"""Job kind ``runall``: one job is the port's run-all command
(``pipeline.runall.main``) on the configuration's .xtc, into a fresh
output prefix, so no step is skipped as up to date: orientation
quaternions -> Delta-q diffusion tensor -> C(t) -> the DoF ladder ->
rates and J(omega) at every field.

The check holds one job's files, drawn from the seed, to the reference
worked out from the generator's quantised coordinates: the quaternions,
the D tensor and the Diso / Daniso run-all uses, both C(t) with their
SEM, S2, the vector histogram, each residue's fit (its chi-square and how
far a float64 LM from its parameters still falls) and the rates and
J(omega) at every field.  The reference follows the port in one place:
it takes each residue's rung (K, S2_fast) and parameters from the port's
fit, and judges them against its own C(t); the rates are its own, from
those parameters, its own D tensor and its own histogram."""

from __future__ import annotations

import os
import shutil
import time

import numpy as np
import torch

from portbench.gen import systems
from portbench.reference import ctfit, judge, physics, traj


def d_factor(cfg) -> float:
    """run-all's D_iso conversion to the experiment's temperature, viscosity
    and D2O share (run-all.bash:15-28)."""
    def eta(T):
        T = T - 273.0
        return 1.7753 - 5.65e-2 * T + 1.0751e-3 * T ** 2 - 9.222e-6 * T ** 3

    return (cfg["temp_exp"] / cfg["temp_md"] * eta(cfg["temp_md"]) / eta(cfg["temp_exp"])
            * (1.23 * cfg["d2o_exp"] + 1.0 - cfg["d2o_exp"]))


def used(dq: dict, cfg) -> dict:
    """``dq`` with the Diso (ps^-1, converted to the experiment) and Daniso
    run-all takes from it: the long axis's where its rhombicity is below
    one, else the short axis's (run-all.bash:404-435)."""
    dq["diso_used"] = dq["Diso"] * 1e-12 * d_factor(cfg)
    dq["dani_used"] = dq["Dani_L"] if dq["Drho_L"] < 1.0 else dq["Dani_S"]
    return dq


def lag_grid(dt: float, tau: float):
    step = tau / 100.0
    skip = max(1, int(step / dt))
    return list(range(max(skip, int(step / dt)), int(tau / dt) + 1, skip))


class Job:
    def __init__(self, ctx):
        self.ctx, self.cfg, self.dev = ctx, ctx.cfg, torch.device(ctx.device)
        self.dirs = {}

    def setup(self):
        from spinrelax_tpu_torch.ops import cuda_acf, cuda_lm

        self.sys = systems.ubq_system(self.ctx.work, self.cfg, self.ctx.seed)
        c = self.cfg
        self.argv = ["-sxtc", self.sys["xtc"], "-refpdb", self.sys["ref_pdb"],
                     "-t_mem", repr(c["tau_mem_ps"]), "-num_chunks", str(c["num_chunks"]),
                     "-Temp_MD", repr(c["temp_md"]), "-Temp_Exp", repr(c["temp_exp"]),
                     "-D2O_Exp", repr(c["d2o_exp"]),
                     "-Bfields", *[repr(b) for b in c["bfields_mhz"]], "-Jw"]
        self.counters = dict(A=cuda_acf.acf_lag_sums, B=cuda_lm.hgc_cuda,
                             C=cuda_lm.cost_cuda, D=cuda_lm.step_solve_cuda,
                             E=cuda_lm.step_gate_cuda)

    def run(self, i: int) -> dict:
        from spinrelax_tpu_torch.pipeline import runall

        d = os.path.join(self.ctx.work, "warm" if i < 0 else f"job{i}")
        os.makedirs(d)
        before = {k: f.launches for k, f in self.counters.items()}
        t0 = time.perf_counter()
        summary = runall.main(["-out", os.path.join(d, "rotdif"),
                               "-qfile", os.path.join(d, "colvar-qorient"), *self.argv],
                              device=self.ctx.device)
        self.dirs[i] = (d, summary)
        phases, at = [], t0
        for step, s in summary["walls"].items():
            phases.append((step, at, at + s))
            at += s
        rec = {"work": 1.0, "phases": phases,
               "launches": {k: f.launches - before[k] for k, f in self.counters.items()}}
        rec.update({f"step_s.{k.replace('-', '')}": s for k, s in summary["walls"].items()})
        return rec

    def forget(self, i: int):
        """Free job ``i``'s outputs (it is not the one checked)."""
        d, _ = self.dirs.pop(i)
        shutil.rmtree(d, ignore_errors=True)

    def release(self):
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # -- the port's files ---------------------------------------------------
    def outputs(self, i: int) -> dict:
        d, summary = self.dirs[i]
        pref = os.path.join(d, f"rotdif-{self.cfg['tau_mem_ps'] / 1000.0:g}ns")
        q = judge.read_columns(os.path.join(d, "colvar-qorient"), 5)[:, 1:]
        D = [None] * 3
        with open(pref + "-aniso2.dat") as fp:
            for line in fp:
                parts = line.split()
                if line.startswith("# Converted D_") and parts[2][2:].isdigit():
                    D[int(parts[2][2:])] = float(parts[4])
                elif line.startswith("# Converted Diso"):
                    diso_hdr = float(parts[4])
        out = dict(q=q, D=np.array(D), Diso=diso_hdr, diso_used=summary["diso"],
                   dani_used=summary["dani"])
        for key, suffix in (("int", "_Ctint.dat"), ("ext", "_Ctext.dat")):
            b = judge.read_blocks(pref + suffix, 3)
            out["ct_" + key], out["dct_" + key] = b[..., 1], b[..., 2]
        out["s2"] = judge.read_columns(pref + "_S2.dat", 3)[:, 1]
        npz = np.load(pref + "_vecHistogram.npz", allow_pickle=True)
        out["hist"], out["edges"] = npz["data"], tuple(npz["edges"][:2])
        out["fit"] = judge.read_fittedct(pref + "_fittedCt.dat")
        out["rates"] = {}
        for bf in self.cfg["bfields_mhz"]:
            of = f"{pref}-{int(bf)}"
            r = {k: judge.read_columns(f"{of}_{k}.dat", 2)[:, 1] for k in
                 ("R1", "R2", "NOE", "rho")}
            out["rates"][bf] = r
        return out

    # -- the reference ------------------------------------------------------
    def reference(self, dtype=torch.float64, low=None) -> dict:
        """The reference's outputs from the quantised coordinates, in
        ``dtype``; ``low`` (the control) rounds to that dtype the
        quaternions, the Delta-q pair vectors and the bond vectors of the
        C(t) stage (C(t), S2, the histogram)."""
        s, c, dev = self.sys, self.cfg, self.dev
        f = dict(dtype=dtype, device=dev)
        xyz = torch.from_numpy(s["ints"]).to(dev).to(dtype) / s["precision"]
        ref = torch.as_tensor(s["ref_xyz"], **f)
        w = torch.as_tensor(s["fit_weights"], **f)
        q = torch.cat([traj.horn_quats(traj.frame_correlations(xyz[lo: lo + 2000], ref, w))
                       for lo in range(0, xyz.shape[0], 2000)])
        if low is not None:
            q = q.to(low).to(dtype)
        dq = used(traj.dq_analysis(q, s["dt"], lag_grid(s["dt"], c["tau_mem_ps"]), low), c)
        raw, fitted = traj.bond_vectors(xyz[:, s["idx_h"]] - xyz[:, s["idx_n"]], q)
        del xyz
        if low is not None:
            raw, fitted = (v.to(low).to(dtype) for v in (raw, fitted))
        fpc = int(c["tau_mem_ps"] / s["dt"])
        nc = raw.shape[0] // fpc
        out = dict(q=q.double().cpu().numpy(), D=np.array(dq["D_axes"]), Diso=dq["Diso"],
                   diso_used=dq["diso_used"], dani_used=dq["dani_used"])
        for key, v in (("int", fitted), ("ext", raw)):
            v = v[: nc * fpc].reshape(nc, fpc, v.shape[1], 3)
            m, sem = traj.pooled(traj.chunk_ct(v), nc)
            out["ct_" + key], out["dct_" + key] = m.cpu().numpy(), sem.cpu().numpy()
        s2m, _ = traj.pooled(traj.s2_blocks(fitted[: nc * fpc].reshape(nc, fpc, -1, 3)), nc)
        out["s2"] = (s2m * physics.ZETA).cpu().numpy()
        paf = traj.rotate(fitted, dq["q_frame"])
        out["hist"] = traj.lambert_hist(paf, *c["hist_bins"]).cpu().numpy()
        out["edges"] = systems.lambert_edges(*c["hist_bins"])
        out["t"] = (np.arange(out["ct_int"].shape[1]) + 1.0) * s["dt"]
        return out

    def rates_of(self, got: dict, dtype=torch.float64) -> dict:
        """Legacy ensemble rates at every field from ``got``'s fitted
        models, the Diso and Daniso run-all used and its histogram."""
        centres = physics.lambert_centres(*got["edges"], dtype, self.dev)
        n = got["hist"].shape[0]
        v = centres[None].expand(n, -1, -1)
        w = torch.as_tensor(got["hist"].reshape(n, -1), dtype=dtype, device=self.dev)
        return {bf: {k: r[0] for k, r in judge.ensemble_rates(
                    bf, v, w, got["diso_used"], got["dani_used"], got["fit"], physics.ZETA,
                    self.dev, dtype=dtype).items() if k != "J"}
                for bf in self.cfg["bfields_mhz"]}

    def diffusion_of(self, q) -> dict:
        """The float64 Delta-q analysis of quaternions (F, 4), with the Diso
        (ps^-1, converted to the experiment) and Daniso run-all takes."""
        c, dt = self.cfg, self.sys["dt"]
        return used(traj.dq_analysis(torch.as_tensor(q, dtype=torch.float64, device=self.dev),
                                     dt, lag_grid(dt, c["tau_mem_ps"])), c)

    def numbers(self, got: dict, ref: dict) -> dict:
        """Each compared number of ``got`` (the port's outputs, or the
        control's) against the float64 reference ``ref``.  The orientation
        (the start) is held to the reference's own; the Delta-q stage to
        the reference's analysis of ``got``'s quaternions; C(t), S2, the
        histogram and the fits to the reference's own C(t); the rates to
        the reference's physics on ``got``'s D, histogram and fits."""
        n = {}
        n["q_angle"] = float(traj.angle_gap(torch.as_tensor(got["q"]),
                                            torch.as_tensor(ref["q"])).max())
        dq = self.diffusion_of(got["q"])
        n["dq"] = max(judge.rel_gap(got["D"], dq["D_axes"]), judge.rel_gap(got["Diso"], dq["Diso"]),
                      judge.rel_gap(got["diso_used"], dq["diso_used"]),
                      judge.rel_gap(got["dani_used"], dq["dani_used"]))
        n["ct_int"] = judge.abs_gap(got["ct_int"], ref["ct_int"])
        n["ct_ext"] = judge.abs_gap(got["ct_ext"], ref["ct_ext"])
        n["dct"] = max(judge.abs_gap(got["dct_int"], ref["dct_int"]),
                       judge.abs_gap(got["dct_ext"], ref["dct_ext"]))
        n["s2"] = judge.abs_gap(got["s2"], ref["s2"])
        n["hist"] = judge.moved_share(got["hist"], ref["hist"])
        n["fit_chisq"], n["fit_drop"] = judge.fit_numbers(
            ref["t"], ref["ct_int"], ref["dct_int"], got["fit"], self.dev)
        want = self.rates_of(got)
        for k in ("R1", "R2", "NOE", "rho"):
            n[k.lower()] = max(judge.rel_gap(got["rates"][bf][k], want[bf][k])
                               for bf in self.cfg["bfields_mhz"])
        return n

    def measured(self, i: int) -> dict:
        """The compared numbers of job ``i``'s files."""
        return self.numbers(self.outputs(i), self.reference())

    def check(self, i: int) -> list:
        """Job ``i``'s numbers, each held to the cell's limit."""
        return judge.judged(self.measured(i), self.ctx.params["limits"])

    def control(self) -> dict:
        """The control's numbers: the reference in the program's place one
        precision below the configuration's: float32 arithmetic with the
        quaternions, the Delta-q pair vectors and the bond vectors in
        bfloat16 (the products the configuration states in float32), its
        fits a float32 LM from a fixed start on its own C(t), its rates in
        float32 (stated float64)."""
        ref = self.reference()
        low = self.reference(dtype=torch.float32, low=torch.bfloat16)
        low["fit"] = ctfit.control_fit(low["t"], low["ct_int"], low["dct_int"], self.dev)
        low["rates"] = self.rates_of(low, dtype=torch.float32)
        return self.numbers(low, ref)
