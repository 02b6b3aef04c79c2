"""Job kind ``ct_stream``: the port's streamed C(t) stage,
``pipeline.stages.stage_ct_streamed``, on one long trajectory, then
``parallel.streamed.run_finish`` on the accumulators it returns.

The stage reads its reference PDB and probes the .xtc's frame spacing as
it does for any input; its decoder (``io.native.iter_xtc_obs``, which
reduces each group of decoded frames to the N-H difference vectors and
Horn's S, as ``orient.bond_obs_host`` does) is stood in for, for the
length of the call, by a source that yields the same observables from
host memory, made from the seed in set-up, a group of ``chunk_groups``
Palmer chunks at a time.  Everything else is the stage's own loop: the
copies to the card, ``orient.bond_vectors_from_obs``,
``fused_group_update`` (kernel A twice a group), the pooled statistics
and the artefact files (both C(t), S2, the average vector, the vector
histogram).  ``run_finish`` fits the pooled internal C(t) with the DoF
ladder and predicts the rates over the PAF vector ensemble.

The check holds one job's outputs, drawn from the seed, to the reference
worked out from the same observables in float64: both pooled C(t) and
their SEM, S2, each residue's fit (its chi-square, and how far a float64
LM from its parameters still falls: the median residue's fall and the
worst residue's; the rung is the port's) and the rates from those
parameters."""

from __future__ import annotations

import contextlib
import math
import os
import shutil
import time

import numpy as np
import torch

from portbench.gen import pdbwrite, systems, xtcwrite
from portbench.reference import ctfit, judge, physics, traj


class Job:
    def __init__(self, ctx):
        self.ctx, self.cfg, self.dev = ctx, ctx.cfg, torch.device(ctx.device)
        self.kept = {}

    def setup(self):
        from spinrelax_tpu_torch.constants import NucleusPair, field_from_mhz
        from spinrelax_tpu_torch.models.diffusion import Diffusion
        from spinrelax_tpu_torch.ops import cuda_acf, cuda_lm

        c, dev = self.cfg, self.dev
        raw, S = systems.bond_observables(c, self.ctx.seed, dev)
        # the decoder's output is pageable host memory: so is the stand-in's
        self.raw, self.S = raw.cpu().numpy(), S.cpu().numpy()
        del raw, S
        self.pdb, self.xtc = stream_files(self.ctx.work, c)
        counts, edges_phi, edges_cos = systems.vector_histogram(c, self.ctx.seed, dev)
        centres = physics.lambert_centres(edges_phi, edges_cos, torch.float64, dev)
        self.vecs = centres[None].expand(c["n_res"], -1, -1).contiguous()
        self.weights = torch.as_tensor(counts.reshape(c["n_res"], -1), dtype=torch.float64,
                                       device=dev)
        self.diso = 1.0 / (6.0 * c["tau_c_ps"])
        self.diffusion = Diffusion.axisymmetric(diso=self.diso, aniso=c["aniso"])
        self.pair = NucleusPair(B0=field_from_mhz(c["bfield_mhz"]), time_unit="ps")
        self.fpc = int(c["tau_mem_ps"] / c["dt_ps"])
        self.group = self.fpc * c["chunk_groups"]
        self.n_chunks = c["n_frames"] // self.fpc
        self.counters = dict(A=cuda_acf.acf_lag_sums, B=cuda_lm.hgc_cuda)
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    def source(self, fn, chunk_frames, idx_h, idx_x, A, threads=1, out_dtype=np.float32):
        """The decoder's stand-in: the seed's observables of ``fn``, in
        groups of ``chunk_frames`` frames, as (raw_diff, S, times)."""
        if fn != self.xtc or len(idx_h) != self.cfg["n_res"]:
            raise ValueError(f"the stand-in serves {self.xtc!r} with {self.cfg['n_res']} bonds")
        dt = self.cfg["dt_ps"]
        for lo in range(0, self.raw.shape[0], chunk_frames):
            hi = min(lo + chunk_frames, self.raw.shape[0])
            yield (self.raw[lo:hi], self.S[lo:hi],
                   np.arange(lo, hi, dtype=np.float32) * np.float32(dt))

    @contextlib.contextmanager
    def decoded_from_memory(self):
        from spinrelax_tpu_torch.io import native

        real = native.iter_xtc_obs
        native.iter_xtc_obs = self.source
        try:
            yield
        finally:
            native.iter_xtc_obs = real

    def run(self, i: int) -> dict:
        from spinrelax_tpu_torch.parallel import streamed
        from spinrelax_tpu_torch.pipeline import stages

        c, nB = self.cfg, self.cfg["n_res"]
        d = os.path.join(self.ctx.work, "warm" if i < 0 else f"job{i}")
        os.makedirs(d)
        before = {k: f.launches for k, f in self.counters.items()}
        t0 = time.perf_counter()
        with self.decoded_from_memory():
            out = stages.stage_ct_streamed([self.xtc], [self.pdb], os.path.join(d, "ct"),
                                           c["tau_mem_ps"], chunk_groups=c["chunk_groups"],
                                           hist_bins=c["hist_bins"][0], device=self.ctx.device)
        acc, n_chunks = out["acc"], out["n_chunks"]
        t1 = time.perf_counter()
        fr = streamed.run_finish(acc["ct_int_s"], acc["ct_int_s2"], n_chunks, n_res=nB,
                                 delta_t=out["delta_t"], diffusion=self.diffusion,
                                 pair=self.pair, vecs=self.vecs, weights=self.weights,
                                 zeta=physics.ZETA)
        host = {k: acc[k].cpu() for k in ("ct_int_s", "ct_int_s2", "ct_ext_s", "ct_ext_s2",
                                          "s2_s", "s2_s2")}
        cts = fr.cts
        host["fit"] = dict(S2=cts.S2.cpu(), C=cts.C.cpu(), tau=cts.tau.cpu(),
                           mask=cts.mask.cpu(), s2free=(cts.s2fast > 0).cpu(),
                           chisq=cts.chisq.cpu())
        host["rates"] = {k: getattr(fr, k).cpu() for k in ("R1", "R2", "NOE", "rho")}
        t2 = time.perf_counter()
        shutil.rmtree(d, ignore_errors=True)
        self.kept[i] = host
        shapes = [(c["chunk_groups"] * nB, self.fpc, self.fpc // 2)] * (2 * math.ceil(
            n_chunks / c["chunk_groups"]))
        return {"work": float(n_chunks * self.fpc * nB), "acf_shapes": shapes,
                "phases": [("stage_ct_streamed", t0, t1), ("run_finish", t1, t2)],
                "launches": {k: f.launches - before[k] for k, f in self.counters.items()}}

    def forget(self, i: int):
        """Free job ``i``'s outputs (it is not the one checked)."""
        self.kept.pop(i)

    def release(self):
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # -- the reference ------------------------------------------------------
    def reference(self, dtype=torch.float64, vec_dtype=None) -> dict:
        """Pooled C(t) (both orientations) and S2 from the observables in
        ``dtype``; ``vec_dtype`` rounds the bond vectors to the control's
        lower precision."""
        dev, n = self.dev, self.n_chunks
        sums = {}
        for lo in range(0, n * self.fpc, self.group):
            hi = min(lo + self.group, n * self.fpc)
            g = (hi - lo) // self.fpc
            raw_g = torch.from_numpy(self.raw[lo:hi]).to(dev).to(dtype)
            q = traj.horn_quats(torch.from_numpy(self.S[lo:hi]).to(dev).to(dtype))
            raw, fitted = traj.bond_vectors(raw_g, q)
            if vec_dtype is not None:
                raw, fitted = (v.to(vec_dtype).to(dtype) for v in (raw, fitted))
            for key, v in (("int", fitted), ("ext", raw)):
                v = v.reshape(g, self.fpc, v.shape[1], 3)
                e = traj.chunk_ct(v) - 1.0
                sums[key] = sums.get(key, 0.0) + torch.stack([e.sum(0), (e * e).sum(0)])
            e2 = traj.s2_blocks(fitted.reshape(g, self.fpc, -1, 3)) - 1.0
            sums["s2"] = sums.get("s2", 0.0) + torch.stack([e2.sum(0), (e2 * e2).sum(0)])
        out = {}
        for key, (s, s2) in sums.items():
            out[key] = pooled_stats(s.double(), s2.double(), n)
        out["t"] = (np.arange(self.fpc // 2) + 1.0) * self.cfg["dt_ps"]
        return out

    def numbers(self, got: dict, ref: dict) -> dict:
        """Each compared number of ``got`` (the port's outputs or the
        control's) against the float64 reference."""
        n = {}
        for key in ("int", "ext"):
            m, d = got[key]
            n["ct_" + key] = judge.abs_gap(m, ref[key][0])
            n["dct_" + key] = judge.abs_gap(d, ref[key][1])
        n["s2"] = judge.abs_gap(got["s2"][0], ref["s2"][0])
        # the median residue's fall, and the worst residue's: the ladder
        # stops short of a float64 LM's cost on a few residues of every
        # stream (up to 2 on sound runs), so the worst catches one residue
        # fitted far off, the median a ladder that stops short everywhere
        n["fit_chisq"], falls = judge.fit_falls(ref["t"], ref["int"][0], ref["int"][1],
                                                got["fit"], self.dev)
        n["fit_drop_median"] = float(falls.median())
        n["fit_drop_worst"] = float(falls.max())
        want = judge.ensemble_rates(self.cfg["bfield_mhz"], self.vecs, self.weights, self.diso,
                                    self.cfg["aniso"], got["fit"], physics.ZETA, self.dev)
        for k in ("R1", "R2", "NOE", "rho"):
            n[k.lower()] = judge.rel_gap(got["rates"][k], want[k][0])
        return n

    def got_of(self, host: dict) -> dict:
        """The port's pooled statistics from its float32 accumulators, in
        float64, (nRes, nDeltas) as the reference's."""
        n = self.n_chunks
        out = {}
        for key in ("int", "ext"):
            m, d = pooled_stats(host[f"ct_{key}_s"].double().T, host[f"ct_{key}_s2"].double().T, n)
            out[key] = (m.numpy(), d.numpy())
        m, d = pooled_stats(host["s2_s"].double(), host["s2_s2"].double(), n)
        out["s2"] = (m.numpy(), d.numpy())
        out["fit"] = {k: v.double().numpy() if k != "s2free" else v.numpy()
                      for k, v in host["fit"].items()}
        out["rates"] = {k: v.double().numpy() for k, v in host["rates"].items()}
        return out

    def measured(self, i: int) -> dict:
        """The compared numbers of job ``i``'s outputs."""
        ref = {k: v if k == "t" else tuple(a.cpu().numpy() for a in v)
               for k, v in self.reference().items()}
        return self.numbers(self.got_of(self.kept[i]), ref)

    def check(self, i: int) -> list:
        """Job ``i``'s numbers, each held to the cell's limit."""
        return judge.judged(self.measured(i), self.ctx.params["limits"])

    def control(self) -> dict:
        """The reference in the program's place one precision down: bond
        vectors in bfloat16 for C(t)'s float32, its fits a float32 LM from a
        fixed start on its own C(t), its rates in float32."""
        ref = {k: v if k == "t" else tuple(a.cpu().numpy() for a in v)
               for k, v in self.reference().items()}
        low = {k: v if k == "t" else tuple(a.cpu().numpy() for a in v)
               for k, v in self.reference(torch.float32, torch.bfloat16).items()}
        low["fit"] = ctfit.control_fit(low["t"], low["int"][0], low["int"][1], self.dev)
        r = judge.ensemble_rates(self.cfg["bfield_mhz"], self.vecs, self.weights, self.diso,
                                 self.cfg["aniso"], low["fit"], physics.ZETA, self.dev,
                                 dtype=torch.float32)
        low["rates"] = {k: r[k][0] for k in ("R1", "R2", "NOE", "rho")}
        return self.numbers(low, ref)


def stream_files(work: str, cfg: dict):
    """A reference PDB of the configuration's residues (N, H and a fitted
    CA each, on a ring) and a two-frame .xtc of it at the configuration's
    frame spacing, which the stage reads for its bonds and its dt."""
    n = cfg["n_res"]
    th = 2 * np.pi * np.arange(n) / n
    cen = np.stack([2.0 * np.cos(th), 2.0 * np.sin(th), 0.3 * np.sin(3 * th)], axis=1)
    xyz = np.repeat(cen, 3, axis=0)
    xyz[1::3] += np.array([0.0, 0.0, 0.102])
    xyz[2::3] += np.array([0.05, -0.03, -0.14])
    pdb = os.path.join(work, "stream.pdb")
    pdbwrite.write_pdb(pdb, ["N", "H", "CA"] * n, ["ALA"] * (3 * n),
                       np.repeat(np.arange(n) + 1, 3), ["A"] * (3 * n), [0.0, 0.0, 1.0] * n,
                       ["N", "H", "C"] * n, xyz)
    trj = os.path.join(work, "stream.xtc")
    frames = np.stack([xyz, xyz]).astype(np.float32)
    xtcwrite.write_xtc(trj, frames, np.array([0.0, cfg["dt_ps"]], np.float32), 1000.0)
    return pdb, trj


def pooled_stats(s, s2, n: int):
    """(mean, SEM with sqrt(n) - 1) from the sums of e = x - 1 and e^2 over
    n chunks (the streamed stage's shifted accumulators)."""
    e = s / n
    var = torch.clamp(s2 / n - e * e, min=0.0)
    return 1.0 + e, torch.sqrt(var) / (math.sqrt(n) - 1.0)
