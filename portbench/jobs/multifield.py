"""Job kind ``multifield``: the multi-field global fit as a user runs it,
``pipeline.stages.stage_multifield`` from files: the fitted C(t) models,
the vector histogram and one experiment file per (R1, R2, NOE) x field;
the fit of the workload's variables by its method from the
configuration's start; the per-experiment .xvg exports.

The traffic is the workload's ``problems`` proteins' worth of inputs,
written in set-up, taken in turn in an order drawn from the seed.  Each
problem's models and vector histogram are the same for every seed (the
fit's work, Powell's evaluations above all, is set by them, so every run
does the same set of fits); its experiments' noise is drawn from the
seed and the problem.

The check holds one job, drawn from the seed, to the reference
objective worked out from its problem's models, ensemble and
experiments in float64: the reported chi-square against the reference's
at the fitted parameters, the parameters against the reference's
minimum near them, and every exported prediction against the
reference's."""

from __future__ import annotations

import os
import shutil
import time

import numpy as np
import torch

from portbench.gen import systems
from portbench.reference import globalfit, judge, physics


class Job:
    def __init__(self, ctx):
        self.ctx, self.cfg, self.dev = ctx, ctx.cfg, torch.device(ctx.device)
        self.kept = {}

    def setup(self):
        c = self.cfg
        self.truth = (1.0 / (6.0 * c["tau_c_ps"]), c["aniso"])
        self.start = (c["start_diso_factor"] * self.truth[0], c["start_aniso"])
        self.problems = [self._problem(k) for k in range(self.ctx.params["problems"])]
        self.order = np.random.default_rng(self.ctx.seed).permutation(len(self.problems))

    def _problem(self, k: int) -> dict:
        """Problem ``k``'s inputs, in memory and as the files the fit reads."""
        c, n = self.cfg, self.cfg["n_res"]
        d = os.path.join(self.ctx.work, f"problem{k}")
        os.makedirs(d)
        pb = dict(models=systems.ct_models(c, k))
        pb["fitted_fn"] = os.path.join(d, "models_fittedCt.dat")
        systems.write_fittedct(pb["fitted_fn"], pb["models"])
        counts, ep, ec = systems.vector_histogram(c, k, self.dev)
        pb["vec_fn"] = os.path.join(d, "models_vecHistogram.npz")
        systems.save_histogram(pb["vec_fn"], pb["models"]["names"], counts, ep, ec)
        pb["vecs"] = physics.lambert_centres(ep, ec, torch.float64, self.dev)[None].expand(
            n, -1, -1)
        pb["w"] = counts.reshape(n, -1).astype(np.float64)
        pb["experiments"], pb["expt_fns"] = self._experiments(pb, d, k)
        return pb

    def _experiments(self, pb: dict, d: str, k: int):
        """R1, R2, NOE at each field from the truth, errors max(ensemble sd,
        the floor share of the value), Gaussian noise of those errors,
        every ``unmeasured_every``-th residue left out."""
        c = self.cfg
        prob = globalfit.Problem(pb["models"], pb["vecs"], pb["w"], [], physics.ZETA,
                                 physics.CSA_N, torch.float64, self.dev)
        prob.pairs = {mhz: physics.Pair(mhz) for mhz in c["bfields_mhz"]}
        pred = prob.predict(*self.truth)
        rng = np.random.default_rng([self.ctx.seed, k])
        keep = [i for i in range(c["n_res"]) if (i + 1) % c["unmeasured_every"]]
        names = [pb["models"]["names"][i] for i in keep]
        out, fns = [], []
        for mhz in c["bfields_mhz"]:
            for kind in ("R1", "R2", "NOE"):
                v, sd = (a.cpu().numpy()[keep] for a in pred[(kind, mhz)])
                err = np.maximum(sd, c["expt_error_floor"] * np.abs(v))
                val = v + err * rng.standard_normal(len(keep))
                fn = os.path.join(d, f"expt_{kind}_{int(mhz)}.dat")
                systems.write_experiment(fn, kind, mhz, names, val, err)
                out.append(dict(kind=kind, mhz=mhz, names=names, values=val, errors=err))
                fns.append(fn)
        return out, fns

    def run(self, i: int) -> dict:
        from spinrelax_tpu_torch.constants import DEFAULT_ZETA
        from spinrelax_tpu_torch.fit import globalfit as gf
        from spinrelax_tpu_torch.models.diffusion import Diffusion
        from spinrelax_tpu_torch.pipeline import stages

        d = os.path.join(self.ctx.work, "warm" if i < 0 else f"job{i}")
        os.makedirs(d)
        pb = self.problems[self.order[i % len(self.order)]]
        reads = gf.host_reads.count
        p = self.ctx.params
        t0 = time.perf_counter()
        final = stages.stage_multifield(
            pb["fitted_fn"], pb["expt_fns"], os.path.join(d, "fit"),
            Diffusion.axisymmetric(diso=self.start[0], aniso=self.start[1]),
            vec_file=pb["vec_fn"], zeta=DEFAULT_ZETA, opt_params=p["opt_params"],
            method=p["method"], include_expt=True, device=self.ctx.device)
        self.kept[i] = (d, final, pb)
        return {"work": 1.0, "host_reads": gf.host_reads.count - reads,
                "phases": [("stage_multifield", t0, time.perf_counter())]}

    def forget(self, i: int):
        """Free job ``i``'s outputs (it is not the one checked)."""
        d = self.kept.pop(i)[0]
        shutil.rmtree(d, ignore_errors=True)

    def release(self):
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def problem(self, pb: dict, dtype=torch.float64):
        return globalfit.Problem(pb["models"], pb["vecs"], pb["w"], pb["experiments"],
                                 physics.ZETA, physics.CSA_N, dtype, self.dev)

    def exported(self, d: str, pb: dict) -> dict:
        """{(kind, mhz): (values, errors)} of the port's .xvg exports (the
        predictions, the first data set of each file)."""
        out = {}
        for e in pb["experiments"]:
            mhz = round(physics.field_from_mhz(e["mhz"]) * 267.513 / (2.0 * np.pi))
            fn = os.path.join(d, f"fit_15N1H_{mhz}MHz_{e['kind']}.xvg")
            rows = []
            with open(fn) as fp:
                for line in fp:
                    if line.startswith("&"):
                        break
                    if line[:1] in "#@" or not line.strip():
                        continue
                    rows.append([float(x) for x in line.split()[1:3]])
            out[(e["kind"], e["mhz"])] = np.asarray(rows).T
        return out

    def numbers(self, pb, diso, aniso, chisq, exports) -> dict:
        """The compared numbers of fitted (Diso, Daniso), the chi-square
        reported there and the exported predictions, on problem ``pb``."""
        prob = self.problem(pb)
        chi_ref = float(prob.chisq(diso, aniso))
        d_min, a_min, _ = globalfit.minimise(prob, diso, aniso)
        pred = prob.predict(diso, aniso)
        gaps = [judge.rel_gap(exports[k], np.stack([a.cpu().numpy() for a in pred[k]]))
                for k in exports]
        return {"chisq": judge.rel_gap(chisq, chi_ref),
                "params": max(judge.rel_gap(diso, d_min), judge.rel_gap(aniso, a_min)),
                "exports": max(gaps)}

    def measured(self, i: int) -> dict:
        """The compared numbers of job ``i``'s fit and exports."""
        d, final, pb = self.kept[i]
        return self.numbers(pb, final["diso"], final["aniso"], final["chisq"],
                            self.exported(d, pb))

    def check(self, i: int) -> list:
        """Job ``i``'s numbers, each held to the cell's limit."""
        return judge.judged(self.measured(i), self.ctx.params["limits"])

    def control(self) -> dict:
        """The reference fit in the program's place one precision down
        (float32 for the fit's float64) on the first problem the seed
        orders: its minimum from the same start, the chi-square it reports
        there and its predictions, each in float32."""
        pb = self.problems[self.order[0]]
        low = self.problem(pb, torch.float32)
        diso, aniso, chisq = globalfit.minimise(low, *self.start)
        pred = low.predict(diso, aniso)
        exports = {k: np.stack([a.double().cpu().numpy() for a in v]) for k, v in pred.items()
                   if k[0] in ("R1", "R2", "NOE")}
        return self.numbers(pb, diso, aniso, chisq, exports)
