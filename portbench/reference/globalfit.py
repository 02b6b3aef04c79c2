"""The multi-field global fit's objective in plain torch: predicted R1,
R2, NOE (new API: the ensemble-mean R1 in the NOE) over a weighted vector
ensemble at each experiment's field, and the published chi-square, the
mean over experiments of each one's masked mean of
(v - t)^2 / (dt^2 + dv^2) (spectral_densities.py:803-818, 1409-1413;
a non-positive weight counts as 1).  :func:`minimise` finds its minimum
over (Diso, Daniso) by Newton steps in log space."""

from __future__ import annotations

import torch

from .physics import Pair, ensemble_rates, j_symmtop


class Problem:
    """Experiments aligned to the models' residues, on one device."""

    def __init__(self, models, vecs, w, experiments, zeta, csa, dtype, device):
        f = dict(dtype=dtype, device=device)
        self.S2 = torch.as_tensor(models["S2"], **f)
        self.C = torch.as_tensor(models["C"], **f)
        self.tau = torch.as_tensor(models["tau"], **f)
        self.mask = torch.ones_like(self.C)
        self.v = torch.as_tensor(vecs, **f)
        self.w = torch.as_tensor(w, **f)
        self.zeta, self.csa = zeta, csa
        index = {n: i for i, n in enumerate(models["names"])}
        self.expts = []
        for e in experiments:
            t = torch.zeros(len(index), **f)
            err = torch.zeros(len(index), **f)
            m = torch.zeros(len(index), **f)
            for n, val, de in zip(e["names"], e["values"], e["errors"]):
                i = index[n]
                t[i], err[i], m[i] = val, de, 1.0
            self.expts.append(dict(kind=e["kind"], mhz=e["mhz"], t=t, err=err, m=m))
        self.pairs = {e["mhz"]: Pair(e["mhz"]) for e in experiments}

    def predict(self, diso, aniso):
        """{(kind, mhz): (value, sd)} at (Diso, Daniso)."""
        out = {}
        for mhz, pair in self.pairs.items():
            J = j_symmtop(pair.omega, self.v, diso, aniso, self.S2, self.C, self.tau,
                          self.mask, self.zeta)
            for k, v in ensemble_rates(pair, J, self.w, self.csa, new_api=True).items():
                out[(k, mhz)] = v
        return out

    def chisq(self, diso, aniso):
        pred = self.predict(diso, aniso)
        total = 0.0
        for e in self.expts:
            v, dv = pred[(e["kind"], e["mhz"])]
            wgt = e["err"] ** 2 + dv ** 2
            wgt = torch.where(wgt > 0, wgt, torch.ones_like(wgt))
            total = total + (e["m"] * (v - e["t"]) ** 2 / wgt).sum() / e["m"].sum().clamp(min=1)
        return total / len(self.expts)


def minimise(prob: Problem, diso0: float, aniso0: float, n_iter: int = 40, h: float = 1e-4):
    """(Diso, Daniso, chisq) at the minimum near the start: Newton steps on
    (log Diso, log Daniso) with central differences, each step halved
    until the chi-square falls."""
    import math

    x = torch.tensor([math.log(diso0), math.log(aniso0)], dtype=torch.float64)

    def f(z):
        return float(prob.chisq(math.exp(float(z[0])), math.exp(float(z[1]))))

    fx = f(x)
    for _ in range(n_iter):
        g = torch.zeros(2, dtype=torch.float64)
        H = torch.zeros((2, 2), dtype=torch.float64)
        e = torch.eye(2, dtype=torch.float64) * h
        for i in range(2):
            fp, fm = f(x + e[i]), f(x - e[i])
            g[i] = (fp - fm) / (2 * h)
            H[i, i] = (fp - 2 * fx + fm) / h ** 2
        fpp, fpm = f(x + e[0] + e[1]), f(x + e[0] - e[1])
        fmp, fmm = f(x - e[0] + e[1]), f(x - e[0] - e[1])
        H[0, 1] = H[1, 0] = (fpp - fpm - fmp + fmm) / (4 * h * h)
        try:
            step = -torch.linalg.solve(H, g)
        except RuntimeError:
            step = -g
        if bool((torch.linalg.eigvalsh(H) <= 0).any()):
            step = -g / max(float(g.abs().max()), 1e-30) * 1e-2
        for _ in range(30):
            fn = f(x + step)
            if fn < fx:
                x, fx = x + step, fn
                break
            step = step / 2
        else:
            break
    return math.exp(float(x[0])), math.exp(float(x[1])), fx
