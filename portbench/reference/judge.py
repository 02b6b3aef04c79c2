"""Numbers that hold a job's outputs to the reference, each a worst case
over its elements, and the plain readers of the port's artefact files
(the outputs are what is judged; the readers are numpy, not the port's)."""

from __future__ import annotations

import numpy as np
import torch

from . import ctfit, physics


def judged(numbers: dict, limits: dict) -> list:
    """[{name, value, limit, ok}]: each number held to the cell's limit for
    it; a number with no limit fails."""
    out = []
    for k, v in numbers.items():
        lim = limits.get(k)
        out.append(dict(name=k, value=v, limit=lim, ok=lim is not None and bool(v <= lim)))
    return out


def rel_gap(a, b) -> float:
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    if not (np.isfinite(a).all() and np.isfinite(b).all()):
        return float("inf")
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


def abs_gap(a, b) -> float:
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    if not (np.isfinite(a).all() and np.isfinite(b).all()):
        return float("inf")
    return float(np.max(np.abs(a - b)))


def moved_share(a, b) -> float:
    """Share of histogram samples in another bin in ``a`` than in ``b``."""
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).sum() / 2 / b.sum())


def fit_falls(t, y, sigma, fit: dict, device):
    """(chisq gap, falls) of fitted models against reference C(t): the
    largest relative gap between each model's reported selection
    chi-square and the reference's at its parameters, and each residue's
    relative fall of the weighted cost that a float64 LM from those
    parameters still finds (nRes,)."""
    f = dict(dtype=torch.float64, device=device)
    t = torch.as_tensor(t, **f)
    y = torch.as_tensor(y, **f)
    sg = torch.as_tensor(sigma, **f)
    S2, C, tau, mask = (torch.as_tensor(fit[k], **f) for k in ("S2", "C", "tau", "mask"))
    s2free = torch.as_tensor(fit["s2free"], device=device).to(torch.bool)
    chi_ref = ctfit.selection_chisq(t, y, sg, S2, C, tau, mask)
    chi_gap = rel_gap(fit["chisq"], chi_ref.cpu().numpy())
    f_min, f0, _ = ctfit.refine(t, y, sg, S2, C, tau, mask, s2free)
    return chi_gap, (f0 - f_min) / f_min.clamp(min=1e-300)


def fit_numbers(t, y, sigma, fit: dict, device):
    """(chisq gap, the worst residue's fall) of :func:`fit_falls`."""
    chi_gap, falls = fit_falls(t, y, sigma, fit, device)
    return chi_gap, float(falls.max())


def ensemble_rates(mhz, vecs, weights, diso, aniso, fit, zeta, device, new_api=False,
                   dtype=torch.float64):
    """{R1, R2, NOE, rho: (mean, sd), J: (mean, sd) (nRes, 5)} of the
    fitted models over a weighted vector ensemble (nRes, nSamp, 3)."""
    f = dict(dtype=dtype, device=device)
    pair = physics.Pair(mhz)
    v = torch.as_tensor(vecs, **f)
    w = torch.as_tensor(weights, **f)
    S2, C, tau, mask = (torch.as_tensor(fit[k], **f) for k in ("S2", "C", "tau", "mask"))
    J = physics.j_symmtop(pair.omega, v, diso, aniso, S2, C, tau, mask, zeta)
    out = physics.ensemble_rates(pair, J, w, physics.CSA_N, new_api)
    out["J"] = physics.wstats(J.movedim(-1, 0), w)
    out["J"] = (out["J"][0].movedim(0, -1), out["J"][1].movedim(0, -1))
    return {k: (m.cpu().numpy(), s.cpu().numpy()) for k, (m, s) in out.items()}


# ---------------------------------------------------------------------------
# readers of the port's files
# ---------------------------------------------------------------------------

def read_blocks(fn: str, ncol: int) -> np.ndarray:
    """An xvg of '@' headers and '&'-ended blocks of equal length ->
    (nBlocks, rows, ncol)."""
    rows, n_blocks = [], 0
    with open(fn) as fp:
        for line in fp:
            if line.startswith("@"):
                continue
            if line.startswith("&"):
                n_blocks += 1
                continue
            parts = line.split()
            if parts:
                rows.append([float(x) for x in parts[:ncol]])
    a = np.asarray(rows, dtype=np.float64)
    return a.reshape(n_blocks, -1, ncol)


def read_fittedct(fn: str) -> dict:
    """Each residue's fitted model: S2 (S2_0), C, tau (padded to the widest
    K with mask 0), s2free (an S2_fast model) and the reported chisq."""
    res = []
    cur = None
    with open(fn) as fp:
        for line in fp:
            if not line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) < 3:
                continue
            if parts[1] == "Residue:":
                cur = dict(name=parts[2], chisq=np.nan, S2=np.nan, fast=False, C=[], tau=[])
                res.append(cur)
            elif parts[1] == "Chi-Square:":
                cur["chisq"] = float(parts[2])
            elif parts[1] == "Param":
                key, val = parts[2].rstrip(":"), float(parts[3])
                if key == "S2_fast":
                    cur["fast"] = True
                elif key == "S2_0":
                    cur["S2"] = val
                elif key.startswith("C_"):
                    cur["C"].append(val)
                elif key.startswith("tau_"):
                    cur["tau"].append(val)
    return pack_models(res)


def pack_models(res) -> dict:
    K = max(len(r["C"]) for r in res)
    B = len(res)
    C, tau, mask = np.zeros((B, K)), np.ones((B, K)), np.zeros((B, K))
    for i, r in enumerate(res):
        k = len(r["C"])
        C[i, :k], tau[i, :k], mask[i, :k] = r["C"], r["tau"], 1.0
    return dict(names=[r["name"] for r in res], S2=np.array([r["S2"] for r in res]),
                C=C, tau=tau, mask=mask, s2free=np.array([r["fast"] for r in res]),
                chisq=np.array([r["chisq"] for r in res]))


def read_columns(fn: str, ncol: int) -> np.ndarray:
    """The numeric rows of a table whose comment lines start with '#' or '@'."""
    rows = []
    with open(fn) as fp:
        for line in fp:
            if line[:1] in "#@&" or not line.strip():
                continue
            rows.append([float(x) for x in line.split()[:ncol]])
    return np.asarray(rows, dtype=np.float64)
