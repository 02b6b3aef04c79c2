"""Legacy single-field fitting modes of calculate-relaxations-from-Ct.py
(port of ``spinrelax_tpu/fit/legacyfit.py``).

Modes (reference :865-1000):
- 'Diso'      : global tumbling rate only.
- 'DisoS2'    : Diso + a global S2 scaling factor (applied to S2 and all
                transient amplitudes, :267-268 / :297-298).
- 'DisoCSA'   : Diso + a global mean CSA.
- 'DisoS2CSA' : all three, with the correlated Powell direction matrix
                (:930-934).
- 'new'       : alternating global-Diso Powell + per-residue CSA fits
                (:865-905); the per-residue stage is a batched
                golden-section (all residues at once).

The chi-square follows optfunc_R1R2NOE_inner (:193-207): mean over
(R1,R2,NOE) x residues of (v-t)^2 / (sigma_sim^2 + sigma_exp^2).  It is
computed in float64 on the device of the C(t) models; every read from the
device goes through ``fit.globalfit.host`` (counted there).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..constants import NucleusPair
from ..models.ctmodel import CtModelSet
from ..models.diffusion import ELLIPSOID, Diffusion
from ..ops import observables as obs
from .globalfit import _arg, host
from .scalar import golden_vec


class LegacyFitResult(NamedTuple):
    diso: float
    s2_scale: float
    csa: np.ndarray  # (nRes,)
    chisq: float
    mode: str


def _with_diso(diffusion: Diffusion, diso):
    """``diffusion`` with Diso the tensor ``diso``, left on its device (so
    autograd and the device loops see it; ``Diffusion.with_diso`` keeps its
    parameters on the CPU).  The ellipsoid kind rescales its principal
    values by diso / Diso_old, as ``with_diso`` does."""
    if diffusion.kind == ELLIPSOID:
        old = diffusion.diso.to(diso.device)
        return dataclasses.replace(diffusion, diso=diso,
                                   dxyz=diffusion.dxyz.to(diso.device) * (diso / old))
    return dataclasses.replace(diffusion, diso=diso)


def _make_chisq(pair: NucleusPair, diffusion: Diffusion, cts: CtModelSet,
                vecs, weights, exp, exp_err):
    """Total and per-residue chi-square functions of (diso, s2s, csa) on
    the device of ``cts``.

    exp     : (nRes, 3) target R1/R2/NOE.
    exp_err : (nRes, 3) uncertainties or None.
    """
    dev = cts.S2.device
    vecs_t, weights_t, exp_t, err_t = (_arg(a, dev) for a in (vecs, weights, exp, exp_err))
    base_zeta = cts.zeta

    def _predict(diso, s2s, csa):
        d = _with_diso(diffusion, _arg(diso, dev))
        # a Python-number scale multiplies as it is (no copy to the device)
        c = dataclasses.replace(cts, zeta=base_zeta * (
            s2s if isinstance(s2s, (int, float)) else _arg(s2s, dev)))
        rates = obs.predict_rates(pair, d, c, vecs=vecs_t, weights=weights_t,
                                  csa=_arg(csa, dev))
        v = torch.stack([rates.R1, rates.R2, rates.NOE], dim=-1)  # (nRes, 3)
        dv = None if rates.dR1 is None else torch.stack(
            [rates.dR1, rates.dR2, rates.dNOE], dim=-1)
        return v, dv

    def _inner(v, dv):
        sq = (v - exp_t) ** 2
        if dv is not None and err_t is not None:
            w = dv**2 + err_t**2
        elif dv is not None:
            w = dv**2
        elif err_t is not None:
            w = err_t**2
        else:
            return sq  # unweighted (reference :207)
        return sq / w

    def chisq_total(diso, s2s, csa):
        return torch.mean(_inner(*_predict(diso, s2s, csa)))

    def chisq_res(diso, s2s, csa):
        return torch.mean(_inner(*_predict(diso, s2s, csa)), dim=-1)  # (nRes,)

    return chisq_total, chisq_res


def fit_legacy(
    mode: str,
    pair: NucleusPair,
    diffusion: Diffusion,
    cts: CtModelSet,
    exp: np.ndarray,
    exp_err: Optional[np.ndarray],
    vecs=None,
    weights=None,
    csa0: Optional[np.ndarray] = None,
    max_cycles: int = 100,
    tol: float = 1e-6,
    method: str = "powell",
    verbose: bool = False,
) -> LegacyFitResult:
    """``method``: 'powell' reproduces the reference's optimiser (direction
    matrices included); 'gradient' minimises the same chi-square with
    L-BFGS-B on autograd gradients; 'device' (mode='new' only) runs the
    alternating Diso / per-residue-CSA fit on the device, reading one
    flag a golden round and one a cycle, and its result in one read.
    The fit runs on the device of ``cts``."""
    from scipy.optimize import fmin_powell

    dev = cts.S2.device
    n_res = cts.n_models
    if csa0 is None:
        csa0 = np.full(n_res, pair.csa_value)
    csa = np.asarray(csa0, dtype=float).copy()
    diso0 = float(np.asarray(diffusion.diso))
    csa_mean0 = float(np.mean(csa))

    chisq_total, chisq_res = _make_chisq(pair, diffusion, cts, vecs, weights, exp, exp_err)

    def val(x) -> float:
        return float(host(x)[0])

    def full(c):
        return torch.full((n_res,), float(c), dtype=torch.float64, device=dev)

    if method == "gradient" and mode in ("Diso", "DisoS2", "DisoCSA", "DisoS2CSA"):
        return _fit_legacy_gradient(mode, chisq_total, diso0, csa, csa_mean0, n_res, verbose,
                                    dev)

    if method == "device":
        if mode != "new":
            raise ValueError(
                "method='device' is implemented for mode='new' only "
                "(the alternating fit; use 'powell' or 'gradient' for "
                f"mode={mode!r})"
            )
        return _fit_legacy_new_device(chisq_total, chisq_res, diso0, csa, max_cycles, tol, dev)

    csa_t = _arg(csa, dev)
    if mode == "Diso":
        f = lambda x: val(chisq_total(x[0], 1.0, csa_t))  # noqa: E731
        out = fmin_powell(f, x0=[diso0], direc=[[0.1 * diso0]], full_output=True, disp=verbose)
        return LegacyFitResult(float(np.ravel(out[0])[0]), 1.0, csa, float(out[1]), mode)

    if mode == "DisoS2":
        f = lambda x: val(chisq_total(x[0], x[1], csa_t))  # noqa: E731
        d_init = np.array([[0.1 * diso0, 0.1], [0.1 * diso0, -0.1]])
        out = fmin_powell(f, x0=[diso0, 1.0], direc=d_init, full_output=True, disp=verbose)
        return LegacyFitResult(float(out[0][0]), float(out[0][1]), csa, float(out[1]), mode)

    if mode == "DisoCSA":
        f = lambda x: val(chisq_total(x[0], 1.0, full(x[1])))  # noqa: E731
        d_init = np.array(
            [[0.1 * diso0, 0.1 * csa_mean0], [0.1 * diso0, -0.1 * csa_mean0]]
        )
        out = fmin_powell(f, x0=[diso0, csa_mean0], direc=d_init, full_output=True,
                          disp=verbose)
        return LegacyFitResult(
            float(out[0][0]), 1.0, np.full(n_res, float(out[0][1])), float(out[1]), mode
        )

    if mode == "DisoS2CSA":
        # Correlated Powell directions (reference :930-934): CSA and S2
        # both compensate for Diso.
        p_init = np.array([diso0, 1.0, csa_mean0])
        dmat = np.array(
            [
                [np.sqrt(1 / 3), np.sqrt(1 / 3), np.sqrt(1 / 3)],
                [-np.sqrt(2 / 3), np.sqrt(1 / 6), np.sqrt(1 / 6)],
                [0.0, np.sqrt(1 / 2), -np.sqrt(1 / 2)],
            ]
        )
        d_init = 0.1 * dmat * p_init
        f = lambda x: val(chisq_total(x[0], x[1], full(x[2])))  # noqa: E731
        out = fmin_powell(f, x0=p_init, direc=d_init, full_output=True, disp=verbose)
        return LegacyFitResult(
            float(out[0][0]), float(out[0][1]),
            np.full(n_res, float(out[0][2])), float(out[1]), mode,
        )

    if mode == "new":
        diso = diso0
        diso_prev = None
        first = True
        for r in range(max_cycles):
            csa_t = _arg(csa, dev)
            f = lambda x: val(chisq_total(np.atleast_1d(x)[0], 1.0, csa_t))  # noqa: E731
            out = fmin_powell(f, x0=diso, direc=[[0.1 * diso]], full_output=True, disp=False)
            diso, chi = float(np.ravel(out[0])[0]), float(out[1])
            if not first and np.allclose(diso, diso_prev, rtol=tol):
                break
            diso_prev = diso

            diso_t = _arg(diso, dev)
            csa_new = host(golden_vec(lambda c: chisq_res(diso_t, 1.0, c),
                                      _arg(csa - 150e-6, dev), _arg(csa + 150e-6, dev)))[0]
            # Compare consecutive rounds (new against the value entering
            # this round): a stale value from two rounds ago would both
            # delay the stop and converge falsely on a period-2 oscillation.
            converged = not first and np.allclose(csa_new, csa, rtol=tol)
            csa = csa_new
            if converged:
                break
            first = False
            if verbose:
                print(f"    ...round {r} complete. Diso={diso:g}")
        return LegacyFitResult(diso, 1.0, csa, val(chisq_total(diso, 1.0, _arg(csa, dev))), mode)

    raise ValueError(f"invalid optimisation mode {mode!r}")


def _fit_legacy_new_device(chisq_total, chisq_res, diso0, csa0, max_cycles, tol,
                           dev) -> LegacyFitResult:
    """mode='new' on the device: cycles alternating a bracket-expanding
    golden-section on log(Diso) (derivative-free like the reference's
    Powell, positivity structural) with the batched per-residue CSA
    golden-section.  The convergence flags are the host loop's (np.allclose
    with its default atol) and the global-convergence break comes before
    the local stage, as there.  The host reads one flag a golden round and
    one a cycle, and the result in one read."""

    def _close(a, b):
        # np.allclose(a, b, rtol=tol): |a-b| <= atol + rtol*|b| with the
        # default atol=1e-8, as the host path uses.
        return torch.abs(a - b) <= 1e-8 + tol * torch.abs(b)

    def _golden_diso(diso_c, csa):
        # 1-D minimisation over z with diso = diso_c e^z: z = 0 is the
        # current value; bracket edges re-centre and double (the
        # reference's Powell is unbounded).
        def f(zv):
            return chisq_total(diso_c * torch.exp(zv[0]), 1.0, csa)[None]

        best = torch.zeros(1, dtype=torch.float64, device=dev)
        hw = torch.full((1,), 0.2, dtype=torch.float64, device=dev)
        for it in range(8):
            lo = best - hw
            hi = best + hw
            best = golden_vec(f, lo, hi)
            at_edge = torch.minimum(best - lo, hi - best) < 0.01 * hw
            hw = torch.where(at_edge, 2.0 * hw, hw)
            if it == 7 or not bool(host(torch.any(at_edge))[0]):
                break
        return diso_c * torch.exp(best[0])

    diso = _arg(float(diso0), dev)
    csa = _arg(csa0, dev)
    for cyc in range(int(max_cycles)):
        diso_new = _golden_diso(diso, csa)
        csa_new = golden_vec(lambda c: chisq_res(diso_new, 1.0, c), csa - 150e-6, csa + 150e-6)
        if cyc == 0:
            done = torch.zeros((), dtype=torch.bool, device=dev)
            g_conv = done
        else:
            g_conv = _close(diso_new, diso)
            done = g_conv | torch.all(_close(csa_new, csa))
        # the global-convergence break comes before the local stage, so
        # its CSA update is dropped on g_conv
        csa = torch.where(g_conv, csa, csa_new)
        diso = diso_new
        if bool(host(done)[0]):
            break
    head, csa_h = host(torch.stack([diso, chisq_total(diso, 1.0, csa)]), csa)
    return LegacyFitResult(float(head[0]), 1.0, np.asarray(csa_h, dtype=float),
                           float(head[1]), "new")


def _fit_legacy_gradient(mode, chisq_total, diso0, csa, csa_mean0, n_res, verbose, dev):
    """L-BFGS-B with autograd gradients over the active parameter subset,
    scaled to O(1) (Diso ~ 1e-5, CSA ~ -1.7e-4); one read of (f, g) an
    iterate."""
    from scipy.optimize import minimize

    active = {
        "Diso": ("diso",),
        "DisoS2": ("diso", "s2s"),
        "DisoCSA": ("diso", "csa"),
        "DisoS2CSA": ("diso", "s2s", "csa"),
    }[mode]
    names = ("diso", "s2s", "csa")
    x0 = {"diso": diso0, "s2s": 1.0, "csa": csa_mean0}
    scales = {"diso": abs(diso0), "s2s": 1.0, "csa": max(abs(csa_mean0), 1e-6)}
    csa_t = _arg(csa, dev)

    def unpack(z):
        vals = dict(x0)
        for name, zi in zip(active, z):
            vals[name] = zi * scales[name]
        return vals

    def f_and_g(z):
        vals = unpack(z)
        p = torch.tensor([vals[n] for n in names], dtype=torch.float64,
                         device=dev).requires_grad_(True)
        c = torch.zeros_like(csa_t) + p[2] if "csa" in active else csa_t
        f = chisq_total(p[0], p[1], c)
        (g,) = torch.autograd.grad(f, p)
        h = host(torch.cat([f.detach()[None], g]))[0]
        gs = dict(zip(names, h[1:]))
        return float(h[0]), np.array([gs[n] * scales[n] for n in active])

    z0 = np.array([x0[n] / scales[n] for n in active])
    res = minimize(f_and_g, z0, jac=True, method="L-BFGS-B")
    vals = unpack(res.x)
    out_csa = np.full(n_res, vals["csa"]) if "csa" in active else csa
    if verbose:
        print(f"    ...gradient fit converged: {res.message}")
    return LegacyFitResult(
        float(vals["diso"]), float(vals["s2s"]), out_csa, float(res.fun), mode
    )
