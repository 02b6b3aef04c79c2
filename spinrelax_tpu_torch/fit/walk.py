"""The DoF-ladder walk: every rung's cold batched LM and the reference's
sequential model selection (port of ``spinrelax_tpu/fit/walk.py:42
fit_ct_walk``).

The selection rules are fitting_Ct_functions.py:278-304 as the JAX walk
vectorises them (walk.py:138-173): a row takes a rung whose fit passes
its quality gates and at least halves (``chisq_threshold``) the chi of
the rung it holds; it breaks out at the first rung that fails either, and
is never fitted again.  NaN comparisons follow the reference (NaN >= x is
False, so a finite-parameter, NaN-chisq rung is taken).  Rows that never
take a rung keep the rung of least finite chisq (``np.nanargmin``, rung 0
when none is finite).

Each rung is fitted over the still-active rows only, gathered and
scattered back (the JAX host walk, expfit.py:373-399): kernels B and C
cost what they are given, and every LM lane is independent of the others
in its batch, so the result equals fitting everyone with broken lanes
frozen (the JAX in-graph walk), which ``tests/test_walk.py`` pins equal to
the host walk.
"""

from __future__ import annotations

import torch

from ..ops import cuda_lm
from . import lm

__all__ = ["fit_ct_walk", "on_mesh", "traced", "traced_fit"]

_MODEL = ("C", "tau", "dC", "dtau", "mask", "S2", "dS2", "chisq", "s2fast")
# The kernels of one step of fit.engine, by the trace's names.
_STEP_KERNELS = {"B": cuda_lm.hgc_cuda, "C": cuda_lm.cost_cuda,
                 "D": cuda_lm.step_solve_cuda, "E": cuda_lm.step_gate_cuda}


def traced(trace, record: dict, fn):
    """Run ``fn(info)``, one LM call of the ladder; with a ``trace`` list,
    append ``record`` plus the LM's steps and slowest lane's iterations
    (its ``info``; on the card the steps round the iterations up to the
    host's next look) and the launches of kernels B, C, D and E the call
    made, read from their counters around it (0 on the CPU; on the card
    one each a step of ``fit.engine``, none for ``lm.lm_solve``)."""
    before = [c.launches for c in _STEP_KERNELS.values()]
    info = None if trace is None else {}
    out = fn(info)
    if trace is not None:
        trace.append(dict(record, **info, **{
            f"launches_{k}": c.launches - n
            for (k, c), n in zip(_STEP_KERNELS.items(), before)}))
    return out


def on_mesh(mesh, fit, arrays, rungs: int = 1):
    """``fit(*arrays)`` -> MultiExpFit over the rows of ``arrays`` (equal
    leading axes); with a mesh, each rank fits its residue slice
    (``parallel.mesh.pad_and_shard``: row-0 copies pad to a multiple of
    the rank count) and one gather of the packed fields gives every rank
    the whole fit.  ``rungs``: the fit returns ``rungs`` rung-major copies
    of the rows (``lm.fit_multiexp_ladder``)."""
    if mesh is None:
        return fit(*arrays)
    from ..parallel import mesh as pm

    local, n = pm.pad_and_shard(mesh, arrays)
    out = fit(*local)
    b = local[0].shape[0]
    f = out.C.dtype
    cols = [a.reshape(rungs, b, -1).to(f) for a in out]
    packed = pm.all_gather(torch.cat(cols, dim=2), pm.group(mesh), dim=1)[:, :n]
    fields, i = [], 0
    for a, c in zip(out, cols):
        v = packed[:, :, i : i + c.shape[2]].reshape((rungs * n,) + tuple(a.shape[1:]))
        fields.append(v > 0.5 if a.dtype == torch.bool else v.to(a.dtype))
        i += c.shape[2]
    return type(out)(*fields)


def traced_fit(trace, stage: str, dt, decays, sigma, K: int, s2_free: bool,
               n_starts: int = 1, init=None, optimiser: str = "lm", mesh=None):
    """One multi-exp fit of the ladder over (B, T) decays: the cold
    ``lm.fit_multiexp`` (``optimiser="lm"``) or ``lm.fit_multiexp_varpro``
    (``"varpro"``), or ``lm.fit_multiexp_warm`` from ``init`` = (C0, tau0,
    S20), recorded by :func:`traced` as {stage, K, s2_free, rows, starts,
    steps, iterations, launches_B .. launches_E}; with a ``mesh``, on this
    rank's rows and gathered (:func:`on_mesh`; the record's steps,
    iterations and launches are this rank's)."""
    record = dict(stage=stage, K=K, s2_free=s2_free, rows=decays.shape[0],
                  starts=n_starts)
    rows = (decays, sigma) + tuple(init or ())
    if init is not None:
        def fit(info, d, s, *p0):
            return lm.fit_multiexp_warm(dt, d, s, *p0, K, s2_free, info=info)
    elif optimiser == "varpro":
        def fit(info, d, s):
            return lm.fit_multiexp_varpro(dt, d, s, K, s2_free, info=info)
    else:
        def fit(info, d, s):
            return lm.fit_multiexp(dt, d, s, K, s2_free, n_starts=n_starts, info=info)
    return traced(trace, record,
                  lambda info: on_mesh(mesh, lambda *a: fit(info, *a), rows))


def fit_ct_walk(dt, decays, sigma, chisq_threshold: float, specs, Kmax: int,
                n_starts: int = 1, trace=None, optimiser: str = "lm",
                fit_rung=None, mesh=None) -> dict:
    """Run the ladder walk over (B, T) ``decays`` / ``sigma``.

    specs : (K, s2_free) per rung, in walk order; Kmax : max K of specs.
    trace : optional list; each rung's LM call appends its record
        (:func:`traced_fit`).
    optimiser : the rungs' cold fit, "lm" or "varpro" (:func:`traced_fit`).
    fit_rung : optional ``(i, rows) -> MultiExpFit`` giving rung i's fit of
        the rows ``rows`` (its components [:K]) in place of a cold fit: the
        stacked ladder's slices of its one LM.
    mesh : optional ("rep", "res") mesh: each rung's LM runs on the rank's
        slice of the rows, and the walk runs on every rank over the
        gathered fits (:func:`on_mesh`).

    Returns a dict of tensors on the decays' device:
      C, tau, dC, dtau, mask (B, Kmax)  the selected model (tau pads 1,
                                        the others 0)
      S2, dS2, chisq, s2fast (B,)       of the selected rung
      sel_idx (B,) long                 selected rung (fallback rows carry
                                        their nanargmin rung)
      sel_chi (B,)                      the walk's running chi (inf for
                                        fallback rows)
      qfail (B,) long                   first rung where the row broke on
                                        failed quality gates, -1 for none
                                        (the escalation's trigger)
    """
    B = decays.shape[0]
    dev, f = decays.device, decays.dtype
    zB = torch.zeros(B, dtype=f, device=dev)
    zBK = torch.zeros((B, Kmax), dtype=f, device=dev)
    sel = dict(C=zBK, tau=torch.ones_like(zBK), dC=zBK, dtau=zBK, mask=zBK,
               S2=zB, dS2=zB, chisq=zB, s2fast=zB)
    fb = dict(sel)  # the fallback track: least finite chisq so far
    fb_cmp = torch.full((B,), float("inf"), dtype=f, device=dev)
    fb_idx = torch.zeros(B, dtype=torch.long, device=dev)
    sel_idx = torch.full((B,), -1, dtype=torch.long, device=dev)
    sel_chi = torch.full((B,), float("inf"), dtype=f, device=dev)
    act = torch.ones(B, dtype=torch.bool, device=dev)
    qfail = torch.full((B,), -1, dtype=torch.long, device=dev)

    for i, (K, s2f) in enumerate(specs):
        rung = dict(C=torch.zeros_like(zBK), tau=torch.ones_like(zBK),
                    dC=torch.zeros_like(zBK), dtau=torch.zeros_like(zBK),
                    mask=torch.zeros_like(zBK))
        rung["mask"][:, :K] = 1.0
        for k in ("S2", "dS2", "chisq"):
            rung[k] = torch.full((B,), float("nan"), dtype=f, device=dev)
        rung["s2fast"] = torch.full((B,), float(s2f), dtype=f, device=dev)
        ok = torch.zeros(B, dtype=torch.bool, device=dev)
        rows = torch.nonzero(act).squeeze(1)
        if rows.numel():
            if fit_rung is None:
                fit = traced_fit(trace, "rung", dt, decays[rows], sigma[rows], K, s2f,
                                 n_starts=n_starts, optimiser=optimiser, mesh=mesh)
            else:
                fit = fit_rung(i, rows)
            for k in ("C", "tau", "dC", "dtau"):
                rung[k][rows, :K] = getattr(fit, k)[:, :K]
            for k in ("S2", "dS2", "chisq"):
                rung[k][rows] = getattr(fit, k)
            ok[rows] = fit.ok_fit & fit.ok_err & fit.ok_sum
        chi = rung["chisq"]
        unset = sel_idx < 0
        brk = act & ~unset & (~ok | (chi >= sel_chi * chisq_threshold))
        take = act & ok & ~brk
        for k in sel:
            w = take[:, None] if sel[k].ndim == 2 else take
            sel[k] = torch.where(w, rung[k], sel[k])
        sel_idx = torch.where(take, i, sel_idx)
        sel_chi = torch.where(take, chi, sel_chi)
        qfail = torch.where((qfail < 0) & brk & ~ok, i, qfail)
        act = act & ~brk
        # Fallback: strict improvement over the least finite chisq so far
        # (rung 0 seeds it unconditionally; NaN never wins).
        better = chi < fb_cmp
        upd = better if i else torch.ones_like(better)
        for k in fb:
            w = upd[:, None] if fb[k].ndim == 2 else upd
            fb[k] = torch.where(w, rung[k], fb[k])
        fb_idx = torch.where(better, i, fb_idx)
        fb_cmp = torch.where(better, chi, fb_cmp)

    use_fb = sel_idx < 0
    out = {}
    for k in _MODEL:
        w = use_fb[:, None] if sel[k].ndim == 2 else use_fb
        out[k] = torch.where(w, fb[k], sel[k])
    out.update(sel_idx=torch.where(use_fb, fb_idx, sel_idx), sel_chi=sel_chi,
               qfail=qfail)
    return out
