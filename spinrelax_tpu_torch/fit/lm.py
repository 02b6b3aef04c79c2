"""Batched bounded Levenberg-Marquardt fits (port of ``spinrelax_tpu/fit/lm.py``).

Box constraints use the sigmoid reparameterisation; uncertainties come
from inv(J^T J) * reduced chi-square in the original parameter space
(curve_fit ``absolute_sigma=False``).  Functions here work on a batch axis
written out (the JAX package vmaps their single-problem forms).

Two LM loops share the JAX package's gates (``lm_solve``'s docstring):
``fit.engine`` for the multi-exponential fits of the ladder, whose
per-iteration products are kernels B and C on the card, and the generic
:func:`lm_solve` for any residual (the varpro and stacked ladders, the
legacy fits), whose products are plain torch as they are plain XLA in the
JAX package.  Every product of a float32 tensor off the CPU runs in
float64 (:func:`_mm`), so no TF32 setting reaches a fit.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch


class LMResult(NamedTuple):
    params: torch.Tensor  # (B, P) best-fit parameters (original space)
    perr: torch.Tensor  # (B, P) 1-sigma uncertainties
    cost: torch.Tensor  # (B,) final 0.5 * sum(r^2)
    n_iter: torch.Tensor  # (B,) iterations used
    converged: torch.Tensor  # (B,) bool


def _mm(a, b):
    """a @ b in IEEE arithmetic whatever torch's TF32 and matmul-precision
    settings say: a float32 product off the CPU runs in float64 and is
    rounded once to float32 (the JAX package's ``Precision.HIGHEST``)."""
    if a.dtype == torch.float32 and a.device.type != "cpu":
        return (a.double() @ b.double()).to(a.dtype)
    return a @ b


def _to_unconstrained(p, lo, hi):
    """Inverse sigmoid map into R (clipped slightly inside the box)."""
    f = torch.clamp((p - lo) / (hi - lo), 1e-6, 1.0 - 1e-6)
    return torch.log(f / (1.0 - f))


def _to_constrained(t, lo, hi):
    return lo + (hi - lo) * _sigmoid(t)


def _sigmoid(t):
    """1 / (1 + e^-t): on the CPU, unlike torch.sigmoid, each element rounds
    the same wherever it sits in a tensor (torch.sigmoid's vectorised body
    and scalar tail differ by an ulp), so :func:`lm_solve`'s lanes do not
    depend on the batch's size."""
    return 1.0 / (1.0 + torch.exp(-t))


def _chol_factor_small(A):
    """Lower Cholesky factor of a batch of TINY SPD matrices (..., P, P),
    unrolled over P; returned as a list of lists of (...) tensors.
    Non-PD input gives NaNs, the failure every caller guards for."""
    P = A.shape[-1]
    L = [[None] * P for _ in range(P)]
    for j in range(P):
        s = A[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        d = torch.sqrt(s)
        L[j][j] = d
        inv = 1.0 / d
        for i in range(j + 1, P):
            s2 = A[..., i, j]
            for k in range(j):
                s2 = s2 - L[i][k] * L[j][k]
            L[i][j] = s2 * inv
    return L


def _chol_solve_small(A, b):
    """Solve A x = b for a batch of TINY SPD A (..., P, P), b (..., P),
    by the unrolled Cholesky factor and two substitutions."""
    return _chol_subst(_chol_factor_small(A), b)


def _chol_subst(L, b):
    """Solve L L^T x = b from :func:`_chol_factor_small`'s factor: b[..., i]
    broadcasts against the factor's entries."""
    P = len(L)
    y = []
    for i in range(P):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y.append(s / L[i][i])
    x = [None] * P
    for i in reversed(range(P)):
        s = y[i]
        for k in range(i + 1, P):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


def _spd_inv_diag_small(A):
    """diag(A^-1) for a batch of TINY SPD A: (A^-1)_ii is the squared norm
    of column i of L^-1, one forward substitution per diagonal entry."""
    L = _chol_factor_small(A)
    P = len(L)
    diag = []
    for i in range(P):
        y = {i: 1.0 / L[i][i]}
        acc = y[i] * y[i]
        for r in range(i + 1, P):
            s = 0.0
            for k in range(i, r):
                s = s - L[r][k] * y[k]
            y[r] = s / L[r][r]
            acc = acc + y[r] * y[r]
        diag.append(acc)
    return torch.stack(diag, dim=-1)


def _batch_jac(fn, x):
    """fn(x) (B, N) and its Jacobian (B, N, P) for a batch of independent
    lanes x (B, P) -> (B, N), by forward mode: the tangent e_j on every
    lane at once gives column j of each lane's Jacobian (``jax.jacfwd``
    under the JAX package's vmap)."""
    B, P = x.shape
    basis = torch.eye(P, dtype=x.dtype, device=x.device)[:, None, :].expand(P, B, P)
    cols = torch.func.vmap(lambda v: torch.func.jvp(fn, (x,), (v,))[1])(basis)
    return fn(x), cols.permute(1, 2, 0)


def lm_solve(
    residual_fn: Callable,
    p0,
    lo,
    hi,
    max_iter: int = 60,
    lam0: float = 1e-3,
    xtol: float = 1e-10,
    n_par_eff=None,
    ftol=None,
    xtol_rel=None,
    stall_window: int = 8,
    lam_stuck: float = 1e6,
    cov: str | None = "pinv",
    residual_jac_fn: Callable | None = None,
    skip=None,
    info=None,
    _eager: bool = False,
) -> LMResult:
    """Minimise 0.5 ||residual_fn(p)||^2 subject to lo <= p <= hi, for a
    batch of independent problems (``spinrelax_tpu/fit/lm.py:146``).

    residual_fn maps (B, P) -> (B, N), lane b's residual depending on row b
    only.  p0, lo and hi are (B, P) or (P,) (B is the leading size of the
    two-dimensional ones, 1 if none is); lo and hi follow p0's dtype and
    device.  The gates are the JAX function's, per lane:

    - lam0, x0.33 on an accepted step and x3 on a rejected one, clamped to
      [1e-12, 1e10];
    - an accepted step with max|step| < ``xtol``;
    - an accepted step whose relative cost gain is <= ``ftol`` (default
      10 ulp of the dtype);
    - an accepted step with ||step|| < ``xtol_rel`` (xtol_rel + ||t||) in
      the unconstrained space (default sqrt(eps)), tested only while
      lam <= lam0;
    - a ``stall_window`` of iterations that improved the best cost by
      <= stall_window * ftol relative, tested only while the next lam is
      <= 100 lam0;
    - lam >= ``lam_stuck``, or ``max_iter`` iterations.

    A finished lane is frozen (its t, lam and iteration count stop), so a
    lane's result does not depend on the rest of the batch; ``skip`` (B,)
    bool lanes start finished and return the projected p0 after 0
    iterations.  ``residual_jac_fn`` p -> (r, J (B, N, P)) gives the
    analytic Jacobian in the original parameters (the box chain rule is
    applied here); without it the Jacobian is forward-mode AD
    (:func:`_batch_jac`).  ``n_par_eff`` (an int or (B,) tensor) replaces P
    in the reduced chi-square's degrees of freedom.  ``cov``: "pinv"
    (singular values <= 10 P eps of the largest dropped, as
    ``jnp.linalg.pinv``), "chol" (exactly dead rows and columns get zero
    variance) or None (no covariance: perr is NaN, for callers that
    discard it).

    The loop is ``fit.engine``'s: on a CPU tensor the host runs each step;
    on the card one step is captured in a CUDA graph and replayed, the
    host reading the live flag once per stall window (``_eager=True``,
    tests only, keeps the host loop).  ``info``, a dict, receives the steps
    run and the slowest lane's iterations.
    """
    from .engine import _run_eager, _run_graph

    if cov not in ("chol", "pinv", None):
        raise ValueError(f"unknown cov {cov!r} (chol|pinv)")
    p0 = torch.as_tensor(p0)
    lo = torch.as_tensor(lo, dtype=p0.dtype, device=p0.device)
    hi = torch.as_tensor(hi, dtype=p0.dtype, device=p0.device)
    P = p0.shape[-1]
    B = max([a.shape[0] for a in (p0, lo, hi) if a.ndim == 2], default=1)
    dev, f = p0.device, p0.dtype
    span = hi - lo
    eps = torch.finfo(f).eps
    ftol_v = 10.0 * eps if ftol is None else ftol
    xtol_rel_v = float(np.sqrt(eps)) if xtol_rel is None else xtol_rel

    def p_of_t(t):
        return lo + span * _sigmoid(t)

    def r_of_t(t):
        return residual_fn(p_of_t(t))

    def r_and_J_of_t(t):
        if residual_jac_fn is None:
            return _batch_jac(r_of_t, t)
        r, Jp = residual_jac_fn(p_of_t(t))
        s = _sigmoid(t)
        return r, Jp * (span * s * (1.0 - s))[:, None, :]

    t = _to_unconstrained(p0, lo, hi).expand(B, P).clone()
    lam = torch.full((B,), lam0, dtype=f, device=dev)
    it = torch.zeros(B, dtype=torch.int32, device=dev)
    c_best = torch.full((B,), float("inf"), dtype=f, device=dev)
    c_mark = c_best.clone()
    if skip is None:
        done = torch.zeros(B, dtype=torch.bool, device=dev)
    else:
        done = torch.as_tensor(skip, dtype=torch.bool, device=dev).expand(B).clone()
    live = torch.any((it < max_iter) & ~done)
    eye = torch.eye(P, dtype=f, device=dev)

    def step():
        """One iteration over every lane, written into the state tensors in
        place; a finished lane is frozen, so steps past the last live
        lane's end change nothing."""
        frozen = done | (it >= max_iter)
        r, J = r_and_J_of_t(t)
        Jt = J.transpose(1, 2)
        g = _mm(Jt, r[:, :, None])[:, :, 0]
        H = _mm(Jt, J)
        diag = torch.clamp(torch.diagonal(H, dim1=1, dim2=2), min=1e-12)
        A = H + lam[:, None, None] * eye * diag[:, None, :]
        step_v = -_chol_solve_small(A, g)
        t_new = t + step_v
        c_old = 0.5 * torch.sum(r * r, dim=1)
        r_new = r_of_t(t_new)
        c_new = 0.5 * torch.sum(r_new * r_new, dim=1)
        improved = (c_new < c_old) & torch.isfinite(c_new)
        t_next = torch.where(improved[:, None], t_new, t)
        lam_next = torch.where(improved, torch.clamp(lam * 0.33, min=1e-12),
                               torch.clamp(lam * 3.0, max=1e10))
        small = torch.amax(torch.abs(step_v), dim=1) < xtol
        flat = improved & ((c_old - c_new) <= ftol_v * c_old)
        small_rel = improved & (lam <= lam0) & (
            torch.linalg.vector_norm(step_v, dim=1)
            < xtol_rel_v * (xtol_rel_v + torch.linalg.vector_norm(t, dim=1))
        )
        c_best_next = torch.minimum(
            torch.minimum(c_best, torch.where(torch.isfinite(c_old), c_old, c_best)),
            torch.where(torch.isfinite(c_new), c_new, c_best),
        )
        at_window = (it + 1) % stall_window == 0
        stalled = (
            at_window & torch.isfinite(c_mark) & (lam_next <= 100.0 * lam0)
            & ((c_mark - c_best_next) <= stall_window * ftol_v * c_best_next)
        )
        done_next = (improved & small) | flat | small_rel | stalled | (lam_next >= lam_stuck)
        c_mark.copy_(torch.where(frozen | ~at_window, c_mark, c_best_next))
        c_best.copy_(torch.where(frozen, c_best, c_best_next))
        t.copy_(torch.where(frozen[:, None], t, t_next))
        lam.copy_(torch.where(frozen, lam, lam_next))
        it.copy_(torch.where(frozen, it, it + 1))
        done.copy_(done | (~frozen & done_next))
        live.copy_(torch.any((it < max_iter) & ~done))

    run = _run_graph if dev.type == "cuda" and not _eager else _run_eager
    steps = run(step, live, max_iter, stall_window)
    if info is not None:
        info.update(steps=steps, iterations=int(it.max()) if B else 0)
    p_fin = p_of_t(t)

    # Uncertainties in the original space (curve_fit absolute_sigma=False).
    if residual_jac_fn is None:
        r_fin, Jp = _batch_jac(residual_fn, p_fin)
    else:
        r_fin, Jp = residual_jac_fn(p_fin)
    ssq = torch.sum(r_fin * r_fin, dim=1)
    if cov is None:
        perr = torch.full_like(p_fin, float("nan"))
    else:
        H = _mm(Jp.transpose(1, 2), Jp)
        n_eff = P if n_par_eff is None else n_par_eff
        dof = torch.clamp(torch.as_tensor(r_fin.shape[1] - n_eff, device=dev), min=1)
        red_chisq = (ssq / dof)[:, None]
        if cov == "chol":
            dead = torch.diagonal(H, dim1=1, dim2=2) == 0.0
            Hs = torch.where(dead[:, :, None] | dead[:, None, :], eye, H)
            var = torch.where(dead, torch.zeros_like(p_fin),
                              _spd_inv_diag_small(Hs)) * red_chisq
        else:
            var = torch.diagonal(torch.linalg.pinv(H, rtol=10.0 * P * eps),
                                 dim1=1, dim2=2) * red_chisq
        perr = torch.sqrt(torch.clamp(var, min=0.0))
    return LMResult(p_fin, perr, 0.5 * ssq, it, done)


def _split(p, K: int, s2_free: bool):
    C = p[..., :K]
    tau = p[..., K : 2 * K]
    S2 = p[..., -1] if s2_free else 1.0 - C.sum(dim=-1)
    return C, tau, S2


def _multiexp_residual(p, dt, decay, sigma, K: int, s2_free: bool):
    """Residuals of S2 + sum C_i exp(-t/tau_i) (S2 = 1 - sum C when not
    free).  p (..., P), decay/sigma (..., T) -> (..., T)."""
    C, tau, S2 = _split(p, K, s2_free)
    model = S2[..., None] + torch.sum(
        C[..., None] * torch.exp(-dt / tau[..., None]), dim=-2
    )
    return (model - decay) / sigma


def _multiexp_res_jac(p, dt, decay, sigma, K: int, s2_free: bool):
    """Residual (..., T) and analytic Jacobian (..., T, P) in one pass:
    dr/dC_i = E_i/sigma (E_i - 1 when S2 = 1 - sum C), dr/dtau_i =
    C_i t/tau_i^2 E_i/sigma, dr/dS2 = 1/sigma."""
    C, tau, S2 = _split(p, K, s2_free)
    E = torch.exp(-dt / tau[..., None])  # (..., K, T)
    model = S2[..., None] + torch.sum(C[..., None] * E, dim=-2)
    r = (model - decay) / sigma
    dC = E if s2_free else E - 1.0
    dtau = (C / (tau * tau))[..., None] * dt * E
    cols = [dC, dtau]
    if s2_free:
        cols.append(torch.ones_like(E[..., :1, :]))
    J = torch.cat(cols, dim=-2).transpose(-1, -2) / sigma[..., None]
    return r, J


class MultiExpFit(NamedTuple):
    C: torch.Tensor  # (B, K)
    tau: torch.Tensor  # (B, K)
    S2: torch.Tensor  # (B,)
    dC: torch.Tensor
    dtau: torch.Tensor
    dS2: torch.Tensor
    chisq: torch.Tensor  # (B,) reference-style selection chi-square
    ok_fit: torch.Tensor  # (B,) finite params
    ok_err: torch.Tensor  # (B,) no dParam > param
    ok_sum: torch.Tensor  # (B,) S2 + sum(C) <= 1 (on the initial guess)


def _init_multiexp(dt, decay, K: int, s2_free: bool, n_sample: int = 10):
    """Initial guesses of initialise_for_fit_advanced
    (fitting_Ct_functions.py:359-374) for decay (..., T): log-spaced taus
    (K,) in dt's dtype, equal C (..., K), S2 (...)."""
    step = torch.mean(dt[1:] - dt[:-1])
    exps = torch.linspace(0.0, 1.0, K + 2, dtype=dt.dtype, device=dt.device)
    lo, hi = torch.log10(step), torch.log10(dt[-1] * 2.0)
    taus = (10.0 ** (lo + (hi - lo) * exps))[1:-1]
    avg_beg = decay[..., :n_sample].mean(dim=-1)
    avg_end = decay[..., -n_sample:].mean(dim=-1)
    C0 = torch.abs(avg_beg - avg_end) / K
    Cs = C0[..., None].expand(C0.shape + (K,))
    S2 = avg_end if s2_free else 1.0 - C0
    return Cs, taus, S2


def _finalise_multiexp(dt, y, sg, C, tau, S2, dC, dtau, dS2, C0, S20,
                       s2_free: bool):
    """Sort fast-to-slow, the reference's selection chi-square
    mean(sq / sigma) [sic], and the validity flags (fitting_Ct_functions.py
    203-209, 272-276, 321-341) for a batch (B, ...).  The sum check runs
    on the PRE-fit guesses, as the reference's does."""
    order = torch.argsort(tau, dim=-1, stable=True)
    C, tau, dC, dtau = (torch.gather(a, -1, order) for a in (C, tau, dC, dtau))
    model = S2[..., None] + torch.sum(
        C[..., None] * torch.exp(-dt / tau[..., None]), dim=-2
    )
    chisq = torch.mean((model - y) ** 2 / sg, dim=-1)
    params = [C, tau] + ([S2[..., None]] if s2_free else [])
    perrs = [dC, dtau] + ([dS2[..., None]] if s2_free else [])
    params_vec = torch.cat(params, dim=-1)
    perr_vec = torch.cat(perrs, dim=-1)
    ok_fit = torch.isfinite(params_vec).all(dim=-1)
    ok_err = ~((perr_vec > params_vec) | ~torch.isfinite(perr_vec)).any(dim=-1)
    if s2_free:
        ok_sum = (S20 + C0.sum(dim=-1)) <= 1.0 + 1e-12
    else:
        ok_sum = torch.ones_like(ok_fit)
    return C, tau, S2, dC, dtau, dS2, chisq, ok_fit, ok_err, ok_sum


def _on_engine(decay) -> bool:
    """Whether a fit of ``decay`` runs ``fit.engine``: on the CPU (the plain
    versions of kernels B and C) and for CUDA float32 (the kernels, which
    take float32 only).  A CUDA float64 fit runs :func:`_fit_one_dense`
    over the generic LM, as the JAX package keeps its vmapped lm_solve for
    everything but the TPU's float32 (``lm.py:580-590``)."""
    return decay.device.type != "cuda" or decay.dtype == torch.float32


def fit_multiexp(dt, decay, sigma, K: int, s2_free: bool,
                 n_starts: int = 1, info=None) -> MultiExpFit:
    """Fit a batch of decays with K transient components.

    dt (T,), decay and sigma (B, T).  Bounds follow the reference: C, S2
    in [0, 1], tau in [1e-8, 10 t_max].  n_starts > 1 adds n_starts - 1
    deterministic tau starts and keeps the lowest-cost solution per
    residue (ties keep the cold start).  Runs ``fit.engine`` (its
    per-iteration evaluation is kernels B and C for CUDA float32 and their
    plain versions on the CPU), or for CUDA float64 the same gates over
    the generic LM (:func:`_on_engine`).  ``info``: the LM's optional dict
    of steps and iterations.
    """
    if not _on_engine(decay):
        return MultiExpFit(*_fit_one_dense(dt, decay, sigma, K, s2_free, n_starts=n_starts,
                                           info=info))
    from .engine import fit_multiexp_engine

    return fit_multiexp_engine(dt, decay, sigma, K, s2_free, n_starts=n_starts,
                               info=info)


def fit_multiexp_warm(dt, decay, sigma, C0, tau0, S20, K: int,
                      s2_free: bool, info=None) -> MultiExpFit:
    """:func:`fit_multiexp` from caller-given PER-ROW initial parameters
    instead of the reference's cold initialiser: the DoF ladder's warm
    retry (``fit.expfit``).  C0, tau0 (B, K), S20 (B,).  Bounds and gates
    are fit_multiexp's; the pre-fit sum > 1 gate reads these C0 and S20,
    as the cold path reads its own guesses.  Runs where
    :func:`fit_multiexp` does: on the card in float32 every iteration is
    kernels B and C."""
    if not _on_engine(decay):
        return MultiExpFit(*_fit_one_dense(dt, decay, sigma, K, s2_free,
                                           init=(C0, tau0, S20), info=info))
    from .engine import fit_multiexp_engine

    return fit_multiexp_engine(dt, decay, sigma, K, s2_free, init=(C0, tau0, S20),
                               info=info)


def _fit_one_dense(dt, y, sg, K: int, s2_free: bool, n_starts: int = 1, skip=None,
                   info=None, init=None):
    """:func:`fit_multiexp` through the generic :func:`lm_solve`
    (``spinrelax_tpu/fit/lm.py:487``, batched): the cold (optionally
    multi-start) LM with ``cov="chol"`` and the analytic Jacobian ->
    :func:`_finalise_multiexp`'s tuple.  y, sg (B, T); ``skip`` (B,) bool
    lanes return the projected initial guess, to be discarded; ``init``
    (C0 (B, K), tau0 (B, K), S20 (B,)) starts each row there instead
    (``fit_multiexp_warm``, ``lm.py:603``; one start).  The CPU and CUDA
    float32 run ``fit.engine`` instead, the same gates over kernels B and
    C (:func:`_on_engine`)."""
    from .engine import _bounds

    B, T = y.shape
    dev, f = y.device, y.dtype
    dt = torch.as_tensor(dt, dtype=f, device=dev)
    sg = torch.as_tensor(sg, dtype=f, device=dev)
    if init is not None:
        if n_starts != 1:
            raise ValueError("init gives one start per row: n_starts must be 1")
        C0, tau0, S20 = (torch.as_tensor(a, dtype=f, device=dev) for a in init)
    else:
        C0, tau0, S20 = _init_multiexp(dt, y, K, s2_free)
    starts = tau0[None]
    if n_starts > 1:
        # the engine's deterministic extra starts (float64 numpy draws)
        u = torch.as_tensor(np.random.default_rng(12345).uniform(size=(n_starts - 1, K)),
                            dtype=f, device=dev)
        step = torch.mean(dt[1:] - dt[:-1])
        lo_l, hi_l = torch.log(step * 0.5), torch.log(dt[-1] * 2.0)
        extra = torch.sort(torch.exp(lo_l + u * (hi_l - lo_l)), dim=1).values
        starts = torch.cat([starts, extra], dim=0)
    S = starts.shape[0]
    # start-major stacking: lane b, start s -> row s * B + b
    ys, sgs = y.repeat(S, 1), sg.repeat(S, 1)
    tau_rows = starts[0] if init is not None else starts.repeat_interleave(B, dim=0)
    p0 = torch.cat([C0.repeat(S, 1), tau_rows]
                   + ([S20.repeat(S)[:, None]] if s2_free else []), dim=1)
    lo, hi = _bounds(K, s2_free, dt[-1] * 10.0, f, dev)
    res = lm_solve(
        lambda p: _multiexp_residual(p, dt, ys, sgs, K, s2_free), p0, lo, hi,
        cov="chol",
        residual_jac_fn=lambda p: _multiexp_res_jac(p, dt, ys, sgs, K, s2_free),
        skip=None if skip is None else torch.as_tensor(skip, device=dev).repeat(S),
        info=info,
    )
    params, perr = res.params, res.perr
    if S > 1:
        # the lowest final cost per lane; ties keep the cold start
        idx = torch.argmin(res.cost.reshape(S, B), dim=0) * B + torch.arange(B, device=dev)
        params, perr = params[idx], perr[idx]
    C = params[:, :K]
    S2 = params[:, -1] if s2_free else 1.0 - C.sum(dim=1)
    dS2 = perr[:, -1] if s2_free else torch.zeros_like(S2)
    return _finalise_multiexp(dt, y, sg, C, params[:, K : 2 * K], S2, perr[:, :K],
                              perr[:, K : 2 * K], dS2, C0, S20, s2_free)


def _varpro_solve(tau, dt, y, sg, s2_free: bool):
    """The variable-projection amplitudes at taus (B, K)
    (``spinrelax_tpu/fit/lm.py:690-716``): coef = (C[, S2]) solves the
    ridged normal system G coef = b, G = Aw Aw^T + ridge I, b = Aw yw, with
    Aw the basis rows (E_i[, 1], or E_i - 1 when S2 = 1 - sum C) over
    sigma and ridge = 1e-10 + 32 eps max(diag(Aw Aw^T)).  Returns
    (E, Aw, yw, diag(Aw Aw^T), its max, G's Cholesky factor with a
    broadcast axis, coef)."""
    E = torch.exp(-dt / tau[..., None])  # (B, K, T)
    if s2_free:
        A, tgt = torch.cat([E, torch.ones_like(E[:, :1])], dim=1), y
    else:
        A, tgt = E - 1.0, y - 1.0
    Aw = A / sg[:, None, :]
    yw = tgt / sg
    G = _mm(Aw, Aw.transpose(1, 2))
    b = _mm(Aw, yw[:, :, None])[:, :, 0]
    gdiag = torch.diagonal(G, dim1=1, dim2=2)
    gmax = torch.amax(gdiag, dim=1)
    ridge = 1e-10 + 32.0 * torch.finfo(G.dtype).eps * gmax
    eye = torch.eye(G.shape[-1], dtype=G.dtype, device=G.device)
    L = _chol_factor_small((G + ridge[:, None, None] * eye)[:, None])
    coef = _chol_subst(L, b[:, None, :])[:, 0]
    return E, Aw, yw, gdiag, gmax, L, coef


def _varpro_res_jac(tau, dt, y, sg, K: int, s2_free: bool, jac: bool):
    """The variable-projection residual at taus (B, K) (amplitudes from
    :func:`_varpro_solve`) and, with ``jac``, its analytic Jacobian
    (B, T, K).  tau_j moves row j of Aw by Fw_j = E_j t / tau_j^2 / sigma,
    so with u_j = Aw Fw_j, dG = e_j u_j^T + u_j e_j^T + dridge I and
    db = e_j (Fw_j . yw), and dcoef = G^-1 (db - dG coef).  The ridge's
    derivative follows the max's, shared equally among tied diagonal
    entries as ``jnp.max``'s is."""
    E, Aw, yw, gdiag, gmax, L, coef = _varpro_solve(tau, dt, y, sg, s2_free)
    C = coef[:, :K]
    S2 = coef[:, -1] if s2_free else 1.0 - C.sum(dim=1)
    model = S2[:, None] + torch.sum(C[..., None] * E, dim=1)
    r = (model - y) / sg
    if not jac:
        return r
    F = E * dt / (tau * tau)[..., None]  # dE_j / dtau_j
    Fw = F / sg[:, None, :]
    u = _mm(Fw, Aw.transpose(1, 2))  # (B, K, M): u[j, m] = Fw_j . Aw_m
    fy = _mm(Fw, yw[:, :, None])[:, :, 0]
    # d diag(G)_m / dtau_j = 2 u[j, j] if m == j: the max's share of it
    ties = (gdiag == gmax[:, None]).to(gdiag.dtype)
    dmax = 2.0 * torch.diagonal(u[:, :, :K], dim1=1, dim2=2) * ties[:, :K] \
        / ties.sum(dim=1, keepdim=True)
    dridge = 32.0 * torch.finfo(gdiag.dtype).eps * dmax
    eyeKM = torch.eye(K, coef.shape[1], dtype=coef.dtype, device=coef.device)
    rhs = ((fy - torch.sum(u * coef[:, None, :], dim=2))[:, :, None] * eyeKM
           - u * coef[:, :K, None] - dridge[:, :, None] * coef[:, None, :])
    dcoef = _chol_subst(L, rhs)  # (B, K, M): dcoef[j] = d coef / d tau_j
    dC = dcoef[:, :, :K]
    dS2 = dcoef[:, :, -1] if s2_free else -dC.sum(dim=2)
    dmodel = dS2[:, :, None] + _mm(dC, E) + C[:, :, None] * F
    return r, (dmodel / sg[:, None, :]).transpose(1, 2)


def fit_multiexp_varpro(dt, decay, sigma, K: int, s2_free: bool, max_iter: int = 30,
                        info=None) -> MultiExpFit:
    """Variable-projection fit of the K-component multi-exponential
    (``spinrelax_tpu/fit/lm.py:657``): the model is linear in (C, S2), so
    for any taus the amplitudes solve a (K+1)^2 weighted normal system in
    closed form (:func:`_varpro_res_jac`), and :func:`lm_solve` iterates
    over the K taus alone (bounds [1e-8, 10 t_max], ``max_iter`` 30).  The
    amplitudes are unconstrained, unlike the reference's [0, 1] box.  The
    uncertainties come from the full joint (C, tau[, S2]) Jacobian at the
    solution (:func:`_spd_inv_diag_small`), and the sort, chi-square and
    flags from :func:`_finalise_multiexp`, as :func:`fit_multiexp`'s.

    dt (T,), decay and sigma (B, T) on one device in one dtype.  ``info``:
    :func:`lm_solve`'s dict of steps and iterations.
    """
    dev, f = decay.device, decay.dtype
    dt = torch.as_tensor(dt, dtype=f, device=dev)
    sigma = torch.as_tensor(sigma, dtype=f, device=dev)
    B, T = decay.shape
    C0, tau0, S20 = _init_multiexp(dt, decay, K, s2_free)
    res = lm_solve(
        lambda tau: _varpro_res_jac(tau, dt, decay, sigma, K, s2_free, False),
        tau0.expand(B, K), torch.full((K,), 1e-8, dtype=f, device=dev),
        (dt[-1] * 10.0).expand(K), max_iter=max_iter, cov=None,
        residual_jac_fn=lambda tau: _varpro_res_jac(tau, dt, decay, sigma, K, s2_free,
                                                    True),
        info=info,
    )
    tau = res.params
    coef = _varpro_solve(tau, dt, decay, sigma, s2_free)[-1]
    C = coef[:, :K]
    S2 = coef[:, -1] if s2_free else 1.0 - C.sum(dim=1)
    p_full = torch.cat([C, tau] + ([S2[:, None]] if s2_free else []), dim=1)
    r_fin, Jp = _multiexp_res_jac(p_full, dt, decay, sigma, K, s2_free)
    dof = max(T - p_full.shape[1], 1)
    var = _spd_inv_diag_small(_mm(Jp.transpose(1, 2), Jp)) \
        * (torch.sum(r_fin * r_fin, dim=1) / dof)[:, None]
    perr = torch.sqrt(torch.clamp(var, min=0.0))
    dS2 = perr[:, -1] if s2_free else torch.zeros_like(S2)
    return MultiExpFit(*_finalise_multiexp(dt, decay, sigma, C, tau, S2, perr[:, :K],
                                           perr[:, K : 2 * K], dS2, C0, S20, s2_free))


def fit_multiexp_ladder(dt, decays, sigma, tau0_rows, specs, Kmax: int,
                        info=None) -> MultiExpFit:
    """Every ladder rung over one (B, T) batch in one stacked LM
    (``spinrelax_tpu/fit/lm.py:761``), the rungs tiled on the decays'
    device, so they are sent there once.  specs: (K, s2_free) per rung;
    tau0_rows (R, Kmax) each rung's initial taus.  Returns the stacked
    MultiExpFit of batch R * B, rung-major."""
    dev, f = decays.device, decays.dtype
    R, B = len(specs), decays.shape[0]
    Kv = torch.tensor([k for k, _ in specs], device=dev).repeat_interleave(B)
    s2 = torch.tensor([s for _, s in specs], device=dev).repeat_interleave(B)
    t0 = torch.as_tensor(tau0_rows, dtype=f, device=dev).repeat_interleave(B, dim=0)
    return _fit_multiexp_stacked_core(dt, decays.repeat(R, 1),
                                      torch.as_tensor(sigma, dtype=f, device=dev).repeat(R, 1),
                                      Kv, s2, t0, Kmax, info=info)


def fit_multiexp_stacked(dt, decay, sigma, Kvals, s2free, tau0, Kmax: int,
                         info=None) -> MultiExpFit:
    """One batched LM over a heterogeneous batch of multi-exp problems
    (``spinrelax_tpu/fit/lm.py:782``): lane b has its own K_b <= Kmax
    (``Kvals`` (B,)) and S2 freedom (``s2free`` (B,) bool), from the initial
    taus ``tau0`` (B, Kmax) (the padding's are not used).  Inactive
    components are frozen by masking: their Jacobian columns are exactly
    zero, so the step never moves them and ``cov="pinv"`` gives them zero
    variance.  Returns MultiExpFit with (B, Kmax) component arrays, the
    active ones first, fast to slow, the padding (C 0) last."""
    return _fit_multiexp_stacked_core(dt, decay, sigma, Kvals, s2free, tau0, Kmax,
                                      info=info)


def _fit_multiexp_stacked_core(dt, decay, sigma, Kvals, s2free, tau0, Kmax: int,
                               info=None) -> MultiExpFit:
    from .engine import _bounds

    dev, f = decay.device, decay.dtype
    dt = torch.as_tensor(dt, dtype=f, device=dev)
    sigma = torch.as_tensor(sigma, dtype=f, device=dev)
    K = torch.as_tensor(Kvals, device=dev)
    s2f = torch.as_tensor(s2free, dtype=torch.bool, device=dev)
    t0 = torch.as_tensor(tau0, dtype=f, device=dev)
    mask = (torch.arange(Kmax, device=dev) < K[:, None]).to(f)  # (B, Kmax)
    act = mask > 0
    # initialise_for_fit_advanced on the active slots (_init_multiexp's)
    avg_beg = decay[:, :10].mean(dim=1)
    avg_end = decay[:, -10:].mean(dim=1)
    c0 = torch.abs(avg_beg - avg_end) / K
    C0 = torch.where(act, c0[:, None], torch.full_like(mask, 0.5))
    S20 = torch.where(s2f, avg_end, 1.0 - c0)
    p0 = torch.cat([C0, torch.where(act, t0, dt[-1]), S20[:, None]], dim=1)
    lo, hi = _bounds(Kmax, True, dt[-1] * 10.0, f, dev)
    s2w = s2f.to(f)[:, None]

    def model_parts(p):
        C = p[:, :Kmax] * mask
        tau = p[:, Kmax : 2 * Kmax]
        S2 = torch.where(s2f, p[:, -1], 1.0 - C.sum(dim=1))
        return C, tau, S2

    def residual(p):
        C, tau, S2 = model_parts(p)
        model = S2[:, None] + torch.sum(C[..., None] * torch.exp(-dt / tau[..., None]), dim=1)
        return (model - decay) / sigma

    def res_jac(p):
        # _multiexp_res_jac masked: an inactive component keeps exactly zero
        # columns (C's by the mask, tau's through C_i = 0)
        C, tau, S2 = model_parts(p)
        E = torch.exp(-dt / tau[..., None])  # (B, Kmax, T)
        model = S2[:, None] + torch.sum(C[..., None] * E, dim=1)
        r = (model - decay) / sigma
        dC = mask[..., None] * torch.where(s2f[:, None, None], E, E - 1.0)
        dtau = (C / (tau * tau))[..., None] * dt * E
        dS2 = s2w[..., None] * torch.ones_like(E[:, :1])
        J = torch.cat([dC, dtau, dS2], dim=1).transpose(1, 2) / sigma[..., None]
        return r, J

    n_eff = 2 * K + s2f.to(K.dtype)
    res = lm_solve(residual, p0, lo, hi, n_par_eff=n_eff, residual_jac_fn=res_jac,
                   info=info)
    C, tau, S2 = model_parts(res.params)
    dC = res.perr[:, :Kmax]
    dtau = res.perr[:, Kmax : 2 * Kmax]
    dS2 = torch.where(s2f, res.perr[:, -1], torch.zeros_like(S2))
    # fast to slow with the padding last, so [:K] are the active components
    order = torch.argsort(torch.where(act, tau, torch.full_like(tau, float("inf"))),
                          dim=1, stable=True)
    C, tau, dC, dtau, mask_s = (torch.gather(a, 1, order) for a in (C, tau, dC, dtau, mask))
    model = S2[:, None] + torch.sum((C * mask_s)[..., None] * torch.exp(-dt / tau[..., None]),
                                    dim=1)
    chisq = torch.mean((model - decay) ** 2 / sigma, dim=1)  # sic: sigma, not sigma^2
    # validity flags over the active parameters only
    act_v = torch.cat([mask_s, mask_s, s2w], dim=1) > 0
    params_vec = torch.cat([C, tau, S2[:, None]], dim=1)
    perr_vec = torch.cat([dC, dtau, dS2[:, None]], dim=1)
    ok_fit = (torch.isfinite(params_vec) | ~act_v).all(dim=1)
    ok_err = ~((perr_vec > params_vec) & act_v).any(dim=1)
    ok_sum = torch.where(s2f, (S20 + torch.sum(C0 * mask, dim=1)) <= 1.0 + 1e-12,
                         torch.ones_like(s2f))
    return MultiExpFit(C, tau, S2, dC, dtau, dS2, chisq, ok_fit, ok_err, ok_sum)
