"""Batched bounded multi-exponential fits (port of ``spinrelax_tpu/fit/lm.py``:
the cold, multi-start and warm-started fits).

Box constraints use the sigmoid reparameterisation; uncertainties come
from inv(J^T J) * reduced chi-square in the original parameter space
(curve_fit ``absolute_sigma=False``).  The LM loop itself lives in
``fit.engine`` -- the port's only LM -- which :func:`fit_multiexp`
calls on every device.  Functions here work on a batch axis written out
(the JAX package vmaps their single-problem forms).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def _to_unconstrained(p, lo, hi):
    """Inverse sigmoid map into R (clipped slightly inside the box)."""
    f = torch.clamp((p - lo) / (hi - lo), 1e-6, 1.0 - 1e-6)
    return torch.log(f / (1.0 - f))


def _to_constrained(t, lo, hi):
    return lo + (hi - lo) * torch.sigmoid(t)


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
    L = _chol_factor_small(A)
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


def fit_multiexp(dt, decay, sigma, K: int, s2_free: bool,
                 n_starts: int = 1, info=None) -> MultiExpFit:
    """Fit a batch of decays with K transient components.

    dt (T,), decay and sigma (B, T).  Bounds follow the reference: C, S2
    in [0, 1], tau in [1e-8, 10 t_max].  n_starts > 1 adds n_starts - 1
    deterministic tau starts and keeps the lowest-cost solution per
    residue (ties keep the cold start).  Runs ``fit.engine`` on every
    device: its per-iteration evaluation is kernels B and C for CUDA
    float32 and their plain versions on the CPU.  ``info``: the engine's
    optional dict of steps and iterations.
    """
    from .engine import fit_multiexp_engine

    return fit_multiexp_engine(dt, decay, sigma, K, s2_free, n_starts=n_starts,
                               info=info)


def fit_multiexp_warm(dt, decay, sigma, C0, tau0, S20, K: int,
                      s2_free: bool, info=None) -> MultiExpFit:
    """:func:`fit_multiexp` from caller-given PER-ROW initial parameters
    instead of the reference's cold initialiser: the DoF ladder's warm
    retry (``fit.expfit``).  C0, tau0 (B, K), S20 (B,).  Bounds and gates
    are fit_multiexp's; the pre-fit sum > 1 gate reads these C0 and S20,
    as the cold path reads its own guesses.  Runs ``fit.engine``, so on
    the card every iteration is kernels B and C."""
    from .engine import fit_multiexp_engine

    return fit_multiexp_engine(dt, decay, sigma, K, s2_free, init=(C0, tau0, S20),
                               info=info)
