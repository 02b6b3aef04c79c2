"""Judging a multi-exponential C(t) fit in plain torch.

A fitted model is S2 + sum_k C_k exp(-t / tau_k), with S2 free (an
S2_fast model) or 1 - sum_k C_k, weighted by the C(t)'s SEM sigma (1
where sigma is not positive).  :func:`selection_chisq` is the published
selection statistic mean((model - y)^2 / sigma) [sic];
:func:`refine` runs a bounded Levenberg-Marquardt from given parameters
on sum(((model - y) / sigma)^2) and returns the least cost it reaches,
so the relative drop from a fit's own parameters says how far the fit
stopped short of its minimum."""

from __future__ import annotations

import torch


def _parts(p, K: int, mask, s2free):
    C = p[:, :K] * mask
    tau = p[:, K: 2 * K]
    S2 = torch.where(s2free, p[:, 2 * K], 1.0 - C.sum(1))
    return C, tau, S2


def model(t, S2, C, tau, mask):
    """(B, T) curves of (B,) S2 and (B, K) C, tau, mask at times t (T,)."""
    safe = torch.where(tau > 0, tau, torch.ones_like(tau))
    return S2[:, None] + ((C * mask)[..., None] * torch.exp(-t / safe[..., None])).sum(1)


def weights(sigma):
    return torch.where(sigma > 0, sigma, torch.ones_like(sigma))


def selection_chisq(t, y, sigma, S2, C, tau, mask):
    return ((model(t, S2, C, tau, mask) - y) ** 2 / weights(sigma)).mean(1)


def refine(t, y, sigma, S2, C, tau, mask, s2free, n_iter: int = 100):
    """(least cost (B,), cost at the start (B,), (S2, C, tau) there) of a
    bounded LM (C, S2 in [0, 1], tau in [1e-8, 10 t_max]) started at the
    given parameters, in the dtype of ``y``.  Padded components (mask 0)
    stay out of the fit."""
    B, K = C.shape
    dt = y.dtype
    s2free = s2free.to(torch.bool)
    p = torch.cat([C, tau, S2[:, None]], 1).to(dt)
    lo = torch.zeros_like(p)
    lo[:, K: 2 * K] = 1e-8
    hi = torch.ones_like(p)
    hi[:, K: 2 * K] = 10.0 * float(t[-1])
    free = torch.cat([mask, mask, s2free[:, None].to(dt)], 1) > 0
    sg = weights(sigma)

    def resid(q):
        Cq, tq, Sq = _parts(q, K, mask, s2free)
        return (model(t, Sq, Cq, tq, mask) - y) / sg

    def jac(q):
        Cq, tq, Sq = _parts(q, K, mask, s2free)
        E = torch.exp(-t / tq[..., None])  # (B, K, T)
        dC = mask[..., None] * torch.where(s2free[:, None, None], E, E - 1.0)
        dtau = (Cq / tq ** 2)[..., None] * t * E
        dS = s2free[:, None, None].to(dt) * torch.ones_like(E[:, :1])
        Jm = torch.cat([dC, dtau, dS], 1) / sg[:, None, :]
        return Jm * free[..., None]

    r = resid(p)
    f0 = f = (r * r).sum(1)
    lam = torch.full((B,), 1e-3, dtype=dt, device=y.device)
    eye = torch.eye(p.shape[1], dtype=dt, device=y.device)
    for _ in range(n_iter):
        J = jac(p)
        A = J @ J.transpose(1, 2)
        g = (J * r[:, None, :]).sum(-1)
        diag = torch.diagonal(A, dim1=1, dim2=2) + (~free).to(dt)
        M = A + lam[:, None, None] * torch.diag_embed(diag) + (~free).to(dt)[:, None, :] * eye
        step, info = torch.linalg.solve_ex(M, -g[..., None])
        step = torch.where((info == 0)[:, None], step[..., 0], torch.zeros_like(p))
        p_new = torch.clamp(p + step * free, lo, hi)
        r_new = resid(p_new)
        f_new = (r_new * r_new).sum(1)
        ok = torch.isfinite(f_new) & (f_new < f)
        p = torch.where(ok[:, None], p_new, p)
        r = torch.where(ok[:, None], r_new, r)
        f = torch.where(ok, f_new, f)
        lam = torch.where(ok, lam * 0.3, lam * 10.0).clamp(1e-12, 1e12)
    C_, tau_, S2_ = _parts(p, K, mask, s2free)
    return f, f0, (S2_, C_, tau_)


def control_fit(t, y, sigma, device) -> dict:
    """The control's fits: a K = 2, S2_fast model from a fixed start, fitted
    by the reference LM in float32 to the control's own C(t)."""
    B = y.shape[0]
    f = dict(dtype=torch.float32, device=device)
    t, y, sg = (torch.as_tensor(a, **f) for a in (t, y, sigma))
    S2 = torch.full((B,), 0.8, **f)
    C = torch.tensor([0.05, 0.1], **f).expand(B, 2).contiguous()
    tau = torch.tensor([10.0, 200.0], **f).expand(B, 2).contiguous()
    mask = torch.ones((B, 2), **f)
    s2free = torch.ones(B, dtype=torch.bool, device=device)
    _, _, (S2, C, tau) = refine(t, y, sg, S2, C, tau, mask, s2free)
    chisq = selection_chisq(t, y, sg, S2, C, tau, mask)
    return {k: v.double().cpu().numpy() for k, v in
            dict(S2=S2, C=C, tau=tau, mask=mask, s2free=s2free, chisq=chisq).items()}
