"""The batched multi-exponential LM (port of ``spinrelax_tpu/fit/engine.py``).

``fit_multiexp_engine`` solves a (B, T) batch of bounded multi-exp fits
as ONE masked loop over all (B * n_starts) lanes, with exactly the
trust-region and convergence gates of ``fit.lm.lm_solve`` /
``fit.engine._engine_jit`` in the JAX package:

- lam0 = 1e-3, x0.33 on accept and x3 on reject, clamped to [1e-12, 1e10];
- accepted step with max|step| < 1e-10;
- accepted step with relative cost gain <= ftol = 10 ulp of the dtype;
- accepted step with ||step|| < sqrt(eps) (sqrt(eps) + ||t||), tested
  only while lam <= lam0;
- a stall window of 8 iterations improving the best cost by <= 8 ftol
  relative, tested only while lam <= 100 lam0;
- lam >= 1e6, or 60 iterations;
- ``skip`` lanes start done.

A finished lane is frozen; the loop runs while any lane is live.  An
iteration is one step function over fixed state tensors, the same code on
every device: on the CPU the host calls it while a lane is live; on the
card one step is captured in a CUDA graph and replayed, and the host asks
whether a lane is live once per stall window (``_run_graph``), not per
iteration.  A step is four calls of ``ops.cuda_lm`` (kernels for CUDA
float32, their plain versions for CPU tensors): kernel B's H = J^T J,
g = J^T r and cost on lag-major (T, B) operands, so the (B, T, P)
Jacobian is only built once, in the covariance tail; kernel D's damped
solve; kernel C's trial cost; kernel E's gates.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import cuda_lm
from ..utils import profiling
from .lm import (
    MultiExpFit, _finalise_multiexp, _init_multiexp, _mm, _multiexp_res_jac,
    _spd_inv_diag_small, _to_constrained, _to_unconstrained,
)


def _bounds(K: int, s2_free: bool, tau_max, dtype, device):
    lo = [0.0] * K + [1e-8] * K + ([0.0] if s2_free else [])
    hi = torch.tensor([1.0] * K + [0.0] * K + ([1.0] if s2_free else []),
                      dtype=dtype, device=device)
    hi[K : 2 * K] = tau_max
    return torch.tensor(lo, dtype=dtype, device=device), hi


def _look(live) -> bool:
    """The host's read of ``live``, counted in ``fit.host_looks``."""
    profiling.count("fit.host_looks")
    return bool(live)


def _run_eager(step, live, max_iter: int, window: int) -> int:
    """Call ``step`` while ``live`` (a bool scalar tensor the step keeps)
    is true; the host reads it every iteration.  Returns the steps run.
    (``max_iter`` and ``window`` are :func:`_run_graph`'s: the step itself
    clears ``live`` at ``max_iter``.)"""
    steps = 0
    while _look(live):
        step()
        steps += 1
    return steps


_SIDE_STREAMS: dict = {}


def _run_graph(step, live, max_iter: int, window: int, counters=()) -> int:
    """Run ``step`` on the current CUDA device until ``live`` (a bool
    scalar tensor the step keeps) is false or ``max_iter`` steps are done:
    the first step eagerly on a side stream (it also warms up what the
    capture may not do: loading the kernel library, first allocations),
    then one step captured in a CUDA graph on the same stream and replayed
    (:func:`_replay`).  The steps it overshoots by change nothing
    (``step`` freezes finished lanes).  ``counters``: the launch counters
    of the kernels one step launches (a replay calls no wrapper).  The
    graph and its memory pool live only inside this call; the side stream
    is one per device for the process (a new stream would get cuBLAS a
    new workspace, kept for the process).  Returns the steps run; a
    capture or replay that fails raises."""
    if max_iter < 1:
        return 0
    cur = torch.cuda.current_stream()
    side = _SIDE_STREAMS.setdefault(cur.device, torch.cuda.Stream(cur.device))
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        step()
    cur.wait_stream(side)
    if max_iter == 1:
        return 1
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):  # launches nothing; no wrapper counts it
        step()
    steps = _replay(graph.replay, live, 1, max_iter, window, counters)
    del graph
    return steps


def _replay(replay, live, steps: int, max_iter: int, window: int, counters=()) -> int:
    """Call ``replay`` from ``steps`` done up to ``max_iter``, reading
    ``live`` once per ``window`` steps (at multiples of ``window``) and
    stopping when it is false; each call adds one to every counter's
    ``launches``.  Returns the steps run."""
    while steps < max_iter:
        n = min(window - steps % window, max_iter - steps)
        for _ in range(n):
            replay()
        steps += n
        for c in counters:
            c.launches += n
        if not _look(live):
            break
    return steps


def fit_multiexp_engine(dt, decay, sigma, K: int, s2_free: bool,
                        n_starts: int = 1, skip=None,
                        max_iter: int = 60, init=None, info=None,
                        _eager: bool = False) -> MultiExpFit:
    """Batched bounded multi-exp fit (see module docstring).

    dt (T,), decay and sigma (B, T), all on one device in one dtype.
    skip : optional (B,) bool -- lanes created already done (their
        returned values are the projected initial guess).
    init : optional per-row start (C0 (B, K), tau0 (B, K), S20 (B,)) in
        place of the reference's cold initialiser (one start only); the
        pre-fit sum > 1 gate then reads these C0 and S20, as the JAX
        package's ``fit_multiexp_warm`` does.
    """
    dev, f = decay.device, decay.dtype
    dt = torch.as_tensor(dt, dtype=f, device=dev).contiguous()
    sigma = torch.as_tensor(sigma, dtype=f, device=dev)
    B, T = decay.shape
    P = cuda_lm.n_par(K, s2_free)
    tau_max = dt[-1] * 10.0

    # --- initialisation ------------------------------------------------
    # starts: (S, K) taus shared by every lane, or (1, B, K) per-row taus
    if init is not None:
        if n_starts != 1:
            raise ValueError("init gives one start per row: n_starts must be 1")
        C0, tau0_rows, S20 = (torch.as_tensor(a, dtype=f, device=dev) for a in init)
        starts = tau0_rows[None]
    else:
        C0, tau0_shared, S20 = _init_multiexp(dt, decay, K, s2_free)
        starts = tau0_shared[None]
    if n_starts > 1:
        # Deterministic extra starts drawn in float64 numpy, independent
        # of dtype and device (same draws as the JAX package).
        u = torch.as_tensor(
            np.random.default_rng(12345).uniform(size=(n_starts - 1, K)),
            dtype=f, device=dev,
        )
        step = torch.mean(dt[1:] - dt[:-1])
        lo_l, hi_l = torch.log(step * 0.5), torch.log(dt[-1] * 2.0)
        extra = torch.sort(torch.exp(lo_l + u * (hi_l - lo_l)), dim=1).values
        starts = torch.cat([starts, extra], dim=0)
    S = starts.shape[0]
    BS = B * S
    # start-major stacking: lane b, start s -> row s * B + b
    dec_s = decay.repeat(S, 1)
    sig_s = sigma.repeat(S, 1)
    C0_s = C0.repeat(S, 1)
    S20_s = S20.repeat(S)
    tau0_s = starts[0] if init is not None else starts.repeat_interleave(B, dim=0)
    if skip is None:
        done = torch.zeros(BS, dtype=torch.bool, device=dev)
    else:
        done = torch.as_tensor(skip, dtype=torch.bool, device=dev).repeat(S)

    p0 = torch.cat([C0_s, tau0_s] + ([S20_s[:, None]] if s2_free else []), dim=1)
    lo, hi = _bounds(K, s2_free, tau_max, f, dev)
    span = hi - lo

    # --- lag-major operands of the kernels ------------------------------
    y_t = dec_s.T.contiguous()
    isg_t = (1.0 / sig_s).T.contiguous()

    eps = torch.finfo(f).eps
    gates = cuda_lm.Gates(max_iter=max_iter, window=8, xtol=1e-10, ftol=10.0 * eps,
                          xtol_rel=float(np.sqrt(eps)), lam0=1e-3, lam_stuck=1e6)

    t = _to_unconstrained(p0, lo, hi)
    lam = torch.full((BS,), gates.lam0, dtype=f, device=dev)
    it = torch.zeros(BS, dtype=torch.int32, device=dev)
    c_best = torch.full((BS,), float("inf"), dtype=f, device=dev)
    c_mark = c_best.clone()
    live = torch.any((it < max_iter) & ~done)
    state = (t, lam, it, c_best, c_mark, done, live)
    pt = _to_constrained(t, lo, hi).T.contiguous()  # (P, BS): B's parameters

    def step():
        """One LM iteration over every lane: kernels B, D, C, E (their plain
        versions on the CPU), written into the state tensors and ``pt`` in
        place.  A lane that is done or out of iterations is frozen: the
        step changes nothing of it, so steps past the last live lane's
        end are no-ops."""
        H_p, g_p, c_old = cuda_lm.hgc(pt, y_t, isg_t, dt, K, s2_free)
        t_new, pt_trial, stats = cuda_lm.step_solve(H_p, g_p, t, lam, lo, span, live)
        c_new = cuda_lm.cost(pt_trial, y_t, isg_t, dt, K, s2_free)
        cuda_lm.step_gate(c_new, c_old, t_new, pt_trial, stats, state, pt, gates)

    if dev.type == "cuda" and not _eager:  # a step launches kernels B, D, C, E once each
        steps = _run_graph(step, live, max_iter, gates.window,
                           (cuda_lm.hgc_cuda, cuda_lm.step_solve_cuda, cuda_lm.cost_cuda,
                            cuda_lm.step_gate_cuda))
    else:
        steps = _run_eager(step, live, max_iter, gates.window)
    if info is not None:
        info.update(steps=steps, iterations=int(it.max()))
    p_fin = _to_constrained(t, lo, hi)  # (BS, P)

    # --- covariance tail + finalisation ----------------------------------
    r_fin, Jp = _multiexp_res_jac(p_fin, dt, dec_s, sig_s, K, s2_free)
    cost_fin = 0.5 * torch.sum(r_fin * r_fin, dim=1)
    H = _mm(Jp.transpose(1, 2), Jp)
    dof = max(T - P, 1)
    red_chisq = torch.sum(r_fin * r_fin, dim=1) / dof
    dead = torch.diagonal(H, dim1=1, dim2=2) == 0.0
    eye = torch.eye(P, dtype=f, device=dev)
    Hs = torch.where(dead[:, :, None] | dead[:, None, :], eye, H)
    var = torch.where(dead, torch.zeros_like(red_chisq)[:, None],
                      _spd_inv_diag_small(Hs)) * red_chisq[:, None]
    perr = torch.sqrt(torch.clamp(var, min=0.0))
    C = p_fin[:, :K]
    tau = p_fin[:, K : 2 * K]
    S2 = p_fin[:, -1] if s2_free else 1.0 - C.sum(dim=1)
    dS2 = perr[:, -1] if s2_free else torch.zeros_like(S2)
    fin = _finalise_multiexp(dt, dec_s, sig_s, C, tau, S2, perr[:, :K],
                             perr[:, K : 2 * K], dS2, C0_s, S20_s, s2_free)
    if S > 1:
        # best start per lane by final cost; ties keep the cold start.
        best = torch.argmin(cost_fin.reshape(S, B), dim=0)
        idx = best * B + torch.arange(B, device=dev)
        fin = tuple(a[idx] for a in fin)
    return MultiExpFit(*fin)
