"""Kernels B to E: the multi-exponential LM's step on the GPU
(``csrc/lm_hgc.cu``: B and C; ``csrc/lm_step.cu``: D and E).

Replace ``spinrelax_tpu/ops/pallas_lm.py:hgc`` and ``:cost``.  For each
problem b of a batch, with the model S2 + sum_k C_k exp(-t/tau_k) and
residual r = (model - y) * isg over T lags:

  ``hgc``  : H = J^T J (B, P, P), g = J^T r (B, P), 0.5 ||r||^2 (B,)
  ``cost`` : 0.5 ||r||^2 (B,) only (the trial step)

Operands are lag-major: p (P, B) constrained parameters (rows C_0..C_{K-1},
tau_0..tau_{K-1}, (S2)), y and isg (T, B), dt (T,).  Each wrapper launches
its kernel for CUDA float32 operands (counting the launch) and runs the
plain PyTorch version for CPU tensors; anything else raises.

On the card the operands' bytes (4.1 MB at the forward's B = 1024, T = 500,
resident in L2 across the LM's iterations) and launch latency bound both
kernels.  A block takes 8 problems x all lags, split over 16 or 32 lag
slices and reduced in a fixed order (no atomics), so results repeat bit for
bit and kernel C's cost equals kernel B's for equal p.  Kernel B writes H
whole (B, P, P), g and cost into one buffer; the wrapper returns views of
it.  K = 1..K_NARROW run those templates; K_NARROW < K <= K_MAX run one
runtime-K variant that keeps a tile's Jacobian rows in shared memory (P up
to 33 gives 595 sums a problem, too many for one thread's registers).  See
``csrc/lm_hgc.cu``.

Kernels D and E have no Pallas twin: they are the XLA fusions of the loop
body of ``spinrelax_tpu/fit/engine.py:_engine_jit`` around B and C, so that
a step of ``fit.engine`` is four launches (B, D, C, E):

  ``step_solve`` (D): the sigmoid chain rule, the damped matrix and its
      Cholesky solve -> t_new (B, P), C's trial parameters (P, B) and
      (max |step|, ||step||, ||t||) (3, B); clears ``live``.
  ``step_gate`` (E): the trust-region and convergence gates, in place on
      the state (t, lam, it, c_best, c_mark, done, live) and on B's
      parameters (P, B) for the next step.

Their plain versions are the engine's torch glue, operation for operation
in its order (on the CPU the engine's bits do not change).  See
``csrc/lm_step.cu``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import _build

K_NARROW = 4  # K = 1..4: templates per (K, S2 free or fixed)
K_MAX = 16  # K = 5..16: the runtime-K variant (P <= 33)


def n_par(K: int, s2_free: bool) -> int:
    return 2 * K + (1 if s2_free else 0)


def _residual(p, y, isg, dt, K: int, s2_free: bool):
    """Residual (T, B) and the K exponentials exp(-t / tau_k) (T, B)."""
    E = [torch.exp(-dt[:, None] / p[K + k]) for k in range(K)]
    if s2_free:
        S2 = p[2 * K]
    else:
        S2 = 1.0
        for k in range(K):
            S2 = S2 - p[k]
    model = S2 + sum(p[k] * E[k] for k in range(K))
    return (model - y) * isg, E


def hgc_plain(p, y, isg, dt, K: int, s2_free: bool):
    """Plain version of kernel B: (H (B, P, P), g (B, P), cost (B,))."""
    r, E = _residual(p, y, isg, dt, K, s2_free)
    planes = [(E[k] if s2_free else E[k] - 1.0) * isg for k in range(K)]
    planes += [(p[k] / (p[K + k] * p[K + k])) * dt[:, None] * E[k] * isg
               for k in range(K)]
    if s2_free:
        planes.append(isg.expand_as(r))
    # Problem-major (B, T, P) and (B, T): every problem's sums over the
    # lags take the same order whatever the batch's size (a lag-major sum
    # over a (T, 1) column would take another on the CPU).
    J = torch.stack(planes, dim=-1).transpose(0, 1).contiguous()  # already * isg
    rb = r.T.contiguous()
    H = J.transpose(1, 2) @ J
    g = (J.transpose(1, 2) @ rb[:, :, None])[:, :, 0]
    return H, g, 0.5 * torch.sum(rb * rb, dim=1)


def cost_plain(p, y, isg, dt, K: int, s2_free: bool):
    """Plain version of kernel C: 0.5 ||r||^2 (B,)."""
    r, _ = _residual(p, y, isg, dt, K, s2_free)
    rb = r.T.contiguous()
    return 0.5 * torch.sum(rb * rb, dim=1)


def check_shapes(name, p, y, isg, dt, K, s2_free):
    """(T, B) of operands the kernels take at this K; raises otherwise
    (the device and dtype checks are :func:`_check_cuda`'s)."""
    if not 1 <= K <= K_MAX:
        raise ValueError(f"{name}: kernels take K = 1..{K_MAX}, got {K}")
    T, B = y.shape
    if (p.shape != (n_par(K, s2_free), B) or isg.shape != (T, B)
            or dt.shape != (T,) or B < 1 or T < 1 or T * B >= 2**62):
        raise ValueError(
            f"{name}: shapes p {tuple(p.shape)}, y {tuple(y.shape)}, "
            f"isg {tuple(isg.shape)}, dt {tuple(dt.shape)} do not match "
            f"K={K}, s2_free={s2_free}"
        )
    return T, B


def _check_cuda(name, p, y, isg, dt, K, s2_free):
    for t in (p, y, isg, dt):
        if not t.is_cuda:
            raise ValueError(f"{name}: operands must all be on the GPU")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    return check_shapes(name, p, y, isg, dt, K, s2_free)


def _launch(fn_name, p, y, isg, dt, out, T, B, K, s2_free):
    lib = _build.load()
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        code = getattr(lib, fn_name)(
            p.data_ptr(), y.data_ptr(), isg.data_ptr(), dt.data_ptr(),
            out.data_ptr(), T, B, K, int(s2_free), stream,
        )
    _build.check(code, fn_name)


def _launched() -> int:
    """1 for a call that launched its kernel, 0 for one recorded into a
    CUDA graph under capture (nothing runs until the graph is replayed;
    whoever replays it counts the launches: ``fit.engine._run_graph``)."""
    return 0 if torch.cuda.is_current_stream_capturing() else 1


def hgc_cuda(p, y, isg, dt, K: int, s2_free: bool):
    """Kernel B on CUDA float32 operands -> (H, g, cost), contiguous views
    of the one buffer the kernel writes."""
    T, B = _check_cuda("hgc", p, y, isg, dt, K, s2_free)
    P = n_par(K, s2_free)
    out = torch.empty(B * (P * P + P + 1), dtype=torch.float32, device=y.device)
    _launch("lm_hgc_f32", p, y, isg, dt, out, T, B, K, s2_free)
    hgc_cuda.launches += _launched()
    n_h, n_g = B * P * P, B * P
    return (out[:n_h].view(B, P, P), out[n_h : n_h + n_g].view(B, P),
            out[n_h + n_g :])


def cost_cuda(p, y, isg, dt, K: int, s2_free: bool):
    """Kernel C on CUDA float32 operands -> cost (B,)."""
    T, B = _check_cuda("cost", p, y, isg, dt, K, s2_free)
    out = torch.empty((B,), dtype=torch.float32, device=y.device)
    _launch("lm_cost_f32", p, y, isg, dt, out, T, B, K, s2_free)
    cost_cuda.launches += _launched()
    return out


hgc_cuda.launches = 0
cost_cuda.launches = 0


def hgc(p, y, isg, dt, K: int, s2_free: bool):
    """H/g/cost: kernel B for CUDA tensors, :func:`hgc_plain` on the CPU."""
    if y.is_cuda:
        return hgc_cuda(p, y, isg, dt, K, s2_free)
    return hgc_plain(p, y, isg, dt, K, s2_free)


def cost(p, y, isg, dt, K: int, s2_free: bool):
    """0.5 ||r||^2: kernel C for CUDA tensors, :func:`cost_plain` on the CPU."""
    if y.is_cuda:
        return cost_cuda(p, y, isg, dt, K, s2_free)
    return cost_plain(p, y, isg, dt, K, s2_free)


# --- kernels D and E: the LM step around B and C ---------------------------


class Gates(NamedTuple):
    """The engine's stopping thresholds (``fit.engine``'s module docstring);
    the kernel takes each as float32, as the plain version's tensors
    compare with them."""
    max_iter: int
    window: int  # the stall window, in iterations
    xtol: float
    ftol: float
    xtol_rel: float
    lam0: float
    lam_stuck: float


def step_solve_plain(H_p, g_p, t, lam, lo, span, live):
    """Plain version of kernel D (``fit.engine``'s glue between B and C):
    from B's H_p (B, P, P) and g_p (B, P), the unconstrained t (B, P),
    lam (B,) and the box lo, span = hi - lo (P,) -> (t_new (B, P), the
    trial parameters lo + span sigmoid(t_new) (P, B) for kernel C, stats
    (3, B): max |step|, ||step||, ||t||).  Clears ``live``, which
    :func:`step_gate_plain` sets again."""
    from ..fit.lm import _chol_solve_small, _sigmoid

    P = t.shape[1]
    eye = torch.eye(P, dtype=t.dtype, device=t.device)
    s = _sigmoid(t)
    D = span * s * (1.0 - s)  # (B, P) chain rule
    H = H_p * D[:, :, None] * D[:, None, :]
    g = g_p * D
    diag = torch.clamp(torch.diagonal(H, dim1=1, dim2=2), min=1e-12)
    A = H + lam[:, None, None] * eye * diag[:, None, :] * eye
    step_v = -_chol_solve_small(A, g)
    t_new = t + step_v
    pt_new = (lo + span * _sigmoid(t_new)).T.contiguous()
    stats = torch.stack([torch.amax(torch.abs(step_v), dim=1),
                         torch.linalg.vector_norm(step_v, dim=1),
                         torch.linalg.vector_norm(t, dim=1)])
    live.zero_()
    return t_new, pt_new, stats


def step_gate_plain(c_new, c_old, t_new, pt_trial, stats, state, pt, gates: Gates):
    """Plain version of kernel E: the engine's gates on one step, written in
    place into ``state`` = (t, lam, it, c_best, c_mark, done, live) and
    into B's parameters ``pt`` (P, B), which take ``pt_trial``'s columns
    where the step is taken.  A lane that is done or out of iterations is
    frozen: nothing of it changes."""
    t, lam, it, c_best, c_mark, done, live = state
    max_iter, window, xtol, ftol, xtol_rel, lam0, lam_stuck = gates
    frozen = done | (it >= max_iter)
    improved = (c_new < c_old) & torch.isfinite(c_new)
    t_next = torch.where(improved[:, None], t_new, t)
    lam_next = torch.where(improved, torch.clamp(lam * 0.33, min=1e-12),
                           torch.clamp(lam * 3.0, max=1e10))
    small = stats[0] < xtol
    flat = improved & ((c_old - c_new) <= ftol * c_old)
    small_rel = improved & (lam <= lam0) & (stats[1] < xtol_rel * (xtol_rel + stats[2]))
    c_best_next = torch.minimum(
        torch.minimum(c_best, torch.where(torch.isfinite(c_old), c_old, c_best)),
        torch.where(torch.isfinite(c_new), c_new, c_best),
    )
    at_window = (it + 1) % window == 0
    stalled = (
        at_window & torch.isfinite(c_mark) & (lam_next <= 100.0 * lam0)
        & ((c_mark - c_best_next) <= window * ftol * c_best_next)
    )
    done_next = (improved & small) | flat | small_rel | stalled | (lam_next >= lam_stuck)
    pt.copy_(torch.where((~frozen & improved)[None, :], pt_trial, pt))
    c_mark.copy_(torch.where(frozen | ~at_window, c_mark, c_best_next))
    c_best.copy_(torch.where(frozen, c_best, c_best_next))
    t.copy_(torch.where(frozen[:, None], t, t_next))
    lam.copy_(torch.where(frozen, lam, lam_next))
    it.copy_(torch.where(frozen, it, it + 1))
    done.copy_(done | (~frozen & done_next))
    live.copy_(torch.any((it < max_iter) & ~done))


def _check_step(name, floats, ints=(), bools=()):
    for x in floats + ints + bools:
        if not x.is_cuda:
            raise ValueError(f"{name}: operands must all be on the GPU")
        if not x.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    for xs, dtype in ((floats, torch.float32), (ints, torch.int32), (bools, torch.bool)):
        for x in xs:
            if x.dtype != dtype:
                raise TypeError(f"{name} takes {dtype} here, got {x.dtype}")


def _shape_error(name, **shapes):
    return ValueError(f"{name}: shapes " + ", ".join(
        f"{k} {tuple(v.shape)}" for k, v in shapes.items()) + " do not match")


def step_solve_cuda(H_p, g_p, t, lam, lo, span, live):
    """Kernel D on CUDA float32 operands -> (t_new, pt_trial, stats),
    contiguous views of the one buffer the kernel writes (see
    :func:`step_solve_plain`)."""
    _check_step("step_solve", (H_p, g_p, t, lam, lo, span), bools=(live,))
    B, P = t.shape
    if (not 2 <= P <= n_par(K_MAX, True) or H_p.shape != (B, P, P) or g_p.shape != (B, P)
            or lam.shape != (B,) or lo.shape != (P,) or span.shape != (P,)
            or live.shape != ()):
        raise _shape_error("step_solve", H_p=H_p, g_p=g_p, t=t, lam=lam, lo=lo, span=span,
                           live=live)
    out = torch.empty(B * (2 * P + 3), dtype=torch.float32, device=t.device)
    t_new, pt_new, stats = (out[: B * P].view(B, P), out[B * P : 2 * B * P].view(P, B),
                            out[2 * B * P :].view(3, B))
    lib = _build.load()
    with torch.cuda.device(t.device):
        code = lib.lm_step_solve_f32(
            H_p.data_ptr(), g_p.data_ptr(), t.data_ptr(), lam.data_ptr(), lo.data_ptr(),
            span.data_ptr(), t_new.data_ptr(), pt_new.data_ptr(), stats.data_ptr(),
            live.data_ptr(), B, P, torch.cuda.current_stream(t.device).cuda_stream)
    _build.check(code, "lm_step_solve_f32")
    step_solve_cuda.launches += _launched()
    return t_new, pt_new, stats


def step_gate_cuda(c_new, c_old, t_new, pt_trial, stats, state, pt, gates: Gates):
    """Kernel E on CUDA operands (float32; ``it`` int32, ``done`` and
    ``live`` bool), in place (see :func:`step_gate_plain`).  ``live`` must
    have been cleared since the last gate (kernel D does it)."""
    t, lam, it, c_best, c_mark, done, live = state
    _check_step("step_gate", (c_new, c_old, t_new, pt_trial, stats, t, lam, c_best, c_mark, pt),
                ints=(it,), bools=(done, live))
    B, P = t.shape
    if (not 1 <= P <= n_par(K_MAX, True) or t_new.shape != (B, P)
            or pt_trial.shape != (P, B) or pt.shape != (P, B) or stats.shape != (3, B)
            or live.shape != ()
            or any(x.shape != (B,) for x in (c_new, c_old, lam, it, c_best, c_mark, done))):
        raise _shape_error("step_gate", c_new=c_new, c_old=c_old, t_new=t_new,
                           pt_trial=pt_trial, stats=stats, t=t, pt=pt, live=live)
    g = gates
    lib = _build.load()
    with torch.cuda.device(t.device):
        code = lib.lm_step_gate_f32(
            *(x.data_ptr() for x in (c_new, c_old, t_new, pt_trial, stats, t, lam, it, c_best,
                                     c_mark, done, live, pt)),
            B, P, g.max_iter, g.window, g.xtol, g.ftol, g.window * g.ftol, g.xtol_rel, g.lam0,
            100.0 * g.lam0, g.lam_stuck, torch.cuda.current_stream(t.device).cuda_stream)
    _build.check(code, "lm_step_gate_f32")
    step_gate_cuda.launches += _launched()


step_solve_cuda.launches = 0
step_gate_cuda.launches = 0


def step_solve(H_p, g_p, t, lam, lo, span, live):
    """Kernel D for CUDA tensors, :func:`step_solve_plain` on the CPU."""
    if t.is_cuda:
        return step_solve_cuda(H_p, g_p, t, lam, lo, span, live)
    return step_solve_plain(H_p, g_p, t, lam, lo, span, live)


def step_gate(c_new, c_old, t_new, pt_trial, stats, state, pt, gates: Gates):
    """Kernel E for CUDA tensors, :func:`step_gate_plain` on the CPU."""
    if t_new.is_cuda:
        return step_gate_cuda(c_new, c_old, t_new, pt_trial, stats, state, pt, gates)
    return step_gate_plain(c_new, c_old, t_new, pt_trial, stats, state, pt, gates)
