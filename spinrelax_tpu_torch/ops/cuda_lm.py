"""Kernels B and C: the multi-exponential LM's per-iteration evaluation on
the GPU (``csrc/lm_hgc.cu``).

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
"""

from __future__ import annotations

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
