"""Kernel A: Palmer C(t) lag sums on the GPU (``csrc/acf_lag_sums.cu``).

Replaces ``spinrelax_tpu/ops/pallas_acf.py:acf_sums_pallas``.  The kernel
computes s[d, b] = sum_{t < F-d} (v_b(t) . v_b(t+d))^2 for d = 1..D by the
direct lag sum, one block per bond, in f32 with f64 block accumulation;
see the source for its design and what bounds it.  Its plain version is
``ops.autocorr.acf_sums_plain``.

The kernel reads a (nOuter, nInner, F, 3) bond view in place from its
strides, so the chunk layout (nRep, F, nRes, 3) seen as (nRep, nRes, F, 3)
and the pretiled (nTiles, 3, F, 128) seen as (nTiles, 128, F, 3) need no
copy.  Output is lag-major (D, nOuter * nInner).
"""

from __future__ import annotations

import torch

from .. import _build

_LAGS, _TBLK = 8, 32  # csrc/acf_lag_sums.cu LAGS, TBLK
MAX_SMEM_BYTES = 232_448  # dynamic shared memory one H100 block may use
_INT32_MAX = 2**31 - 1


def smem_bytes(n_frames: int) -> int:
    """Shared memory of one block (csrc/acf_lag_sums.cu smem_bytes)."""
    n = n_frames + _TBLK + _LAGS
    return 3 * (n + (n >> 5) + 1) * 4


def supports(n_frames: int, n_deltas: int) -> bool:
    """True when the kernel takes this chunk shape: 1 <= D < F and the
    bond's frames fit in one block's shared memory (F up to ~18 000)."""
    return 1 <= n_deltas < n_frames and smem_bytes(n_frames) <= MAX_SMEM_BYTES


def acf_lag_sums(v: torch.Tensor, n_deltas: int) -> torch.Tensor:
    """v : (nOuter, nInner, F, 3) CUDA float32 view (any strides) ->
    (n_deltas, nOuter * nInner) float32 lag sums, bond index
    outer * nInner + inner.  Raises on anything the kernel does not take;
    there is no CPU path here (``ops.autocorr.acf_sums`` dispatches)."""
    if not v.is_cuda:
        raise ValueError("acf_lag_sums launches a CUDA kernel; got a CPU tensor")
    if v.dtype != torch.float32:
        raise TypeError(f"acf_lag_sums takes float32, got {v.dtype}")
    if v.ndim != 4 or v.shape[-1] != 3:
        raise ValueError(f"expected (nOuter, nInner, F, 3), got {tuple(v.shape)}")
    n_outer, n_inner, n_frames, _ = v.shape
    if not supports(n_frames, n_deltas):
        raise ValueError(
            f"acf_lag_sums: unsupported chunk shape F={n_frames}, D={n_deltas}"
        )
    n_bonds = n_outer * n_inner
    if n_bonds < 1 or n_bonds > _INT32_MAX or n_deltas * n_bonds > 2**62:
        raise ValueError(f"acf_lag_sums: unsupported bond count {n_bonds}")
    s_outer, s_inner, s_t, s_c = v.stride()
    out = torch.empty((n_deltas, n_bonds), dtype=torch.float32, device=v.device)
    lib = _build.load()
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        code = lib.acf_lag_sums_f32(
            v.data_ptr(), out.data_ptr(), n_bonds, n_frames, n_deltas,
            n_inner, s_outer, s_inner, s_t, s_c, stream,
        )
    _build.check(code, "acf_lag_sums_f32")
    acf_lag_sums.launches += 1
    return out


acf_lag_sums.launches = 0
