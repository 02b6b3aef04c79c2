"""Kernel A: Palmer C(t) lag sums on the GPU (``csrc/acf_lag_sums.cu``).

Replaces ``spinrelax_tpu/ops/pallas_acf.py:acf_sums_pallas``.  The kernel
computes s[d, b] = sum_{t < F-d} (v_b(t) . v_b(t+d))^2 for d = 1..D by the
direct lag sum in f32 with f64 accumulation.  It is bound by FP32 issue (4
instructions per (t, d) term; 1.283 ms for the forward's 32 x 1024 bonds
of 1000 frames at D = 500).  A thread owns the lag windows p and nW-1-p of
one bond, so every thread walks ~2F - D frames; nb bonds share a block,
staged and stored coalesced.  See the source for the design.  Its plain
version is ``ops.autocorr.acf_sums_plain``.

The kernel reads a (nOuter, nInner, F, 3) bond view in place from its
strides, so the chunk layout (nRep, F, nRes, 3) seen as (nRep, nRes, F, 3)
and the pretiled (nTiles, 3, F, 128) seen as (nTiles, 128, F, 3) need no
copy.  Output is lag-major (D, nOuter * nInner).

A chunk whose bond planes do not fit one block's shared memory (F above
~18 700) takes the slab plan: one block per (bond, block of SLAB_LAGS
lags), walking the frames in slabs of SLAB (:class:`SlabPlan`).  Every
1 <= D < F within int32 indexing has a plan.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import _build

# csrc/acf_lag_sums.cu constexprs
LAGS, TBLK = 8, 32  # lags per register window, frames per f32 partial sum
NB_MAX = 4  # bonds per block at most
MAX_THREADS = 512  # threads per block (the kernel's launch bounds)
MAX_SMEM_BYTES = 232_448  # dynamic shared memory one H100 block may use
SLAB_THREADS, SLAB = 128, 512  # slab plan: threads per block, frames per slab
SLAB_LAGS = LAGS * SLAB_THREADS  # slab plan: lags per block
_INT32_MAX = 2**31 - 1
_GRID_Y_MAX = 65_535


class LaunchPlan(NamedTuple):
    """A block holds nb bonds' whole planes in shared memory."""

    nb: int  # bonds per block
    threads: int  # threads per block: nb * bond_threads(D)
    smem_bytes: int  # dynamic shared memory per block


class SlabPlan(NamedTuple):
    """A block holds one bond's frame slab and its partners (long chunks)."""

    threads: int
    slab: int  # frames per slab
    smem_bytes: int


def plane_words(n_frames: int) -> int:
    """Words of one bank-padded plane: frames 0..F+TBLK+LAGS-1, a pad word
    every 32 (csrc/acf_lag_sums.cu plane_words)."""
    n = n_frames + TBLK + LAGS
    return n + (n >> 5) + 1


def n_windows(n_deltas: int) -> int:
    return -(-n_deltas // LAGS)


def bond_threads(n_deltas: int) -> int:
    """Threads per bond: one per window pair, whole warps, at most
    MAX_THREADS (more pairs are walked in rounds)."""
    return min(-(-((n_windows(n_deltas) + 1) // 2) // 32) * 32, MAX_THREADS)


def slab_partner_words() -> int:
    """Words of one bank-padded partner plane of the slab plan
    (csrc/acf_lag_sums.cu slab_partner_words)."""
    n = SLAB + SLAB_LAGS
    return n + (n >> 5) + 1


def launch_plan(n_frames: int, n_deltas: int) -> LaunchPlan | SlabPlan | None:
    """The launch of kernel A for a chunk shape: the most bonds per block (a
    power of two <= NB_MAX) whose threads and shared memory fit one block,
    else the slab plan; None only when 1 <= D < F fails or the shape
    leaves int32 indexing."""
    if not 1 <= n_deltas < n_frames:
        return None
    per_bond = 8 + 3 * plane_words(n_frames) * 4
    threads = bond_threads(n_deltas)
    nb = NB_MAX
    while nb >= 1:
        if nb * threads <= MAX_THREADS and nb * per_bond <= MAX_SMEM_BYTES:
            return LaunchPlan(nb, nb * threads, nb * per_bond)
        nb //= 2
    if (n_frames + SLAB + SLAB_LAGS > _INT32_MAX
            or -(-n_deltas // SLAB_LAGS) > _GRID_Y_MAX):
        return None
    return SlabPlan(SLAB_THREADS, SLAB, 3 * (SLAB + slab_partner_words()) * 4)


def fold_schedule(n_frames: int, n_deltas: int) -> list[tuple[int, int, tuple[int, ...]]]:
    """(thread of a bond, round, first lags of its windows) as the kernel
    deals them: thread j of round r owns window pair p = r * bond_threads
    + j, i.e. windows p and nW-1-p (one window when they coincide)."""
    n_w, bt = n_windows(n_deltas), bond_threads(n_deltas)
    n_p = (n_w + 1) // 2
    out = []
    for p in range(n_p):
        wins = sorted({p, n_w - 1 - p})
        out.append((p % bt, p // bt, tuple(1 + LAGS * w for w in wins)))
    return out


def supports(n_frames: int, n_deltas: int) -> bool:
    """True when the kernel takes this chunk shape: 1 <= D < F within
    int32 indexing (long chunks through the slab plan)."""
    return launch_plan(n_frames, n_deltas) is not None


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
    plan = launch_plan(n_frames, n_deltas)
    if plan is None:
        raise ValueError(
            f"acf_lag_sums: unsupported chunk shape F={n_frames}, D={n_deltas}"
        )
    n_bonds = n_outer * n_inner
    if n_bonds < 1 or n_bonds > _INT32_MAX or n_deltas * n_bonds > 2**62:
        raise ValueError(f"acf_lag_sums: unsupported bond count {n_bonds}")
    s_outer, s_inner, s_t, s_c = v.stride()
    out = torch.empty((n_deltas, n_bonds), dtype=torch.float32, device=v.device)
    name = "acf_lag_sums_slab_f32" if isinstance(plan, SlabPlan) else "acf_lag_sums_f32"
    lib = _build.load()
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        code = getattr(lib, name)(
            v.data_ptr(), out.data_ptr(), n_bonds, n_frames, n_deltas,
            n_inner, s_outer, s_inner, s_t, s_c, *plan, stream,
        )
    _build.check(code, name)
    acf_lag_sums.launches += 1
    return out


acf_lag_sums.launches = 0
