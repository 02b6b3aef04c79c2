"""P2 orientational autocorrelation C(t) with Palmer chunk statistics.

Port of ``spinrelax_tpu/ops/autocorr.py``: the fused, scanned and
streamed C(t) drivers, the direct lag-loop reference and the S2 order
parameters.  Not ported: the JAX package's alternative lag-sum backends
(``_acf_sums_xla``, ``_acf_sums_mxu``, ``ct_palmer_mxu``: matmul forms
for the TPU's MXU; kernel A takes their place) and the ``lru_cache``s that
exist only to keep one jit alive (``_dft_constants``,
``_stream_update_jit``: its update is the plain :func:`stream_update`).
The lag
sums s[d] = sum_t (v(t) . v(t+d))^2 behind every C(t) come from
:func:`acf_sums`, which launches kernel A (``ops.cuda_acf``) for a CUDA
float32 tensor and runs :func:`acf_sums_plain` -- the FFT form of the
JAX package's ``_acf_sums_fft`` -- for a CPU tensor.  A CUDA tensor of
any other dtype raises.

Palmer statistics follow the reference exactly: per-chunk lag means
-0.5 + 1.5 s / (F - d), then mean and std / (sqrt(n) - 1) across chunks
with the POPULATION std (calculate-Ct-from-traj.py:228); one chunk gives
NaN dCt, as the reference's 0/0 does.
"""

from __future__ import annotations

import torch

from . import cuda_acf

# Index pairs of the 6 unique outer-product components and their weights
# (off-diagonals count twice in sum_ab, so their components carry sqrt 2).
_PAIR_I = (0, 1, 2, 0, 0, 1)
_PAIR_J = (0, 1, 2, 1, 2, 2)
_SQRT2 = 2.0**0.5
_PAIR_W = (1.0, 1.0, 1.0, _SQRT2, _SQRT2, _SQRT2)

# Bonds per FFT batch in acf_sums_plain: bounds the spectra's memory
# (a float64 batch of 4096 bonds at F = 1000 holds ~300 MB of spectra).
PLAIN_CHUNK = 4096


def _fft_len(n_min: int) -> int:
    """Smallest 5-smooth length >= n_min (linear correlation needs
    nfft >= nFrames + nDeltas)."""
    best = 1
    while best < n_min:
        best *= 2
    m5 = 1
    while m5 < 8 * n_min:
        m3 = m5
        while m3 < 8 * n_min:
            m = m3
            while m < n_min:
                m *= 2
            best = min(best, m)
            m3 *= 3
        m5 *= 5
    return best


def acf_sums_plain(vecs: torch.Tensor, n_deltas: int) -> torch.Tensor:
    """Sum_t (v(t).v(t+delta))^2 for delta = 1..n_deltas via FFT, on any
    device and dtype: the plain version of kernel A.

    P2 identity: (v.v')^2 = sum_ab [v_a v_b](t) [v_a v_b](t+d), so the lag
    profile is the autocorrelation of the six weighted outer-product
    components; their power spectra are summed before one inverse FFT.

    vecs : (..., nFrames, 3) -> (..., n_deltas)
    """
    lead = vecs.shape[:-2]
    n_frames = vecs.shape[-2]
    nfft = _fft_len(n_frames + n_deltas)
    flat = vecs.reshape((-1, n_frames, 3))
    out = torch.empty((flat.shape[0], n_deltas), dtype=vecs.dtype,
                      device=vecs.device)
    for lo in range(0, flat.shape[0], PLAIN_CHUNK):
        v = flat[lo : lo + PLAIN_CHUNK]
        w6 = torch.stack(
            [w * v[..., i] * v[..., j]
             for i, j, w in zip(_PAIR_I, _PAIR_J, _PAIR_W)],
            dim=-2,
        )  # (b, 6, nF)
        W = torch.fft.rfft(w6, n=nfft, dim=-1)
        power = torch.sum(W.real**2 + W.imag**2, dim=-2)
        acf = torch.fft.irfft(power, n=nfft, dim=-1)
        out[lo : lo + PLAIN_CHUNK] = acf[:, 1 : n_deltas + 1]
    return out.reshape(lead + (n_deltas,))


def _bond_view(vecs: torch.Tensor) -> torch.Tensor:
    """(..., F, 3) -> the kernel's (nOuter, nInner, F, 3) view, without a
    copy when the leading dims number one or two."""
    if vecs.ndim == 3:
        return vecs.unsqueeze(0)
    if vecs.ndim == 4:
        return vecs
    raise ValueError(
        f"acf_sums on CUDA takes (B, F, 3) or (A, B, F, 3), got {tuple(vecs.shape)}"
    )


def acf_sums(vecs: torch.Tensor, n_deltas: int,
             lag_major: bool = False) -> torch.Tensor:
    """Sum_t (v(t).v(t+delta))^2 for delta = 1..n_deltas — the dispatcher
    (JAX ``_acf_sums``): kernel A for CUDA float32, the plain FFT form
    for a CPU tensor, and an error for any other CUDA dtype.

    vecs : (..., nFrames, 3).  Returns (..., n_deltas), or with
    ``lag_major`` the kernel's native (n_deltas, B) with B the leading
    dims flattened row-major.
    """
    if vecs.is_cuda:
        if vecs.dtype != torch.float32:
            raise TypeError(
                f"acf_sums on CUDA runs kernel A, which takes float32; got {vecs.dtype}"
            )
        s = cuda_acf.acf_lag_sums(_bond_view(vecs), n_deltas)
        return s if lag_major else s.T.reshape(vecs.shape[:-2] + (n_deltas,))
    if vecs.device.type != "cpu":
        raise ValueError(f"acf_sums: unsupported device {vecs.device}")
    s = acf_sums_plain(vecs, n_deltas)
    return s.reshape(-1, n_deltas).T if lag_major else s


def _n_vals(n_frames: int, n_deltas: int, like: torch.Tensor) -> torch.Tensor:
    return n_frames - torch.arange(1, n_deltas + 1, dtype=like.dtype,
                                   device=like.device)


def ct_palmer(vecs: torch.Tensor):
    """C(t) with Palmer chunk statistics.

    vecs : (nReplicates, nFrames, nResidues, 3) unit bond vectors in
        Palmer chunks.
    Returns Ct, dCt : (nDeltas, nResidues), nDeltas = nFrames // 2.
    """
    n_rep, n_frames, n_res, _ = vecs.shape
    n_deltas = n_frames // 2
    # (nRep, nRes, nF, 3) view: bond index rep * nRes + res.
    s = acf_sums(vecs.transpose(1, 2), n_deltas, lag_major=True)
    per_rep = -0.5 + 1.5 * s.reshape(n_deltas, n_rep, n_res) / _n_vals(
        n_frames, n_deltas, vecs
    )[:, None, None]
    Ct = per_rep.mean(dim=1)
    dCt = per_rep.std(dim=1, correction=0) / (n_rep**0.5 - 1.0)
    return Ct, dCt


def palmer_pooled_stats(acc_s: torch.Tensor, acc_s2: torch.Tensor, count):
    """(shifted sum, shifted sum of squares, chunk count) -> (mean, dCt)
    in the accumulators' own orientation.

    Producers accumulate e = x - 1 and e**2 (not x and x**2): the variance
    is shift-invariant, and near C = 1, where the spread is smallest, raw
    f32 sums cancel to their rounding floor.  count == 1 gives NaN dCt.
    """
    count = torch.as_tensor(count, dtype=acc_s.dtype, device=acc_s.device)
    e_mean = acc_s / count
    mean = 1.0 + e_mean
    var = torch.clamp(acc_s2 / count - e_mean**2, min=0.0)
    denom = torch.sqrt(count) - 1.0
    safe = torch.where(denom > 0, denom, torch.ones_like(denom))
    dct = torch.where(denom > 0, torch.sqrt(var) / safe,
                      torch.full_like(var, float("nan")))
    return mean, dct


def tile_palmer_group(group: torch.Tensor) -> torch.Tensor:
    """Chunk group (g, nFrames, nRes, 3) -> the tile layout
    (nTiles, 3, nFrames, 128), lanes (chunk, residue) row-major and
    zero-padded to a multiple of 128."""
    g, n_frames, n_res, _ = group.shape
    b = g * n_res
    v = group.transpose(1, 2).reshape(b, n_frames, 3)
    b_pad = ((b + 127) // 128) * 128
    if b_pad != b:
        v = torch.cat([v, v.new_zeros((b_pad - b, n_frames, 3))], dim=0)
    return v.reshape(b_pad // 128, 128, n_frames, 3).permute(0, 3, 2, 1).contiguous()


def palmer_group_update_pretiled(vt: torch.Tensor, acc_s: torch.Tensor,
                                 acc_s2: torch.Tensor, n_group: int,
                                 n_res: int):
    """One streamed Palmer group step on tile-layout input.

    vt : (nTiles, 3, nFrames, 128) group of ``n_group`` chunks x ``n_res``
        residues (:func:`tile_palmer_group`).
    acc_s, acc_s2 : (nDeltas, nRes) running shifted sums.
    Returns the updated accumulators (new tensors); finalise with
    :func:`palmer_pooled_stats` on the total chunk count.
    """
    n_tiles, _, n_frames, _ = vt.shape
    n_deltas = n_frames // 2
    b = n_group * n_res
    if b > n_tiles * 128:
        raise ValueError(
            f"n_group*n_res ({b}) exceeds tile capacity ({n_tiles * 128})"
        )
    v = vt.permute(0, 3, 2, 1)  # (nTiles, 128, F, 3) view
    if not vt.is_cuda:
        v = v.reshape(n_tiles * 128, n_frames, 3)[:b]
    s = acf_sums(v, n_deltas, lag_major=True)[:, :b]  # (nDeltas, B)
    # palmer_pooled_stats convention: accumulate e = per - 1 and e**2.
    e = -1.5 + 1.5 * s / _n_vals(n_frames, n_deltas, vt)[:, None]
    e = e.reshape(n_deltas, n_group, n_res)
    return acc_s + e.sum(dim=1), acc_s2 + (e**2).sum(dim=1)


def palmer_group_sums(group: torch.Tensor, weights=None):
    """A group's own shifted sums (sum_chunks w e, sum_chunks w e**2), each
    (nDeltas, nRes): kernel A on the card, on the (g, nFrames, nRes, 3)
    group as it lies (any strides), then the per-chunk statistics.
    ``weights`` : optional (g,) chunk weights (0.0 for the zero-padded
    chunks of a partial group)."""
    g, n_frames, n_res, _ = group.shape
    n_deltas = n_frames // 2
    s = acf_sums(group.transpose(1, 2), n_deltas, lag_major=True)  # (nDeltas, g * nRes)
    # palmer_pooled_stats convention: accumulate e = per - 1 and e**2.
    e = -1.5 + 1.5 * s / _n_vals(n_frames, n_deltas, group)[:, None]
    e = e.reshape(n_deltas, g, n_res)
    if weights is None:
        return e.sum(dim=1), (e**2).sum(dim=1)
    w = weights[None, :, None]
    return torch.sum(w * e, dim=1), torch.sum(w * e**2, dim=1)


def stream_update(group: torch.Tensor, acc_s: torch.Tensor, acc_s2: torch.Tensor,
                  weights=None):
    """One streamed group step: :func:`palmer_group_sums` (kernel A on the
    card) added to the lag-leading (nDeltas, nRes) shifted accumulators.
    Returns the updated accumulators (new tensors)."""
    s, s2 = palmer_group_sums(group, weights)
    return acc_s + s, acc_s2 + s2


def stream_accumulate(chunk_iter, n_frames_per_chunk: int):
    """Streaming accumulation: chunk groups -> (acc_s, acc_s2, count), the
    running lag-leading (nDeltas, nRes) sums of the SHIFTED per-chunk Palmer
    C(t) means (e = per - 1 and e**2; see palmer_pooled_stats) and the
    chunk count.  Each group is a (g, n_frames_per_chunk, nRes, 3) tensor
    (g may vary); all on one device."""
    n_deltas = n_frames_per_chunk // 2
    acc_s = acc_s2 = None
    n_rep = 0
    for group in chunk_iter:
        if group.shape[1] != n_frames_per_chunk:
            raise ValueError(
                f"chunk group has {group.shape[1]} frames, expected {n_frames_per_chunk}"
            )
        if acc_s is None:
            acc_s = torch.zeros((n_deltas, group.shape[2]), dtype=group.dtype,
                                device=group.device)
            acc_s2 = torch.zeros_like(acc_s)
        acc_s, acc_s2 = stream_update(group, acc_s, acc_s2)
        n_rep += group.shape[0]
    if acc_s is None:
        raise ValueError("empty chunk iterator")
    return acc_s, acc_s2, n_rep


def ct_palmer_streamed(chunk_iter, n_frames_per_chunk: int, mesh=None):
    """Streaming C(t): consume an iterator of Palmer-chunk groups without
    ever holding the full trajectory.

    chunk_iter yields (g, n_frames_per_chunk, nRes, 3) tensors (g may
    vary); per-chunk lag means accumulate into running sum / sum of
    squares, so the result equals :func:`ct_palmer` over the concatenated
    chunks.  Returns Ct, dCt : (nDeltas, nRes).

    mesh : optional ("rep", "res") mesh (``parallel.mesh.make_mesh``) --
        every rank feeds the same groups; each group's chunks shard over
        "rep" and its residues over "res"
        (``parallel.streamed.ShardedCtStream``: kernel A on each rank's
        block, one all-reduce over "rep" per sum), and every rank returns
        the whole result."""
    if mesh is not None:
        from ..parallel.streamed import ShardedCtStream

        stream = None
        for group in chunk_iter:
            if stream is None:
                stream = ShardedCtStream(mesh, n_frames_per_chunk, group.shape[2],
                                         dtype=torch.as_tensor(group[:0]).dtype)
            stream.update(group)
        if stream is None:
            raise ValueError("empty chunk iterator")
        return stream.finalize()
    acc_s, acc_s2, n_rep = stream_accumulate(chunk_iter, n_frames_per_chunk)
    return palmer_pooled_stats(acc_s, acc_s2, float(n_rep))


def ct_palmer_scan(vecs: torch.Tensor, batch: int = 1, mesh=None):
    """Replicate-streamed variant of :func:`ct_palmer` for chunk sets too
    large for one lag-sum launch: ``batch`` replicates a step, accumulating
    per-lag sum and sum of squares (population std via E[x^2] - E[x]^2).

    vecs : (nReplicates, nFrames, nResidues, 3); nReplicates % batch == 0.
    mesh : optional ("rep", "res") mesh: each ``batch`` of replicates goes
        through the sharded stream (:func:`ct_palmer_streamed`).
    """
    if mesh is not None:
        return ct_palmer_streamed((vecs[off : off + batch]
                                   for off in range(0, vecs.shape[0], batch)),
                                  vecs.shape[1], mesh=mesh)
    n_rep = vecs.shape[0]
    if n_rep % batch != 0:
        raise ValueError(f"nReplicates ({n_rep}) must be divisible by batch ({batch})")
    return ct_palmer_streamed((vecs[off : off + batch] for off in range(0, n_rep, batch)),
                              vecs.shape[1])


def ct_palmer_direct(vecs: torch.Tensor):
    """O(N^2) lag-loop reference implementation (for parity tests against
    the FFT path and kernel A; mirrors calculate-Ct-from-traj.py:222-228
    literally)."""
    n_rep, n_frames, n_res, _ = vecs.shape
    n_deltas = n_frames // 2
    per_rep = torch.stack([
        (-0.5 + 1.5 * torch.sum(vecs[:, :-d] * vecs[:, d:], dim=-1) ** 2).mean(dim=1)
        for d in range(1, n_deltas + 1)
    ])  # (nDeltas, nRep, nRes)
    Ct = per_rep.mean(dim=1)
    dCt = per_rep.std(dim=1, correction=0) / (n_rep**0.5 - 1.0)
    return Ct, dCt


def reformat_by_tau(vec_list, delta_t: float, tau_memory: float):
    """Concatenate per-trajectory (nFrames, nBonds, 3) arrays and reshape
    into Palmer chunks (nChunks, framesPerChunk, nBonds, 3), dropping
    remainder frames per source (calculate-Ct-from-traj.py:245-275).
    Tensors stay on their device; numpy arrays become CPU tensors."""
    frames_per_chunk = int(tau_memory / delta_t)
    out = torch.cat([torch.as_tensor(v[: (v.shape[0] // frames_per_chunk) * frames_per_chunk])
                     for v in vec_list])
    n_chunks = out.shape[0] // frames_per_chunk
    return out.reshape(n_chunks, frames_per_chunk, out.shape[-2], out.shape[-1])


# ---------------------------------------------------------------------------
# S^2 order parameters (calculate-Ct-from-traj.py:96-145)
# ---------------------------------------------------------------------------

def s2_outer(vecs: torch.Tensor):
    """S2 = 1.5 * sum_ab <v_a v_b>^2 - 0.5 with no block averaging.

    vecs : (nFrames, nResidues, 3) or (nFrames, 3).
    Returns (nResidues,) or scalar.
    """
    if vecs.ndim == 2:
        outer = torch.einsum("ij,ik->jk", vecs, vecs) / vecs.shape[0]
        return 1.5 * torch.sum(outer**2) - 0.5
    outer = torch.einsum("ijk,ijl->jkl", vecs, vecs) / vecs.shape[0]
    return 1.5 * torch.sum(outer**2, dim=(-2, -1)) - 0.5


def s2_block_values(blocks: torch.Tensor):
    """Per-block S2 of (nBlocks, nPerBlock, nRes, 3) vectors -> (nBlocks, nRes)."""
    outer = torch.einsum("ijkl,ijkm->iklm", blocks, blocks) / blocks.shape[1]
    return 1.5 * torch.sum(outer**2, dim=(-2, -1)) - 0.5


def s2_outer_blocked(vecs: torch.Tensor, delta_t: float, tau_memory: float):
    """Block-averaged S2 with SEM using the reference's sqrt(n)-1
    denominator (calculate-Ct-from-traj.py:116-142).

    vecs : (nFrames, nResidues, 3).
    Returns (nResidues, 2) stacked [S2, dS2].
    """
    n_per_block = int(tau_memory / delta_t)
    n_blocks = vecs.shape[0] // n_per_block
    v = vecs[: n_blocks * n_per_block].reshape(
        n_blocks, n_per_block, vecs.shape[-2], vecs.shape[-1]
    )
    s2 = s2_block_values(v)
    S2 = s2.mean(dim=0)
    dS2 = s2.std(dim=0, correction=0) / (n_blocks**0.5 - 1.0)
    return torch.stack([S2, dS2], dim=-1)


def lag_times(delta_t: float, tau_memory: float) -> torch.Tensor:
    """The lag-time grid of calculate_dt (calculate-Ct-from-traj.py:
    240-243), as a float64 CPU tensor like the reference's floats."""
    n_pts = int(0.5 * tau_memory / delta_t)
    return (torch.arange(n_pts, dtype=torch.float64) + 1.0) * delta_t
