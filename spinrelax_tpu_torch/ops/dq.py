"""Delta-q rotational-diffusion statistics: q(t) -> D tensor + PAF (port of
``spinrelax_tpu/ops/dq.py``, the counterpart of
``calculate-dq-distribution.py``'s main loop, :554-650).

For each lag delta on a grid:

    dq(t) = q^-1(t) * q(t+delta)
    iso(delta)  = < 1 - 2|dq_v|^2 >                 [= <cos theta>]
    M(delta)    = < dq_v (x) dq_v >                 [3x3 'MoI' tensor]

then M is diagonalised, the principal-axis frame (PAF) quaternion locked at
the FIRST lag, and single exponentials fitted per axis to obtain D.

Everything runs in float64 on the tensors' device (the card unless the
caller asks for the CPU), as the reference computes in float64:
- the lags go through in blocks under a fixed memory budget
  (:data:`BLOCK_BYTES`), each block's pairs formed from zero-padded slices
  of q, so a pair past the end of the trajectory contributes a zero vector;
- iso needs no pass of its own: sum |v|^2 is the trace of sum v v^T;
- with sub-chunks, M is the sum of the chunks' sums;
- the reference's uncertainty sub-chunks are segment sums (``index_add_``
  on the chunk id of each pair's first frame), their counts analytic;
- the double-cover reduction of dq is left out: v v^T is the same, bit
  for bit, for v and -v;
- the finalise (PAF, exponential fits, anisotropies, model curves) runs
  on the device and is fetched to the host once.
The delta-q histograms stay on the host in numpy (:func:`_np_dq_pairs`), so
the streamed and in-memory counts are bitwise equal.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import checked_device
from ..core import quaternion as qt

# Memory budget of one block of lags: ~240 bytes a (lag, frame) pair, on
# top of three (n, 4) copies of the frames a part holds (the pairs' first
# and second frames and the conjugates).
BLOCK_BYTES = 256 << 20
_PAIR_BYTES = 240


class DqStats(NamedTuple):
    lag_frames: np.ndarray  # (L,) integer lags in frames
    iso: torch.Tensor  # (L,) <1 - 2|v|^2>
    M: torch.Tensor  # (L, 3, 3) <v (x) v>
    iso_chunks: torch.Tensor  # (L, nChunk) or (L, 0)
    M_chunks: torch.Tensor  # (L, nChunk, 3, 3) or (L, 0, 3, 3)


def _np_dq_pairs(qa, qb) -> np.ndarray:
    """reduce(qa^-1 * qb).v in plain numpy -- shared by the in-memory and
    streamed histogram paths so their vectors are BITWISE equal."""
    w1, x1, y1, z1 = qa[:, 0], -qa[:, 1], -qa[:, 2], -qa[:, 3]
    w2, x2, y2, z2 = qb[:, 0], qb[:, 1], qb[:, 2], qb[:, 3]
    w = w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2
    v = np.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 + y1 * w2 + z1 * x2 - x1 * z2,
            w1 * z2 + z1 * w2 + x1 * y2 - y1 * x2,
        ],
        axis=-1,
    )
    return v * np.where(w >= 0, 1.0, -1.0)[:, None]


def dq_vectors(q, delta: int) -> np.ndarray:
    """Host-facing helper: the valid delta-q vector parts for one lag
    (the 3D histogram output, calculate-dq-distribution.py:632-647)."""
    q = np.asarray(q.cpu() if torch.is_tensor(q) else q, dtype=np.float64)
    return _np_dq_pairs(q[: q.shape[0] - delta], q[delta:])


def _as_q(q, device) -> torch.Tensor:
    """float64 quaternions: a tensor stays on its device, anything else
    goes to ``device``."""
    if torch.is_tensor(q):
        return q.to(torch.float64)
    return torch.as_tensor(np.asarray(q, dtype=np.float64), device=checked_device(device))


def _chunk_counts(n: int, lags: np.ndarray, n_chunks: int) -> np.ndarray:
    """(L, C) pair counts of the reference's sub-chunks: nblock =
    ceil((n - lag) / C) pairs each, the last one shorter or empty
    (calculate-dq-distribution.py:128-144)."""
    ndat = n - lags.astype(np.int64)
    nblock = -(-ndat // n_chunks)
    lo = np.arange(n_chunks)[None, :] * nblock[:, None]
    return np.clip(np.minimum(ndat[:, None], lo + nblock[:, None]) - lo, 0, None)


class _PairSums:
    """Running per-lag sums of v v^T, v = (q^-1(t) q(t+d)).v, over a stream
    of quaternion frames; each pair (t, t+d) is added once, with the part
    that holds its second frame.

    With ``n_chunks`` > 0 the sums are also split over the reference's
    sub-chunks: chunk id = t // nblock[lag] of the pair's FIRST frame (t
    global), clipped to n_chunks - 1."""

    def __init__(self, lags, n_chunks: int, nblock, device):
        self.lags = np.asarray(lags, dtype=np.int64)
        self.max_lag = int(self.lags.max())
        self.n_chunks = n_chunks
        self.dev = device
        L = len(self.lags)
        f64 = dict(dtype=torch.float64, device=device)
        self.M = torch.zeros((L, 3, 3), **f64)
        self.M_c = torch.zeros((L, n_chunks, 3, 3), **f64)
        self.cnt = np.zeros(L, dtype=np.int64)
        self.nblock = None if nblock is None else torch.as_tensor(
            np.maximum(np.asarray(nblock, dtype=np.int64), 1), device=device)
        self.tail = torch.zeros((0, 4), **f64)
        self.pos = 0  # global index of the next frame

    def add(self, part: torch.Tensor) -> None:
        """Add the pairs whose second frame lies in ``part`` (n, 4)."""
        B, nv = self.tail.shape[0], part.shape[0]
        first = torch.cat([self.tail, part])
        # second frames: zero in the tail (those pairs were counted) and
        # past the end, so such a pair's v is exactly zero.  A block's rows
        # are as many as its SHORTEST lag has pairs; its longer lags read
        # up to max_lag frames into the padding.
        second = torch.cat([torch.zeros_like(self.tail), part,
                            part.new_zeros((self.max_lag, 4))])
        conj = qt.qconj(first)
        C = self.n_chunks
        order = np.argsort(self.lags, kind="stable")
        i = 0
        while i < len(order):
            n_rows = first.shape[0] - int(self.lags[order[i]])
            if n_rows <= 0:
                break  # this lag and every longer one has no pair here
            per = max(1, BLOCK_BYTES // (_PAIR_BYTES * n_rows))
            blk = order[i: i + per]
            i += len(blk)
            sec = torch.stack([second[d: d + n_rows] for d in self.lags[blk]])
            v = qt.qmult(conj[None, :n_rows], sec)[..., 1:]  # (Lb, n_rows, 3)
            idx = torch.as_tensor(blk, device=self.dev)
            if not C:
                self.M.index_add_(0, idx, v.transpose(1, 2) @ v)
            else:
                t = torch.arange(n_rows, device=self.dev) + (self.pos - B)
                cid = torch.clamp(t[None, :] // self.nblock[idx][:, None], max=C - 1)
                seg = (torch.arange(len(blk), device=self.dev)[:, None] * C + cid).reshape(-1)
                outer = (v[..., :, None] * v[..., None, :]).reshape(-1, 9)
                sums = torch.zeros((len(blk) * C, 9), dtype=v.dtype, device=self.dev)
                sums.index_add_(0, seg, outer)
                self.M_c.index_add_(0, idx, sums.reshape(len(blk), C, 3, 3))
            del sec, v
        self.cnt += np.clip(B + nv - self.lags, 0, nv)
        self.tail = first[first.shape[0] - min(self.max_lag, first.shape[0]):]
        self.pos += nv

    def stats(self, n_total: Optional[int]) -> DqStats:
        """The means; the chunk counts follow from ``n_total`` frames."""
        def iso_of(M):
            return 1.0 - 2.0 * torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)

        cnt = torch.as_tensor(self.cnt, dtype=torch.float64, device=self.dev)
        M = (self.M_c.sum(1) if self.n_chunks else self.M) / cnt[:, None, None]
        if self.n_chunks:
            cnt_c = torch.as_tensor(_chunk_counts(n_total, self.lags, self.n_chunks),
                                    dtype=torch.float64, device=self.dev)
            M_c = self.M_c / cnt_c[..., None, None]  # an empty chunk is 0/0 = NaN
        else:
            M_c = self.M_c
        return DqStats(self.lags, iso_of(M), M, iso_of(M_c), M_c)


def dq_statistics(q, lag_frames, n_chunks: int = 0, device="cuda") -> DqStats:
    """Iso decay and anisotropy tensors for all lags.

    q          : (N, 4) orientation quaternions (unit); a tensor stays on
                 its device, numpy goes to ``device``.  float64.
    lag_frames : (L,) integer lags (frames).
    n_chunks   : if >0, also return per-subchunk statistics for
                 uncertainty estimation
                 (calculate-dq-distribution.py:128-144,613-630).
    """
    q = _as_q(q, device)
    n = q.shape[0]
    lags = np.asarray(lag_frames.cpu() if torch.is_tensor(lag_frames) else lag_frames,
                      dtype=np.int64)
    nblock = -(-(n - lags) // n_chunks) if n_chunks > 0 else None
    acc = _PairSums(lags, n_chunks, nblock, q.device)
    acc.add(q)
    return acc.stats(n)


class DqFrame(NamedTuple):
    q_frame: torch.Tensor  # (4,) PAF quaternion (locked at first lag)
    eigvals: torch.Tensor  # (L, 3) eigenvalues per lag
    aniso_decay: torch.Tensor  # (L, 3): 1 - 2 * diag(R M R^T) per lag
    aniso_chunks: torch.Tensor  # (L, nChunk, 3) or (L, 0, 3)
    q_per_lag: torch.Tensor  # (L, 4) per-lag PAF quaternions
    axes_per_lag: torch.Tensor  # (L, 3, 3) eigenvector rows per lag


def _diag_decay(MR):
    return 1.0 - 2.0 * torch.diagonal(MR, dim1=-2, dim2=-1)


def principal_frame(stats: DqStats) -> DqFrame:
    """Diagonalise M per lag, lock the PAF at the first lag, and project
    every lag's tensor into that frame algebraically
    (calculate-dq-distribution.py:575-611).  The eigenvectors' signs are
    absorbed by frame_transform_min."""
    eigvals, eigvecs = torch.linalg.eigh(stats.M)  # vecs columns
    axes = eigvecs.transpose(-1, -2)  # rows = axes
    q_all = qt.frame_transform_min(axes)  # (L, 4)
    q_frame = q_all[0]
    R = qt.quat_to_mat(q_frame)  # rotation applied to vectors
    # <(Rv)(Rv)^T> = R M R^T
    aniso = _diag_decay(R @ stats.M @ R.T)
    aniso_c = _diag_decay(R @ stats.M_chunks @ R.T)  # (L, C, 3)
    return DqFrame(q_frame, eigvals, aniso, aniso_c, q_all, axes)


# ---------------------------------------------------------------------------
# Exponential decay fits: y = C0 exp(-x/A) + C1, solve for A > 0
# (replaces conduct_exponential_fit + powell_expdecay,
# calculate-dq-distribution.py:152-207)
# ---------------------------------------------------------------------------


def fit_exp_decay(x, y, c0, c1, n_iter: int = 60):
    """1-parameter exponential fit by damped Newton on log A, all series at
    once.  x: (T,); y: (..., T).  Returns tau (...,).

    chi2(la) = mean((c0 exp(-x/A) + c1 - y)^2), A = exp(la), with its first
    and second derivative in la in closed form (u = x/A, m = c0 exp(-u):
    dm = m u, d2m = m u (u - 1)); the 60 steps, their Newton/gradient
    fallback and the better-or-damped gate are those of the JAX package,
    with no host sync inside the loop."""
    x = torch.as_tensor(x)
    y = torch.as_tensor(y, dtype=x.dtype, device=x.device)
    flat = y.reshape(-1, y.shape[-1])

    def parts(la):
        u = x[None, :] / torch.exp(la)[:, None]
        m = c0 * torch.exp(-u)
        return u, m, m + c1 - flat

    def chi2(la):
        return torch.mean(parts(la)[2] ** 2, dim=-1)

    # two-point initial guess (calculate-dq-distribution.py:195-196)
    ratio = (flat[:, 1] - c1) / (flat[:, 0] - c1)
    safe = torch.where(ratio > 0, ratio, torch.full_like(ratio, 0.5))
    guess = (x[0] - x[1]) / torch.log(safe)
    la = torch.log(torch.minimum(torch.maximum(guess, x[0] * 1e-3), x[-1] * 1e3))
    for _ in range(n_iter):
        u, m, r = parts(la)
        d1 = m * u
        d2 = d1 * (u - 1.0)
        g = torch.mean(2.0 * r * d1, dim=-1)
        h = torch.mean(2.0 * (d1 * d1 + r * d2), dim=-1)
        step = torch.where(torch.abs(h) > 1e-30, g / h, torch.zeros_like(g))
        # damped Newton with fallback to the gradient's direction
        step = torch.where((h > 0) & torch.isfinite(step), step, torch.sign(g) * 0.1)
        la_new = la - torch.clamp(step, -0.5, 0.5)
        better = chi2(la_new) <= torch.mean(r * r, dim=-1)
        la = torch.where(better, la_new, la - 0.1 * torch.clamp(g, -1.0, 1.0))
    return torch.exp(la).reshape(y.shape[:-1])


def isotropic_decay(x, tau):
    """1.5 exp(-x/tau) - 0.5 (calculate-dq-distribution.py:146-147)."""
    return 1.5 * torch.exp(-x / tau) - 0.5


def anisotropic_decay(x, tau):
    """0.5 exp(-x/tau) + 0.5 (calculate-dq-distribution.py:149-150)."""
    return 0.5 * torch.exp(-x / tau) + 0.5


def tau_to_D(tau_ps):
    """D [s^-1] = 0.5e12 / tau[ps] (calculate-dq-distribution.py:230)."""
    return 0.5e12 / tau_ps


# ---------------------------------------------------------------------------
# Anisotropy conversions (calculate-dq-distribution.py:30-91)
# ---------------------------------------------------------------------------


def aniso_of(D):
    return 2 * D[..., 2] / (D[..., 1] + D[..., 0])


def rhomb_of(D):
    return 3 * (D[..., 1] - D[..., 0]) / (2 * D[..., 2] - D[..., 1] - D[..., 0])


def calculate_anisotropies(D):
    """(Diso, aniL, rhomL, aniS, rhomS) from sorted Dx<=Dy<=Dz."""
    D = torch.as_tensor(D)
    Drev = D.flip(-1)
    return (D.mean(dim=-1), aniso_of(D), rhomb_of(D), aniso_of(Drev), rhomb_of(Drev))


# ---------------------------------------------------------------------------
# High-level entry points
# ---------------------------------------------------------------------------


class DqResult(NamedTuple):
    lag_times: np.ndarray
    iso: np.ndarray
    iso_tau: float
    iso_tau_chunks: np.ndarray
    aniso: np.ndarray  # (3, L)
    aniso_taus: np.ndarray  # (3,)
    aniso_tau_chunks: np.ndarray  # (nChunk, 3)
    aniso_chunks: np.ndarray  # (nChunk, 3, L)
    iso_chunks: np.ndarray  # (nChunk, L)
    q_frame: np.ndarray
    q_per_lag: np.ndarray
    axes_per_lag: np.ndarray
    D_iso: float
    D_axes: np.ndarray  # (3,) in s^-1
    anisotropies: tuple  # (Diso, aniL, rhomL, aniS, rhomS) of D_axes
    M: Optional[np.ndarray] = None  # (L, 3, 3) raw <v v^T> per lag
    hist: Optional[np.ndarray] = None  # (L, B, B, B) per-lag dq histograms
    # (density-normalised like np.histogramdd(density=True) over (-1,1)^3;
    # populated only by the streamed path when hist_bins > 0 -- the
    # in-memory stage computes histograms directly from dq_vectors)
    anis_chunk_samples: Optional[np.ndarray] = None  # (nChunk, 5) per-chunk
    # (Diso, aniL, rhomL, aniS, rhomS) in the MAIN fit's axis order
    iso_models: Optional[np.ndarray] = None  # (1+nChunk, L) fitted curves
    aniso_models: Optional[np.ndarray] = None  # (1+nChunk, 3, L)


def _lag_grid(delta_t: float, min_dt: float, max_dt: float, skip_dt: float,
              n: Optional[int] = None, what: str = "trajectory") -> np.ndarray:
    """The reference's lag-grid construction (:509-523), shared by every
    analyse_dq* entry point: lags from max(skip, min) to max in steps of
    skip (frames).  ``n`` (frame count) enables the half-length check;
    pass None when the stream length is only known afterwards."""
    skip_int = max(1, int(skip_dt / delta_t))
    min_int = max(skip_int, int(min_dt / delta_t))
    max_int = int(max_dt / delta_t)
    if n is not None and max_int * delta_t > (n - 1) * delta_t / 2.0:
        raise ValueError(
            f"max_dt ({max_dt}) exceeds half the {what} length "
            f"({(n - 1) * delta_t / 2.0})"
        )
    lags = np.arange(min_int, max_int + 1, skip_int, dtype=np.int32)
    if len(lags) < 2:
        # The exp-decay initial guess reads (x[1], y[1]); the reference
        # fails with an IndexError at the same spot.
        raise ValueError(
            f"lag grid needs >= 2 points, got {len(lags)}: min_dt={min_dt}, "
            f"max_dt={max_dt}, skip_dt={skip_dt} at delta_t={delta_t}"
        )
    return lags


def analyse_dq_multi(
    q_trajs,
    delta_t: float,
    min_dt: float,
    max_dt: float,
    skip_dt: float,
    n_chunks: int = 0,
    device="cuda",
) -> "DqResult":
    """Multi-replica Delta-q analysis: per-replica dq samples are pooled at
    each lag (the capability of calculate-dq-distribution-multi.py:529-539).

    Replicas may differ in length; uncertainty chunks group whole replicas
    (nReplicas % n_chunks == 0, mirroring the reference's
    subchunks-divide-replicas requirement :481-483).
    """
    q_list = [_as_q(q, device) for q in q_trajs]
    n_rep = len(q_list)
    n_min = min(q.shape[0] for q in q_list)
    if n_chunks > 0 and n_rep % n_chunks != 0:
        raise ValueError(
            f"n_chunks ({n_chunks}) must divide nReplicas ({n_rep})"
        )
    lags = _lag_grid(delta_t, min_dt, max_dt, skip_dt, n_min,
                     what="shortest replica trajectory")
    dev = q_list[0].device

    # The reference pools the delta-q SAMPLES of all replicas at each lag:
    # per-replica means recombine weighted by their sample counts
    # n_r - delta, which also handles replicas of unequal length.
    per_rep = [dq_statistics(q, lags, n_chunks=0) for q in q_list]
    counts = np.stack([q.shape[0] - lags.astype(np.int64) for q in q_list])  # (nRep, L)

    def pool(items, cnt):
        w = torch.as_tensor(cnt / cnt.sum(axis=0, keepdims=True), device=dev)
        stacked = torch.stack(items)  # (nRep, L, ...)
        return torch.sum(stacked * w.reshape(w.shape + (1,) * (stacked.ndim - 2)), dim=0)

    iso = pool([s.iso for s in per_rep], counts)
    M = pool([s.M for s in per_rep], counts)
    if n_chunks > 0:
        group = n_rep // n_chunks
        sels = [slice(g * group, (g + 1) * group) for g in range(n_chunks)]
        iso_c = torch.stack([pool([s.iso for s in per_rep[sel]], counts[sel])
                             for sel in sels], dim=1)  # (L, nChunk)
        M_c = torch.stack([pool([s.M for s in per_rep[sel]], counts[sel])
                           for sel in sels], dim=1)  # (L, nChunk, 3, 3)
    else:
        iso_c = iso.new_zeros((len(lags), 0))
        M_c = M.new_zeros((len(lags), 0, 3, 3))
    return _finalise_dq(DqStats(lags, iso, M, iso_c, M_c), lags, delta_t)


def _finalise_device(iso, M, iso_c, M_c, x):
    """Everything after the statistics as device work returning ONE packed
    vector: PAF frame, exponential-fit taus (main + chunks, batched),
    anisotropy conversions (main + per-chunk in the main order,
    calculate-dq-distribution.py:230-272) and the fitted model curves for
    the artefact graphs."""
    fr = principal_frame(DqStats(None, iso, M, iso_c, M_c))
    # batched exponential fits: row 0 = the full series, rows 1.. chunks
    iso_stack = torch.cat([iso[None, :], iso_c.T])
    tau_iso_all = fit_exp_decay(x, iso_stack, 1.5, -0.5)  # (1+C,)
    aniso_stack = torch.cat([fr.aniso_decay.T[None], fr.aniso_chunks.permute(1, 2, 0)])
    tau_aniso_all = fit_exp_decay(x, aniso_stack, 0.5, 0.5)  # (1+C, 3)
    # anisotropy conversions; chunks use the MAIN fit's axis order
    # (stage header semantics, calculate-dq-distribution.py:241-268)
    D_axes = tau_to_D(tau_aniso_all[0])
    order = torch.argsort(D_axes, stable=True)
    anis_main = torch.stack(calculate_anisotropies(D_axes[order]))  # (5,)
    anis_ch = torch.stack(calculate_anisotropies(tau_to_D(tau_aniso_all[1:])[:, order]),
                          dim=-1)  # (C, 5)
    iso_models = isotropic_decay(x[None, :], tau_iso_all[:, None])
    aniso_models = anisotropic_decay(x[None, None, :], tau_aniso_all[..., None])
    parts = [iso, M, iso_c, fr.aniso_decay, fr.aniso_chunks, fr.q_frame, fr.q_per_lag,
             fr.axes_per_lag, tau_iso_all, tau_aniso_all, anis_main, anis_ch,
             iso_models, aniso_models]
    return torch.cat([p.reshape(-1) for p in parts])


def _finalise_dq(stats: DqStats, lags, delta_t: float) -> "DqResult":
    x = np.asarray(lags, dtype=float) * delta_t
    L, C = len(x), stats.iso_chunks.shape[1]
    packed = _finalise_device(stats.iso, stats.M, stats.iso_chunks, stats.M_chunks,
                              torch.as_tensor(x, device=stats.M.device)).cpu().numpy()
    sizes = [L, 9 * L, L * C, 3 * L, 3 * L * C, 4, 4 * L, 9 * L,
             1 + C, 3 * (1 + C), 5, 5 * C, (1 + C) * L, (1 + C) * 3 * L]
    (iso, M, iso_c, aniso, aniso_c, q_frame, q_all, axes,
     tau_iso_all, tau_aniso_all, anis_main, anis_ch,
     iso_models, aniso_models) = np.split(packed, np.cumsum(sizes)[:-1])
    tau_aniso_all = tau_aniso_all.reshape(1 + C, 3)
    return DqResult(
        M=M.reshape(L, 3, 3),
        lag_times=x,
        iso=iso,
        iso_tau=float(tau_iso_all[0]),
        iso_tau_chunks=tau_iso_all[1:],
        aniso=aniso.reshape(L, 3).T,
        aniso_taus=tau_aniso_all[0],
        aniso_tau_chunks=tau_aniso_all[1:],
        aniso_chunks=np.moveaxis(aniso_c.reshape(L, C, 3), 0, -1),
        iso_chunks=iso_c.reshape(L, C).T,
        q_frame=q_frame,
        q_per_lag=q_all.reshape(L, 4),
        axes_per_lag=axes.reshape(L, 3, 3),
        D_iso=float(0.5e12 / tau_iso_all[0]),
        D_axes=0.5e12 / tau_aniso_all[0],
        anisotropies=tuple(float(v) for v in anis_main),
        anis_chunk_samples=anis_ch.reshape(C, 5),
        iso_models=iso_models.reshape(1 + C, L),
        aniso_models=aniso_models.reshape(1 + C, 3, L),
    )


def analyse_dq(
    q_traj,
    delta_t: float,
    min_dt: float,
    max_dt: float,
    skip_dt: float,
    n_chunks: int = 0,
    device="cuda",
) -> DqResult:
    """Full Delta-q analysis of one quaternion trajectory, on ``device``
    (the card unless ``device="cpu"``; a tensor stays on its own).

    Mirrors the lag-grid construction of the reference (:509-523): lags
    from max(skip, min) to max in steps of skip (in frames).
    """
    q = _as_q(q_traj, device)
    lags = _lag_grid(delta_t, min_dt, max_dt, skip_dt, q.shape[0])
    return _finalise_dq(dq_statistics(q, lags, n_chunks=n_chunks), lags, delta_t)


# ---------------------------------------------------------------------------
# Streaming Delta-q: constant-memory statistics over chunked q(t) streams
# (capability beyond the reference, which loads the full colvar into RAM,
# calculate-dq-distribution.py:525-536)
# ---------------------------------------------------------------------------


def _parts(chunk, chunk_len: int):
    for off in range(0, chunk.shape[0], chunk_len):
        yield chunk[off: off + chunk_len]


def dq_statistics_streamed(chunk_iter, lags, chunk_len: int,
                           n_chunks: int = 0, n_total: Optional[int] = None,
                           hist_bins: int = 0, device="cuda") -> tuple:
    """Accumulate DqStats over an iterator of (n, 4) quaternion chunks
    without ever materialising the full trajectory: each chunk goes to
    ``device`` in parts of ``chunk_len`` frames.  Exact: matches
    dq_statistics on the concatenated stream to float tolerance.

    n_chunks > 0 additionally accumulates the reference's per-sub-chunk
    statistics (calculate-dq-distribution.py:128-144,613-630); this
    requires the total stream length ``n_total`` up front.

    hist_bins > 0 accumulates per-lag 3D histogram COUNTS of the delta-q
    vectors over (-1, 1)^3 on the host (the stage's -hist output,
    :632-647); the vectors are bitwise identical to the in-memory path's,
    so the counts match np.histogramdd exactly.

    Returns (DqStats, total_frames, hist_counts or None)."""
    lags = np.asarray(lags, dtype=np.int64)
    L = len(lags)
    max_lag = int(lags.max())
    nblock = None
    if n_chunks > 0:
        if n_total is None:
            raise ValueError(
                "streamed sub-chunk uncertainties need n_total (count the "
                "stream first)"
            )
        nblock = -(-(n_total - lags) // n_chunks)
    dev = checked_device(device)
    acc = _PairSums(lags, n_chunks, nblock, dev)
    hist = (
        np.zeros((L, hist_bins, hist_bins, hist_bins), dtype=np.int64)
        if hist_bins > 0 else None
    )
    # Host-side tail mirror for the histogram path: the per-pair vectors
    # are computed with the SAME numpy elementwise chain as the in-memory
    # dq_vectors, so the accumulated counts are bitwise identical.
    np_tail = np.zeros((0, 4))
    total = 0
    for chunk in chunk_iter:
        chunk = np.asarray(chunk, dtype=np.float64)
        total += chunk.shape[0]
        for part in _parts(chunk, chunk_len):
            if hist is not None:
                B, nv = np_tail.shape[0], part.shape[0]
                ext_np = np.concatenate([np_tail, part], axis=0)
                for i, d in enumerate(lags):
                    lo, hi = max(0, B - int(d)), B + nv - int(d)
                    if hi <= lo:
                        continue
                    vv = _np_dq_pairs(ext_np[lo:hi], ext_np[lo + int(d): hi + int(d)])
                    h, _ = np.histogramdd(vv, bins=(hist_bins,) * 3, range=((-1, 1),) * 3)
                    hist[i] += h.astype(np.int64)
                np_tail = ext_np[-max_lag:]
            acc.add(torch.from_numpy(part).to(dev))
    if n_chunks > 0 and total != n_total:
        raise ValueError(
            f"streamed frame count ({total}) != pre-counted n_total "
            f"({n_total}): the sub-chunk blocking would be wrong (did the "
            f"input change between the counting pre-pass and this pass?)"
        )
    return acc.stats(n_total), total, hist


def dq_statistics_streamed_multi(rep_chunk_iter, lags, chunk_len: int,
                                 min_rep_len: int = 0,
                                 short_replica_msg=None, device="cuda"):
    """Per-REPLICA streamed Delta-q sums over an iterator of
    (replica_index, (n, 4) quaternion chunk) pairs (constant memory).

    The tail resets at every replica boundary, so no pair spans two
    replicas -- exactly the in-memory multi path's per-replica
    dq_statistics.  Only per-replica SUMS are kept; the pooled means and
    the whole-replica uncertainty grouping are formed from them afterwards.

    ``min_rep_len`` > 0 fails FAST at the first replica flush shorter than
    that many frames (message from ``short_replica_msg(n_frames)`` when
    given).

    Returns (rep_sums, rep_lengths) where rep_sums is a list of
    (s_iso (L,), s_M (L,3,3), cnt (L,)) numpy triples per replica.
    """
    lags = np.asarray(lags, dtype=np.int64)
    dev = checked_device(device)
    rep_sums, rep_lengths = [], []
    cur_rep, acc, n_frames = None, None, 0

    def flush():
        if n_frames < min_rep_len:
            raise ValueError(
                short_replica_msg(n_frames) if short_replica_msg
                else f"replica {cur_rep} has {n_frames} frames; the lag "
                     f"grid needs >= {min_rep_len}"
            )
        s_M = acc.M.cpu().numpy()
        cnt = acc.cnt.astype(np.float64)
        # sum (1 - 2|v|^2) over the pairs = cnt - 2 tr(sum v v^T)
        rep_sums.append((cnt - 2.0 * np.trace(s_M, axis1=1, axis2=2), s_M, cnt))
        rep_lengths.append(n_frames)

    for rep, chunk in rep_chunk_iter:
        if rep != cur_rep:
            if cur_rep is not None:
                flush()
            cur_rep, acc, n_frames = rep, _PairSums(lags, 0, None, dev), 0
        chunk = np.asarray(chunk, dtype=np.float64)
        n_frames += chunk.shape[0]
        for part in _parts(chunk, chunk_len):
            acc.add(torch.from_numpy(part).to(dev))
    if cur_rep is None:
        raise ValueError("empty multi-replica stream (no chunks)")
    flush()
    return rep_sums, rep_lengths


def analyse_dq_multi_streamed(
    rep_chunk_iter,
    delta_t: float,
    min_dt: float,
    max_dt: float,
    skip_dt: float,
    chunk_frames: int = 65536,
    n_chunks: int = 0,
    device="cuda",
) -> DqResult:
    """analyse_dq_multi over a lazy (replica_index, quaternion chunk)
    stream (constant memory) -- the aggregate multi-replica colvar is the
    input that outgrows RAM first (the reference's run-all concatenates
    every replica's colvar, run-all.bash:312-367).

    Pooling follows analyse_dq_multi: per-replica sums and counts add, and
    ``n_chunks`` uncertainty sub-chunks group WHOLE replicas."""
    lags = _lag_grid(delta_t, min_dt, max_dt, skip_dt, None)
    max_int = int(max_dt / delta_t)

    def short_msg(n):
        return (
            f"max_dt ({max_dt}) exceeds half the shortest replica "
            f"trajectory length ({(n - 1) * delta_t / 2.0})"
        )

    # max_int*dt > (n-1)*dt/2  <=>  n < 2*max_int + 1: fail at the first
    # short replica's flush, not after the whole streaming pass.
    rep_sums, rep_lengths = dq_statistics_streamed_multi(
        rep_chunk_iter, lags, chunk_frames,
        min_rep_len=2 * max_int + 1, short_replica_msg=short_msg, device=device,
    )
    n_rep = len(rep_sums)
    n_min = min(rep_lengths)
    if max_int * delta_t > (n_min - 1) * delta_t / 2.0:
        raise ValueError(short_msg(n_min))
    if n_chunks > 0 and n_rep % n_chunks != 0:
        raise ValueError(
            f"n_chunks ({n_chunks}) must divide nReplicas ({n_rep})"
        )

    def pooled(sel):
        cnt = np.sum([c for _s, _m, c in sel], axis=0)
        return (np.sum([s for s, _m, _c in sel], axis=0) / cnt,
                np.sum([m for _s, m, _c in sel], axis=0) / cnt[:, None, None])

    iso, M = pooled(rep_sums)
    L = len(lags)
    if n_chunks > 0:
        group = n_rep // n_chunks
        per = [pooled(rep_sums[g * group: (g + 1) * group]) for g in range(n_chunks)]
        iso_c = np.stack([p[0] for p in per], axis=1)  # (L, C)
        M_c = np.stack([p[1] for p in per], axis=1)  # (L, C, 3, 3)
    else:
        iso_c, M_c = np.zeros((L, 0)), np.zeros((L, 0, 3, 3))
    dev = checked_device(device)
    stats = DqStats(lags, *(torch.as_tensor(a, device=dev) for a in (iso, M, iso_c, M_c)))
    return _finalise_dq(stats, lags, delta_t)


def analyse_dq_streamed(
    chunk_iter,
    delta_t: float,
    min_dt: float,
    max_dt: float,
    skip_dt: float,
    chunk_frames: int = 65536,
    n_chunks: int = 0,
    n_total: Optional[int] = None,
    hist_bins: int = 0,
    device="cuda",
) -> DqResult:
    """analyse_dq over a lazy stream of quaternion chunks (constant memory).

    ``n_chunks`` > 0 adds the reference's sub-chunk uncertainty estimates
    (requires ``n_total``, the total frame count, known up front).
    ``hist_bins`` > 0 additionally accumulates the per-lag delta-q
    histograms into ``DqResult.hist`` (density-normalised like
    np.histogramdd(density=True))."""
    lags = _lag_grid(delta_t, min_dt, max_dt, skip_dt, None)
    stats, n, hist = dq_statistics_streamed(
        chunk_iter, lags, chunk_frames, n_chunks=n_chunks, n_total=n_total,
        hist_bins=hist_bins, device=device,
    )
    if int(max_dt / delta_t) * delta_t > (n - 1) * delta_t / 2.0:
        raise ValueError(
            f"max_dt ({max_dt}) exceeds half the streamed trajectory length "
            f"({(n - 1) * delta_t / 2.0})"
        )
    res = _finalise_dq(stats, lags, delta_t)
    if hist is not None:
        # Density normalisation replicating np.histogramdd(density=True)
        # operation for operation (divide by each dimension's bin-width
        # array, then by the total count), so the densities are bitwise
        # equal to the in-memory path's too.
        edges = np.linspace(-1.0, 1.0, hist_bins + 1)
        dens = hist.astype(np.float64)
        s = dens.sum(axis=(1, 2, 3))
        for i in range(3):
            shape = [1, 1, 1, 1]
            shape[1 + i] = hist_bins
            dens = dens / np.diff(edges).reshape(shape)
        dens = dens / s[:, None, None, None]
        res = res._replace(hist=dens)
    return res
