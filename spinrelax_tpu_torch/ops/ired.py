"""iRED / wiRED order parameters (Gu, Li & Brueschweiler, JCTC 2014) on a
torch device (port of ``spinrelax_tpu/ops/ired.py``).

isotropic Reorientational Eigenmode Dynamics (iRED):
  1. M_ij = < P2( v_i(t) . v_j(t) ) >  over a time window.
  2. Eigendecompose M (symmetric, nRes x nRes).
  3. The 5 largest-eigenvalue modes describe collective reorientation
     (the rank-2 global tumbling subspace); the remainder are internal.
  4. S2_i = 1 - sum_{k internal} lambda_k |psi_k,i|^2.

Window lengths: iRED averages over blocks of ~5*tau_c, wiRED over ~2*tau_c.
Per-block S2 estimates give a mean and SEM, mirroring the Palmer block
statistics convention.

The Q Q^T product behind M runs in float64 whatever the vectors' dtype:
no TF32 setting reaches a float64 product, and M of float32 vectors is
then rounded once to float32 for the eigendecomposition (the JAX package
computes it at ``Precision.HIGHEST``).  All blocks of a call go through
one batched ``torch.linalg.eigh``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class IredResult(NamedTuple):
    S2: torch.Tensor  # (nRes,) mean over blocks
    dS2: torch.Tensor  # (nRes,) SEM over blocks (sqrt(n)-1 convention)
    eigenvalues: torch.Tensor  # (nBlocks, nRes) descending
    modes: torch.Tensor  # (nBlocks, nRes, nRes) eigenvectors (columns)


def _q_sums(vecs):
    """sum_t Q_t Q_t^T in float64 for (..., T, nRes, 3) vectors -> (..., nRes,
    nRes), with Q_i = vec(v_i v_i^T): (v_i . v_j)^2 = Q_i . Q_j, so the
    frame sum is ONE matmul over the (T * 9) axis instead of a
    (T, nRes, nRes) dot tensor."""
    v = vecs.to(torch.float64)
    T, n = v.shape[-3], v.shape[-2]
    Q = (v[..., :, None] * v[..., None, :]).reshape(*v.shape[:-3], T, n, 9)
    Q = Q.transpose(-3, -2).reshape(*v.shape[:-3], n, T * 9)
    return Q @ Q.transpose(-1, -2)


def _ired_matrix(vecs):
    """M_ij = < P2(v_i . v_j) > over the frame axis of (..., T, nRes, 3)
    vectors, in the vectors' dtype."""
    T = vecs.shape[-3]
    return ((1.5 / T) * _q_sums(vecs) - 0.5).to(vecs.dtype)


def _eig_s2(M, n_global: int):
    """Eigendecompose (..., nRes, nRes) block matrices -> (s2, vals desc,
    modes desc), one batched eigh."""
    n_res = M.shape[-1]
    if n_res <= n_global:
        # With every mode global there is no internal relaxation at all.
        raise ValueError(
            f"iRED needs more residues ({n_res}) than global modes "
            f"({n_global}) to separate internal motion"
        )
    vals, vecs_e = torch.linalg.eigh(M)  # ascending
    # Internal modes: all but the n_global largest.
    lam_int = vals[..., : n_res - n_global]
    psi_int = vecs_e[..., :, : n_res - n_global]  # (..., nRes, nInternal)
    s2 = 1.0 - torch.sum(lam_int[..., None, :] * psi_int**2, dim=-1)
    return s2, vals.flip(-1), vecs_e.flip(-1)


def ired_block_s2(vecs, n_global: int = 5):
    """S2 from one time block. vecs (nFrames, nRes, 3)."""
    return _eig_s2(_ired_matrix(vecs), n_global)


def _block_stats(s2):
    """(S2, dS2) over the block axis of (nBlocks, nRes): the mean, and the
    population sd over sqrt(nBlocks) - 1 (NaN for one block, the Palmer
    block-stats convention: a single block has no spread estimate)."""
    n_blocks = s2.shape[0]
    S2 = s2.mean(dim=0)
    denom = n_blocks**0.5 - 1.0
    if denom > 0:
        dS2 = torch.std(s2, dim=0, correction=0) / denom
    else:
        dS2 = torch.full_like(S2, float("nan"))
    return S2, dS2


def calculate_s2_ired(vecs, delta_t: float, tau: float, window_factor: float = 5.0,
                      n_global: int = 5) -> IredResult:
    """iRED S2 with block statistics.

    vecs : (nFrames, nRes, 3) lab-frame unit vectors, a tensor on the
        device that computes (NOT superposed -- iRED separates global from
        internal motion spectrally).
    tau  : isotropic tumbling time estimate; block length =
        window_factor * tau (5 for iRED, 2 for wiRED).
    """
    n_frames, n_res = vecs.shape[0], vecs.shape[1]
    n_per_block = max(int(window_factor * tau / delta_t), 2)
    n_blocks = n_frames // n_per_block
    if n_blocks < 1:
        raise ValueError(
            f"trajectory too short: {n_frames} frames < one window of "
            f"{n_per_block}"
        )
    v = vecs[: n_blocks * n_per_block].reshape(n_blocks, n_per_block, n_res, 3)
    s2, vals, modes = ired_block_s2(v, n_global=n_global)
    S2, dS2 = _block_stats(s2)
    return IredResult(S2, dS2, vals, modes)


def calculate_s2_wired(vecs, delta_t: float, tau: float, n_global: int = 5) -> IredResult:
    """windowed iRED: 2*tau windows."""
    return calculate_s2_ired(vecs, delta_t, tau, window_factor=2.0, n_global=n_global)


class IredStream:
    """Streaming iRED/wiRED: per-block M accumulation over chunked
    lab-frame vector streams (constant memory in the frame axis).

    The in-memory path (:func:`calculate_s2_ired`) slices the trajectory
    into nFrames // W whole blocks of W frames and eigendecomposes each
    block's M_ij = <P2(v_i . v_j)>.  This class accumulates the same
    per-block sum incrementally -- a float64 (nRes, nRes) running
    Q-outer-product accumulator on the vectors' device -- and finishes the
    blocks an :meth:`update` completes with one batched eigh.  It matches
    the in-memory result to float tolerance (the only difference is
    summation order).

    Trailing frames short of a full block are dropped, exactly like the
    in-memory ``n_frames // W``.  ``keep_modes=False`` (default) drops
    the (nBlocks, nRes, nRes) eigenvector stacks -- unbounded over a long
    stream -- and returns an empty modes array.
    """

    def __init__(self, n_res: int, n_per_block: int, n_global: int = 5,
                 keep_modes: bool = False):
        if n_per_block < 2:
            raise ValueError(f"block length must be >= 2, got {n_per_block}")
        self.n_res = int(n_res)
        self.W = int(n_per_block)
        self.n_global = int(n_global)
        self.keep_modes = keep_modes
        self._acc = None  # float64, on the first chunk's device
        self._dtype = None  # the vectors' dtype: M's and the results'
        self._in_block = 0
        self._s2 = []
        self._vals = []
        self._modes = []

    def update(self, vecs):
        """Feed (c, nRes, 3) lab-frame vectors (any chunk length)."""
        c = vecs.shape[0]
        if self._acc is None:
            self._acc = torch.zeros((self.n_res, self.n_res), dtype=torch.float64,
                                    device=vecs.device)
            self._dtype = vecs.dtype
        done = []
        off = 0
        while off < c:
            take = min(self.W - self._in_block, c - off)
            self._acc += _q_sums(vecs[off : off + take])
            self._in_block += take
            off += take
            if self._in_block == self.W:
                done.append(self._acc)
                self._acc = torch.zeros_like(self._acc)
                self._in_block = 0
        if done:
            M = ((1.5 / self.W) * torch.stack(done) - 0.5).to(self._dtype)
            s2, vals, modes = _eig_s2(M, self.n_global)
            self._s2.append(s2)
            self._vals.append(vals)
            if self.keep_modes:
                self._modes.append(modes)

    def result(self) -> IredResult:
        """Block statistics, identical conventions to calculate_s2_ired
        (sqrt(nBlocks)-1 SEM; single block -> NaN dS2)."""
        if not self._s2:
            raise ValueError(
                f"stream too short: no complete iRED window of "
                f"{self.W} frames"
            )
        s2 = torch.cat(self._s2)
        vals = torch.cat(self._vals)
        S2, dS2 = _block_stats(s2)
        modes = (
            torch.cat(self._modes) if self._modes
            else torch.zeros((0, self.n_res, self.n_res), dtype=s2.dtype, device=s2.device)
        )
        return IredResult(S2, dS2, vals, modes)
