"""Trajectory orientation: batched Horn quaternion superposition (port of
``spinrelax_tpu/ops/orient.py``).

Replaces the reference's *external* orientation toolchain -- the PLUMED2
QUATERNION colvar (the per-frame rigid-body orientation quaternion vs a
reference structure; plumed-quat-template.dat + run-all.bash:359) and
mdtraj's ``center_coordinates``/``superpose`` least-squares fit
(calculate-Ct-from-traj.py:433,466-467).

Horn's closed-form solution: the optimal rotation mapping reference
coordinates onto a frame is the leading eigenvector of the 4x4 key
matrix K built from the coordinate correlation matrix.  All frames are
solved in one batched ``torch.linalg.eigh`` -- no external processes, no
per-frame loops.  ``eigh`` fixes an eigenvector only up to sign (and, where
the top two eigenvalues are close, up to a rotation of their plane): the
double-cover reduction pins the sign, and rotated vectors do not depend on
it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import quaternion as qt


def _horn_K(S):
    """Horn's 4x4 key matrix from a 3x3 correlation S = sum w x_ref x_frm^T."""
    Sxx, Sxy, Sxz = S[..., 0, 0], S[..., 0, 1], S[..., 0, 2]
    Syx, Syy, Syz = S[..., 1, 0], S[..., 1, 1], S[..., 1, 2]
    Szx, Szy, Szz = S[..., 2, 0], S[..., 2, 1], S[..., 2, 2]
    row0 = torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1)
    row1 = torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1)
    row2 = torch.stack([Szx - Sxz, Sxy + Syx, Syy - Sxx - Szz, Syz + Szy], -1)
    row3 = torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, Szz - Sxx - Syy], -1)
    return torch.stack([row0, row1, row2, row3], -2)


def _sign_continuous(q):
    """Flip q_t wherever it points away from the (already flipped) q_{t-1},
    along the leading axis, without a loop.  The sequential rule is s_0 = 1,
    s_t = +1 if s_{t-1} (q_{t-1} . q_t) >= 0 else -1: the running sign is
    the cumulative product of sign(q_{t-1} . q_t) since the last exact
    zero of that dot product (a zero restarts the run at +1)."""
    d = torch.sum(q[1:] * q[:-1], dim=-1)
    d = torch.cat([torch.ones_like(d[:1]), d])
    prod = torch.cumprod(torch.where(d < 0, -1.0, 1.0).to(q.dtype), dim=0)
    t = torch.arange(d.shape[0], device=q.device)
    last_zero = torch.cummax(torch.where(d == 0, t, torch.zeros_like(t)), dim=0).values
    return q * (prod * prod[last_zero])[:, None]


def _quats_from_S(S, continuous: bool):
    """Horn quaternions from the correlation matrices: top eigenvector of
    the 4x4 K, double-cover reduced; optionally sign-continuous along the
    leading (frame) axis (flip q_t if q_t . q_{t-1} < 0).  Shared by
    :func:`orientation_quats` and :func:`bond_vectors_from_obs` so the
    convention cannot diverge."""
    _, vecs = torch.linalg.eigh(_horn_K(S))  # ascending; take last column
    q = qt.qreduce(vecs[..., :, -1])
    return _sign_continuous(q) if continuous else q


def _norm_weights(weights, n_atoms: int, like):
    if weights is None:
        w = torch.ones(n_atoms, dtype=like.dtype, device=like.device)
    else:
        w = torch.as_tensor(weights, dtype=like.dtype, device=like.device)
    return w / torch.sum(w)


def orientation_quats(frames, reference, weights=None):
    """Per-frame rigid-body orientation quaternions vs a reference.

    frames    : (nFrames, nAtoms, 3) trajectory coordinates.
    reference : (nAtoms, 3) reference coordinates.
    weights   : (nAtoms,) fit weights (e.g. occupancies/masses) or None.

    Returns q (nFrames, 4) such that rotating the *reference* by q gives
    the best fit to each frame (the same convention as the PLUMED
    QUATERNION colvar: the orientation of the frame relative to the
    reference).  Quaternions are double-cover reduced and sign-continuous
    along the trajectory.
    """
    reference = torch.as_tensor(reference, dtype=frames.dtype, device=frames.device)
    w = _norm_weights(weights, reference.shape[0], frames)
    ref_c = reference - torch.sum(w[:, None] * reference, dim=0)
    frm_c = frames - torch.sum(w[None, :, None] * frames, dim=1, keepdim=True)
    # S_f = sum_a w_a ref_a (x) frm_fa : (nFrames, 3, 3)
    S = torch.einsum("ai,faj->fij", w[:, None] * ref_c, frm_c)
    return _quats_from_S(S, continuous=True)


def superpose(frames, reference, fit_weights=None):
    """Least-squares superpose all frames onto the reference (the
    mdtraj ``center_coordinates`` + ``superpose`` step,
    calculate-Ct-from-traj.py:433,466-467).

    Returns the rotated+centred coordinates (nFrames, nAtoms, 3): each
    frame is centred on its fit-weight centroid and rotated so the fit
    atoms best match the centred reference.
    """
    q = orientation_quats(frames, reference, fit_weights)
    w = _norm_weights(fit_weights, frames.shape[1], frames)
    frm_c = frames - torch.sum(w[None, :, None] * frames, dim=1, keepdim=True)
    # q rotates the reference onto the frame; to bring the frame onto the
    # reference, apply the conjugate.
    return qt.rotate_vector(frm_c, qt.qconj(q)[:, None, :])


class BondVectors(NamedTuple):
    raw: torch.Tensor  # (nFrames, nBonds, 3) lab-frame unit vectors
    fitted: torch.Tensor  # (nFrames, nBonds, 3) after superposition


def _index(idx, device):
    return torch.as_tensor(np.asarray(idx), dtype=torch.long, device=device)


def bond_vectors(frames, reference, idx_h, idx_x, fit_weights=None):
    """Extract normalised X-H bond vectors pre- and post-fit
    (obtain_XHvecs, calculate-Ct-from-traj.py:64-86).

    idx_h / idx_x : (nBonds,) atom indices of H and X partners.
    """
    raw = frames[:, _index(idx_h, frames.device), :] - frames[:, _index(idx_x, frames.device), :]
    raw = qt.vecnorm(raw)
    # Rotation is linear and translation cancels in differences, so only
    # the nBonds difference vectors need rotating, not all nAtoms.
    q = orientation_quats(frames, reference, fit_weights)
    fitted = qt.vecnorm(qt.rotate_vector(raw, qt.qconj(q)[:, None, :]))
    return BondVectors(raw, fitted)


def bond_obs_matrix(reference, fit_weights=None):
    """The (3, nAtoms) float64 numpy weighted-centred reference correlation
    matrix A with S_f = A @ frame -- the single home of the reduction both
    :func:`bond_obs_host` (numpy slabs) and the fused native ingest
    (io.native.iter_xtc_obs; reduction inside the decoder) apply.
    A's weighted columns sum to zero, so A @ frame is translation-
    invariant without per-frame centring."""
    reference = np.asarray(reference, dtype=np.float64)
    if fit_weights is None:
        w = np.ones(reference.shape[0])
    else:
        w = np.asarray(fit_weights, dtype=np.float64)
    w = w / w.sum()
    ref_c = reference - (w[:, None] * reference).sum(0)
    return (w[:, None] * ref_c).T


def bond_obs_host(xyz, reference, idx_h, idx_x, fit_weights=None,
                  frame_slab_bytes=1 << 23):
    """Host-side sufficient statistics for :func:`bond_vectors_from_obs`.

    The per-frame Kabsch/Horn fit consumes the coordinates ONLY through
    the 3x3 correlation S (see :func:`orientation_quats`), and the bond
    vectors are translation-invariant coordinate differences -- so a
    file-fed chunk never needs to ship its full (nFrames, nAtoms, 3)
    coordinate block to the device.  This reduction is the whole
    host->device contract of the streamed C(t) stage: nAtoms/nBonds-fold
    less transfer.

    Returns numpy (raw_diff (F, nBonds, 3), S (F, 3, 3)) in the dtype of
    ``xyz`` (float32 in, float32 out; float64 in, float64 out; anything
    else float32).  S is accumulated in float64 slabs
    (``frame_slab_bytes`` bounds the float64 temporary).
    """
    xyz = np.asarray(xyz)
    out_dtype = np.float64 if xyz.dtype == np.float64 else np.float32
    A = bond_obs_matrix(reference, fit_weights)
    if xyz.dtype == np.float32:
        # float32 chunks (every binary trajectory codec) reduce through
        # the NATIVE per-frame loop -- the same code the fused .xtc ingest
        # runs inside the decoder, so host-reduced and decoder-reduced
        # observables are BIT-identical (numpy's BLAS dgemm sums S in a
        # different float64 order, flipping occasional float32-cast ulps).
        from ..io import native as natio

        raw_diff, S64 = natio.reduce_obs_mem(xyz, idx_h, idx_x, A, threads=0)
        return raw_diff, S64.astype(out_dtype)

    raw_diff = (xyz[:, idx_h, :] - xyz[:, idx_x, :]).astype(out_dtype, copy=False)
    n_frames, n_atoms = xyz.shape[:2]
    slab = max(1, int(frame_slab_bytes // (n_atoms * 3 * 8)))
    S = np.empty((n_frames, 3, 3), dtype=out_dtype)
    for lo in range(0, n_frames, slab):
        x = xyz[lo : lo + slab].astype(np.float64, copy=False)
        # No per-frame COM subtraction: A's weighted columns sum to zero
        # (ref_c is weighted-centred), so A @ (x - com) == A @ x exactly.
        S[lo : lo + slab] = A @ x
    return raw_diff, S


def bond_vectors_from_obs(raw_diff, S):
    """Device half of the split :func:`bond_vectors`: normalised raw and
    superposed bond vectors from the host-reduced observables of
    :func:`bond_obs_host`, as tensors on one device.  Identical convention
    to ``bond_vectors`` -- Horn quaternion from S, conjugate rotation of
    the difference vectors (calculate-Ct-from-traj.py:64-86,466-467).  The
    sign-continuity pass is skipped: rotate_vector is invariant under
    q -> -q, so continuity only matters when the quaternions themselves
    are exposed."""
    raw = qt.vecnorm(raw_diff)
    q = _quats_from_S(S, continuous=False)
    fitted = qt.vecnorm(qt.rotate_vector(raw, qt.qconj(q)[:, None, :]))
    return BondVectors(raw, fitted)
