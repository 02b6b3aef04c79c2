"""Batched quaternion algebra on torch tensors (port of
``spinrelax_tpu/core/quaternion.py``).

Replaces the reference's ``transforms3d_supplement.py`` (plus the parts
of the external ``transforms3d`` package it relies on).  All functions
operate on tensors whose **last axis** holds the quaternion (w, x, y, z)
or vector (x, y, z) components, broadcast over any number of leading batch
axes, on the device and in the dtype of their inputs, with no
data-dependent Python control flow.

Convention: Hamilton quaternions, scalar-first.
"""

from __future__ import annotations

import math

import torch


def _unit(like, axis: int):
    """The lab axis ``axis`` broadcast to ``like``'s (..., 3) shape."""
    e = torch.zeros_like(like)
    e[..., axis] = 1.0
    return e


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def qnorm(q):
    """Normalise quaternions along the last axis; zero-safe
    (transforms3d_supplement.py:40-52 semantics: 0-vectors map to 0)."""
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return torch.where(n > 0, q / torch.where(n > 0, n, torch.ones_like(n)),
                       torch.zeros_like(q))


def vecnorm(v):
    """Normalise vectors along the last axis, mapping zero vectors to zero
    (transforms3d_supplement.py:40-52)."""
    return qnorm(v)


def qmult(q1, q2):
    """Hamilton product, broadcasting over leading axes
    (transforms3d_supplement.py:163-183)."""
    w1, v1 = q1[..., :1], q1[..., 1:]
    w2, v2 = q2[..., :1], q2[..., 1:]
    w = w1 * w2 - torch.sum(v1 * v2, dim=-1, keepdim=True)
    v = w1 * v2 + w2 * v1 + _cross(v1, v2)
    return torch.cat([w, v], dim=-1)


def qconj(q):
    """Conjugate (= inverse for unit quaternions)
    (transforms3d_supplement.py:185-186)."""
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


qinvert = qconj


def qreduce(q, qref=None):
    """Select the image of +-q closer to ``qref`` (double-cover reduction,
    transforms3d_supplement.py:219-245). sign(0) counts as +1."""
    if qref is None:
        d = q[..., 0]
    else:
        qref = torch.as_tensor(qref, dtype=q.dtype, device=q.device)
        d = torch.sum(q * qref, dim=-1)
    sgn = torch.where(d >= 0, 1.0, -1.0).to(q.dtype)
    return q * sgn[..., None]


def rotate_vector(v, q, normalised: bool = False):
    """Rotate vectors ``v`` by unit quaternions ``q``; broadcasts
    (transforms3d_supplement.py:263-296): b = q_v x (q_v x v + w v); v + 2b.
    """
    if not normalised:
        q = qnorm(q)
    w, qv = q[..., :1], q[..., 1:]
    a = _cross(qv, v) + w * v
    b = _cross(qv, a)
    return v + 2.0 * b


def axangle_to_quat(axis, angle, normalised: bool = False):
    """Axis-angle to quaternion, batched
    (transforms3d_supplement.py:54-69)."""
    angle = torch.as_tensor(angle, dtype=axis.dtype, device=axis.device)
    if not normalised:
        axis = vecnorm(axis)
    half = angle / 2.0
    w = torch.cos(half)[..., None]
    v = axis * torch.sin(half)[..., None]
    w, _ = torch.broadcast_tensors(w, v[..., :1])
    return torch.cat([w, v], dim=-1)


def quat_v1v2(v1, v2, normalised: bool = False):
    """Minimum-angle quaternion rotating v1 onto v2, batched
    (transforms3d_supplement.py:85-106).  Parallel vectors give identity."""
    if not normalised:
        v1 = vecnorm(v1)
        v2 = vecnorm(v2)
    v1, v2 = torch.broadcast_tensors(v1, v2)
    dot = torch.clamp(torch.sum(v1 * v2, dim=-1), -1.0, 1.0)
    th = torch.arccos(dot)
    ax = _cross(v1, v2)
    # Parallel vectors: zero cross, th = 0 -> identity, matching the
    # reference's qeye() branch (transforms3d_supplement.py:78-81).
    # ANTIparallel vectors also give a zero cross but th = pi: the naive
    # axangle of a zero axis would return the INVALID zero quaternion (the
    # reference does) -- any axis perpendicular to v1 realises the
    # 180-degree rotation.
    px = _cross(v1, _unit(v1, 0))
    py = _cross(v1, _unit(v1, 1))
    fallback = torch.where(torch.sum(px * px, dim=-1, keepdim=True) > 1e-12, px, py)
    anti = (dot < -1.0 + 1e-12)[..., None]
    ax = torch.where(anti, fallback, ax)
    return axangle_to_quat(ax, th)


def quat_to_mat(q):
    """Unit quaternion -> 3x3 rotation matrix, batched over leading axes."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        dim=-2,
    )


def mat_to_quat(M):
    """Rotation matrix -> unit quaternion (w >= 0), batched; branch-free
    (replaces transforms3d.quaternions.mat2quat).

    Uses the standard four-candidate construction and selects the
    numerically safest via the largest diagonal combination.
    """
    m00, m01, m02 = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    m10, m11, m12 = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    m20, m21, m22 = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]

    tr = m00 + m11 + m22
    tw = 1.0 + tr
    tx = 1.0 + m00 - m11 - m22
    ty = 1.0 - m00 + m11 - m22
    tz = 1.0 - m00 - m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=0.0))

    def over(num, t):
        return 0.25 * num / torch.clamp(safe_sqrt(t), min=1e-30) * 2

    qw = torch.stack([0.5 * safe_sqrt(tw), over(m21 - m12, tw), over(m02 - m20, tw),
                      over(m10 - m01, tw)], dim=-1)
    qx = torch.stack([over(m21 - m12, tx), 0.5 * safe_sqrt(tx), over(m01 + m10, tx),
                      over(m02 + m20, tx)], dim=-1)
    qy = torch.stack([over(m02 - m20, ty), over(m01 + m10, ty), 0.5 * safe_sqrt(ty),
                      over(m12 + m21, ty)], dim=-1)
    qz = torch.stack([over(m10 - m01, tz), over(m02 + m20, tz), over(m12 + m21, tz),
                      0.5 * safe_sqrt(tz)], dim=-1)

    disc = torch.stack([tw, tx, ty, tz], dim=-1)
    idx = torch.argmax(disc, dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # (..., 4 candidates, 4 components)
    q = torch.take_along_dim(cands, idx[..., None, None], dim=-2)[..., 0, :]
    return qreduce(qnorm(q))


def frame_transform(axes):
    """Quaternion performing the COORDINATE transform that maps the three
    given (row) axes onto the lab axes (transforms3d_supplement.py:119-133).
    ``axes`` has shape (..., 3, 3) with axes[..., i, :] the i-th axis."""
    q1 = quat_v1v2(axes[..., 2, :], _unit(axes[..., 2, :], 2))
    xrot = rotate_vector(axes[..., 0, :], q1, normalised=True)
    q2 = quat_v1v2(xrot, _unit(xrot, 0))
    return qmult(q2, q1)


def frame_transform_min(axes):
    """Sign-minimised variant: chooses +-z and +-x targets that maximise the
    quaternion scalar part, i.e. the smallest rotation
    (transforms3d_supplement.py:137-149). Batched over leading axes."""
    zax = axes[..., 2, :]
    ref_zp = _unit(zax, 2)
    q1a = quat_v1v2(zax, ref_zp)
    q1b = quat_v1v2(zax, -ref_zp)
    q1 = torch.where((q1a[..., 0] > q1b[..., 0])[..., None], q1a, q1b)

    xrot = rotate_vector(axes[..., 0, :], q1, normalised=True)
    ref_xp = _unit(xrot, 0)
    q2a = quat_v1v2(xrot, ref_xp)
    q2b = quat_v1v2(xrot, -ref_xp)
    q2 = torch.where((q2a[..., 0] > q2b[..., 0])[..., None], q2a, q2b)
    return qmult(q2, q1)


def random_quats(generator: torch.Generator, n: int, dtype=torch.float64,
                 reduce: bool = True):
    """Shoemake-uniform random rotations (transforms3d_supplement.py:200-217)
    drawn from a ``torch.Generator``, on the generator's device."""
    r = torch.rand((3, n), generator=generator, dtype=dtype, device=generator.device)
    two_pi = 2.0 * math.pi
    q = torch.stack(
        [
            torch.sqrt(1.0 - r[0]) * torch.sin(two_pi * r[1]),
            torch.sqrt(1.0 - r[0]) * torch.cos(two_pi * r[1]),
            torch.sqrt(r[0]) * torch.sin(two_pi * r[2]),
            torch.sqrt(r[0]) * torch.cos(two_pi * r[2]),
        ],
        dim=-1,
    )
    return qreduce(q) if reduce else q


def slerp(q1, q2, r):
    """Spherical interpolation between two quaternions along the shortest
    arc, with q = q1 at r = 0 and q = q2 (up to sign) at r = 1.

    Covers transforms3d_supplement.py:253-261, but fixes two bugs the
    reference itself flags with a WARNING: it doubles the arc angle and
    divides by sin(th) = 0 for identical endpoints.  Here th is the 4D
    angle arccos(|q1.q2|); near-parallel endpoints fall back to normalised
    lerp."""
    r = torch.as_tensor(r, dtype=q1.dtype, device=q1.device)
    dot = torch.sum(q1 * q2, dim=-1)
    q2s = torch.where(dot[..., None] < 0, -q2, q2)  # shortest path
    th = torch.arccos(torch.clamp(torch.abs(dot), 0.0, 1.0))
    s = torch.sin(th)
    safe = s > 1e-8
    s_ = torch.where(safe, s, torch.ones_like(s))
    w1 = torch.where(safe, torch.sin((1 - r) * th) / s_, 1.0 - r)
    w2 = torch.where(safe, torch.sin(r * th) / s_, r)
    return qnorm(w1[..., None] * q1 + w2[..., None] * q2s)
