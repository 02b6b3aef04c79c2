"""Trajectory analysis in plain torch: Horn's orientation quaternions, the
Delta-q rotational-diffusion tensor with its principal frame, bond
vectors, the Palmer-chunk C(t) (by FFT), block S2 and the Lambert
histogram -- the published methods of calculate-Ct-from-traj.py and
calculate-dq-distribution.py, worked out from the benchmark's own inputs."""

from __future__ import annotations

import math

import torch


# ---------------------------------------------------------------------------
# quaternions
# ---------------------------------------------------------------------------

def qmul(a, b):
    w1, v1 = a[..., :1], a[..., 1:]
    w2, v2 = b[..., :1], b[..., 1:]
    a_, b_ = torch.broadcast_tensors(v1, v2)
    return torch.cat([w1 * w2 - (v1 * v2).sum(-1, keepdim=True),
                      w1 * v2 + w2 * v1 + torch.linalg.cross(a_, b_, dim=-1)], -1)


def qconj(q):
    return torch.cat([q[..., :1], -q[..., 1:]], -1)


def rotate(v, q):
    """Rotate vectors by quaternions (normalised first)."""
    q = q / q.norm(dim=-1, keepdim=True)
    w, qv = q[..., :1], q[..., 1:]
    qv, v = torch.broadcast_tensors(qv, v)
    a = torch.linalg.cross(qv, v, dim=-1) + w * v
    return v + 2.0 * torch.linalg.cross(qv, a, dim=-1)


def quat_to_mat(q):
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def horn_quats(S):
    """Quaternions (..., 4), w >= 0, rotating the reference onto each frame,
    from the correlations S = sum_a w_a ref_a (x) frame_a (..., 3, 3):
    the top eigenvector of Horn's key matrix."""
    Sxx, Sxy, Sxz = S[..., 0, 0], S[..., 0, 1], S[..., 0, 2]
    Syx, Syy, Syz = S[..., 1, 0], S[..., 1, 1], S[..., 1, 2]
    Szx, Szy, Szz = S[..., 2, 0], S[..., 2, 1], S[..., 2, 2]
    K = torch.stack([
        torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
        torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
        torch.stack([Szx - Sxz, Sxy + Syx, Syy - Sxx - Szz, Syz + Szy], -1),
        torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, Szz - Sxx - Syy], -1)], -2)
    q = torch.linalg.eigh(K)[1][..., -1]
    return q * torch.where(q[..., :1] >= 0, 1.0, -1.0).to(q.dtype)


def frame_correlations(xyz, ref, weights):
    """S (F, 3, 3) of frames (F, A, 3) against the reference (A, 3) over
    the weighted atoms; the weighted centroids removed."""
    w = weights / weights.sum()
    ref_c = ref - (w[:, None] * ref).sum(0)
    frm_c = xyz - (w[None, :, None] * xyz).sum(1, keepdim=True)
    return torch.einsum("ai,faj->fij", w[:, None] * ref_c, frm_c)


def unit(v):
    return v / v.norm(dim=-1, keepdim=True)


def bond_vectors(raw_diff, q):
    """(raw, fitted) unit bond vectors: the lab-frame differences and the
    same rotated back by each frame's orientation."""
    raw = unit(raw_diff)
    return raw, unit(rotate(raw, qconj(q)[:, None, :]))


def angle_gap(qa, qb):
    """Rotation angle between two sets of quaternions, sign-blind (rad)."""
    d = torch.clamp((unit(qa) * unit(qb)).sum(-1).abs(), max=1.0)
    return 2.0 * torch.arccos(d)


# ---------------------------------------------------------------------------
# Delta-q
# ---------------------------------------------------------------------------

def dq_tensors(q, lags, operand_dtype=None):
    """<v v^T> (L, 3, 3) of v = (q(t)^-1 q(t + lag)).v over every pair;
    ``operand_dtype`` rounds each v first (the control)."""
    M = []
    for lag in lags:
        v = qmul(qconj(q[:-lag]), q[lag:])[:, 1:]
        if operand_dtype is not None:
            v = v.to(operand_dtype).to(q.dtype)
        M.append(v.T @ v / v.shape[0])
    return torch.stack(M)


def _q_v1v2(a, b):
    """Minimal rotation taking unit a onto unit b."""
    c = torch.clamp((a * b).sum(-1), -1.0, 1.0)
    axis = torch.linalg.cross(a, b, dim=-1)
    n = axis.norm(dim=-1, keepdim=True)
    axis = torch.where(n > 0, axis / torch.where(n > 0, n, 1.0), torch.zeros_like(axis))
    th = torch.arccos(c)[..., None]
    return torch.cat([torch.cos(th / 2), axis * torch.sin(th / 2)], -1)


def principal_frame(axes):
    """The quaternion of the smallest rotation taking the rows of ``axes``
    (x, y, z, an orthonormal set) onto +-z and then +-x."""
    z, x = axes[2], axes[0]
    ez = torch.zeros_like(z)
    ez[2] = 1.0
    cands = [_q_v1v2(z, ez), _q_v1v2(z, -ez)]
    q1 = cands[0] if cands[0][0] > cands[1][0] else cands[1]
    xr = rotate(x, q1)
    ex = torch.zeros_like(x)
    ex[0] = 1.0
    cands = [_q_v1v2(xr, ex), _q_v1v2(xr, -ex)]
    q2 = cands[0] if cands[0][0] > cands[1][0] else cands[1]
    return qmul(q2, q1)


def fit_decay(x, y, n_iter: int = 200):
    """tau of y = 0.5 exp(-x / tau) + 0.5 by least squares: Newton on
    log tau, then bisection on the gradient's root as a safeguard."""
    def grad_hess(la):
        u = x / torch.exp(la)
        m = 0.5 * torch.exp(-u)
        r = m + 0.5 - y
        d1 = m * u
        return (2 * r * d1).mean(), (2 * (d1 * d1 + r * d1 * (u - 1))).mean()

    def chi(la):
        return ((0.5 * torch.exp(-x / torch.exp(la)) + 0.5 - y) ** 2).mean()

    # bracket the minimum on a log grid, then refine
    grid = torch.linspace(math.log(float(x[0]) * 1e-3), math.log(float(x[-1]) * 1e3), 2001,
                          dtype=x.dtype, device=x.device)
    vals = torch.stack([chi(g) for g in grid])
    la = grid[int(torch.argmin(vals))]
    for _ in range(n_iter):
        g, h = grad_hess(la)
        step = g / h if h > 0 else torch.sign(g) * 0.01
        la = la - torch.clamp(step, -0.05, 0.05)
    return float(torch.exp(la))


def dq_analysis(q, dt: float, lags, operand_dtype=None):
    """{D (3,) sorted s^-1, D_axes (the same in the frame's axis order),
    Diso, Dani_L, Drho_L, Dani_S, Drho_S, q_frame}."""
    M = dq_tensors(q, lags, operand_dtype)
    axes = torch.linalg.eigh(M[0])[1].T  # rows, ascending eigenvalue
    q_frame = principal_frame(axes)
    R = quat_to_mat(q_frame)
    decay = 1.0 - 2.0 * torch.diagonal(R @ M @ R.T, dim1=-2, dim2=-1)  # (L, 3)
    x = torch.as_tensor([lag * dt for lag in lags], dtype=q.dtype, device=q.device)
    taus = [fit_decay(x, decay[:, i]) for i in range(3)]
    D_axes = [0.5e12 / t for t in taus]
    D = sorted(D_axes)

    def ani(d):
        return 2 * d[2] / (d[1] + d[0])

    def rho(d):
        return 3 * (d[1] - d[0]) / (2 * d[2] - d[1] - d[0])

    rev = D[::-1]
    return dict(D=D, D_axes=D_axes, Diso=sum(D) / 3.0, Dani_L=ani(D), Drho_L=rho(D), Dani_S=ani(rev),
                Drho_S=rho(rev), q_frame=q_frame)


# ---------------------------------------------------------------------------
# C(t), S2, histogram
# ---------------------------------------------------------------------------

def lag_sums(v, n_deltas: int):
    """s[d] = sum_t (v(t) . v(t + d))^2 for d = 1..n_deltas, by FFT.
    v (..., F, 3) -> (..., n_deltas)."""
    F = v.shape[-2]
    n = 1 << (F + n_deltas - 1).bit_length()
    s = 0.0
    for i, j, k in ((0, 0, 1.0), (1, 1, 1.0), (2, 2, 1.0), (0, 1, 2.0), (0, 2, 2.0),
                    (1, 2, 2.0)):
        p = torch.fft.rfft(v[..., i] * v[..., j], n=n)
        s = s + k * torch.fft.irfft(p * p.conj(), n=n)[..., 1: n_deltas + 1]
    return s


def chunk_ct(v):
    """Per-chunk C(t) (nChunk, nBond, D) of (nChunk, F, nBond, 3) unit
    vectors: -0.5 + 1.5 s[d] / (F - d), D = F // 2."""
    F = v.shape[1]
    D = F // 2
    s = lag_sums(v.transpose(1, 2), D)
    n = F - torch.arange(1, D + 1, dtype=v.dtype, device=v.device)
    return -0.5 + 1.5 * s / n


def pooled(values, n: int):
    """(mean, SEM with sqrt(n) - 1) over the leading axis of n chunks."""
    m = values.mean(0)
    return m, values.std(0, correction=0) / (math.sqrt(n) - 1.0)


def s2_blocks(v):
    """Per-block S2 (nBlock, nBond) of (nBlock, F, nBond, 3) unit vectors."""
    outer = torch.einsum("cfbi,cfbj->cbij", v, v) / v.shape[1]
    return 1.5 * (outer ** 2).sum((-2, -1)) - 0.5


def lambert_hist(v, bins_phi: int, bins_cos: int):
    """Counts (nBond, bins_phi, bins_cos) of (F, nBond, 3) unit vectors."""
    phi = torch.atan2(v[..., 1], v[..., 0])
    ix = torch.clamp(((phi + math.pi) / (2 * math.pi) * bins_phi).to(torch.int64), 0,
                     bins_phi - 1)
    iy = torch.clamp(((torch.clamp(v[..., 2], -1, 1) + 1) / 2 * bins_cos).to(torch.int64), 0,
                     bins_cos - 1)
    nb = v.shape[1]
    flat = torch.arange(nb, device=v.device)[None, :] * (bins_phi * bins_cos) \
        + ix * bins_cos + iy
    return torch.bincount(flat.reshape(-1), minlength=nb * bins_phi * bins_cos).reshape(
        nb, bins_phi, bins_cos)
