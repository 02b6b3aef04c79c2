"""Spherical-coordinate transforms and histogram helpers on torch tensors
(port of ``spinrelax_tpu/core/geometry.py``).

Replaces ``general_maths.py:118-205`` (xyz<->r/phi/theta) and the
Lambert-cylindrical histogram logic from ``calculate-Ct-from-traj.py:609-636``
/ ``spectral_densities.py:2334-2350``.  The reference's unit-vector
``xyz_to_rtp`` contains a latent bug (theta computed as arccos(z/phi),
general_maths.py:131-139); here the intended maths (theta = arccos(z) for
unit vectors) is implemented.
"""

from __future__ import annotations

import math

import torch


def xyz_to_rtp(v):
    """(..., 3) xyz -> (..., 3) [r, phi, theta]; phi in (-pi, pi],
    theta in [0, pi] from +z (general_maths.py:118-158, intended maths)."""
    r = torch.linalg.vector_norm(v, dim=-1)
    phi = torch.arctan2(v[..., 1], v[..., 0])
    safe_r = torch.where(r > 0, r, torch.ones_like(r))
    theta = torch.arccos(torch.clamp(v[..., 2] / safe_r, -1.0, 1.0))
    return torch.stack([r, phi, theta], dim=-1)


def xyz_to_pt(v):
    """Unit vectors (..., 3) -> (..., 2) [phi, theta]."""
    phi = torch.arctan2(v[..., 1], v[..., 0])
    theta = torch.arccos(torch.clamp(v[..., 2], -1.0, 1.0))
    return torch.stack([phi, theta], dim=-1)


def pt_to_xyz(pt):
    """(..., 2) [phi, theta] -> unit vectors (..., 3)
    (general_maths.py:160-187 with bUnit=True)."""
    phi, theta = pt[..., 0], pt[..., 1]
    st = torch.sin(theta)
    return torch.stack([torch.cos(phi) * st, torch.sin(phi) * st, torch.cos(theta)], dim=-1)


def rtp_to_xyz(rtp):
    """(..., 3) [r, phi, theta] -> (..., 3) xyz."""
    r, phi, theta = rtp[..., 0], rtp[..., 1], rtp[..., 2]
    st = torch.sin(theta)
    return torch.stack(
        [r * torch.cos(phi) * st, r * torch.sin(phi) * st, r * torch.cos(theta)], dim=-1
    )


def lambert_edges(bins_phi: int = 72, bins_cos: int = 36, dtype=torch.float32,
                  device=None):
    """Bin edges of :func:`lambert_histogram`: (bins_phi + 1,) spanning
    (-pi, pi) and (bins_cos + 1,) spanning (-1, 1)."""
    return (torch.linspace(-math.pi, math.pi, bins_phi + 1, dtype=dtype, device=device),
            torch.linspace(-1.0, 1.0, bins_cos + 1, dtype=dtype, device=device))


def lambert_histogram(vecs, bins_phi: int = 72, bins_cos: int = 36, valid=None):
    """2D histogram over (phi, cos(theta)) -- the Lambert cylindrical
    projection, equal-area so bin occupancies are comparable
    (calculate-Ct-from-traj.py:609-636).

    Parameters
    ----------
    vecs : (..., nSamples, 3) unit vectors; the histogram is taken over the
        second-to-last axis independently for each leading index.
    valid : optional bool mask broadcastable to (..., nSamples); False
        samples are discarded (scattered into a dropped overflow slot) --
        used by fixed-shape streaming callers that zero-pad partial chunk
        groups (pipeline.stages.stage_ct_streamed).

    Returns
    -------
    hist : (..., bins_phi, bins_cos) int32 counts
    edges_phi : (bins_phi+1,) edges spanning (-pi, pi)
    edges_cos : (bins_cos+1,) edges spanning (-1, 1)
    """
    phi = torch.arctan2(vecs[..., 1], vecs[..., 0])
    cth = torch.clamp(vecs[..., 2], -1.0, 1.0)

    # Bin indices; right-inclusive top edge like np.histogramdd.  The cast
    # truncates toward zero (not floor), and phi = pi lands in the clipped
    # top bin.
    fx = (phi + math.pi) / (2.0 * math.pi) * bins_phi
    fy = (cth + 1.0) / 2.0 * bins_cos
    ix = torch.clamp(fx.to(torch.int32), 0, bins_phi - 1)
    iy = torch.clamp(fy.to(torch.int32), 0, bins_cos - 1)
    flat = (ix * bins_cos + iy).to(torch.int64)

    nbins = bins_phi * bins_cos
    n_slots = nbins
    if valid is not None:
        mask = torch.as_tensor(valid, dtype=torch.bool, device=flat.device)
        flat = torch.where(mask.broadcast_to(flat.shape), flat, nbins)  # discard slot
        n_slots = nbins + 1
    lead_shape = flat.shape[:-1]
    flat2 = flat.reshape((-1, flat.shape[-1]))
    # One scatter-add over (row, bin) for every leading index, into a
    # histogram of known size (bincount reads the largest index back to
    # the host, a wait on the card).  Counts are int32, NOT the coordinate
    # dtype: float32 counts saturate at 2^24 (callers that pool chunk
    # histograms pool in int64).
    rows = torch.arange(flat2.shape[0], device=flat.device)[:, None]
    idx = (rows * n_slots + flat2).reshape(-1)
    hist = torch.zeros(flat2.shape[0] * n_slots, dtype=torch.int32, device=flat.device)
    hist.index_add_(0, idx, torch.ones((), dtype=torch.int32, device=flat.device).expand_as(idx))
    hist = hist.reshape(flat2.shape[0], n_slots)[:, :nbins]
    hist = hist.reshape(lead_shape + (bins_phi, bins_cos))
    edges_phi, edges_cos = lambert_edges(bins_phi, bins_cos, vecs.dtype, vecs.device)
    return hist, edges_phi, edges_cos


def lambert_hist_to_vecs(hist, edges_phi, edges_cos):
    """Histogram -> (bin-centre unit vectors, weights); zero-weight bins are
    kept for fixed shapes (spectral_densities.py:2334-2350).

    hist : (nRes, bins_phi, bins_cos)
    Returns vecs (nRes, nPoints, 3) and weights (nRes, nPoints).
    """
    phis = 0.5 * (edges_phi[:-1] + edges_phi[1:])
    thetas = torch.arccos(torch.clamp(0.5 * (edges_cos[:-1] + edges_cos[1:]), -1.0, 1.0))
    pp, tt = torch.meshgrid(phis, thetas, indexing="ij")
    bin_vecs = pt_to_xyz(torch.stack([pp, tt], dim=-1)).reshape(-1, 3)
    n_res = hist.shape[0]
    n_pts = bin_vecs.shape[0]
    vecs = bin_vecs[None].expand(n_res, n_pts, 3)
    weights = hist.reshape(n_res, n_pts)
    return vecs, weights
