"""Statistical helpers: weighted ensemble averages and replica pooling
(port of ``spinrelax_tpu/core/stats.py:12-50``).
"""

from __future__ import annotations

import torch


def _safe_sqrt(var):
    """sqrt with a finite gradient at 0 (a zero-variance ensemble, e.g.
    duplicated vectors, would otherwise NaN-poison a Jacobian through the
    error bars)."""
    safe = torch.where(var > 0, var, torch.ones_like(var))
    return torch.where(var > 0, torch.sqrt(safe), torch.zeros_like(var))


def weighted_mean_std(values, weights=None, axis=-1):
    """Weighted mean and population-style weighted stdev along ``axis``
    (general_maths.py:100-110).  ``weights=None`` gives the plain mean /
    std pair."""
    values = torch.as_tensor(values)
    if weights is None:
        avg = torch.mean(values, dim=axis)
        var = torch.mean((values - avg.unsqueeze(axis)) ** 2, dim=axis)
        return avg, _safe_sqrt(var)
    weights = torch.as_tensor(weights, dtype=values.dtype, device=values.device)
    wsum = torch.sum(weights, dim=axis)
    safe = torch.where(wsum > 0, wsum, torch.ones_like(wsum))
    avg = torch.sum(values * weights, dim=axis) / safe
    var = torch.sum((values - avg.unsqueeze(axis)) ** 2 * weights, dim=axis) / safe
    return avg, _safe_sqrt(var)


def simple_total_mean_square(means, sigmas, axis=0):
    """Pooled mean-square across equally-sized samples
    (general_maths.py:89-98): (GSS + ESS) / copies."""
    means = torch.as_tensor(means)
    sigmas = torch.as_tensor(sigmas, dtype=means.dtype, device=means.device)
    copies = means.shape[axis]
    grand = torch.mean(means, dim=axis, keepdim=True)
    gss = torch.sum((means - grand) ** 2, dim=axis)
    ess = torch.sum(sigmas**2, dim=axis)
    return (gss + ess) / copies
