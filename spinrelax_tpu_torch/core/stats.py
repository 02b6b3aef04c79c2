"""Statistical helpers: weighted ensemble averages and replica pooling
(port of ``spinrelax_tpu/core/stats.py``).
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


def anova_total_mean_square(Ns, means, sigmas):
    """ANOVA pooling of samples of unequal sizes (general_maths.py:75-87),
    with its intended composite-stdev formula: the reference's grand mean
    drops a sum; here grand_mean = sum(N mean) / sum(N)."""
    means = torch.as_tensor(means)
    Ns = torch.as_tensor(Ns, dtype=means.dtype, device=means.device)
    sigmas = torch.as_tensor(sigmas, dtype=means.dtype, device=means.device)
    grand_total = torch.sum(Ns)
    grand_mean = torch.sum(Ns * means) / grand_total
    gss = torch.sum(Ns * (means - grand_mean) ** 2)
    ess = torch.sum((Ns - 1) * sigmas**2)
    return (gss + ess) / (grand_total - 1)


def central_moments(x, y, symmetric: bool = False):
    """The first four central moments of a weighted 1-D distribution
    (general_maths.py:57-73): mean, variance, third and fourth central
    moment; ``symmetric`` takes the odd ones as 0 and the even ones about 0."""
    x = torch.as_tensor(x)
    y = torch.as_tensor(y, dtype=x.dtype, device=x.device)
    ctot = torch.sum(y)
    if symmetric:
        mu2 = torch.sum(y * x**2) / ctot
        mu4 = torch.sum(y * x**4) / ctot
        return torch.stack([torch.zeros_like(mu2), mu2, torch.zeros_like(mu2), mu4])
    ex1 = torch.sum(y * x) / ctot
    ex2 = torch.sum(y * x**2) / ctot
    ex3 = torch.sum(y * x**3) / ctot
    ex4 = torch.sum(y * x**4) / ctot
    return torch.stack([
        ex1,
        ex2 - ex1**2,
        ex3 - 3 * ex1 * ex2 + 2 * ex1**3,
        ex4 - 4 * ex1 * ex3 + 6 * ex1**2 * ex2 - 3 * ex1**4,
    ])
