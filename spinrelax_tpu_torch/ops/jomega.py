"""Spectral densities J(omega) (port of ``spinrelax_tpu/ops/jomega.py``,
main-path subset).  omega is (nOm,); every return has a trailing nOm axis.
"""

from __future__ import annotations

import torch


def jsum(omega, A_J, D_J):
    """J_k = sum_j A_j D_j / (D_j^2 + om_k^2).

    omega (nOm,), A_J (..., J), D_J broadcastable to A_J -> (..., nOm).
    """
    D_J = torch.broadcast_to(torch.as_tensor(D_J, dtype=A_J.dtype,
                                             device=A_J.device), A_J.shape)
    lor = D_J[..., None] / (D_J[..., None] ** 2 + omega**2)  # (..., J, nOm)
    return torch.sum(A_J[..., None] * lor, dim=-2)


def j_combine_isotropic(omega, tau_iso, S2, C, tau, comp_mask=None, zeta=1.0):
    """Isotropic tumbling combined with a local multi-exponential
    (spectral_densities.py:2038-2050):
    J = zeta [S2 tau_g / (1 + (w tau_g)^2) + sum_i C_i k_i / (k_i^2 + w^2)],
    k_i = 1/tau_g + 1/tau_i.  S2 (...,), C/tau (..., K) -> (..., nOm).
    """
    safe_tau = torch.where(tau > 0, tau, torch.ones_like(tau))
    k = 1.0 / tau_iso + 1.0 / safe_tau  # (..., K)
    J = S2[..., None] * tau_iso / (1.0 + (omega * tau_iso) ** 2)
    term = C[..., None] * k[..., None] / (k[..., None] ** 2 + omega**2)
    if comp_mask is not None:
        term = term * comp_mask[..., None]
    return zeta * (J + torch.sum(term, dim=-2))
