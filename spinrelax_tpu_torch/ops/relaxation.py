"""R1 / R2 / hetNOE / rho, the CSA-DD cross-correlated rates eta_z /
eta_xy, and experimental rho from measured rates (port of
``spinrelax_tpu/ops/relaxation.py``).

J carries the five frequencies [J(0), J(wX), J(wH-wX), J(wH), J(wH+wX)]
on its last axis; every prefactor broadcasts.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..constants import NucleusPair

# Frequency indices (spectral_densities.py:147-151)
IOM0, IOMX, IOMBMX, IOMB, IOMBPX = 0, 1, 2, 3, 4


class RelaxationRates(NamedTuple):
    R1: torch.Tensor
    R2: torch.Tensor
    NOE: torch.Tensor
    rho: torch.Tensor


def r1_from_j(J, f_dd, f_csa, time_fact):
    """R1 (spectral_densities.py:824-829)."""
    return time_fact * (
        f_dd * (J[..., IOMBMX] + 3 * J[..., IOMX] + 6 * J[..., IOMBPX])
        + f_csa * J[..., IOMX]
    )


def r2_from_j(J, f_dd, f_csa, time_fact):
    """R2 (spectral_densities.py:859-864)."""
    return time_fact * (
        0.5
        * f_dd
        * (4 * J[..., IOM0] + J[..., IOMBMX] + 3 * J[..., IOMX] + 6 * J[..., IOMBPX] + 6 * J[..., IOMB])
        + (1.0 / 6.0) * f_csa * (4 * J[..., IOM0] + 3 * J[..., IOMX])
    )


def cross_rate_from_j(J, f_dd, time_fact, gamma_ratio):
    """Dipolar cross-relaxation rate tf gr f_dd (6 J(wB+wA) - J(wB-wA))
    (spectral_densities.py:888-892)."""
    return time_fact * gamma_ratio * f_dd * (
        6 * J[..., IOMBPX] - J[..., IOMBMX]
    )


def noe_from_j(J, f_dd, time_fact, gamma_ratio, R1):
    """hetNOE given R1 (spectral_densities.py:888-892); gamma_ratio is
    gamma_B / gamma_A."""
    return 1.0 + cross_rate_from_j(J, f_dd, time_fact, gamma_ratio) / R1


def rho_from_j(J):
    """rho = J(wX) / J(0) (spectral_densities.py:1775-1786)."""
    return J[..., IOMX] / J[..., IOM0]


def relaxation_from_j(J, pair: NucleusPair, csa=None) -> RelaxationRates:
    """All four observables from the 5-frequency J
    (spectral_densities.py:1710-1737).  ``csa``: None (pair default), a
    scalar, or a tensor broadcasting against J's leading axes."""
    f_dd = pair.factor_dd()
    f_csa = pair.factor_csa(csa)
    tf = pair.time_fact
    R1 = r1_from_j(J, f_dd, f_csa, tf)
    R2 = r2_from_j(J, f_dd, f_csa, tf)
    NOE = noe_from_j(J, f_dd, tf, pair.gamma_b / pair.gamma_a, R1)
    return RelaxationRates(R1, R2, NOE, rho_from_j(J))


def _eta_fact(pair: NucleusPair, beta):
    """Shared eta_z/eta_xy prefactor (mu_0 hbar / 4pi = hbar * 1e-7,
    spectral_densities.py:1758-1773) including the reference's
    1.5*cos(beta)-0.5 form [sic: cos, not cos^2 -- replicated for
    parity]."""
    r_m = pair.r_ab_nm * 1e-9
    return (
        -1.0545718e-41
        * pair.gamma_b
        * pair.gamma_a**2
        * r_m**-3.0
        * pair.B0
        * pair.csa_value
        * 0.4
    ) * (1.5 * math.cos(beta) - 0.5)


def eta_z_from_j(J, pair: NucleusPair, beta=0.0):
    """Longitudinal CSA-DD cross-correlated rate eta_z
    (Kroenke et al. 1998; spectral_densities.py:1758-1765)."""
    return _eta_fact(pair, beta) * J[..., IOMX]


def eta_xy_from_j(J, pair: NucleusPair, beta=0.0):
    """Transverse CSA-DD cross-correlated rate eta_xy
    (spectral_densities.py:1767-1773)."""
    return _eta_fact(pair, beta) / 6.0 * (4.0 * J[..., IOM0] + 3.0 * J[..., IOMX])


def rho_from_rates(R1, R2, NOE, gamma_a, gamma_b):
    """Experimental rho from (R1, R2, NOE) with high-frequency stripping
    (Ghose/Fushman/Cowburn 2001 Eq.4; spectral_densities.py:1788-1800);
    elementwise on tensors (or numpy arrays)."""
    HF = -0.2 * (gamma_a / gamma_b) * (1.0 - NOE) * R1
    R1p = R1 - 7.0 * (0.921 / 0.87) ** 2 * HF
    R2p = R2 - 6.5 * (0.955 / 0.87) ** 2 * HF
    return (4.0 / 3.0) * R1p / (2.0 * R2p - R1p)
