"""End-to-end observables: C(t) parameters + diffusion tensor ->
R1/R2/NOE/rho, or J(omega) (port of ``spinrelax_tpu/ops/observables.py:31-84``,
the legacy averaging, and ``:190 predict_jomega``).

Every observable, NOE included, is computed per vector sample and then
ensemble-averaged (get_relax_from_J_simd, spectral_densities.py:1710-1737).
The new-API averaging (NOE from the ensemble-mean R1) is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..constants import NucleusPair
from ..core.stats import weighted_mean_std
from ..models.ctmodel import CtModelSet
from ..models.diffusion import Diffusion
from . import relaxation as rx


class RatesWithErrors(NamedTuple):
    R1: torch.Tensor
    R2: torch.Tensor
    NOE: torch.Tensor
    rho: torch.Tensor
    dR1: Optional[torch.Tensor] = None
    dR2: Optional[torch.Tensor] = None
    dNOE: Optional[torch.Tensor] = None
    drho: Optional[torch.Tensor] = None


def compute_j(pair: NucleusPair, diffusion: Diffusion, cts: CtModelSet, vecs=None):
    """J at the pair's five frequencies: (nRes, [nSamp,] 5)."""
    omega = torch.tensor(pair.omega5(), dtype=cts.S2.dtype, device=cts.S2.device)
    return diffusion.j_combined(omega, cts.S2, cts.C, cts.tau, mask=cts.mask,
                                vecs=vecs, zeta=cts.zeta)


def _csa_broadcast(csa, ensemble: bool, like=None):
    """Align a per-residue (nRes,) CSA with an ensemble J (nRes, nSamp, 5)
    by adding the sample axis; scalars pass through.  ``like`` gives the
    dtype and device."""
    if csa is None:
        return None
    csa = torch.as_tensor(csa) if like is None else torch.as_tensor(
        csa, dtype=like.dtype, device=like.device)
    return csa[:, None] if (csa.ndim == 1 and ensemble) else csa


def predict_rates(pair: NucleusPair, diffusion: Diffusion, cts: CtModelSet,
                  vecs=None, weights=None, csa=None) -> RatesWithErrors:
    """Legacy prediction (per-sample NOE) with optional weighted ensemble
    averaging over the sample axis.

    vecs    : (nRes, nSamp, 3) or (nRes, 3) PAF vectors (anisotropic only).
    weights : (nRes, nSamp) ensemble weights or None.
    csa     : None, scalar, or (nRes,) residue-specific CSA.
    """
    J = compute_j(pair, diffusion, cts, vecs)
    ensemble = J.ndim == 3  # (nRes, nSamp, 5)
    rates = rx.relaxation_from_j(J, pair, csa=_csa_broadcast(csa, ensemble, like=J))
    if not ensemble:
        return RatesWithErrors(rates.R1, rates.R2, rates.NOE, rates.rho)
    if weights is not None:
        weights = torch.as_tensor(weights, dtype=J.dtype, device=J.device)
    R1, dR1 = weighted_mean_std(rates.R1, weights, axis=-1)
    R2, dR2 = weighted_mean_std(rates.R2, weights, axis=-1)
    NOE, dNOE = weighted_mean_std(rates.NOE, weights, axis=-1)
    rho, drho = weighted_mean_std(rates.rho, weights, axis=-1)
    return RatesWithErrors(R1, R2, NOE, rho, dR1, dR2, dNOE, drho)


def predict_jomega(pair: NucleusPair, diffusion: Diffusion, cts: CtModelSet,
                   vecs=None, weights=None):
    """J(omega) with ensemble averaging, mirroring _obtain_Jomega
    (calculate-relaxations-from-Ct.py:82-122).
    Returns (J_mean, J_std) with shape (nRes, 5); J_std is None without an
    ensemble axis."""
    J = compute_j(pair, diffusion, cts, vecs)
    if J.ndim == 2:
        return J, None
    if weights is not None:
        weights = torch.as_tensor(weights, dtype=J.dtype, device=J.device)
    mean, std = weighted_mean_std(J.movedim(-1, 0), weights, axis=-1)
    return mean.movedim(0, -1), std.movedim(0, -1)
