"""End-to-end observables: C(t) parameters + diffusion tensor ->
R1/R2/NOE/rho, or J(omega) (port of ``spinrelax_tpu/ops/observables.py``).

Two averaging semantics exist in the reference and both are provided:

- legacy (:func:`predict_rates`): every observable, NOE included, is
  computed per vector sample and then ensemble-averaged
  (get_relax_from_J_simd, spectral_densities.py:1710-1737);
- new API (:func:`predict_rates_newapi`): R1 is ensemble-averaged first
  and the averaged R1 enters the NOE (spinRelaxationNOE.eval,
  spectral_densities.py:877-907); :func:`rates_from_a_moments_newapi`
  gives the same ensemble statistics from the A-coefficient moments.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..constants import NucleusPair
from ..core.stats import _safe_sqrt, weighted_mean_std
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


def predict_rates_newapi(pair: NucleusPair, diffusion: Diffusion, cts: CtModelSet,
                         vecs=None, weights=None, csa=None) -> RatesWithErrors:
    """New-API prediction matching spinRelaxation{R1,R2,NOE}.eval(): the
    NOE uses the ensemble-averaged R1 (spectral_densities.py:894-907)."""
    J = compute_j(pair, diffusion, cts, vecs)
    return rates_from_j_newapi(pair, J, weights=weights, csa=csa)


def rates_from_j_newapi(pair: NucleusPair, J, weights=None, csa=None) -> RatesWithErrors:
    """New-API rates from a precomputed J(omega5), so that callers share
    one J evaluation across experiments (the A/D coefficients do not
    depend on the field)."""
    ensemble = J.ndim == 3
    f_dd = pair.factor_dd()
    f_csa = pair.factor_csa(_csa_broadcast(csa, ensemble, like=J))
    tf = pair.time_fact
    gr = pair.gamma_b / pair.gamma_a

    r1_s = rx.r1_from_j(J, f_dd, f_csa, tf)
    r2_s = rx.r2_from_j(J, f_dd, f_csa, tf)
    rho_s = rx.rho_from_j(J)
    if not ensemble:
        return RatesWithErrors(r1_s, r2_s, rx.noe_from_j(J, f_dd, tf, gr, r1_s), rho_s)
    if weights is not None:
        weights = torch.as_tensor(weights, dtype=J.dtype, device=J.device)
    R1, dR1 = weighted_mean_std(r1_s, weights, axis=-1)
    R2, dR2 = weighted_mean_std(r2_s, weights, axis=-1)
    rho, drho = weighted_mean_std(rho_s, weights, axis=-1)
    noe_s = rx.noe_from_j(J, f_dd, tf, gr, R1[:, None])
    NOE, dNOE = weighted_mean_std(noe_s, weights, axis=-1)
    return RatesWithErrors(R1, R2, NOE, rho, dR1, dR2, dNOE, drho)


def rates_from_a_moments_newapi(pair: NucleusPair, G, mu, cov, csa=None) -> RatesWithErrors:
    """New-API ensemble rates without the sample axis.

    R1, R2 and the NOE's cross-relaxation numerator are linear in J, and
    the axisymmetric J is linear in the per-sample A coefficients
    (spectral_densities.py:2057-2077; rates :824-907), so the weighted
    ensemble mean and sd collapse onto the A moments:

        mean(R) = mu . r,   sd(R)^2 = r^T cov r,   r_j = R(G_j)

    equal to :func:`rates_from_j_newapi` over the whole (nRes, nSamp, 5) J
    at O(nRes x 3) a call.

    G   : (nRes, 3, 5) from ``ops.jomega.symmtop_g_factors`` on the pair's
          omega5.
    mu  : (nRes, 3), cov : (nRes, 3, 3) of one branch of
          ``ops.jomega.a_moments_symmtop``, tensors on G's device.
    csa : None, scalar, or (nRes,).

    rho = J(wX)/J(0) is not linear in A: the rho returned is that of the
    ensemble-mean J, and drho is None.
    """
    f_dd = pair.factor_dd()
    csa_v = None if csa is None else torch.as_tensor(csa, dtype=G.dtype, device=G.device)
    if csa_v is not None and csa_v.ndim == 1:
        csa_v = csa_v[:, None]  # (nRes,) over the 3 decay modes
    f_csa = pair.factor_csa(csa_v)
    tf = pair.time_fact

    r1_j = rx.r1_from_j(G, f_dd, f_csa, tf)  # (nRes, 3)
    r2_j = rx.r2_from_j(G, f_dd, f_csa, tf)
    # the NOE's R1-independent numerator, shared with rx.noe_from_j
    sig_j = rx.cross_rate_from_j(G, f_dd, tf, pair.gamma_b / pair.gamma_a)

    def _stats(r):
        mean = torch.sum(mu * r, dim=-1)
        var = torch.einsum("rj,rjk,rk->r", r, cov, r)
        # _safe_sqrt: sqrt's gradient at 0 is inf, which a zero-variance
        # ensemble would turn into a NaN Jacobian.
        return mean, _safe_sqrt(var)

    R1, dR1 = _stats(r1_j)
    R2, dR2 = _stats(r2_j)
    y, dy = _stats(sig_j)
    NOE = 1.0 + y / R1
    dNOE = dy / torch.abs(R1)
    rho = rx.rho_from_j(torch.einsum("rj,rjw->rw", mu, G))
    return RatesWithErrors(R1, R2, NOE, rho, dR1, dR2, dNOE, None)


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
