"""Spin-relaxation physics in plain torch: the N-H pair's constants,
J(omega) of axisymmetric tumbling combined with a multi-exponential
internal C(t), and R1 / R2 / NOE / rho with their ensemble averages
(the published SpinRelax formulas: spectral_densities.py:23-249, 824-907,
1710-1737, 1874-1906, 2057-2077)."""

from __future__ import annotations

import math

import torch

GAMMA = {"1H": 267.513e6, "15N": -27.116e6}  # rad s^-1 T^-1
MU0_HBAR_OVER_4PI_SQ = 1.1121216813552401e-82
R_NH_M = 1.02e-10
CSA_N = -170e-6
ZETA = (1.02 / 1.04) ** 6
TIME_FACT = 1e-12  # ps


def field_from_mhz(mhz: float) -> float:
    return 2.0 * math.pi * mhz / 267.513


class Pair:
    """The 15N-1H pair at a 1H frequency, times in ps."""

    def __init__(self, mhz: float):
        self.B0 = field_from_mhz(mhz)
        ga, gb = GAMMA["15N"], GAMMA["1H"]
        wA = -ga * self.B0 * TIME_FACT
        wB = -gb * self.B0 * TIME_FACT
        self.omega = (0.0, wA, wB - wA, wB, wB + wA)
        self.f_dd = 0.10 * MU0_HBAR_OVER_4PI_SQ * ga ** 2 * gb ** 2 * R_NH_M ** -6.0
        self.gamma_ratio = gb / ga
        self.ga_b0_sq = (ga * self.B0) ** 2

    def f_csa(self, csa):
        return (2.0 / 15.0) * csa ** 2 * self.ga_b0_sq


def dpar_dperp(diso, aniso):
    dperp = 3.0 * diso / (2.0 + aniso)
    return aniso * dperp, dperp


def j_symmtop(omega, v, diso, aniso, S2, C, tau, mask, zeta):
    """J (nRes, nSamp, nOm) of axisymmetric tumbling (Diso, Daniso) with
    the local model S2 + sum_k C_k exp(-t / tau_k).  v (nRes, nSamp, 3)
    diffusion-frame unit vectors; S2 (nRes,); C, tau, mask (nRes, K)."""
    dt = v.dtype
    omega = torch.as_tensor(omega, dtype=dt, device=v.device)
    dpar, dperp = dpar_dperp(torch.as_tensor(diso, dtype=dt), torch.as_tensor(aniso, dtype=dt))
    DJ = torch.stack([5.0 * dperp + dpar, 2.0 * dperp + 4.0 * dpar, 6.0 * dperp]).to(v.device)
    z2 = (v[..., 2] if bool(dpar > dperp) else v[..., 0]) ** 2
    A = torch.stack([3.0 * z2 * (1 - z2), 0.75 * (1 - z2) ** 2, 0.25 * (3 * z2 - 1) ** 2], -1)

    def lor(d):  # d (..., 3) -> (..., 3, nOm)
        return d[..., None] / (d[..., None] ** 2 + omega ** 2)

    J = S2[:, None, None] * torch.einsum("rsj,jw->rsw", A, lor(DJ))
    safe = torch.where(tau > 0, tau, torch.ones_like(tau))
    Dk = DJ[None, None, :] + 1.0 / safe[..., None]  # (nRes, K, 3)
    term = torch.einsum("rk,rsj,rkjw->rsw", C * mask, A, lor(Dk))
    return zeta * (J + term)


def rates_from_j(pair: Pair, J, csa):
    """Per-sample (R1, R2, sigma, rho) from J (..., 5); csa broadcasts."""
    tf, f_dd, f_csa = TIME_FACT, pair.f_dd, pair.f_csa(csa)
    R1 = tf * (f_dd * (J[..., 2] + 3 * J[..., 1] + 6 * J[..., 4]) + f_csa * J[..., 1])
    R2 = tf * (0.5 * f_dd * (4 * J[..., 0] + J[..., 2] + 3 * J[..., 1] + 6 * J[..., 4]
                             + 6 * J[..., 3])
               + (1.0 / 6.0) * f_csa * (4 * J[..., 0] + 3 * J[..., 1]))
    sigma = tf * pair.gamma_ratio * f_dd * (6 * J[..., 4] - J[..., 2])
    return R1, R2, sigma, J[..., 1] / J[..., 0]


def wstats(x, w):
    """Weighted mean and population standard deviation over the last axis."""
    ws = w.sum(-1)
    ws = torch.where(ws > 0, ws, torch.ones_like(ws))
    m = (x * w).sum(-1) / ws
    return m, torch.sqrt(((x - m[..., None]) ** 2 * w).sum(-1) / ws)


def ensemble_rates(pair: Pair, J, w, csa, new_api: bool):
    """{name: (mean, sd)} of R1, R2, NOE, rho over the sample axis.  The
    legacy average takes each sample's NOE (stage_relax); the new API
    puts the ensemble-mean R1 into the NOE (the multi-field fit)."""
    csa = torch.as_tensor(csa, dtype=J.dtype, device=J.device)
    if csa.ndim == 1:
        csa = csa[:, None]
    R1, R2, sig, rho = rates_from_j(pair, J, csa)
    out = {"R1": wstats(R1, w), "R2": wstats(R2, w), "rho": wstats(rho, w)}
    out["NOE"] = wstats(1.0 + sig / (out["R1"][0][:, None] if new_api else R1), w)
    return out


def lambert_centres(edges_phi, edges_cos, dtype, device):
    """(nBins, 3) unit vectors at the Lambert bins' centres, phi-major."""
    ep = torch.as_tensor(edges_phi, dtype=dtype, device=device)
    ec = torch.as_tensor(edges_cos, dtype=dtype, device=device)
    phi = 0.5 * (ep[:-1] + ep[1:])
    th = torch.arccos(torch.clamp(0.5 * (ec[:-1] + ec[1:]), -1.0, 1.0))
    pp, tt = torch.meshgrid(phi, th, indexing="ij")
    return torch.stack([torch.cos(pp) * torch.sin(tt), torch.sin(pp) * torch.sin(tt),
                        torch.cos(tt)], -1).reshape(-1, 3)
