"""Spectral densities J(omega) (port of ``spinrelax_tpu/ops/jomega.py``).

omega is (nOm,); every return has a trailing nOm axis.  vecs (..., 3) are
unit vectors in the diffusion frame; S2 (...,), C/tau/comp_mask (..., K).
Scalars (dpar, dperp, Diso, ...) may be Python floats or tensors; they
follow the dtype and device of the tensor they meet.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _like(x, ref):
    """``x`` as a tensor of ``ref``'s dtype on ``ref``'s device."""
    return torch.as_tensor(x, dtype=ref.dtype, device=ref.device)


def _t(x):
    """A tensor as it is; a Python or numpy number or array as float64."""
    return x if torch.is_tensor(x) else torch.as_tensor(x, dtype=torch.float64)


# ---------------------------------------------------------------------------
# D / A coefficients (spectral_densities.py:1874-1959)
# ---------------------------------------------------------------------------

def d_coefficients_symmtop(dpar, dperp):
    """3 axisymmetric D-coefficients (spectral_densities.py:1874-1884)."""
    dpar = _t(dpar)
    dperp = _like(dperp, dpar)
    return torch.stack(
        [5.0 * dperp + dpar, 2.0 * dperp + 4.0 * dpar, 6.0 * dperp], dim=-1)


def a_coefficients_symmtop(v, prolate=True):
    """3 axisymmetric A-coefficients from unit vectors (..., 3)
    (spectral_densities.py:1886-1906).  ``prolate`` selects the unique
    axis: z when Daniso > 1, x when Daniso < 1 (Dx <= Dy <= Dz)."""
    v = _t(v)
    prolate = torch.as_tensor(prolate, device=v.device)
    z2 = torch.where(prolate, v[..., 2], v[..., 0]) ** 2
    onemz2 = 1.0 - z2
    A0 = 3.0 * z2 * onemz2
    A1 = 0.75 * onemz2**2
    A2 = 0.25 * (3.0 * z2 - 1.0) ** 2
    return torch.stack([A0, A1, A2], dim=-1)


def d_coefficients_ellipsoid(D):
    """5 fully-anisotropic D-coefficients and the delta of the
    A-coefficients (spectral_densities.py:1914-1932); D = (Dx, Dy, Dz),
    Dx <= Dy <= Dz.  The reference's fact1 = sqrt(Diso^2 - D2^2) mixes
    orders of D (:1921-1922) and is kept; its argument clamps at 0 where
    the reference gives NaN, so pass D in ps^-1."""
    D = _t(D)
    Diso = torch.mean(D, dim=-1)
    D2 = (D[..., 0] * D[..., 1] + D[..., 0] * D[..., 2] + D[..., 1] * D[..., 2]) / 3.0
    fact1 = torch.sqrt(torch.clamp(Diso**2 - D2**2, min=0.0))
    D_J = torch.stack(
        [
            4 * D[..., 0] + D[..., 1] + D[..., 2],
            D[..., 0] + 4 * D[..., 1] + D[..., 2],
            D[..., 0] + D[..., 1] + 4 * D[..., 2],
            6 * Diso + 6 * fact1,
            6 * Diso - 6 * fact1,
        ],
        dim=-1,
    )
    safe = torch.where(fact1 > 0, fact1, torch.ones_like(fact1))
    delta = (D - Diso[..., None]) / safe[..., None]
    return D_J, delta


def a_coefficients_ellipsoid(v, delta):
    """5 fully-anisotropic A-coefficients (spectral_densities.py:1934-1959);
    v (..., 3), delta (..., 3) from :func:`d_coefficients_ellipsoid`."""
    v = _t(v)
    delta = _like(delta, v)
    v2 = v**2
    v4 = v2**2
    fact2 = 0.25 * (3.0 * torch.sum(v4, dim=-1) - 1.0)
    fact3 = (1.0 / 12.0) * (
        delta[..., 0] * (3 * v4[..., 0] + 6 * v2[..., 1] * v2[..., 2] - 1)
        + delta[..., 1] * (3 * v4[..., 1] + 6 * v2[..., 0] * v2[..., 2] - 1)
        + delta[..., 2] * (3 * v4[..., 2] + 6 * v2[..., 0] * v2[..., 1] - 1)
    )
    return torch.stack(
        [
            3 * v2[..., 1] * v2[..., 2],
            3 * v2[..., 0] * v2[..., 2],
            3 * v2[..., 0] * v2[..., 1],
            fact2 - fact3,
            fact2 + fact3,
        ],
        dim=-1,
    )


def jsum(omega, A_J, D_J):
    """J_k = sum_j A_j D_j / (D_j^2 + om_k^2).

    omega (nOm,), A_J (..., J), D_J broadcastable to A_J -> (..., nOm).
    """
    omega = _like(omega, A_J)
    D_J = torch.broadcast_to(_like(D_J, A_J), A_J.shape)
    lor = D_J[..., None] / (D_J[..., None] ** 2 + omega**2)  # (..., J, nOm)
    return torch.sum(A_J[..., None] * lor, dim=-2)


# ---------------------------------------------------------------------------
# Rigid-body J (spectral_densities.py:1977-2000)
# ---------------------------------------------------------------------------

def j_rigid_sphere_D(omega, Diso):
    Diso = _t(Diso)
    omega = _like(omega, Diso)
    return 6.0 * Diso / ((6.0 * Diso) ** 2 + omega**2)


def j_rigid_sphere_tau(omega, tau_c):
    tau_c = _t(tau_c)
    omega = _like(omega, tau_c)
    return tau_c / (1.0 + (omega * tau_c) ** 2)


def j_rigid_symmtop(omega, v, dpar, dperp):
    v = _t(v)
    dpar, dperp = _like(dpar, v), _like(dperp, v)
    D_J = d_coefficients_symmtop(dpar, dperp)
    A_J = a_coefficients_symmtop(v, prolate=dpar > dperp)
    return jsum(omega, A_J, D_J)


def j_rigid_ellipsoid(omega, v, D):
    v = _t(v)
    D_J, delta = d_coefficients_ellipsoid(_like(D, v))
    A_J = a_coefficients_ellipsoid(v, delta)
    return jsum(omega, A_J, D_J)


def j_lipari_szabo(omega, tau_glob, S2, tau_int):
    """Classic isotropic Lipari-Szabo (spectral_densities.py:2004-2007):
    S2 tau_g / (1 + (w tau_g)^2) + (1 - S2) tau_e / (1 + (w tau_e)^2),
    1/tau_e = 1/tau_g + 1/tau_int."""
    ref = next((x for x in (S2, tau_int, tau_glob) if torch.is_tensor(x)), None)
    S2 = _t(S2) if ref is None else _like(S2, ref)
    tau_int, tau_glob, omega = (_like(x, S2) for x in (tau_int, tau_glob, omega))
    tau_eff = tau_int * tau_glob / (tau_int + tau_glob)
    return S2 * tau_glob / (1 + (omega * tau_glob) ** 2) + (1 - S2) * tau_eff / (
        1 + (omega * tau_eff) ** 2
    )


def j_direct_transform(omega, C, tau, comp_mask=None):
    """J = sum_i C_i tau_i / (1 + (tau_i w)^2): no global tumbling
    (spectral_densities.py:2024-2033).  C, tau (..., K)."""
    C = _t(C)
    tau = _like(tau, C)
    omega = _like(omega, C)
    term = C[..., None] * tau[..., None] / (1.0 + (tau[..., None] * omega) ** 2)
    if comp_mask is not None:
        term = term * comp_mask[..., None]
    return torch.sum(term, dim=-2)


# ---------------------------------------------------------------------------
# Global tumbling combined with a local multi-exponential C(t)
# (spectral_densities.py:2038-2105)
# ---------------------------------------------------------------------------

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


def j_combine_symmtop(omega, v, dpar, dperp, S2, C, tau, comp_mask=None, zeta=1.0):
    """Axisymmetric tumbling combined with a local multi-exponential C(t)
    (spectral_densities.py:2057-2077); v in the diffusion frame.
    v (..., 3), S2 (...,), C/tau (..., K) -> (..., nOm)."""
    v = _t(v)
    dpar, dperp = _like(dpar, v), _like(dperp, v)
    D_J = d_coefficients_symmtop(dpar, dperp)  # (3,)
    A_J = a_coefficients_symmtop(v, prolate=dpar > dperp)  # (..., 3)
    safe_tau = torch.where(tau > 0, tau, torch.ones_like(tau))
    J = jsum(omega, S2[..., None] * A_J, D_J)
    Dk = D_J + 1.0 / safe_tau[..., None]  # (..., K, 3)
    Ak = C[..., None] * A_J[..., None, :]  # (..., K, 3)
    term = jsum(omega, Ak, Dk)  # (..., K, nOm)
    if comp_mask is not None:
        term = term * comp_mask[..., None]
    return zeta * (J + torch.sum(term, dim=-2))


def symmtop_g_factors(omega, dpar, dperp, S2, C, tau, comp_mask=None, zeta=1.0):
    """Per-decay-mode Lorentzian factors G_j(w) of the axisymmetric
    combined J, which is linear in the A coefficients:

        j_combine_symmtop(v, ...) == sum_j A_j(v) G_j(w)

    so the ensemble mean and sd of any rate linear in J follow from the
    first and second A moments (:func:`a_moments_symmtop`,
    ``ops.observables.rates_from_a_moments_newapi``).  ``dpar`` / ``dperp``
    are tensors on the device of ``S2`` (or Python floats).

    Shapes: S2 (...,), C/tau/comp_mask (..., K); returns (..., 3, nOm).
    """
    dpar = _like(dpar, S2)
    D_J = d_coefficients_symmtop(dpar, _like(dperp, S2))  # (3,)
    omega = _like(omega, S2)
    safe_tau = torch.where(tau > 0, tau, torch.ones_like(tau))
    lor0 = D_J[..., None] / (D_J[..., None] ** 2 + omega**2)  # (3, nOm)
    G = S2[..., None, None] * lor0
    Dk = D_J + 1.0 / safe_tau[..., None]  # (..., K, 3)
    lork = Dk[..., None] / (Dk[..., None] ** 2 + omega**2)  # (..., K, 3, nOm)
    Ck = C if comp_mask is None else C * comp_mask
    G = G + torch.sum(Ck[..., None, None] * lork, dim=-3)
    return zeta * G


def a_moments_symmtop(vecs, weights=None):
    """Weighted first moment and second *central* moment of the three
    axisymmetric A coefficients over the sample axis, for both the prolate
    and the oblate branch (the branch follows Daniso, which the optimiser
    moves, so both are kept and one is picked on the device).

    Normalised as :func:`core.stats.weighted_mean_std` (sum of weights,
    guarded > 0), so rates rebuilt from these moments equal the per-sample
    ensemble statistics to rounding.

    vecs : (nRes, nSamp, 3) unit vectors; weights: (nRes, nSamp) or None.
    Returns numpy float64 (mu_p, cov_p, mu_o, cov_o): mu (nRes, 3), cov
    (nRes, 3, 3).  Host numpy, called once per geometry.
    """
    vecs = np.asarray(vecs, dtype=np.float64)
    out = []
    for prolate in (True, False):
        z2 = vecs[..., 2 if prolate else 0] ** 2
        onemz2 = 1.0 - z2
        A = np.stack(
            [3.0 * z2 * onemz2, 0.75 * onemz2**2, 0.25 * (3.0 * z2 - 1.0) ** 2],
            axis=-1,
        )  # (nRes, nSamp, 3)
        if weights is None:
            mu = A.mean(axis=1)
            d = A - mu[:, None, :]
            cov = np.einsum("rsj,rsk->rjk", d, d) / A.shape[1]
        else:
            w = np.asarray(weights, dtype=np.float64)
            wsum = w.sum(axis=1)
            safe = np.where(wsum > 0, wsum, 1.0)
            mu = np.einsum("rs,rsj->rj", w, A) / safe[:, None]
            d = A - mu[:, None, :]
            cov = np.einsum("rs,rsj,rsk->rjk", w, d, d) / safe[:, None, None]
        out.extend([mu, cov])
    return tuple(out)


def j_combine_ellipsoid(omega, v, D, S2, C, tau, comp_mask=None, zeta=1.0):
    """Fully anisotropic tumbling combined with a local C(t)
    (spectral_densities.py:2094-2105).  D = (Dx, Dy, Dz), Dx <= Dy <= Dz."""
    v = _t(v)
    D_J, delta = d_coefficients_ellipsoid(_like(D, v))  # (5,), (3,)
    A_J = a_coefficients_ellipsoid(v, delta)  # (..., 5)
    safe_tau = torch.where(tau > 0, tau, torch.ones_like(tau))
    J = jsum(omega, S2[..., None] * A_J, D_J)
    Dk = D_J + 1.0 / safe_tau[..., None]  # (..., K, 5)
    Ak = C[..., None] * A_J[..., None, :]  # (..., K, 5)
    term = jsum(omega, Ak, Dk)
    if comp_mask is not None:
        term = term * comp_mask[..., None]
    return zeta * (J + torch.sum(term, dim=-2))


def symmtop_from_diso_aniso(diso, aniso):
    """(Diso, Daniso) -> (Dpar, Dperp) (spectral_densities.py:535-540)."""
    dperp = 3.0 * diso / (2.0 + aniso)
    return aniso * dperp, dperp


def j_lipari_szabo_aniso(omega, S2, tau_int, A_J, D_J):
    """Lipari-Szabo applied to each anisotropic decay component
    (d'Auvergne 2006 eq. 8.66; what the reference's
    _J_combine_LS_anisotropic, spectral_densities.py:2012-2022, intends --
    its loop body indexes J[i] with an undefined i).  A_J (..., J), D_J
    broadcastable to it; S2, tau_int broadcastable to A_J's batch shape ->
    (..., nOm)."""
    A_J = _t(A_J)
    D_J = torch.broadcast_to(_like(D_J, A_J), A_J.shape)
    omega, S2, tau = (_like(x, A_J) for x in (omega, S2, tau_int))
    D_eff = D_J + 1.0 / tau[..., None]
    term = (
        S2[..., None, None] * A_J[..., None] * D_J[..., None]
        / (D_J[..., None] ** 2 + omega**2)
        + (1.0 - S2)[..., None, None] * A_J[..., None] * D_eff[..., None]
        / (D_eff[..., None] ** 2 + omega**2)
    )
    return torch.sum(term, dim=-2)


def j_from_ct_dft(t, Ct, omega):
    """The reference's dormant direct-DFT path (do_dft + interpolate_point,
    spectral_densities.py:2252-2331): J(w) = Re{rfft(C(t))} as a
    trapezoid-rule one-sided transform (the t = 0 sample counted half),
    linearly interpolated between the bins 2 pi k / (N dt) (true for odd N
    too) at |omega|, holding the last bin past Nyquist rather than
    extrapolating.  t (T,) uniform, Ct (..., T), omega (nOm,) -> (..., nOm)
    on Ct's device and dtype (cuFFT on the card: no TF32 setting applies)."""
    Ct = _t(Ct)
    t = _like(t, Ct)
    omega = torch.abs(_like(omega, Ct)).contiguous()
    dt = t[1] - t[0]
    N = t.shape[-1]
    G = torch.fft.rfft(Ct, dim=-1).real * dt - 0.5 * dt * Ct[..., 0:1]
    om_grid = 2.0 * math.pi * torch.arange(N // 2 + 1, dtype=Ct.dtype, device=Ct.device) \
        / (N * dt)
    idx = torch.clamp(torch.searchsorted(om_grid, omega), 1, om_grid.shape[0] - 1)
    x0 = om_grid[idx - 1]
    x1 = om_grid[idx]
    w1 = torch.clamp((omega - x0) / (x1 - x0), 0.0, 1.0)
    return (1 - w1) * G[..., idx - 1] + w1 * G[..., idx]


def spectral_density(model: str, omega, *args):
    """J(w) by model name, as calculate_spectral_density
    (spectral_densities.py:2107-2174), batched over vectors and sites:
    rigid_sphere_T(tau), rigid_sphere_D(D), rigid_symmtop_D(D, v),
    rigid_ellipsoid_D(D, v), LS_classic_D(tau_glob, S2, tau_int),
    LS_symmtop_D(D, v, S2, tau_int), LS_ellipsoid_D(D, v, S2, tau_int).
    D is a pair (Dpar, Dperp) or triple (Dx, Dy, Dz) of floats or a tensor;
    an unknown model raises ValueError."""
    if model == "rigid_sphere_T":
        return j_rigid_sphere_tau(omega, args[0])
    if model == "rigid_sphere_D":
        return j_rigid_sphere_D(omega, args[0])
    if model == "rigid_symmtop_D":
        D, v = args
        return j_rigid_symmtop(omega, _t(v), D[0], D[1])
    if model == "rigid_ellipsoid_D":
        D, v = args
        return j_rigid_ellipsoid(omega, _t(v), D)
    if model == "LS_classic_D":
        tau_glob, S2, tau_int = args
        return j_lipari_szabo(omega, tau_glob, _t(S2)[..., None], _t(tau_int)[..., None])
    if model == "LS_symmtop_D":
        D, v, S2, tau_int = args
        v = _t(v)
        D_J = d_coefficients_symmtop(_like(D[0], v), _like(D[1], v))
        A_J = a_coefficients_symmtop(v, prolate=D[0] > D[1])
        return j_lipari_szabo_aniso(omega, S2, tau_int, A_J, D_J)
    if model == "LS_ellipsoid_D":
        D, v, S2, tau_int = args
        v = _t(v)
        D_J, delta = d_coefficients_ellipsoid(_like(D, v))
        A_J = a_coefficients_ellipsoid(v, delta)
        return j_lipari_szabo_aniso(omega, S2, tau_int, A_J, D_J)
    raise ValueError(f"unknown model given to spectral_density: {model!r}")
