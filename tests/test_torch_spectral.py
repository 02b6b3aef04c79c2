"""The port's J(omega) dispatcher, Lipari-Szabo and direct-DFT spectral
densities (ops.jomega), and the statistics and constants helpers that
came with them, against the JAX package on the CPU in float64, on the same
seeded numpy inputs (tests/test_spectral_dispatcher.py's cases, each held
to the JAX function at 1e-12)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spinrelax_tpu import constants as jconst
from spinrelax_tpu.core import stats as jstats
from spinrelax_tpu.ops import jomega as jw
from spinrelax_tpu_torch import constants as tconst
from spinrelax_tpu_torch.core import stats as tstats
from spinrelax_tpu_torch.ops import jomega as tw

OM = np.linspace(0, 0.3, 5)


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_state():
    """Clear jax's compiled-program caches before this module (see
    tests/test_review_fixes_r3.py); two torch threads per xdist worker."""
    jax.clear_caches()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(2)


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _close(t, j, rtol=1e-12):
    t = t.numpy() if torch.is_tensor(t) else np.asarray(t)
    np.testing.assert_allclose(t, np.asarray(j), rtol=rtol, atol=0)
    return t


def test_dispatcher_sphere():
    """test_spectral_dispatcher.py::test_dispatcher_sphere: both sphere
    models against JAX and the closed form."""
    tau = 2000.0
    for model, arg in (("rigid_sphere_T", tau), ("rigid_sphere_D", 1 / (6 * tau))):
        got = _close(tw.spectral_density(model, OM, arg), jw.spectral_density(model, OM, arg))
        np.testing.assert_allclose(got, tau / (1 + (OM * tau) ** 2), rtol=1e-12)


@pytest.mark.parametrize("D", [(3e-4, 1.5e-4), (1.5e-4, 3e-4)])
def test_dispatcher_symmtop_matches_kernel(rng, D):
    """test_dispatcher_symmtop_matches_kernel, prolate and oblate, with D as
    floats and as a tensor (prolate = D[0] > D[1] for both)."""
    v = _unit(rng, 4)
    want = jw.spectral_density("rigid_symmtop_D", OM, D, v)
    _close(tw.spectral_density("rigid_symmtop_D", OM, D, v), want)
    _close(tw.spectral_density("rigid_symmtop_D", OM, torch.tensor(D, dtype=torch.float64),
                               torch.from_numpy(v)), want)
    _close(tw.spectral_density("rigid_symmtop_D", OM, D, v),
           jw.j_rigid_symmtop(jnp.asarray(OM), jnp.asarray(v), *D))


def test_ls_classic_limits():
    """test_ls_classic_limits: S2 = 1 is pure global tumbling; and
    j_lipari_szabo on arrays against JAX."""
    tau_g = 2000.0
    got = _close(tw.spectral_density("LS_classic_D", OM, tau_g, [1.0], [50.0]),
                 jw.spectral_density("LS_classic_D", OM, tau_g, [1.0], [50.0]))
    np.testing.assert_allclose(got[0], tau_g / (1 + (OM * tau_g) ** 2), rtol=1e-10)
    S2, ti = np.array([0.3, 0.8, 0.95]), np.array([20.0, 150.0, 900.0])
    _close(tw.spectral_density("LS_classic_D", OM, tau_g, S2, ti),
           jw.spectral_density("LS_classic_D", OM, tau_g, S2, ti))
    _close(tw.j_lipari_szabo(torch.from_numpy(OM), tau_g, torch.from_numpy(S2)[:, None],
                             torch.from_numpy(ti)[:, None]),
           jw.j_lipari_szabo(OM, tau_g, S2[:, None], ti[:, None]))


def test_ls_symmtop_reduces_to_rigid(rng):
    """test_ls_symmtop_reduces_to_rigid: S2 = 1 removes the internal term;
    and S2 < 1, prolate and oblate, against JAX."""
    v = _unit(rng, 3)
    D = (3e-4, 1.5e-4)
    got = _close(tw.spectral_density("LS_symmtop_D", OM, D, v, np.ones(3), np.full(3, 50.0)),
                 jw.spectral_density("LS_symmtop_D", OM, D, v, np.ones(3), np.full(3, 50.0)))
    np.testing.assert_allclose(got, np.asarray(jw.j_rigid_symmtop(jnp.asarray(OM),
                                                                  jnp.asarray(v), *D)),
                               rtol=1e-10)
    S2, ti = np.array([0.7, 0.85, 0.9]), np.array([30.0, 80.0, 400.0])
    for Dx in (D, D[::-1]):
        _close(tw.spectral_density("LS_symmtop_D", OM, Dx, v, S2, ti),
               jw.spectral_density("LS_symmtop_D", OM, Dx, v, S2, ti))


def test_ls_ellipsoid_runs(rng):
    """test_ls_ellipsoid_runs: shape (3, 5), finite and positive, and equal
    to JAX's; and the rigid ellipsoid through the dispatcher.  At omega = 0
    the reference's D coefficient 6 Diso - 6 sqrt(Diso^2 - D2^2) cancels
    to ~1e-10 of Diso (D2 is second order in D, the quirk
    d_coefficients_ellipsoid keeps), so J there, ~1e9, carries the
    packages' rounding of Diso amplified ~1e4 and is held at 1e-8; the
    other frequencies at 1e-12."""
    v = _unit(rng, 3)
    D = np.sort(rng.uniform(1e-4, 4e-4, 3))
    args = (OM, D, v, np.full(3, 0.8), np.full(3, 40.0))
    for model, a in (("LS_ellipsoid_D", args), ("rigid_ellipsoid_D", args[:3])):
        got = tw.spectral_density(model, *a).numpy()
        want = np.asarray(jw.spectral_density(model, *a))
        np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-8, err_msg=model)
        np.testing.assert_allclose(got[:, 1:], want[:, 1:], rtol=1e-12, err_msg=model)
        assert got.shape == (3, 5) and np.isfinite(got).all() and (got > 0).all()
    with pytest.raises(ValueError, match="unknown model"):
        tw.spectral_density("LS_sphere", OM, 1.0)


@pytest.mark.parametrize("N", [16384, 16383])
def test_dft_path_matches_analytic(N):
    """test_dft_path_matches_analytic at even and odd N: against JAX at
    1e-12 of the largest value and the analytic Lorentzian at 2 %."""
    t = np.arange(0, N) * 1.0
    Ct = np.exp(-t / 50.0)
    om = np.array([0.0, 0.02, 0.05, 0.1])
    got = tw.j_from_ct_dft(t, Ct, om).numpy()
    want = np.asarray(jw.j_from_ct_dft(t, Ct, om))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())
    np.testing.assert_allclose(got, 50.0 / (1 + (om * 50.0) ** 2), rtol=0.02)


def test_dft_batched_and_beyond_nyquist_clamps(rng):
    """test_dft_beyond_nyquist_clamps (past the band the last bin is held),
    and a (3, T) batch at odd N with negative and in-between frequencies,
    against JAX at 1e-12 of the largest value."""
    t = np.arange(0, 4096) * 1.0
    Ct = np.exp(-t / 50.0)
    nyq = np.pi
    inside = tw.j_from_ct_dft(t, Ct, np.array([nyq])).numpy()
    beyond = tw.j_from_ct_dft(t, Ct, np.array([nyq * 3, nyq * 100])).numpy()
    np.testing.assert_allclose(beyond, inside[..., :1] * np.ones(2), rtol=1e-12)
    t = np.arange(0, 1001) * 2.0
    Ct = np.exp(-t[None] / rng.uniform(20, 200, (3, 1))) + 1e-3 * rng.normal(size=(3, t.size))
    om = np.array([-0.01, 0.0, 0.0031, 0.7, 1.5708, 1.6, 9.0])
    got = tw.j_from_ct_dft(torch.from_numpy(t), torch.from_numpy(Ct), om).numpy()
    want = np.asarray(jw.j_from_ct_dft(t, Ct, om))
    assert got.shape == (3, om.size)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())


def test_lipari_szabo_aniso_matches_jax(rng):
    """j_lipari_szabo_aniso on a batch of ellipsoid A coefficients."""
    D_J, delta = jw.d_coefficients_ellipsoid(jnp.asarray([1e-4, 2e-4, 3.5e-4]))
    A = np.asarray(jw.a_coefficients_ellipsoid(jnp.asarray(_unit(rng, 6)), delta))
    S2, ti = rng.uniform(0.5, 0.95, 6), rng.uniform(10, 500, 6)
    _close(tw.j_lipari_szabo_aniso(OM, S2, ti, A, np.asarray(D_J)),
           jw.j_lipari_szabo_aniso(OM, S2, ti, A, D_J))


def test_stats_helpers_match_jax(rng):
    """anova_total_mean_square and central_moments (both ``symmetric``
    values) against JAX at 1e-12."""
    Ns = np.array([10.0, 25.0, 7.0, 40.0])
    means, sigmas = rng.normal(size=(4, 3)), rng.uniform(0.1, 1.0, (4, 3))
    for i in range(3):
        _close(tstats.anova_total_mean_square(torch.from_numpy(Ns), torch.from_numpy(means[:, i]),
                                              torch.from_numpy(sigmas[:, i])),
               jstats.anova_total_mean_square(jnp.asarray(Ns), jnp.asarray(means[:, i]),
                                              jnp.asarray(sigmas[:, i])))
    x = np.linspace(-3, 4, 101)
    y = np.exp(-(x - 0.5) ** 2) * rng.uniform(0.5, 1.5, x.size)
    for sym in (False, True):
        _close(tstats.central_moments(torch.from_numpy(x), torch.from_numpy(y), symmetric=sym),
               jstats.central_moments(x, y, symmetric=sym))


def test_omega_names():
    for a, b in (("15N", "1H"), ("13C", "1H")):
        assert tconst.omega_names(a, b) == jconst.omega_names(a, b)
