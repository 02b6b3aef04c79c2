"""The port's forward step and its physics (spinrelax_tpu_torch.ops.jomega,
ops.relaxation, parallel.pipeline, convert, entry) against the JAX
package and the reference goldens, on the CPU."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spinrelax_tpu.constants import NucleusPair
from spinrelax_tpu.ops import jomega as jjw
from spinrelax_tpu.parallel.pipeline import make_forward as jax_make_forward
from spinrelax_tpu_torch import convert, entry
from spinrelax_tpu_torch.ops import cuda_acf, cuda_lm
from spinrelax_tpu_torch.ops import jomega as tjw
from spinrelax_tpu_torch.ops import relaxation as trx
from spinrelax_tpu_torch.parallel.pipeline import PipelineOutput, make_forward

GOLD = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_state():
    """Clear jax's compiled-program caches before this module (see
    tests/test_review_fixes_r3.py); two torch threads per xdist worker."""
    jax.clear_caches()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(2)


@pytest.fixture(scope="module")
def gold():
    return np.load(os.path.join(GOLD, "jomega_relax.npz"))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_j_combine_isotropic_golden(gold):
    """Reference-generated J_iso, rtol 1e-10 (the JAX suite's bound)."""
    got = tjw.j_combine_isotropic(_t(gold["omega"]), float(gold["tau_iso"]),
                                  _t(gold["S2"]), _t(gold["consts"]), _t(gold["taus"]))
    np.testing.assert_allclose(got.numpy(), gold["J_iso"], rtol=1e-10)


def test_j_combine_isotropic_mask_and_zeta_match_jax(rng):
    """comp_mask, zeta and a zero tau (masked to 1) against JAX, f64."""
    omega = np.array(NucleusPair(time_unit="ps").omega5())
    S2 = rng.uniform(0.5, 0.9, 6)
    C = rng.uniform(0.01, 0.2, (6, 3))
    tau = rng.uniform(1, 500, (6, 3))
    tau[0, 2] = 0.0
    mask = (rng.uniform(size=(6, 3)) > 0.3).astype(float)
    ref = jjw.j_combine_isotropic(omega, 3000.0, S2, C, tau, comp_mask=mask, zeta=0.89)
    got = tjw.j_combine_isotropic(_t(omega), 3000.0, _t(S2), _t(C), _t(tau),
                                  comp_mask=_t(mask), zeta=0.89)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-13)


def test_jsum_matches_jax(rng):
    omega = np.array(NucleusPair(time_unit="ps").omega5())
    A = rng.uniform(0, 1, (4, 7, 3))
    D = rng.uniform(1e-4, 1e-2, 3)
    np.testing.assert_allclose(tjw.jsum(_t(omega), _t(A), _t(D)).numpy(),
                               np.asarray(jjw.jsum(omega, A, D)), rtol=1e-13)


def test_relaxation_from_j_golden(gold):
    """Reference R1/R2/NOE/rho from the reference J_symm, rtol 1e-9."""
    pair = NucleusPair(B0=float(gold["B0"]), time_unit="ps")
    rates = trx.relaxation_from_j(_t(gold["J_symm"]), pair)
    for name in ("R1", "R2", "NOE", "rho"):
        np.testing.assert_allclose(getattr(rates, name).numpy(), gold[name], rtol=1e-9)
    csa = trx.relaxation_from_j(_t(gold["J_symm"]), pair, csa=_t(gold["csa_arr"][:, None]))
    np.testing.assert_allclose(csa.R1.numpy(), gold["R1csa"], rtol=1e-9)


def test_constants_match_jax_package():
    """The port's copy of the constants it uses equals the JAX package's."""
    from spinrelax_tpu import constants as jc
    from spinrelax_tpu_torch import constants as tc

    for name in ("GYROMAGNETIC_RATIOS", "DEFAULT_CSA", "MU0_HBAR_OVER_4PI_SQ",
                 "DEFAULT_R_XH_NM", "TIME_FACTORS", "DIST_FACTORS"):
        assert getattr(tc, name) == getattr(jc, name), name
    for kw in ({}, dict(isotope_a="13C", B0=jc.field_from_mhz(800.0), time_unit="ns",
                        csa=-150e-6)):
        a, b = jc.NucleusPair(**kw), tc.NucleusPair(**kw)
        assert a.omega5() == b.omega5()
        assert (a.factor_dd(), a.factor_csa(), a.time_fact, a.gamma_a, a.gamma_b) == (
            b.factor_dd(), b.factor_csa(), b.time_fact, b.gamma_a, b.gamma_b)
    assert tc.field_from_mhz(600.0) == jc.field_from_mhz(600.0)


def test_forward_kwargs_from_jax():
    """A JAX NucleusPair carries straight into the port's forward."""
    pair = NucleusPair(time_unit="ps")
    kw = convert.forward_kwargs_from_jax(pair, tau_iso=3000.0, delta_t=2.0,
                                         n_components=3, zeta=0.9)
    assert kw["omega"].tolist() == list(pair.omega5())
    assert kw["f_dd"] == pair.factor_dd() and kw["f_csa"] == pair.factor_csa()
    assert kw["gamma_ratio"] == pair.gamma_b / pair.gamma_a
    assert (kw["tau_iso"], kw["delta_t"], kw["n_components"], kw["zeta"]) == (3000.0, 2.0, 3, 0.9)


def test_palmer_state_shape_check():
    with pytest.raises(ValueError):
        convert.palmer_state_from_numpy(np.zeros((4, 3)), np.zeros((4, 2)), 5,
                                        device="cpu")


def test_entry_points_default_to_the_card():
    """entry() and palmer_state_from_numpy() place their tensors on the
    card unless told device="cpu"; with no card they raise instead of
    running quietly on the CPU."""
    acc = np.zeros((4, 3))
    if torch.cuda.is_available():
        assert entry.entry()[1][0].is_cuda
        assert convert.palmer_state_from_numpy(acc, acc, 1)[0].is_cuda
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.palmer_state_from_numpy(acc, acc, 1)
    assert entry.entry(device="cpu")[1][0].device.type == "cpu"


def test_correlated_walk_is_graft_entry_input():
    """The shared generator reproduces __graft_entry__.entry()'s input
    bit for bit (seed 0, (4, 64, 16))."""
    import __graft_entry__

    _, (v,) = __graft_entry__.entry()
    np.testing.assert_array_equal(entry.correlated_walk(4, 64, 16), np.asarray(v))
    fwd, (vt,) = entry.entry("cpu")
    assert vt.dtype == torch.float32 and tuple(vt.shape) == (4, 64, 16, 3)


@pytest.mark.parametrize("shape", [(4, 64, 16), (8, 200, 32)])
def test_forward_matches_jax_f64(shape):
    """The whole forward against JAX make_forward on the same f64 input.
    Ct/dCt to 1e-12 (FFT rounding).  The fit's per-component split can
    differ on near-degenerate lanes (two taus within 0.1 %, both fits
    equally good), so the fit is held through what it predicts: S2 to
    1e-8, sum C to 1e-6, and R1/R2/NOE/rho to 1e-6 relative."""
    v = entry.correlated_walk(*shape).astype(np.float64)
    ref = jax_make_forward()(jnp.asarray(v))
    got = make_forward()(torch.from_numpy(v))
    assert isinstance(got, PipelineOutput)
    for name in ("Ct", "dCt"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.S2.numpy(), np.asarray(ref.S2), rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.C.sum(1).numpy(), np.asarray(ref.C).sum(1), atol=1e-6)
    for name in ("R1", "R2", "NOE", "rho"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), rtol=1e-6)


def test_forward_f32_cpu_close_to_f64():
    """The f32 CPU forward (plain kernels in f32) stays near the f64 one:
    Ct to 2e-6 and the rates to 1e-3 relative in median."""
    v = entry.correlated_walk(8, 200, 32)
    launches = (cuda_acf.acf_lag_sums.launches, cuda_lm.hgc_cuda.launches,
                cuda_lm.cost_cuda.launches)
    a = make_forward()(torch.from_numpy(v))
    b = make_forward()(torch.from_numpy(v.astype(np.float64)))
    assert (cuda_acf.acf_lag_sums.launches, cuda_lm.hgc_cuda.launches,
            cuda_lm.cost_cuda.launches) == launches  # CPU: plain versions only
    assert a.R1.dtype == torch.float32
    np.testing.assert_allclose(a.Ct.numpy(), b.Ct.numpy(), atol=2e-6)
    for name in ("R1", "R2", "NOE", "rho"):
        x, y = getattr(a, name).double().numpy(), getattr(b, name).numpy()
        assert np.all(np.isfinite(x))
        assert np.median(np.abs(x - y) / np.abs(y)) < 1e-3
