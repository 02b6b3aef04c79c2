"""The port's legacy explicit fit surface (fit/legacy_expfit.py) against the
JAX package's on the CPU in float64: tests/test_legacy_expfit.py's cases,
with the JAX package in the place of the reference in its six live-
reference cases.  The evaluators are held at 1e-12, the fits at 1e-8, the
9999.99 sentinel and the empty-sigma chi exactly."""

import os

import jax
import numpy as np
import pytest
import torch

from spinrelax_tpu.fit import legacy_expfit as jx
from spinrelax_tpu_torch.fit import legacy_expfit as tx


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_state():
    """Clear jax's compiled-program caches before this module (see
    tests/test_review_fixes_r3.py); two torch threads per xdist worker."""
    jax.clear_caches()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(2)


def _fits_agree(t, j, rtol=1e-8):
    """(chi, params, perr, ymodel) of both packages: params, perr and
    ymodel within rtol, chi within rtol (equal when a sentinel)."""
    for a, b, name in zip(t, j, ("chi", "params", "perr", "ymodel")):
        if name == "chi" and np.any(np.asarray(b) == 9999.99):
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=rtol, atol=1e-14, err_msg=name)


def test_func_exp_decay_numeric_parity():
    """test_legacy_expfit.py:27 with the JAX package as the reference: every
    func_exp_decayN evaluates the same (1e-12), and returns numpy."""
    t = np.linspace(0.0, 50.0, 101)
    cases = {
        1: (7.0,),
        2: (0.4, 7.0),
        3: (0.5, 0.3, 7.0),
        4: (0.3, 2.0, 0.2, 20.0),
        5: (0.5, 0.3, 2.0, 0.1, 20.0),
        6: (0.2, 1.0, 0.2, 5.0, 0.2, 25.0),
        7: (0.4, 0.2, 1.0, 0.2, 5.0, 0.1, 25.0),
        8: (0.1, 0.5, 0.2, 2.0, 0.2, 8.0, 0.2, 32.0),
        9: (0.3, 0.1, 0.5, 0.2, 2.0, 0.2, 8.0, 0.1, 32.0),
        10: (0.1, 0.5, 0.1, 2.0, 0.2, 8.0, 0.2, 32.0, 0.1, 128.0),
        11: (0.3, 0.1, 0.5, 0.1, 2.0, 0.2, 8.0, 0.1, 32.0, 0.1, 128.0),
    }
    for n, params in cases.items():
        ours = getattr(tx, f"func_exp_decay{n}")(t, *params)
        assert isinstance(ours, np.ndarray) and ours.shape == t.shape
        np.testing.assert_allclose(ours, getattr(jx, f"func_exp_decay{n}")(t, *params),
                                   rtol=1e-12, err_msg=f"num_pars={n}")
        # a scalar t evaluates pointwise
        np.testing.assert_allclose(getattr(tx, f"func_exp_decay{n}")(t[7], *params), ours[7],
                                   rtol=1e-15)
    for n in (1, 2, 5, 9):  # the product forms, batched params
        p = np.stack([np.asarray(cases[n])] * 2)
        np.testing.assert_allclose(tx.ls_decay(t, p, n).numpy(),
                                   np.asarray(jax.vmap(lambda q: jx.ls_decay(t, q, n))(p)),
                                   rtol=1e-12)


def test_bound_check_and_calc_chi_parity():
    """test_legacy_expfit.py:51 with the JAX package as the reference."""
    t = np.linspace(0.0, 10.0, 21)
    y = np.exp(-t / 3.0)
    ym = np.exp(-t / 3.5)
    dy = np.full_like(t, 0.01)
    np.testing.assert_allclose(tx.calc_chi(y, ym, dy), jx.calc_chi(y, ym, list(dy)), rtol=1e-12)
    np.testing.assert_allclose(tx.calc_chi(y, ym), jx.calc_chi(y, ym), rtol=1e-12)
    for p, n in (([0.6, 1.0, 0.6, 2.0], 4), ([0.5, 0.3, 1.0, 0.1, 2.0], 5),
                 ([0.2, 1.0, 0.3, 2.0], 4), ([7.0], 1)):
        np.testing.assert_array_equal(tx.bound_check(p, n), jx.bound_check(p, n))
    assert not tx.bound_check([7.0], 1)[0]


@pytest.mark.parametrize("num_pars", [2, 3, 5])
def test_expstyle_fit_matches_jax(num_pars):
    """test_legacy_expfit.py:74 with the JAX package as the reference: the
    same clean decays, every output within 1e-8."""
    t = np.arange(1.0, 301.0)
    truth = {2: (0.35, 40.0), 3: (0.55, 0.35, 40.0), 5: (0.6, 0.25, 8.0, 0.12, 120.0)}[num_pars]
    y = np.asarray(jx.exp_decay(t, np.asarray(truth), num_pars))
    out = tx.do_expstyle_fit(num_pars, t, y, device="cpu")
    _fits_agree(out, jx.do_expstyle_fit(num_pars, t, y))
    assert isinstance(out[0], float) and out[1].shape == (num_pars,)


def test_expstyle_fit_batched():
    """test_legacy_expfit.py:102: a (2, T) batch recovers the truth (1e-4)
    and equals JAX's (1e-8); the same with a shared (T,) sigma."""
    t = np.arange(1.0, 201.0)
    A = np.array([0.3, 0.5])
    tau = np.array([20.0, 60.0])
    y = (1 - A)[:, None] + A[:, None] * np.exp(-t[None] / tau[:, None])
    out = tx.do_expstyle_fit(2, t, y, device="cpu")
    assert out[0].shape == (2,) and out[1].shape == (2, 2)
    np.testing.assert_allclose(out[1][:, 0], A, rtol=1e-4)
    np.testing.assert_allclose(out[1][:, 1], tau, rtol=1e-4)
    _fits_agree(out, jx.do_expstyle_fit(2, t, y))
    dy = np.linspace(0.5, 2.0, t.size)
    _fits_agree(tx.do_expstyle_fit(2, t, y, dy, device="cpu"), jx.do_expstyle_fit(2, t, y, dy))


def test_bound_violation_sentinel():
    """test_legacy_expfit.py:113: a fit whose amplitude sum exceeds 1
    returns the 9999.99 sentinel, as JAX's does."""
    t = np.arange(1.0, 101.0)
    y = 0.9 + 0.4 * np.exp(-t / 10.0)
    out = tx.do_expstyle_fit(3, t, y, device="cpu")
    assert out[0] == 9999.99
    _fits_agree(out, jx.do_expstyle_fit(3, t, y))


def test_lsstyle_ours_works():
    """test_legacy_expfit.py:124 with the JAX package as the reference (the
    reference's own do_LSstyle_fit raises NameError for num_pars >= 2): the
    product model recovers the truth (1e-4, chi < 1e-10) and equals JAX's."""
    t = np.arange(1.0, 301.0)
    S2a, tau_a = 0.7, 50.0
    y = S2a + (1 - S2a) * np.exp(-t / tau_a)
    out = tx.do_lsstyle_fit(2, t, y, device="cpu")
    np.testing.assert_allclose(out[1], [S2a, tau_a], rtol=1e-4)
    assert out[0] < 1e-10
    _fits_agree(out, jx.do_lsstyle_fit(2, t, y))


def test_lsstyle_product_recovery():
    """test_legacy_expfit.py:139: the 5-parameter product form."""
    t = np.arange(1.0, 501.0)
    truth = np.array([0.3, 0.35, 120.0, 0.3, 10.0])
    y = tx.ls_decay(t, truth, 5).numpy()
    out = tx.do_lsstyle_fit(5, t, y, device="cpu")
    np.testing.assert_allclose(out[3], y, atol=1e-6)
    assert out[0] < 1e-10
    _fits_agree(out, jx.do_lsstyle_fit(5, t, y))


def test_lsstyle_sum_gt_one_sentinel():
    """test_legacy_expfit.py:151: S2 factors summing past 1 hit the
    sentinel even at a perfect fit."""
    t = np.arange(1.0, 501.0)
    truth = np.array([0.8, 0.75, 120.0, 0.85, 10.0])
    y = tx.ls_decay(t, truth, 5).numpy()
    out = tx.do_lsstyle_fit(5, t, y, device="cpu")
    np.testing.assert_allclose(out[3], y, atol=1e-6)
    assert out[0] == 9999.99
    _fits_agree(out, jx.do_lsstyle_fit(5, t, y))


def test_calc_chi_accepts_empty_sigma_sentinel():
    """test_legacy_expfit.py:163: dy=[] (the reference's default) and an
    empty array mean unweighted, exactly; and a fit given dy=[]."""
    y = np.array([1.0, 2.0, 3.0])
    m = np.array([1.1, 1.9, 3.2])
    want = tx.calc_chi(y, m, None)
    assert tx.calc_chi(y, m, []) == want == tx.calc_chi(y, m, np.array([]))
    assert want == jx.calc_chi(y, m, [])
    t = np.arange(1.0, 101.0)
    yy = 0.6 + 0.4 * np.exp(-t / 12.0)
    a = tx.do_expstyle_fit(2, t, yy, [], device="cpu")
    b = tx.do_expstyle_fit(2, t, yy, device="cpu")
    assert a[0] == b[0]
    np.testing.assert_array_equal(a[1], b[1])


def test_num_pars_range_and_numpy_defaults_to_the_card():
    for fit in (tx.do_expstyle_fit, tx.do_lsstyle_fit):
        with pytest.raises(ValueError, match="num_pars"):
            fit(10, np.arange(1.0, 5.0), np.ones(4), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tx.do_expstyle_fit(2, np.arange(1.0, 5.0), np.ones(4))
