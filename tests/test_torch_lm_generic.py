"""The port's generic LM (fit.lm.lm_solve) and the fits over it -- the cold
dense fit, variable projection, the stacked heterogeneous batch and the
varpro / stacked ladders -- against the JAX package on the CPU, on the
same seeded numpy inputs, in float64.

The JAX side is its vmapped XLA code (no Pallas kernel is involved); the
port's side is plain torch.  The LM runners' bookkeeping (fit.engine
_replay) is held here with a stub step; the CUDA graph itself runs only on
the card (tests/test_torch_cuda.py, chip_smoke.py).

Iteration counts.  Both LMs stop a lane at gates 10 ulp wide (ftol, the
stall window), so where a lane's last trial step changes the cost by an
ulp or two, the two packages' summation orders can decide the stop
differently (seen: the port accepts a step 1.7 ulp better and stops at
24 iterations; JAX rejects it and stops at lam_stuck after 43).  The
parameters are then the same optimum.  So n_iter and converged are held
equal on every lane whose final costs differ by more than 1e-12
relative, and the tests count the lanes excepted.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spinrelax_tpu.fit import expfit as jex
from spinrelax_tpu.fit import lm as jlm
from spinrelax_tpu_torch.entry import hetero_cohort
from spinrelax_tpu_torch.fit import engine as teng
from spinrelax_tpu_torch.fit import lm as tlm
from spinrelax_tpu_torch.fit.expfit import fit_ct_ladder


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_state():
    """Clear jax's compiled-program caches before this module (see
    tests/test_review_fixes_r3.py); two torch threads per xdist worker."""
    jax.clear_caches()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b) / np.maximum(np.abs(b), 1e-300)


# ---------------------------------------------------------------------------
# lm_solve on generic residuals
# ---------------------------------------------------------------------------

T_G = np.linspace(0.0, 10.0, 80)
T_E = np.arange(1.0, 151.0)


def _gauss_problem(rng, B=8):
    """A Gaussian a exp(-(t - mu)^2 / (2 w^2)) in a box whose width bound
    binds on half the lanes (their true width is above hi = 1.5)."""
    a = rng.uniform(0.5, 2.0, B)
    mu = rng.uniform(3.0, 7.0, B)
    w = np.where(np.arange(B) % 2 == 0, rng.uniform(0.6, 1.2, B), rng.uniform(1.8, 2.5, B))
    y = a[:, None] * np.exp(-(T_G - mu[:, None]) ** 2 / (2 * w[:, None] ** 2))
    y = y + 1e-3 * rng.normal(size=y.shape)
    return y, np.array([1.0, 5.0, 1.0]), np.array([0.0, 0.0, 0.1]), np.array([3.0, 10.0, 1.5])


def _twoexp_problem(rng, B=8):
    """a1 e^(-t/tau1) + a2 e^(-t/tau2) with per-lane boxes (B, 4): the fast
    tau's upper bound sits below its truth on every third lane."""
    a = rng.uniform(0.2, 0.6, (B, 2))
    tau = np.stack([rng.uniform(4.0, 12.0, B), rng.uniform(50.0, 200.0, B)], 1)
    y = (a[:, :, None] * np.exp(-T_E / tau[:, :, None])).sum(1) + 1e-4 * rng.normal(size=(B, T_E.size))
    lo = np.tile([0.0, 1e-3, 0.0, 1e-3], (B, 1))
    hi = np.tile([1.0, 30.0, 1.0, 1e3], (B, 1))
    hi[::3, 1] = 3.0
    return y, np.array([0.3, 10.0, 0.3, 100.0]), lo, hi


def _gauss_j(p, y):
    return p[0] * jnp.exp(-(jnp.asarray(T_G) - p[1]) ** 2 / (2 * p[2] ** 2)) - y


def _gauss_t(p, y):
    t = torch.from_numpy(T_G)
    return p[:, :1] * torch.exp(-(t - p[:, 1:2]) ** 2 / (2 * p[:, 2:3] ** 2)) - y


def _twoexp_j(p, y):
    t = jnp.asarray(T_E)
    return p[0] * jnp.exp(-t / p[1]) + p[2] * jnp.exp(-t / p[3]) - y


def _twoexp_t(p, y):
    t = torch.from_numpy(T_E)
    return (p[:, :1] * torch.exp(-t / p[:, 1:2]) + p[:, 2:3] * torch.exp(-t / p[:, 3:4])) - y


_PROBLEMS = {"gauss": (_gauss_problem, _gauss_j, _gauss_t),
             "twoexp": (_twoexp_problem, _twoexp_j, _twoexp_t)}


def _jax_solve(res_j, y, p0, lo, hi, skip=None, **kw):
    B = y.shape[0]
    lo_b = np.broadcast_to(lo, (B, p0.size))
    hi_b = np.broadcast_to(hi, (B, p0.size))
    sk = np.zeros(B, bool) if skip is None else skip
    out = jax.vmap(lambda yy, l, h, s: jlm.lm_solve(
        lambda p: res_j(p, yy), jnp.asarray(p0), l, h, skip=s, **kw))(
        jnp.asarray(y), jnp.asarray(lo_b), jnp.asarray(hi_b), jnp.asarray(sk))
    return jlm.LMResult(*(np.asarray(a) for a in out))


def _port_solve(res_t, y, p0, lo, hi, skip=None, **kw):
    yt = _t(y)
    out = tlm.lm_solve(lambda p: res_t(p, yt), _t(np.broadcast_to(p0, (y.shape[0], p0.size))),
                       _t(lo), _t(hi), skip=None if skip is None else _t(skip), **kw)
    return tlm.LMResult(*(a.numpy() for a in out))


def _assert_lm_agree(t, j, n_except_max):
    """params and perr 1e-8 relative, cost 1e-10; n_iter and converged
    equal except on lanes stopped by an ulp-level cost decision (module
    docstring), of which at most ``n_except_max``."""
    np.testing.assert_allclose(t.params, j.params, rtol=1e-8, atol=1e-14)
    np.testing.assert_allclose(t.perr, j.perr, rtol=1e-8, atol=1e-14)
    np.testing.assert_allclose(t.cost, j.cost, rtol=1e-10)
    same_cost = _rel(t.cost, j.cost) <= 1e-12
    differ = (t.n_iter != j.n_iter) | (t.converged != j.converged)
    assert not (differ & ~same_cost).any(), (t.n_iter, j.n_iter)
    assert differ.sum() <= n_except_max, (t.n_iter, j.n_iter)


@pytest.mark.parametrize("cov", ["chol", "pinv"])
@pytest.mark.parametrize("problem", ["gauss", "twoexp"])
def test_lm_solve_matches_jax(rng, problem, cov):
    """lm_solve on a generic residual (a Gaussian and a two-exponential,
    bounds binding on some lanes; the two-exponential with per-lane
    boxes), with a skip lane, against jax.vmap(lm_solve): params and perr
    within 1e-8 relative, cost 1e-10, n_iter and converged equal (module
    docstring).  The skip lane returns the projected start after 0
    iterations."""
    make, res_j, res_t = _PROBLEMS[problem]
    y, p0, lo, hi = make(rng)
    skip = np.zeros(y.shape[0], bool)
    skip[5] = True
    j = _jax_solve(res_j, y, p0, lo, hi, skip, cov=cov)
    t = _port_solve(res_t, y, p0, lo, hi, skip, cov=cov)
    _assert_lm_agree(t, j, n_except_max=2)
    assert t.n_iter[5] == 0 and t.converged[5]
    lo5, hi5 = np.broadcast_to(lo, y.shape[:1] + p0.shape)[5], np.broadcast_to(hi, y.shape[:1] + p0.shape)[5]
    t5 = tlm._to_unconstrained(_t(p0), _t(lo5), _t(hi5))
    want = _t(lo5) + _t(hi5 - lo5) * tlm._sigmoid(t5)
    np.testing.assert_array_equal(t.params[5], want.numpy())
    if problem == "gauss":  # the width bound binds: the fit sits just inside it
        assert (t.params[[1, 3, 7], 2] > 1.49).all()


@pytest.mark.parametrize("max_iter", [2, 4])
def test_lm_solve_trajectory_matches_jax(rng, max_iter):
    """The early trajectory is the same: after max_iter iterations params
    agree to 1e-10, and n_iter and converged are equal on every lane."""
    y, p0, lo, hi = _twoexp_problem(rng)
    j = _jax_solve(_twoexp_j, y, p0, lo, hi, max_iter=max_iter, cov="chol")
    t = _port_solve(_twoexp_t, y, p0, lo, hi, max_iter=max_iter, cov="chol")
    np.testing.assert_allclose(t.params, j.params, rtol=1e-10)
    np.testing.assert_array_equal(t.n_iter, j.n_iter)
    np.testing.assert_array_equal(t.converged, j.converged)
    assert (t.n_iter <= max_iter).all()


def test_lm_solve_lanes_do_not_depend_on_the_batch(rng):
    """A lane's result is the same in two batch compositions (all 8 lanes,
    and 5 of them in another order with a skip lane added): n_iter and
    converged equal, the rest the same bits."""
    y, p0, lo, hi = _twoexp_problem(rng)
    full = _port_solve(_twoexp_t, y, p0, lo, hi)
    perm = np.array([6, 1, 4, 7, 2, 0, 3, 5])
    same = _port_solve(_twoexp_t, y[perm], p0, lo[perm], hi[perm])
    for f in tlm.LMResult._fields:
        np.testing.assert_array_equal(getattr(same, f), getattr(full, f)[perm], err_msg=f)
    pick = perm[:5]
    y2 = np.concatenate([y[pick], y[:1]])
    lo2, hi2 = np.concatenate([lo[pick], lo[:1]]), np.concatenate([hi[pick], hi[:1]])
    skip = np.r_[np.zeros(5, bool), True]
    part = _port_solve(_twoexp_t, y2, p0, lo2, hi2, skip)
    for f in tlm.LMResult._fields:
        np.testing.assert_array_equal(getattr(part, f)[:5], getattr(full, f)[pick], err_msg=f)


def test_lm_solve_shapes_and_refusals():
    """(P,) p0 and bounds make a batch of one; an unknown cov raises; the
    residual_jac_fn path applies the box chain rule (it equals the AD
    path's Jacobian, so the fits agree to 1e-12)."""
    y = np.exp(-T_E / 20.0) * 0.5
    yt = _t(y)[None]
    res = tlm.lm_solve(lambda p: p[:, :1] * torch.exp(-_t(T_E) / p[:, 1:2]) - yt,
                       _t(np.array([0.3, 10.0])), _t(np.array([0.0, 1.0])),
                       _t(np.array([1.0, 100.0])))
    assert res.params.shape == (1, 2) and res.cost.shape == (1,)
    np.testing.assert_allclose(res.params[0].numpy(), [0.5, 20.0], rtol=1e-8)

    def res_jac(p):
        E = torch.exp(-_t(T_E) / p[:, 1:2])
        return p[:, :1] * E - yt, torch.stack([E, p[:, :1] * _t(T_E) / p[:, 1:2] ** 2 * E], 2)

    res2 = tlm.lm_solve(lambda p: res_jac(p)[0], _t(np.array([0.3, 10.0])), _t(np.array([0.0, 1.0])),
                        _t(np.array([1.0, 100.0])), residual_jac_fn=res_jac)
    np.testing.assert_allclose(res2.params.numpy(), res.params.numpy(), rtol=1e-12)
    with pytest.raises(ValueError, match="unknown cov"):
        tlm.lm_solve(lambda p: p, _t(np.ones(2)), _t(np.zeros(2)), _t(np.full(2, 2.0)),
                     cov="cholesky")


# ---------------------------------------------------------------------------
# tests/test_lm_chol.py's LM cases against the port
# ---------------------------------------------------------------------------

def test_cov_chol_zero_column_matches_scipy_truncation(rng):
    """test_lm_chol.py:68 on the port: an exactly dead Jacobian column gets
    zero variance, not NaN, under both covariances (and equal to JAX's
    perr at 1e-8)."""
    T = 60
    t = np.linspace(0.1, 6.0, T)
    y = np.exp(-t) + 1e-3 * rng.normal(size=T)

    def res_j(p, yy):
        return p[0] * jnp.exp(-jnp.asarray(t) / p[1]) - yy + 0.0 * p[2] * jnp.zeros(T)

    def res_t(p, yy):
        return p[:, :1] * torch.exp(-_t(t) / p[:, 1:2]) - yy + 0.0 * p[:, 2:3] * torch.zeros(T)

    p0, lo, hi = np.array([0.9, 1.2, 0.5]), np.zeros(3), np.array([2.0, 10.0, 1.0])
    for cov in ("chol", "pinv"):
        tr = _port_solve(res_t, y[None], p0, lo, hi, cov=cov)
        jr = _jax_solve(res_j, y[None], p0, lo, hi, cov=cov)
        assert np.isfinite(tr.perr[0, :2]).all(), cov
        assert tr.perr[0, 2] == 0.0, cov
        np.testing.assert_allclose(tr.perr, jr.perr, rtol=1e-8, err_msg=cov)


def _decays(rng, n, K, T):
    """test_lm_chol.py's _decays."""
    dt = np.arange(1.0, T + 1.0)
    S2 = rng.uniform(0.6, 0.9, n)
    C = rng.uniform(0.03, 0.1, (n, K))
    tau = np.sort(rng.uniform(5.0, 300.0, (n, K)), axis=1)
    dec = S2[:, None] + np.einsum("rk,rkt->rt", C, np.exp(-dt[None, None, :] / tau[:, :, None]))
    return dt, dec + 1e-4 * rng.normal(size=(n, T))


def test_lm_cov_chol_matches_pinv(rng):
    """test_lm_chol.py:115 on the port: params equal between the two
    covariances (1e-12) and perr equal (1e-6) on the lanes whose J^T J is
    well conditioned (cond < 1e10)."""
    K, T = 2, 300
    dt, dec = _decays(rng, 6, K, T)
    dt_t, one = _t(dt), torch.ones(T, dtype=torch.float64)
    p0 = np.array([0.05, 0.05, 10.0, 100.0, 0.7])
    lo = np.array([0.0, 0.0, 1e-8, 1e-8, 0.0])
    hi = np.array([1.0, 1.0, dt[-1] * 10, dt[-1] * 10, 1.0])
    dec_t = _t(dec)

    def run(cov):
        return tlm.lm_solve(lambda p: tlm._multiexp_residual(p, dt_t, dec_t, one, K, True),
                            _t(np.tile(p0, (6, 1))), _t(lo), _t(hi), cov=cov)

    r1, r2 = run("chol"), run("pinv")
    np.testing.assert_allclose(r1.params.numpy(), r2.params.numpy(), rtol=1e-12)
    _, J = tlm._multiexp_res_jac(r1.params, dt_t, dec_t, one, K, True)
    good = np.linalg.cond((J.transpose(1, 2) @ J).numpy()) < 1e10
    assert good.any()
    np.testing.assert_allclose(r1.perr.numpy()[good], r2.perr.numpy()[good], rtol=1e-6)


def test_convergence_gates_preserve_solution(rng):
    """test_lm_chol.py:153 on the port: the engine's fit (10-ulp ftol and
    lam_stuck gates) against lm_solve with both gates off, S2 within
    2e-7."""
    K, T = 2, 400
    dt, dec = _decays(rng, 8, K, T)
    dt_t, dec_t = _t(dt), _t(dec)
    one = torch.ones_like(dec_t)
    fit_a = tlm.fit_multiexp(dt_t, dec_t, one, K, True)
    C0, tau0, S20 = tlm._init_multiexp(dt_t, dec_t, K, True)
    p0 = torch.cat([C0, tau0.expand(8, K), S20[:, None]], 1)
    lo, hi = teng._bounds(K, True, dt_t[-1] * 10, torch.float64, "cpu")
    res = tlm.lm_solve(lambda p: tlm._multiexp_residual(p, dt_t, dec_t, one, K, True),
                       p0, lo, hi, ftol=0.0, lam_stuck=np.inf, cov="chol")
    np.testing.assert_allclose(fit_a.S2.numpy(), res.params[:, -1].numpy(), atol=2e-7)


def test_stacked_masked_jacobian_freezes_inactive(rng):
    """test_lm_chol.py:209 on the port: padding components stay exactly
    zero, their pinv'd uncertainties below 1e-10, chisq finite; and the
    result equals JAX's (C, tau, chisq 1e-8)."""
    K, T = 2, 150
    dt, dec = _decays(rng, 4, K, T)
    Kmax = 4
    tau0 = np.tile(np.array([5.0, 20.0, 80.0, 300.0]), (4, 1))
    s2f = np.array([True, True, False, False])
    out = tlm.fit_multiexp_stacked(_t(dt), _t(dec), torch.ones(4, T, dtype=torch.float64),
                                   torch.full((4,), K), _t(s2f), _t(tau0), Kmax)
    np.testing.assert_array_equal(out.C[:, K:].numpy(), 0.0)
    assert out.dC[:, K:].abs().max() < 1e-10
    assert torch.isfinite(out.chisq).all()
    j = jlm.fit_multiexp_stacked(jnp.asarray(dt), jnp.asarray(dec), jnp.ones((4, T)),
                                 jnp.full(4, K), jnp.asarray(s2f), jnp.asarray(tau0), Kmax=Kmax)
    # lanes 2, 3 fix S2 = 1 - sum C on data whose S2 + sum C is not 1
    _assert_fits_agree(out, j, dt, K, min_determined=0.25)


def test_varpro_degenerate_tau_start_survives(rng):
    """test_lm_chol.py:233 on the port: single-exponential data under a
    K = 2 varpro fit drives the taus together; the scale-aware ridge keeps
    it finite, S2 within 5e-3 of 0.8."""
    K, T = 2, 200
    dt = np.arange(1.0, T + 1.0)
    dec = np.tile(0.8 + 0.15 * np.exp(-dt / 50.0), (3, 1)) + 1e-5 * rng.normal(size=(3, T))
    fit = tlm.fit_multiexp_varpro(_t(dt), _t(dec), torch.ones(3, T, dtype=torch.float64),
                                  K, True)
    assert torch.isfinite(fit.S2).all() and torch.isfinite(fit.chisq).all()
    np.testing.assert_allclose(fit.S2.numpy(), 0.8, atol=5e-3)


# ---------------------------------------------------------------------------
# the dense, varpro and stacked multi-exponential fits
# ---------------------------------------------------------------------------

def _truth_decays(rng, specs, T=300, noise=1e-5):
    """One decay per (K, s2_free) of specs with K true components
    (tests/test_stacked_lm.py's heterogeneous batch), unit sigma.  The
    taus are a factor ~5 apart (6, 30, 150 ps, each times 0.8-1.25) and the
    amplitudes 0.05-0.12 (S2 = 1 - sum C where S2 is not free), so every
    component is determined by the data: a
    fit that holds a component the data cannot see lies in a flat valley
    of its cost, where two correct optimisers stop at parameters that
    differ by their rounding (tests/test_torch_ladder.py), and a 1e-8
    comparison of parameters means nothing there."""
    dt = np.arange(1.0, T + 1.0)
    rows = []
    for K, s2f in specs:
        C = rng.uniform(0.05, 0.12, K)
        S2 = rng.uniform(0.6, 0.8) if s2f else 1.0 - C.sum()
        tau = 6.0 * 5.0 ** np.arange(K) * rng.uniform(0.8, 1.25, K)
        rows.append(S2 + (C[:, None] * np.exp(-dt / tau[:, None])).sum(0)
                    + noise * rng.normal(size=T))
    y = np.stack(rows)
    return dt, y, np.ones_like(y)


def _assert_fits_agree(t, j, dt, K=None, rtol=1e-8, min_determined=0.5, active=None):
    """MultiExpFit fields, components [:K]: the flags equal, and chisq and
    the fitted curve S2 + sum C e^(-t/tau) within ``rtol`` on every lane;
    the parameters within ``rtol`` and their uncertainties within
    100 ``rtol`` on the lanes the data determine (they pass the dParam <=
    Param check, every component is seen: C > 1e-12 and
    e^(-dt[0]/tau) > 1e-10, and no two taus lie within 0.1 %), at least
    ``min_determined`` of them.  Elsewhere the
    parameters sit in a flat valley of the cost (tests/test_torch_ladder.py).
    ``active`` (B, K) bool: the components a heterogeneous batch's lanes
    hold (the padding's C is 0).  Returns the determined lanes."""
    sl = slice(None) if K is None else slice(0, K)
    tv = {f: getattr(t, f).numpy() for f in t._fields}
    jv = {f: np.asarray(getattr(j, f)) for f in j._fields}
    for v in (tv, jv):
        for f in ("C", "tau", "dC", "dtau"):
            v[f] = v[f][:, sl]
    for f in ("ok_fit", "ok_err", "ok_sum"):
        np.testing.assert_array_equal(tv[f], jv[f], err_msg=f)
    np.testing.assert_allclose(tv["chisq"], jv["chisq"], rtol=rtol, atol=1e-300)

    def curve(v):
        return v["S2"][:, None] + (v["C"][:, :, None] * np.exp(-dt / v["tau"][:, :, None])).sum(1)

    np.testing.assert_allclose(curve(tv), curve(jv), rtol=0, atol=rtol)
    C, tau = jv["C"], jv["tau"]
    pad = np.zeros(C.shape, bool) if active is None else ~active
    seen = (pad | ((C > 1e-12) & (np.exp(-dt[0] / tau) > 1e-10))).all(1)
    with np.errstate(invalid="ignore"):
        gate = (np.isfinite(jv["dC"]).all(1) & np.isfinite(jv["dtau"]).all(1)
                & (pad | (jv["dC"] <= C)).all(1) & (pad | (jv["dtau"] <= tau)).all(1)
                & (jv["dS2"] <= jv["S2"]))
    # collapsed components (two taus within 0.1 %) fix only their sum of C
    taus = np.sort(np.where(pad, np.inf, tau), 1)
    with np.errstate(invalid="ignore"):
        gap = taus[:, 1:] / taus[:, :-1] - 1.0
    apart = (~(gap < 1e-3)).all(1)
    rows = seen & gate & apart
    assert rows.mean() >= min_determined, rows
    for f in ("C", "tau", "S2"):
        np.testing.assert_allclose(tv[f][rows], jv[f][rows], rtol=rtol, atol=1e-14, err_msg=f)
    for f in ("dC", "dtau"):  # a padding slot's pinv'd variance is rounding
        np.testing.assert_allclose(np.where(pad, 0.0, tv[f])[rows], np.where(pad, 0.0, jv[f])[rows],
                                   rtol=100 * rtol, atol=1e-14, err_msg=f)
    np.testing.assert_allclose(tv["dS2"][rows], jv["dS2"][rows], rtol=100 * rtol, atol=1e-14)
    return rows


@pytest.mark.parametrize("K,s2f,ns", [(1, False, 1), (2, True, 1), (3, True, 1), (2, True, 3)])
def test_fit_one_dense_matches_jax_and_engine(rng, K, s2f, ns):
    """_fit_one_dense (the cold fit over lm_solve, cov="chol") against the
    JAX package's vmapped _fit_one_dense, and against the port's
    fit_multiexp (fit.engine, the same gates over kernels B/C's plain
    versions): every field within 1e-8 (perr 1e-6), flags equal."""
    dt, y, sg = _truth_decays(rng, [(K, s2f)] * 6)
    t = tlm.MultiExpFit(*tlm._fit_one_dense(_t(dt), _t(y), _t(sg), K, s2f, n_starts=ns))
    j = jlm._fit_multiexp_xla(jnp.asarray(dt), jnp.asarray(y), jnp.asarray(sg), K=K,
                              s2_free=s2f, n_starts=ns)
    _assert_fits_agree(t, j, dt)
    _assert_fits_agree(t, tlm.fit_multiexp(_t(dt), _t(y), _t(sg), K, s2f, n_starts=ns), dt)


@pytest.mark.parametrize("K,s2f", [(2, True), (3, False)])
def test_warm_dense_matches_jax_and_engine(rng, K, s2f):
    """_fit_one_dense from per-row starts (the warm fit of CUDA float64,
    where kernels B and C do not run) against the JAX package's
    fit_multiexp_warm and the port's engine warm fit, from the cold fit's
    solution perturbed by 10 %."""
    dt, y, sg = _truth_decays(rng, [(K, s2f)] * 6)
    cold = tlm.fit_multiexp(_t(dt), _t(y), _t(sg), K, s2f)
    C0, tau0 = cold.C * 1.1, cold.tau * 0.9
    S20 = cold.S2 if s2f else 1.0 - C0.sum(1)
    t = tlm.MultiExpFit(*tlm._fit_one_dense(_t(dt), _t(y), _t(sg), K, s2f,
                                            init=(C0, tau0, S20)))
    j = jlm.fit_multiexp_warm(jnp.asarray(dt), jnp.asarray(y), jnp.asarray(sg),
                              *(jnp.asarray(a.numpy()) for a in (C0, tau0, S20)),
                              K=K, s2_free=s2f)
    _assert_fits_agree(t, j, dt)
    _assert_fits_agree(t, tlm.fit_multiexp_warm(_t(dt), _t(y), _t(sg), C0, tau0, S20, K, s2f),
                       dt)


@pytest.mark.parametrize("K", [1, 2, 3])
def test_varpro_matches_jax(rng, K):
    """fit_multiexp_varpro (analytic varpro Jacobian) against the JAX
    package's (jax.jacfwd through the amplitude solve) with S2 free and
    fixed: params and chisq within 1e-8, perr 1e-6, the sort order and the
    flags equal."""
    dt, y, sg = _truth_decays(rng, [(K, True)] * 4 + [(K, False)] * 4)
    sg = sg * rng.uniform(0.5, 2.0, sg.shape)
    for s2f in (True, False):
        t = tlm.fit_multiexp_varpro(_t(dt), _t(y), _t(sg), K, s2f)
        j = jlm.fit_multiexp_varpro(jnp.asarray(dt), jnp.asarray(y), jnp.asarray(sg), K=K,
                                    s2_free=s2f)
        rows = _assert_fits_agree(t, j, dt)
        np.testing.assert_array_equal(np.argsort(t.tau.numpy()[rows], 1),
                                      np.argsort(np.asarray(j.tau)[rows], 1))


@pytest.mark.parametrize("K,s2f", [(1, True), (1, False), (2, True), (2, False), (4, True)])
def test_varpro_jacobian_matches_forward_ad(rng, K, s2f):
    """The analytic varpro Jacobian (through the ridged amplitude solve)
    equals torch.func forward-mode AD of the same residual at 1e-12
    relative to its largest entry, at well-spread taus (the normal
    matrix's condition number below 1e4, so rounding stays below 1e-12)."""
    B, T = 3, 300
    dt = torch.arange(1.0, T + 1.0, dtype=torch.float64)
    y = _t(0.7 + 0.2 * np.exp(-np.arange(1.0, T + 1.0) / 40.0)[None]
           + 1e-3 * rng.normal(size=(B, T)))
    sg = _t(rng.uniform(0.5, 2.0, (B, T)))
    tau = _t(np.tile(np.geomspace(2.0, 250.0, K), (B, 1)) * rng.uniform(0.9, 1.1, (B, K)))
    r, J = tlm._varpro_res_jac(tau, dt, y, sg, K, s2f, True)
    r2, J2 = tlm._batch_jac(lambda tt: tlm._varpro_res_jac(tt, dt, y, sg, K, s2f, False), tau)
    assert torch.equal(r, r2)
    assert float((J - J2).abs().max() / J2.abs().max()) < 1e-12


@pytest.mark.parametrize("K", [1, 2, 3])
@pytest.mark.parametrize("s2f", [True, False])
def test_stacked_single_rung_matches_jax(rng, K, s2f):
    """tests/test_stacked_lm.py::test_stacked_matches_dense_single_rung on
    the port against JAX's stacked fit: components [:K], S2, chisq within
    1e-8, perr 1e-6, flags equal, padding C exactly 0."""
    dt, y, sg = _truth_decays(rng, [(K, s2f)] * 6)
    Kmax = 4
    step = float(np.mean(dt[1:] - dt[:-1]))
    tau0 = np.full((6, Kmax), dt[-1])
    tau0[:, :K] = np.logspace(np.log10(step), np.log10(dt[-1] * 2.0), K + 2)[1:-1]
    t = tlm.fit_multiexp_stacked(_t(dt), _t(y), _t(sg), torch.full((6,), K),
                                 torch.full((6,), s2f), _t(tau0), Kmax)
    j = jlm.fit_multiexp_stacked(jnp.asarray(dt), jnp.asarray(y), jnp.asarray(sg),
                                 jnp.full(6, K), jnp.full(6, s2f), jnp.asarray(tau0), Kmax=Kmax)
    _assert_fits_agree(t, j, dt, K)
    assert (t.C[:, K:] == 0).all()


def test_stacked_heterogeneous_batch_and_ladder_match_jax(rng):
    """tests/test_stacked_lm.py::test_stacked_heterogeneous_batch on the
    port (K in 1..3, S2 free and fixed in one batch) against JAX's
    fit_multiexp_stacked, and fit_multiexp_ladder (rungs tiled on the
    device) against JAX's: params within 1e-8, the sort order and the
    flags equal."""
    specs = [(1, False), (1, True), (2, True), (3, True), (2, False), (3, False)]
    dt, y, sg = _truth_decays(rng, specs, T=120)
    Kmax = 3
    step = float(np.mean(dt[1:] - dt[:-1]))
    tau0 = np.full((len(specs), Kmax), dt[-1])
    for i, (K, _) in enumerate(specs):
        tau0[i, :K] = np.logspace(np.log10(step), np.log10(dt[-1] * 2.0), K + 2)[1:-1]
    Kv, s2 = np.array([k for k, _ in specs]), np.array([s for _, s in specs])
    t = tlm.fit_multiexp_stacked(_t(dt), _t(y), _t(sg), _t(Kv), _t(s2), _t(tau0), Kmax)
    j = jlm.fit_multiexp_stacked(jnp.asarray(dt), jnp.asarray(y), jnp.asarray(sg),
                                 jnp.asarray(Kv), jnp.asarray(s2), jnp.asarray(tau0), Kmax=Kmax)
    active = np.arange(Kmax) < Kv[:, None]
    rows = _assert_fits_agree(t, j, dt, active=active)
    np.testing.assert_array_equal(np.argsort(t.tau.numpy()[rows], 1),
                                  np.argsort(np.asarray(j.tau)[rows], 1))

    lspecs = ((1, False), (1, True), (2, True))
    rows = tau0[[0, 1, 2]]
    tl = tlm.fit_multiexp_ladder(_t(dt), _t(y), _t(sg), _t(rows), lspecs, Kmax)
    jl = jlm.fit_multiexp_ladder(jnp.asarray(dt), jnp.asarray(y), jnp.asarray(sg),
                                 jnp.asarray(rows), lspecs, Kmax=Kmax)
    assert tl.C.shape == (3 * len(specs), Kmax)
    lK = np.repeat([k for k, _ in lspecs], len(specs))
    _assert_fits_agree(tl, jl, dt, active=np.arange(Kmax) < lK[:, None], min_determined=0.25)


# ---------------------------------------------------------------------------
# the varpro and stacked ladders
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cohort_ladders():
    """{(kw, weighted): (JAX ladder, port ladder, trace)} on
    entry.hetero_cohort(12, 60), computed once."""
    dt, y, dy = hetero_cohort(12, 60)
    names = [str(i) for i in range(12)]
    out = {}
    for key, kw in (("varpro", dict(optimiser="varpro")), ("stacked", dict(stacked=True))):
        for weighted in (False, True):
            sig = dy if weighted else None
            trace = []
            out[key, weighted] = (jex.fit_ct_ladder(names, dt, y, sig, **kw),
                                  fit_ct_ladder(names, dt, y, sig, device="cpu", trace=trace,
                                                **kw), trace)
    return dt, out


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("kind", ["varpro", "stacked"])
def test_ladder_matches_jax(cohort_ladders, kind, weighted):
    """fit_ct_ladder(optimiser="varpro") and (stacked=True) against the JAX
    package's on entry.hetero_cohort(12, 60): the rung selected equal on
    every row, and the fitted model C(t) (S2 + sum C e^(-t/tau)) within
    1e-8 everywhere; chisq 1e-10.  (The parameters of a row with a
    component the data barely see sit in a flat valley of the cost and
    agree only to ~1e-7, as tests/test_torch_ladder.py describes; the
    curve does not.)"""
    dt, ladders = cohort_ladders
    j, t, trace = ladders[kind, weighted]
    for f in ("mask", "s2fast"):
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)), err_msg=f)
    real = np.asarray(j.mask) > 0
    curve = np.asarray(j.S2)[:, None] + ((np.asarray(j.C) * real)[:, :, None]
                                         * np.exp(-dt / np.asarray(j.tau)[:, :, None])).sum(1)
    np.testing.assert_allclose(t.eval(dt).numpy(), curve, rtol=0, atol=1e-8)
    np.testing.assert_allclose(t.chisq.numpy(), np.asarray(j.chisq), rtol=1e-10)
    stages = {c["stage"] for c in trace}
    if kind == "stacked":
        assert stages == {"stacked"} and trace[0]["rows"] == 5 * 12
    else:  # cold varpro rungs, then warm retries over fit.engine; no multi-start arm
        assert stages <= {"rung", "warm", "resume"} and "rung" in stages
    assert all(c["launches_B"] == c["launches_C"] == 0 for c in trace)


def test_ladder_option_errors_match_jax():
    """The JAX ValueErrors of expfit.py:272-277: varpro with stacked, and
    n_starts > 1 off the plain per-rung LM."""
    dt, y = np.arange(1.0, 9.0), np.ones((2, 8))
    for kw in (dict(optimiser="varpro", stacked=True), dict(optimiser="varpro", n_starts=2),
               dict(stacked=True, n_starts=2)):
        with pytest.raises(ValueError) as e_t:
            fit_ct_ladder(["0", "1"], dt, y, device="cpu", **kw)
        with pytest.raises(ValueError) as e_j:
            jex.fit_ct_ladder(["0", "1"], dt, y, **kw)
        assert str(e_t.value) == str(e_j.value)


# ---------------------------------------------------------------------------
# the runners' bookkeeping
# ---------------------------------------------------------------------------

class _Counter:
    launches = 0


@pytest.mark.parametrize("stop_at,max_iter,want", [(3, 60, 8), (8, 60, 8), (9, 60, 16),
                                                   (100, 20, 20), (100, 1, 1)])
def test_replay_bookkeeping(stop_at, max_iter, want):
    """fit.engine._replay (the graph runner's loop, here with a stub
    replay): it reads the live flag at multiples of the window, so a step
    that clears it at ``stop_at`` runs on to the window's end; it stops at
    max_iter; each replay adds one to every counter it was given, and a
    runner given no counters (lm_solve) adds to none."""
    live = torch.tensor(True)
    n = [1]  # the first step ran eagerly

    def replay():
        n[0] += 1
        if n[0] >= stop_at:
            live.fill_(False)

    if max_iter == 1:
        assert teng._run_eager(lambda: live.fill_(False), live, 1, 8) == 1
        return
    a, b, other = _Counter(), _Counter(), _Counter()
    steps = teng._replay(replay, live, 1, max_iter, 8, (a, b))
    assert steps == want == n[0]
    assert a.launches == b.launches == want - 1 and other.launches == 0
    live.fill_(True)
    n[0] = 1
    assert teng._replay(replay, live, 1, max_iter, 8) == want
    assert other.launches == 0
