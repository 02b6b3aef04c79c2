"""spinrelax_tpu_torch's LM (ops.cuda_lm, fit.lm, fit.engine) against
spinrelax_tpu's on the CPU, on the same seeded numpy inputs.

On CPU tensors the port's engine evaluates every iteration with the plain
versions of kernels B and C; these are held to the TPU kernels in
interpret mode, and the whole fit to the JAX engine (interpret mode) and
to the JAX package's vmapped XLA fit, with tests/test_engine.py's
criteria.  Kernels B and C themselves run only on the GPU.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spinrelax_tpu.fit.engine as jeng
from spinrelax_tpu.fit import lm as jlm
from spinrelax_tpu.ops import pallas_lm as plm
from spinrelax_tpu_torch.fit import engine as teng
from spinrelax_tpu_torch.fit import lm as tlm
from spinrelax_tpu_torch.ops import cuda_lm


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_state():
    """Clear jax's compiled-program caches before this module (see
    tests/test_review_fixes_r3.py); two torch threads per xdist worker."""
    jax.clear_caches()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(2)


def _cohort(rng, B=192, T=300, noise=2e-3):
    """tests/test_engine.py's two-timescale cohort, float32."""
    dt = np.arange(1, T + 1, dtype=np.float32)
    S2 = rng.uniform(0.6, 0.9, B)
    C1 = rng.uniform(0.05, 0.2, B)
    tau1 = rng.uniform(5, 30, B)
    C2 = 1 - S2 - C1
    tau2 = rng.uniform(100, 400, B)
    y = (S2[:, None] + C1[:, None] * np.exp(-dt / tau1[:, None])
         + C2[:, None] * np.exp(-dt / tau2[:, None])
         + rng.normal(scale=noise, size=(B, T))).astype(np.float32)
    return dt, y, np.full_like(y, noise)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _check_plain_against_pallas_interpret(rng, K, s2f, B, T):
    """hgc_plain / cost_plain (through the cuda_lm dispatchers, CPU route)
    on (B, T) against the TPU kernels in interpret mode on operands padded
    to (T_pad, B_pad): pad lags carry isg = 0, pad lanes are dropped."""
    P = plm.n_par(K, s2f)
    T_pad, B_pad, P_pad = -(-T // 8) * 8, -(-B // plm.LANES) * plm.LANES, 16
    dt = np.linspace(1, 100, T).astype(np.float32)
    y = rng.uniform(0.3, 1.0, (B, T)).astype(np.float32)
    sg = rng.uniform(0.5, 2.0, (B, T)).astype(np.float32)
    C = rng.uniform(0.01, 0.4, (B, K))
    tau = rng.uniform(1.0, 500.0, (B, K))
    S2 = rng.uniform(0.2, 0.8, B)
    p = np.concatenate([C, tau] + ([S2[:, None]] if s2f else []), axis=1).astype(np.float32)

    p_t = np.zeros((P_pad, B_pad), np.float32)
    p_t[:P, :B] = p.T
    p_t[:P, B:] = p.T[:, :1]  # pad lanes: any finite parameters
    y_t = np.zeros((T_pad, B_pad), np.float32)
    y_t[:T, :B] = y.T
    isg_t = np.zeros((T_pad, B_pad), np.float32)
    isg_t[:T, :B] = (1.0 / sg).T
    dt_t = np.zeros((T_pad, plm.LANES), np.float32)
    dt_t[:T] = dt[:, None]
    Hj, gj, cj = plm.hgc(*map(jnp.asarray, (p_t, y_t, isg_t, dt_t)), K, s2f,
                         interpret=True)
    cj2 = plm.cost(*map(jnp.asarray, (p_t, y_t, isg_t, dt_t)), K, s2f,
                   interpret=True)

    args = _t(p.T, y.T, (1.0 / sg).T, dt)
    H, g, c = cuda_lm.hgc(*args, K, s2f)
    c2 = cuda_lm.cost(*args, K, s2f)
    assert H.shape == (B, P, P) and g.shape == (B, P) and c.shape == (B,)
    np.testing.assert_allclose(H.numpy(), np.asarray(Hj)[:B], rtol=3e-5, atol=1e-4)
    np.testing.assert_allclose(g.numpy(), np.asarray(gj)[:B], rtol=3e-5, atol=1e-3)
    np.testing.assert_allclose(c.numpy(), np.asarray(cj)[:B], rtol=1e-5)
    np.testing.assert_allclose(c2.numpy(), np.asarray(cj2)[:B], rtol=1e-5)
    np.testing.assert_allclose(c2.numpy(), c.numpy(), rtol=1e-6)


@pytest.mark.parametrize("K,s2f", [(1, False), (2, True), (4, True)])
def test_hgc_cost_plain_match_pallas_interpret(rng, K, s2f):
    """hgc_plain / cost_plain equal the TPU kernels B and C (interpret
    mode, f32) with test_engine's tolerances: H rtol 3e-5 atol 1e-4,
    g rtol 3e-5 atol 1e-3, cost rtol 1e-5 (f32 sums in another order).
    The TPU side runs on padded operands (pad lags carry isg = 0)."""
    _check_plain_against_pallas_interpret(rng, K, s2f, B=128, T=100)


@pytest.mark.parametrize("K,s2f,B,T", [(2, True, 77, 31), (3, False, 1, 1)])
def test_hgc_cost_plain_match_pallas_interpret_ragged(rng, K, s2f, B, T):
    """... and on ragged shapes (B and T off the TPU's (8, 128) tiling,
    down to one problem and one lag), same tolerances."""
    _check_plain_against_pallas_interpret(rng, K, s2f, B, T)


@pytest.mark.parametrize("K,s2f", [(1, True), (3, False)])
def test_hgc_plain_matches_res_jac_f64(rng, K, s2f):
    """In f64, hgc_plain equals J^T J, J^T r, 0.5 r.r from the JAX
    analytic Jacobian (rtol 1e-12; same algebra, another sum order)."""
    B, T = 16, 40
    dt = np.linspace(1, 80, T)
    y = rng.uniform(0.3, 1.0, (B, T))
    sg = rng.uniform(0.5, 2.0, (B, T))
    p = np.concatenate([rng.uniform(0.05, 0.3, (B, K)), rng.uniform(2, 200, (B, K))]
                       + ([rng.uniform(0.2, 0.6, (B, 1))] if s2f else []), axis=1)
    H, g, c = cuda_lm.hgc_plain(*_t(p.T, y.T, (1.0 / sg).T, dt), K, s2f)
    for b in range(0, B, 5):
        r, J = jlm._multiexp_res_jac(*map(jnp.asarray, (p[b], dt, y[b], sg[b])), K, s2f)
        r, J = np.asarray(r), np.asarray(J)
        np.testing.assert_allclose(H[b].numpy(), J.T @ J, rtol=1e-12)
        np.testing.assert_allclose(g[b].numpy(), J.T @ r, rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(float(c[b]), 0.5 * r @ r, rtol=1e-12)


@pytest.mark.parametrize("K,s2f", [(2, True), (2, False)])
def test_res_jac_matches_jax_and_autograd_f64(rng, K, s2f):
    """Batched residual / analytic Jacobian equal the JAX per-problem
    functions (1e-13) and torch autograd's Jacobian of the residual."""
    B, T = 6, 30
    dt = np.linspace(1, 60, T)
    y = rng.uniform(0.3, 1.0, (B, T))
    sg = rng.uniform(0.5, 2.0, (B, T))
    p = np.concatenate([rng.uniform(0.05, 0.3, (B, K)), rng.uniform(2, 200, (B, K))]
                       + ([rng.uniform(0.2, 0.6, (B, 1))] if s2f else []), axis=1)
    pt, dtt, yt, sgt = _t(p, dt, y, sg)
    r, J = tlm._multiexp_res_jac(pt, dtt, yt, sgt, K, s2f)
    r2 = tlm._multiexp_residual(pt, dtt, yt, sgt, K, s2f)
    np.testing.assert_allclose(r.numpy(), r2.numpy(), rtol=1e-14)
    for b in range(B):
        rj, Jj = jlm._multiexp_res_jac(*map(jnp.asarray, (p[b], dt, y[b], sg[b])), K, s2f)
        np.testing.assert_allclose(r[b].numpy(), np.asarray(rj), rtol=1e-13, atol=1e-15)
        np.testing.assert_allclose(J[b].numpy(), np.asarray(Jj), rtol=1e-13, atol=1e-15)
        Ja = torch.autograd.functional.jacobian(
            lambda q: tlm._multiexp_residual(q, dtt, yt[b], sgt[b], K, s2f), pt[b])
        np.testing.assert_allclose(J[b].numpy(), Ja.numpy(), rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("P", [1, 3, 5, 9])
def test_unrolled_cholesky_matches_linalg(rng, P):
    """The unrolled solve and inverse diagonal equal torch.linalg on
    well-conditioned SPD batches (f64, rtol 1e-10)."""
    M = rng.normal(size=(64, P, P))
    A = torch.from_numpy(M @ np.swapaxes(M, 1, 2) + P * np.eye(P))
    b = torch.from_numpy(rng.normal(size=(64, P)))
    x = tlm._chol_solve_small(A, b)
    torch.testing.assert_close(x, torch.linalg.solve(A, b), rtol=1e-10, atol=1e-12)
    inv_d = tlm._spd_inv_diag_small(A)
    torch.testing.assert_close(inv_d, torch.diagonal(torch.linalg.inv(A), dim1=1, dim2=2),
                               rtol=1e-10, atol=1e-12)
    L = tlm._chol_factor_small(A)
    Lt = torch.linalg.cholesky(A)
    for i in range(P):
        for j in range(i + 1):
            torch.testing.assert_close(L[i][j], Lt[:, i, j], rtol=1e-10, atol=1e-12)


def test_sigmoid_box_matches_jax(rng):
    lo = np.array([0.0, 1e-8, 0.0])
    hi = np.array([1.0, 3000.0, 1.0])
    p = rng.uniform(lo, hi, (20, 3))
    p[0] = lo  # clipped just inside the box
    tj = np.asarray(jlm._to_unconstrained(*map(jnp.asarray, (p, lo, hi))))
    t = tlm._to_unconstrained(*_t(p, lo, hi))
    np.testing.assert_allclose(t.numpy(), tj, rtol=1e-12)
    np.testing.assert_allclose(tlm._to_constrained(t, *_t(lo, hi)).numpy(),
                               np.asarray(jlm._to_constrained(*map(jnp.asarray, (tj, lo, hi)))),
                               rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("K,s2f", [(2, True), (3, False)])
def test_init_multiexp_matches_jax(rng, K, s2f):
    dt, y, _ = _cohort(rng, B=8, T=120)
    dt, y = dt.astype(np.float64), y.astype(np.float64)
    C, taus, S2 = tlm._init_multiexp(*_t(dt, y), K, s2f)
    for b in range(8):
        Cj, tj, S2j = jlm._init_multiexp(jnp.asarray(dt), jnp.asarray(y[b]), K, s2f)
        np.testing.assert_allclose(C[b].numpy(), np.asarray(Cj), rtol=1e-14)
        np.testing.assert_allclose(taus.numpy(), np.asarray(tj), rtol=1e-13)
        np.testing.assert_allclose(float(S2[b]), float(S2j), rtol=1e-14)


def test_finalise_sort_is_stable():
    """Tied taus keep their input order (jnp.argsort is stable; the port
    passes stable=True), and the flags follow the reference rules."""
    dt = torch.arange(1.0, 11.0, dtype=torch.float64)
    y = torch.full((2, 10), 0.7, dtype=torch.float64)
    sg = torch.ones_like(y)
    C = torch.tensor([[0.1, 0.2, 0.3], [0.3, 0.2, 0.1]], dtype=torch.float64)
    tau = torch.tensor([[5.0, 5.0, 1.0], [2.0, 2.0, 2.0]], dtype=torch.float64)
    dC = C / 10
    dtau = tau / 10
    S2 = torch.tensor([0.4, 0.4], dtype=torch.float64)
    C0 = torch.tensor([[0.1, 0.2, 0.3], [0.3, 0.3, 0.1]], dtype=torch.float64)
    out = tlm._finalise_multiexp(dt, y, sg, C, tau, S2, dC, dtau, S2 / 10,
                                 C0, S2, True)
    torch.testing.assert_close(out[0], torch.tensor([[0.3, 0.1, 0.2], [0.3, 0.2, 0.1]],
                                                    dtype=torch.float64))
    assert out[7].all() and out[8].all()
    # sum check on the initial guesses: 0.4 + 0.6 <= 1, 0.4 + 0.7 > 1
    assert out[9].tolist() == [True, False]


def _flags(f):
    return np.asarray(f.ok_fit & f.ok_err & f.ok_sum)


def _assert_selection_agrees(a, b):
    """tests/test_engine.py's criteria: median relative chisq gap < 1e-4,
    >= 95 % of lanes within 1e-2, quality flags agreeing on > 95 %."""
    ca, cb = np.asarray(a.chisq), np.asarray(b.chisq)
    rel = np.abs(cb - ca) / np.maximum(ca, 1e-12)
    assert np.median(rel) < 1e-4, np.median(rel)
    assert np.mean(rel < 1e-2) > 0.95, np.mean(rel < 1e-2)
    assert np.mean(_flags(a) == _flags(b)) > 0.95


@pytest.mark.parametrize("K,s2f,ns", [(1, False, 1), (2, True, 1),
                                      (3, True, 1), (2, True, 4)])
def test_fit_multiexp_matches_jax_xla(rng, K, s2f, ns):
    """The port's fit_multiexp (engine + plain B/C, f32 CPU) against the
    JAX vmapped XLA fit on the same f32 cohort."""
    dt, y, sg = _cohort(rng)
    a = jlm.fit_multiexp(dt, y, sg, K=K, s2_free=s2f, n_starts=ns)
    b = tlm.fit_multiexp(*_t(dt, y, sg), K=K, s2_free=s2f, n_starts=ns)
    _assert_selection_agrees(a, b)


@pytest.mark.parametrize("K,s2f,ns", [(2, True, 1), (1, False, 2)])
def test_fit_multiexp_matches_jax_engine_interpret(rng, K, s2f, ns):
    """... and against the JAX engine over the TPU kernels (interpret)."""
    dt, y, sg = _cohort(rng)
    a = jeng.fit_multiexp_engine(dt, y, sg, K=K, s2_free=s2f, n_starts=ns,
                                 interpret=True)
    b = tlm.fit_multiexp(*_t(dt, y, sg), K=K, s2_free=s2f, n_starts=ns)
    _assert_selection_agrees(a, b)


def test_fit_multiexp_f64_matches_jax_xla_closely(rng):
    """In f64 the port follows the JAX XLA trajectories: chisq to 1e-8
    relative on >= 95 % of lanes, S2 to 1e-6 on the lanes whose chisq
    agrees (knife-edge lanes may land on another, equally good split)."""
    dt, y, sg = (a.astype(np.float64) for a in _cohort(rng, B=96))
    a = jlm.fit_multiexp(dt, y, sg, K=2, s2_free=True)
    b = tlm.fit_multiexp(*_t(dt, y, sg), K=2, s2_free=True)
    ca, cb = np.asarray(a.chisq), b.chisq.numpy()
    same = np.abs(cb - ca) / ca < 1e-8
    assert same.mean() >= 0.95
    np.testing.assert_allclose(b.S2.numpy()[same], np.asarray(a.S2)[same], atol=1e-6)
    assert (_flags(a) == _flags(b)).mean() >= 0.95


def test_engine_skip_lanes(rng):
    """skip lanes return the projected initial guess; the others equal a
    run without skipped lanes (as tests/test_engine.py pins for JAX), and
    the JAX engine's skipped lanes give the same guesses."""
    dt, y, sg = _cohort(rng, B=64)
    skip = np.zeros(64, bool)
    skip[::2] = True
    a = teng.fit_multiexp_engine(*_t(dt, y, sg), K=2, s2_free=True,
                                 skip=torch.from_numpy(skip))
    b = teng.fit_multiexp_engine(*_t(dt, y, sg), K=2, s2_free=True)
    np.testing.assert_allclose(a.chisq.numpy()[1::2], b.chisq.numpy()[1::2], rtol=1e-6)
    assert not np.allclose(a.chisq.numpy()[::2], b.chisq.numpy()[::2])
    j = jeng.fit_multiexp_engine(dt, y, sg, K=2, s2_free=True, skip=skip,
                                 interpret=True)
    np.testing.assert_allclose(a.tau.numpy()[::2], np.asarray(j.tau)[::2], rtol=1e-5)
    np.testing.assert_allclose(a.S2.numpy()[::2], np.asarray(j.S2)[::2], rtol=1e-5)


def test_fit_multiexp_matches_jax_on_forward_ct():
    """On the forward's own kind of input -- Palmer C(t) of a correlated
    walk, nearly single-exponential, so K = 2 is degenerate on many
    lanes -- the port's f32 engine follows the JAX f32 engine with
    test_engine's criteria, and in f64 the port equals the JAX XLA fit
    to 1e-8 on every lane.  (Every f32 LM of either package stops some of
    these lanes above the f64 optimum: its eps-scaled gates do that.)"""
    from spinrelax_tpu_torch.entry import correlated_walk
    from spinrelax_tpu_torch.ops.autocorr import ct_palmer

    Ct, dCt = ct_palmer(torch.from_numpy(correlated_walk(16, 600, 96, seed=3)).double())
    y = Ct.T.contiguous().numpy()
    sg = np.where(dCt.T.numpy() > 0, dCt.T.numpy(), 1.0)
    dt = np.arange(1.0, y.shape[1] + 1.0)
    a = jlm.fit_multiexp(dt, y, sg, K=2, s2_free=True)
    b = tlm.fit_multiexp(*_t(dt, y, sg), K=2, s2_free=True)
    np.testing.assert_allclose(b.chisq.numpy(), np.asarray(a.chisq), rtol=1e-8)
    f32 = [x.astype(np.float32) for x in (dt, y, sg)]
    a32 = jeng.fit_multiexp_engine(*f32, K=2, s2_free=True, interpret=True)
    b32 = tlm.fit_multiexp(*_t(*f32), K=2, s2_free=True)
    _assert_selection_agrees(a32, b32)


def _old_engine(dt, decay, sigma, K: int, s2_free: bool,
                        n_starts: int = 1, skip=None,
                        max_iter: int = 60, init=None):
    """spinrelax_tpu_torch.fit.engine.fit_multiexp_engine as it was before its
    loop became a step function: a literal copy, the reference of
    test_step_function_equals_old_loop (its chain rule takes the engine's
    box map, fit.lm._sigmoid)."""
    dev, f = decay.device, decay.dtype
    dt = torch.as_tensor(dt, dtype=f, device=dev).contiguous()
    sigma = torch.as_tensor(sigma, dtype=f, device=dev)
    B, T = decay.shape
    P = cuda_lm.n_par(K, s2_free)
    tau_max = dt[-1] * 10.0

    # --- initialisation ------------------------------------------------
    # starts: (S, K) taus shared by every lane, or (1, B, K) per-row taus
    if init is not None:
        if n_starts != 1:
            raise ValueError("init gives one start per row: n_starts must be 1")
        C0, tau0_rows, S20 = (torch.as_tensor(a, dtype=f, device=dev) for a in init)
        starts = tau0_rows[None]
    else:
        C0, tau0_shared, S20 = teng._init_multiexp(dt, decay, K, s2_free)
        starts = tau0_shared[None]
    if n_starts > 1:
        # Deterministic extra starts drawn in float64 numpy, independent
        # of dtype and device (same draws as the JAX package).
        u = torch.as_tensor(
            np.random.default_rng(12345).uniform(size=(n_starts - 1, K)),
            dtype=f, device=dev,
        )
        step = torch.mean(dt[1:] - dt[:-1])
        lo_l, hi_l = torch.log(step * 0.5), torch.log(dt[-1] * 2.0)
        extra = torch.sort(torch.exp(lo_l + u * (hi_l - lo_l)), dim=1).values
        starts = torch.cat([starts, extra], dim=0)
    S = starts.shape[0]
    BS = B * S
    # start-major stacking: lane b, start s -> row s * B + b
    dec_s = decay.repeat(S, 1)
    sig_s = sigma.repeat(S, 1)
    C0_s = C0.repeat(S, 1)
    S20_s = S20.repeat(S)
    tau0_s = starts[0] if init is not None else starts.repeat_interleave(B, dim=0)
    if skip is None:
        done = torch.zeros(BS, dtype=torch.bool, device=dev)
    else:
        done = torch.as_tensor(skip, dtype=torch.bool, device=dev).repeat(S)

    p0 = torch.cat([C0_s, tau0_s] + ([S20_s[:, None]] if s2_free else []), dim=1)
    lo, hi = teng._bounds(K, s2_free, tau_max, f, dev)
    span = hi - lo

    # --- lag-major operands of the kernels ------------------------------
    y_t = dec_s.T.contiguous()
    isg_t = (1.0 / sig_s).T.contiguous()

    def pt_of_t(t):  # (BS, P) unconstrained -> (P, BS) constrained
        return teng._to_constrained(t, lo, hi).T.contiguous()

    eps = torch.finfo(f).eps
    ftol = 10.0 * eps
    xtol = 1e-10
    xtol_rel = float(np.sqrt(eps))
    stall_window = 8
    lam0 = 1e-3
    lam_stuck = 1e6

    t = teng._to_unconstrained(p0, lo, hi)
    lam = torch.full((BS,), lam0, dtype=f, device=dev)
    it = torch.zeros(BS, dtype=torch.int32, device=dev)
    c_best = torch.full((BS,), float("inf"), dtype=f, device=dev)
    c_mark = c_best.clone()
    eye = torch.eye(P, dtype=f, device=dev)

    while bool(torch.any((it < max_iter) & ~done)):
        H_p, g_p, c_old = cuda_lm.hgc(pt_of_t(t), y_t, isg_t, dt, K, s2_free)
        s = tlm._sigmoid(t)
        D = span * s * (1.0 - s)  # (BS, P) chain rule
        H = H_p * D[:, :, None] * D[:, None, :]
        g = g_p * D
        diag = torch.clamp(torch.diagonal(H, dim1=1, dim2=2), min=1e-12)
        A = H + lam[:, None, None] * eye * diag[:, None, :] * eye
        step_v = -tlm._chol_solve_small(A, g)
        t_new = t + step_v
        c_new = cuda_lm.cost(pt_of_t(t_new), y_t, isg_t, dt, K, s2_free)
        improved = (c_new < c_old) & torch.isfinite(c_new)
        t_next = torch.where(improved[:, None], t_new, t)
        lam_next = torch.where(improved, torch.clamp(lam * 0.33, min=1e-12),
                               torch.clamp(lam * 3.0, max=1e10))
        small = torch.amax(torch.abs(step_v), dim=1) < xtol
        flat = improved & ((c_old - c_new) <= ftol * c_old)
        small_rel = improved & (lam <= lam0) & (
            torch.linalg.vector_norm(step_v, dim=1)
            < xtol_rel * (xtol_rel + torch.linalg.vector_norm(t, dim=1))
        )
        c_best_next = torch.minimum(
            torch.minimum(c_best, torch.where(torch.isfinite(c_old), c_old, c_best)),
            torch.where(torch.isfinite(c_new), c_new, c_best),
        )
        at_window = (it + 1) % stall_window == 0
        stalled = (
            at_window & torch.isfinite(c_mark) & (lam_next <= 100.0 * lam0)
            & ((c_mark - c_best_next) <= stall_window * ftol * c_best_next)
        )
        c_mark = torch.where(at_window, c_best_next, c_mark)
        c_best = c_best_next
        done_next = (done | (improved & small) | flat | small_rel | stalled
                     | (lam_next >= lam_stuck))
        t = torch.where(done[:, None], t, t_next)
        lam = torch.where(done, lam, lam_next)
        it = torch.where(done, it, it + 1)
        done = done_next
    p_fin = teng._to_constrained(t, lo, hi)  # (BS, P)

    # --- covariance tail + finalisation ----------------------------------
    r_fin, Jp = teng._multiexp_res_jac(p_fin, dt, dec_s, sig_s, K, s2_free)
    cost_fin = 0.5 * torch.sum(r_fin * r_fin, dim=1)
    H = Jp.transpose(1, 2) @ Jp
    dof = max(T - P, 1)
    red_chisq = torch.sum(r_fin * r_fin, dim=1) / dof
    dead = torch.diagonal(H, dim1=1, dim2=2) == 0.0
    Hs = torch.where(dead[:, :, None] | dead[:, None, :], eye, H)
    var = torch.where(dead, torch.zeros_like(red_chisq)[:, None],
                      teng._spd_inv_diag_small(Hs)) * red_chisq[:, None]
    perr = torch.sqrt(torch.clamp(var, min=0.0))
    C = p_fin[:, :K]
    tau = p_fin[:, K : 2 * K]
    S2 = p_fin[:, -1] if s2_free else 1.0 - C.sum(dim=1)
    dS2 = perr[:, -1] if s2_free else torch.zeros_like(S2)
    fin = teng._finalise_multiexp(dt, dec_s, sig_s, C, tau, S2, perr[:, :K],
                             perr[:, K : 2 * K], dS2, C0_s, S20_s, s2_free)
    if S > 1:
        # best start per lane by final cost; ties keep the cold start.
        best = torch.argmin(cost_fin.reshape(S, B), dim=0)
        idx = best * B + torch.arange(B, device=dev)
        fin = tuple(a[idx] for a in fin)
    return teng.MultiExpFit(*fin)


_STEP_CASES = [dict(K=2, s2_free=True), dict(K=2, s2_free=True, n_starts=8),
               dict(K=1, s2_free=False, n_starts=3), dict(K=5, s2_free=True),
               dict(K=2, s2_free=True, skip=True), dict(K=2, s2_free=True, init=True),
               dict(K=3, s2_free=False, max_iter=7)]


def _step_case_args(rng, case, dtype):
    dt, y, sg = (a.astype(dtype) for a in _cohort(rng, B=48, T=120))
    kw = dict(case)
    if kw.pop("skip", False):
        kw["skip"] = torch.from_numpy(rng.uniform(size=48) < 0.4)
    if kw.pop("init", False):
        K = kw["K"]
        kw["init"] = _t(rng.uniform(0.02, 0.2, (48, K)).astype(dtype),
                        np.sort(rng.uniform(2, 300, (48, K)), axis=1).astype(dtype),
                        rng.uniform(0.5, 0.9, 48).astype(dtype))
    return _t(dt, y, sg), kw


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", _STEP_CASES, ids=lambda c: "-".join(f"{k}{v}" for k, v in c.items()))
def test_step_function_equals_old_loop(rng, case, dtype):
    """The engine's step function, run eagerly on the CPU, gives the old
    while loop's outputs bit for bit (NaN == NaN), and reports the steps
    it ran = the iterations of the slowest lane."""
    args, kw = _step_case_args(rng, case, dtype)
    info = {}
    new = teng.fit_multiexp_engine(*args, info=info, **kw)
    old = _old_engine(*args, **kw)
    for name, a, b in zip(new._fields, new, old):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(torch.nan_to_num(a.double(), nan=-7.0),
                           torch.nan_to_num(b.double(), nan=-7.0)), name
    assert info["steps"] == info["iterations"] <= kw.get("max_iter", 60)
    assert info["steps"] > 0


@pytest.mark.parametrize("case", _STEP_CASES, ids=lambda c: "-".join(f"{k}{v}" for k, v in c.items()))
def test_steps_past_the_last_live_lane_change_nothing(rng, case, monkeypatch):
    """Run on the card's schedule -- the host looks at the lanes once per
    stall window and the steps in between run regardless, to max_iter
    steps at most -- and then a window more: frozen lanes keep t, lam and
    it, so every output equals the eager loop's bit for bit."""
    args, kw = _step_case_args(rng, case, np.float32)
    want_info, ran = {}, {}
    want = teng.fit_multiexp_engine(*args, info=want_info, **kw)

    def windowed(step, live, max_iter, window):
        steps = 0
        while steps < max_iter:
            n = min(window - steps % window, max_iter - steps)
            for _ in range(n):
                step()
            steps += n
            if not bool(live):
                break
        for _ in range(window):  # past the end, and past max_iter
            step()
        ran["steps"] = steps + window
        return steps

    monkeypatch.setattr(teng, "_run_eager", windowed)
    info = {}
    got = teng.fit_multiexp_engine(*args, info=info, **kw)
    assert ran["steps"] > want_info["steps"]
    assert info["iterations"] == want_info["iterations"]
    assert info["steps"] >= want_info["steps"]
    for name, a, b in zip(got._fields, got, want):
        assert torch.equal(torch.nan_to_num(a.double(), nan=-7.0),
                           torch.nan_to_num(b.double(), nan=-7.0)), name
