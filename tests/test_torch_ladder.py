"""The port's DoF ladder (fit.expfit.fit_ct_ladder over fit.walk and the
LM engine) against the JAX package's on the CPU, on the same seeded numpy
inputs, and the two K-limit repairs (kernels B/C past K = 4, the unrolled
small solves at P = 33).

On the CPU the JAX ladder is its vmapped float64 XLA walk, and the port's
engine evaluates every LM iteration with the plain versions of kernels B
and C (float64).  Kernels B and C themselves run only on the GPU
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import os

import jax
import numpy as np
import pytest
import torch

from spinrelax_tpu.fit import lm as jlm
from spinrelax_tpu.fit.expfit import fit_ct_ladder as jax_ladder
from spinrelax_tpu_torch.entry import hetero_cohort
from spinrelax_tpu_torch.fit import lm as tlm
from spinrelax_tpu_torch.fit.expfit import LADDER_NO_FAST, LADDER_WITH_FAST, fit_ct_ladder
from spinrelax_tpu_torch.ops import cuda_lm

B, T = 96, 400  # tests/test_walk.py's _hetero cohort size
OUTLIER_ROWS = [14, 17, 20, 26]  # the escalation cohort's shrunk-sigma rows


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_state():
    """Clear jax's compiled-program caches before this module (see
    tests/test_review_fixes_r3.py); two torch threads per xdist worker."""
    jax.clear_caches()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(2)


def _escalation_cohort():
    """entry.hetero_cohort (seed 0) with two kinds of rows the ladder's
    escalation targets.  Rows 0-11: 4 low-noise components at tau ~ 1, 3,
    9, 27, whose cold K = 4 fit collapses components and fails the quality
    gates, so the warm retry from the K = 3 fit can rescue them.  The
    OUTLIER_ROWS: sigmas shrunk 20x, so their chisq is a > 5x-median
    outlier for the multi-start refit."""
    rng = np.random.default_rng(0)
    dt, y, dy = hetero_cohort(B, T, rng)
    for b in range(12):
        tau = np.array([1.0, 3.0, 9.0, 27.0]) * rng.uniform(0.9, 1.1, 4)
        y[b] = 0.55 + (0.1 * np.exp(-dt / tau[:, None])).sum(0) \
            + rng.normal(scale=1e-5, size=dt.size)
        dy[b] = 1e-5
    dy[OUTLIER_ROWS] /= 20.0
    return dt, y, dy


_COHORTS = {"hetero": lambda: hetero_cohort(B, T), "escalation": _escalation_cohort}


@pytest.fixture(scope="module")
def ladders():
    """ladders(cohort, port_only=False, weighted=False, **options) ->
    (JAX ladder or None, port ladder, dt), each computed once per module,
    so the flag-surface cases and the adoption checks share them."""
    cache = {}

    def get(cohort, port_only=False, weighted=False, **kw):
        key = (cohort, port_only, weighted, tuple(sorted(kw.items())))
        if key not in cache:
            dt, y, dy = _COHORTS[cohort]()
            sig = dy if weighted else None
            names = [str(i) for i in range(y.shape[0])]
            j = None if port_only else jax_ladder(names, dt, y, sig, **kw)
            cache[key] = (j, fit_ct_ladder(names, dt, y, sig, device="cpu", **kw), dt)
        return cache[key]

    return get


def _np(cts, f):
    v = getattr(cts, f)
    return v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def _assert_ladders_agree(j, t, dt, skip=()):
    """Selection equal; chisq to rtol 1e-6 on every row (but the rows in
    ``skip``: JAX_BATCH_ROWS, held to JAX otherwise); S2, C, tau to
    rtol 1e-6 and dS2, dC, dtau to 1e-5 on the rows whose parameters the
    data determine.  The engine and the JAX XLA LM agree to 1e-8 in
    float64 on well-posed fits (tests/test_torch_lm.py), but a row whose selected fit fails the reference's
    own dParam > Param check, or holds a component the data cannot see (C
    below 1e-12, or exp(-dt[0] / tau) below 1e-10: a component faster than
    the first lag), lies in a flat valley of its cost: both optimisers
    stop at the same chisq (held on every row) at parameters that differ
    by their rounding (up to swapped components); their fitted C(t)
    curves still agree (held on every row to 1e-6).  Returns the rows held
    to the tight bounds."""
    keep = np.ones(len(t.names), bool)
    keep[list(skip)] = False
    for f in ("mask", "s2fast"):
        np.testing.assert_array_equal(_np(t, f)[keep], _np(j, f)[keep], err_msg=f)
    assert t.names == list(j.names)
    np.testing.assert_allclose(_np(t, "chisq")[keep], _np(j, "chisq")[keep], rtol=1e-6)
    C, tau, S2 = _np(j, "C"), _np(j, "tau"), _np(j, "S2")
    real = _np(j, "mask") > 0
    curve = S2[:, None] + ((C * real)[:, :, None] * np.exp(-dt / tau[:, :, None])).sum(1)
    np.testing.assert_allclose(t.eval(dt).numpy()[keep], curve[keep], rtol=0, atol=1e-6)
    rows = _determined(C, tau, S2, _np(j, "dC"), _np(j, "dtau"), _np(j, "dS2"), real, dt)
    rows &= keep
    for f in ("S2", "C", "tau"):
        np.testing.assert_allclose(_np(t, f)[rows], _np(j, f)[rows], rtol=1e-6, err_msg=f)
    for f in ("dS2", "dC", "dtau"):
        np.testing.assert_allclose(_np(t, f)[rows], _np(j, f)[rows], rtol=1e-5, err_msg=f)
    return rows


def _determined(C, tau, S2, dC, dtau, dS2, real, dt):
    """Rows that pass the reference's dParam > Param check and whose every
    component the data can see (see _assert_ladders_agree)."""
    seen = ~real | ((C > 1e-12) & (np.exp(-dt[0] / tau) > 1e-10))
    gate = (np.isfinite(dC).all(1) & np.isfinite(dtau).all(1) & np.isfinite(dS2)
            & (dC <= C).all(1) & (dtau <= tau).all(1) & (dS2 <= S2))
    return seen.all(1) & gate


@pytest.mark.parametrize("kw", [
    dict(),
    dict(weighted=True),
    dict(weighted=True, use_s2fast=False),
    dict(weighted=True, n_starts=4),
    dict(warm_retry=False, retry_starts=1),
    dict(weighted=True, chisq_threshold=0.9),
    dict(weighted=True, n_components=2),
    dict(weighted=True, n_components=5),
])
def test_ladder_matches_jax(ladders, kw):
    """entry.hetero_cohort, tests/test_walk.py's _hetero cohort (B = 96,
    T = 400), across its flag surface, plus n_components = 5 (K = 5: past
    the K <= 4 the card kernels took before): the port selects the JAX
    rung on every row but the one named in JAX_BATCH_ROWS.

    The cohort's seed is pinned (0), not the suite's: at the suite's seed
    one row (23, use_s2fast=False) is decided by JAX's batch size, not by
    the data (test_suite_seed_row_23_gate_depends_on_jax_batch)."""
    j, t, dt = ladders("hetero", **kw)
    differ = np.nonzero((_np(t, "mask") != _np(j, "mask")).any(1)
                        | (_np(t, "s2fast") != _np(j, "s2fast")))[0]
    known = JAX_BATCH_ROWS.get(tuple(sorted(kw.items())))
    assert differ.tolist() == ([] if known is None else [known["row"]]), differ
    if known is not None:
        _assert_row_held_to_jax_alone(kw, known, t, dt)
    rows = _assert_ladders_agree(j, t, dt, skip=differ)
    if "n_components" not in kw:  # a forced K overfits most of this cohort
        assert rows.mean() > 0.5
    assert t.C.dtype == torch.float64 and t.C.device.type == "cpu"


def _cold_escalation(ladders):
    """The port's escalation-cohort ladder with no escalation at all."""
    return ladders("escalation", port_only=True, weighted=True, warm_retry=False,
                   retry_starts=1)[1]


def test_warm_retry_adoption_matches_jax(ladders):
    """The escalation cohort with the warm retry alone (retry_starts=1):
    the retry is adopted (asserted: the port's ladder selects another rung
    on some row than the same ladder without escalation), held to JAX."""
    j, t, dt = ladders("escalation", weighted=True, warm_retry=True, retry_starts=1)
    assert (t.mask.sum(1) != _cold_escalation(ladders).mask.sum(1)).sum() >= 1
    _assert_ladders_agree(j, t, dt)


def test_chisq_outlier_refit_matches_jax(ladders):
    """The escalation cohort with the chisq-outlier 8-start refit alone
    (warm_retry=False): the refit is adopted on its OUTLIER_ROWS
    (asserted against the ladder without escalation: lower chisq, and no
    row's rung changes), held to JAX."""
    j, t, dt = ladders("escalation", weighted=True, warm_retry=False, retry_starts=8)
    cold = _cold_escalation(ladders)
    assert torch.equal(t.mask, cold.mask)  # the refit never changes selection
    assert (t.chisq[OUTLIER_ROWS] < cold.chisq[OUTLIER_ROWS]).sum() >= 1
    _assert_ladders_agree(j, t, dt)


def _gates(f, i):
    return tuple(bool(np.asarray(g[i])) for g in (f.ok_fit, f.ok_err, f.ok_sum))


# The one row of test_ladder_matches_jax's seed-0 cohort whose rung JAX's
# batch decides, not its data, with the (ok_fit, ok_err, ok_sum) gates of
# JAX's 8-start fit of the row at the port's rung, alone and among the
# cohort's 96 lanes.  Alone the fit passes; in the batch its fastest tau
# stops at 1.3e-2 instead of 1.7e-7 and its error estimate fails ok_err,
# so JAX's ladder stays at K = 2.  The port's lanes do not depend on their
# batch (fit.engine's box map, fit.lm._sigmoid), so it takes K = 3, as
# JAX's fit of the row alone would.
JAX_BATCH_ROWS = {
    (("use_s2fast", False), ("weighted", True)): dict(
        row=11, K=3, s2_free=False, jax_alone=(True, True, True),
        jax_batch=(True, False, True)),
}


def _assert_row_held_to_jax_alone(kw, known, t, dt):
    """The JAX_BATCH_ROWS row of the port's ladder ``t``: at the rung
    named there, JAX's multi-start fit of the row reads the recorded gates
    alone and in the cohort, the port's passes them both ways, and the
    port's selected fit is held to JAX's fit of the row alone as every
    other row is held to JAX's ladder (chisq rtol 1e-6, curve atol 1e-6,
    parameters where the data determine them)."""
    r, K, s2f = known["row"], known["K"], known["s2_free"]
    assert (int(_np(t, "mask")[r].sum()), bool(_np(t, "s2fast")[r])) == (K, s2f)
    _, y, dy = hetero_cohort(B, T)
    sig = dy if kw.get("weighted") else np.ones_like(y)
    ns = kw.get("retry_starts", 8)
    alone = jlm.fit_multiexp(dt, y[r:r + 1], sig[r:r + 1], K=K, s2_free=s2f, n_starts=ns)
    batch = jlm.fit_multiexp(dt, y, sig, K=K, s2_free=s2f, n_starts=ns)
    assert (_gates(alone, 0), _gates(batch, r)) == (known["jax_alone"], known["jax_batch"])
    tt = [torch.from_numpy(a) for a in (dt, y, sig)]
    p_alone = tlm.fit_multiexp(tt[0], tt[1][r:r + 1], tt[2][r:r + 1], K=K, s2_free=s2f,
                               n_starts=ns)
    p_batch = tlm.fit_multiexp(*tt, K=K, s2_free=s2f, n_starts=ns)
    assert all(_gates(p_alone, 0)) and all(_gates(p_batch, r))

    S2, C, tau = (np.asarray(getattr(alone, f))[:1] for f in ("S2", "C", "tau"))
    real = np.ones_like(C, bool)
    np.testing.assert_allclose(float(_np(t, "chisq")[r]), float(alone.chisq[0]), rtol=1e-6)
    curve = S2[0] + (C[0][:, None] * np.exp(-dt / tau[0][:, None])).sum(0)
    np.testing.assert_allclose(t.eval(dt).numpy()[r], curve, rtol=0, atol=1e-6)
    dC, dtau, dS2 = (np.asarray(getattr(alone, f))[:1] for f in ("dC", "dtau", "dS2"))
    if _determined(C, tau, S2, dC, dtau, dS2, real, dt)[0]:
        for f, want in (("S2", S2[0]), ("C", C[0]), ("tau", tau[0])):
            np.testing.assert_allclose(np.atleast_1d(_np(t, f)[r])[:K], want, rtol=1e-6,
                                       err_msg=f)
        for f, want in (("dS2", dS2[0]), ("dC", dC[0]), ("dtau", dtau[0])):
            np.testing.assert_allclose(np.atleast_1d(_np(t, f)[r])[:K], want, rtol=1e-5,
                                       err_msg=f)


def test_suite_seed_row_23_gate_depends_on_jax_batch():
    """Why test_ladder_matches_jax pins its cohort's seed.  At the suite's
    seed (tests/conftest.py), row 23 of the cohort, at the use_s2fast=False
    ladder's K = 3 rung, holds a component faster than the first lag.  Its
    8-start fit either drives that tau low enough that exp(-t / tau)
    underflows to exactly 0 (a dead Jacobian column: zero variance, gate
    passed) or stops just above (a huge variance, gate failed).  JAX
    decides it both ways with the batch the row is fitted in: alone, the
    gate fails; inside the cohort's 96 lanes, it passes.  The port's lanes
    do not depend on their batch (fit.engine's box map, fit.lm._sigmoid;
    problem-major sums in kernels B and C's plain versions), so its
    escalation, which fits only the rows it targets, decides the row as
    the cohort's batch does, at JAX's chisq."""
    dt, y, dy = hetero_cohort(B, T, np.random.default_rng(20260816))
    r = 23

    def gate(f, i):
        return bool(np.asarray(f.ok_fit[i] & f.ok_err[i] & f.ok_sum[i]))

    alone = jlm.fit_multiexp(dt, y[r:r + 1], dy[r:r + 1], K=3, s2_free=False, n_starts=8)
    batch = jlm.fit_multiexp(dt, y, dy, K=3, s2_free=False, n_starts=8)
    assert not gate(alone, 0) and gate(batch, r)
    # the two solutions fit the data alike; they differ in the dead tau
    np.testing.assert_allclose(float(alone.chisq[0]), float(batch.chisq[r]), rtol=1e-6)
    port = tlm.fit_multiexp(*(torch.from_numpy(a) for a in (dt, y[r:r + 1], dy[r:r + 1])),
                            K=3, s2_free=False, n_starts=8)
    in_batch = tlm.fit_multiexp(*(torch.from_numpy(a) for a in (dt, y, dy)),
                                K=3, s2_free=False, n_starts=8)
    assert gate(port, 0) == gate(in_batch, r)
    for f in port._fields:
        torch.testing.assert_close(getattr(port, f)[0], getattr(in_batch, f)[r], rtol=0,
                                   atol=0, equal_nan=True, msg=f)
    np.testing.assert_allclose(float(port.chisq[0]), float(alone.chisq[0]), rtol=1e-6)


def test_warm_fit_matches_jax(rng):
    """fit_multiexp_warm (the engine from per-row starts) against JAX's
    vmapped warm fit in float64 on two-timescale decays, from starts
    scattered around the truth: flags equal, chisq on every row and
    parameters on the determined rows to 1e-6."""
    B, T, K = 24, 200, 2
    dt = np.arange(1, T + 1, dtype=float)
    C = rng.uniform(0.05, 0.2, (B, K))
    tau = np.stack([rng.uniform(3, 20, B), rng.uniform(60, 400, B)], axis=1)
    S2 = 1.0 - C.sum(1) - rng.uniform(0.0, 0.1, B)
    y = S2[:, None] + (C[:, :, None] * np.exp(-dt / tau[:, :, None])).sum(1) \
        + rng.normal(scale=2e-3, size=(B, T))
    dy = np.full_like(y, 2e-3)
    C0, tau0 = C * rng.uniform(0.5, 1.5, (B, K)), tau * rng.uniform(0.5, 2.0, (B, K))
    S20 = 1.0 - C0.sum(1) - 0.05
    for s2f in (False, True):
        j = jlm.fit_multiexp_warm(dt, y, dy, C0, tau0, S20, K=K, s2_free=s2f)
        t = tlm.fit_multiexp_warm(*(torch.from_numpy(a) for a in (dt, y, dy, C0, tau0, S20)),
                                  K=K, s2_free=s2f)
        for f in ("ok_fit", "ok_err", "ok_sum"):
            np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)))
        np.testing.assert_allclose(t.chisq.numpy(), np.asarray(j.chisq), rtol=1e-6)
        jv = {f: np.asarray(getattr(j, f)) for f in ("C", "tau", "S2", "dC", "dtau", "dS2")}
        rows = _determined(jv["C"], jv["tau"], jv["S2"], jv["dC"], jv["dtau"], jv["dS2"],
                           np.ones_like(jv["C"], bool), dt)
        assert rows.sum() >= B // 2
        for f in ("C", "tau", "S2"):
            np.testing.assert_allclose(getattr(t, f).numpy()[rows], jv[f][rows], rtol=1e-6,
                                       err_msg=f)


def test_ladders_and_rung_spec():
    assert LADDER_WITH_FAST == (2, 3, 5, 7, 9) and LADDER_NO_FAST == (2, 4, 6, 8)
    from spinrelax_tpu.fit import expfit as jex
    from spinrelax_tpu_torch.fit import expfit as tex

    for n in range(1, 34):
        assert tex._rung_spec(n) == jex._rung_spec(n)
    for chi in (np.array([1.0, 1.1, 0.9, 9.0]), np.array([np.inf, 1.0, np.nan, 6.0]),
                np.full(4, np.inf), np.zeros(3)):
        np.testing.assert_array_equal(tex._chisq_outlier_rows(chi, 256),
                                      jex._chisq_outlier_rows(chi, 256))
    assert not tex._chisq_outlier_rows(np.r_[np.ones(10), 9.0, 9.0], 1).any()


def test_ladder_refuses_unported_options():
    """pipeline_rungs (a relay hook, not ported on purpose) raises naming
    ROADMAP; varpro and stacked run (tests/test_torch_lm_generic.py), and
    so does mesh= (a one-rank gloo mesh here, the same CtModelSet bit for
    bit; 4 and 8 ranks in tests/test_torch_parallel_cli.py)."""
    from spinrelax_tpu_torch.parallel import launch
    from spinrelax_tpu_torch.parallel.mesh import make_mesh

    dt, y = np.arange(1.0, 9.0), np.ones((2, 8))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fit_ct_ladder(["0", "1"], dt, y, device="cpu", pipeline_rungs=True)
    dt, y, sg = hetero_cohort(12, 60, np.random.default_rng(5))
    want = fit_ct_ladder([str(i) for i in range(12)], dt, y, sg, device="cpu")
    try:
        got = fit_ct_ladder([str(i) for i in range(12)], dt, y, sg, device="cpu",
                            mesh=make_mesh(1, device="cpu"))
    finally:
        launch.stop()
    for f in ("S2", "C", "tau", "mask", "dS2", "dC", "dtau", "chisq", "s2fast"):
        torch.testing.assert_close(getattr(got, f), getattr(want, f), rtol=0, atol=0,
                                   equal_nan=True, msg=f)
    with pytest.raises(ValueError, match="unknown optimiser"):
        fit_ct_ladder(["0", "1"], dt, y, device="cpu", optimiser="bfgs")


def test_ladder_trace_records_every_lm_call():
    """fit_ct_ladder(trace=[]) records each LM call in order: one per rung
    over the rows still walking (the first over all rows, none growing),
    then the escalation's calls; on the CPU no kernel launches."""
    dt, y, dy = hetero_cohort(12, 60)
    trace = []
    fit_ct_ladder([str(i) for i in range(12)], dt, y, dy, device="cpu", trace=trace)
    rungs = [c for c in trace if c["stage"] == "rung"]
    assert [(c["K"], c["s2_free"]) for c in rungs] == [(1, False), (1, True), (2, True),
                                                       (3, True), (4, True)][:len(rungs)]
    assert rungs[0]["rows"] == 12
    assert all(a["rows"] >= b["rows"] for a, b in zip(rungs, rungs[1:]))
    assert trace[:len(rungs)] == rungs
    assert {c["stage"] for c in trace} <= {"rung", "warm", "multistart", "resume", "outlier"}
    assert all(c["launches_B"] == c["launches_C"] == 0 for c in trace)


def test_ladder_numpy_input_defaults_to_the_card():
    """Numpy input goes to the card unless device="cpu"; without one the
    call raises rather than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fit_ct_ladder(["0"], np.arange(1.0, 9.0), np.ones((1, 8)))


@pytest.mark.parametrize("s2f", [False, True])
def test_lm_kernels_take_k_up_to_16(s2f):
    """Kernels B and C's shape check takes every K = 1..16 (P <= 33) and
    refuses K = 17 with the limit in its message (the check alone: CPU
    tensors of the shapes the kernels get)."""
    T, B = 7, 5
    y = torch.zeros((T, B))
    dt = torch.ones(T)
    for K in range(1, cuda_lm.K_MAX + 1):
        p = torch.zeros((cuda_lm.n_par(K, s2f), B))
        assert cuda_lm.check_shapes("hgc", p, y, y, dt, K, s2f) == (T, B)
    assert cuda_lm.K_MAX == 16
    with pytest.raises(ValueError, match="K = 1..16"):
        cuda_lm.check_shapes("hgc", torch.zeros((34 + s2f, B)), y, y, dt, 17, s2f)
    with pytest.raises(ValueError, match="do not match"):
        cuda_lm.check_shapes("cost", torch.zeros((10, B)), y, y, dt, 5, True)


@pytest.mark.parametrize("P", [9, 17, 33])
def test_small_solves_up_to_p33(P):
    """The unrolled Cholesky solve and inverse diagonal of the LM hold at
    P = 33 (K = 16, S2 free) against torch.linalg in float64."""
    g = torch.Generator().manual_seed(P)
    M = torch.randn((6, P, P), generator=g, dtype=torch.float64)
    A = M @ M.transpose(1, 2) + P * torch.eye(P, dtype=torch.float64)
    b = torch.randn((6, P), generator=g, dtype=torch.float64)
    x = tlm._chol_solve_small(A, b)
    torch.testing.assert_close(x, torch.linalg.solve(A, b), rtol=1e-10, atol=1e-12)
    d = tlm._spd_inv_diag_small(A)
    torch.testing.assert_close(d, torch.diagonal(torch.linalg.inv(A), dim1=1, dim2=2),
                               rtol=1e-10, atol=1e-12)
