"""spinrelax_tpu_torch.ops.autocorr against spinrelax_tpu.ops.autocorr on
the CPU: the same seeded numpy inputs through both packages.

On a CPU tensor the port's ACF dispatcher runs kernel A's plain version
(the FFT form), so these tests hold that plain version, and the Palmer
statistics around it, to the JAX functions.  Kernel A itself runs only on
the GPU (chip_smoke.py, tests/test_torch_cuda.py).
"""

import contextlib
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spinrelax_tpu.ops import autocorr as jac
from spinrelax_tpu.ops import pallas_acf
from spinrelax_tpu_torch.convert import palmer_state_from_numpy
from spinrelax_tpu_torch.ops import autocorr as tac
from spinrelax_tpu_torch.ops import cuda_acf


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_state():
    """Clear jax's compiled-program caches before this module (the guard
    against the XLA:CPU JIT crash after many tests in one process, as in
    tests/test_review_fixes_r3.py), and keep torch to two threads per
    xdist worker."""
    jax.clear_caches()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(2)


@contextlib.contextmanager
def interpreted_pallas():
    """Force pallas_call into interpret mode (as tests/test_pallas.py)."""
    from jax.experimental import pallas as pl

    real_call = pl.pallas_call

    def interp_call(*args, **kw):
        kw["interpret"] = True
        return real_call(*args, **kw)

    with mock.patch.object(pallas_acf.pl, "pallas_call", interp_call):
        yield


def unit_vecs(rng, shape, dtype=np.float64):
    v = rng.normal(size=shape + (3,))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(dtype)


def test_pair_constants_match():
    assert tac._PAIR_I == jac._PAIR_I
    assert tac._PAIR_J == jac._PAIR_J
    assert tac._PAIR_W == jac._PAIR_W


@pytest.mark.parametrize("n", [2, 96, 150, 1500, 3001])
def test_fft_len_matches(n):
    assert tac._fft_len(n) == jac._fft_len(n)


# F = 64 and F = 100 put the JAX DFT split at F % N2 == 0 (the shape
# class behind a hardware-only bug in the TPU kernel); odd F and a
# ragged bond count cover the rest.
@pytest.mark.parametrize("B,F", [(32, 100), (7, 64), (5, 101), (3, 1000)])
def test_acf_sums_plain_matches_jax_f64(rng, B, F):
    """Both JAX formulations in f64.  Tolerance 1e-10 on the lag mean
    s / (F - d) (the scale of C(t)): the f64 FFT/DFT forms differ in
    rounding only (measured <= 5e-14)."""
    v = unit_vecs(rng, (B, F))
    D = F // 2
    n = F - np.arange(1, D + 1)
    got = tac.acf_sums_plain(torch.from_numpy(v), D).numpy()
    for ref_fn in (jac._acf_sums_fft, jac._acf_sums_xla):
        ref = np.asarray(ref_fn(jnp.asarray(v), D))
        np.testing.assert_allclose(got / n, ref / n, rtol=0, atol=1e-10)


def test_acf_sums_plain_matches_pallas_interpret_f32(rng):
    """The TPU kernel A (interpret mode, f32, its production compensated
    bf16 mode) at F = 100, B = 32.  Tolerance 2e-6 on s / (F - d): the TPU
    kernel's recorded error is ~1e-6 on C(t) = -0.5 + 1.5 s/(F - d)."""
    v = unit_vecs(rng, (32, 100), np.float32)
    D = 50
    n = 100 - np.arange(1, D + 1)
    with interpreted_pallas():
        ref = np.asarray(pallas_acf.acf_sums_pallas(jnp.asarray(v), D))
    got = tac.acf_sums_plain(torch.from_numpy(v), D).numpy()
    np.testing.assert_allclose(got / n, ref / n, rtol=0, atol=2e-6)


def test_acf_sums_dispatch_cpu_runs_plain(rng):
    """A CPU tensor goes to the plain version (no kernel launch), in
    both output orientations; the kernel wrapper refuses CPU tensors."""
    v = torch.from_numpy(unit_vecs(rng, (3, 5, 40), np.float32))
    before = cuda_acf.acf_lag_sums.launches
    s = tac.acf_sums(v, 20)
    lag = tac.acf_sums(v, 20, lag_major=True)
    assert cuda_acf.acf_lag_sums.launches == before
    assert s.shape == (3, 5, 20) and lag.shape == (20, 15)
    torch.testing.assert_close(lag, s.reshape(15, 20).T, rtol=0, atol=0)
    with pytest.raises(ValueError):
        cuda_acf.acf_lag_sums(v.transpose(0, 1)[None], 20)


def test_kernel_shape_guard():
    """supports() reads launch_plan(): 1 <= D < F; one bond's planes in
    227 KB of shared memory take the block plan, longer chunks the slab
    plan; the plans' constants mirror the C source's."""
    src = open(os.path.join(os.path.dirname(cuda_acf.__file__), "..", "csrc",
                            "acf_lag_sums.cu")).read()
    assert f"constexpr int LAGS = {cuda_acf.LAGS};" in src
    assert f"constexpr int TBLK = {cuda_acf.TBLK};" in src
    assert f"constexpr int NB_MAX = {cuda_acf.NB_MAX};" in src
    assert f"constexpr int MAX_THREADS = {cuda_acf.MAX_THREADS};" in src
    assert f"constexpr int MAX_SMEM = {cuda_acf.MAX_SMEM_BYTES};" in src
    assert f"constexpr int SLAB_THREADS = {cuda_acf.SLAB_THREADS};" in src
    assert f"constexpr int SLAB = {cuda_acf.SLAB};" in src
    assert cuda_acf.supports(1000, 500)
    assert cuda_acf.supports(64, 32)
    assert cuda_acf.supports(18000, 9000)
    assert isinstance(cuda_acf.launch_plan(18743, 9371), cuda_acf.LaunchPlan)
    assert isinstance(cuda_acf.launch_plan(19000, 9500), cuda_acf.SlabPlan)
    assert cuda_acf.supports(19000, 9500)
    assert not cuda_acf.supports(10, 10)
    assert not cuda_acf.supports(10, 0)
    # The forward's shape: one warp per bond, 4 bonds per block.
    assert cuda_acf.launch_plan(1000, 500) == (4, 128, 4 * (8 + 12 * 1073))


@pytest.mark.parametrize("F,D", [(18744, 9372), (20000, 10000), (40001, 20000),
                                 (100000, 50000), (20000, 37), (30000, 29999)])
def test_slab_plan_takes_long_chunks(F, D):
    """Past one block's shared memory every 1 <= D < F still has a plan
    (the slab plan), within the grid's 65 535 lag blocks; the plan's
    shared bytes and partner words mirror the C source's formulas."""
    plan = cuda_acf.launch_plan(F, D)
    assert isinstance(plan, cuda_acf.SlabPlan) and cuda_acf.supports(F, D)
    n = cuda_acf.SLAB + cuda_acf.SLAB_LAGS
    assert cuda_acf.slab_partner_words() == n + n // 32 + 1
    assert plan == (cuda_acf.SLAB_THREADS, cuda_acf.SLAB,
                    3 * (cuda_acf.SLAB + cuda_acf.slab_partner_words()) * 4)
    assert plan.smem_bytes <= 48 * 1024  # no opt-in attribute needed
    assert -(-D // cuda_acf.SLAB_LAGS) <= 65_535
    assert cuda_acf.SLAB % cuda_acf.TBLK == 0


def test_slab_plan_index_model(rng):
    """An index-exact numpy model of the slab kernel's reads (slabs of SLAB
    frames, partner slab from t0 + d0, register windows of LAGS lags,
    zero past F) gives the lag sums of the direct definition, at shrunken
    constants that force several slabs and lag blocks."""
    SLAB, LAGS, NT = 16, 4, 3  # frames per slab, lags per thread, threads
    F, D = 70, 40
    v = unit_vecs(rng, (F,))
    out = np.zeros(D)
    for d0 in range(1, D + 1, LAGS * NT):
        for t0 in range(0, F - d0, SLAB):
            a = np.zeros((SLAB, 3))
            part = v[t0 : t0 + SLAB]
            a[: len(part)] = part
            bpl = np.zeros((SLAB + LAGS * NT, 3))
            part = v[t0 + d0 : t0 + d0 + SLAB + LAGS * NT]
            bpl[: len(part)] = part
            for tid in range(NT):
                for k in range(LAGS):
                    lag = d0 + LAGS * tid + k
                    if lag <= D:
                        off = LAGS * tid + k
                        out[lag - 1] += np.sum(
                            np.einsum("uc,uc->u", a, bpl[off : off + SLAB]) ** 2)
    ref = np.array([np.sum(np.einsum("tc,tc->t", v[: F - d], v[d:]) ** 2)
                    for d in range(1, D + 1)])
    np.testing.assert_allclose(out, ref, rtol=1e-12)


@pytest.mark.parametrize("F,D", [(2, 1), (64, 32), (101, 50), (1000, 37),
                                 (1000, 500), (4097, 2048), (18000, 9000)])
def test_kernel_launch_plan_and_fold(F, D):
    """The plan fits one block (shared memory, threads in whole warps);
    the folded schedule gives every lag 1..D to exactly one (thread,
    window); threads owning two windows walk frame counts (whole TBLK
    blocks) within 2 x TBLK of each other."""
    nb, threads, smem = cuda_acf.launch_plan(F, D)
    assert smem <= cuda_acf.MAX_SMEM_BYTES
    assert 32 <= threads <= 1024 and threads % 32 == 0
    assert nb >= 1 and threads % nb == 0 and (threads // nb) % 32 == 0
    sched = cuda_acf.fold_schedule(F, D)
    owners = {}
    for j, r, lag0s in sched:
        assert j < threads // nb
        for lag0 in lag0s:
            for d in range(lag0, min(lag0 + cuda_acf.LAGS, D + 1)):
                assert d not in owners, (d, owners[d], (j, r))
                owners[d] = (j, r)
    assert sorted(owners) == list(range(1, D + 1))
    tb = cuda_acf.TBLK
    walks = [sum(-(-(F - lag0) // tb) * tb for lag0 in lag0s)
             for _, _, lag0s in sched if len(lag0s) == 2]
    if walks:
        assert max(walks) - min(walks) <= 2 * tb


@pytest.mark.parametrize("n_rep", [1, 3, 6])
def test_ct_palmer_matches_jax_f64(rng, n_rep):
    """Ct/dCt equal JAX ct_palmer (1e-12), including the population std,
    the sqrt(n) - 1 SEM and NaN dCt for one chunk."""
    v = unit_vecs(rng, (n_rep, 80, 9))
    Ct_j, dCt_j = jac.ct_palmer(jnp.asarray(v))
    Ct, dCt = tac.ct_palmer(torch.from_numpy(v))
    np.testing.assert_allclose(Ct.numpy(), np.asarray(Ct_j), rtol=0, atol=1e-12)
    np.testing.assert_allclose(dCt.numpy(), np.asarray(dCt_j), rtol=1e-10,
                               atol=1e-13, equal_nan=True)
    assert np.isnan(dCt.numpy()).all() == (n_rep == 1)


def test_ct_palmer_matches_direct_lag_loop(rng):
    """An oracle independent of the FFT: the JAX O(N^2) lag loop."""
    v = unit_vecs(rng, (4, 60, 5))
    Ct_j, dCt_j = jac.ct_palmer_direct(jnp.asarray(v))
    Ct, dCt = tac.ct_palmer(torch.from_numpy(v))
    np.testing.assert_allclose(Ct.numpy(), np.asarray(Ct_j), rtol=0, atol=1e-12)
    np.testing.assert_allclose(dCt.numpy(), np.asarray(dCt_j), rtol=1e-9,
                               atol=1e-13)


@pytest.mark.parametrize("count", [1.0, 2.0, 17.0])
def test_palmer_pooled_stats_matches_jax(rng, count):
    """Exact formula port, f64 (1e-14); NaN dCt at count 1."""
    acc_s = rng.normal(size=(12, 4)) * count
    acc_s2 = acc_s**2 / count + rng.uniform(0, 0.1, size=(12, 4))
    m_j, d_j = jac.palmer_pooled_stats(jnp.asarray(acc_s), jnp.asarray(acc_s2), count)
    m, d = tac.palmer_pooled_stats(torch.from_numpy(acc_s), torch.from_numpy(acc_s2), count)
    np.testing.assert_allclose(m.numpy(), np.asarray(m_j), rtol=1e-14)
    np.testing.assert_allclose(d.numpy(), np.asarray(d_j), rtol=1e-14, equal_nan=True)
    assert np.isnan(d.numpy()).all() == (count == 1.0)


@pytest.mark.parametrize("g,n_res", [(2, 64), (3, 50), (1, 7)])
def test_tile_palmer_group_matches_jax(rng, g, n_res):
    """Pure layout: bitwise equal, zero pad lanes included."""
    grp = unit_vecs(rng, (g, 30, n_res))
    ref = np.asarray(jac.tile_palmer_group(jnp.asarray(grp)))
    got = tac.tile_palmer_group(torch.from_numpy(grp)).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("g,n_res", [(2, 64), (3, 50)])
def test_palmer_group_update_pretiled_matches_jax(rng, g, n_res):
    """One group step from nonzero accumulators, f64, ragged lane counts
    (3 x 50 = 150 of 256 lanes).  Tolerance 1e-12: same formula, FFT
    rounding only."""
    F = 70
    D = F // 2
    grp = unit_vecs(rng, (g, F, n_res))
    acc_s = rng.normal(size=(D, n_res))
    acc_s2 = rng.uniform(0, 1, size=(D, n_res))
    vt_j = jac.tile_palmer_group(jnp.asarray(grp))
    ref = jac.palmer_group_update_pretiled(vt_j, jnp.asarray(acc_s),
                                           jnp.asarray(acc_s2), g, n_res)
    vt = tac.tile_palmer_group(torch.from_numpy(grp))
    got = tac.palmer_group_update_pretiled(vt, torch.from_numpy(acc_s),
                                           torch.from_numpy(acc_s2), g, n_res)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-12)


def test_palmer_group_update_pretiled_capacity_raises(rng):
    vt = torch.zeros((1, 3, 20, 128), dtype=torch.float64)
    acc = torch.zeros((10, 65), dtype=torch.float64)
    with pytest.raises(ValueError, match="exceeds tile capacity"):
        tac.palmer_group_update_pretiled(vt, acc, acc, 2, 65)


def test_stream_state_carries_over_from_jax(rng):
    """Half the groups accumulate in JAX, the rest in the port from
    palmer_state_from_numpy; the pooled result equals an all-JAX stream
    and an all-port stream (f64, 1e-12)."""
    F, n_res, groups = 50, 20, [3, 2, 4, 1]
    D = F // 2
    data = [unit_vecs(rng, (g, F, n_res)) for g in groups]

    def jax_steps(acc, grps):
        for grp in grps:
            acc = jac.palmer_group_update_pretiled(
                jac.tile_palmer_group(jnp.asarray(grp)), *acc, grp.shape[0], n_res)
        return acc

    def port_steps(acc, grps):
        for grp in grps:
            acc = tac.palmer_group_update_pretiled(
                tac.tile_palmer_group(torch.from_numpy(grp)), *acc,
                grp.shape[0], n_res)
        return acc

    zeros = np.zeros((D, n_res))
    total = sum(groups)
    ref = jac.palmer_pooled_stats(*jax_steps((jnp.asarray(zeros),) * 2, data), total)

    half = jax_steps((jnp.asarray(zeros),) * 2, data[:2])
    s, s2, count = palmer_state_from_numpy(np.asarray(half[0]), np.asarray(half[1]),
                                           sum(groups[:2]), device="cpu")
    s, s2 = port_steps((s, s2), data[2:])
    carried = tac.palmer_pooled_stats(s, s2, count + sum(groups[2:]))

    z = torch.zeros((D, n_res), dtype=torch.float64)
    port_only = tac.palmer_pooled_stats(*port_steps((z, z), data), total)
    for got in (carried, port_only):
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-12)
    # ... and the pooled stream equals ct_palmer over all chunks.
    Ct, dCt = tac.ct_palmer(torch.from_numpy(np.concatenate(data)))
    np.testing.assert_allclose(carried[0].numpy(), Ct.numpy(), atol=1e-12)
    np.testing.assert_allclose(carried[1].numpy(), dCt.numpy(), rtol=1e-8, atol=1e-12)


def test_lag_times_matches_jax():
    got = tac.lag_times(2.0, 1000.0)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), jac.lag_times(2.0, 1000.0))
