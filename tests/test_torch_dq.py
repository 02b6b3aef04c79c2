"""The port's Delta-q analysis (spinrelax_tpu_torch.ops.dq) against
spinrelax_tpu.ops.dq on the CPU, in float64, on Brownian tumbling with a
fully anisotropic body tensor and with the axisymmetric one of
tests/test_dq.py.

Tolerances: per-lag statistics 1e-12 absolute (two float64 summation
orders); exponential-fit taus 1e-8 relative; D and the anisotropies
1e-10 relative; histogram counts exactly.  Eigenvectors and quaternions
are compared up to sign (eigh returns either).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spinrelax_tpu.ops import dq as jdq
from spinrelax_tpu_torch.ops import dq as tdq

D_ANISO = [8e-4, 1.2e-3, 2.4e-3]
D_AXI = [8e-4, 8e-4, 2.4e-3]  # tests/test_dq.py's fixture
GRID = (1.0, 5.0, 500.0, 5.0)  # delta_t, min_dt, max_dt, skip_dt: 100 lags


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_state():
    """Clear jax's compiled-program caches before this module (see
    tests/test_review_fixes_r3.py); two torch threads per xdist worker."""
    jax.clear_caches()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(2)


def tumbling(seed, n_frames, D_body, dt=1.0):
    """Rotational Brownian motion with body-frame diffusion tensor
    diag(D_body): per-step rotation angles ~ N(0, 2 D_i dt) (the generator
    of tests/test_dq.py)."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(n_frames, 3)) * np.sqrt(2.0 * np.asarray(D_body) * dt)
    q = np.empty((n_frames, 4))
    cur = np.array([1.0, 0.0, 0.0, 0.0])
    q[0] = cur
    for t in range(1, n_frames):
        th = np.linalg.norm(w[t])
        ax = w[t] / th if th > 0 else np.array([1.0, 0.0, 0.0])
        b = np.concatenate([[np.cos(th / 2)], ax * np.sin(th / 2)])
        a = cur
        cur = np.array([a[0] * b[0] - a[1:] @ b[1:],
                        *(a[0] * b[1:] + b[0] * a[1:] + np.cross(a[1:], b[1:]))])
        cur /= np.linalg.norm(cur)
        q[t] = cur
    return q


@pytest.fixture(scope="module")
def qs():
    return {"aniso": tumbling(7, 3000, D_ANISO), "axi": tumbling(8, 3000, D_AXI)}


@pytest.fixture(scope="module")
def analysed(qs):
    """analyse_dq of both packages, n_chunks 4, on both trajectories."""
    return {k: (jdq.analyse_dq(q, *GRID, n_chunks=4),
                tdq.analyse_dq(q, *GRID, n_chunks=4, device="cpu"))
            for k, q in qs.items()}


def _same_up_to_sign(a, b, atol):
    a, b = np.asarray(a), np.asarray(b)
    s = np.where(np.sum(a * b, axis=-1, keepdims=True) >= 0, 1.0, -1.0)
    np.testing.assert_allclose(a * s, b, atol=atol)


def _assert_results_agree(t, j, chunks=True, hist=False):
    np.testing.assert_array_equal(t.lag_times, j.lag_times)
    rt = dict(rtol=1e-8)
    np.testing.assert_allclose(t.iso_tau, j.iso_tau, **rt)
    np.testing.assert_allclose(t.aniso_taus, j.aniso_taus, **rt)
    np.testing.assert_allclose(t.D_axes, j.D_axes, rtol=1e-10)
    np.testing.assert_allclose(t.D_iso, j.D_iso, rtol=1e-10)
    np.testing.assert_allclose(t.anisotropies, j.anisotropies, rtol=1e-10)
    for f in ("iso", "aniso", "M", "iso_models", "aniso_models"):
        np.testing.assert_allclose(getattr(t, f), np.asarray(getattr(j, f)), atol=1e-12,
                                   err_msg=f)
    _same_up_to_sign(t.q_frame, j.q_frame, 1e-10)
    _same_up_to_sign(t.q_per_lag, j.q_per_lag, 1e-10)
    _same_up_to_sign(t.axes_per_lag, j.axes_per_lag, 1e-10)
    if chunks:
        np.testing.assert_allclose(t.iso_tau_chunks, j.iso_tau_chunks, **rt)
        np.testing.assert_allclose(t.aniso_tau_chunks, j.aniso_tau_chunks, **rt)
        np.testing.assert_allclose(t.anis_chunk_samples, j.anis_chunk_samples, rtol=1e-10)
        for f in ("iso_chunks", "aniso_chunks"):
            np.testing.assert_allclose(getattr(t, f), getattr(j, f), atol=1e-12, err_msg=f)
    if hist:
        np.testing.assert_array_equal(t.hist, j.hist)


# --- statistics, frame, fits ------------------------------------------------------

@pytest.mark.parametrize("n_chunks", [0, 4])
def test_dq_statistics_matches_jax(qs, monkeypatch, n_chunks):
    """Short and long lags; at 2995 and 2997 of 3000 frames the last
    sub-chunk is empty (NaN in both).  A budget of one lag a block gives
    the same sums."""
    q = qs["aniso"]
    lags = np.array([1, 5, 10, 20, 1400, 2995, 2997], dtype=np.int32)
    j = jdq.dq_statistics(jnp.asarray(q), jnp.asarray(lags), n_chunks=n_chunks)
    t = tdq.dq_statistics(q, lags, n_chunks=n_chunks, device="cpu")
    monkeypatch.setattr(tdq, "BLOCK_BYTES", 1)
    t1 = tdq.dq_statistics(torch.from_numpy(q), lags, n_chunks=n_chunks)
    for f in ("iso", "M", "iso_chunks", "M_chunks"):
        a, b = getattr(t, f).numpy(), np.asarray(getattr(j, f))
        assert a.shape == b.shape, f
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_allclose(a, b, atol=1e-12, err_msg=f)
        np.testing.assert_allclose(getattr(t1, f).numpy(), a, atol=1e-15, err_msg=f)
    if n_chunks:
        assert np.isnan(t.iso_chunks[-2:, 3].numpy()).all()
        assert not np.isnan(t.iso_chunks[:-2].numpy()).any()


def test_principal_frame_matches_jax(qs, analysed):
    """principal_frame against the frame inside JAX's analyse_dq (its
    finalise runs the same computation) and eigh against numpy's."""
    lags = np.arange(5, 505, 5, dtype=np.int32)
    stats = tdq.dq_statistics(qs["aniso"], lags, n_chunks=4, device="cpu")
    t = tdq.principal_frame(stats)
    j = analysed["aniso"][0]
    np.testing.assert_allclose(t.eigvals.numpy(), np.linalg.eigvalsh(stats.M.numpy()),
                               atol=1e-14)
    _same_up_to_sign(t.q_frame.numpy(), j.q_frame, 1e-10)
    _same_up_to_sign(t.q_per_lag.numpy(), j.q_per_lag, 1e-10)
    _same_up_to_sign(t.axes_per_lag.numpy(), j.axes_per_lag, 1e-10)
    np.testing.assert_allclose(t.aniso_decay.numpy().T, j.aniso, atol=1e-12)
    np.testing.assert_allclose(np.moveaxis(t.aniso_chunks.numpy(), 0, -1), j.aniso_chunks,
                               atol=1e-12)


def test_fit_exp_decay_matches_jax():
    """Noisy decays of both forms, batched; a clean decay recovers its tau."""
    rng = np.random.default_rng(2)
    x = np.arange(5.0, 505.0, 5.0)
    taus = rng.uniform(40.0, 900.0, (3, 4))
    for c0, c1 in ((1.5, -0.5), (0.5, 0.5)):
        y = c0 * np.exp(-x / taus[..., None]) + c1 + rng.normal(scale=3e-3, size=(3, 4, 100))
        j = np.asarray(jdq.fit_exp_decay(jnp.asarray(x), jnp.asarray(y), c0, c1))
        t = tdq.fit_exp_decay(torch.from_numpy(x), torch.from_numpy(y), c0, c1).numpy()
        assert t.shape == (3, 4)
        np.testing.assert_allclose(t, j, rtol=1e-8)
    y = 1.5 * np.exp(-x / 77.0) - 0.5
    np.testing.assert_allclose(float(tdq.fit_exp_decay(torch.from_numpy(x),
                                                       torch.from_numpy(y), 1.5, -0.5)),
                               77.0, rtol=1e-6)


# --- the analyse paths ----------------------------------------------------------

def test_analyse_dq_anisotropic_matches_jax(analysed):
    j, t = analysed["aniso"]
    _assert_results_agree(t, j)


def test_analyse_dq_axisymmetric_matches_jax(analysed):
    """The in-plane axes are ill-determined in both packages: compare what
    does not depend on them."""
    j, t = analysed["axi"]
    np.testing.assert_allclose(np.sort(t.D_axes), np.sort(j.D_axes), rtol=1e-10)
    np.testing.assert_allclose(t.anisotropies[:3], j.anisotropies[:3], rtol=1e-10)
    np.testing.assert_allclose(t.D_iso, j.D_iso, rtol=1e-10)
    _same_up_to_sign(t.q_frame, j.q_frame, 1e-8)


def test_analyse_dq_multi_matches_jax(qs):
    """Four replicas of unequal length, uncertainty chunks of two replicas
    each."""
    q = qs["aniso"]
    reps = [q[:1500], q[1500:], qs["axi"][:1400], qs["axi"][1400:]]
    j = jdq.analyse_dq_multi(reps, 1.0, 5.0, 300.0, 5.0, n_chunks=2)
    t = tdq.analyse_dq_multi(reps, 1.0, 5.0, 300.0, 5.0, n_chunks=2, device="cpu")
    _assert_results_agree(t, j)
    with pytest.raises(ValueError, match="must divide"):
        tdq.analyse_dq_multi(reps, 1.0, 5.0, 300.0, 5.0, n_chunks=3, device="cpu")


def test_analyse_dq_streamed_matches_jax_and_in_memory(qs, analysed):
    """Blocks of 700 frames (3000 is not a multiple), sub-chunks from the
    pre-counted total, histograms: JAX's streamed result, and the
    in-memory one (histogram counts equal exactly)."""
    q = qs["aniso"]
    bins = 6
    chunks = [q[i: i + 1000] for i in range(0, 3000, 1000)]
    kw = dict(chunk_frames=700, n_chunks=4, n_total=3000, hist_bins=bins)
    j = jdq.analyse_dq_streamed(iter(chunks), *GRID, **kw)
    t = tdq.analyse_dq_streamed(iter(chunks), *GRID, device="cpu", **kw)
    _assert_results_agree(t, j, hist=True)
    _assert_results_agree(t, analysed["aniso"][1])
    for li in (0, 57, 99):
        d = int(t.lag_times[li])
        h, _ = np.histogramdd(tdq.dq_vectors(q, d), bins=(bins,) * 3,
                              range=((-1, 1),) * 3, density=True)
        np.testing.assert_array_equal(t.hist[li], h)
    with pytest.raises(ValueError, match="n_total"):
        tdq.analyse_dq_streamed(iter(chunks), *GRID, n_chunks=4, device="cpu")
    with pytest.raises(ValueError, match="pre-counted"):
        tdq.analyse_dq_streamed(iter(chunks), *GRID, n_chunks=4, n_total=2999,
                                device="cpu")


def test_analyse_dq_multi_streamed_matches_jax(qs):
    reps = [qs["aniso"][:1500], qs["aniso"][1500:]]

    def stream():
        for r, q in enumerate(reps):
            for i in range(0, 1500, 400):
                yield r, q[i: i + 400]

    j = jdq.analyse_dq_multi_streamed(stream(), 1.0, 5.0, 300.0, 5.0, chunk_frames=250,
                                      n_chunks=2)
    t = tdq.analyse_dq_multi_streamed(stream(), 1.0, 5.0, 300.0, 5.0, chunk_frames=250,
                                      n_chunks=2, device="cpu")
    _assert_results_agree(t, j)
    m = tdq.analyse_dq_multi(reps, 1.0, 5.0, 300.0, 5.0, n_chunks=2, device="cpu")
    _assert_results_agree(t, m)
    with pytest.raises(ValueError, match="shortest replica"):
        tdq.analyse_dq_multi_streamed(stream(), 1.0, 5.0, 800.0, 5.0, device="cpu")


@pytest.mark.parametrize("grid,n", [((1.0, 100.0, 50.0, 5.0), 400),
                                    ((1.0, 50.0, 50.0, 50.0), 400),
                                    ((1.0, 5.0, 300.0, 5.0), 400)])
def test_lag_grid_errors_match_jax(qs, grid, n):
    """tests/test_dq.py's empty and single-point grids, and a max_dt past
    half the trajectory: the same error text."""
    q = qs["aniso"][:n]
    with pytest.raises(ValueError) as je:
        jdq.analyse_dq(q, *grid)
    with pytest.raises(ValueError) as te:
        tdq.analyse_dq(q, *grid, device="cpu")
    assert str(te.value) == str(je.value)


def test_default_device_is_the_card(qs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdq.analyse_dq(qs["aniso"], *GRID)
