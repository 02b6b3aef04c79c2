"""The port's multi-device paths at 4 ranks (mesh 2 x 2) and 8 ranks
(4 x 2, the JAX package's make_mesh(8)) of spawned gloo ranks on the CPU,
each held to the JAX package on its 8-device CPU mesh, float64, on the
same seeded numpy inputs.

The ranks run tests/torch_mp_workers.parallel_checks once per world size
(a module fixture); the JAX side runs once per module.  Tolerances are
tests/test_parallel.py's:
- the sharded and streamed C(t) and the scan: atol 1e-10;
- run_streamed_pipeline: R1 / NOE rtol 1e-6, S2 atol 1e-6 (fast
  decorrelating walks fit S2 ~ 0);
- make_sharded_forward: Ct rtol 1e-8, R1 / NOE rtol 1e-6;
- host_stream + reduce_partials(_collective): atol 1e-12;
- shard_experiment_set: chisq_total rtol 1e-10, the device fit rtol 1e-8.
"""

import dataclasses
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spinrelax_tpu.fit.globalfit import GlobalFitter, chisq_total
from spinrelax_tpu.models.experiments import ExperimentSet
from spinrelax_tpu.models import Diffusion
from spinrelax_tpu.ops.autocorr import ct_palmer_scan, ct_palmer_streamed
from spinrelax_tpu.parallel.fit import shard_experiment_set
from spinrelax_tpu.parallel.ingest import (
    host_stream, reduce_partials, reduce_partials_collective)
from spinrelax_tpu.parallel.mesh import make_mesh, vecs_sharding
from spinrelax_tpu.parallel.pipeline import make_sharded_forward
from spinrelax_tpu.parallel.streamed import run_streamed_pipeline
from spinrelax_tpu_torch.parallel.launch import spawn
from tests import torch_mp_workers as workers
from tests.test_globalfit import make_setup, synth_experiments
from tests.test_parallel import make_vecs

SPAWN_TIMEOUT = 240.0  # seconds a spawn (and its group's collectives) may take
# the "rep" rows' chunks of ingest_vecs, one host's partial per row
INGEST_ROWS = {2: [(0, 3), (3, 6)], 4: [(0, 1), (1, 3), (3, 5), (5, 6)]}


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_state():
    jax.clear_caches()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(2)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(20261017)
    d = dict(stream_vecs=make_vecs(rng, n_rep=10, n_frames=64, n_res=11),
             scan_vecs=make_vecs(rng, n_rep=8, n_frames=32, n_res=8),
             fwd_vecs=make_vecs(rng, n_rep=4, n_frames=64, n_res=8),
             ingest_vecs=make_vecs(rng, n_rep=6, n_frames=32, n_res=5))
    # 11 residues: NOT divisible by 4 or 8 -- exercises the padding.
    names, cts, diff, v, w = make_setup(rng, n_res=11, diso=4e-5, aniso=1.5)
    expts = synth_experiments(names, cts, diff, v, w)
    d["fit_jax"] = (names, cts, v, w, expts)
    d["fit"] = dict(
        names=names, S2=np.asarray(cts.S2), C=np.asarray(cts.C), tau=np.asarray(cts.tau),
        v=v, w=w, zeta=float(cts.zeta),
        expts=[{f.name: getattr(e, f.name) for f in dataclasses.fields(e)} for e in expts])
    c = rng.normal(size=(3, 16, 5, 3))
    d["scalar_csa_chunks"] = c / np.linalg.norm(c, axis=-1, keepdims=True)
    return d


@pytest.fixture(scope="module")
def jref(data):
    """The JAX package's results on its 8-device mesh."""
    mesh = make_mesh(8)
    v = data["stream_vecs"]
    groups = [v[:3], v[3:9], v[9:]]
    out = {}
    out["streamed_Ct"], out["streamed_dCt"] = map(
        np.asarray, ct_palmer_streamed(iter(groups), 64, mesh=mesh))
    r = run_streamed_pipeline(iter(groups), mesh, 64, 11, tau_iso=500.0)
    out.update({f"pipe_{k}": np.asarray(getattr(r, k)) for k in ("R1", "NOE", "S2")})
    out["scan_Ct"], out["scan_dCt"] = map(
        np.asarray, ct_palmer_scan(jnp.asarray(data["scan_vecs"]), batch=4, mesh=mesh))
    fwd = make_sharded_forward(mesh, tau_iso=500.0)
    f = fwd(jax.device_put(jnp.asarray(data["fwd_vecs"]), vecs_sharding(mesh)))
    out.update({f"fwd_{k}": np.asarray(getattr(f, k)) for k in ("Ct", "R1", "NOE")})
    iv = data["ingest_vecs"]
    pa = host_stream(iter([iv[:2], iv[2:4]]), 32)
    pb = host_stream(iter([iv[4:]]), 32)
    out["ingest_Ct"], out["ingest_dCt"] = reduce_partials([pa, pb])
    parts = [host_stream(iter([iv[lo:hi]]), 32) for lo, hi in INGEST_ROWS[4]]
    out["ingest_coll_Ct"], out["ingest_coll_dCt"] = reduce_partials_collective(parts, mesh)
    names, cts, v, w, expts = data["fit_jax"]
    es = ExperimentSet.build(expts, cts, Diffusion.axisymmetric(diso=4.6e-5, aniso=1.3),
                             vecs=v, weights=w)
    es_sh = shard_experiment_set(es, mesh)
    csa = jnp.asarray(np.full(es_sh.n_residues, -170e-6))
    out["fit_chisq"] = float(chisq_total(es_sh, 4.6e-5, 1.3, cts.zeta, csa))
    st = GlobalFitter(es_sh, ["Diso", "Daniso"]).run(method="device")
    out["fit_device"] = np.array([st.diso, st.aniso])
    return out


@pytest.fixture(scope="module", params=[4, 8], ids=["4ranks", "8ranks"])
def ranks(request, data):
    """Every rank's results of parallel_checks at one world size."""
    world = request.param
    d = {k: v for k, v in data.items() if k != "fit_jax"}
    d["ingest_rows"] = INGEST_ROWS[{4: 2, 8: 4}[world]]
    return world, spawn(workers.parallel_checks, world, d, device="cpu",
                        timeout=SPAWN_TIMEOUT)


def test_mesh_shape(ranks):
    world, res = ranks
    want = {4: (2, 2), 8: tuple(make_mesh(8).devices.shape)}[world]
    assert tuple(res[0]["dims"]) == want


def test_streamed_ct_matches_jax(ranks, jref):
    """3 + 6 + 1 chunks over 11 residues: neither divides the mesh."""
    r = ranks[1][0]
    np.testing.assert_allclose(r["streamed_Ct"], jref["streamed_Ct"], rtol=0, atol=1e-10)
    np.testing.assert_allclose(r["streamed_dCt"], jref["streamed_dCt"], rtol=0, atol=1e-10)


def test_scan_mesh_matches_jax(ranks, jref):
    r = ranks[1][0]
    np.testing.assert_allclose(r["scan_Ct"], jref["scan_Ct"], rtol=0, atol=1e-10)
    np.testing.assert_allclose(r["scan_dCt"], jref["scan_dCt"], rtol=0, atol=1e-10)


def test_streamed_pipeline_matches_jax(ranks, jref):
    r = ranks[1][0]
    np.testing.assert_allclose(r["pipe_R1"], jref["pipe_R1"], rtol=1e-6)
    np.testing.assert_allclose(r["pipe_NOE"], jref["pipe_NOE"], rtol=1e-6)
    np.testing.assert_allclose(r["pipe_S2"], jref["pipe_S2"], rtol=0, atol=1e-6)


def test_sharded_forward_matches_jax(ranks, jref):
    r = ranks[1][0]
    np.testing.assert_allclose(r["fwd_Ct"], jref["fwd_Ct"], rtol=1e-8)
    np.testing.assert_allclose(r["fwd_R1"], jref["fwd_R1"], rtol=1e-6)
    np.testing.assert_allclose(r["fwd_NOE"], jref["fwd_NOE"], rtol=1e-6)


def test_ingest_reductions_match_jax(ranks, jref):
    """Two hosts pooled on the host, and one partial per "rep" row pooled
    by one all-reduce over "rep"."""
    r = ranks[1][0]
    for k in ("ingest_Ct", "ingest_dCt", "ingest_coll_Ct", "ingest_coll_dCt"):
        np.testing.assert_allclose(r[k], jref[k], rtol=0, atol=1e-12, err_msg=k)


def test_sharded_multifield_fit_matches_jax(ranks, jref):
    r = ranks[1][0]
    world = ranks[0]
    assert r["fit_n_total"] == 11 + (-11) % world
    np.testing.assert_allclose(r["fit_chisq"], jref["fit_chisq"], rtol=1e-10)
    np.testing.assert_allclose(r["fit_device"][:2], jref["fit_device"], rtol=1e-8)
    np.testing.assert_allclose(r["fit_device"][0], 4e-5, rtol=1e-4)


def test_ranks_agree_bit_for_bit(ranks):
    """Every rank returns the same bits: the all-reduces give each the same
    sums, so each takes the same optimiser path."""
    world, res = ranks
    assert len(res) == world
    for r in res[1:]:
        for k in ("fit_device", "fit_chisq", "pipe_R1", "fwd_R1", "streamed_Ct"):
            np.testing.assert_array_equal(r[k], res[0][k], err_msg=k)


def test_scalar_csa_finish(ranks):
    """run_sharded_finish takes a scalar csa (it gets a residue axis before
    pad_and_shard, which refuses 0-d inputs), as the JAX package does."""
    assert np.all(np.isfinite(ranks[1][0]["scalar_csa_R1"]))


def test_spawn_raises_when_a_rank_fails():
    """Rank 1 raises while rank 0 waits in a barrier: spawn raises the
    first failure it sees (rank 1's, or rank 0's barrier losing its peer)
    at once, not at the group's timeout, and no rank is left running."""
    import torch.multiprocessing as mp

    t0 = time.monotonic()
    with pytest.raises((mp.ProcessRaisedException, mp.ProcessExitedException)):
        spawn(workers.fail_on_rank1, 2, device="cpu", timeout=SPAWN_TIMEOUT)
    assert time.monotonic() - t0 < SPAWN_TIMEOUT / 2


def test_spawn_kills_ranks_at_its_timeout():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="did not finish within 6 s"):
        spawn(workers.sleep_forever, 2, device="cpu", timeout=6.0)
    assert time.monotonic() - t0 < 60.0
