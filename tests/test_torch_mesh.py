"""The port's mesh helpers (spinrelax_tpu_torch/parallel/mesh.py) in this
process, on a one-rank gloo group, against the JAX package's
parallel/mesh.py on its 8-device CPU mesh.  No rank is spawned here:
tests/test_torch_parallel.py runs 4 and 8 ranks."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from spinrelax_tpu.parallel import mesh as jmesh
from spinrelax_tpu_torch.parallel import launch
from spinrelax_tpu_torch.parallel import mesh as pm


@pytest.fixture(scope="module")
def mesh():
    """make_mesh(1) with no group running: it starts a one-rank gloo group
    in this process (torn down after the module)."""
    assert not dist.is_initialized()
    m = pm.make_mesh(1, device="cpu")
    yield m
    launch.stop()


def test_factor2_matches_jax():
    for n in range(1, 17):
        assert pm._factor2(n) == jmesh._factor2(n), n


def test_make_mesh_without_group_names_torchrun(monkeypatch):
    """A mesh of several devices with no group running (and no torchrun
    environment) raises and says how to start the ranks."""
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        pm.make_mesh(2, device="cpu")


def test_make_mesh_one_rank(mesh):
    assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
    assert pm.dims(mesh) == (1, 1)
    assert tuple(mesh.mesh_dim_names) == ("rep", "res")
    assert pm.coordinate(mesh) == (0, 0)
    assert pm.device_of(mesh) == torch.device("cpu")
    assert pm.make_mesh(device="cpu") is mesh  # one mesh per group and shape


def test_make_mesh_refuses_other_sizes_and_devices(mesh):
    """n other than the world size raises, as the JAX package refuses to
    truncate; a CUDA mesh without a card raises instead of running on
    the CPU."""
    with pytest.raises(ValueError, match="subset"):
        pm.make_mesh(4, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pm.make_mesh(1, device="cuda")


def test_shardings_are_slices(mesh):
    assert pm.vecs_sharding(mesh, 6, 11) == (slice(0, 6), slice(0, 11))
    assert pm.residue_sharding(mesh, 7) == slice(0, 7)
    assert pm.replicated(mesh, 5) == slice(0, 5)
    with pytest.raises(ValueError, match="does not split"):
        pm._block(7, 2, 0)


def test_pad_and_shard_rejects_scalars(mesh):
    with pytest.raises(ValueError, match="0-d"):
        pm.pad_and_shard(mesh, [np.float64(1.7e-4)])
    with pytest.raises(ValueError, match="leading axes differ"):
        pm.pad_and_shard(mesh, [np.zeros(3), np.zeros(4)])


def test_pad_and_shard_pads_with_row_zero(mesh, monkeypatch, rng):
    """At 4 ranks (rank and world size stood in for), 5 rows pad to 8 with
    copies of row 0, and the ranks' blocks laid end to end equal the JAX
    package's padded array; numpy keeps its dtype."""
    a = rng.normal(size=(5, 3))
    b = np.arange(5)
    (ja, jb), n = jmesh.pad_and_shard(jmesh.make_mesh(8), [a, b])
    assert n == 5
    monkeypatch.setattr(pm.dist, "get_world_size", lambda group=None: 4)
    blocks = []
    for r in range(4):
        monkeypatch.setattr(pm.dist, "get_rank", lambda group=None, r=r: r)
        (la, lb), n_orig = pm.pad_and_shard(mesh, [a, torch.from_numpy(b)])
        assert n_orig == 5 and la.shape == (2, 3) and la.dtype == torch.float64
        blocks.append((la.numpy(), lb.numpy()))
    got_a = np.concatenate([x for x, _ in blocks])
    got_b = np.concatenate([y for _, y in blocks])
    np.testing.assert_array_equal(got_a, np.asarray(ja))
    np.testing.assert_array_equal(got_b, np.asarray(jb))
    np.testing.assert_array_equal(got_a[5:], np.repeat(a[:1], 3, axis=0))


def test_fetch_is_the_identity_on_one_rank(mesh, rng):
    a = torch.from_numpy(rng.normal(size=(16, 5)))
    torch.testing.assert_close(pm.fetch(a, mesh), a, rtol=0, atol=0)
    torch.testing.assert_close(pm.fetch(a, mesh, 11), a[:11], rtol=0, atol=0)
    m = a > 0
    assert torch.equal(pm.fetch(m, mesh), m)
    (local,), n = pm.pad_and_shard(mesh, [a])
    torch.testing.assert_close(pm.fetch(local, mesh, n), a, rtol=0, atol=0)
    # a one-rank all-reduce runs as written and changes nothing
    x = a.clone()
    pm.all_reduce(x, mesh, "rep")
    torch.testing.assert_close(x, a, rtol=0, atol=0)
    assert pm.is_writer(mesh) and pm.is_writer(None)
    pm.barrier(mesh)
