"""The port's flagship physics sharded over 4 spawned gloo ranks (mesh
2 x 2): ShardedCtStream -> run_sharded_finish (the DoF ladder with each
rung's LMs on a rank's residues, J with vector ensembles, ensemble rates)
for the isotropic, axisymmetric and ellipsoid diffusion kinds, held to the
JAX package's run_sharded_finish on its 8-device CPU mesh, float64, on the
same seeded inputs (tests/test_flagship_sharded.py's data and tolerances:
Ct / dCt rtol 1e-10; S2 and the rates rtol 1e-6, atol 1e-12, the floor
above the dead-parameter and cancellation noise that test explains).
"""

import os

import jax
import numpy as np
import pytest
import torch

from spinrelax_tpu.constants import NucleusPair, field_from_mhz
from spinrelax_tpu.models import Diffusion
from spinrelax_tpu.parallel.mesh import make_mesh
from spinrelax_tpu.parallel.streamed import ShardedCtStream, run_sharded_finish
from spinrelax_tpu_torch.parallel.launch import spawn
from tests import torch_mp_workers as workers

KINDS = ("axisymmetric", "isotropic", "ellipsoid")
RATES = ("R1", "R2", "NOE", "rho", "dR1", "dR2", "dNOE", "drho")


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_state():
    jax.clear_caches()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(2)


@pytest.fixture(scope="module")
def data():
    """tests/test_flagship_sharded.py's system: a correlated random walk
    on the sphere in 7 chunks of 32 frames, 9 residues (divides no mesh),
    12-sample PAF ensembles with weights, residue CSAs."""
    rng = np.random.default_rng(20261018)
    n_frames, n_res, n_samp = 32, 9, 12
    steps = rng.normal(size=(7 * n_frames, n_res, 3))
    walk = np.empty((7 * n_frames, n_res, 3))
    walk[0] = steps[0] / np.linalg.norm(steps[0], axis=-1, keepdims=True)
    for t in range(1, 7 * n_frames):
        w = walk[t - 1] + 0.25 * steps[t]
        walk[t] = w / np.linalg.norm(w, axis=-1, keepdims=True)
    vecs = rng.normal(size=(n_res, n_samp, 3))
    vecs /= np.linalg.norm(vecs, axis=-1, keepdims=True)
    one = rng.normal(size=(1, n_frames, n_res, 3))
    return dict(chunks=walk.reshape(7, n_frames, n_res, 3), vecs=vecs,
                weights=rng.uniform(0.5, 2.0, (n_res, n_samp)),
                csa=rng.uniform(-180e-6, -160e-6, n_res),
                names=[str(i + 2) for i in range(n_res)],
                one_chunk=one / np.linalg.norm(one, axis=-1, keepdims=True))


@pytest.fixture(scope="module")
def port(data):
    return spawn(workers.flagship_checks, 4, data, device="cpu", timeout=240.0)


def _jax_diffusion(kind):
    if kind == "axisymmetric":
        return Diffusion.axisymmetric(diso=4e-5, aniso=1.5)
    if kind == "ellipsoid":
        return Diffusion.ellipsoid(np.array([2.8e-5, 3.6e-5, 5.6e-5]))
    return Diffusion.isotropic(diso=4e-5)


@pytest.mark.parametrize("kind", KINDS)
def test_flagship_sharded_matches_jax(data, port, kind):
    mesh = make_mesh(8)
    chunks = data["chunks"]
    aniso = kind != "isotropic"
    stream = ShardedCtStream(mesh, 32, 9, dtype=np.float64)
    stream.update(chunks[:4])
    stream.update(chunks[4:])
    want = run_sharded_finish(
        mesh, *stream.accumulators(), n_res=9, delta_t=1.0, diffusion=_jax_diffusion(kind),
        pair=NucleusPair(B0=field_from_mhz(600.133), time_unit="ps"),
        vecs=data["vecs"] if aniso else None, weights=data["weights"] if aniso else None,
        csa=data["csa"], zeta=0.89, names=data["names"])
    got = port[0][kind]
    np.testing.assert_allclose(got["Ct"], np.asarray(want.Ct), rtol=1e-10)
    np.testing.assert_allclose(got["dCt"], np.asarray(want.dCt), rtol=1e-10)
    np.testing.assert_allclose(got["S2"], np.asarray(want.cts.S2), rtol=1e-6, atol=1e-12)
    np.testing.assert_array_equal(got["mask"], np.asarray(want.cts.mask))
    for f in RATES:
        w = getattr(want, f)
        if w is None:
            assert got[f] is None, f
            continue
        np.testing.assert_allclose(got[f], np.asarray(w), rtol=1e-6, atol=1e-12, err_msg=f)
    for r in port[1:]:  # every rank returns the same bits
        for f in ("Ct", "S2", "R1"):
            np.testing.assert_array_equal(r[kind][f], got[f], err_msg=f)


def test_flagship_sharded_single_chunk_stream_is_finite(port):
    """A one-chunk stream has dCt = NaN (the sqrt(n)-1 quirk); the ladder's
    NaN-safe weights keep every rate finite."""
    got = port[0]["one_chunk"]
    assert np.all(np.isnan(got["dCt"]))
    for f in ("R1", "R2", "NOE", "rho"):
        assert np.all(np.isfinite(got[f])), f
