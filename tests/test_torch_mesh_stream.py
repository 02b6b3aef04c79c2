"""Four replicate trajectories analysed jointly on 4 spawned gloo ranks
(mesh 2 x 2), as ``ct --split G --devices 4`` runs them: every rank calls
stage_ct_streamed on all four .xtc files (entry.synthetic_system, a seed
each) with the mesh, then run_finish(mesh=); held to the one-process
stage and finish over the same four files, and to the JAX package's
stage_ct_streamed and run_sharded_finish over the same four replicas
(tests/torch_mp_workers.stream_mesh_checks).

The port runs in float64 (the stage's ``dtype``).  Against its own one
process the only difference is the order of the sums -- each group's
chunks summed a rank at a time over "rep", then all-reduced -- and the
tolerances are those of the existing sharded tests for that: the C(t)
atol 1e-10 (tests/test_torch_parallel.py, the sharded streamed C(t)); the
fitted S2 and the rates rtol 1e-6, atol 1e-12
(tests/test_torch_flagship_sharded.py: the floor above the
dead-parameter and cancellation noise of the ladder's LMs).  The
artefacts that every rank computes whole (S2, the average vector, the
histogram) are the same bytes; the C(t) files are numpy's 8-digit
rendering, so they agree to 1e-8.

Against JAX: the JAX stage reads an .xtc into float32 observables, and
the port's .xtc decoder hands its stage the bond differences rounded to
float32 (4e-10 from the same frames in float64), so the float64
comparison runs both packages, the port on the mesh, over the replicas'
frames as decoded from the .xtc files, saved as float64 .npy: the same
tolerances as above, with the rates from JAX's run_sharded_finish on the
JAX stage's pooled statistics (its convert.palmer_state_from_stage
accumulators).  The .xtc run is held to the JAX stage on the .xtc files
at that stage's float32 tolerance, atol 1e-5
(tests/test_torch_ct_streamed.py).

Also: only rank 0 writes; every rank returns the same bits; under a
profiler each rank records one ``ct_stream.allreduce`` span a stream and
group and one ``mesh.barrier`` an artefact; the one-process path records
neither.
"""

import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from spinrelax_tpu.constants import NucleusPair as JPair
from spinrelax_tpu.constants import field_from_mhz as jfield
from spinrelax_tpu.models.diffusion import Diffusion as JDiff
from spinrelax_tpu.parallel.mesh import make_mesh as jmesh
from spinrelax_tpu.parallel.streamed import run_sharded_finish
from spinrelax_tpu.pipeline import stages as jstages
from spinrelax_tpu_torch import convert
from spinrelax_tpu_torch.constants import NucleusPair, field_from_mhz
from spinrelax_tpu_torch.entry import synthetic_system
from spinrelax_tpu_torch.io import native, xvg
from spinrelax_tpu_torch.parallel.launch import spawn
from spinrelax_tpu_torch.parallel.streamed import run_finish
from spinrelax_tpu_torch.pipeline.stages import stage_ct_streamed
from spinrelax_tpu_torch.utils import profiling
from tests import torch_mp_workers as workers

WORLD = 4
N_RES, N_FRAMES, TAU, GROUPS = 5, 1600, 200.0, 3  # 8 chunks a replica: groups of 3, 3, 2
DT = 1.0
FILES = ("_Ctext.dat", "_Ctint.dat", "_avgvec.dat", "_vecHistogram.npz", "_S2.dat")
RATES = ("R1", "R2", "NOE", "rho")


@pytest.fixture(scope="module", autouse=True)
def _threads():
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(2)


@pytest.fixture(scope="module")
def system(tmp_path_factory):
    d = tmp_path_factory.mktemp("rep4")
    xtcs, refs, npys = [], [], []
    for r in range(4):
        (d / f"replica{r}").mkdir()
        ref, xtc, _ = synthetic_system(d / f"replica{r}", n_res=N_RES, n_frames=N_FRAMES,
                                       dt=DT, seed=40 + r)
        xtcs.append(xtc)
        refs.append(ref)
        npys.append(str(d / f"replica{r}" / "decoded.npy"))
        np.save(npys[-1], native.read_xtc(xtc)[0].astype(np.float64))
    rng = np.random.default_rng(22)
    vecs = rng.normal(size=(N_RES, 12, 3))
    kw = dict(tau=TAU, groups=GROUPS, n_res=N_RES, npys=npys, dt=DT,
              vecs=vecs / np.linalg.norm(vecs, axis=-1, keepdims=True),
              weights=rng.uniform(0.5, 2.0, (N_RES, 12)))
    return d, xtcs, refs, kw


@pytest.fixture(scope="module")
def ranks(system):
    d, xtcs, refs, kw = system
    (d / "mesh").mkdir()
    return spawn(workers.stream_mesh_checks, WORLD, xtcs, refs, str(d / "mesh"), kw,
                 device="cpu", timeout=240.0)


@pytest.fixture(scope="module")
def flat(system):
    """The one-process stage and finish over the same files, profiled."""
    from spinrelax_tpu_torch.ops import autocorr

    d, xtcs, refs, kw = system
    (d / "flat").mkdir()
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        out = stage_ct_streamed(xtcs, refs, str(d / "flat" / "m"), TAU, chunk_groups=GROUPS,
                                device="cpu", dtype=torch.float64)
        acc = out["acc"]
        fin = run_finish(acc["ct_int_s"], acc["ct_int_s2"], out["n_chunks"], n_res=N_RES,
                         delta_t=out["delta_t"], diffusion=workers.diffusion("axisymmetric"),
                         pair=NucleusPair(B0=field_from_mhz(600.133), time_unit="ps"),
                         vecs=kw["vecs"], weights=kw["weights"], zeta=0.89)
    names = [s[0] for s in profiling.spans()]
    profiling.clear()
    ext = autocorr.palmer_pooled_stats(acc["ct_ext_s"], acc["ct_ext_s2"], out["n_chunks"])
    res = {"Ct": out["Ct"], "dCt": out["dCt"], "Ctext": ext[0].numpy(),
           "dCtext": ext[1].numpy(), "S2": out["S2"], "fit_S2": fin.cts.S2.numpy(),
           "n_chunks": out["n_chunks"], "names": names}
    res.update({f: getattr(fin, f).numpy() for f in RATES})
    return res


@pytest.fixture(scope="module")
def jax_ref(system):
    """The JAX package's stage (no mesh) over the four replicas: float64
    over the decoded frames, with its finish (run_sharded_finish on a
    one-device mesh from the stage's pooled statistics), and its own
    float32 over the .xtc files."""
    d, xtcs, refs, kw = system
    n = 4 * N_FRAMES // int(TAU)
    j = jstages.stage_ct_streamed(kw["npys"], refs, str(d / "jax64"), TAU,
                                  chunk_groups=GROUPS, timestep=DT)
    s, s2, count = convert.palmer_state_from_stage(j, n, device="cpu")
    fin = run_sharded_finish(jmesh(1), s.numpy().T, s2.numpy().T, count, n_res=N_RES,
                             delta_t=j["delta_t"],
                             diffusion=JDiff.axisymmetric(diso=4e-5, aniso=1.5),
                             pair=JPair(B0=jfield(600.133), time_unit="ps"), vecs=kw["vecs"],
                             weights=kw["weights"], zeta=0.89)
    want = {k: np.asarray(j[k]) for k in ("Ct", "dCt", "S2")}
    want["fit_S2"] = np.asarray(fin.cts.S2)
    want.update({f: np.asarray(getattr(fin, f)) for f in RATES})
    j32 = jstages.stage_ct_streamed(xtcs, refs, str(d / "jax32"), TAU, chunk_groups=GROUPS)
    return want, {k: np.asarray(j32[k]) for k in ("Ct", "dCt", "S2")}


def test_mesh_stage_and_finish_match_one_process(ranks, flat):
    got = ranks[0]
    assert flat["n_chunks"] == 4 * N_FRAMES // int(TAU)
    for k in ("Ct", "dCt", "Ctext", "dCtext"):
        np.testing.assert_allclose(got[k], flat[k], rtol=0, atol=1e-10, err_msg=k)
    np.testing.assert_allclose(got["S2"], flat["S2"], rtol=0, atol=1e-10)
    np.testing.assert_allclose(got["fit_S2"], flat["fit_S2"], rtol=1e-6, atol=1e-12)
    for f in RATES:
        np.testing.assert_allclose(got[f], flat[f], rtol=1e-6, atol=1e-12, err_msg=f)


def test_only_rank_zero_writes_the_one_process_files(system, ranks):
    d = system[0]
    assert ranks[0]["files"] == sorted("m" + s for s in FILES)
    assert all(r["files"] == [] for r in ranks[1:])
    for s in ("_avgvec.dat", "_vecHistogram.npz", "_S2.dat"):
        a, b = d / "mesh" / "rank0" / ("m" + s), d / "flat" / ("m" + s)
        assert a.read_bytes() == b.read_bytes(), s
    for s in ("_Ctint.dat", "_Ctext.dat"):
        a = xvg.load_sxydylist(str(d / "mesh" / "rank0" / ("m" + s)), "legend")
        b = xvg.load_sxydylist(str(d / "flat" / ("m" + s)), "legend")
        assert a[0] == b[0]
        np.testing.assert_allclose(np.asarray(a[2]), np.asarray(b[2]), rtol=0, atol=1e-8)


def test_every_rank_returns_the_same_bits(ranks):
    for r in ranks[1:]:
        for k in ("Ct", "Ctext", "S2", "fit_S2") + RATES:
            np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)


@pytest.mark.parametrize("inputs", ["npy", "xtc"])
def test_mesh_stage_and_finish_match_jax(ranks, jax_ref, inputs):
    """Rank 0's pooled C(t), dC(t) and S2, fitted S2 and rates against the
    JAX package's stage and finish over the same four replicas (the module
    docstring gives the inputs and tolerances)."""
    want64, want32 = jax_ref
    if inputs == "npy":
        got = ranks[0]["npy"]
        for k in ("Ct", "dCt", "S2"):
            assert got[k].shape == want64[k].shape, k
            np.testing.assert_allclose(got[k], want64[k], rtol=0, atol=1e-10, err_msg=k)
        for f in ("fit_S2",) + RATES:
            np.testing.assert_allclose(got[f], want64[f], rtol=1e-6, atol=1e-12, err_msg=f)
    else:
        for k in ("Ct", "dCt", "S2"):
            np.testing.assert_allclose(ranks[0][k], want32[k], rtol=0, atol=1e-5, err_msg=k)


def test_mesh_spans(ranks):
    """Per rank: 12 groups (three a replica) x 2 streams all-reduce spans
    and a barrier for each of the 5 artefacts."""
    groups = 4 * 3
    for r in ranks:
        assert r["spans"] == {"ct_stream.allreduce": 2 * groups, "mesh.barrier": len(FILES)}


def test_one_process_path_records_no_mesh_span(flat):
    assert "stage_ct" in flat["names"] and "run_finish" in flat["names"]
    assert not set(workers.MESH_SPANS) & set(flat["names"])
