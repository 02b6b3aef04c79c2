"""The four-card cell ``mbp-ct-stream-4`` on the CPU (``jobs/ct_stream_mesh.py``):
a whole run on 4 gloo rank processes at a tiny size comes out correct on
four devices; the all-reduces over "rep" left out on every rank make it
not correct; its reference over the replicas is a direct float64 Palmer
computation over all their chunks, and each replica's file is served its
own stretch of the walk; the three readers new with the cell read the
program's mesh spans and NCCL kernels, the copies' reader the window of
a mesh job, and each reads nothing where there is nothing to read (a
program without the mesh spans)."""

from __future__ import annotations

import math
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import run as R  # noqa: E402
from portbench.bench import spec  # noqa: E402

CELL = "mbp-ct-stream-4"
TINY = dict(n_res=16, n_frames=8000, tau_mem_ps=1000.0, hist_samples=2000)
READERS = ("ct_allreduce_s.ct4", "nccl_ms.ct4", "mesh_barrier_s.ct4")


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_job(seed, work, rank=0, world=1, **cfg):
    wl = spec.workload(CELL)
    ctx = R.Ctx(dict(spec.config(wl["config"]), **{**TINY, **cfg}), wl, seed, "cpu", work,
                rank, world)
    return spec.job(wl["job"]).Job(ctx)


@pytest.mark.parametrize("trace", [0, 1])
def test_four_rank_run_is_correct(trace):
    assert R.chips_of(CELL) == 4
    args = R.parse(["--workload", CELL, "--seed", str(2**31 + 11), "--seconds", "1",
                    "--trace", str(trace)])
    res = R.run(args, device="cpu", cfg_override=TINY, emit=False)
    assert res is not None and res["correct"], res and res["compared"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    per = res["device"]["per_device"]
    assert res["device"]["count"] == 4 and [c["uuid"] for c in per] == [f"cpu:{r}" for r in
                                                                         range(4)]
    assert {c["jobs"] for c in per} == {res["attempted"]}
    # no profiler runs on the CPU, so the traced run's readers find nothing
    # but the job's own launch counts (kernel B's: none on the CPU)
    assert set(res["metrics"]) == ({"lm_steps.ct"} if trace else
                                   {"ct_bondframes_per_s", "setup_s"})
    if trace:
        assert res["metrics"]["lm_steps.ct"]["value"] == 0.0


def fault_rank(rank, world, seed):
    """A rank of the job with the program's all-reduces left out: each
    rank keeps only its own chunks' sums.  Returns rank 0's check."""
    from spinrelax_tpu_torch.parallel import mesh as pm

    pm.all_reduce = lambda t, mesh, axis=None: t
    job = tiny_job(seed, tempfile.mkdtemp(prefix="portbench-fault-"), rank, world)
    job.setup()
    job.run(0)
    return job.check(0) if rank == 0 else None


def test_allreduce_left_out_is_not_correct():
    from spinrelax_tpu_torch.parallel.launch import spawn

    verdict = spawn(fault_rank, 4, 2**31 + 12, device="cpu", timeout=240.0)[0]
    bad = {v["name"] for v in verdict if not v["ok"]}
    assert {"ct_int", "ct_ext"} <= bad, verdict


def test_reference_is_a_direct_palmer_over_the_replicas(tmp_path):
    """Replica r is frames [r F, (r + 1) F) of one walk from the seed, its
    file is served exactly those, and the reference's pooled C(t) (both
    orientations) and S2 are a direct float64 sum over every lag of every
    chunk of every replica, the SEM with sqrt(n) - 1."""
    from portbench.gen import systems
    from portbench.reference import traj

    seed, F, fpc = 2**31 + 13, 1200, 100
    job = tiny_job(seed, str(tmp_path), n_res=3, n_frames=F, tau_mem_ps=200.0,
                   hist_samples=200)
    job.setup()
    raw, S = systems.bond_observables(dict(job.cfg, n_frames=4 * F), seed, "cpu")
    np.testing.assert_array_equal(job.raw, raw.numpy())
    np.testing.assert_array_equal(job.S, S.numpy())
    for r, xtc in enumerate(job.xtcs):
        served = list(job.source(xtc, 500, range(3), None, None))
        assert [len(a) for a, _, _ in served] == [500, 500, 200]
        np.testing.assert_array_equal(np.concatenate([a for a, _, _ in served]),
                                      job.raw[r * F:(r + 1) * F])
    ref = job.reference()

    q = traj.horn_quats(torch.from_numpy(job.S).double())
    ext, fit = (v.numpy().reshape(-1, fpc, 3, 3)
                for v in traj.bond_vectors(torch.from_numpy(job.raw).double(), q))
    n, D = ext.shape[0], fpc // 2
    assert n == job.n_chunks == 4 * F // fpc
    for key, v in (("int", fit), ("ext", ext)):
        ct = np.empty((n, 3, D))
        for d in range(1, D + 1):
            dots = (v[:, :-d] * v[:, d:]).sum(-1)  # (chunk, pair, bond)
            ct[:, :, d - 1] = (1.5 * dots ** 2 - 0.5).mean(1)
        np.testing.assert_allclose(ref[key][0].numpy(), ct.mean(0), rtol=0, atol=1e-12)
        np.testing.assert_allclose(ref[key][1].numpy(), ct.std(0) / (math.sqrt(n) - 1),
                                   rtol=1e-9, atol=1e-14)
    outer = np.einsum("cfbi,cfbj->cbij", fit, fit) / fpc
    s2 = 1.5 * (outer ** 2).sum((-2, -1)) - 0.5
    np.testing.assert_allclose(ref["s2"][0].numpy(), s2.mean(0), rtol=0, atol=1e-12)


class View:
    """What a reader sees of a traced window (``run.TraceView``'s part)."""

    kernel_seconds = R.TraceView.kernel_seconds

    def __init__(self, records, kernels):
        self.records, self.kernels = records, kernels


def recorded(with_mesh: bool):
    """Two jobs' worth of the program's spans and counter under a CPU
    profiler; with ``with_mesh`` the mesh's spans too."""
    from spinrelax_tpu_torch.utils import profiling

    profiling.clear()
    records = []
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            t0 = time.perf_counter()
            with profiling.span("stage_ct"):
                profiling.count("stage_ct.h2d_bytes", 3_000_000_000)
                for _ in range(3 if with_mesh else 0):
                    with profiling.span("ct_stream.allreduce"):
                        time.sleep(0.002)
                if with_mesh:
                    with profiling.span("mesh.barrier"):
                        time.sleep(0.004)
            records.append({"t0": t0, "t1": time.perf_counter()})
    spans = profiling.spans()
    return records, spans


def test_readers_read_the_mesh_spans_and_kernels():
    from spinrelax_tpu_torch.utils import profiling

    records, spans = recorded(True)
    kernels = {"ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)":
               (600, 0.5), "acf_lag_sums_kernel<float>": (200, 3.0),
               "Memcpy HtoD (Pageable -> Device)": (400, 1.5)}
    got = {m: spec.reader(m).read(View(records, kernels)) for m in READERS + ("ct_h2d_gbps.ct",)}
    profiling.clear()
    per_job = {name: sum(s[2] - s[1] for s in spans if s[0] == name) / 2e9
               for name in ("ct_stream.allreduce", "mesh.barrier")}
    assert got["ct_h2d_gbps.ct"] == pytest.approx(2 * 3.0 / 1.5)
    assert got["ct_allreduce_s.ct4"] == pytest.approx(per_job["ct_stream.allreduce"])
    assert got["mesh_barrier_s.ct4"] == pytest.approx(per_job["mesh.barrier"])
    assert got["ct_allreduce_s.ct4"] >= 0.006 and got["mesh_barrier_s.ct4"] >= 0.004
    assert got["nccl_ms.ct4"] == pytest.approx(250.0)


def test_readers_read_nothing_without_the_mesh_spans():
    """A program without the mesh's spans (the parent of the change that
    adds them), or a window with no profiler, reads None, not 0."""
    from spinrelax_tpu_torch.utils import profiling

    records, _ = recorded(False)
    got = {m: spec.reader(m).read(View(records, {})) for m in READERS}
    profiling.clear()
    assert got == {"ct_allreduce_s.ct4": None, "nccl_ms.ct4": None,
                   "mesh_barrier_s.ct4": None}
    assert all(spec.reader(m).read(View(records, {})) is None for m in READERS)
