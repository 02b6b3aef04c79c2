"""Rank functions of the port's multi-rank CPU tests.

Each runs in a gloo rank that ``spinrelax_tpu_torch.parallel.launch.spawn``
starts, on inputs the test made with numpy, and returns numpy results for
the test to hold against the JAX package.  This module imports torch,
numpy and the port only: a spawned rank never loads JAX.
"""

import os
import time

import numpy as np
import torch
import torch.distributed as dist

from spinrelax_tpu_torch.constants import NucleusPair, field_from_mhz
from spinrelax_tpu_torch.io.experiments import ExperimentData
from spinrelax_tpu_torch.models.ctmodel import CtModelSet
from spinrelax_tpu_torch.models.diffusion import Diffusion
from spinrelax_tpu_torch.parallel.mesh import dims, make_mesh


def _np(x):
    return None if x is None else x.detach().cpu().numpy()


def diffusion(kind):
    if kind == "axisymmetric":
        return Diffusion.axisymmetric(diso=4e-5, aniso=1.5)
    if kind == "ellipsoid":
        return Diffusion.ellipsoid(np.array([2.8e-5, 3.6e-5, 5.6e-5]))
    return Diffusion.isotropic(diso=4e-5)


def experiment_set(fit):
    """The port's ExperimentSet of ``fit`` (plain arrays: names, S2, C,
    tau, v, w, zeta and the experiments as dicts), on the CPU."""
    from spinrelax_tpu_torch.models.experiments import ExperimentSet

    n = len(fit["names"])
    cts = CtModelSet.from_lists(fit["names"], fit["S2"], list(fit["C"]), list(fit["tau"]),
                                s2fast=[True] * n, zeta=fit["zeta"], sort=False,
                                device="cpu")
    expts = [ExperimentData(**e) for e in fit["expts"]]
    start = Diffusion.axisymmetric(diso=4.6e-5, aniso=1.3)
    return ExperimentSet.build(expts, cts, start, vecs=fit["v"], weights=fit["w"])


def parallel_checks(rank, world, data):
    """Every check of tests/test_torch_parallel.py on one mesh."""
    from spinrelax_tpu_torch.fit.globalfit import GlobalFitter, chisq_total
    from spinrelax_tpu_torch.ops.autocorr import ct_palmer_scan, ct_palmer_streamed
    from spinrelax_tpu_torch.parallel.fit import shard_experiment_set
    from spinrelax_tpu_torch.parallel.ingest import (
        CtPartial, host_stream, reduce_partials, reduce_partials_collective)
    from spinrelax_tpu_torch.parallel.pipeline import make_sharded_forward
    from spinrelax_tpu_torch.parallel.streamed import (
        ShardedCtStream, run_sharded_finish, run_streamed_pipeline)

    mesh = make_mesh(world, device="cpu")
    out = {"dims": np.array(dims(mesh))}

    v = torch.from_numpy(data["stream_vecs"])
    groups = [v[:3], v[3:9], v[9:]]  # 3 + 6 + 1 chunks, 11 residues
    Ct, dCt = ct_palmer_streamed(iter(groups), v.shape[1], mesh=mesh)
    out["streamed_Ct"], out["streamed_dCt"] = _np(Ct), _np(dCt)
    r = run_streamed_pipeline(iter(groups), mesh, v.shape[1], v.shape[2], tau_iso=500.0)
    out.update({f"pipe_{k}": _np(getattr(r, k)) for k in ("R1", "NOE", "S2")})

    Ct, dCt = ct_palmer_scan(torch.from_numpy(data["scan_vecs"]), batch=4, mesh=mesh)
    out["scan_Ct"], out["scan_dCt"] = _np(Ct), _np(dCt)

    f = make_sharded_forward(mesh, tau_iso=500.0)(torch.from_numpy(data["fwd_vecs"]))
    out.update({f"fwd_{k}": _np(getattr(f, k)) for k in ("Ct", "R1", "NOE")})

    iv = torch.from_numpy(data["ingest_vecs"])
    pa = host_stream(iter([iv[:2], iv[2:4]]), iv.shape[1])
    pb = host_stream(iter([iv[4:]]), iv.shape[1])
    out["ingest_Ct"], out["ingest_dCt"] = map(_np, reduce_partials([pa, pb]))
    row = rank // dims(mesh)[1]
    lo, hi = data["ingest_rows"][row]
    mine = host_stream(iter([iv[lo:hi]]), iv.shape[1])
    assert isinstance(mine, CtPartial)
    out["ingest_coll_Ct"], out["ingest_coll_dCt"] = map(
        _np, reduce_partials_collective(mine, mesh))

    es = experiment_set(data["fit"])
    es_sh = shard_experiment_set(es, mesh)
    out["fit_n_total"] = es_sh.n_global
    csa = torch.full((es_sh.n_residues,), -170e-6, dtype=torch.float64)
    out["fit_chisq"] = float(chisq_total(es_sh, 4.6e-5, 1.3, es.cts.zeta, csa))
    st = GlobalFitter(es_sh, ["Diso", "Daniso"]).run(method="device")
    out["fit_device"] = np.array([st.diso, st.aniso, st.chisq])

    chunks = torch.from_numpy(data["scalar_csa_chunks"])
    stream = ShardedCtStream(mesh, chunks.shape[1], chunks.shape[2], dtype=torch.float64)
    stream.update(chunks)
    fin = run_sharded_finish(mesh, *stream.accumulators(), n_res=chunks.shape[2],
                             delta_t=1.0, diffusion=Diffusion.isotropic(diso=4e-5),
                             csa=np.float64(-1.7e-4))
    out["scalar_csa_R1"] = _np(fin.R1)
    return out


def flagship_checks(rank, world, data):
    """run_sharded_finish for each diffusion kind (tests/test_torch_flagship_sharded.py)."""
    from spinrelax_tpu_torch.parallel.streamed import ShardedCtStream, run_sharded_finish

    mesh = make_mesh(world, device="cpu")
    chunks = torch.from_numpy(data["chunks"])
    n_frames, n_res = chunks.shape[1], chunks.shape[2]
    pair = NucleusPair(B0=field_from_mhz(600.133), time_unit="ps")
    out = {}
    for kind in ("axisymmetric", "isotropic", "ellipsoid"):
        aniso = kind != "isotropic"
        stream = ShardedCtStream(mesh, n_frames, n_res, dtype=torch.float64)
        stream.update(chunks[:4])
        stream.update(chunks[4:])  # 3 chunks: not divisible by the rep axis
        fin = run_sharded_finish(
            mesh, *stream.accumulators(), n_res=n_res, delta_t=1.0,
            diffusion=diffusion(kind), pair=pair,
            vecs=data["vecs"] if aniso else None, weights=data["weights"] if aniso else None,
            csa=data["csa"], zeta=0.89, names=data["names"])
        res = {"Ct": _np(fin.Ct), "dCt": _np(fin.dCt), "S2": _np(fin.cts.S2),
               "mask": _np(fin.cts.mask)}
        for f in ("R1", "R2", "NOE", "rho", "dR1", "dR2", "dNOE", "drho"):
            res[f] = _np(getattr(fin, f))
        out[kind] = res
    one = torch.from_numpy(data["one_chunk"])
    stream = ShardedCtStream(mesh, one.shape[1], one.shape[2], dtype=torch.float64)
    stream.update(one)
    fin = run_sharded_finish(mesh, *stream.accumulators(), n_res=one.shape[2],
                             delta_t=1.0, diffusion=Diffusion.isotropic(diso=4e-5))
    out["one_chunk"] = {f: _np(getattr(fin, f)) for f in ("dCt", "R1", "R2", "NOE", "rho")}
    return out


def cli_checks(rank, world, d):
    """fit-ct --devices and stage_multifield(devices=) in directory ``d``,
    the output names with prefix "mesh"; returns the files this rank wrote
    and the fitted parameters."""
    from spinrelax_tpu_torch.models.diffusion import Diffusion as D
    from spinrelax_tpu_torch.pipeline import cli
    from spinrelax_tpu_torch.pipeline.stages import stage_multifield

    before = set(os.listdir(d))
    cli.main(["fit-ct", "-f", os.path.join(d, "in_Ctint.dat"), "-o",
              os.path.join(d, "mesh"), "--devices", str(world)], device="cpu")
    final = stage_multifield(
        os.path.join(d, "in_fittedCt.dat"), sorted(
            os.path.join(d, f) for f in before if f.startswith("expt_")),
        os.path.join(d, "mesh"), D.axisymmetric(diso=4.6e-5, aniso=1.3),
        vec_file=os.path.join(d, "vecs.npz"), zeta=0.89, opt_params=["Diso", "rsCSA"],
        max_cycles=4, method="device", devices=world, device="cpu")
    dist.barrier()
    return {"final": np.concatenate([[final["diso"], final["aniso"], final["chisq"]],
                                     final["csa"]]),
            "mine": sorted(set(os.listdir(d)) - before) if rank == 0 else None}


def fail_on_rank1(rank, world):
    """Rank 1 raises while the others wait for it in a barrier."""
    if rank == 1:
        raise RuntimeError("rank 1 fails")
    dist.barrier()


def sleep_forever(rank, world):
    time.sleep(3600)


def runall_checks(rank, world, d, xtc, ref):
    """run-all -stream 2 -devices ``world`` in directory ``d`` (every rank
    calls run_workflow; rank 0 writes); returns its summary."""
    from spinrelax_tpu_torch.pipeline import config, runall

    os.chdir(d)
    cfg = config.WorkflowConfig(
        io=config.IOParams(outpref="rotdif", traj=xtc, refpdb=ref, qfile="colvar-qorient",
                           stream_groups=2, devices=world),
        tumbling=config.TumblingParams(tau_mem=400.0, num_chunks=4),
        experiments=config.ExperimentParams(bfields_mhz=(600.133,)))
    out = runall.run_workflow(cfg, device="cpu")
    return {k: out[k] for k in ("diso", "dani", "quat")}


MESH_SPANS = ("ct_stream.allreduce", "mesh.barrier")


def stream_mesh_checks(rank, world, xtcs, refs, d, kw):
    """stage_ct_streamed over every replica's file with the mesh (float64,
    each rank writing under ``d/rank<r>``), then run_finish(mesh=), inside
    a CPU profiler (tests/test_torch_mesh_stream.py); then, unprofiled, the
    same over the replicas' decoded frames as float64 .npy (``kw["npys"]``,
    written under ``d/npy<r>``).  Returns the C(t), S2 and rates of both,
    the files this rank wrote and the mesh spans' tallies."""
    from torch.profiler import ProfilerActivity, profile

    from spinrelax_tpu_torch.parallel.streamed import run_finish
    from spinrelax_tpu_torch.pipeline.stages import stage_ct_streamed
    from spinrelax_tpu_torch.utils import profiling

    mesh = make_mesh(world, device="cpu")

    def both(trj, prefix, **opt):
        out = stage_ct_streamed(trj, refs, prefix, kw["tau"], chunk_groups=kw["groups"],
                                mesh=mesh, device="cpu", dtype=torch.float64, **opt)
        fin = run_finish(*out["streams"]["int"].accumulators(), n_res=kw["n_res"],
                         delta_t=out["delta_t"], diffusion=diffusion("axisymmetric"),
                         pair=NucleusPair(B0=field_from_mhz(600.133), time_unit="ps"),
                         vecs=kw["vecs"], weights=kw["weights"], zeta=0.89, mesh=mesh)
        ext = out["streams"]["ext"].finalize()
        res = {"Ct": out["Ct"], "dCt": out["dCt"], "Ctext": _np(ext[0]), "dCtext": _np(ext[1]),
               "S2": out["S2"], "fit_S2": _np(fin.cts.S2)}
        res.update({f: _np(getattr(fin, f)) for f in ("R1", "R2", "NOE", "rho")})
        return res

    mine = os.path.join(d, f"rank{rank}")
    os.makedirs(mine)
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        res = both(xtcs, os.path.join(mine, "m"))
    names = [s[0] for s in profiling.spans()]
    profiling.clear()
    res["spans"] = {n: names.count(n) for n in MESH_SPANS}
    res["files"] = sorted(os.listdir(mine))
    os.makedirs(os.path.join(d, f"npy{rank}"))
    res["npy"] = both(kw["npys"], os.path.join(d, f"npy{rank}", "n"), timestep=kw["dt"])
    return res
