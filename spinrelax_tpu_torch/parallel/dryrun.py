"""Multi-device dry run of the port: the twin of the JAX package's
``__graft_entry__.dryrun_multichip``.

    python -m spinrelax_tpu_torch.parallel.dryrun [N]

``dryrun_multichip(n)`` runs n ranks on a ("rep", "res") mesh (spawned
gloo ranks on the CPU by default, or the ranks of a group already running,
e.g. under ``torchrun``) through the flagship streamed pipeline on small
shapes: sharded group steps of kernel A's C(t) with group and residue
counts that do not divide the mesh, the production physics with residues
over every rank (DoF-ladder selection, axisymmetric J with PAF vector
ensembles, legacy ensemble rates), then the residue-sharded multi-field
device fit.  Rank 0 prints one "dryrun_multichip OK" line.
"""

from __future__ import annotations

import sys

import numpy as np
import torch
import torch.distributed as dist


def _dryrun_rank(rank: int, world: int, device="cpu") -> str:
    """The dry run on one rank of a ``world``-rank group; returns the
    summary line."""
    from ..constants import NucleusPair, field_from_mhz
    from ..fit.globalfit import GlobalFitter
    from ..io.experiments import ExperimentData
    from ..models.ctmodel import CtModelSet
    from ..models.diffusion import Diffusion
    from ..models.experiments import ExperimentSet
    from ..ops import observables as obs
    from .fit import shard_experiment_set
    from .mesh import dims, make_mesh
    from .streamed import ShardedCtStream, run_sharded_finish

    mesh = make_mesh(world, device=device)
    rep_dim, res_dim = dims(mesh)
    # Residues NOT divisible by the res axis, group chunk counts NOT
    # divisible by the rep axis: every padding and weighting path runs.
    n_frames, n_res = 32, 4 * res_dim + 1
    rng = np.random.default_rng(0)
    # A slow spherical random walk plus a fast AR(1) wobble, continuing
    # across groups: multi-exponential decays, so the ladder walks rungs.
    walk = rng.normal(size=(n_res, 3))
    walk /= np.linalg.norm(walk, axis=-1, keepdims=True)
    wob = np.zeros((n_res, 3))

    def make_group(g):
        nonlocal walk, wob
        out = np.empty((g, n_frames, n_res, 3), dtype=np.float32)
        for c in range(g):
            for t in range(n_frames):
                walk = walk + 0.18 * rng.normal(size=(n_res, 3))
                walk /= np.linalg.norm(walk, axis=-1, keepdims=True)
                wob = 0.45 * wob + rng.normal(size=(n_res, 3))
                v = walk + 0.35 * wob
                out[c, t] = v / np.linalg.norm(v, axis=-1, keepdims=True)
        return out

    dtype = torch.float32 if mesh.device_type == "cuda" else torch.float64
    stream = ShardedCtStream(mesh, n_frames, n_res, dtype=dtype)
    for g in (2 * rep_dim, rep_dim + 1, rep_dim):
        stream.update(make_group(g))
    n_samp = 6
    paf = rng.normal(size=(n_res, n_samp, 3))
    paf /= np.linalg.norm(paf, axis=-1, keepdims=True)
    paf_w = rng.uniform(0.5, 2.0, (n_res, n_samp))
    out = run_sharded_finish(
        mesh, *stream.accumulators(), n_res=n_res, delta_t=1.0,
        diffusion=Diffusion.axisymmetric(diso=1.0 / (6.0 * 500.0), aniso=1.4),
        pair=NucleusPair(time_unit="ps"), vecs=paf, weights=paf_w, zeta=0.89)
    R1 = out.R1.cpu().numpy()
    assert R1.shape == (n_res,)
    assert np.all(np.isfinite(R1)) and np.all(np.isfinite(out.dR1.cpu().numpy()))
    assert tuple(out.Ct.shape) == (n_res, n_frames // 2)
    assert stream.n_chunks == 4 * rep_dim + 1

    # The residue-sharded multi-field fit, its residue count not divisible
    # by the rank count.
    n_fit = world + 3
    names = [str(i + 2) for i in range(n_fit)]
    cts = CtModelSet.from_lists(
        names, rng.uniform(0.7, 0.9, n_fit), list(rng.uniform(0.02, 0.08, (n_fit, 2))),
        list(np.stack([rng.uniform(5, 30, n_fit), rng.uniform(100, 500, n_fit)], -1)),
        s2fast=[True] * n_fit, zeta=0.89, sort=False, device=device)
    vv = rng.normal(size=(n_fit, 8, 3))
    vv /= np.linalg.norm(vv, axis=-1, keepdims=True)
    ww = rng.uniform(0.5, 2.0, (n_fit, 8))
    pair = NucleusPair(B0=field_from_mhz(600.133), time_unit="ps")
    rates = obs.predict_rates_newapi(pair, Diffusion.axisymmetric(diso=4e-5, aniso=1.5),
                                     cts, vecs=torch.as_tensor(vv, device=cts.S2.device),
                                     weights=torch.as_tensor(ww, device=cts.S2.device))
    expts = [
        ExperimentData(expt_type=t, nuclei_a="15N", nuclei_b="1H", frequency=600.133,
                       freq_unit="MHz", names=np.array(names), values=va.cpu().numpy().copy(),
                       errors=np.maximum(er.cpu().numpy(), 1e-3))
        for t, va, er in (("R1", rates.R1, rates.dR1), ("R2", rates.R2, rates.dR2))
    ]
    es = shard_experiment_set(ExperimentSet.build(
        expts, cts, Diffusion.axisymmetric(diso=4.6e-5, aniso=1.5), vecs=vv, weights=ww), mesh)
    state = GlobalFitter(es, ["Diso"]).run(method="device")
    assert np.isfinite(state.chisq)
    assert abs(state.diso / 4e-5 - 1.0) < 0.05, state.diso
    kmax_sel = int(out.cts.mask.sum(1).max())
    return (f"dryrun_multichip OK: mesh {dims(mesh)} axes {tuple(mesh.mesh_dim_names)}, "
            f"streamed {stream.n_chunks} chunks -> DoF ladder (full rung walk, "
            f"selected Kmax={kmax_sel}) -> symmtop-ensemble rates, R1 mean "
            f"{float(R1.mean()):.4g}, sharded-fit Diso {state.diso:.3e}")


def dryrun_multichip(n_devices: int = 8, device="cpu", timeout: float = 300.0) -> str:
    """Run the dry run on ``n_devices`` ranks and print (and return) rank
    0's summary line: in this process's group when one of that size is
    running, else in ``n_devices`` spawned ranks on ``device``."""
    if dist.is_initialized() and dist.get_world_size() == n_devices:
        line = _dryrun_rank(dist.get_rank(), n_devices, device)
        if dist.get_rank() != 0:
            return line
    else:
        from .launch import spawn

        line = spawn(_dryrun_rank, n_devices, device, device=device, timeout=timeout)[0]
    print(line)
    return line


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
