"""Job kind ``ct_stream_mesh``: replicate trajectories of one protein
analysed jointly, the way ``torchrun --nproc-per-node N -m
spinrelax_tpu_torch ct ... --split G --devices N`` runs them: every rank
calls ``pipeline.stages.stage_ct_streamed`` on all the replicas' files
with the program's ("rep", "res") mesh, so each group's chunks shard over
"rep" and its bonds over "res" (``parallel.streamed.ShardedCtStream``:
kernel A on the rank's block, its sums all-reduced over "rep"), rank 0
writes the files, and then ``parallel.streamed.run_finish(mesh=)`` fits
the residues over every rank and gathers the rates.

The replicas are one protein's: set-up draws one walk of ``replicas``
x ``n_frames`` frames from the seed (``gen.systems.bond_observables``:
each bond's cone, correlation time and libration drawn once) and replica
r is its r-th stretch of ``n_frames``, on every rank alike; a checksum
gathered over the group holds every rank to the same bytes, as every
rank of a deployment reads the same files.  The decoder is stood in for
from host memory as in ``ct_stream``, one file a replica.  With one process (``world`` 1: calibrate, the control) no
mesh is made and the stage runs on one card.

The check, on rank 0, is ``ct_stream``'s: the replicas' observables are
held back to back, one stream of every replica's chunks, so the float64
reference of ``ct_stream.Job.reference`` runs over all of them in
groups on rank 0's card.  Whatever the check reads that a rank holds
only a block of (the C(t) sums, sharded over "res") is gathered inside
the job, on every rank."""

from __future__ import annotations

import math
import os
import shutil
import sys
import time

import numpy as np
import torch

from portbench.jobs import ct_stream
from portbench.reference import physics


def checksum(x: torch.Tensor) -> torch.Tensor:
    """Two int64 sums of a contiguous float32 tensor's bit patterns: of
    them all, and of each leading index's sum weighted by its position (so
    a reordering shows), both kept inside int64's range."""
    per = x.view(torch.int32).reshape(x.shape[0], -1).sum(1, dtype=torch.int64)
    w = torch.arange(x.shape[0]) % 1021 + 1
    return torch.stack([per.sum(), (per % (1 << 31) * w).sum()])


class Job(ct_stream.Job):
    def setup(self):
        from spinrelax_tpu_torch.parallel import mesh as pm

        c, ctx = self.cfg, self.ctx
        self.mesh = pm.make_mesh(ctx.world, device=ctx.device) if ctx.world > 1 else None
        if self.mesh is not None and list(pm.dims(self.mesh)) != c["mesh"]:
            raise ValueError(f"the mesh is {pm.dims(self.mesh)}, the configuration's {c['mesh']}")
        if c["n_frames"] % int(c["tau_mem_ps"] / c["dt_ps"]):
            raise ValueError("a replica's frames are no whole number of Palmer chunks")
        # ct_stream's set-up of one walk of every replica's frames, back to
        # back in pageable host memory as the decoder would return them: the
        # reference reads them as one stream
        self.cfg = dict(c, n_frames=c["replicas"] * c["n_frames"])
        try:
            super().setup()
        finally:
            self.cfg = c
        if self.mesh is not None:
            mine = torch.cat([checksum(torch.from_numpy(a)) for a in (self.raw, self.S)])
            mine = mine.to(self.dev)
            every = pm.all_gather(mine, pm.group(self.mesh)).reshape(ctx.world, -1)
            if not bool((every == mine).all()):
                raise RuntimeError("the ranks' observables differ: every rank reads the same files")
        self.pdbs, self.xtcs = [], []
        for r in range(c["replicas"]):
            d = os.path.join(ctx.work, f"replica{r}")
            os.makedirs(d)
            pdb, xtc = ct_stream.stream_files(d, c)
            self.pdbs.append(pdb)
            self.xtcs.append(xtc)

    def source(self, fn, chunk_frames, idx_h, idx_x, A, threads=1, out_dtype=np.float32):
        """The decoder's stand-in: replica ``fn``'s observables, in groups
        of ``chunk_frames`` frames, as (raw_diff, S, times)."""
        if fn not in self.xtcs or len(idx_h) != self.cfg["n_res"]:
            raise ValueError(f"the stand-in serves {self.xtcs!r} with {self.cfg['n_res']} bonds")
        F, dt = self.cfg["n_frames"], self.cfg["dt_ps"]
        base = self.xtcs.index(fn) * F
        for lo in range(0, F, chunk_frames):
            hi = min(lo + chunk_frames, F)
            yield (self.raw[base + lo: base + hi], self.S[base + lo: base + hi],
                   np.arange(lo, hi, dtype=np.float32) * np.float32(dt))

    def run(self, i: int) -> dict:
        from spinrelax_tpu_torch.parallel import mesh as pm
        from spinrelax_tpu_torch.parallel import streamed
        from spinrelax_tpu_torch.pipeline import stages

        c, nB, mesh = self.cfg, self.cfg["n_res"], self.mesh
        d = os.path.join(self.ctx.work, "warm" if i < 0 else f"job{i}")
        os.makedirs(d)
        before = {k: f.launches for k, f in self.counters.items()}
        t0 = time.perf_counter()
        with self.decoded_from_memory():
            out = stages.stage_ct_streamed(self.xtcs, self.pdbs, os.path.join(d, "ct"),
                                           c["tau_mem_ps"], chunk_groups=c["chunk_groups"],
                                           hist_bins=c["hist_bins"][0], mesh=mesh,
                                           device=self.ctx.device)
        acc = out["acc"]
        t1 = time.perf_counter()
        if mesh is None:
            sums = {k: (acc[f"ct_{k}_s"], acc[f"ct_{k}_s2"]) for k in ("ext", "int")}
            into = (acc["ct_int_s"], acc["ct_int_s2"], out["n_chunks"])
        else:
            into = out["streams"]["int"].accumulators()
        fr = streamed.run_finish(*into, n_res=nB, delta_t=out["delta_t"],
                                 diffusion=self.diffusion, pair=self.pair, vecs=self.vecs,
                                 weights=self.weights, zeta=physics.ZETA, mesh=mesh)
        t2 = time.perf_counter()
        if mesh is not None:  # the check's whole sums, a collective on every rank
            sums = {k: streamed.gather_accumulators(mesh, *out["streams"][k].accumulators()[:2])
                    for k in ("ext", "int")}
        host = {f"ct_{k}_{j}": v[:, :nB].cpu() for k, both in sums.items()
                for j, v in zip(("s", "s2"), both)}
        host.update({k: acc[k].cpu() for k in ("s2_s", "s2_s2")})
        cts = fr.cts
        host["fit"] = dict(S2=cts.S2.cpu(), C=cts.C.cpu(), tau=cts.tau.cpu(),
                           mask=cts.mask.cpu(), s2free=(cts.s2fast > 0).cpu(),
                           chisq=cts.chisq.cpu())
        host["rates"] = {k: getattr(fr, k).cpu() for k in ("R1", "R2", "NOE", "rho")}
        shutil.rmtree(d, ignore_errors=True)
        self.kept[i] = host
        # kernel A's launches on this rank: one a stream and group, on the
        # rank's block of the group's chunks and bonds
        rep, res = pm.dims(mesh) if mesh is not None else (1, 1)
        groups = c["replicas"] * math.ceil(c["n_frames"] // self.fpc / c["chunk_groups"])
        series = math.ceil(c["chunk_groups"] / rep) * math.ceil(nB / res)
        return {"work": float(out["n_chunks"] * self.fpc * nB),
                "acf_shapes": [(series, self.fpc, self.fpc // 2)] * (2 * groups),
                "phases": [("stage_ct_streamed", t0, t1), ("run_finish", t1, t2)],
                "launches": {k: f.launches - before[k] for k, f in self.counters.items()}}

    def check(self, i: int) -> list:
        t0 = time.perf_counter()
        out = super().check(i)
        sys.stderr.write(f"check {time.perf_counter() - t0:.3f} s\n")
        return out
