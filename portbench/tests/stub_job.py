"""A job for the tests of N-rank runs (``bench/ranks.py``), kept out of
``jobs/`` so that no workload can name it.

Each rank builds the program's mesh over every rank (``make_mesh``, which
joins the group that torchrun's environment describes), makes two n x n
matrices from the seed and its rank, and a job multiplies them ``reps``
times on its card, scales the column sums of the product by (job + 2) and
sums them over the mesh's "rep" axis.  The check, on rank 0, works the
sum out again in float64 from the same inputs of every rank on rank 0's
"rep" axis: a rank that ran another job, or a sum left out, is not
correct.

Planted faults, from the workload's ``params``, each at [rank, call], the
window's calls of ``run`` counted from 0: ``raise_on`` raises after the
sum; ``exit_on`` ends the rank's process; ``hang_on`` sleeps for an
hour.  ``jax_in_check`` makes the check, on rank 0, put a module named
``jax`` into ``sys.modules``, as a reference that imported it would.
``pid_dir`` names a directory where each rank leaves its process id.
"""

from __future__ import annotations

import os
import sys
import time
import types

import torch
import torch.distributed as dist


def inputs(seed: int, rank: int, n: int):
    g = torch.Generator().manual_seed((seed * 7919 + rank) % (1 << 63))
    return torch.randn(n, n, generator=g), torch.randn(n, n, generator=g)


class Job:
    def __init__(self, ctx):
        self.ctx, self.p, self.dev = ctx, ctx.params, torch.device(ctx.device)
        self.kept, self.calls = {}, -1

    def setup(self):
        from spinrelax_tpu_torch.parallel import mesh as M

        c = self.ctx
        if self.p.get("pid_dir"):
            with open(os.path.join(self.p["pid_dir"], f"rank{c.rank}.pid"), "w") as fp:
                fp.write(str(os.getpid()))
        try:
            self.mesh = M.make_mesh(c.world, device=c.device)
            self.group = M.group(self.mesh, "rep")
            rep, res = M.dims(self.mesh)
            self.peers = [r for r in range(c.world) if r % res == c.rank % res]
            self.how = f"make_mesh({c.world}): rep {rep} x res {res}"
        except Exception as e:  # the harness's proof does not rest on the mesh
            sys.stderr.write(f"rank {c.rank}: make_mesh({c.world}) failed: {e!r}\n")
            if not dist.is_initialized():
                if self.dev.type == "cuda":
                    torch.cuda.set_device(self.dev)
                dist.init_process_group("nccl" if self.dev.type == "cuda" else "gloo",
                                        init_method="env://")
            self.group, self.peers = None, list(range(c.world))
            self.how = f"init_process_group over {c.world} ranks"
        sys.stderr.write(f"rank {c.rank}: {self.how}\n")
        a, b = inputs(c.seed, c.rank, self.p["n"])
        self.a, self.b = a.to(self.dev), b.to(self.dev)

    def _plant(self, key: str) -> bool:
        return self.p.get(key) == [self.ctx.rank, self.calls]

    def run(self, i: int) -> dict:
        self.calls += i >= 0
        if self._plant("exit_on"):
            os._exit(7)
        if self._plant("hang_on"):
            time.sleep(3600)
        for _ in range(self.p["reps"]):
            y = self.a @ self.b
        v = y.sum(0) * (i + 2 if i >= 0 else 1)
        dist.all_reduce(v, group=self.group)
        if self._plant("raise_on"):
            raise RuntimeError("a planted failure")
        self.kept[i] = v.cpu()
        n = self.p["n"]
        return {"work": float(2 * n ** 3 * self.p["reps"])}

    def forget(self, i: int):
        self.kept.pop(i)

    def release(self):
        self.a = self.b = None

    def check(self, i: int) -> list:
        if self.p.get("jax_in_check"):
            sys.modules.setdefault("jax", types.ModuleType("jax"))
        want = sum((a.double() @ b.double()).sum(0)
                   for a, b in (inputs(self.ctx.seed, r, self.p["n"]) for r in self.peers))
        want = want * (i + 2)
        gap = float((self.kept[i].double() - want).abs().max() / want.abs().max())
        limit = self.p["limit"]
        return [dict(name="sum_gap", value=gap, limit=limit, ok=gap <= limit)]
