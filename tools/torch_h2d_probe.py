#!/usr/bin/env python3
"""Host-to-card copy rates of one streamed C(t) group, on the card.

    python3 tools/torch_h2d_probe.py [--mb 89.52] [--pool-gb 2.24] [--procs 4] [--reps 20]

A group of the mbp cells is 20 000 frames x (370 bonds x 3 + 9) float32
values, 89.52 MB, and a job streams 2.24 GB of them.  Each copy takes the
next group of a ``--pool-gb`` source (so no cache holds it, as in the
stage) into one of two pinned slots in turn.  Prints one JSON line each
for:

- ``dma``: a pinned block to the card with ``non_blocking=True`` on a side
  stream, and a pageable block with a blocking copy (CUDA events);
- ``host``: a pageable numpy array into a pinned block, by
  ``numpy.copyto``, and by torch's ``copy_`` on its intra-op pool as the
  process has it and on 1, 2, 4, 8 threads and every core of the
  affinity (``pipeline.h2d.intra_op_threads``, as the stage stages a
  slot);
- ``concurrent``: ``--procs`` processes at once, each on card
  ``i % cards``, each with torch's ``copy_`` on ``cores // procs``
  threads (the stage's share under a mesh), then on its pool as the
  process has it, then each its pinned DMA: every process's rate and
  their sum.

Rates are GB/s (1e9 bytes), medians over ``--reps`` copies after a warm
one.  Needs a card; exits 1 without one.
"""

import argparse
import json
import multiprocessing as mp
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from spinrelax_tpu_torch.pipeline.h2d import intra_op_threads  # noqa: E402


def _median_rate(nbytes, times):
    return nbytes / statistics.median(times) / 1e9


def _host_times(fn, reps):
    """Times of ``fn(k)`` for k = 1..reps, after a warm ``fn(0)``."""
    fn(0)
    out = []
    for k in range(1, reps + 1):
        t0 = time.perf_counter()
        fn(k)
        out.append(time.perf_counter() - t0)
    return out


def _dma_times(dst, srcs, reps, non_blocking, stream=None):
    """Event times of copies of ``srcs[k % len(srcs)]`` to ``dst``."""
    stream = stream or torch.cuda.current_stream()
    out = []
    with torch.cuda.stream(stream):
        dst.copy_(srcs[0], non_blocking=non_blocking)
        for k in range(1, reps + 1):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record(stream)
            dst.copy_(srcs[k % len(srcs)], non_blocking=non_blocking)
            b.record(stream)
            b.synchronize()
            out.append(a.elapsed_time(b) / 1e3)
    return out


class Source:
    """A pool of ``pool`` bytes of float32 in groups of ``nbytes``, and two
    pinned slots of a group each."""

    def __init__(self, nbytes, pool, seed=0):
        n = nbytes // 4
        self.groups = max(2, pool // nbytes)
        self.pool = np.random.default_rng(seed).standard_normal(n * self.groups,
                                                                dtype=np.float32)
        self.pool = self.pool.reshape(self.groups, n)
        self.slots = [torch.empty(n, dtype=torch.float32, pin_memory=True) for _ in range(2)]
        self.nbytes = n * 4

    def pair(self, k):
        return self.pool[k % self.groups], self.slots[k % 2]

    def torch_copy(self, k, threads=None):
        src, dst = self.pair(k)
        with intra_op_threads(threads or torch.get_num_threads()):
            dst.copy_(torch.from_numpy(src))

    def numpy(self, k):
        src, dst = self.pair(k)
        np.copyto(dst.numpy(), src)


def _worker(i, procs, nbytes, pool, reps, barrier, queue):
    dev = torch.device("cuda", i % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    threads = max(1, len(os.sched_getaffinity(0)) // procs)
    s = Source(nbytes, pool, seed=i)
    dst = torch.empty(s.slots[0].shape, dtype=torch.float32, device=dev)
    out = {"proc": i, "device": str(dev), "threads": threads}
    for name, fn in (("torch_copy_share", lambda k: s.torch_copy(k, threads)),
                     ("torch_copy_pool", s.torch_copy)):
        barrier.wait()
        out[name] = _median_rate(s.nbytes, _host_times(fn, reps))
    barrier.wait()
    out["dma_pinned"] = _median_rate(s.nbytes, _dma_times(dst, s.slots, reps, True,
                                                          torch.cuda.Stream(dev)))
    queue.put(out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=float, default=89.52)
    ap.add_argument("--pool-gb", type=float, default=2.24)
    ap.add_argument("--procs", type=int, default=4)
    ap.add_argument("--reps", type=int, default=20)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        sys.exit(1)
    nbytes = int(a.mb * 1e6) // 64 * 64
    pool = int(a.pool_gb * 1e9)
    cores = len(os.sched_getaffinity(0))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    print(json.dumps({"cards": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
                      "torch_threads": torch.get_num_threads(), "affinity_cores": cores,
                      "cpu_count": os.cpu_count(), "bytes": nbytes}), flush=True)

    s = Source(nbytes, pool)
    dst = torch.empty(s.slots[0].shape, dtype=torch.float32, device="cuda")
    pageable = [torch.from_numpy(g) for g in s.pool]
    dma = {"pinned_side_stream": _median_rate(s.nbytes, _dma_times(dst, s.slots, a.reps, True,
                                                                   torch.cuda.Stream())),
           "pageable_blocking": _median_rate(s.nbytes, _dma_times(dst, pageable, a.reps, False))}
    print(json.dumps({"dma": dma}), flush=True)

    host = {"numpy_copyto": _median_rate(s.nbytes, _host_times(s.numpy, a.reps)),
            "torch_copy_pool": _median_rate(s.nbytes, _host_times(s.torch_copy, a.reps))}
    for t in sorted({1, 2, 4, 8, cores}):
        host[f"torch_copy_{t}"] = _median_rate(s.nbytes, _host_times(
            lambda k: s.torch_copy(k, t), a.reps))
    src, slot = s.pair(a.reps)
    assert np.array_equal(slot.numpy(), src)
    print(json.dumps({"host": host}), flush=True)
    del s, dst, pageable

    ctx = mp.get_context("spawn")
    barrier, queue = ctx.Barrier(a.procs), ctx.Queue()
    ps = [ctx.Process(target=_worker, args=(i, a.procs, nbytes, pool // a.procs, a.reps,
                                            barrier, queue))
          for i in range(a.procs)]
    for p in ps:
        p.start()
    got = sorted((queue.get(timeout=600) for _ in ps), key=lambda r: r["proc"])
    for p in ps:
        p.join(timeout=60)
    print(json.dumps({"concurrent": got, "sum": {k: sum(r[k] for r in got) for k in
                                                 ("torch_copy_share", "torch_copy_pool",
                                                  "dma_pinned")}}),
          flush=True)


if __name__ == "__main__":
    main()
