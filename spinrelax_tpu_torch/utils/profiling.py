"""Lightweight observability: stage timers + optional torch.profiler traces
(port of ``spinrelax_tpu/utils/profiling.py``).

The reference's only instrumentation is wall-clock prints; this keeps
that convention (the same "Total seconds elapsed" line the reference
tooling greps) and adds structured timings plus an opt-in device trace
under SPINRELAX_TRACE_DIR.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional


class StageTimer:
    """Collects named stage durations; prints a reference-style summary."""

    def __init__(self):
        self.durations: Dict[str, float] = {}
        self._t0 = time.time()

    @contextlib.contextmanager
    def stage(self, name: str):
        t = time.time()
        try:
            yield
        finally:
            self.durations[name] = self.durations.get(name, 0.0) + time.time() - t

    def report(self):
        for name, dur in self.durations.items():
            print(f"= = stage {name}: {dur:g} s")
        print("= = Finished. Total seconds elapsed: %g" % (time.time() - self._t0))


@contextlib.contextmanager
def trace(label: str = "spinrelax", trace_dir: Optional[str] = None):
    """Capture a torch.profiler trace (the host's ops, and the card's
    kernels and copies when CUDA is available) into
    ``<trace_dir>/<label>.json`` when SPINRELAX_TRACE_DIR (or the explicit
    argument) is set; otherwise a no-op."""
    trace_dir = trace_dir or os.environ.get("SPINRELAX_TRACE_DIR")
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(trace_dir, label + ".json"))
