"""The port's tracing: spans and counters, and a torch.profiler trace of a
command under SPINRELAX_TRACE_DIR.

- :class:`span` marks a piece of host work by name.  While a torch
  profiler is active (``torch.autograd.profiler._is_profiler_enabled``,
  read once at entry; any profiler's activities) it appends
  ``(name, t0_ns, t1_ns, parent)`` to an in-memory buffer, on
  ``time.perf_counter_ns()``, with ``parent`` the buffer index of the
  enclosing open span (-1 at the top), and opens
  ``torch.profiler.record_function(name)``, so a trace shows it beside the
  kernels.  Otherwise it costs that one read.
- :func:`count` adds to an always-on total by name; while a profiler is
  active it also appends ``(t_ns, name, n)``, so a reader can sum a
  counter inside a window.
- :func:`counters` snapshots every counter the port keeps: the kernels'
  launch counters, ``fit.host_reads`` and the totals of :func:`count`.
- The buffer holds at most ``CAPACITY`` spans and events together; past
  it, entries are dropped and counted as ``profiling.dropped``.
  :func:`spans` and :func:`events` read it, :func:`clear` empties it.

Spans nest on one module-level stack: the stage and the LM loop run on
one thread.  Nothing here synchronises with the card: a span reads the
host clock only.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional

import torch
import torch.autograd.profiler as _autograd_profiler

CAPACITY = 1 << 16

_spans: list = []  # [name, t0_ns, t1_ns or None while open, parent]
_events: list = []  # (t_ns, name, n)
_stack: list = []  # buffer indices of the open recorded spans (None: dropped)
_drops = [None, None]  # first and last drop, perf_counter_ns
_totals = {"stage_ct.h2d_bytes": 0, "stage_ct.h2d_pinned_bytes": 0,
           "stage_ct.write_bytes": 0, "fit.host_looks": 0,
           "xvg.native_sets": 0, "xvg.row_sets": 0, "profiling.dropped": 0}


def _drop(t_ns: int) -> None:
    _totals["profiling.dropped"] += 1
    if _drops[0] is None:
        _drops[0] = t_ns
    _drops[1] = t_ns


class span(contextlib.ContextDecorator):
    """``with span("stage_ct.write"): ...``, or ``@span("run_finish")`` on a
    function (each call is its own span)."""

    def __init__(self, name: str):
        self.name = name
        self._rec = None

    def _recreate_cm(self):
        return span(self.name)

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            self._open()
        return self

    def _open(self):
        rf = torch.profiler.record_function(self.name)
        rf.__enter__()
        t0 = time.perf_counter_ns()
        if len(_spans) + len(_events) >= CAPACITY:
            _drop(t0)
            i = None
        else:
            parent = _stack[-1] if _stack and _stack[-1] is not None else -1
            i = len(_spans)
            _spans.append([self.name, t0, None, parent])
        _stack.append(i)
        self._rec = (rf, i)

    def __exit__(self, *exc):
        if self._rec is not None:
            t1 = time.perf_counter_ns()
            rf, i = self._rec
            self._rec = None
            _stack.pop()
            if i is not None:
                _spans[i][2] = t1
            rf.__exit__(*exc)
        return False


def spanned(name: str, iterable):
    """Yield ``iterable``'s items, each wait for the next one inside
    ``span(name)`` (the last, which finds the end, too)."""
    it = iter(iterable)
    while True:
        with span(name):
            try:
                item = next(it)
            except StopIteration:
                return
        yield item


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the total ``name``; while a profiler is active, also
    record ``(t_ns, name, n)``."""
    _totals[name] = _totals.get(name, 0) + n
    if _autograd_profiler._is_profiler_enabled:
        t = time.perf_counter_ns()
        if len(_spans) + len(_events) >= CAPACITY:
            _drop(t)
        else:
            _events.append((t, name, n))


def counters() -> dict:
    """{name: total} of every counter the port keeps: ``launches.A`` ..
    ``launches.E`` (kernel A; B, C, D, E of the LM), ``fit.host_reads``,
    and every :func:`count` total."""
    from ..fit import globalfit
    from ..ops import cuda_acf, cuda_lm

    out = {"launches.A": cuda_acf.acf_lag_sums.launches,
           "launches.B": cuda_lm.hgc_cuda.launches,
           "launches.C": cuda_lm.cost_cuda.launches,
           "launches.D": cuda_lm.step_solve_cuda.launches,
           "launches.E": cuda_lm.step_gate_cuda.launches,
           "fit.host_reads": globalfit.host_reads.count}
    out.update(_totals)
    return out


def spans() -> list:
    """The recorded spans, ``(name, t0_ns, t1_ns, parent)`` in the order
    they opened (``t1_ns`` None while open)."""
    return [tuple(s) for s in _spans]


def events() -> list:
    """The recorded counts, ``(t_ns, name, n)`` in time order."""
    return list(_events)


def dropped_between(t0_ns: int, t1_ns: int) -> bool:
    """Whether an entry was dropped inside [t0_ns, t1_ns] since the last
    :func:`clear`."""
    return _drops[0] is not None and _drops[0] <= t1_ns and _drops[1] >= t0_ns


def clear() -> None:
    """Empty the buffer; call it with no span open."""
    _spans.clear()
    _events.clear()
    _drops[:] = [None, None]


@contextlib.contextmanager
def trace(label: str = "spinrelax", trace_dir: Optional[str] = None):
    """Capture a torch.profiler trace (the host's ops and the spans, and
    the card's kernels and copies when CUDA is available) into
    ``<trace_dir>/<label>.json`` when SPINRELAX_TRACE_DIR (or the explicit
    argument) is set, with the counters' changes over the block under
    ``spinrelax_counters``, also when the block raises; otherwise a
    no-op."""
    trace_dir = trace_dir or os.environ.get("SPINRELAX_TRACE_DIR")
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    before = counters()
    prof = profile(activities=acts)
    try:
        with prof:
            try:
                yield
            finally:
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                prof.add_metadata_json("spinrelax_counters", json.dumps(
                    {k: v - before.get(k, 0) for k, v in counters().items()}))
    finally:
        prof.export_chrome_trace(os.path.join(trace_dir, label + ".json"))
