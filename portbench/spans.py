"""What the readers of the port's spans and counters share
(``spinrelax_tpu_torch.utils.profiling``): the entries recorded inside
the traced window, ``[records[0]["t0"], records[-1]["t1"]]``.  Spans and
the job records are stamped on one clock (``time.perf_counter``).

:func:`window` gives None, so its reader gives None, where the checkout's
program keeps no spans, where the window holds no span (nothing was
recorded: no profiler was active) or where the buffer dropped an entry
inside it."""

from __future__ import annotations


def window(t):
    """(spans, events) inside the window of the TraceView ``t``: spans as
    (index, name, t0_ns, t1_ns, parent), events as (t_ns, name, n); or
    None."""
    try:
        from spinrelax_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not t.records or not hasattr(profiling, "dropped_between"):
        return None
    lo, hi = int(t.records[0]["t0"] * 1e9), int(t.records[-1]["t1"] * 1e9)
    spans = [(i, *s) for i, s in enumerate(profiling.spans())
             if s[2] is not None and lo <= s[1] and s[2] <= hi]
    if not spans or profiling.dropped_between(lo, hi):
        return None
    return spans, [e for e in profiling.events() if lo <= e[0] <= hi]


def seconds_per_job(t, name: str):
    """Seconds a job spends in the spans called ``name``."""
    w = window(t)
    if w is None:
        return None
    return sum(s[3] - s[2] for s in w[0] if s[1] == name) / 1e9 / len(t.records)


def self_seconds_per_job(t, name: str):
    """Seconds a job spends in the spans called ``name`` less their
    children's (spans on one stack: children do not overlap)."""
    w = window(t)
    if w is None:
        return None
    total = 0
    for i, nm, a, b, _ in w[0]:
        if nm == name:
            total += b - a - sum(d - c for _, _, c, d, parent in w[0] if parent == i)
    return total / 1e9 / len(t.records)


def count_in_window(t, name: str):
    """The counter ``name``'s sum over the window (None as :func:`window`)."""
    w = window(t)
    if w is None:
        return None
    return sum(n for _, nm, n in w[1] if nm == name)
