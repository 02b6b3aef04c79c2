"""The reader ``ct_h2d_pinned_share.ct`` on the program's counters recorded
under a CPU profiler: 100 where every copied byte went through the pinned
slots, 0 for a program that keeps no pinned counter, None where the
window copies nothing or no profiler recorded it."""

from __future__ import annotations

import contextlib
import sys
import time
from pathlib import Path

import pytest
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import run as R  # noqa: E402
from portbench.bench import spec  # noqa: E402

METRIC = "ct_h2d_pinned_share.ct"


class View:
    """What a reader sees of a traced window (``run.TraceView``'s part)."""

    kernel_seconds = R.TraceView.kernel_seconds

    def __init__(self, records):
        self.records, self.kernels = records, {}


def recorded(copied: int, pinned, traced: bool = True):
    """Two jobs' worth of the stage's span and copy counters, each job
    copying ``copied`` bytes, ``pinned`` of them through the slots (None:
    a program without the pinned counter)."""
    from spinrelax_tpu_torch.utils import profiling

    profiling.clear()
    records = []
    with profile(activities=[ProfilerActivity.CPU]) if traced else contextlib.nullcontext():
        for _ in range(2):
            t0 = time.perf_counter()
            with profiling.span("stage_ct"):
                profiling.count("stage_ct.h2d_bytes", copied)
                if pinned is not None:
                    profiling.count("stage_ct.h2d_pinned_bytes", pinned)
            records.append({"t0": t0, "t1": time.perf_counter()})
    got = spec.reader(METRIC).read(View(records))
    profiling.clear()
    return got


@pytest.mark.parametrize("copied,pinned,want", [
    (2_238_000_000, 2_238_000_000, 100.0),  # every byte through the slots
    (2_238_000_000, None, 0.0),  # a program with pageable copies only
    (4_000, 1_000, 25.0),
    (0, None, None),  # no copies in the window
])
def test_pinned_share_reads_the_counters(copied, pinned, want):
    got = recorded(copied, pinned)
    assert got == (None if want is None else pytest.approx(want))


def test_pinned_share_reads_nothing_without_a_profiler():
    assert recorded(2_238_000_000, 2_238_000_000, traced=False) is None


def test_pinned_share_names_its_unit():
    assert spec.reader(METRIC).UNIT == "%"
