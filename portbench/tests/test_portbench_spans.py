"""The readers of the port's spans and counters (``portbench/spans.py``
and the metrics that use it), in a whole run of mbp-ct-stream at its tiny
CPU size with the five metrics listed for the cell: each reads a finite
value from a run made inside a CPU profiler, and none reads anything from
a run with no profiler, where no span is recorded.  ``ct_h2d_gbps.ct``
divides by the profiler's copy time on the card, so on the CPU, where
there are no copies, it reads None in both."""

from __future__ import annotations

import math
import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import run as R  # noqa: E402
from portbench.bench import spec  # noqa: E402
from portbench.tests.test_portbench_run import TINY  # noqa: E402

CELL = "mbp-ct-stream"
SPANS = ["ct_write_s.ct", "ct_stage_self_s.ct", "ct_h2d_gbps.ct", "finish_ladder_s.ct",
         "lm_host_looks.ct"]
CARD_ONLY = {"ct_h2d_gbps.ct"}


@pytest.fixture
def listed(monkeypatch):
    """The cell with the five metrics appended to its per-layer list."""
    workload = spec.workload

    def with_spans(name):
        wl = workload(name)
        wl["per_layer"] = wl["per_layer"] + [m for m in SPANS if m not in wl["per_layer"]]
        return wl

    monkeypatch.setattr(R.spec, "workload", with_spans)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def traced_run(seed=2**31 + 23):
    args = R.parse(["--workload", CELL, "--seed", str(seed), "--seconds", "1", "--trace", "1"])
    return R.run(args, device="cpu", cfg_override=TINY[CELL], emit=False)


def test_readers_read_a_profiled_run(listed):
    from spinrelax_tpu_torch.utils import profiling

    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        res = traced_run()
    profiling.clear()
    assert res["correct"], res["compared"]
    for name in SPANS:
        if name in CARD_ONLY:
            assert name not in res["metrics"]
            continue
        m = res["metrics"][name]
        assert math.isfinite(m["value"]) and m["value"] >= 0, name
        assert m["unit"] == spec.reader(name).UNIT
    assert res["metrics"]["ct_write_s.ct"]["value"] > 0
    assert res["metrics"]["ct_stage_self_s.ct"]["value"] > 0
    assert res["metrics"]["lm_host_looks.ct"]["value"] >= 1


def test_readers_read_nothing_without_spans(listed):
    from spinrelax_tpu_torch.utils import profiling

    profiling.clear()
    res = traced_run()
    assert res["correct"], res["compared"]
    assert not set(SPANS) & set(res["metrics"])
    assert "lm_steps.ct" in res["metrics"]
