"""N-rank runs (``bench/ranks.py``) on the CPU over gloo: the stub job
(``stub_job.py``) on 2 and 4 rank processes of ``run.py`` under
torchrun's environment, in lock-step through the harness's store.  A
sound run reports every rank's device and comes out correct; a job that
raises on one rank fails on all of them and the run goes on; a rank that
ends, or a job that passes the wait bound, ends the run with no result
inside the bound, and leaves no rank running; so does a module of the
JAX side that rank 0's check loads; fewer distinct devices than
``chips`` give no result; ``run.run`` gives a cell on 2 chips to
the ranks."""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
sys.path.insert(0, str(ROOT))

from portbench import run as R  # noqa: E402
from portbench.bench import ranks  # noqa: E402

STUB = {"config": "stub", "traffic": "stub", "job": "stub_job",
        "e2e": {"name": "stub_flops_per_s", "unit": "flop/s", "kind": "work_per_second"},
        "per_layer": [], "why": "the N-rank tests' stub"}


def launch(tmp_path, chips, seconds=2.0, trace=0, devices=None, **plant):
    """Run the stub on ``chips`` CPU ranks; (result or None, seconds taken)."""
    args = argparse.Namespace(workload=f"stub-{chips}", seed=2**31 + 23, seconds=seconds,
                              trace=trace)
    wl = {**STUB, "params": {"n": 48, "reps": 2, "limit": 1e-5, "pid_dir": str(tmp_path),
                             **plant}}
    t0 = time.perf_counter()
    pl = ranks.plan(args, wl, {}, HERE / "stub_job.py", chips, t0, device="cpu")
    if devices is not None:
        pl["devices"] = devices
    got = ranks.launch(pl)
    res = None if got is None else R.report(*got, on_card=False, trace=bool(trace),
                                            chips=chips, emit=False, per_device=True)
    return res, time.perf_counter() - t0


def assert_no_rank_left(tmp_path, chips):
    for r in range(chips):
        pid = int((tmp_path / f"rank{r}.pid").read_text())
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


@pytest.mark.parametrize("chips,trace", [(2, 0), (4, 0), (2, 1)])
def test_sound_run(tmp_path, chips, trace):
    res, _ = launch(tmp_path, chips, trace=trace)
    assert res is not None
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert res["correct"], res["compared"]
    assert res["failed"] == 0 and res["attempted"] >= 2
    dev = res["device"]
    assert dev["count"] == chips and len(dev["per_device"]) == chips
    assert [c["index"] for c in dev["per_device"]] == list(range(chips))
    assert {c["jobs"] for c in dev["per_device"]} == {res["attempted"]}
    if trace:
        assert set(res["metrics"]) == set()
    else:
        assert set(res["metrics"]) == {"stub_flops_per_s", "setup_s"}
        assert res["metrics"]["setup_s"]["value"] > 0
    assert_no_rank_left(tmp_path, chips)


def test_job_raising_on_one_rank_fails_on_all(tmp_path):
    res, _ = launch(tmp_path, 2, raise_on=[1, 1])
    assert res is not None
    assert res["failed"] == 1 and res["attempted"] >= 3 and res["correct"] is False
    assert {c["jobs"] for c in res["device"]["per_device"]} == {res["attempted"]}


@pytest.mark.parametrize("chips", [2, 4])
def test_rank_exiting_mid_window_gives_no_result(tmp_path, chips):
    res, took = launch(tmp_path, chips, seconds=30.0, exit_on=[chips - 1, 1])
    assert res is None
    assert took < 30.0  # the window was not waited out, nor the wait bound
    assert_no_rank_left(tmp_path, chips)


def test_job_past_the_wait_bound_gives_no_result(tmp_path, monkeypatch):
    monkeypatch.setattr(ranks, "WAIT_FLOOR_S", 3.0)
    res, took = launch(tmp_path, 2, seconds=30.0, hang_on=[0, 1])
    assert res is None
    assert took < 30.0
    assert_no_rank_left(tmp_path, 2)


@pytest.mark.parametrize("chips", [2, 4])
def test_jax_loaded_by_rank_0s_check_gives_no_result(tmp_path, chips):
    """The check runs on rank 0 after the window's look at ``sys.modules``:
    a module of the JAX side that it loads still leaves no result."""
    res, _ = launch(tmp_path, chips, jax_in_check=True)
    assert res is None
    assert_no_rank_left(tmp_path, chips)


def test_fewer_devices_than_chips_gives_no_result(tmp_path):
    res, _ = launch(tmp_path, 2, devices=["cpu:0", "cpu:0"])
    assert res is None


def test_run_gives_a_multi_chip_cell_to_ranks(monkeypatch):
    """``run.run`` runs a cell whose ``chips`` is 2 as two ranks (here a
    one-card job, run alike on both CPU ranks, at a tiny size)."""
    monkeypatch.setattr(R, "chips_of", lambda cell: 2)
    args = R.parse(["--workload", "mbp-fit-device", "--seed", str(2**31 + 5), "--seconds", "1",
                    "--trace", "0"])
    res = R.run(args, device="cpu", cfg_override=dict(n_res=24, hist_samples=2000), emit=False)
    assert res is not None and res["correct"], res and res["compared"]
    per = res["device"]["per_device"]
    assert [c["uuid"] for c in per] == ["cpu:0", "cpu:1"] and res["device"]["count"] == 2
    assert {c["jobs"] for c in per} == {res["attempted"]}
