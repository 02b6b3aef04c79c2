"""The port's tracing (spinrelax_tpu_torch.utils.profiling), on the CPU:
spans and count events are recorded exactly while a torch profiler is
active, nest by their ``parent``, and are stamped on perf_counter_ns; the
buffer drops past its bound and counts the drops; counters() names every
counter the port keeps.  Then the program's spans and counters where they
are placed: stage_ct_streamed's stage, children, copied and written bytes;
the LM's host looks; and cli.main's trace under SPINRELAX_TRACE_DIR."""

import json
import os
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from spinrelax_tpu_torch.entry import synthetic_system
from spinrelax_tpu_torch.fit import engine
from spinrelax_tpu_torch.pipeline import cli, stages
from spinrelax_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGE_CHILDREN = {"stage_ct.decode", "stage_ct.h2d", "stage_ct.accumulate", "stage_ct.write"}


@pytest.fixture(autouse=True)
def _empty_buffer():
    profiling.clear()
    yield
    profiling.clear()


def _cpu_profiler():
    return profile(activities=[ProfilerActivity.CPU])


def test_nothing_recorded_outside_a_profiler():
    before = profiling.counters()["stage_ct.h2d_bytes"]
    with profiling.span("outer"):
        with profiling.span("inner"):
            profiling.count("stage_ct.h2d_bytes", 7)
    assert profiling.spans() == [] and profiling.events() == []
    assert profiling.counters()["stage_ct.h2d_bytes"] == before + 7


def test_spans_nest_and_stamp_under_a_profiler():
    with _cpu_profiler() as prof:
        a = time.perf_counter_ns()
        with profiling.span("outer"):
            with profiling.span("inner"):
                profiling.count("fit.host_looks", 2)
            with profiling.span("inner2"):
                pass
        b = time.perf_counter_ns()
        for _ in profiling.spanned("waits", range(2)):
            pass
    got = profiling.spans()
    assert [(s[0], s[3]) for s in got] == [("outer", -1), ("inner", 0), ("inner2", 0),
                                           ("waits", -1), ("waits", -1), ("waits", -1)]
    for name, t0, t1, _ in got[:3]:
        assert a <= t0 <= t1 <= b, name
    assert got[0][1] <= got[1][1] <= got[1][2] <= got[2][1] <= got[2][2] <= got[0][2]
    (t, name, n), = profiling.events()
    assert name == "fit.host_looks" and n == 2 and got[1][1] <= t <= got[1][2]
    names = {e.name for e in prof.events()}
    assert {"outer", "inner", "inner2", "waits"} <= names


def test_span_decorates_each_call():
    @profiling.span("call")
    def f(x):
        with profiling.span("body"):
            return x + 1

    with _cpu_profiler():
        assert f(1) == 2 and f(2) == 3
    assert [(s[0], s[3]) for s in profiling.spans()] == [("call", -1), ("body", 0),
                                                          ("call", -1), ("body", 2)]


def test_buffer_drops_past_its_bound(monkeypatch):
    monkeypatch.setattr(profiling, "CAPACITY", 4)
    dropped = profiling.counters()["profiling.dropped"]
    with _cpu_profiler():
        t0 = time.perf_counter_ns()
        for _ in range(3):
            with profiling.span("s"):
                pass
        profiling.count("fit.host_looks")
        with profiling.span("late"):
            profiling.count("fit.host_looks")
        t1 = time.perf_counter_ns()
    assert len(profiling.spans()) == 3 and len(profiling.events()) == 1
    assert profiling.counters()["profiling.dropped"] == dropped + 2
    assert profiling.dropped_between(t0, t1) and not profiling.dropped_between(0, t0 - 1)
    profiling.clear()
    assert profiling.spans() == [] and not profiling.dropped_between(t0, t1)


def test_counters_name_every_counter():
    names = set(profiling.counters())
    assert {f"launches.{k}" for k in "ABCDE"} <= names
    assert {"fit.host_reads", "stage_ct.h2d_bytes", "stage_ct.h2d_pinned_bytes",
            "stage_ct.write_bytes", "fit.host_looks", "profiling.dropped"} <= names


def test_stage_ct_spans_and_bytes(tmp_path):
    """stage_ct_streamed at tests/test_torch_ct_streamed.py's size (5
    residues, 1200 frames, 2.5 ps, tau_mem 400 ps; groups of 2 chunks, so
    every group is copied): one ``stage_ct`` span over its four kinds of
    children, the bytes copied equal to the observables' (F x (5 bonds x 3
    + 9) float32), the bytes written equal to the five files' sizes."""
    from spinrelax_tpu_torch.io import native

    ref, xtc, _ = synthetic_system(tmp_path, n_res=5, n_frames=1200, dt=2.5, seed=4)
    n_frames = native.read_xtc(xtc)[0].shape[0]
    before = profiling.counters()
    prefix = str(tmp_path / "t")
    with _cpu_profiler() as prof:
        stages.stage_ct_streamed([xtc], [ref], prefix, tau_memory=400.0, chunk_groups=2,
                                 device="cpu")
    got = profiling.spans()
    top = [i for i, s in enumerate(got) if s[0] == "stage_ct"]
    assert len(top) == 1 and got[top[0]][3] == -1
    children = [s for s in got if s[3] == top[0]]
    assert {s[0] for s in children} == STAGE_CHILDREN
    assert sum(s[0] == "stage_ct.write" for s in children) == 5
    assert sum(s[0] == "stage_ct.h2d" for s in children) == 4  # 320, 320, 320, 240 frames
    assert all(got[top[0]][1] <= s[1] <= s[2] <= got[top[0]][2] for s in children)
    sums = {}
    for _, name, n in profiling.events():
        sums[name] = sums.get(name, 0) + n
    files = [prefix + s for s in ("_Ctext.dat", "_Ctint.dat", "_avgvec.dat",
                                  "_vecHistogram.npz", "_S2.dat")]
    assert sums["stage_ct.h2d_bytes"] == n_frames * (5 * 3 + 9) * 4
    assert sums["stage_ct.write_bytes"] == sum(os.path.getsize(f) for f in files)
    after = profiling.counters()
    for key in ("stage_ct.h2d_bytes", "stage_ct.write_bytes"):
        assert after[key] - before[key] == sums[key]
    assert STAGE_CHILDREN | {"stage_ct"} <= {e.name for e in prof.events()}


class _Flag:
    """A ``live`` flag that reads true ``n`` times, counting its reads."""

    def __init__(self, n):
        self.n, self.reads = n, 0

    def __bool__(self):
        self.reads += 1
        return self.reads <= self.n


@pytest.mark.parametrize("n", [0, 1, 5])
def test_run_eager_counts_each_look(n):
    flag, steps = _Flag(n), []
    before = profiling.counters()["fit.host_looks"]
    assert engine._run_eager(lambda: steps.append(1), flag, 60, 8) == n == len(steps)
    assert profiling.counters()["fit.host_looks"] - before == flag.reads == n + 1


def test_replay_counts_one_look_a_window():
    flag = _Flag(2)
    before = profiling.counters()["fit.host_looks"]
    assert engine._replay(lambda: None, flag, 1, 60, 8) == 24
    assert profiling.counters()["fit.host_looks"] - before == flag.reads == 3


def test_cli_writes_a_trace_with_the_counters(tmp_path, monkeypatch):
    """``check`` (the smallest command) with SPINRELAX_TRACE_DIR set writes
    ``<dir>/check.json``: a chrome trace whose metadata holds every
    counter's change over the command."""
    monkeypatch.setenv("SPINRELAX_TRACE_DIR", str(tmp_path / "traces"))
    monkeypatch.chdir(REPO)
    assert cli.main(["check"], device="cpu") == 0
    with open(tmp_path / "traces" / "check.json") as fp:
        doc = json.load(fp)
    assert set(doc["spinrelax_counters"]) == set(profiling.counters())
    assert all(isinstance(v, int) for v in doc["spinrelax_counters"].values())
    assert doc["traceEvents"]


def test_python_m_writes_a_trace(tmp_path):
    """``python -m spinrelax_tpu_torch info`` (a command that computes
    nothing on a device) with SPINRELAX_TRACE_DIR set writes ``info.json``
    with the counters."""
    import subprocess
    import sys

    _, xtc, _ = synthetic_system(tmp_path, n_res=3, n_frames=20, dt=2.5, seed=1)
    env = dict(os.environ, PYTHONPATH=REPO, SPINRELAX_TRACE_DIR=str(tmp_path / "traces"))
    out = subprocess.run([sys.executable, "-m", "spinrelax_tpu_torch", "info", xtc],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "20 frames x 9 atoms" in out.stdout
    with open(tmp_path / "traces" / "info.json") as fp:
        doc = json.load(fp)
    assert set(doc["spinrelax_counters"]) == set(profiling.counters())
