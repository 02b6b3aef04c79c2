"""Whole runs of each cell at a tiny size on the CPU (the harness's look
for a card skipped, ``run.run(device="cpu")``): the result line's keys,
the window's time limit, and ``correct`` false under each fault a cell
can have, planted underneath the timed path -- an LM step that leaves
its state unchanged, half of the batch left out with the mean taken over
the rest, an answer altered where it is produced.  (No cell spans chips,
so no exchange between chips can be left out.)"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import run as R  # noqa: E402

TINY = {"ubq-runall": dict(n_res=8, n_atoms=40, n_frames=2000, tau_mem_ps=1000.0),
        "mbp-ct-stream": dict(n_res=16, n_frames=8000, tau_mem_ps=1000.0, hist_samples=2000),
        "mbp-fit-powell": dict(n_res=24, hist_samples=2000),
        "mbp-fit-device": dict(n_res=24, hist_samples=2000)}
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_run(cell, trace=0, seconds=1.0, seed=2**31 + 11):
    args = R.parse(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                    "--trace", str(trace)])
    return R.run(args, device="cpu", cfg_override=TINY[cell], emit=False)


@pytest.mark.parametrize("cell", list(TINY))
@pytest.mark.parametrize("trace", [0, 1])
def test_sound_run(cell, trace):
    res = tiny_run(cell, trace)
    assert list(res)[:5] == KEYS and list(res)[-1] == "compared"
    assert set(res) <= set(KEYS) | {"breakdown", "compared"}
    assert res["correct"], res["compared"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    if trace == 0:
        assert "setup_s" in res["metrics"] and len(res["metrics"]) == 2
    for c in res["compared"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


def _unchanged_lm(monkeypatch):
    from spinrelax_tpu_torch.fit import engine
    monkeypatch.setattr(engine, "_run_eager", lambda *a, **k: 0)


def _unchanged_global(monkeypatch):
    from spinrelax_tpu_torch.fit import globalfit

    def start(self, d0, a0, zeta0, csa0, _eager=False):
        return self.chisq(), {"Diso": float(d0), "Daniso": float(a0), "zeta": float(zeta0)}

    monkeypatch.setattr(globalfit.GlobalFitter, "_solve_device", start)


def _unchanged_powell(monkeypatch):
    import scipy.optimize

    def start(func, x0, *a, **k):
        return x0, func(x0), None, 0, 0, 0

    monkeypatch.setattr(scipy.optimize, "fmin_powell", start)


def _half_chunks_ct(monkeypatch):
    from spinrelax_tpu_torch.ops import autocorr
    real = autocorr.ct_palmer
    monkeypatch.setattr(autocorr, "ct_palmer", lambda v: real(v[: max(1, v.shape[0] // 2)]))


def _half_chunks_stream(monkeypatch):
    from spinrelax_tpu_torch.pipeline import stages
    real = stages.fused_group_update

    def half(raw, fit, w, q, acc, want_pt=False):
        h = raw.shape[0] // 2
        raw, fit = raw.clone(), fit.clone()
        raw[h:], fit[h:] = raw[:h], fit[:h]
        return real(raw, fit, w, q, acc, want_pt)

    monkeypatch.setattr(stages, "fused_group_update", half)


def _half_experiments(monkeypatch):
    from spinrelax_tpu_torch.models.experiments import ExperimentSet
    real = ExperimentSet.build

    def half(expts, *a, **k):
        return real(expts[: len(expts) // 2 + 1], *a, **k)

    monkeypatch.setattr(ExperimentSet, "build", staticmethod(half))


def _altered_rate(monkeypatch):
    from spinrelax_tpu_torch.ops import relaxation
    real = relaxation.relaxation_from_j

    def altered(J, pair, csa=None):
        r = real(J, pair, csa)
        R1 = r.R1.clone()
        R1[0] = R1[0] * 1.001
        return r._replace(R1=R1)

    monkeypatch.setattr(relaxation, "relaxation_from_j", altered)


def _one_residue_misfit(monkeypatch):
    """The ladder's answer altered where it is produced: one residue's
    slowest time half again as long, its reported chi-square kept."""
    from spinrelax_tpu_torch.fit import expfit
    real = expfit.fit_ct_ladder

    def altered(*a, **k):
        cts = real(*a, **k)
        tau = cts.tau.clone()
        j = int(torch.argmax(tau[0] * cts.mask[0]))
        tau[0, j] = tau[0, j] * 1.5
        cts.tau = tau
        return cts

    monkeypatch.setattr(expfit, "fit_ct_ladder", altered)


def _altered_prediction(monkeypatch):
    from spinrelax_tpu_torch.fit import globalfit
    real = globalfit._eval_all

    def altered(es, *a):
        out = list(real(es, *a))
        v, dv = out[0]
        out[0] = (v * (1 + 1e-3 * (torch.arange(v.shape[0], device=v.device) == 0)), dv)
        return out

    monkeypatch.setattr(globalfit, "_eval_all", altered)


FAULTS = [("ubq-runall", _unchanged_lm), ("ubq-runall", _half_chunks_ct),
          ("ubq-runall", _altered_rate),
          ("mbp-ct-stream", _unchanged_lm), ("mbp-ct-stream", _half_chunks_stream),
          ("mbp-ct-stream", _altered_rate), ("mbp-ct-stream", _one_residue_misfit),
          ("mbp-fit-powell", _unchanged_powell), ("mbp-fit-powell", _half_experiments),
          ("mbp-fit-powell", _altered_prediction),
          ("mbp-fit-device", _unchanged_global), ("mbp-fit-device", _half_experiments),
          ("mbp-fit-device", _altered_prediction)]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    res = tiny_run(cell)
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["compared"].values()), res["compared"]
    if fault is _one_residue_misfit:  # the worst residue's fall catches it alone
        worst = res["compared"]["fit_drop_worst"]
        assert worst["value"] > worst["limit"], res["compared"]


def test_window_stops_starting_jobs(monkeypatch):
    """No job starts once --seconds have passed; a failing job is counted
    in attempted and failed and the loop goes on."""
    from portbench.bench import spec
    real_job = spec.job
    starts = []

    def slow_job(kind):
        mod = real_job(kind)

        class Slow(mod.Job):
            def run(self, i):
                if i >= 0:
                    starts.append(time.perf_counter())
                    time.sleep(0.2)
                    if len(starts) % 2 == 0:
                        raise RuntimeError("a planted failure")
                return super().run(i)

        return type("M", (), {"Job": Slow})

    monkeypatch.setattr(spec, "job", slow_job)
    res = tiny_run("mbp-fit-device", seconds=2.0)
    assert len(starts) >= 2
    assert res["attempted"] == len(starts) and res["failed"] == len(starts) // 2
    assert res["correct"] is False
    assert all(s < starts[0] + 2.0 for s in starts)


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = R.main(["--workload", "ubq-runall", "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_alone_no_result(tmp_path):
    """From a directory holding only BENCHMARK.json and portbench/, the
    run exits non-zero and prints no result."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", "ubq-runall",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, env=env, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
