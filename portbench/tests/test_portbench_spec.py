"""The benchmark's data files are found by name and agree with
BENCHMARK.json; names, units and the result line keep to the contract."""

from __future__ import annotations

import json
import re
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
sys.path.insert(0, str(ROOT))

from portbench.bench import spec  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and BENCH["command"][1] == "portbench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in e:
                    assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
    assert len(set(names)) == len(names)
    for c in BENCH["configs"]:
        for key in c["reduced"]:
            assert NAME.match(key)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    """Each cell's data file names its configuration, traffic and job, and
    lists exactly the per-layer metrics BENCHMARK.json gives it."""
    wl = spec.workload(cell)
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert (wl["config"], wl["traffic"]) == (entry["config"], entry["traffic"])
    assert entry["chips"] == 1
    cfg = spec.config(wl["config"])
    conf = next(c for c in BENCH["configs"] if c["name"] == wl["config"])
    assert conf["file"] == f"portbench/configs/{wl['config']}.json"
    assert cfg["reduced"] == conf["reduced"]
    per_layer = {m["name"] for m in BENCH["per_layer"] if cell in m["workloads"]}
    assert per_layer == set(wl["per_layer"])
    e2e = [m for m in BENCH["end_to_end"] if cell in m.get("workloads", [cell])]
    assert {m["name"] for m in e2e} == {wl["e2e"]["name"], "setup_s"}
    assert next(m for m in e2e if m["name"] == wl["e2e"]["name"])["unit"] == wl["e2e"]["unit"]
    job = spec.job(wl["job"])
    for method in ("setup", "run", "forget", "release", "measured", "check", "control"):
        assert callable(getattr(job.Job, method))
    assert wl["params"]["limits"], "every compared number has a limit"


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_readers(metric):
    rd = spec.reader(metric)
    entry = next(m for m in BENCH["per_layer"] if m["name"] == metric)
    assert rd.UNIT == entry["unit"]
    assert entry["moves"] in {m["name"] for m in BENCH["end_to_end"]}


def test_every_config_and_metric_used():
    used = {spec.workload(c)["config"] for c in CELLS}
    assert used == {c["name"] for c in BENCH["configs"]}
    assert all(m["workloads"] for m in BENCH["per_layer"])


def test_bad_names_refused():
    with pytest.raises(ValueError):
        spec.check_name("has space", "metric")
    with pytest.raises(ValueError):
        spec.check_name("a/b", "metric")
    with pytest.raises(FileNotFoundError):
        spec.workload("no-such-cell")
