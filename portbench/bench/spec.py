"""Finding a cell's data by name: ``workloads/<cell>.json`` names its
configuration (``configs/<config>.json``), its traffic and job kind
(``jobs/<job>.py``); each per-layer metric is ``metrics/<metric>.py``.
A later cell, mix or metric is added as files; nothing here lists them."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WORKLOAD_KEYS = {"config", "traffic", "job", "e2e", "per_layer", "params", "why"}


def check_name(name: str, what: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"{what} {name!r}: a name is 1-64 letters, digits, '_', '.', '-'")
    return name


def _json(path: Path):
    with open(path) as fp:
        return json.load(fp)


def workload(name: str) -> dict:
    """The cell's data file, checked: its keys, names and files."""
    check_name(name, "workload")
    path = HERE / "workloads" / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no workload file {path.relative_to(HERE.parent)}")
    wl = _json(path)
    if set(wl) != WORKLOAD_KEYS:
        raise ValueError(f"{path.name}: keys {sorted(wl)} != {sorted(WORKLOAD_KEYS)}")
    for key in ("config", "traffic", "job"):
        check_name(wl[key], key)
    if not (HERE / "jobs" / f"{wl['job']}.py").is_file():
        raise FileNotFoundError(f"{path.name}: no job module jobs/{wl['job']}.py")
    e2e = wl["e2e"]
    check_name(e2e["name"], "metric")
    if e2e["kind"] not in ("seconds_per_job", "work_per_second") or not UNIT.match(e2e["unit"]):
        raise ValueError(f"{path.name}: bad end-to-end metric {e2e}")
    for m in wl["per_layer"]:
        check_name(m, "metric")
        if not (HERE / "metrics" / f"{m}.py").is_file():
            raise FileNotFoundError(f"{path.name}: no reader metrics/{m}.py")
    return wl


def config(name: str) -> dict:
    check_name(name, "config")
    cfg = _json(HERE / "configs" / f"{name}.json")
    for key in cfg.get("reduced", []):
        check_name(key, "reduced key")
    return cfg


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def job(kind: str):
    """The job module ``jobs/<kind>.py``."""
    return _module(HERE / "jobs" / f"{check_name(kind, 'job')}.py", f"portbench_job_{kind}")


def reader(metric: str):
    """The reader ``metrics/<metric>.py``: its ``read(trace)`` gives the
    metric's value, or None where the trace holds nothing to read."""
    mod = _module(HERE / "metrics" / f"{check_name(metric, 'metric')}.py",
                  "portbench_metric_" + metric.replace(".", "_").replace("-", "_"))
    if not callable(getattr(mod, "read", None)) or not UNIT.match(getattr(mod, "UNIT", "")):
        raise ValueError(f"metrics/{metric}.py needs read(trace) and UNIT")
    return mod
