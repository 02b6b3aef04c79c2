#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds spinrelax_tpu_torch.  The cell's
data file ``portbench/workloads/<cell>.json`` names its configuration
(``configs/``), its job kind (``jobs/<job>.py``) and its per-layer
metrics (``metrics/<metric>.py``).  The run:

1. makes the cell's inputs from ``--seed`` and runs one warm job
   (``setup_s``: from this script's start, CUDA's start and the kernels'
   load or first build included);
2. runs jobs one after another, a closed loop with one client, starting
   none once ``--seconds`` have passed; with ``--trace 1`` the window runs
   under torch.profiler (the card's activity only) and the per-layer
   metrics are read from it, else the end-to-end metric is taken from the
   host clock over the completed jobs, first start to last end;
3. reads the peak device memory, frees the program's state and holds one
   completed job's outputs, drawn from the seed, to the plain reference
   (``reference/``): each number compared is printed beside its limit as
   the last lines of standard error and under ``compared`` in the result;
4. fails, printing no result, if a module of the JAX side was loaded.

The last line of standard output is one JSON object: correct, attempted,
failed, metrics, device (and breakdown with ``--trace 1``), compared.
Exits non-zero without a result when there is no card.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.bench import guard, spec  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    if a.seconds <= 0:
        p.error("--seconds must be positive")
    return a


def log(*parts):
    print(*parts, file=sys.stderr, flush=True)


def chips_of(cell: str) -> int:
    """The chips BENCHMARK.json gives the cell (1 where it lists none)."""
    try:
        with open(ROOT / "BENCHMARK.json") as fp:
            cells = {w["name"]: w for w in json.load(fp)["workloads"]}
        return int(cells[cell]["chips"])
    except (OSError, KeyError, ValueError):
        return 1


class Ctx:
    """What a job gets: its configuration, parameters, seed, device and a
    scratch directory under TMPDIR (removed at the end of the run)."""

    def __init__(self, cfg, wl, seed, device, work):
        self.cfg, self.params, self.seed = cfg, wl["params"], seed
        self.device, self.work = device, work


def _cache_dirs():
    """Every build and kernel cache at a fixed path inside the checkout."""
    build = HERE / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")


def run(args, device="cuda", cfg_override=None, emit=True):
    """One run; returns the result dict (printed unless ``emit`` is false).
    ``device="cpu"`` and ``cfg_override`` are for the CPU tests, which
    drive a run at a tiny size without a card."""
    import numpy as np
    import torch

    wl = spec.workload(args.workload)
    cfg = spec.config(wl["config"])
    cfg.update(cfg_override or {})
    on_card = device != "cpu"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    readers = {m: spec.reader(m) for m in wl["per_layer"]} if args.trace else {}
    work = tempfile.mkdtemp(prefix="portbench-")
    quiet = open(os.devnull, "w")  # the program's own prints
    seed = args.seed % (1 << 63)
    try:
        job = spec.job(wl["job"]).Job(Ctx(cfg, wl, seed, device, work))
        job.setup()
        with contextlib.redirect_stdout(quiet):
            job.run(-1)  # the warm job
        job.forget(-1)
        sync()
        setup_s = time.perf_counter() - T_START
        log(f"set-up {setup_s:.3f} s (inputs, warm job); window {args.seconds:g} s")

        from portbench.bench.trace import Traced

        # one completed job's outputs are kept for the check, drawn from the
        # seed by reservoir sampling, so the others' are freed as they come
        records, attempted, failed, kept = [], 0, 0, None
        draw = np.random.default_rng(seed)
        with Traced(torch, bool(args.trace), on_card) as tw, contextlib.redirect_stdout(quiet):
            deadline = tw.t0 + args.seconds
            while time.perf_counter() < deadline:
                attempted += 1
                t0, c0 = time.perf_counter(), time.process_time()
                try:
                    rec = job.run(len(records))
                    sync()
                except Exception:  # a failed job is counted and the loop goes on
                    failed += 1
                    log(traceback.format_exc())
                    continue
                rec["t0"], rec["t1"] = t0, time.perf_counter()
                rec["cpu_s"] = time.process_time() - c0
                records.append(rec)
                i = len(records) - 1
                if kept is None or draw.integers(len(records)) == 0:
                    kept, i = i, kept
                if i is not None:
                    job.forget(i)
        bad = guard.forbidden()
        if bad:
            log("loaded modules of the JAX side: " + ", ".join(bad))
            sys.exit(3)
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        span = records[-1]["t1"] - records[0]["t0"] if records else float("nan")
        log(f"{len(records)} jobs in {span:.3f} s ({attempted} attempted, {failed} failed)")
        log("job seconds: " + " ".join(repr(r["t1"] - r["t0"]) for r in records))
        flat = [{**{k: v for k, v in r.items() if isinstance(v, (int, float))},
                 **{f"{k}.{j}": u for k, v in r.items() if isinstance(v, dict)
                    for j, u in v.items()}} for r in records]
        for key in sorted(k for k in (flat[0] if flat else {}) if k not in ("t0", "t1", "work")):
            log(f"job {key}: " + " ".join(f"{f.get(key, float('nan')):.6g}" for f in flat))

        metrics = {}
        breakdown = None
        if not args.trace:
            e2e = wl["e2e"]
            if records:
                value = (span / len(records) if e2e["kind"] == "seconds_per_job"
                         else sum(r["work"] for r in records) / span)
                metrics[e2e["name"]] = {"value": value, "unit": e2e["unit"]}
            metrics["setup_s"] = {"value": setup_s, "unit": "s"}
        else:
            view = TraceView(records, tw, cfg, wl, on_card)
            for name, rd in readers.items():
                value = rd.read(view) if records else None
                if value is not None:
                    metrics[name] = {"value": float(value), "unit": rd.UNIT}
            if on_card:
                phases = [p for r in records for p in r.get("phases", [])]
                breakdown = {"device_ops": tw.device_ops(),
                             "idle_gaps": tw.idle_gaps(phases)}

        job.release()
        try:
            compared = job.check(kept) if records else [
                dict(name="jobs_missing", value=1.0, limit=0.0, ok=False)]
        except Exception:  # outputs the check cannot read are not correct
            log(traceback.format_exc())
            compared = [dict(name="outputs_unread", value=1.0, limit=0.0, ok=False)]
        for c in compared:  # JSON has no inf or NaN: such a gap reads 1e300
            if not math.isfinite(c["value"]):
                c["value"], c["ok"] = 1e300, False
        correct = bool(records) and failed == 0 and all(c["ok"] for c in compared)
        bad = guard.forbidden()
        if bad:
            log("loaded modules of the JAX side: " + ", ".join(bad))
            sys.exit(3)

        dev = {"platform": "gpu" if on_card else "cpu",
               "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
               "count": 1, "memory_peak_bytes": int(peak)}
        if args.trace and on_card:
            dev["busy_s"] = tw.busy_s()
            dev["window_s"] = tw.window_s
        result = {"correct": correct, "attempted": attempted, "failed": failed,
                  "metrics": metrics, "device": dev}
        if breakdown is not None:
            result["breakdown"] = breakdown
        result["compared"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                              for c in compared}
        if emit:
            for c in compared:
                log(f"compared {c['name']} {c['value']!r} limit {c['limit']!r} "
                    f"{'ok' if c['ok'] else 'FAIL'}")
            print(json.dumps(result), flush=True)
        return result
    finally:
        quiet.close()
        shutil.rmtree(work, ignore_errors=True)


class TraceView:
    """What a per-layer reader sees: the traced window's job records, the
    profiler's kernel table ({name: (launches, seconds)}), the busy time,
    the window and the cell's data."""

    def __init__(self, records, tw, cfg, wl, on_card):
        self.records, self.cfg, self.params = records, cfg, wl["params"]
        self.kernels = tw.kernels if on_card else {}
        self.window_s = tw.window_s
        self.busy_s = tw.busy_s() if on_card and tw.spans else None

    def per_job(self, key):
        """Mean over the window's jobs of record[key] (None if absent)."""
        vals = [r[key] for r in self.records if key in r]
        return sum(vals) / len(vals) if vals else None

    def kernel_seconds(self, match) -> float:
        return sum(t for name, (_, t) in self.kernels.items() if match(name))


def main(argv=None) -> int:
    args = parse(argv)
    _cache_dirs()
    import torch

    need = chips_of(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        log(f"no CUDA device (need {need}): the benchmark measures the card")
        return 2
    run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
