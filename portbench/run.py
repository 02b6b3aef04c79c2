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

A cell whose ``chips`` in BENCHMARK.json is N > 1 runs as N rank
processes of this script, one a card, under torchrun's environment
(``bench/ranks.py``), so the program's mesh joins its group as under
``torchrun``.  Rank 0's clock opens and closes the window and starts each
job on every rank; a job ends when the last rank ends it, and one that
raised on any rank failed.  Set-up runs from this process's start to the
end of the last rank's warm job.  Rank 0 holds the kept job to the
reference and its trace feeds the per-layer metrics and ``breakdown``.
A rank that ends early, or a wait past the larger of 120 s and ten warm
jobs, kills every rank: no result.

The last line of standard output is one JSON object: correct, attempted,
failed, metrics, device (and breakdown with ``--trace 1``), compared.
``device.count`` is the number of distinct cards (by uuid) on which a
rank ran the window's jobs; an N-rank run also gives ``per_device``, each
rank's card index, uuid, kind, jobs, peak memory and, traced, busy
seconds, with the fullest card's peak and the ranks' mean busy time
above it.  Exits non-zero without a result when there is no card, or
fewer distinct cards than the cell's ``chips`` ran its jobs.
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

from portbench.bench import guard, ranks, spec  # noqa: E402


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
    # one write a line, so that the lines of several ranks do not interleave
    sys.stderr.write(" ".join(map(str, parts)) + "\n")
    sys.stderr.flush()


def chips_of(cell: str) -> int:
    """The chips BENCHMARK.json gives the cell (1 where it lists none)."""
    try:
        with open(ROOT / "BENCHMARK.json") as fp:
            cells = {w["name"]: w for w in json.load(fp)["workloads"]}
        return int(cells[cell]["chips"])
    except (OSError, KeyError, ValueError):
        return 1


class Ctx:
    """What a job gets: its configuration, parameters, seed, device, a
    scratch directory under TMPDIR (removed at the end of the run), and
    its rank of ``world`` (0 of 1 on one card)."""

    def __init__(self, cfg, wl, seed, device, work, rank=0, world=1):
        self.cfg, self.params, self.seed = cfg, wl["params"], seed
        self.device, self.work = device, work
        self.rank, self.world = rank, world


def _cache_dirs():
    """Every build and kernel cache at a fixed path inside the checkout."""
    build = HERE / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")


def run(args, device="cuda", cfg_override=None, emit=True):
    """One run; returns the result dict (printed unless ``emit`` is
    false), or None where there is no result.  A one-chip cell runs in
    this process; a cell on N chips as N rank processes, rank i on
    ``<device>:i``.  ``device="cpu"`` and ``cfg_override`` are for the
    CPU tests, which drive a run at a tiny size without a card."""
    wl = spec.workload(args.workload)
    cfg = spec.config(wl["config"])
    cfg.update(cfg_override or {})
    chips = chips_of(args.workload)
    if chips == 1:
        core, card = measure(args, wl, cfg, spec.job(wl["job"]), device, ranks.Solo(), T_START)
        cards = [card]
    else:
        got = ranks.launch(ranks.plan(args, wl, cfg, spec.HERE / "jobs" / f"{wl['job']}.py",
                                      chips, T_START, device))
        if got is None:
            return None
        core, cards = got
    return report(core, cards, device != "cpu", bool(args.trace), chips, emit,
                  per_device=chips > 1)


def measure(args, wl, cfg, job_mod, device, peers, t_start):
    """Set-up, the window and the check on this process's card, in step
    with ``peers``; returns (the outcome, this card's use).  The outcome
    (correct, attempted, failed, metrics, breakdown, compared, window) is
    rank 0's to report; other ranks skip the readers and the check."""
    import numpy as np
    import torch

    on_card = torch.device(device).type == "cuda"
    lead = peers.rank == 0
    tag = f"rank {peers.rank}: " if peers.world > 1 else ""

    def sync():
        if on_card:
            torch.cuda.synchronize()

    readers = {m: spec.reader(m) for m in wl["per_layer"]} if args.trace and lead else {}
    work = tempfile.mkdtemp(prefix="portbench-")
    quiet = open(os.devnull, "w")  # the program's own prints
    seed = args.seed % (1 << 63)
    try:
        job = job_mod.Job(Ctx(cfg, wl, seed, device, work, peers.rank, peers.world))
        job.setup()
        t_warm = time.perf_counter()
        with contextlib.redirect_stdout(quiet):
            job.run(-1)  # the warm job
        job.forget(-1)
        sync()
        t_end = time.perf_counter()
        setup_s = peers.ready(t_end, t_end - t_warm) - t_start
        log(f"{tag}set-up {setup_s:.3f} s (inputs, warm job); window {args.seconds:g} s")

        from portbench.bench.trace import Traced

        # one completed job's outputs are kept for the check, drawn from the
        # seed by reservoir sampling, so the others' are freed as they come
        records, attempted, failed, kept = [], 0, 0, None
        draw = np.random.default_rng(seed)
        with Traced(torch, bool(args.trace), on_card) as tw, contextlib.redirect_stdout(quiet):
            peers.opened()
            deadline = tw.t0 + args.seconds
            while peers.go(deadline):
                attempted += 1
                t0, c0 = time.perf_counter(), time.process_time()
                i, rec = len(records), None
                try:
                    rec = job.run(i)
                    sync()
                except Exception:  # a failed job is counted and the loop goes on
                    log(tag + traceback.format_exc())
                ok, t1 = peers.done(rec is not None)
                if not ok:  # on any rank
                    failed += 1
                    if rec is not None:
                        job.forget(i)
                    continue
                rec["t0"], rec["t1"] = t0, t1
                rec["cpu_s"] = time.process_time() - c0
                records.append(rec)
                if kept is None or draw.integers(len(records)) == 0:
                    kept, i = i, kept
                if i is not None:
                    job.forget(i)
        bad = guard.forbidden()
        if bad:
            log(tag + "loaded modules of the JAX side: " + ", ".join(bad))
            sys.exit(3)
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        busy = tw.busy_s() if args.trace and on_card else None
        card = ranks.card(device, attempted, peak, busy)
        if not lead:
            job.release()
            return None, card
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
        core = {"correct": correct, "attempted": attempted, "failed": failed,
                "metrics": metrics, "breakdown": breakdown, "compared": compared,
                "window_s": tw.window_s if args.trace and on_card else None}
        return core, card
    finally:
        quiet.close()
        shutil.rmtree(work, ignore_errors=True)


def report(core, cards, on_card, trace, chips, emit=True, per_device=False):
    """The result line from rank 0's outcome and every rank's card
    (printed unless ``emit`` is false); None, printing nothing, when the
    JAX side is loaded or fewer distinct cards than ``chips`` ran jobs."""
    bad = guard.forbidden()
    if bad:
        log("loaded modules of the JAX side: " + ", ".join(bad))
        sys.exit(3)
    dev = ranks.device_block(cards, on_card, core["window_s"] if trace else None, per_device)
    if dev["count"] < chips:
        log(f"the window's jobs ran on {dev['count']} distinct card(s); the cell needs {chips}")
        return None
    result = {"correct": core["correct"], "attempted": core["attempted"],
              "failed": core["failed"], "metrics": core["metrics"], "device": dev}
    if core["breakdown"] is not None:
        result["breakdown"] = core["breakdown"]
    compared = core["compared"]
    result["compared"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                          for c in compared}
    if emit:
        for c in compared:
            log(f"compared {c['name']} {c['value']!r} limit {c['limit']!r} "
                f"{'ok' if c['ok'] else 'FAIL'}")
        print(json.dumps(result), flush=True)
    return result


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
    if ranks.STORE_ENV in os.environ:  # a rank of an N-card run
        return ranks.rank_main(measure)
    import torch

    need = chips_of(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        log(f"no CUDA device (need {need}): the benchmark measures the card")
        return 2
    return 0 if run(args) is not None else 4


if __name__ == "__main__":
    sys.exit(main())
