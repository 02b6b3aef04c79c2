#!/usr/bin/env python3
"""The readings a cell's limits are set from, on the card:

    python3 portbench/calibrate.py --workload <cell> --seeds 1 2 3 [--program] [--control]

For each seed, in one process: the cell's set-up, and with ``--program``
one job of the port held to the reference (the numbers its runs
compare), with ``--control`` the control -- the reference put in the
program's place one precision below the configuration's -- held to the
same reference.  One JSON line a seed: {"seed", "program", "control"}.
The benchmark's own runs never run this."""

import argparse
import contextlib
import json
import os
import shutil
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.bench import spec  # noqa: E402
from portbench.run import Ctx, _cache_dirs  # noqa: E402


def readings(cell: str, seed: int, program: bool, control: bool, device="cuda",
             cfg_override=None) -> dict:
    wl = spec.workload(cell)
    cfg = spec.config(wl["config"])
    cfg.update(cfg_override or {})
    work = tempfile.mkdtemp(prefix="portbench-cal-")
    try:
        job = spec.job(wl["job"]).Job(Ctx(cfg, wl, seed, device, work))
        job.setup()
        out = {"seed": seed}
        if program:
            with open(os.devnull, "w") as quiet, contextlib.redirect_stdout(quiet):
                job.run(0)
            out["program"] = job.measured(0)
        if control:
            out["control"] = job.control()
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--program", action="store_true")
    p.add_argument("--control", action="store_true")
    a = p.parse_args(argv)
    _cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    for seed in a.seeds:
        print(json.dumps(readings(a.workload, seed, a.program, a.control)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
