"""A cell on N > 1 cards: N rank processes, one a card, started the way
users start the port (``torchrun --nproc-per-node N -m spinrelax_tpu_torch
...``): each child of ``run.py`` gets torchrun's environment (RANK =
LOCAL_RANK = i, WORLD_SIZE = LOCAL_WORLD_SIZE = N, MASTER_ADDR 127.0.0.1,
a free MASTER_PORT), so the program's ``parallel.mesh.make_mesh`` joins
its group through ``launch.init_from_env`` on ``cuda:i``.  The harness
never starts the program's group.

The ranks keep in lock-step through a store of the harness's own, a
``TCPStore`` that the parent serves on a port of its own (a FileStore
polls every 10 ms; a TCPStore wakes a waiter in about 0.1 ms):

- ``plan``: what every rank runs (the cell's data, its job file, each
  rank's device, the parent's start);
- ``ready/<r>``: the end of rank r's warm job and its length; set-up ends
  at the last rank's;
- ``open/<r>``: rank r's traced window is open;
- ``cmd/<i>``: rank 0's clock decides: ``run`` job i or ``stop``;
- ``done/<i>/<r>``: whether job i raised on rank r, and when it ended
  there; a job that raised on any rank failed on every rank, and it ended
  when the last rank ended it;
- ``report/<r>``: rank r's card and, from rank 0, the run's outcome.

The parent watches the ranks and the store.  When a rank ends before the
run does, or a wait passes its bound (the larger of ``WAIT_FLOOR_S`` and
ten warm jobs), it kills every rank and the run gives no result.
"""

from __future__ import annotations

import contextlib
import datetime
import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

STORE_ENV = "PORTBENCH_RANKS"  # host:port of the harness's store, in a rank's environment
WAIT_FLOOR_S = 120.0
SETUP_BOUND_S = 1100.0  # a checkout's first run builds the kernels on every rank
POLL_S = 0.02


class Solo:
    """One process on one card: the closed loop as a one-chip cell runs it."""

    rank, world = 0, 1

    def ready(self, t_end: float, warm_s: float) -> float:
        return t_end

    def opened(self):
        pass

    def go(self, deadline: float) -> bool:
        return time.perf_counter() < deadline

    def done(self, ok: bool):
        return ok, time.perf_counter()


class Peers:
    """Rank ``rank`` of ``world``, in lock-step through ``store``."""

    def __init__(self, store, rank: int, world: int):
        self.store, self.rank, self.world = store, rank, world
        self.i = -1

    def _all(self, key: str) -> list:
        keys = [f"{key}/{r}" for r in range(self.world)]
        self.store.wait(keys)
        return [json.loads(v) for v in self.store.multi_get(keys)]

    def ready(self, t_end: float, warm_s: float) -> float:
        """Publish this rank's warm job; the end of the last rank's."""
        self.store.set(f"ready/{self.rank}", json.dumps([t_end, warm_s]))
        return max(t for t, _ in self._all("ready"))

    def opened(self):
        self.store.set(f"open/{self.rank}", "1")
        self._all("open")

    def go(self, deadline: float) -> bool:
        self.i += 1
        key = f"cmd/{self.i}"
        if self.rank == 0:
            cmd = "run" if time.perf_counter() < deadline else "stop"
            self.store.set(key, cmd)
            return cmd == "run"
        return self.store.get(key) == b"run"

    def done(self, ok: bool):
        self.store.set(f"done/{self.i}/{self.rank}", json.dumps([ok, time.perf_counter()]))
        got = self._all(f"done/{self.i}")
        return all(k for k, _ in got), max(t for _, t in got)


def card(device: str, jobs: int, peak: int, busy_s=None) -> dict:
    """What one rank's card did: index, uuid (a CPU device is named by
    itself), kind, the window's jobs, peak memory and busy seconds."""
    import torch

    dev = torch.device(device)
    out = {"index": dev.index, "uuid": str(dev), "kind": "cpu"}
    if dev.type == "cuda":
        i = torch.cuda.current_device() if dev.index is None else dev.index
        out.update(index=i, uuid=str(torch.cuda.get_device_properties(i).uuid),
                   kind=torch.cuda.get_device_name(i))
    out.update(jobs=jobs, memory_peak_bytes=int(peak))
    if busy_s is not None:
        out["busy_s"] = busy_s
    return out


def device_block(cards: list, on_card: bool, window_s=None, per_device: bool = False) -> dict:
    """The result's ``device``: ``count`` the distinct cards on which a
    rank ran the window's jobs, the fullest card's peak, the mean busy
    time over the ranks."""
    count = len({c["uuid"] for c in cards if c["jobs"] > 0})
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": ", ".join(sorted({c["kind"] for c in cards})),
           "count": count, "memory_peak_bytes": max(c["memory_peak_bytes"] for c in cards)}
    if window_s is not None:
        dev["busy_s"] = sum(c["busy_s"] for c in cards) / len(cards)
        dev["window_s"] = window_s
    if per_device:
        dev["per_device"] = cards
    return dev


def plan(args, wl: dict, cfg: dict, job_file, chips: int, t_start: float,
         device: str = "cuda") -> dict:
    """What every rank of a ``chips``-rank run is given: rank i runs on
    ``<device>:i``."""
    return {"args": vars(args), "wl": wl, "cfg": cfg, "job_file": str(job_file),
            "chips": chips, "devices": [f"{device}:{i}" for i in range(chips)],
            "t_start": t_start}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _log(*parts):
    sys.stderr.write(" ".join(map(str, ("ranks:",) + parts)) + "\n")
    sys.stderr.flush()


class _Watch:
    """The parent's view of the ranks: waits for keys of the store, each
    wait bounded, and stops at the first rank that ends before its time."""

    def __init__(self, store, procs):
        self.store, self.procs = store, procs

    def ended(self):
        """(rank, exit code) of the first rank that has ended, or None."""
        for r, p in enumerate(self.procs):
            if p.poll() is not None:
                return r, p.returncode
        return None

    def keys(self, keys: list, bound: float, what: str) -> bool:
        t_end = time.perf_counter() + bound
        while not self.store.check(keys):
            gone = self.ended()
            if gone is not None:
                _log(f"rank {gone[0]} ended (exit code {gone[1]}) while waiting for {what}")
                return False
            if time.perf_counter() > t_end:
                _log(f"no {what} within {bound:.1f} s")
                return False
            time.sleep(POLL_S)
        return True

    def exits(self, bound: float) -> bool:
        t_end = time.perf_counter() + bound
        while any(p.poll() is None for p in self.procs):
            if time.perf_counter() > t_end:
                _log(f"ranks still running {bound:.1f} s after the window closed")
                return False
            time.sleep(POLL_S)
        bad = [(r, p.returncode) for r, p in enumerate(self.procs) if p.returncode != 0]
        for r, rc in bad:
            _log(f"rank {r} ended with exit code {rc}")
        return not bad


def _kill(procs):
    for p in procs:
        if p.poll() is None:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(p.pid, signal.SIGKILL)
    for p in procs:
        p.wait()


def launch(pl: dict):
    """Run the plan's ranks to the end: (rank 0's outcome, every rank's
    card), or None when a rank ends early, a wait passes its bound, or a
    rank's report is missing.  Every rank has ended when this returns."""
    import torch.distributed as dist

    n = pl["chips"]
    store = dist.TCPStore("127.0.0.1", 0, is_master=True, wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=SETUP_BOUND_S))
    store.set("plan", json.dumps(pl))
    a = pl["args"]
    cmd = [sys.executable, str(Path(__file__).resolve().parents[1] / "run.py"),
           "--workload", a["workload"], "--seed", str(a["seed"]),
           "--seconds", repr(a["seconds"]), "--trace", str(a["trace"])]
    env = {**os.environ, STORE_ENV: f"127.0.0.1:{store.port}", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(_free_port()), "WORLD_SIZE": str(n), "LOCAL_WORLD_SIZE": str(n)}
    procs = []
    term = signal.getsignal(signal.SIGTERM)
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))  # so the ranks are killed
    try:
        for r in range(n):
            procs.append(subprocess.Popen(
                cmd, env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
                stdout=2, start_new_session=True))  # the result line is the parent's
        w = _Watch(store, procs)

        def each(key):
            return [f"{key}/{r}" for r in range(n)]

        left = SETUP_BOUND_S - (time.perf_counter() - pl["t_start"])
        if not w.keys(each("ready"), left, "every rank's warm job"):
            return None
        warm = max(json.loads(store.get(k))[1] for k in each("ready"))
        bound = max(WAIT_FLOOR_S, 10.0 * warm)
        _log(f"{n} ranks warm; each wait bounded by {bound:.1f} s")
        if not w.keys(each("open"), bound, "every rank's window"):
            return None
        i = 0
        while True:
            if not w.keys([f"cmd/{i}"], bound, f"rank 0's word on job {i}"):
                return None
            if store.get(f"cmd/{i}") == b"stop":
                break
            if not w.keys(each(f"done/{i}"), bound, f"job {i} on every rank"):
                return None
            i += 1
        if not w.exits(bound):
            return None
        if not store.check(each("report")):
            _log("a rank ended without its report")
            return None
        reports = [json.loads(store.get(k)) for k in each("report")]
        return reports[0]["core"], [rep["card"] for rep in reports]
    finally:
        _kill(procs)
        signal.signal(signal.SIGTERM, term)


def rank_main(measure) -> int:
    """A rank's process: its plan from the parent's store, then
    ``measure(args, wl, cfg, job, device, peers, t_start)``, then its
    report."""
    import argparse

    import torch
    import torch.distributed as dist

    from portbench.bench import guard, spec

    host, port = os.environ[STORE_ENV].rsplit(":", 1)
    store = dist.TCPStore(host, int(port), is_master=False,
                          timeout=datetime.timedelta(seconds=SETUP_BOUND_S))
    pl = json.loads(store.get("plan"))
    rank = int(os.environ["RANK"])
    device = pl["devices"][rank]
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device))
    else:
        torch.set_num_threads(1)
    job = spec._module(Path(pl["job_file"]), "portbench_rank_job")
    core, crd = measure(argparse.Namespace(**pl["args"]), pl["wl"], pl["cfg"], job, device,
                        Peers(store, rank, pl["chips"]), pl["t_start"])
    bad = guard.forbidden()  # rank 0's readers and check ran after the window's look
    if bad:
        _log(f"rank {rank} loaded modules of the JAX side: " + ", ".join(bad))
        sys.exit(3)
    store.set(f"report/{rank}", json.dumps({"core": core if rank == 0 else None, "card": crd}))
    return 0
