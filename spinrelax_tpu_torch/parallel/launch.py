"""Process groups for the multi-device paths: one process per device.

The JAX package runs a mesh inside one process (its tests fake eight CPU
devices); PyTorch runs one process per device in a ``torch.distributed``
process group.  This module starts that group three ways:

- :func:`spawn` starts ``world_size`` ranks of a function on this host
  (the CPU tests' gloo ranks, or one rank per card), through a
  ``FileStore`` in a temporary directory, so no port is needed and
  parallel test workers cannot race for one;
- :func:`start_one_rank` starts the world-size-1 group that ``--devices 1``
  and ``chip_smoke.py`` use, in the calling process;
- :func:`init_from_env` joins the group ``torchrun`` describes in the
  environment (``torchrun --nproc-per-node N -m spinrelax_tpu_torch ...``).

The backend follows the device: NCCL for ``cuda``, gloo for ``cpu``.  A
CUDA group without a card raises (``checked_device``); nothing falls back
to the CPU.
"""

from __future__ import annotations

import atexit
import datetime
import os
import pickle
import shutil
import tempfile
import time

import torch
import torch.distributed as dist

from .. import checked_device

TIMEOUT_S = 600.0  # default process-group timeout: a hung collective raises


def backend_for(device) -> str:
    """The process-group backend of ``device``: nccl for cuda, gloo for cpu."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return "nccl"
    if dev.type == "cpu":
        return "gloo"
    raise ValueError(f"no process-group backend for device {dev}")


def init_group(rank: int, world_size: int, device, store=None,
               timeout: float = TIMEOUT_S, init_method=None) -> torch.device:
    """Join (or start) the default process group as ``rank`` of
    ``world_size`` on ``device``, whose CUDA index is set before the group
    starts; the group is torn down at the interpreter's exit if no one
    has done so before (:func:`stop`).  Returns the rank's device."""
    dev = checked_device(device)
    kw = {}
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    dist.init_process_group(
        backend_for(dev), init_method=init_method, store=store, rank=rank,
        world_size=world_size, timeout=datetime.timedelta(seconds=timeout), **kw)
    atexit.register(stop)
    return dev


def start_one_rank(device="cuda", timeout: float = TIMEOUT_S) -> torch.device:
    """Start a world-size-1 group on ``device`` in this process (an
    in-memory store: no file, no port).  A group already started with one
    rank is kept; one of several ranks raises."""
    if dist.is_initialized():
        if dist.get_world_size() != 1:
            raise RuntimeError(
                f"start_one_rank: a process group of {dist.get_world_size()} ranks "
                "is already running")
        return checked_device(device)
    return init_group(0, 1, device, store=dist.HashStore(), timeout=timeout)


def init_from_env(device="cuda", timeout: float = TIMEOUT_S) -> torch.device:
    """Join the group that ``torchrun`` describes (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT); on the card the rank takes the
    device of its LOCAL_RANK."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return init_group(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), dev,
                      timeout=timeout, init_method="env://")


def launched_by_torchrun() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def stop() -> None:
    """Tear the default group down (before exit, so the process does not
    wait on NCCL's background threads), and forget its meshes."""
    from .mesh import _MESHES

    _MESHES.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


def _rank_main(rank, fn, world_size, args, device, timeout, tmpdir):
    """One spawned rank: join the group, run ``fn(rank, world_size,
    *args)``, leave the group, and pickle the result for the parent."""
    dev = torch.device(device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(tmpdir, "store"), world_size)
    init_group(rank, world_size, dev, store=store, timeout=timeout)
    try:
        out = fn(rank, world_size, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmpdir, f"rank{rank}.pkl"), "wb") as fp:
        pickle.dump(out, fp)


def spawn(fn, world_size: int, *args, device="cuda", timeout: float = 300.0) -> list:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` spawned
    processes, each a rank of one group on ``device`` (rank r takes
    cuda:r on the card; on the CPU one thread a rank).  ``fn`` must be
    importable by name (a module-level function).  Returns every rank's
    result, in rank order.

    ``timeout`` [s] bounds both the group's collectives and the whole
    run: when any rank fails or the time passes, every rank is killed and
    the call raises."""
    dev = checked_device(device)
    if dev.type == "cuda" and world_size > torch.cuda.device_count():
        raise ValueError(
            f"spawn: {world_size} ranks on the card need {world_size} devices; "
            f"{torch.cuda.device_count()} present")
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="spinrelax_ranks_")
    try:
        ctx = mp.start_processes(
            _rank_main, args=(fn, world_size, args, str(dev), timeout, tmp),
            nprocs=world_size, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=max(0.0, min(1.0, deadline - time.monotonic()))):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                for p in ctx.processes:
                    p.join()
                raise TimeoutError(
                    f"spawn: {world_size} ranks did not finish within {timeout:g} s")
        out = []
        for r in range(world_size):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as fp:
                out.append(pickle.load(fp))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
