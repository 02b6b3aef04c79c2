"""Trajectory ingest: host-side readers producing device-ready numpy arrays
(the part of ``spinrelax_tpu/io/trajectory.py`` the streamed C(t) stage
reads).

- .npz : {'xyz': (nFrames, nAtoms, 3) [nm], 'time': (nFrames,) [ps]}
- .npy : bare (nFrames, nAtoms, 3) array, memory-mapped (no time axis)
- .pdb : multi-MODEL coordinate files (io.pdb; no time axis)
- .xtc : the native GROMACS codec (io.native)

Every other extension (.gro, .trr, .dcd, .nc, .mdcrd, .crd, .xyz and what
mdtraj reads) raises ``NotImplementedError``: their readers come with
ROADMAP item 14.  All readers return (xyz, timestep_ps).
"""

from __future__ import annotations

import itertools
from typing import Optional, Tuple

import numpy as np

from . import native
from . import pdb as pdbio
from .zopen import fmt_name, is_gz

_BINARY_EXTS = (".npz", ".npy", ".xtc")
_READ_EXTS = (".npz", ".npy", ".pdb", ".xtc")

# Formats that record NO time axis: load/iter echo the caller's timestep
# (or 1.0) back.  Stages that scale physics by dt must refuse these
# without an explicit timestep instead of silently assuming 1 ps.
TIMELESS_EXTS = (".npy", ".mdcrd", ".crd", ".xyz", ".pdb")


def is_timeless(fn: str) -> bool:
    """True when the file carries no frame times (looks through .gz)."""
    return _dispatch_name(fn).endswith(TIMELESS_EXTS)


def _dispatch_name(fn: str) -> str:
    """Extension-dispatch name: looks through a trailing .gz for the text
    formats (whose readers gunzip transparently, io.zopen); rejects .gz on
    the binary formats up front -- their readers need seek/mmap, and .xtc
    is already compressed; raises for a format the port does not read."""
    base = fmt_name(fn)
    if is_gz(fn) and base.endswith(_BINARY_EXTS):
        raise ValueError(
            f"{fn!r}: gzip-compressed binary trajectories are not "
            "supported (binary readers need seek/mmap) -- gunzip first; "
            ".pdb reads .gz transparently"
        )
    if not base.endswith(_READ_EXTS):
        raise NotImplementedError(
            f"cannot read {fn!r}: the port reads .npz, .npy, .pdb and .xtc "
            "trajectories; the other formats come with ROADMAP item 14"
        )
    return base


def _spacing(times, default: float = 1.0) -> float:
    return float(times[1] - times[0]) if len(times) > 1 else default


def load_trajectory(fn: str, top_fn: Optional[str] = None) -> Tuple[np.ndarray, float]:
    """Load a trajectory -> (xyz (nFrames, nAtoms, 3) nm, timestep ps)."""
    disp = _dispatch_name(fn)
    if disp.endswith(".npz"):
        obj = np.load(fn)
        xyz = np.asarray(obj["xyz"])
        if "time" in obj and len(obj["time"]) > 1:
            return xyz, _spacing(obj["time"])
        return xyz, float(obj.get("timestep", 1.0))
    if disp.endswith(".npy"):
        # bare array, no time axis: callers pass dt separately
        return np.asarray(np.load(fn, mmap_mode="r")), 1.0
    if disp.endswith(".pdb"):
        return pdbio.read_pdb(fn)[1], 1.0
    # all cores, as iter_trajectory: frames decode independently, and the
    # output is the same bits for any thread count
    xyz, _boxes, times = native.read_xtc(fn, threads=0)
    return xyz, _spacing(times)


def save_trajectory_npz(fn: str, xyz: np.ndarray, timestep: float = 1.0):
    xyz = np.asarray(xyz)
    time = np.arange(xyz.shape[0]) * timestep
    np.savez_compressed(fn, xyz=xyz, time=time, timestep=timestep)


def iter_trajectory(fn: str, chunk_frames: int, top_fn: Optional[str] = None,
                    timestep: float = 1.0, io_threads: int = 0):
    """Stream a trajectory in fixed-size frame chunks without loading it
    into memory.

    - ``.npy``  : (nFrames, nAtoms, 3) memmap -- true streaming; pass the
      timestep explicitly (bare npy has no time axis).
    - ``.xtc``  : decoded chunk by chunk; ``io_threads`` worker threads
      (0 = one per core, 1 = sequential; output identical regardless).
    - ``.npz`` / ``.pdb`` : loaded once, then sliced.

    Yields (xyz_chunk (c, nAtoms, 3), timestep_ps).
    """
    disp = _dispatch_name(fn)
    if disp.endswith(".npy"):
        arr = np.load(fn, mmap_mode="r")
        for start in range(0, arr.shape[0], chunk_frames):
            yield np.asarray(arr[start : start + chunk_frames]), timestep
        return
    if disp.endswith(".xtc"):
        # Two-chunk lookahead so the timestep is known from the FIRST
        # yield even at chunk_frames=1 (stage_ct_streamed probes dt with
        # a single-frame read; yielding the caller's default there would
        # silently mis-scale every Palmer chunk).
        chunks = native.iter_xtc(fn, chunk_frames, threads=io_threads)
        head = list(itertools.islice(chunks, 2))
        if not head:
            return
        t0 = head[0][2]
        if len(t0) > 1:
            dt_out = float(t0[1] - t0[0])
        elif len(head) > 1:
            dt_out = float(head[1][2][0] - t0[0])
        else:
            dt_out = timestep  # single-frame file: no spacing to measure
        for xyz, _boxes, _times in itertools.chain(head, chunks):
            yield xyz, dt_out
        return
    xyz, dt = load_trajectory(fn, top_fn=top_fn)
    # Honour the caller's explicit timestep when the FILE carries no time
    # information (a .pdb never does; an .npz only when it has a
    # time/timestep entry).
    has_file_time = False
    if disp.endswith(".npz"):
        with np.load(fn) as obj:
            has_file_time = ("time" in obj and len(obj["time"]) > 1) or "timestep" in obj
    dt_out = dt if has_file_time else timestep
    for start in range(0, xyz.shape[0], chunk_frames):
        yield xyz[start : start + chunk_frames], dt_out
