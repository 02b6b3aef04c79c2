"""Trajectory ingest: host-side readers producing device-ready numpy arrays
(the port's copy of ``spinrelax_tpu/io/trajectory.py``).

- .npz  : {'xyz': (nFrames, nAtoms, 3) [nm], 'time': (nFrames,) [ps]}
- .npy  : bare (nFrames, nAtoms, 3) array, memory-mapped (no time axis)
- .pdb  : multi-MODEL coordinate files (io.pdb; no time axis)
- .gro  : (multi-frame) GROMACS coordinate files (io.gro)
- .trr / .xtc : GROMACS codecs (io.gmx / the native codec, io.native)
- .dcd  : CHARMM/NAMD/X-PLOR (io.dcd)
- .nc   : Amber NetCDF via scipy's classic-NetCDF reader (io.amber)
- .mdcrd/.crd : Amber ASCII (needs the topology for the atom count)
- .xyz  : XMol multi-frame (io.xyz; Angstrom on disk -> nm)
- anything mdtraj reads, when mdtraj is installed (optional).

All readers return (xyz, timestep_ps).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from . import pdb as pdbio
from .zopen import fmt_name, is_gz

try:  # optional
    import mdtraj as _md
except Exception:  # pragma: no cover - absent in this image
    _md = None


_BINARY_EXTS = (".npz", ".npy", ".trr", ".xtc", ".dcd", ".nc")

# Formats that record NO time axis: load/iter echo the caller's timestep
# (or 1.0) back.  Stages that scale physics by dt must refuse these
# without an explicit timestep instead of silently assuming 1 ps.
# Multi-MODEL .pdb files carry no time axis either.
TIMELESS_EXTS = (".npy", ".mdcrd", ".crd", ".xyz", ".pdb")


def is_timeless(fn: str) -> bool:
    """True when the file carries no frame times (looks through .gz).

    Extension check for the always-timeless formats; .gro files are
    probed (first title line) for a ``t=`` stamp — GROMACS writes the
    stamp on every frame or none."""
    base = fmt_name(fn)
    if base.endswith(TIMELESS_EXTS):
        return True
    if base.endswith(".gro"):
        from .gro import _TIME_RE
        from .zopen import topen

        try:
            with topen(fn) as fp:
                title = fp.readline()
        except OSError:
            return False  # let the real reader raise its own error
        # Probe with the READER's stamp grammar (t= followed by a
        # parseable float), not a substring: a free-text title that
        # merely contains " t=" (e.g. "run at t=equilibrium") carries
        # no parseable frame times and must not bypass the
        # explicit-timestep guard.
        return _TIME_RE.search(title) is None
    return False


def _dispatch_name(fn: str) -> str:
    """Extension-dispatch name: looks through a trailing .gz for the TEXT
    formats (whose readers gunzip transparently, io.zopen); rejects .gz on
    the binary formats up front — their readers need seek/mmap, and .xtc
    is already compressed."""
    base = fmt_name(fn)
    if is_gz(fn) and base.endswith(_BINARY_EXTS):
        raise ValueError(
            f"{fn!r}: gzip-compressed binary trajectories are not "
            "supported (binary readers need seek/mmap) — gunzip first; "
            "text formats (.pdb/.gro/.mdcrd/.crd) read .gz transparently"
        )
    return base


def load_trajectory(
    fn: str, top_fn: Optional[str] = None
) -> Tuple[np.ndarray, float]:
    """Load any supported trajectory -> (xyz (nFrames, nAtoms, 3) nm,
    timestep ps)."""
    disp = _dispatch_name(fn)
    if disp.endswith(".npz"):
        obj = np.load(fn)
        xyz = np.asarray(obj["xyz"])
        if "time" in obj and len(obj["time"]) > 1:
            dt = float(obj["time"][1] - obj["time"][0])
        else:
            dt = float(obj.get("timestep", 1.0))
        return xyz, dt
    if disp.endswith(".npy"):
        # bare array, no time axis (the out-of-core streaming format
        # iter_trajectory documents) — callers pass dt separately.
        xyz = np.load(fn, mmap_mode="r")
        return np.asarray(xyz), 1.0
    if disp.endswith(".pdb"):
        _, xyz = pdbio.read_pdb(fn)
        return xyz, 1.0
    if disp.endswith(".gro"):
        from . import gro

        _, xyz, _boxes, times = gro.read_gro(fn)
        dt = (
            float(times[1] - times[0])
            if times is not None and len(times) > 1
            else 1.0
        )
        return xyz, dt if dt > 0 else 1.0
    if disp.endswith(".trr"):
        from . import gmx

        xyz, _boxes, times = gmx.read_trr(fn)
        dt = float(times[1] - times[0]) if len(times) > 1 else 1.0
        return xyz, dt
    if disp.endswith(".xtc"):
        from . import native

        # all cores, as iter_trajectory: frames decode independently, and
        # the output is the same bits for any thread count
        xyz, _boxes, times = native.read_xtc(fn, threads=0)
        dt = float(times[1] - times[0]) if len(times) > 1 else 1.0
        return xyz, dt
    if disp.endswith(".dcd"):
        from . import dcd as dcdio

        xyz, _boxes, times = dcdio.read_dcd(fn)
        dt = float(times[1] - times[0]) if len(times) > 1 else 1.0
        return xyz, dt
    if disp.endswith(".nc"):
        from . import amber

        xyz, _boxes, times = amber.read_nc(fn)
        dt = float(times[1] - times[0]) if len(times) > 1 else 1.0
        return xyz, dt
    if disp.endswith(".xyz"):
        from . import xyz as xyzio

        _el, xyz = xyzio.read_xyz(fn)
        return xyz, 1.0  # the format records no times
    if disp.endswith((".mdcrd", ".crd")):
        from . import amber

        xyz, _boxes, _times = amber.read_mdcrd(fn, _mdcrd_natoms(fn, top_fn))
        return xyz, 1.0  # the ASCII format records no times
    if _md is not None:
        trj = _md.load(fn, top=top_fn)
        return np.asarray(trj.xyz), float(trj.timestep)
    raise ValueError(
        f"cannot read {fn!r}: npz/npy/pdb/gro/trr/xtc/dcd/nc/mdcrd/xyz supported "
        "natively; install mdtraj for other formats"
    )


def save_trajectory_npz(fn: str, xyz: np.ndarray, timestep: float = 1.0):
    xyz = np.asarray(xyz)
    time = np.arange(xyz.shape[0]) * timestep
    np.savez_compressed(fn, xyz=xyz, time=time, timestep=timestep)


def iter_trajectory(
    fn: str,
    chunk_frames: int,
    top_fn: Optional[str] = None,
    timestep: float = 1.0,
    io_threads: int = 0,
):
    """Stream a trajectory in fixed-size frame chunks without loading it
    into RAM (the >HBM ingest path, SURVEY §5 'long-context').

    - ``.npy``  : (nFrames, nAtoms, 3) memmap — true streaming; pass the
      timestep explicitly (bare npy has no time axis).
    - ``.npz`` / ``.pdb`` : loaded once, then sliced (these formats cannot
      be memory-mapped; convert to .npy for out-of-core trajectories).
    - mdtraj formats: ``md.iterload`` when mdtraj is installed.

    ``io_threads``: worker threads for the compressed .xtc decode
    (0 = one per core, 1 = sequential; output identical regardless —
    frames decode independently after an offset scan).

    Yields (xyz_chunk (c, nAtoms, 3), timestep_ps).
    """
    disp = _dispatch_name(fn)
    if disp.endswith(".npy"):
        arr = np.load(fn, mmap_mode="r")
        for start in range(0, arr.shape[0], chunk_frames):
            yield np.asarray(arr[start : start + chunk_frames]), timestep
        return
    if disp.endswith(".trr"):
        from . import gmx

        # Two-frame lookahead: the timestep must be right from the FIRST
        # yield even at chunk_frames=1 (stage_ct_streamed probes dt with a
        # single-frame read — a wrong default mis-scales every Palmer
        # chunk; same contract as the .xtc branch above).
        frames = gmx.iter_trr(fn)
        head = []
        for x, _box, t in frames:
            head.append((x, t))
            if len(head) == 2:
                break
        if not head:
            return
        dt_out = (
            float(head[1][1] - head[0][1]) if len(head) > 1 else timestep
        )
        buf = [x for x, _t in head]
        if len(buf) >= chunk_frames:
            for off in range(0, len(buf) - len(buf) % chunk_frames,
                             chunk_frames):
                yield np.array(buf[off : off + chunk_frames]), dt_out
            buf = buf[len(buf) - len(buf) % chunk_frames :]
        for x, _box, _t in frames:
            buf.append(x)
            if len(buf) == chunk_frames:
                yield np.array(buf), dt_out
                buf = []
        if buf:
            yield np.array(buf), dt_out
        return
    if disp.endswith(".xtc"):
        import itertools

        from . import native

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
    if disp.endswith(".dcd"):
        from . import dcd as dcdio

        # DCD headers carry the frame spacing directly (DELTA x NSAVC),
        # so dt is right from the FIRST yield even at chunk_frames=1 (the
        # stage_ct_streamed single-frame dt probe) — no lookahead needed;
        # the caller's timestep is the fallback for unset-DELTA writers.
        dt_out = dcdio.header_timestep_ps(fn) or timestep
        for xyz, _boxes, _times in dcdio.iter_dcd(fn, chunk_frames):
            yield xyz, dt_out
        return
    if disp.endswith(".nc"):
        from . import amber

        # The time variable gives dt from the FIRST yield (same
        # single-frame-probe contract as the .dcd branch above).
        dt_out = amber.header_timestep_ps(fn) or timestep
        for xyz, _boxes, _times in amber.iter_nc(fn, chunk_frames):
            yield xyz, dt_out
        return
    if disp.endswith(".gro"):
        from . import gro

        # Parsed once, then sliced (text format; convert to .npy for
        # out-of-core trajectories).  dt from t= title stamps when
        # present, else the caller's timestep (same contract as .npz).
        _, xyz, _boxes, times = gro.read_gro(fn)
        dt_file = (
            float(times[1] - times[0])
            if times is not None and len(times) > 1
            else 0.0
        )
        dt_out = dt_file if dt_file > 0 else timestep
        for start in range(0, xyz.shape[0], chunk_frames):
            yield xyz[start : start + chunk_frames], dt_out
        return
    if disp.endswith(".xyz"):
        from . import xyz as xyzio

        # text format, no time axis: parsed once, sliced; the caller's
        # timestep wins (same contract as .mdcrd)
        _el, xyz = xyzio.read_xyz(fn)
        for start in range(0, xyz.shape[0], chunk_frames):
            yield xyz[start : start + chunk_frames], timestep
        return
    if disp.endswith((".mdcrd", ".crd")):
        from . import amber

        # no time axis in the ASCII format: the caller's timestep wins
        xyz, _boxes, _t = amber.read_mdcrd(fn, _mdcrd_natoms(fn, top_fn))
        for start in range(0, xyz.shape[0], chunk_frames):
            yield xyz[start : start + chunk_frames], timestep
        return
    if disp.endswith((".npz", ".pdb")):
        xyz, dt = load_trajectory(fn, top_fn=top_fn)
        # Honour the caller's explicit timestep when the FILE carries no
        # time information (a .pdb never does; an .npz only when it has a
        # time/timestep entry) — matching the .npy/.trr/.xtc branches'
        # contract instead of silently yielding the 1.0 default.
        has_file_time = False
        if disp.endswith(".npz"):
            with np.load(fn) as obj:
                has_file_time = (
                    ("time" in obj and len(obj["time"]) > 1)
                    or "timestep" in obj
                )
        dt_out = dt if has_file_time else timestep
        for start in range(0, xyz.shape[0], chunk_frames):
            yield xyz[start : start + chunk_frames], dt_out
        return
    if _md is not None:
        for trj in _md.iterload(fn, chunk=chunk_frames, top=top_fn):
            yield np.asarray(trj.xyz), float(trj.timestep)
        return
    raise ValueError(f"cannot stream {fn!r}")


def _mdcrd_natoms(fn: str, top_fn: Optional[str]) -> int:
    """Amber ASCII trajectories are headerless: the paired topology
    supplies the atom count."""
    if top_fn is None:
        raise ValueError(
            f"{fn}: Amber ASCII trajectories carry no atom count — pass "
            "the topology (top_fn/-s, e.g. the .prmtop)"
        )
    return pdbio.read_topology(top_fn).n_atoms


def _npz_boxes(obj, n_frames: int) -> Optional[np.ndarray]:
    """Normalise an npz 'box' entry to (nFrames, 3, 3) matrices.
    Accepted layouts: (nF,3,3), (3,3) shared, (nF,3) per-frame lengths,
    (3,) shared lengths."""
    if "box" not in obj:
        return None
    box = np.asarray(obj["box"])
    if box.ndim == 3:
        return box
    if box.shape == (3, 3):
        return np.broadcast_to(box, (n_frames, 3, 3)).copy()
    if box.ndim == 2 and box.shape[1] == 3:
        out = np.zeros((n_frames, 3, 3), dtype=box.dtype)
        out[:, [0, 1, 2], [0, 1, 2]] = box
        return out
    if box.shape == (3,):
        return np.broadcast_to(np.diag(box), (n_frames, 3, 3)).copy()
    raise ValueError(f"unrecognised npz box shape {box.shape}")


def iter_trajectory_full(
    fn: str,
    chunk_frames: int,
    top_fn: Optional[str] = None,
    io_threads: int = 0,
):
    """Like :func:`iter_trajectory`, but keeps the per-frame metadata:
    yields (xyz (c, nAtoms, 3) nm, boxes (c, 3, 3) nm or None,
    times (c,) ps or None).  The format-conversion path — readers that
    stream natively (xtc/trr/dcd/nc) stay constant-memory."""
    disp = _dispatch_name(fn)
    if disp.endswith(".xtc"):
        from . import native

        yield from native.iter_xtc(fn, chunk_frames, threads=io_threads)
        return
    if disp.endswith(".trr"):
        from . import gmx

        fs, bs, ts = [], [], []
        for x, b, t in gmx.iter_trr(fn):
            fs.append(x)
            bs.append(b)
            ts.append(t)
            if len(fs) == chunk_frames:
                boxes = None if any(b is None for b in bs) else np.stack(bs)
                yield np.stack(fs), boxes, np.asarray(ts, dtype=float)
                fs, bs, ts = [], [], []
        if fs:
            boxes = None if any(b is None for b in bs) else np.stack(bs)
            yield np.stack(fs), boxes, np.asarray(ts, dtype=float)
        return
    if disp.endswith(".dcd"):
        from . import dcd as dcdio

        yield from dcdio.iter_dcd(fn, chunk_frames)
        return
    if disp.endswith(".nc"):
        from . import amber

        yield from amber.iter_nc(fn, chunk_frames)
        return
    if disp.endswith(".gro"):
        from . import gro

        _top, xyz, boxes, times = gro.read_gro(fn)
        if not np.any(boxes):
            boxes = None  # zero box lines = no box information
        for lo in range(0, xyz.shape[0], chunk_frames):
            sel = slice(lo, lo + chunk_frames)
            yield (xyz[sel], None if boxes is None else boxes[sel],
                   None if times is None else times[sel])
        return
    if disp.endswith(".xyz"):
        from . import xyz as xyzio

        # text format: parsed once, sliced; no box or time metadata
        _el, xyz = xyzio.read_xyz(fn)
        for lo in range(0, xyz.shape[0], chunk_frames):
            yield xyz[lo : lo + chunk_frames], None, None
        return
    if disp.endswith((".mdcrd", ".crd")):
        from . import amber

        # text format: parsed once, sliced (convert to .npy/.nc for
        # out-of-core); no times recorded.
        xyz, boxes, _ = amber.read_mdcrd(fn, _mdcrd_natoms(fn, top_fn))
        for lo in range(0, xyz.shape[0], chunk_frames):
            sel = slice(lo, lo + chunk_frames)
            yield (xyz[sel], None if boxes is None else boxes[sel], None)
        return
    if disp.endswith(".npz"):
        obj = np.load(fn)
        xyz = np.asarray(obj["xyz"])
        n = xyz.shape[0]
        boxes = _npz_boxes(obj, n)
        if "time" in obj:
            times = np.asarray(obj["time"], dtype=float)
        elif "timestep" in obj:
            times = np.arange(n, dtype=float) * float(obj["timestep"])
        else:
            times = None
        for lo in range(0, n, chunk_frames):
            sel = slice(lo, lo + chunk_frames)
            yield (xyz[sel], None if boxes is None else boxes[sel],
                   None if times is None else times[sel])
        return
    if disp.endswith(".npy"):
        arr = np.load(fn, mmap_mode="r")
        for lo in range(0, arr.shape[0], chunk_frames):
            yield np.asarray(arr[lo : lo + chunk_frames]), None, None
        return
    if disp.endswith(".pdb"):
        _, xyz = pdbio.read_pdb(fn)
        for lo in range(0, xyz.shape[0], chunk_frames):
            yield xyz[lo : lo + chunk_frames], None, None
        return
    raise ValueError(
        f"cannot stream {fn!r}: npz/npy/pdb/gro/trr/xtc/dcd/nc/mdcrd/xyz supported"
    )
