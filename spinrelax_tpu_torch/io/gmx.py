"""Native GROMACS TRR trajectory I/O (no mdtraj/GROMACS needed).

TRR is a sequence of XDR-encoded frames: a fixed header (magic 1993,
version string, section sizes) followed by optional box / positions /
velocities / forces blocks in big-endian float32 or float64 (the header's
size fields imply the precision).  Reader and writer implemented from the
format specification; positions are returned in nm (GROMACS native).

The compressed XTC format (3dfcoord integer codec) lives in the native
C++ module (native/xtc.cpp via io/native.py); TRR here covers
full-precision GROMACS output in pure Python.  Foreign-bytes validation
for both: tests/test_xtc_foreign.py.

The port's copy of ``spinrelax_tpu/io/gmx.py`` (host-side numpy; the same bytes).
"""

from __future__ import annotations

import struct
from typing import Iterator, List, Optional, Tuple

import numpy as np

_MAGIC = 1993


def _read_xdr_string(fp) -> str:
    (n,) = struct.unpack(">i", fp.read(4))
    # XDR strings in trr carry an inner length then padded bytes.
    (m,) = struct.unpack(">i", fp.read(4))
    data = fp.read((m + 3) // 4 * 4)
    return data[:m].rstrip(b"\x00").decode(errors="replace")


def _write_xdr_string(fp, s: str):
    b = s.encode()
    fp.write(struct.pack(">i", len(b) + 1))
    fp.write(struct.pack(">i", len(b)))
    fp.write(b + b"\x00" * ((4 - len(b) % 4) % 4))


class TrrFrameHeader:
    __slots__ = (
        "ir_size", "e_size", "box_size", "vir_size", "pres_size", "top_size",
        "sym_size", "x_size", "v_size", "f_size", "natoms", "step", "nre",
        "time", "lam", "double",
    )


def _read_frame_header(fp) -> Optional[TrrFrameHeader]:
    raw = fp.read(4)
    if len(raw) < 4:
        return None
    (magic,) = struct.unpack(">i", raw)
    if magic != _MAGIC:
        raise ValueError(f"bad TRR magic {magic} (expected {_MAGIC})")
    _read_xdr_string(fp)  # version string, e.g. 'GMX_trn_file'
    h = TrrFrameHeader()
    (
        h.ir_size, h.e_size, h.box_size, h.vir_size, h.pres_size,
        h.top_size, h.sym_size, h.x_size, h.v_size, h.f_size,
        h.natoms, h.step, h.nre,
    ) = struct.unpack(">13i", fp.read(52))
    # Precision detection follows GROMACS's nFloatSize chain over every
    # vector block (x -> v -> f -> box): a velocity- or force-only frame
    # (nstvout != nstxout) carries no x/box yet still fixes the reals'
    # width — falling back to box alone desyncs double-precision streams.
    per = None
    if h.x_size:
        per = h.x_size / (h.natoms * 3)
    elif h.v_size:
        per = h.v_size / (h.natoms * 3)
    elif h.f_size:
        per = h.f_size / (h.natoms * 3)
    elif h.box_size:
        per = h.box_size / 9
    h.double = per == 8
    fmt = ">2d" if h.double else ">2f"
    h.time, h.lam = struct.unpack(fmt, fp.read(16 if h.double else 8))
    return h


def iter_trr(fn: str) -> Iterator[Tuple[np.ndarray, np.ndarray, float]]:
    """Yield (xyz (nAtoms, 3) [nm], box (3, 3) [nm], time [ps]) per frame."""
    with open(fn, "rb") as fp:
        while True:
            h = _read_frame_header(fp)
            if h is None:
                return
            if h.ir_size or h.e_size or h.top_size or h.sym_size:
                # Vestigial .trj-era blocks: GROMACS's own trr reader
                # (do_htrn) processes only box/vir/pres/x/v/f and never
                # these, so their on-disk position is undefined —
                # guessing would silently desync every later frame.
                raise ValueError(
                    f"{fn}: unsupported legacy TRR blocks "
                    f"(ir={h.ir_size}, e={h.e_size}, top={h.top_size}, "
                    f"sym={h.sym_size})"
                )
            dt = np.dtype(">f8") if h.double else np.dtype(">f4")
            box = np.zeros((3, 3))
            if h.box_size:
                box = np.frombuffer(fp.read(h.box_size), dtype=dt).reshape(3, 3).astype(float)
            # Canonical block order after box (GROMACS do_htrn):
            # vir, pres, x, v, f.
            if h.vir_size or h.pres_size:
                fp.read(h.vir_size + h.pres_size)
            if h.x_size:
                x = np.frombuffer(fp.read(h.x_size), dtype=dt).reshape(h.natoms, 3)
            if h.v_size:
                fp.read(h.v_size)
            if h.f_size:
                fp.read(h.f_size)
            if not h.x_size:
                # Velocity/force-only frame (nstxout != nstvout): not a
                # coordinate frame — fabricating zeros would NaN the
                # normalised bond vectors downstream.
                continue
            yield x.astype(np.float32), box, float(h.time)


def info_trr(fn: str) -> Tuple[int, int, List[float]]:
    """Header-hop scan (payloads fseek'd past, not read) ->
    (n coordinate frames, natoms, first <=2 frame times [ps])."""
    import os

    n, natoms = 0, 0
    times: List[float] = []
    with open(fn, "rb") as fp:
        size = os.fstat(fp.fileno()).st_size
        while True:
            h = _read_frame_header(fp)
            if h is None:
                break
            if h.ir_size or h.e_size or h.top_size or h.sym_size:
                raise ValueError(
                    f"{fn}: unsupported legacy TRR blocks "
                    f"(ir={h.ir_size}, e={h.e_size}, top={h.top_size}, "
                    f"sym={h.sym_size})"
                )
            fp.seek(
                h.box_size + h.vir_size + h.pres_size
                + h.x_size + h.v_size + h.f_size,
                1,
            )
            if fp.tell() > size:
                raise ValueError(f"{fn}: truncated TRR (frame payload cut)")
            if h.x_size:
                n += 1
                natoms = h.natoms
                if len(times) < 2:
                    times.append(float(h.time))
    return n, natoms, times


def read_trr(fn: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (xyz (nFrames, nAtoms, 3) [nm], boxes (nFrames, 3, 3), times)."""
    xs: List[np.ndarray] = []
    boxes: List[np.ndarray] = []
    times: List[float] = []
    for x, box, t in iter_trr(fn):
        xs.append(x)
        boxes.append(box)
        times.append(t)
    return np.array(xs), np.array(boxes), np.array(times)


def write_trr(
    fn: str,
    xyz: np.ndarray,
    times: Optional[np.ndarray] = None,
    box: Optional[np.ndarray] = None,
    double: bool = False,
):
    """Write a minimal TRR (box + positions per frame).

    box : (3, 3) shared box, or (nFrames, 3, 3) per-frame boxes (the
    shape read_trr returns, so read->write round-trips directly).
    """
    xyz = np.asarray(xyz)
    n_frames, n_atoms, _ = xyz.shape
    if times is None:
        times = np.arange(n_frames, dtype=float)
    if box is None:
        box = np.zeros((3, 3))
    box = np.asarray(box, dtype=float)
    if box.shape == (3, 3):
        box = np.broadcast_to(box, (n_frames, 3, 3))
    elif box.shape != (n_frames, 3, 3):
        # A wrong shape would silently stream extra floats into a box
        # block whose size field says 9, corrupting every later frame.
        raise ValueError(
            f"box must be (3, 3) or ({n_frames}, 3, 3), got {box.shape}"
        )
    per = 8 if double else 4
    dt = np.dtype(">f8") if double else np.dtype(">f4")
    with open(fn, "wb") as fp:
        for f in range(n_frames):
            fp.write(struct.pack(">i", _MAGIC))
            _write_xdr_string(fp, "GMX_trn_file")
            fp.write(
                struct.pack(
                    ">13i",
                    0, 0, 9 * per, 0, 0, 0, 0,
                    n_atoms * 3 * per, 0, 0,
                    n_atoms, f, 0,
                )
            )
            fmt = ">2d" if double else ">2f"
            fp.write(struct.pack(fmt, float(times[f]), 0.0))
            fp.write(np.ascontiguousarray(box[f], dtype=dt).tobytes())
            fp.write(np.ascontiguousarray(xyz[f], dtype=dt).tobytes())
