"""CHARMM / NAMD / X-PLOR DCD trajectory I/O (host-side, clean-room).

The reference ingests trajectories through mdtraj (md.load/md.iterload,
calculate-Ct-from-traj.py:426-458), which accepts DCD; this module keeps
that ingest path available natively.  Implemented from the public format
description (Fortran sequential records, 'CORD' header with the 20-int
icntrl block, 80-char title cards, natoms, then per frame an optional
6-double unit-cell record and three float32 coordinate records).

Conventions follow the rest of io/: coordinates returned in nanometres
(DCD stores Angstrom), times in picoseconds (the header's AKMA-unit
DELTA x NSAVC when present).  Both byte orders are read; writing is
little-endian CHARMM-style (version 24, float32 DELTA).

Unsupported corners fail loudly instead of mis-parsing: fixed-atom files
(nfixed > 0 changes the record layout after frame 1) and CHARMM 4D
trajectories.

The port's copy of ``spinrelax_tpu/io/dcd.py`` (host-side numpy; the same bytes).
"""

from __future__ import annotations

import os
import struct
from typing import Iterator, Optional, Tuple

import numpy as np

# 1 AKMA time unit in ps (CHARMM's internal unit, used for DELTA).
AKMA_PS = 0.04888821


class DcdError(ValueError):
    pass


def _read_record(fp, endian: str) -> bytes:
    head = fp.read(4)
    if len(head) < 4:
        raise DcdError("truncated DCD: missing record marker")
    (n,) = struct.unpack(endian + "i", head)
    if n < 0 or n > (1 << 30):
        raise DcdError(f"corrupt DCD record length {n}")
    body = fp.read(n)
    if len(body) < n:
        raise DcdError("truncated DCD: record body cut short")
    tail = fp.read(4)
    if len(tail) < 4 or struct.unpack(endian + "i", tail)[0] != n:
        raise DcdError("corrupt DCD: record length suffix mismatch")
    return body


class _Header:
    __slots__ = (
        "endian", "n_frames", "nsavc", "delta", "has_cell", "charmm",
        "natoms", "frame0_off", "frame_bytes",
    )


def _read_header(fp) -> _Header:
    h = _Header()
    first = fp.read(4)
    if len(first) < 4:
        raise DcdError("truncated DCD: empty file")
    if struct.unpack("<i", first)[0] == 84:
        h.endian = "<"
    elif struct.unpack(">i", first)[0] == 84:
        h.endian = ">"
    else:
        raise DcdError("not a DCD file (first record is not 84 bytes)")
    fp.seek(0)
    blk = _read_record(fp, h.endian)
    if blk[:4] != b"CORD":
        raise DcdError("not a coordinate DCD (missing CORD magic)")
    icntrl = struct.unpack(h.endian + "20i", blk[4:84])
    h.charmm = icntrl[19] != 0
    h.n_frames = icntrl[0]
    h.nsavc = icntrl[2]
    nfixed = icntrl[8]
    if nfixed != 0:
        raise DcdError(
            f"fixed-atom DCD (nfixed={nfixed}) is not supported: frames "
            "after the first store only free atoms"
        )
    if h.charmm:
        (h.delta,) = struct.unpack(h.endian + "f", blk[4 + 9 * 4: 4 + 10 * 4])
        h.has_cell = icntrl[10] != 0
        if icntrl[11] != 0:
            raise DcdError("CHARMM 4D trajectories are not supported")
    else:
        # X-PLOR stores DELTA as a double spanning icntrl[9:11].
        (h.delta,) = struct.unpack(h.endian + "d", blk[4 + 9 * 4: 4 + 11 * 4])
        h.has_cell = False
    _read_record(fp, h.endian)  # title cards (ignored)
    natoms_blk = _read_record(fp, h.endian)
    if len(natoms_blk) != 4:
        raise DcdError("corrupt DCD: natoms record is not one int")
    (h.natoms,) = struct.unpack(h.endian + "i", natoms_blk)
    if h.natoms <= 0:
        raise DcdError(f"corrupt DCD: natoms = {h.natoms}")
    h.frame0_off = fp.tell()
    coord_rec = 4 + 4 * h.natoms + 4
    h.frame_bytes = 3 * coord_rec + ((4 + 48 + 4) if h.has_cell else 0)
    return h


def _cell_to_box(cell: np.ndarray) -> np.ndarray:
    """6-double XTLABC record -> (3, 3) triclinic box in nm.

    The record is the lower triangle (A, gamma', B, beta', alpha', C)
    with lengths in Angstrom; NAMD/new-CHARMM store the primed entries as
    COSINES of the cell angles, older tools as degrees.  Values in
    [-1, 1] are treated as cosines (a real cell angle below ~57 deg is
    not representable in degrees inside that range anyway, and every
    orthorhombic writer emits exact 0.0 / 90.0)."""
    a, g, b, be, al, c = (float(v) for v in cell)
    def cosang(v):
        if -1.0 <= v <= 1.0:
            return v
        return float(np.cos(np.deg2rad(v)))
    ca, cb, cg = cosang(al), cosang(be), cosang(g)
    a, b, c = a / 10.0, b / 10.0, c / 10.0  # A -> nm
    # GROMACS-style lower-triangular box vectors.
    sg = float(np.sqrt(max(0.0, 1.0 - cg * cg)))
    bx, by = b * cg, b * sg
    cx = c * cb
    cy = c * (ca - cb * cg) / sg if sg > 0 else 0.0
    cz = float(np.sqrt(max(0.0, c * c - cx * cx - cy * cy)))
    return np.array([[a, 0.0, 0.0], [bx, by, 0.0], [cx, cy, cz]])


def _read_frame(fp, h: _Header):
    box = None
    if h.has_cell:
        cell_blk = _read_record(fp, h.endian)
        if len(cell_blk) != 48:
            raise DcdError("corrupt DCD: unit-cell record is not 6 doubles")
        box = _cell_to_box(np.frombuffer(cell_blk, dtype=h.endian + "f8"))
    coords = np.empty((h.natoms, 3), dtype=np.float32)
    for k in range(3):
        blk = _read_record(fp, h.endian)
        if len(blk) != 4 * h.natoms:
            raise DcdError(
                f"corrupt DCD: coordinate record has {len(blk) // 4} "
                f"values, expected {h.natoms}"
            )
        coords[:, k] = np.frombuffer(blk, dtype=h.endian + "f4")
    return coords * np.float32(0.1), box  # A -> nm


def _timestep_ps(h: _Header) -> float:
    """Frame spacing in ps from the header (DELTA x NSAVC, AKMA units);
    0.0 when the writer left DELTA unset."""
    dt = float(h.delta) * max(int(h.nsavc), 1) * AKMA_PS
    return dt if dt > 0 else 0.0


def header_timestep_ps(fn: str) -> float:
    """Read only the header and return the frame spacing in ps
    (0.0 when the file does not record one)."""
    with open(fn, "rb") as fp:
        return _timestep_ps(_read_header(fp))


def info_dcd(fn: str) -> Tuple[int, int, float]:
    """Header-only inspection -> (n frames, natoms, timestep ps or 0.0).
    The frame count comes from the file size (fixed frame stride), not
    the header's advisory NSET; a trailing partial frame errors."""
    with open(fn, "rb") as fp:
        h = _read_header(fp)
        size = os.fstat(fp.fileno()).st_size
        payload = size - h.frame0_off
        if payload % h.frame_bytes:
            raise DcdError(
                f"{fn}: {payload % h.frame_bytes} trailing bytes "
                "(truncated frame?)"
            )
        return payload // h.frame_bytes, h.natoms, _timestep_ps(h)


def read_dcd(fn: str) -> Tuple[np.ndarray, Optional[np.ndarray], np.ndarray]:
    """Read a whole DCD -> (xyz (nFrames, nAtoms, 3) nm,
    boxes (nFrames, 3, 3) nm or None, times (nFrames,) ps).

    The header frame count is advisory (crashed runs leave it stale);
    frames are read until EOF, and a partial trailing frame errors."""
    frames, boxes = [], []
    with open(fn, "rb") as fp:
        h = _read_header(fp)
        size = os.fstat(fp.fileno()).st_size
        while fp.tell() < size:
            xyz, box = _read_frame(fp, h)
            frames.append(xyz)
            boxes.append(box)
    if not frames:
        raise DcdError(f"{fn}: no frames")
    dt = _timestep_ps(h) or 1.0
    times = np.arange(len(frames), dtype=np.float64) * dt
    xyz = np.stack(frames)
    out_boxes = None if boxes[0] is None else np.stack(boxes)
    return xyz, out_boxes, times


def iter_dcd(
    fn: str, chunk_frames: int
) -> Iterator[Tuple[np.ndarray, Optional[np.ndarray], np.ndarray]]:
    """Stream a DCD in fixed-size frame chunks (constant memory).
    Yields (xyz (c, nAtoms, 3) nm, boxes (c, 3, 3) or None, times (c,) ps)."""
    with open(fn, "rb") as fp:
        h = _read_header(fp)
        size = os.fstat(fp.fileno()).st_size
        dt = _timestep_ps(h) or 1.0
        start = 0
        frames, boxes = [], []
        while fp.tell() < size:
            xyz, box = _read_frame(fp, h)
            frames.append(xyz)
            boxes.append(box)
            if len(frames) == chunk_frames:
                times = (start + np.arange(len(frames), dtype=np.float64)) * dt
                yield (np.stack(frames),
                       None if boxes[0] is None else np.stack(boxes), times)
                start += len(frames)
                frames, boxes = [], []
        if frames:
            times = (start + np.arange(len(frames), dtype=np.float64)) * dt
            yield (np.stack(frames),
                   None if boxes[0] is None else np.stack(boxes), times)


def write_dcd(
    fn: str,
    xyz: np.ndarray,
    boxes: Optional[np.ndarray] = None,
    timestep_ps: float = 1.0,
    nsavc: int = 1,
    append: bool = False,
):
    """Write (nFrames, nAtoms, 3) nm coordinates as a little-endian
    CHARMM-format DCD (crystal records when ``boxes`` is given —
    orthorhombic boxes write exact 90-degree cosines).

    ``append=True`` extends a DCD this function previously wrote and
    patches the header frame counts in place — the streaming-writer
    path for >RAM conversions.  The appended chunk must match the
    file's natoms and crystal-record layout."""
    xyz = np.asarray(xyz)
    if xyz.ndim != 3 or xyz.shape[2] != 3:
        raise ValueError(f"xyz must be (nFrames, nAtoms, 3), got {xyz.shape}")
    n_frames, natoms = xyz.shape[:2]
    if append and os.path.exists(fn):
        with open(fn, "r+b") as fp:
            h = _read_header(fp)
            if h.endian != "<":
                raise DcdError(f"{fn}: can only append to little-endian DCD")
            if h.natoms != natoms:
                raise DcdError(
                    f"{fn}: appending {natoms}-atom frames to a "
                    f"{h.natoms}-atom DCD"
                )
            if h.has_cell != (boxes is not None):
                raise DcdError(
                    f"{fn}: crystal-record layout mismatch on append "
                    f"(file has_cell={h.has_cell}, chunk "
                    f"boxes={'set' if boxes is not None else 'None'})"
                )
            fp.seek(0, os.SEEK_END)
            _write_frames(fp, xyz, boxes)
            total = h.n_frames + n_frames
            # icntrl[0] (NSET) sits at byte 8 (marker + 'CORD'),
            # icntrl[3] (NSTEP) at byte 20.
            fp.seek(8)
            fp.write(struct.pack("<i", total))
            fp.seek(8 + 3 * 4)
            fp.write(struct.pack("<i", total * max(h.nsavc, 1)))
        return
    delta = float(timestep_ps) / (AKMA_PS * max(int(nsavc), 1))
    icntrl = [0] * 20
    icntrl[0] = n_frames
    icntrl[1] = nsavc
    icntrl[2] = nsavc
    icntrl[3] = n_frames * nsavc
    icntrl[10] = 1 if boxes is not None else 0
    icntrl[19] = 24  # CHARMM version -> float32 DELTA + cell records

    with open(fn, "wb") as fp:
        blk = b"CORD"
        blk += struct.pack("<9i", *icntrl[:9])
        blk += struct.pack("<f", delta)
        blk += struct.pack("<10i", *icntrl[10:])
        fp.write(_rec(blk))
        title = b"REMARKS written by spinrelax_tpu".ljust(80)[:80]
        fp.write(_rec(struct.pack("<i", 1) + title))
        fp.write(_rec(struct.pack("<i", natoms)))
        _write_frames(fp, xyz, boxes)


def _rec(body: bytes) -> bytes:
    return struct.pack("<i", len(body)) + body + struct.pack("<i", len(body))


def _write_frames(fp, xyz: np.ndarray, boxes: Optional[np.ndarray]):
    for f in range(xyz.shape[0]):
        if boxes is not None:
            bx = np.asarray(boxes[f], dtype=np.float64) * 10.0  # nm -> A
            if bx.ndim == 1:
                a, b, c = bx[:3]
                ca = cb = cg = 0.0
            else:
                a = float(np.linalg.norm(bx[0]))
                b = float(np.linalg.norm(bx[1]))
                c = float(np.linalg.norm(bx[2]))
                ca = float(bx[1] @ bx[2] / (b * c)) if b * c else 0.0
                cb = float(bx[0] @ bx[2] / (a * c)) if a * c else 0.0
                cg = float(bx[0] @ bx[1] / (a * b)) if a * b else 0.0
            fp.write(_rec(struct.pack("<6d", a, cg, b, cb, ca, c)))
        frame = np.asarray(xyz[f], dtype=np.float32) * np.float32(10.0)
        for k in range(3):
            fp.write(_rec(np.ascontiguousarray(frame[:, k]).tobytes()))
