"""Amber NetCDF trajectory I/O (host-side).

The reference ingests trajectories through mdtraj
(calculate-Ct-from-traj.py:426-458), which accepts Amber .nc files; this
module keeps that path available natively via scipy's classic-NetCDF
reader (Amber trajectories are CDF-1/CDF-2 by convention — AMBER
conventions v1.0: dimensions (frame, atom, spatial), float32
``coordinates`` in Angstrom, ``time`` in ps, optional
``cell_lengths``/``cell_angles``).

Conventions follow the rest of io/: coordinates in nanometres, times in
picoseconds, boxes as (3, 3) lower-triangular GROMACS-style matrices.
Reads are memory-mapped, so :func:`iter_nc` streams fixed-size frame
chunks without loading the file.

The port's copy of ``spinrelax_tpu/io/amber.py`` (host-side numpy; the same bytes).
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

from .zopen import topen


class AmberNcError(ValueError):
    pass


def _open(fn: str):
    from scipy.io import netcdf_file

    try:
        nc = netcdf_file(fn, "r", mmap=True)
    except Exception as e:  # scipy raises bare TypeError/ValueError here
        raise AmberNcError(f"{fn}: not a classic NetCDF file ({e})")
    conventions = getattr(nc, "Conventions", b"")
    if isinstance(conventions, bytes):
        conventions = conventions.decode("ascii", "replace")
    if "AMBER" not in conventions.upper():
        nc.close()
        raise AmberNcError(
            f"{fn}: Conventions={conventions!r} is not an AMBER trajectory"
        )
    if "coordinates" not in nc.variables:
        nc.close()
        raise AmberNcError(f"{fn}: no 'coordinates' variable")
    return nc


def _boxes_from(nc, sel) -> Optional[np.ndarray]:
    # np.array (copy=True): mmap-backed netcdf arrays must be copied so
    # nc.close() can unmap the file cleanly.
    if "cell_lengths" not in nc.variables:
        return None
    lengths = np.array(nc.variables["cell_lengths"][sel], dtype=np.float64)
    if "cell_angles" in nc.variables:
        ang = np.array(nc.variables["cell_angles"][sel], dtype=np.float64)
    else:
        ang = np.full_like(lengths, 90.0)
    a, b, c = (lengths[..., i] / 10.0 for i in range(3))  # A -> nm
    ca, cb, cg = (np.cos(np.deg2rad(ang[..., i])) for i in range(3))
    sg = np.sqrt(np.maximum(0.0, 1.0 - cg * cg))
    out = np.zeros(lengths.shape[:-1] + (3, 3))
    out[..., 0, 0] = a
    out[..., 1, 0] = b * cg
    out[..., 1, 1] = b * sg
    out[..., 2, 0] = c * cb
    cy = np.where(sg > 0, c * (ca - cb * cg) / np.where(sg > 0, sg, 1.0), 0.0)
    out[..., 2, 1] = cy
    out[..., 2, 2] = np.sqrt(
        np.maximum(0.0, c * c - out[..., 2, 0] ** 2 - cy * cy)
    )
    return out


def _times_from(nc, sel, n: int, start: int) -> np.ndarray:
    if "time" in nc.variables:
        return np.array(nc.variables["time"][sel], dtype=np.float64)
    return np.arange(start, start + n, dtype=np.float64)


def read_nc(fn: str) -> Tuple[np.ndarray, Optional[np.ndarray], np.ndarray]:
    """Read a whole Amber NetCDF -> (xyz (nFrames, nAtoms, 3) nm,
    boxes (nFrames, 3, 3) nm or None, times (nFrames,) ps)."""
    nc = _open(fn)
    try:
        xyz = np.array(
            nc.variables["coordinates"][:], dtype=np.float32
        ) * np.float32(0.1)
        if xyz.ndim != 3 or xyz.shape[-1] != 3:
            raise AmberNcError(f"{fn}: coordinates shape {xyz.shape}")
        n = xyz.shape[0]
        return xyz, _boxes_from(nc, slice(None)), _times_from(
            nc, slice(None), n, 0
        )
    finally:
        nc.close()


def iter_nc(
    fn: str, chunk_frames: int
) -> Iterator[Tuple[np.ndarray, Optional[np.ndarray], np.ndarray]]:
    """Stream an Amber NetCDF in fixed-size frame chunks (memory-mapped
    reads — only the sliced pages are touched)."""
    nc = _open(fn)
    try:
        n_frames = nc.variables["coordinates"].shape[0]
        for lo in range(0, n_frames, chunk_frames):
            sel = slice(lo, min(lo + chunk_frames, n_frames))
            xyz = np.array(
                nc.variables["coordinates"][sel], dtype=np.float32
            ) * np.float32(0.1)
            yield xyz, _boxes_from(nc, sel), _times_from(
                nc, sel, xyz.shape[0], lo
            )
    finally:
        nc.close()


def header_timestep_ps(fn: str) -> float:
    """Frame spacing from the first two time entries (0.0 when the file
    stores none or only one frame)."""
    nc = _open(fn)
    try:
        if "time" in nc.variables and nc.variables["time"].shape[0] > 1:
            t = np.array(nc.variables["time"][:2], dtype=np.float64)
            return float(t[1] - t[0])
        return 0.0
    finally:
        nc.close()


def read_mdcrd(
    fn: str, natoms: int, has_box: Optional[bool] = None
) -> Tuple[np.ndarray, Optional[np.ndarray], None]:
    """Read an Amber ASCII trajectory (.mdcrd/.crd: title line, then
    10F8.3 coordinate fields in Angstrom, frames back-to-back, an
    optional 3-value box line after each frame).

    The format is headerless, so ``natoms`` must come from the paired
    topology.  ``has_box=None`` auto-detects from the total value count;
    genuinely ambiguous files (divisible both ways) must say."""
    if natoms <= 0:
        raise AmberNcError(f"{fn}: natoms must be positive, got {natoms}")
    vals: list = []
    with topen(fn) as fp:
        fp.readline()  # title
        for line in fp:
            line = line.rstrip("\n")
            # fixed 8-char fields (values can touch at full width)
            for off in range(0, len(line), 8):
                piece = line[off : off + 8]
                if piece.strip():
                    try:
                        vals.append(float(piece))
                    except ValueError:
                        raise AmberNcError(
                            f"{fn}: unparseable field {piece!r}"
                        )
    total = len(vals)
    per_plain, per_box = 3 * natoms, 3 * natoms + 3
    if total == 0:
        raise AmberNcError(f"{fn}: no coordinate data")
    if has_box is None:
        div_plain = total % per_plain == 0
        div_box = total % per_box == 0
        if div_plain and div_box:
            raise AmberNcError(
                f"{fn}: frame layout ambiguous at natoms={natoms} "
                f"({total} values divide both with and without a box "
                "line) — pass has_box explicitly"
            )
        if div_plain:
            has_box = False
        elif div_box:
            has_box = True
        else:
            raise AmberNcError(
                f"{fn}: {total} values is not a whole number of "
                f"{natoms}-atom frames (with or without box lines)"
            )
    per = per_box if has_box else per_plain
    if total % per:
        raise AmberNcError(
            f"{fn}: {total} values is not a whole number of frames "
            f"at natoms={natoms}, has_box={has_box}"
        )
    arr = np.asarray(vals).reshape(total // per, per)
    xyz = (
        arr[:, : 3 * natoms].reshape(-1, natoms, 3).astype(np.float32)
        * np.float32(0.1)
    )
    boxes = None
    if has_box:
        lengths = arr[:, 3 * natoms :] / 10.0
        boxes = np.zeros((arr.shape[0], 3, 3))
        boxes[:, [0, 1, 2], [0, 1, 2]] = lengths
    return xyz, boxes, None  # the format records no times


def write_mdcrd(
    fn: str,
    xyz: np.ndarray,
    boxes: Optional[np.ndarray] = None,
    title: str = "written by spinrelax_tpu",
):
    """Write (nFrames, nAtoms, 3) nm coordinates as Amber ASCII
    (10F8.3, Angstrom; orthorhombic box lengths per frame when given)."""
    xyz = np.asarray(xyz)
    if xyz.ndim != 3 or xyz.shape[2] != 3:
        raise ValueError(f"xyz must be (nFrames, nAtoms, 3), got {xyz.shape}")
    ang = xyz * 10.0
    if np.abs(ang).max(initial=0.0) >= 10000.0 or ang.min(initial=0.0) <= -1000.0:
        raise ValueError(
            f"{fn}: coordinates overflow the 10F8.3 field in Angstrom"
        )

    def rows(flat):
        for off in range(0, len(flat), 10):
            yield "".join("%8.3f" % v for v in flat[off : off + 10])

    with topen(fn, "w") as fp:
        print(title, file=fp)
        for f in range(xyz.shape[0]):
            for row in rows(ang[f].reshape(-1)):
                print(row, file=fp)
            if boxes is not None:
                b = np.asarray(boxes[f])
                lens = np.diag(b) if b.ndim == 2 else b[:3]
                print("".join("%8.3f" % (v * 10.0) for v in lens), file=fp)


def write_nc(
    fn: str,
    xyz: np.ndarray,
    boxes: Optional[np.ndarray] = None,
    timestep_ps: float = 1.0,
    times: Optional[np.ndarray] = None,
):
    """Write (nFrames, nAtoms, 3) nm coordinates as an AMBER-conventions
    NetCDF trajectory (orthorhombic boxes only — the cell_angles are
    written as 90 degrees)."""
    from scipy.io import netcdf_file

    xyz = np.asarray(xyz)
    if xyz.ndim != 3 or xyz.shape[2] != 3:
        raise ValueError(f"xyz must be (nFrames, nAtoms, 3), got {xyz.shape}")
    n_frames, natoms = xyz.shape[:2]
    nc = netcdf_file(fn, "w", version=2)  # CDF-2 like modern Amber
    try:
        nc.Conventions = "AMBER"
        nc.ConventionVersion = "1.0"
        nc.program = "spinrelax_tpu"
        nc.programVersion = "1"
        nc.title = "written by spinrelax_tpu"
        nc.createDimension("frame", None)
        nc.createDimension("atom", natoms)
        nc.createDimension("spatial", 3)
        v_t = nc.createVariable("time", "f", ("frame",))
        v_t.units = "picosecond"
        if times is not None:
            v_t[:] = np.asarray(times, dtype=np.float32)
        else:
            v_t[:] = np.arange(n_frames, dtype=np.float32) * np.float32(
                timestep_ps
            )
        v_c = nc.createVariable("coordinates", "f", ("frame", "atom", "spatial"))
        v_c.units = "angstrom"
        v_c[:] = np.asarray(xyz, dtype=np.float32) * np.float32(10.0)
        if boxes is not None:
            boxes = np.asarray(boxes, dtype=np.float64)
            nc.createDimension("cell_spatial", 3)
            nc.createDimension("cell_angular", 3)
            v_l = nc.createVariable("cell_lengths", "d", ("frame", "cell_spatial"))
            v_l.units = "angstrom"
            v_a = nc.createVariable("cell_angles", "d", ("frame", "cell_angular"))
            v_a.units = "degree"
            if boxes.ndim == 3:  # (nFrames, 3, 3) matrices
                off = boxes - boxes * np.eye(3)
                if np.abs(off).max() > 1e-9:
                    raise ValueError(
                        "write_nc supports orthorhombic boxes only "
                        "(cell_angles are written as 90 degrees)"
                    )
                lens = np.einsum("fii->fi", boxes)
            else:  # (nFrames, 3) lengths
                lens = boxes
            v_l[:] = lens * 10.0  # nm -> A
            v_a[:] = np.full((n_frames, 3), 90.0)
    finally:
        nc.close()
