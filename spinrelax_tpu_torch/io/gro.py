"""GROMACS .gro coordinate I/O (host-side, clean-room).

The reference's workflow materialises GROMACS structures as PDB
(create-reference-pdb.bash:63 runs ``gmx editconf -o reference.pdb``),
but every GROMACS deployment equally produces .gro files — the
toolchain's default structure format (``gmx solvate``, ``grompp -c``,
``trjconv -o traj.gro``).  This module keeps that ingest path available
natively so the CLI accepts .gro wherever it accepts .pdb.

Format (fixed columns): per frame a free-text title line (optionally
carrying ``t= <ps>``), the atom count, atom lines
``%5d%-5s%5s%5d`` + 3 (or 6, with velocities) fixed-width floats, and a
3- or 9-value box line ``v1x v2y v3z [v1y v1z v2x v2z v3x v3y]``.
Concatenated frames form a trajectory.  Coordinates are already in nm
(no unit conversion, unlike the Angstrom formats in io/).

.gro carries no chain ids, occupancies, or element symbols; the
returned Topology uses '' chains, occupancy 1.0 everywhere (so
``occupancy > 0`` selections keep every atom), and elements guessed
from the first letter of the atom name (only consumed by write_pdb).

The port's copy of ``spinrelax_tpu/io/gro.py`` (host-side numpy; the same bytes).
"""

from __future__ import annotations

import re
from typing import List, Optional, Tuple

import numpy as np

from .zopen import topen

from .pdb import Topology


class GroError(ValueError):
    pass


# The GROMACS title-line time stamp, ``t= <float>``.  The group must be
# a PARSEABLE float (not just float-alphabet characters): a free-text
# title like "run at t=equilibrium" must neither crash float() here nor
# defeat the is_timeless probe in io.trajectory, which keys on this
# same regex.
_TIME_RE = re.compile(
    r"\bt\s*=\s*([-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?)"
)


def _parse_floats(rest: str, fn: str, lineno: int) -> List[float]:
    """Fixed-width float fields after the 20-char atom prefix.

    GROMACS writes equal-width fields (width = decimals + 5, default
    %8.3f positions / %8.4f velocities, both width 8; ``-ndec`` widens
    uniformly).  Adjacent negative values can touch, so whitespace
    splitting is only a fallback for hand-edited files."""
    rest = rest.rstrip("\r\n")
    dot1 = rest.find(".")
    dot2 = rest.find(".", dot1 + 1)
    if dot1 >= 0 and dot2 > dot1:
        w = dot2 - dot1
        n = len(rest) // w
        if n in (3, 6) and len(rest) % w == 0:
            try:
                return [float(rest[i * w : (i + 1) * w]) for i in range(n)]
            except ValueError:
                pass
    vals = rest.split()
    if len(vals) in (3, 6):
        try:
            return [float(v) for v in vals]
        except ValueError:
            pass
    raise GroError(f"{fn}:{lineno}: cannot parse coordinate fields {rest!r}")


def _parse_box(line: str, fn: str, lineno: int) -> np.ndarray:
    try:
        f = [float(v) for v in line.split()]
    except ValueError:
        f = []
    if len(f) not in (3, 9):
        raise GroError(f"{fn}:{lineno}: box line needs 3 or 9 values")
    box = np.zeros((3, 3))
    box[0, 0], box[1, 1], box[2, 2] = f[0], f[1], f[2]
    if len(f) == 9:
        # GROMACS order: v1y v1z v2x v2z v3x v3y.
        box[0, 1], box[0, 2] = f[3], f[4]
        box[1, 0], box[1, 2] = f[5], f[6]
        box[2, 0], box[2, 1] = f[7], f[8]
    return box


def _guess_element(name: str) -> str:
    for ch in name:
        if ch.isalpha():
            return ch.upper()
    return ""


def read_gro(
    fn: str,
) -> Tuple[Topology, np.ndarray, np.ndarray, np.ndarray]:
    """Read a (possibly multi-frame) .gro file.

    Returns (Topology, xyz (nFrames, nAtoms, 3) nm,
    boxes (nFrames, 3, 3) nm, times).  Times come from ``t=`` in the
    title lines; ``times`` is None when no frame carries a stamp (so
    callers can fall back to an explicit timestep instead of mistaking
    synthesized indices for real times), and frames missing a stamp in
    a partially-stamped file get their index."""
    frames: List[np.ndarray] = []
    boxes: List[np.ndarray] = []
    times: List[float] = []
    top: Optional[Topology] = None
    with topen(fn) as fp:
        lineno = 0
        while True:
            title = fp.readline()
            lineno += 1
            if not title:
                break
            if not title.strip() and not frames:
                raise GroError(f"{fn}: empty title line")
            nline = fp.readline()
            lineno += 1
            try:
                natoms = int(nline)
            except ValueError:
                raise GroError(
                    f"{fn}:{lineno}: expected atom count, got {nline!r}"
                )
            if natoms <= 0:
                raise GroError(f"{fn}:{lineno}: atom count {natoms}")
            if top is not None and natoms != top.n_atoms:
                raise GroError(
                    f"{fn}:{lineno}: frame {len(frames)} has {natoms} atoms,"
                    f" first frame had {top.n_atoms}"
                )
            first = top is None
            names: List[str] = []
            res_seqs: List[int] = []
            res_names: List[str] = []
            xyz = np.empty((natoms, 3))
            for i in range(natoms):
                line = fp.readline()
                lineno += 1
                if len(line) < 21:
                    raise GroError(
                        f"{fn}:{lineno}: truncated atom line (frame "
                        f"{len(frames)}, atom {i + 1}/{natoms})"
                    )
                if first:
                    try:
                        res_seqs.append(int(line[0:5]))
                    except ValueError:
                        raise GroError(
                            f"{fn}:{lineno}: bad residue number "
                            f"{line[0:5]!r}"
                        )
                    res_names.append(line[5:10].strip())
                    names.append(line[10:15].strip())
                xyz[i] = _parse_floats(line[20:], fn, lineno)[:3]
            box_line = fp.readline()
            lineno += 1
            if not box_line.strip():
                raise GroError(
                    f"{fn}:{lineno}: missing box line after frame "
                    f"{len(frames)}"
                )
            boxes.append(_parse_box(box_line, fn, lineno))
            if first:
                top = Topology(
                    atom_names=names,
                    res_seqs=np.array(res_seqs, dtype=int),
                    res_names=res_names,
                    chain_ids=[""] * natoms,
                    occupancies=np.ones(natoms),
                    elements=[_guess_element(n) for n in names],
                )
            m = _TIME_RE.search(title)
            times.append(float(m.group(1)) if m else None)
            frames.append(xyz)
    if top is None:
        raise GroError(f"{fn}: no frames")
    if all(t is None for t in times):
        out_times = None
    else:
        out_times = np.array(
            [float(i) if t is None else t for i, t in enumerate(times)]
        )
    return top, np.stack(frames), np.stack(boxes), out_times


def write_gro(
    fn: str,
    top: Topology,
    xyz: np.ndarray,
    boxes: Optional[np.ndarray] = None,
    times: Optional[np.ndarray] = None,
    title: str = "written by spinrelax_tpu",
    append: bool = False,
):
    """Write (nFrames, nAtoms, 3) nm coordinates as a (multi-frame) .gro.

    Residue/atom numbers wrap at 100000 (the format's %5d fields, same
    convention GROMACS uses for large systems).  ``append=True`` adds
    frames to an existing file (concatenated frames are the format's
    trajectory convention)."""
    xyz = np.asarray(xyz)
    if xyz.ndim == 2:
        xyz = xyz[None]
    if xyz.ndim != 3 or xyz.shape[2] != 3:
        raise ValueError(f"xyz must be (nFrames, nAtoms, 3), got {xyz.shape}")
    if xyz.shape[1] != top.n_atoms:
        raise ValueError(
            f"xyz has {xyz.shape[1]} atoms, topology has {top.n_atoms}"
        )
    if xyz.size and (xyz.min() <= -1000.0 or xyz.max() >= 10000.0):
        # -1000.000 needs 9 characters: the %8.3f field overflows and
        # every later column shifts — readers then misparse silently.
        raise ValueError(
            f"{fn}: coordinates outside the .gro %8.3f field "
            f"(-1000, 10000) nm: [{xyz.min():g}, {xyz.max():g}]"
        )
    if boxes is not None:
        boxes = np.asarray(boxes)
        if boxes.ndim == 2:
            boxes = np.broadcast_to(boxes, (xyz.shape[0], 3, 3))
    with topen(fn, "a" if append else "w") as fp:
        for m in range(xyz.shape[0]):
            t = f" t= {float(times[m]):.5f}" if times is not None else ""
            print(f"{title}{t}", file=fp)
            print(f"{top.n_atoms:5d}", file=fp)
            for i in range(top.n_atoms):
                x, y, z = xyz[m, i]
                print(
                    "%5d%-5s%5s%5d%8.3f%8.3f%8.3f"
                    % (
                        int(top.res_seqs[i]) % 100000,
                        top.res_names[i][:5],
                        top.atom_names[i][:5],
                        (i + 1) % 100000,
                        x,
                        y,
                        z,
                    ),
                    file=fp,
                )
            b = boxes[m] if boxes is not None else np.zeros((3, 3))
            off = (b[0, 1], b[0, 2], b[1, 0], b[1, 2], b[2, 0], b[2, 1])
            vals = [b[0, 0], b[1, 1], b[2, 2]]
            if any(v != 0.0 for v in off):
                vals += list(off)
            print(" ".join("%10.5f" % v for v in vals), file=fp)
