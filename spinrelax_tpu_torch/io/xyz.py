"""XMol/XYZ trajectory I/O.

The reference ingests trajectories through mdtraj, whose format table
includes multi-frame ``.xyz`` (calculate-Ct-from-traj.py:426-453 via
``md.load``) — the interchange format Tinker/ORCA/VMD and most QM codes
emit.  Grammar per frame::

    <natoms>
    <comment line>
    <element>  <x> <y> <z>      (natoms rows, coordinates in Angstrom)

Disk coordinates are Angstrom by the format's convention (mdtraj's
XYZTrajectoryFile makes the same assumption); in memory everything is nm
like the rest of the package.  No box or time metadata exists in the
format — callers pass the timestep explicitly (same contract as .mdcrd).

Reads are gzip-transparent (io.zopen).

The port's copy of ``spinrelax_tpu/io/xyz.py`` (host-side numpy; the same bytes).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from .zopen import topen


class XyzError(ValueError):
    pass


def read_xyz(fn: str) -> Tuple[List[str], np.ndarray]:
    """-> (elements (nAtoms), xyz (nFrames, nAtoms, 3) nm)."""
    elements: List[str] = []
    rows: List[List[str]] = []  # coordinate token triples, all frames
    n_frames = 0
    with topen(fn) as fp:
        while True:
            head = fp.readline()
            if not head:
                break  # clean EOF at a frame boundary
            head = head.strip()
            if not head:
                continue  # blank separator lines between frames
            try:
                natoms = int(head)
            except ValueError:
                raise XyzError(
                    f"{fn}: frame {n_frames}: expected an atom count "
                    f"line, got {head[:40]!r}"
                )
            if natoms <= 0:
                raise XyzError(
                    f"{fn}: frame {n_frames}: non-positive atom count "
                    f"{natoms}"
                )
            if elements and natoms != len(elements):
                raise XyzError(
                    f"{fn}: frame {n_frames} has {natoms} atoms, "
                    f"frame 0 had {len(elements)}"
                )
            fp.readline()  # comment line (may be empty)
            frame_el: List[str] = []
            for i in range(natoms):
                line = fp.readline()
                parts = line.split()
                if len(parts) < 4:
                    raise XyzError(
                        f"{fn}: frame {n_frames}: truncated at atom "
                        f"{i}/{natoms}"
                    )
                frame_el.append(parts[0])
                rows.append(parts[1:4])
            if not elements:
                elements = frame_el
            elif frame_el != elements:
                raise XyzError(
                    f"{fn}: frame {n_frames}: element column changed "
                    "mid-file"
                )
            n_frames += 1
    if n_frames == 0:
        raise XyzError(f"{fn}: no frames found")
    try:
        flat = np.asarray(rows, dtype=np.float64)
    except ValueError:
        raise XyzError(f"{fn}: non-numeric coordinate field")
    xyz = flat.reshape(n_frames, len(elements), 3) / 10.0  # A -> nm
    return elements, xyz


def write_xyz(
    fn: str,
    xyz: np.ndarray,
    elements: Optional[Sequence[str]] = None,
    comments: Optional[Sequence[str]] = None,
    append: bool = False,
):
    """Write (nFrames, nAtoms, 3) nm coordinates as multi-frame XYZ
    (Angstrom on disk).  ``elements`` defaults to ``X``; ``append=True``
    adds frames to an existing file (chunked == single write since the
    format is purely per-frame)."""
    xyz = np.asarray(xyz, dtype=np.float64)
    if xyz.ndim == 2:
        xyz = xyz[None]
    n_frames, n_atoms, _ = xyz.shape
    if elements is None:
        elements = ["X"] * n_atoms
    if len(elements) != n_atoms:
        raise XyzError(
            f"{fn}: {len(elements)} elements for {n_atoms} atoms"
        )
    # Empty/whitespace element strings (blank PDB cols 77-78, unguessable
    # .gro names) would render a 3-token row no XYZ reader accepts —
    # substitute the same 'X' placeholder the elements=None default uses.
    elements = [
        e if (e := str(el).strip()) else "X" for el in elements
    ]
    ang = xyz * 10.0
    with topen(fn, "a" if append else "w") as fp:
        for f in range(n_frames):
            comment = (
                comments[f]
                if comments is not None and f < len(comments)
                else f"frame {f}"
            )
            fp.write(f"{n_atoms}\n{comment}\n")
            frame = ang[f]
            for i in range(n_atoms):
                fp.write(
                    "%-4s %14.8f %14.8f %14.8f\n"
                    % (elements[i], frame[i, 0], frame[i, 1], frame[i, 2])
                )
