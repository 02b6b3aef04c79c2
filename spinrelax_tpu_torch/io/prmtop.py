"""Amber prmtop/parm7 topology reading (host-side, clean-room).

Amber NetCDF trajectories (io/amber.py) pair with .prmtop topologies;
the reference's mdtraj ingest accepts that pairing
(calculate-Ct-from-traj.py:426-458, md.load(..., top=)).  Like PSF
(io/psf.py) a prmtop carries no coordinates but DOES carry the bond
table, so `spinrelax center` gets exact bond-graph molecules.

Format: ``%FLAG <NAME>`` sections, each with a ``%FORMAT(...)``
descriptor followed by fixed-width data lines.  Sections used:
POINTERS (NATOM/NRES), ATOM_NAME + RESIDUE_LABEL (20a4 — names can
contain spaces, so fields are sliced at the FORMAT width, not split),
RESIDUE_POINTER, MASS, BONDS_INC_HYDROGEN + BONDS_WITHOUT_HYDROGEN
(coordinate-array offsets: atom = value/3).

The port's copy of ``spinrelax_tpu/io/prmtop.py`` (host-side numpy; the same bytes).
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

import numpy as np

from .pdb import Topology
from .psf import _element_from_mass
from .zopen import topen


class PrmtopError(ValueError):
    pass


_FORMAT_RE = re.compile(r"%FORMAT\(\s*(\d*)\s*([aIEFed])\s*(\d+)", re.I)


def _parse_sections(fn: str) -> Dict[str, Tuple[str, int, List[str]]]:
    """-> {FLAG: (kind, field_width, data_lines)}."""
    sections: Dict[str, Tuple[str, int, List[str]]] = {}
    flag = None
    kind, width = "a", 4
    with topen(fn) as fp:
        first = fp.readline()
        if not first.startswith("%VERSION"):
            raise PrmtopError(f"{fn}: not a prmtop (missing %VERSION)")
        for raw in fp:
            if raw.startswith("%FLAG"):
                parts = raw.split()
                if len(parts) < 2:
                    raise PrmtopError(f"{fn}: malformed %FLAG line {raw!r}")
                flag = parts[1].upper()
                sections[flag] = ("a", 4, [])
            elif raw.startswith("%FORMAT"):
                m = _FORMAT_RE.match(raw.strip())
                if not m or flag is None:
                    continue
                kind = m.group(2).lower()
                width = int(m.group(3))
                sections[flag] = (kind, width, sections[flag][2])
            elif raw.startswith("%"):
                continue  # %COMMENT etc.
            elif flag is not None:
                sections[flag][2].append(raw.rstrip("\n"))
    return sections


def _fields(section, n: int, fn: str, flag: str) -> List[str]:
    kind, width, lines = section
    out: List[str] = []
    for line in lines:
        for off in range(0, len(line), width):
            piece = line[off : off + width]
            if piece.strip() or kind == "a":
                out.append(piece)
        if len(out) >= n and kind == "a":
            break
    if len(out) < n:
        raise PrmtopError(
            f"{fn}: %FLAG {flag} has {len(out)} entries, expected {n}"
        )
    return out[:n]


def read_prmtop(fn: str) -> Tuple[Topology, np.ndarray]:
    """Read an Amber prmtop -> (Topology, bonds (nBonds, 2) 0-based).

    Topology conventions: chain_ids '' (prmtop has none), occupancies
    1.0, elements from ATOMIC_NUMBER when present else per-atom mass."""
    sec = _parse_sections(fn)
    if "POINTERS" not in sec:
        raise PrmtopError(f"{fn}: no POINTERS section")
    pointers = [int(v) for v in " ".join(sec["POINTERS"][2]).split()]
    if len(pointers) < 13:
        raise PrmtopError(f"{fn}: POINTERS too short ({len(pointers)})")
    natom, nres = pointers[0], pointers[11]
    nbonh, nbona = pointers[2], pointers[3]
    for need in ("ATOM_NAME", "RESIDUE_LABEL", "RESIDUE_POINTER"):
        if need not in sec:
            raise PrmtopError(f"{fn}: no {need} section")
    names = [v.strip() for v in _fields(sec["ATOM_NAME"], natom, fn, "ATOM_NAME")]
    res_labels = [
        v.strip()
        for v in _fields(sec["RESIDUE_LABEL"], nres, fn, "RESIDUE_LABEL")
    ]
    res_ptr = [
        int(v)
        for v in _fields(sec["RESIDUE_POINTER"], nres, fn, "RESIDUE_POINTER")
    ]
    res_names: List[str] = [""] * natom
    res_seqs = np.zeros(natom, dtype=int)
    bounds = res_ptr + [natom + 1]
    for r in range(nres):
        lo, hi = bounds[r] - 1, bounds[r + 1] - 1
        if not (0 <= lo <= hi <= natom):
            raise PrmtopError(
                f"{fn}: RESIDUE_POINTER {res_ptr[r]} outside 1..{natom}"
            )
        for i in range(lo, hi):
            res_names[i] = res_labels[r]
            res_seqs[i] = r + 1
    if "ATOMIC_NUMBER" in sec:
        znum = [
            int(v) for v in _fields(sec["ATOMIC_NUMBER"], natom, fn, "ATOMIC_NUMBER")
        ]
        _SYM = {1: "H", 6: "C", 7: "N", 8: "O", 9: "F", 11: "NA", 12: "MG",
                15: "P", 16: "S", 17: "CL", 19: "K", 20: "CA", 26: "FE",
                30: "ZN", 35: "BR", 53: "I"}
        elements = [_SYM.get(z, "") for z in znum]
    elif "MASS" in sec:
        masses = [
            float(v) for v in _fields(sec["MASS"], natom, fn, "MASS")
        ]
        elements = [_element_from_mass(m) for m in masses]
    else:
        elements = [""] * natom
    bonds: List[Tuple[int, int]] = []
    for flag, count in (
        ("BONDS_INC_HYDROGEN", nbonh), ("BONDS_WITHOUT_HYDROGEN", nbona)
    ):
        if flag not in sec or count == 0:
            continue
        vals = [int(v) for v in _fields(sec[flag], 3 * count, fn, flag)]
        for k in range(count):
            a3, b3 = vals[3 * k], vals[3 * k + 1]
            if a3 % 3 or b3 % 3:
                raise PrmtopError(
                    f"{fn}: {flag} entry not a coordinate offset "
                    f"({a3}, {b3})"
                )
            a, b = a3 // 3, b3 // 3
            if not (0 <= a < natom and 0 <= b < natom):
                raise PrmtopError(
                    f"{fn}: {flag} atom index outside 0..{natom - 1}"
                )
            bonds.append((a, b))
    top = Topology(
        atom_names=names,
        res_seqs=res_seqs,
        res_names=res_names,
        chain_ids=[""] * natom,
        occupancies=np.ones(natom),
        elements=elements,
    )
    return top, np.array(bonds, dtype=int).reshape(-1, 2)
