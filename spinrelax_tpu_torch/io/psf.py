"""CHARMM/NAMD/X-PLOR PSF topology reading (host-side, clean-room).

DCD trajectories (io/dcd.py) pair with .psf topologies in CHARMM/NAMD
deployments; the reference's mdtraj ingest accepts that pairing
(calculate-Ct-from-traj.py:426-458, md.load(..., top=)).  A PSF carries
no coordinates — it serves the selection / molecule-inference surfaces
(`spinrelax center` / `convert`) — but unlike PDB/GRO it DOES carry the
bond table, so molecule decomposition is exact (bond-graph connected
components) instead of the residue-contiguity heuristic
(ops/pbc.molecule_ids).

Parsed sections: the PSF flags line, !NATOM (required), !NBOND
(optional; other sections are skipped).  Standard, EXT, CHEQ and
XPLOR/NAMD variants all parse — fields are whitespace-delimited in
every variant CHARMM/NAMD emit.

The port's copy of ``spinrelax_tpu/io/psf.py`` (host-side numpy; the same bytes).
"""

from __future__ import annotations

import re
from typing import List, Tuple

import numpy as np

from .pdb import Topology
from .zopen import topen


class PsfError(ValueError):
    pass


_SECTION_RE = re.compile(r"^\s*(\d+)\s+!(\w+)")

# Nearest-mass element guess (PSF stores per-atom masses; names/types are
# force-field labels, not elements).  Only consumed by write_pdb.
_MASSES = [
    (1.008, "H"), (12.011, "C"), (14.007, "N"), (15.999, "O"),
    (18.998, "F"), (22.990, "NA"), (24.305, "MG"), (30.974, "P"),
    (32.06, "S"), (35.45, "CL"), (39.098, "K"), (40.078, "CA"),
    (55.845, "FE"), (65.38, "ZN"), (79.904, "BR"), (126.904, "I"),
]


def _element_from_mass(mass: float) -> str:
    if mass <= 0:
        return ""
    return min(_MASSES, key=lambda t: abs(t[0] - mass))[1]


def _resid_int(tok: str) -> int:
    """CHARMM resids may carry insertion codes ('45A'); keep the number."""
    m = re.match(r"^(-?\d+)", tok)
    if not m:
        raise ValueError(tok)
    return int(m.group(1))


def read_psf(fn: str) -> Tuple[Topology, np.ndarray]:
    """Read a PSF -> (Topology, bonds (nBonds, 2) 0-based int array).

    Topology conventions: chain_ids = segment names, occupancies 1.0
    (so 'occupancy > 0' selections keep every atom), elements guessed
    from the per-atom masses."""
    with topen(fn) as fp:
        first = fp.readline()
        if "PSF" not in first.upper():
            raise PsfError(f"{fn}: not a PSF file (missing PSF header)")
        names: List[str] = []
        res_seqs: List[int] = []
        res_names: List[str] = []
        segs: List[str] = []
        elements: List[str] = []
        bonds: List[int] = []
        natom = None
        nbond = 0
        line = fp.readline()
        while line:
            m = _SECTION_RE.match(line)
            if not m:
                line = fp.readline()
                continue
            count, section = int(m.group(1)), m.group(2).upper()
            if section.startswith("NATOM"):
                natom = count
                for i in range(count):
                    row = fp.readline()
                    tok = row.split()
                    if len(tok) < 8:
                        raise PsfError(
                            f"{fn}: atom line {i + 1}/{count} has "
                            f"{len(tok)} fields (expected >= 8): {row!r}"
                        )
                    segs.append(tok[1])
                    try:
                        res_seqs.append(_resid_int(tok[2]))
                    except ValueError:
                        raise PsfError(
                            f"{fn}: unparseable resid {tok[2]!r} on atom "
                            f"line {i + 1}"
                        )
                    res_names.append(tok[3])
                    names.append(tok[4])
                    try:
                        mass = float(tok[7])
                    except ValueError:
                        raise PsfError(
                            f"{fn}: unparseable mass {tok[7]!r} on atom "
                            f"line {i + 1}"
                        )
                    elements.append(_element_from_mass(mass))
            elif section.startswith("NBOND"):
                nbond = count
                while len(bonds) < 2 * count:
                    row = fp.readline()
                    if not row:
                        raise PsfError(
                            f"{fn}: !NBOND section truncated "
                            f"({len(bonds) // 2}/{count} bonds)"
                        )
                    for tok in row.split():
                        try:
                            bonds.append(int(tok))
                        except ValueError:
                            raise PsfError(
                                f"{fn}: non-integer bond index {tok!r}"
                            )
            line = fp.readline()
    if natom is None:
        raise PsfError(f"{fn}: no !NATOM section")
    top = Topology(
        atom_names=names,
        res_seqs=np.array(res_seqs, dtype=int),
        res_names=res_names,
        chain_ids=segs,
        occupancies=np.ones(natom),
        elements=elements,
    )
    barr = np.array(bonds, dtype=int).reshape(-1, 2)
    if barr.size:
        if barr.min() < 1 or barr.max() > natom:
            raise PsfError(
                f"{fn}: bond index outside 1..{natom} "
                f"(found {barr.min()}..{barr.max()})"
            )
        barr = barr - 1  # PSF is 1-based
    if nbond and barr.shape[0] != nbond:
        raise PsfError(f"{fn}: expected {nbond} bonds, got {barr.shape[0]}")
    return top, barr


def molecule_ids_from_bonds(n_atoms: int, bonds: np.ndarray) -> np.ndarray:
    """Exact molecule decomposition: connected components of the bond
    graph, relabelled in file order (first atom appearance).  PSF files
    list each molecule's atoms contiguously, which is also what the
    centring kernels require (ops/pbc.center_solute's contiguous-run
    check) — interleaved components error loudly."""
    parent = np.arange(n_atoms)

    def find(i):
        root = i
        while parent[root] != root:
            root = parent[root]
        while parent[i] != root:  # path compression
            parent[i], i = root, parent[i]
        return root

    for a, b in np.asarray(bonds, dtype=int):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)
    roots = np.array([find(i) for i in range(n_atoms)])
    # Union-by-min makes each component's root its smallest atom index,
    # so unique's sorted labels ARE first-appearance order.
    _, mol = np.unique(roots, return_inverse=True)
    mol = mol.astype(np.int32)
    if np.any(np.diff(mol) < 0) or np.any(np.diff(mol) > 1):
        raise PsfError(
            "bond-graph molecules are interleaved in atom order; the "
            "centring kernels need each molecule's atoms contiguous"
        )
    return mol
