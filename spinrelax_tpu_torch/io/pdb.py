"""Minimal PDB reading/writing + atom selection.

Host-side ingest replacing the reference's mdtraj dependency for the
structure-handling it actually uses (calculate-Ct-from-traj.py:283-294,
405-471): load coordinates (multi-MODEL for trajectories), select H/N
atoms by name/residue, read occupancy flags for fit-atom selection, and
write rotated structures (rotate-coordinate-file.py).

Coordinates are returned in nanometres (mdtraj convention, so all
downstream defaults carry over).
"""

from __future__ import annotations

import dataclasses
import re
import warnings
from typing import List, Tuple

import numpy as np

from .zopen import fmt_name, topen


@dataclasses.dataclass
class Topology:
    atom_names: List[str]
    res_seqs: np.ndarray  # (nAtoms,) int
    res_names: List[str]
    chain_ids: List[str]
    occupancies: np.ndarray  # (nAtoms,)
    elements: List[str]

    @property
    def n_atoms(self) -> int:
        return len(self.atom_names)

    @property
    def res_indices(self) -> np.ndarray:
        """0-based internal residue index per atom (mdtraj's ``resid``):
        increments whenever (chain, resSeq, resName) changes along the
        file order — distinct from the author-assigned ``resSeq``."""
        idx = np.empty(self.n_atoms, dtype=int)
        cur, prev = -1, None
        for i in range(self.n_atoms):
            key = (self.chain_ids[i], int(self.res_seqs[i]), self.res_names[i])
            if key != prev:
                cur += 1
                prev = key
            idx[i] = cur
        return idx

    def select(self, expr: str) -> np.ndarray:
        """A small selection language covering the reference's usage:
        - 'name H', 'name N', 'name CA' (multiple names allowed)
        - 'not resname PRO'
        - 'occupancy > 0'
        - conjunctions with 'and'
        Examples: 'name N and not resname PRO', 'name CA and occupancy > 0'.
        """
        mask = np.ones(self.n_atoms, dtype=bool)
        # Split on 'and' at the top level.
        for clause in re.split(r"\band\b", expr):
            clause = clause.strip()
            if not clause:
                continue
            neg = False
            if clause.startswith("not "):
                neg = True
                clause = clause[4:].strip()
            if clause.startswith("name "):
                names = clause.split()[1:]
                m = np.array([a in names for a in self.atom_names])
            elif clause.startswith("resname "):
                rn = clause.split()[1:]
                m = np.array([r in rn for r in self.res_names])
            elif clause.startswith("occupancy"):
                mt = re.match(r"occupancy\s*(>|>=|<|<=|==)\s*([\d.eE+-]+)", clause)
                if not mt:
                    raise ValueError(f"cannot parse occupancy clause: {clause!r}")
                op, val = mt.group(1), float(mt.group(2))
                ops = {
                    ">": np.greater,
                    ">=": np.greater_equal,
                    "<": np.less,
                    "<=": np.less_equal,
                    "==": np.equal,
                }
                m = ops[op](self.occupancies, val)
            elif clause.startswith("resSeq") or clause.startswith("resid"):
                mt = re.match(r"(resSeq|resid)\s+(\d+)(?:\s+to\s+(\d+))?", clause)
                if not mt:
                    raise ValueError(f"cannot parse residue clause: {clause!r}")
                lo = int(mt.group(2))
                hi = int(mt.group(3)) if mt.group(3) else lo
                # mdtraj semantics, which reference selection strings
                # are written in (calculate-Ct-from-traj.py:34-51):
                # 'resid' is the 0-BASED internal residue index,
                # 'resSeq' the author-assigned PDB number.  Mapping both
                # to resSeq silently shifted migrated 'resid i to j'
                # selections by the numbering offset.
                vals = self.res_indices if mt.group(1) == "resid" else self.res_seqs
                m = (vals >= lo) & (vals <= hi)
            elif clause == "all":
                m = np.ones(self.n_atoms, dtype=bool)
            else:
                raise ValueError(f"unsupported selection clause: {clause!r}")
            mask &= ~m if neg else m
        return np.where(mask)[0]


def read_pdb(fn: str) -> Tuple[Topology, np.ndarray]:
    """Read a PDB file -> (Topology, xyz (nModels, nAtoms, 3) in nm)."""
    atom_names: List[str] = []
    res_seqs: List[int] = []
    res_names: List[str] = []
    chain_ids: List[str] = []
    occs: List[float] = []
    elements: List[str] = []
    models: List[List[Tuple[float, float, float]]] = []
    cur: List[Tuple[float, float, float]] = []
    first_model = True
    with topen(fn) as fp:
        for line in fp:
            rec = line[:6]
            if rec in ("ATOM  ", "HETATM"):
                x = float(line[30:38]) / 10.0
                y = float(line[38:46]) / 10.0
                z = float(line[46:54]) / 10.0
                cur.append((x, y, z))
                if first_model:
                    atom_names.append(line[12:16].strip())
                    # Columns 18-21: the PDB spec uses 3 characters, but
                    # CHARMM/VMD write 4 (TIP3, TIP4, ...) — truncating
                    # to 3 would misclassify those waters as solute in
                    # ops/pbc.solute_mask.
                    res_names.append(line[17:21].strip())
                    chain_ids.append(line[21].strip())
                    res_seqs.append(int(line[22:26]))
                    occ = line[54:60].strip()
                    occs.append(float(occ) if occ else 1.0)
                    elements.append(line[76:78].strip())
            elif rec.startswith("ENDMDL"):
                if cur:
                    models.append(cur)
                    cur = []
                    first_model = False
    if cur:
        models.append(cur)
    top = Topology(
        atom_names=atom_names,
        res_seqs=np.array(res_seqs, dtype=int),
        res_names=res_names,
        chain_ids=chain_ids,
        occupancies=np.array(occs),
        elements=elements,
    )
    if not models or top.n_atoms == 0:
        raise ValueError(f"{fn}: no ATOM records found")
    if any(len(m) != len(models[0]) for m in models):
        # np.array would raise an opaque "inhomogeneous shape" first.
        raise ValueError(f"{fn}: inconsistent atom counts across MODELs")
    xyz = np.array(models)
    if xyz.shape[1] != top.n_atoms:
        raise ValueError(f"{fn}: inconsistent atom counts across MODELs")
    return top, xyz


def write_pdb(fn: str, top: Topology, xyz: np.ndarray):
    """Write (nModels, nAtoms, 3) nm coordinates as a (multi-)MODEL PDB."""
    xyz = np.asarray(xyz)
    if xyz.ndim == 2:
        xyz = xyz[None]
    # The fixed-column format cannot represent these: an overflowing %4d
    # resSeq (or %5d serial) shifts every later column, and read_pdb's
    # fixed-offset parse then crashes — or silently mis-parses
    # coordinates.  Fail loudly instead; callers with >9999 residues
    # must split chains (bond pairing is (chain, resSeq)-keyed).
    rs = np.asarray(top.res_seqs)
    if rs.size and (rs.max() > 9999 or rs.min() < -999):
        raise ValueError(
            f"{fn}: resSeq outside the PDB %4d field "
            f"[{rs.min()}, {rs.max()}] — split into chains"
        )
    if top.n_atoms > 99999:
        raise ValueError(
            f"{fn}: {top.n_atoms} atoms overflow the PDB %5d serial field"
        )
    multi = xyz.shape[0] > 1
    with topen(fn, "w") as fp:
        for m in range(xyz.shape[0]):
            if multi:
                print("MODEL     %4d" % (m + 1), file=fp)
            for i in range(top.n_atoms):
                x, y, z = xyz[m, i] * 10.0
                name = top.atom_names[i]
                pname = f" {name:<3s}" if len(name) < 4 else name
                # %-4s keeps 4-character residue names (CHARMM TIP3
                # etc.) in columns 18-21 — truncating to 3 would undo
                # read_pdb's preservation and misclassify round-tripped
                # waters as solute; 3-char names render identically.
                print(
                    "ATOM  %5d %4s %-4s%1s%4d    %8.3f%8.3f%8.3f%6.2f%6.2f          %2s"
                    % (
                        i + 1,
                        pname,
                        top.res_names[i][:4],
                        top.chain_ids[i] or "A",
                        top.res_seqs[i],
                        x,
                        y,
                        z,
                        top.occupancies[i],
                        0.0,
                        top.elements[i],
                    ),
                    file=fp,
                )
            if multi:
                print("ENDMDL", file=fp)
        print("END", file=fp)


def read_structure(fn: str) -> Tuple[Topology, np.ndarray]:
    """Read a structure/topology file -> (Topology, xyz (nModels, nAtoms,
    3) nm).  Dispatches on extension: .gro (io.gro) or PDB (default) —
    every CLI surface that takes a reference/topology structure accepts
    both (the reference's GROMACS deployments produce either,
    create-reference-pdb.bash:63)."""
    if fmt_name(fn).endswith(".gro"):
        from . import gro

        top, xyz, _boxes, _times = gro.read_gro(fn)
        return top, xyz
    if fmt_name(fn).endswith((".psf", ".prmtop", ".parm7")):
        raise ValueError(
            f"{fn}: this topology format carries no coordinates — pass a "
            ".pdb/.gro here (PSF/prmtop topologies work where only atom "
            "metadata is needed: spinrelax center/convert)"
        )
    return read_pdb(fn)


def read_topology(fn: str) -> Topology:
    """Read just the Topology from any structure/topology format:
    .psf (coordinate-less CHARMM/NAMD topology, io.psf), .gro, or PDB.
    For surfaces that also need coordinates use read_structure (which
    rejects .psf with a clear message)."""
    if fmt_name(fn).endswith(".psf"):
        from . import psf

        top, _bonds = psf.read_psf(fn)
        return top
    if fmt_name(fn).endswith((".prmtop", ".parm7")):
        from . import prmtop

        top, _bonds = prmtop.read_prmtop(fn)
        return top
    return read_structure(fn)[0]


def write_structure(fn: str, top: Topology, xyz: np.ndarray):
    """Write a structure file, dispatching on extension (.gro or PDB)."""
    if fmt_name(fn).endswith(".gro"):
        from . import gro

        gro.write_gro(fn, top, xyz)
    else:
        write_pdb(fn, top, xyz)


def bond_indices(
    top: Topology,
    h_sel: str = "name H",
    x_sel: str = "name N and not resname PRO",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Paired H/X atom indices + residue numbers, with the reference's
    consistency check that both selections cover the same residues
    (confirm_mdtraj_seltxt, spectral_densities.py:2354-2382)."""
    idx_h = top.select(h_sel)
    idx_x = top.select(x_sel)
    res_h = top.res_seqs[idx_h]
    res_x = top.res_seqs[idx_x]
    if len(idx_h) == 0 or len(idx_x) == 0:
        raise ValueError(
            f"selection found no atoms: H({h_sel!r})={len(idx_h)}, "
            f"X({x_sel!r})={len(idx_x)}"
        )
    # Key the repair on (chain, resSeq), not resSeq alone: duplicate
    # residue numbers in different chains must not silently pair an H
    # from one chain with an X from another (the reference hard-exits on
    # any mismatch, spectral_densities.py:2354-2382 — repairing is our
    # extension, so it has to be unambiguous).
    chains = np.asarray(top.chain_ids)
    key_h = np.array([f"{c}|{r}" for c, r in zip(chains[idx_h], res_h)])
    key_x = np.array([f"{c}|{r}" for c, r in zip(chains[idx_x], res_x)])
    if not np.array_equal(key_h, key_x):
        common = np.intersect1d(key_h, key_x)
        idx_h = idx_h[np.isin(key_h, common)]
        idx_x = idx_x[np.isin(key_x, common)]
        key_h, key_x = key_h[np.isin(key_h, common)], key_x[np.isin(key_x, common)]
        res_h = top.res_seqs[idx_h]
        if not np.array_equal(key_h, key_x):
            raise ValueError("H and X selections cover different residues")
    if len(np.unique(res_h)) != len(res_h):
        # The stage artefacts key rows by resSeq alone (reference wire
        # format, e.g. '# Residue: N' in fittedCt) — duplicate numbers
        # across chains pair fine here (keys above are chain-aware) but
        # collide in every downstream by-residue lookup.
        warnings.warn(
            "duplicate residue numbers across chains: downstream "
            "artefacts key rows by resSeq alone and will be ambiguous "
            "(renumber chains or select one chain, e.g. 'resid i to j')"
        )
    return idx_h, idx_x, res_h
