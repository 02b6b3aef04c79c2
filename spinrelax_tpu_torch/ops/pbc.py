"""Periodic-boundary repair for solute trajectories: a native trjconv on a
torch device (port of ``spinrelax_tpu/ops/pbc.py``).

The reference delegates PBC handling to a 3-stage GROMACS trjconv
pipeline (center-solute-gromacs.bash:70-80):

    stage 1:  trjconv -pbc mol     -ur compact            (make whole)
    stage 2:  trjconv -pbc cluster -ur compact -center    (gather solute)
    stage 3:  trjconv -pbc mol     -ur compact            (re-pack water)

Molecules are inferred from the topology (each water/ion residue is its
own molecule; every other (chain, contiguous-residue) run is one
molecule), made whole by chaining minimum-image displacements along the
atom order, clustered with the greedy closest-image-to-cluster-centre
growth of ``-pbc cluster``, and compacted so every molecule's centre sits
in the unit cell around the box centre.  Orthorhombic cells only.

:func:`center_solute` repairs frames in batches on ``device`` (the card
unless the caller asks for the CPU), every stage vectorised over the
frames of a batch.  Two runs on the card give the same bits: the
molecule sums are segmented sums over the molecules' contiguous atom
runs (``torch.segment_reduce``, one fixed order, no atomics), and the
make-whole chain sums whole-box counts, which are integers and so exact
in any order.

Every "centre" is the UNWEIGHTED geometric mean of the atoms involved (the
JAX package's documented deviation from GROMACS's mass-weighted centres;
the repaired trajectories agree up to a rigid whole-box translation).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import checked_device

# Residue names treated as solvent/ions when no explicit selection is
# given -- the script's `not group "Water_and_ions"` default
# (center-solute-gromacs.bash:65).
WATER_ION_RESNAMES = frozenset(
    {"SOL", "HOH", "WAT", "TIP3", "TIP4", "TIP5", "SPC", "SPCE", "OPC",
     "T3P", "T4P", "MW",
     # element-style ion names (GROMACS/AMBER)
     "NA", "CL", "K", "MG", "ZN", "CA", "CA2", "NA+", "CL-", "K+", "BR",
     "CS", "LI", "RB", "F", "IOD",
     # CHARMM ion residue names (toppar convention)
     "SOD", "CLA", "POT", "CES", "LIT", "CAL", "BAR", "RUB", "ZN2", "CD2"}
)


def unwrap_and_center(xyz, box):
    """Make a molecule whole across orthorhombic PBC and centre it.

    xyz : (nFrames, nAtoms, 3) tensor [nm].
    box : (3,) or (nFrames, 3) orthorhombic box lengths [nm].

    Each atom is shifted by whole box vectors to the periodic image
    closest to the first atom (sufficient for solutes smaller than half
    the box, the standard `-pbc mol` situation), then the geometric
    centre is moved to the origin.
    """
    box = torch.as_tensor(box, dtype=xyz.dtype, device=xyz.device)
    if box.ndim == 1:
        box = box[None, :]
    anchor = xyz[:, :1, :]
    disp = xyz - anchor
    disp = disp - torch.round(disp / box[:, None, :]) * box[:, None, :]
    whole = anchor + disp
    return whole - whole.mean(dim=1, keepdim=True)


def minimum_image_distance(a, b, box):
    """Minimum-image distance vectors a-b under orthorhombic PBC."""
    d = a - b
    box = torch.as_tensor(box, dtype=d.dtype, device=d.device)
    return d - torch.round(d / box) * box


# ---------------------------------------------------------------------------
# Molecule inference from a topology (host-side numpy, as in the JAX package)
# ---------------------------------------------------------------------------

def molecule_ids(top, water_ion_resnames=WATER_ION_RESNAMES):
    """(nAtoms,) int32 molecule index per atom.

    GROMACS knows molecules from the .tpr; a PDB carries no bond table,
    so we use the standard structural convention: every water/ion residue
    is its own molecule, and each (chain id, contiguous residue-number
    run) of non-solvent atoms is one molecule (a protein/nucleic chain).
    """
    n = top.n_atoms
    mol = np.zeros(n, dtype=np.int32)
    cur = 0
    for i in range(1, n):
        solv_prev = top.res_names[i - 1].upper() in water_ion_resnames
        solv_here = top.res_names[i].upper() in water_ion_resnames
        new_res = top.res_seqs[i] != top.res_seqs[i - 1]
        new_chain = top.chain_ids[i] != top.chain_ids[i - 1]
        res_jump = abs(int(top.res_seqs[i]) - int(top.res_seqs[i - 1])) > 1
        if (
            new_chain
            or solv_prev != solv_here
            or (solv_here and new_res)
            or (new_res and res_jump)
        ):
            cur += 1
        mol[i] = cur
    return mol


def apply_molecule_breaks(mol, top, break_resids):
    """Force new-molecule boundaries at the FIRST atom of each residue
    number in ``break_resids`` (a ligand numbered contiguously after a
    protein chain is otherwise fused with it -- molecule_ids has no bond
    table to know better).  Keeps ids monotonic contiguous runs.

    Break specs may be plain residue numbers (every matching residue-run
    start breaks -- beware same-numbered residues in other chains) or
    chain-qualified ``"A:200"`` strings.  Atoms that already start a
    molecule are left alone (a double increment would violate the
    contiguous-run invariant center_solute checks)."""
    mol = np.asarray(mol, dtype=np.int32).copy()
    res = np.asarray(top.res_seqs)
    chains = np.asarray(top.chain_ids)
    for b in break_resids:
        chain = None
        if isinstance(b, str) and ":" in b:
            chain, b = b.split(":", 1)
        sel = res == int(b)
        if chain is not None:
            sel &= chains == chain
        starts = np.flatnonzero(
            sel & np.concatenate([[True], res[1:] != res[:-1]])
        )
        for i in starts:
            if i > 0 and mol[i] == mol[i - 1]:
                mol[i:] += 1
    return mol


def solute_mask(top, water_ion_resnames=WATER_ION_RESNAMES):
    """(nAtoms,) bool -- everything that is not water/ions (the script's
    auto-generated "Solute" group, center-solute-gromacs.bash:62-67)."""
    return np.array(
        [rn.upper() not in water_ion_resnames for rn in top.res_names]
    )


# ---------------------------------------------------------------------------
# The three stages, each over a batch of frames (B, nAtoms, 3)
# ---------------------------------------------------------------------------

def _make_whole(xyz, box, mol_start, start_idx):
    """Chain minimum-image displacements along the atom order, restarting
    at each molecule's first atom: exact for connectivity that follows
    the atom order with bonds < box/2 (the `-pbc mol` contract).

    xyz : (B, nAtoms, 3); box : (B, 3); mol_start : (nAtoms,) bool, True
    at a molecule's first atom; start_idx : (nAtoms,) that first atom.
    The running sum is of whole-box counts, exact in any order; each
    molecule subtracts its start's value (a segmented restart).
    """
    d = torch.diff(xyz, dim=1, prepend=xyz[:, :1])
    steps = torch.round(d / box[:, None, :]).masked_fill(mol_start[None, :, None], 0.0)
    cum = torch.cumsum(-steps, dim=1)
    return xyz + (cum - cum[:, start_idx]) * box[:, None, :]


def _mol_centers(xyz, lengths, inv_count):
    """(B, nMol, 3) geometric centres: a segmented sum over each
    molecule's contiguous atom run, in one fixed order."""
    s = torch.segment_reduce(xyz.transpose(0, 1), "sum", lengths=lengths, axis=0)
    return s.transpose(0, 1) * inv_count[:, None]


def _compact(xyz, box, mol_id, lengths, inv_count, center):
    """Shift every (whole) molecule by whole boxes so its geometric
    centre lands in the compact cell around ``center`` (-ur compact for
    orthorhombic cells = nearest image of the molecule centre)."""
    com = _mol_centers(xyz, lengths, inv_count)
    b = box[:, None, :]
    shift = -torch.round((com - center[:, None, :]) / b) * b
    return xyz + shift[:, mol_id]


def _cluster(xyz, box, mol_id, lengths, inv_count, in_cluster, n_cluster: int):
    """`-pbc cluster`: greedy cluster growth (gmx trjconv's algorithm) --
    seed with the first clustered molecule, then repeatedly take the
    remaining cluster molecule whose minimum-image distance to the
    running cluster centre is smallest and place it at that image.
    A naive all-at-once fixpoint fails for e.g. a dimer straddling the
    boundary (both halves are already "nearest image" to their midpoint);
    greedy growth is what makes the solute contiguous.

    in_cluster : (nMol,) bool, the solute molecules (the script clusters
    the Solute group, center-solute-gromacs.bash:76); n_cluster : their
    count.  The n_cluster - 1 steps run as a host loop, each vectorised
    over the frames of the batch; each places one molecule, so every step
    has a candidate.
    """
    if n_cluster <= 1:
        return xyz
    com = _mol_centers(xyz, lengths, inv_count)  # (B, nMol, 3)
    n_b, n_mol = com.shape[:2]
    rows = torch.arange(n_b, device=xyz.device)
    b = box[:, None, :]
    big = torch.finfo(xyz.dtype).max
    seed = int(torch.argmax(in_cluster.to(torch.int8)))
    shifts = torch.zeros_like(com)
    placed = torch.zeros((n_b, n_mol), dtype=torch.bool, device=xyz.device)
    placed[:, seed] = True
    csum = com[:, seed].clone()
    cnt = 1.0
    for _ in range(n_cluster - 1):
        ccom = csum / cnt
        d = com - ccom[:, None, :]
        d_mi = d - torch.round(d / b) * b
        dist2 = torch.sum(d_mi * d_mi, dim=2)
        cand = in_cluster[None, :] & ~placed
        pick = torch.argmin(torch.where(cand, dist2, big), dim=1)  # first minimum
        picked = com[rows, pick]
        shift_row = -torch.round((picked - ccom) / box) * box
        shifts[rows, pick] = shift_row
        placed[rows, pick] = True
        csum = csum + picked + shift_row
        cnt = cnt + 1.0
    return xyz + shifts[:, mol_id]


def _center_solute_frames(xyz, box, mol_id, mol_start, start_idx, lengths, inv_count,
                          in_cluster, n_cluster, atom_sel_w):
    """All three stages for a batch of frames; xyz (B, nAtoms, 3), box
    (B, 3); atom_sel_w (nAtoms,) 1.0 for solute atoms (centring weight)."""
    center = 0.5 * box
    # Stage 1: -pbc mol -ur compact.
    x = _make_whole(xyz, box, mol_start, start_idx)
    x = _compact(x, box, mol_id, lengths, inv_count, center)
    # Stage 2: -pbc cluster -ur compact -center on the solute.
    x = _cluster(x, box, mol_id, lengths, inv_count, in_cluster, n_cluster)
    sol_c = torch.sum(x * atom_sel_w[:, None], dim=1) / torch.sum(atom_sel_w)
    x = x + (center - sol_c)[:, None, :]
    # Stage 3: -pbc mol -ur compact (re-pack solvent around solute).
    return _compact(x, box, mol_id, lengths, inv_count, center)


# ---------------------------------------------------------------------------
# Public entry point
# ---------------------------------------------------------------------------

def center_solute(xyz, box, top=None, mol_id=None, solute=None, batch: int = 256,
                  device="cuda"):
    """Native equivalent of center-solute-gromacs.bash: make molecules
    whole, cluster the solute across images, centre it in the box, and
    re-pack the solvent compactly.

    Parameters
    ----------
    xyz : (nFrames, nAtoms, 3) [nm], numpy; its dtype is kept.
    box : (3,) or (nFrames, 3) orthorhombic box lengths [nm].
    top : Topology -- used to infer ``mol_id`` and ``solute`` when they
        are not given explicitly.
    mol_id : (nAtoms,) int molecule index (contiguous runs).
    solute : (nAtoms,) bool solute-atom mask (default: not water/ions).
    batch : frames per device step (bounds the device working set).
    device : the card unless the caller asks for ``"cpu"``.

    Returns (nFrames, nAtoms, 3) repaired coordinates (numpy).
    """
    xyz = np.asarray(xyz)
    if xyz.ndim == 2:
        xyz = xyz[None]
    n_frames, n_atoms = xyz.shape[:2]
    box = np.asarray(box, dtype=xyz.dtype)
    if box.ndim == 1:
        box = np.broadcast_to(box, (n_frames, 3))
    if mol_id is None:
        if top is None:
            raise ValueError("need top= or mol_id=")
        mol_id = molecule_ids(top)
    mol_id = np.asarray(mol_id, dtype=np.int32)
    d = np.diff(mol_id)
    if np.any(d < 0) or np.any(d > 1):
        raise ValueError(
            "mol_id must be contiguous non-decreasing runs (0,0,1,1,2,...) "
            "-- the make-whole chain restarts at each molecule's first atom"
        )
    if solute is None:
        if top is not None:
            solute = solute_mask(top)
        else:
            solute = np.ones(n_atoms, dtype=bool)
    solute = np.asarray(solute, dtype=bool)
    if not solute.any():
        raise ValueError(
            "solute selection matches no atoms (centring would divide "
            "by zero) -- pass solute= or check the topology's residue names"
        )
    dev = checked_device(device)
    n_mol = int(mol_id.max()) + 1
    counts = np.bincount(mol_id, minlength=n_mol)
    # A molecule is in the cluster group when ANY of its atoms is solute.
    in_cluster = np.zeros(n_mol, dtype=bool)
    in_cluster[np.unique(mol_id[solute])] = True
    dtype = torch.from_numpy(xyz[:0]).dtype
    mol_start = np.concatenate([[True], mol_id[1:] != mol_id[:-1]])
    idx = torch.arange(n_atoms)
    start_idx = torch.cummax(torch.where(torch.from_numpy(mol_start), idx, 0), dim=0).values
    consts = dict(
        mol_id=torch.from_numpy(mol_id).long().to(dev),
        mol_start=torch.from_numpy(mol_start).to(dev),
        start_idx=start_idx.to(dev),
        lengths=torch.from_numpy(counts).long().to(dev),
        inv_count=torch.from_numpy((1.0 / counts).astype(xyz.dtype)).to(dev),
        in_cluster=torch.from_numpy(in_cluster).to(dev),
        n_cluster=int(in_cluster.sum()),
        atom_sel_w=torch.from_numpy(solute).to(device=dev, dtype=dtype),
    )
    out = np.empty_like(xyz)
    for off in range(0, n_frames, batch):
        sl = slice(off, min(off + batch, n_frames))
        x = torch.from_numpy(np.ascontiguousarray(xyz[sl])).to(dev)
        b = torch.from_numpy(np.ascontiguousarray(box[sl])).to(dev)
        torch.from_numpy(out[sl]).copy_(_center_solute_frames(x, b, **consts))
    return out
