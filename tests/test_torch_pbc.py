"""The port's PBC repair (spinrelax_tpu_torch.ops.pbc) against
spinrelax_tpu.ops.pbc on the CPU, on the same seeded wrapped systems.

Tolerances: float64 (JAX under x64) 1e-12 nm -- the same three stages in
the same dtype, differing only in summation order (the port sums whole-box
counts before scaling by the box, JAX sums the scaled steps).  float32
1e-5 nm -- a few float32 ulps of coordinates up to ~10 nm.  The topology
helpers (numpy in both packages) are equal.
"""

import os

import jax
import numpy as np
import pytest
import torch

from spinrelax_tpu.io import psf as jpsf
from spinrelax_tpu.io.pdb import Topology as JTopology
from spinrelax_tpu.ops import pbc as jpbc
from spinrelax_tpu_torch.io import psf as tpsf
from spinrelax_tpu_torch.io.pdb import Topology
from spinrelax_tpu_torch.ops import pbc as tpbc


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_state():
    """Clear jax's compiled-program caches before this module (see
    tests/test_review_fixes_r3.py); two torch threads per xdist worker."""
    jax.clear_caches()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(2)


def _top(names, seqs, resn, chains, cls=Topology):
    n = len(names)
    return cls(atom_names=list(names), res_seqs=np.asarray(seqs), res_names=list(resn),
               chain_ids=list(chains), occupancies=np.ones(n), elements=[""] * n)


def _both(top):
    return top, _top(top.atom_names, top.res_seqs, top.res_names, top.chain_ids, JTopology)


def one_chain(rng, n_frames=12):
    """A 40-atom chain random-walking over several images with 30 waters
    and an ion, wrapped into a 3.2 nm box frame by frame."""
    box = np.array([3.2, 3.2, 3.2])
    chain = np.cumsum(rng.normal(scale=0.1, size=(40, 3)), axis=0)
    xyz = chain[None] + 0.02 * rng.normal(size=(n_frames, 40, 3))
    drift = np.cumsum(rng.normal(scale=0.4, size=(n_frames, 1, 3)), axis=0)
    o = rng.uniform(0, 3.2, (n_frames, 30, 1, 3))
    wat = (o + np.array([[0, 0, 0], [0.08, 0.02, 0], [0, 0.08, 0.02]])).reshape(n_frames, 90, 3)
    ion = rng.uniform(0, 3.2, (n_frames, 1, 3))
    raw = np.mod(np.concatenate([xyz + drift + 1.6, wat, ion], axis=1), box)
    top = _top(["CA"] * 40 + ["OW", "HW1", "HW2"] * 30 + ["NA"],
               np.concatenate([np.arange(1, 41), np.repeat(np.arange(100, 130), 3), [500]]),
               ["ALA"] * 40 + ["SOL"] * 90 + ["NA"], ["A"] * 40 + ["W"] * 90 + ["I"])
    return top, raw, box


def dimer(rng):
    """tests/test_pbc.py's dimer: chain B shifted by a whole box so the
    cluster straddles a face (two cluster molecules: n_cluster > 1), then
    everything wrapped; two frames, the second moved by 0.37 nm."""
    box = np.array([6.0, 6.0, 6.0])
    chain_a = np.cumsum(rng.normal(scale=0.08, size=(30, 3)), axis=0)
    chain_b = chain_a[::-1] + np.array([1.5, 0.2, -0.1])
    waters = [o + np.array([[0, 0, 0], [0.08, 0.02, 0], [0, 0.08, 0.02]])
              for o in rng.uniform(0, 6.0, size=(40, 1, 3))]
    xyz = np.concatenate([chain_a, chain_b] + waters + [rng.uniform(0, 6.0, (1, 3))])
    xyz[30:60] += box * np.array([1.0, -1.0, 0.0])
    frames = np.mod(np.stack([xyz, xyz + 0.37]), box)
    top = _top(["CA"] * 60 + ["OW", "HW1", "HW2"] * 40 + ["NA"],
               np.concatenate([np.arange(1, 31), np.arange(1, 31),
                               np.repeat(np.arange(100, 140), 3), [500]]),
               ["ALA"] * 60 + ["SOL"] * 120 + ["NA"],
               ["A"] * 30 + ["B"] * 30 + ["W"] * 120 + ["I"])
    return top, frames, box


def ligand(rng):
    """A 20-atom chain and a 6-atom ligand numbered contiguously after it
    (residue 21: fused by molecule_ids, split by --mol-breaks 21), 10
    waters, per-frame boxes; wrapped."""
    n_frames = 5
    box = np.array([[3.0, 3.3, 2.9]] * n_frames) * (1 + 0.01 * np.arange(n_frames))[:, None]
    chain = np.cumsum(rng.normal(scale=0.1, size=(20, 3)), axis=0)
    lig = chain[-1] + 0.6 + 0.05 * rng.normal(size=(6, 3))
    wat = rng.uniform(0, 2.9, (10, 3))[:, None] + np.array([[0, 0, 0], [0.08, 0, 0], [0, 0.08, 0]])
    xyz = np.concatenate([chain, lig, wat.reshape(30, 3)])
    drift = np.cumsum(rng.normal(scale=0.5, size=(n_frames, 1, 3)), axis=0)
    raw = np.mod(xyz[None] + drift, box[:, None, :])
    top = _top(["CA"] * 20 + ["C1"] * 6 + ["OW", "HW1", "HW2"] * 10,
               np.concatenate([np.arange(1, 21), [21] * 6, np.repeat(np.arange(50, 60), 3)]),
               ["ALA"] * 20 + ["LIG"] * 6 + ["SOL"] * 30, ["A"] * 26 + ["W"] * 30)
    return top, raw, box


def psf_text(top, bonds):
    """A standard-format CHARMM PSF of ``top`` (segment = chain) with
    ``bonds`` (0-based pairs)."""
    lines = ["PSF", "", "       1 !NTITLE", " REMARKS test system", "",
             f"{top.n_atoms:8d} !NATOM"]
    for i in range(top.n_atoms):
        lines.append(f"{i + 1:8d} {top.chain_ids[i]:<4s} {int(top.res_seqs[i]):<4d} "
                     f"{top.res_names[i]:<4s} {top.atom_names[i]:<4s} X       0.000000"
                     f"       12.0110           0")
    lines += ["", f"{len(bonds):8d} !NBOND: bonds"]
    flat = [f"{int(k) + 1:8d}" for k in np.asarray(bonds).ravel()]
    lines += ["".join(flat[i:i + 8]) for i in range(0, len(flat), 8)]
    return "\n".join(lines) + "\n\n"


def _center(top, raw, box, dtype, **kw):
    jtop = _both(top)[1]
    want = np.asarray(jpbc.center_solute(raw.astype(dtype), box, top=jtop, **kw))
    got = tpbc.center_solute(raw.astype(dtype), box, top=top, device="cpu", **kw)
    return got, want


@pytest.mark.parametrize("dtype,atol", [(np.float64, 1e-12), (np.float32, 1e-5)],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("system", ["one_chain", "dimer"])
def test_center_solute_matches_jax(system, dtype, atol):
    top, raw, box = {"one_chain": one_chain, "dimer": dimer}[system](np.random.default_rng(11))
    got, want = _center(top, raw, box, dtype, batch=5)
    assert got.dtype == want.dtype == dtype and got.shape == raw.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    if system == "dimer":
        assert int(tpbc.molecule_ids(top).max()) + 1 == 43
        # the clustered dimer is whole: chain B sits 1.5 nm from chain A
        d = got[:, 30:60].mean(axis=1) - got[:, :30].mean(axis=1)
        np.testing.assert_allclose(np.abs(d[:, 0]), 1.5, atol=0.3)


@pytest.mark.parametrize("dtype,atol", [(np.float64, 1e-12), (np.float32, 1e-5)],
                         ids=["f64", "f32"])
def test_mol_breaks_and_per_frame_boxes_match_jax(dtype, atol):
    top, raw, box = ligand(np.random.default_rng(5))
    mol_t = tpbc.apply_molecule_breaks(tpbc.molecule_ids(top), top, ["A:21"])
    mol_j = jpbc.apply_molecule_breaks(jpbc.molecule_ids(_both(top)[1]), _both(top)[1], ["A:21"])
    np.testing.assert_array_equal(mol_t, mol_j)
    assert mol_t[20] == mol_t[19] + 1  # the ligand is its own molecule
    got, want = _center(top, raw, box, dtype, mol_id=mol_t, batch=2)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_psf_bond_graph_molecules_match_jax(tmp_path):
    """Molecules from a .psf's bond table (one file, read by both
    packages): exact connected components, then the repair."""
    top, raw, box = ligand(np.random.default_rng(9))
    bonds = np.array([[i, i + 1] for i in range(19)] + [[i, i + 1] for i in range(20, 25)]
                     + [[26 + 3 * k, 27 + 3 * k] for k in range(10)]
                     + [[26 + 3 * k, 28 + 3 * k] for k in range(10)])
    fn = str(tmp_path / "sys.psf")
    with open(fn, "w") as fp:
        fp.write(psf_text(top, bonds))
    ttop, tbonds = tpsf.read_psf(fn)
    jtop, jbonds = jpsf.read_psf(fn)
    np.testing.assert_array_equal(tbonds, jbonds)
    mol_t = tpsf.molecule_ids_from_bonds(ttop.n_atoms, tbonds)
    mol_j = jpsf.molecule_ids_from_bonds(jtop.n_atoms, jbonds)
    np.testing.assert_array_equal(mol_t, mol_j)
    assert mol_t.max() + 1 == 12  # chain, ligand, 10 waters
    got = tpbc.center_solute(raw, box, top=ttop, mol_id=mol_t, device="cpu")
    want = np.asarray(jpbc.center_solute(raw, box, top=jtop, mol_id=mol_j))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_unwrap_and_minimum_image_match_jax():
    rng = np.random.default_rng(2)
    box = np.array([5.0, 4.0, 4.5])
    mol = rng.normal(scale=0.3, size=(3, 20, 3)) + np.array([4.9, 2.0, 0.1])
    wrapped = np.mod(mol, box)
    got = tpbc.unwrap_and_center(torch.from_numpy(wrapped), box).numpy()
    np.testing.assert_allclose(got, np.asarray(jpbc.unwrap_and_center(wrapped, box)),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(got, mol - mol.mean(axis=1, keepdims=True), atol=1e-12)
    per_frame = box * np.array([[1.0], [1.1], [0.9]])
    got = tpbc.unwrap_and_center(torch.from_numpy(wrapped), per_frame).numpy()
    np.testing.assert_allclose(got, np.asarray(jpbc.unwrap_and_center(wrapped, per_frame)),
                               rtol=0, atol=1e-12)
    a, b = rng.uniform(0, 5, (2, 50, 3))
    got = tpbc.minimum_image_distance(torch.from_numpy(a), torch.from_numpy(b), box).numpy()
    np.testing.assert_allclose(got, np.asarray(jpbc.minimum_image_distance(a, b, box)),
                               rtol=0, atol=1e-12)
    assert np.all(np.abs(got) <= box / 2 + 1e-12)


def test_topology_helpers_match_jax():
    for make in (one_chain, dimer, ligand):
        top, _, _ = make(np.random.default_rng(0))
        jtop = _both(top)[1]
        np.testing.assert_array_equal(tpbc.molecule_ids(top), jpbc.molecule_ids(jtop))
        np.testing.assert_array_equal(tpbc.solute_mask(top), jpbc.solute_mask(jtop))
        for breaks in ([21], ["A:21", "B:5"], [1, 130]):
            np.testing.assert_array_equal(
                tpbc.apply_molecule_breaks(tpbc.molecule_ids(top), top, breaks),
                jpbc.apply_molecule_breaks(jpbc.molecule_ids(jtop), jtop, breaks))
    assert tpbc.WATER_ION_RESNAMES == jpbc.WATER_ION_RESNAMES


def test_center_solute_refuses_what_jax_refuses():
    top, raw, box = one_chain(np.random.default_rng(1), n_frames=2)
    bad = tpbc.molecule_ids(top).copy()
    bad[5] = 7
    with pytest.raises(ValueError, match="contiguous"):
        tpbc.center_solute(raw, box, mol_id=bad, device="cpu")
    with pytest.raises(ValueError, match="matches no atoms"):
        tpbc.center_solute(raw, box, top=top, solute=np.zeros(top.n_atoms, bool), device="cpu")
    with pytest.raises(ValueError, match="need top= or mol_id="):
        tpbc.center_solute(raw, box, device="cpu")
