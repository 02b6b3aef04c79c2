"""The port's trajectory, topology, index and NMR file formats (its numpy
copies under spinrelax_tpu_torch.io) against spinrelax_tpu's, both ways:
each file written by the JAX package's writer is read by the port, and the
port's writer's file by the JAX package, with the arrays equal (exactly:
both sides run the same numpy code on the same bytes).  The trajectory
loaders (load_trajectory, iter_trajectory, iter_trajectory_full,
is_timeless) run over every extension the JAX package reads.
"""

import os

import numpy as np
import pytest

from spinrelax_tpu.io import amber as jamber
from spinrelax_tpu.io import bmrb as jbmrb
from spinrelax_tpu.io import dcd as jdcd
from spinrelax_tpu.io import gmx as jgmx
from spinrelax_tpu.io import gro as jgro
from spinrelax_tpu.io import hydronmr as jhyd
from spinrelax_tpu.io import native as jnat
from spinrelax_tpu.io import ndx as jndx
from spinrelax_tpu.io import nmrstar as jstar
from spinrelax_tpu.io import pdb as jpdb
from spinrelax_tpu.io import prmtop as jprm
from spinrelax_tpu.io import psf as jpsf
from spinrelax_tpu.io import trajectory as jtraj
from spinrelax_tpu.io import xyz as jxyz
from spinrelax_tpu_torch.io import amber as tamber
from spinrelax_tpu_torch.io import bmrb as tbmrb
from spinrelax_tpu_torch.io import dcd as tdcd
from spinrelax_tpu_torch.io import gmx as tgmx
from spinrelax_tpu_torch.io import gro as tgro
from spinrelax_tpu_torch.io import hydronmr as thyd
from spinrelax_tpu_torch.io import native as tnat
from spinrelax_tpu_torch.io import ndx as tndx
from spinrelax_tpu_torch.io import nmrstar as tstar
from spinrelax_tpu_torch.io import pdb as tpdb
from spinrelax_tpu_torch.io import prmtop as tprm
from spinrelax_tpu_torch.io import psf as tpsf
from spinrelax_tpu_torch.io import trajectory as ttraj
from spinrelax_tpu_torch.io import xyz as txyz
from test_bmrb import STAR_TEXT  # noqa: E402
from test_prmtop import PRMTOP  # noqa: E402
from test_psf import STANDARD_PSF  # noqa: E402

N_FRAMES = 5
HYDRONMR_RES = (
    "  Structural file: 1abc.pdb\n"
    " Dx  1.5e7   eigenvector:  0.0 0.0 1.0\n"
    " Dy  2.5e7   eigenvector:  1.0 0.0 0.0\n"
    " Dz  2.0e7   eigenvector:  0.0 1.0 0.0\n"
)


def _system(mod):
    """Two N-H residues and a water (9 atoms), 5 frames in a ~3 nm box with
    per-frame boxes and times (2.5 ps apart), as ``mod``'s Topology."""
    rng = np.random.default_rng(17)
    top = mod.Topology(
        atom_names=["N", "H", "CA"] * 2 + ["OW", "HW1", "HW2"],
        res_seqs=np.array([2, 2, 2, 3, 3, 3, 90, 90, 90]),
        res_names=["ALA"] * 3 + ["GLY"] * 3 + ["SOL"] * 3,
        chain_ids=["A"] * 6 + ["W"] * 3, occupancies=np.array([0, 0, 1.0] * 2 + [0] * 3),
        elements=["N", "H", "C"] * 2 + ["O", "H", "H"])
    xyz = rng.uniform(0.2, 2.8, (N_FRAMES, 9, 3)).astype(np.float32)
    boxes = np.zeros((N_FRAMES, 3, 3), np.float32)
    boxes[:, [0, 1, 2], [0, 1, 2]] = 3.0 + 0.01 * np.arange(N_FRAMES)[:, None]
    times = 10.0 + 2.5 * np.arange(N_FRAMES)
    return top, xyz, boxes, times


def _top_fields(top):
    return (list(top.atom_names), [int(x) for x in top.res_seqs], list(top.res_names),
            list(top.chain_ids), [float(x) for x in top.occupancies], list(top.elements))


def _equal(a, b):
    """Nested tuples/lists/dicts of arrays, None and scalars, exactly equal."""
    if isinstance(a, (tuple, list)):
        assert isinstance(b, (tuple, list)) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _equal(a[k], b[k])
    elif a is None or b is None:
        assert a is None and b is None
    elif isinstance(a, str) or hasattr(a, "atom_names"):
        assert (a if isinstance(a, str) else _top_fields(a)) == \
            (b if isinstance(b, str) else _top_fields(b))
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# each format: (file name, write(mod, fn, system), read(mod, fn, system))
TRAJ = {
    "gro": ("t.gro",
            lambda m, fn, s: m.write_gro(fn, s[0], s[1], boxes=s[2], times=s[3]),
            lambda m, fn, s: m.read_gro(fn)),
    "trr": ("t.trr",
            lambda m, fn, s: m.write_trr(fn, s[1], times=s[3], box=s[2]),
            lambda m, fn, s: (m.read_trr(fn), m.info_trr(fn))),
    "dcd": ("t.dcd",
            lambda m, fn, s: m.write_dcd(fn, s[1], boxes=s[2], timestep_ps=2.5),
            lambda m, fn, s: (m.read_dcd(fn), m.info_dcd(fn), m.header_timestep_ps(fn))),
    "nc": ("t.nc",
           lambda m, fn, s: m.write_nc(fn, s[1], boxes=s[2], timestep_ps=2.5, times=s[3]),
           lambda m, fn, s: (m.read_nc(fn), m.header_timestep_ps(fn))),
    "mdcrd": ("t.mdcrd",
              lambda m, fn, s: m.write_mdcrd(fn, s[1], boxes=s[2]),
              lambda m, fn, s: m.read_mdcrd(fn, 9)),
    "xyz": ("t.xyz",
            lambda m, fn, s: m.write_xyz(fn, s[1], elements=s[0].elements,
                                         comments=[f"t= {t:g}" for t in s[3]]),
            lambda m, fn, s: m.read_xyz(fn)),
}
MODS = {"gro": (jgro, tgro), "trr": (jgmx, tgmx), "dcd": (jdcd, tdcd), "nc": (jamber, tamber),
        "mdcrd": (jamber, tamber), "xyz": (jxyz, txyz)}


def _loaders_agree(fn, top_fn):
    """load_trajectory, iter_trajectory (chunks of 1 and 2, with a caller
    timestep), iter_trajectory_full and is_timeless: the port's equal the
    JAX package's on ``fn``."""
    assert ttraj.is_timeless(fn) == jtraj.is_timeless(fn)
    _equal(ttraj.load_trajectory(fn, top_fn=top_fn), jtraj.load_trajectory(fn, top_fn=top_fn))
    for chunk in (1, 2):
        _equal(list(ttraj.iter_trajectory(fn, chunk, top_fn=top_fn, timestep=0.7)),
               list(jtraj.iter_trajectory(fn, chunk, top_fn=top_fn, timestep=0.7)))
        _equal(list(ttraj.iter_trajectory_full(fn, chunk, top_fn=top_fn)),
               list(jtraj.iter_trajectory_full(fn, chunk, top_fn=top_fn)))


def _structure_case(fmt, tmp_path):
    """psf / prmtop: the JAX tests' hand-written files read by both
    packages, directly and through io/pdb.read_topology."""
    fn = str(tmp_path / ("t.psf" if fmt == "psf" else "t.parm7"))
    with open(fn, "w") as fp:
        fp.write(STANDARD_PSF if fmt == "psf" else PRMTOP)
    jm, tm = (jpsf, tpsf) if fmt == "psf" else (jprm, tprm)
    reader = "read_psf" if fmt == "psf" else "read_prmtop"
    (ttop, tb), (jtop, jb) = getattr(tm, reader)(fn), getattr(jm, reader)(fn)
    _equal((ttop, tb), (jtop, jb))
    assert ttop.n_atoms == 10 and len(tb) > 0
    _equal(tpsf.molecule_ids_from_bonds(10, tb), jpsf.molecule_ids_from_bonds(10, jb))
    _equal(tpdb.read_topology(fn), jpdb.read_topology(fn))
    for mod in (tpdb, jpdb):
        with pytest.raises(ValueError, match="no coordinates"):
            mod.read_structure(fn)


def _ndx_case(tmp_path):
    groups = {"System": np.arange(12), "Solute": np.array([0, 1, 2, 5]),
              "Solute#2": np.array([7]), "Empty": np.array([], int)}
    fj, ft = str(tmp_path / "j.ndx"), str(tmp_path / "t.ndx")
    jndx.write_ndx(fj, groups)
    tndx.write_ndx(ft, groups)
    assert open(fj).read() == open(ft).read()
    _equal(dict(tndx.read_ndx(fj)), dict(jndx.read_ndx(ft)))
    g = tndx.read_ndx(fj)
    _equal(tndx.group_mask(g, "Solute", 12), jndx.group_mask(jndx.read_ndx(fj), "Solute", 12))
    for mod, read in ((tndx, g), (jndx, jndx.read_ndx(fj))):
        with pytest.raises(mod.NdxError):
            mod.group_mask(read, "Missing", 12)


def _nmr_case(fmt, tmp_path):
    if fmt == "nmrstar":
        te, je = tstar.parse(STAR_TEXT), jstar.parse(STAR_TEXT)
        assert [sf.name for sf in te.saveframes] == [sf.name for sf in je.saveframes]
        for a, b in zip(te.saveframes, je.saveframes):
            assert a.tags == b.tags and len(a.loops) == len(b.loops)
            for la, lb in zip(a.loops, b.loops):
                assert la.tags == lb.tags and la.rows == lb.rows
        outs = {}
        for name, mod in (("port", tbmrb), ("jax", jbmrb)):
            d = tmp_path / name
            d.mkdir()
            entry = (tstar if name == "port" else jstar).parse(STAR_TEXT)
            files = mod.parse_bmrb_entry(entry, str(d / "expt"))
            outs[name] = {os.path.basename(f): open(f).read() for f in files}
        assert outs["port"] == outs["jax"] and len(outs["port"]) == 2
    else:  # hydronmr
        fn = tmp_path / "output.res"
        fn.write_text(HYDRONMR_RES)
        got, want = thyd.read_hydronmr_results(str(fn)), jhyd.read_hydronmr_results(str(fn))
        _equal(got, want)
        _equal(thyd.translate_D(got[0] * 1e-12), jhyd.translate_D(want[0] * 1e-12))
        _equal(thyd.reorder_axes(got[0][::-1].copy(), got[1]),
               jhyd.reorder_axes(want[0][::-1].copy(), want[1]))


FORMATS = list(TRAJ) + ["psf", "prmtop", "ndx", "nmrstar", "hydronmr"]


@pytest.mark.parametrize("fmt", FORMATS)
def test_format_both_ways(fmt, tmp_path):
    if fmt in ("psf", "prmtop"):
        return _structure_case(fmt, tmp_path)
    if fmt == "ndx":
        return _ndx_case(tmp_path)
    if fmt in ("nmrstar", "hydronmr"):
        return _nmr_case(fmt, tmp_path)
    name, write, read = TRAJ[fmt]
    jm, tm = MODS[fmt]
    js, ts = _system(jpdb), _system(tpdb)
    fj, ft = str(tmp_path / ("j_" + name)), str(tmp_path / ("t_" + name))
    write(jm, fj, js)
    write(tm, ft, ts)
    assert open(fj, "rb").read() == open(ft, "rb").read()
    _equal(read(tm, fj, ts), read(jm, fj, js))  # the JAX writer's file, read by both
    _equal(read(jm, ft, js), read(tm, ft, ts))  # the port writer's file, read by both
    top_fn = str(tmp_path / "top.pdb")
    jpdb.write_pdb(top_fn, js[0], js[1][:1])
    _loaders_agree(fj, top_fn)


@pytest.mark.parametrize("ext", ["npz", "npy", "pdb", "xtc", "gro.gz", "pdb.gz", "xyz.gz"])
def test_loaders_on_the_other_extensions(ext, tmp_path):
    """The remaining extensions (and gzipped text) through both packages'
    loaders; the trajectory formats above run them on their own files."""
    top, xyz, boxes, times = _system(jpdb)
    fn = str(tmp_path / f"t.{ext}")
    if ext == "npz":
        np.savez(fn, xyz=xyz, time=times, box=boxes)
    elif ext == "npy":
        np.save(fn, xyz)
    elif ext.startswith("pdb"):
        jpdb.write_pdb(fn, top, xyz)
    elif ext == "xtc":
        jnat.write_xtc(fn, xyz, times=times.astype(np.float32), boxes=boxes)
    elif ext.startswith("gro"):
        jgro.write_gro(fn, top, xyz, boxes=boxes, times=times)
    else:
        jxyz.write_xyz(fn, xyz, elements=top.elements)
    _loaders_agree(fn, None)
    if ext == "xtc":
        _equal(tnat.read_xtc(fn), jnat.read_xtc(fn))


def test_structure_dispatch_and_gro_writer(tmp_path):
    """io/pdb.read_structure / write_structure take .gro as the JAX
    package's do, in both directions."""
    top, xyz, boxes, times = _system(tpdb)
    jtop = _system(jpdb)[0]
    ft, fj = str(tmp_path / "t.gro"), str(tmp_path / "j.gro")
    tpdb.write_structure(ft, top, xyz[:1])
    jpdb.write_structure(fj, jtop, xyz[:1])
    assert open(ft).read() == open(fj).read()
    _equal(tpdb.read_structure(fj), jpdb.read_structure(ft))
    _equal(tpdb.read_topology(fj), jpdb.read_topology(fj))
