"""The port's XTC codec wrapper (spinrelax_tpu_torch.io.native, built from
its own csrc/xtc.cpp with the host C++ compiler) and its trajectory readers
against spinrelax_tpu's: files written by either package read back bit for
bit through the other, and the bond-index bounds check the JAX wrapper
lacks on the in-memory reduction.
"""

import os

import numpy as np
import pytest

from spinrelax_tpu.io import native as jnat
from spinrelax_tpu.io import trajectory as jtraj
from spinrelax_tpu.ops import orient as jor
from spinrelax_tpu_torch import _build
from spinrelax_tpu_torch.io import native as tnat
from spinrelax_tpu_torch.io import pdb as tpdb
from spinrelax_tpu_torch.io import trajectory as ttraj
from spinrelax_tpu_torch.io import xvg as txvg


@pytest.fixture(scope="module")
def system(tmp_path_factory):
    """11 atoms x 257 frames of a drifting, jittering cloud, with boxes and
    times, written once by each package's write_xtc."""
    rng = np.random.default_rng(7)
    tmp = tmp_path_factory.mktemp("xtc")
    xyz = (rng.normal(size=(1, 11, 3)) + np.cumsum(0.01 * rng.normal(size=(257, 11, 3)), 0))
    xyz = xyz.astype(np.float32)
    times = (np.arange(257) * 2.5).astype(np.float32)
    boxes = np.broadcast_to(np.diag([3.0, 4.0, 5.0]).astype(np.float32), (257, 3, 3)).copy()
    by_jax, by_port = str(tmp / "jax.xtc"), str(tmp / "port.xtc")
    jnat.write_xtc(by_jax, xyz, times=times, boxes=boxes, precision=100000.0)
    tnat.write_xtc(by_port, xyz, times=times, boxes=boxes, precision=100000.0)
    return dict(tmp=tmp, xyz=xyz, times=times, boxes=boxes, by_jax=by_jax, by_port=by_port)


def test_codec_builds_into_the_build_directory():
    """The codec lands in spinrelax_tpu_torch/build/ under a name carrying
    its source's hash, and is the port's own copy of the JAX package's
    source."""
    tnat.info_xtc  # noqa: B018  (import only; the build is at first use)
    path = _build.host_library_path("xtc")
    tnat._load_xtc()
    assert path.exists() and path.parent == _build.BUILD_DIR
    assert path.name.startswith("libxtc_") and path.suffix == ".so"
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    src = open(os.path.join(here, "spinrelax_tpu", "native", "xtc.cpp"), "rb").read()
    assert (_build.CSRC / "xtc.cpp").read_bytes() == src
    assert tnat.xtc_obs_available()


def test_written_files_equal_byte_for_byte(system):
    assert open(system["by_jax"], "rb").read() == open(system["by_port"], "rb").read()
    assert tnat.info_xtc(system["by_jax"]) == jnat.info_xtc(system["by_port"]) == (257, 11)


@pytest.mark.parametrize("writer", ["by_jax", "by_port"])
@pytest.mark.parametrize("threads", [1, 3])
def test_read_and_iter_xtc_bit_for_bit(system, writer, threads):
    """read_xtc and iter_xtc (chunks of 100: 100, 100, 57) of either
    package on either package's file give the same arrays, bit for bit; the
    coordinates are the written ones to the file's precision."""
    fn = system[writer]
    for a, b in zip(tnat.read_xtc(fn, threads=threads), jnat.read_xtc(fn)):
        np.testing.assert_array_equal(a, b)
    got = list(tnat.iter_xtc(fn, 100, threads=threads))
    want = list(jnat.iter_xtc(fn, 100))
    assert [c[0].shape[0] for c in got] == [100, 100, 57]
    for cg, cw in zip(got, want):
        for a, b in zip(cg, cw):
            np.testing.assert_array_equal(a, b)
    xyz = np.concatenate([c[0] for c in got])
    np.testing.assert_allclose(xyz, system["xyz"], atol=1e-5)
    np.testing.assert_array_equal(np.concatenate([c[2] for c in got]), system["times"])
    np.testing.assert_array_equal(np.concatenate([c[1] for c in got]), system["boxes"])


@pytest.mark.parametrize("writer", ["by_jax", "by_port"])
@pytest.mark.parametrize("threads", [1, 4])
def test_iter_xtc_obs_bit_for_bit(system, writer, threads):
    """The fused decode -> bond-observable reader of both packages, and the
    in-memory reduction of the decoded chunk, give the same bits."""
    rng = np.random.default_rng(3)
    idx_h, idx_x = np.array([1, 4, 7, 10]), np.array([0, 3, 6, 9])
    A = jor.bond_obs_matrix(rng.normal(size=(11, 3)), rng.uniform(0.1, 1, 11))
    got = list(tnat.iter_xtc_obs(system[writer], 100, idx_h, idx_x, A, threads=threads))
    want = list(jnat.iter_xtc_obs(system[writer], 100, idx_h, idx_x, A))
    assert len(got) == len(want) == 3
    for cg, cw in zip(got, want):
        assert cg[0].dtype == cg[1].dtype == np.float32
        for a, b in zip(cg, cw):
            np.testing.assert_array_equal(a, b)
    xyz = tnat.read_xtc(system[writer])[0]
    raw, S = tnat.reduce_obs_mem(xyz, idx_h, idx_x, A)
    jraw, jS = jnat.reduce_obs_mem(xyz, idx_h, idx_x, A)
    np.testing.assert_array_equal(raw, jraw)
    np.testing.assert_array_equal(S, jS)
    np.testing.assert_array_equal(raw, np.concatenate([c[0] for c in got]))
    np.testing.assert_array_equal(S.astype(np.float32), np.concatenate([c[1] for c in got]))


def test_append_extends_a_file(system):
    fn = str(system["tmp"] / "grown.xtc")
    tnat.write_xtc(fn, system["xyz"][:100], times=system["times"][:100], precision=100000.0)
    tnat.write_xtc(fn, system["xyz"][100:], times=system["times"][100:], precision=100000.0,
                   append=True, step0=100)
    assert tnat.info_xtc(fn) == (257, 11)
    np.testing.assert_array_equal(tnat.read_xtc(fn)[0], tnat.read_xtc(system["by_port"])[0])


@pytest.mark.parametrize("bad", [(11, 0), (0, 11), (-1, 0), (0, -12), (2**40, 0)])
@pytest.mark.parametrize("route", ["reduce_obs_mem", "iter_xtc_obs"])
def test_out_of_range_bond_index_raises(system, route, bad):
    """A bond index outside [0, natoms) raises ValueError in both routes
    (the C loops would read past the frame), as does a wrong A shape."""
    idx_h, idx_x = np.array([1, bad[0]]), np.array([0, bad[1]])
    A = np.zeros((3, 11))
    if route == "reduce_obs_mem":
        def call(h, x, a):
            return tnat.reduce_obs_mem(system["xyz"], h, x, a)
    else:
        def call(h, x, a):
            return list(tnat.iter_xtc_obs(system["by_port"], 50, h, x, a))
    with pytest.raises(ValueError, match="out of range"):
        call(idx_h, idx_x, A)
    with pytest.raises(ValueError, match="shape"):
        call(np.array([1]), np.array([0]), np.zeros((3, 10)))
    with pytest.raises(ValueError, match="shape"):
        call(np.array([1, 2]), np.array([0]), A)
    call(np.array([10]), np.array([0]), A)  # the last atom is in range


def test_reduce_obs_mem_refuses_other_input(system):
    with pytest.raises(ValueError, match="float32"):
        tnat.reduce_obs_mem(system["xyz"].astype(np.float64), [1], [0], np.zeros((3, 11)))


def test_missing_file_and_missing_compiler_raise(system, monkeypatch, tmp_path):
    with pytest.raises(OSError):
        tnat.read_xtc(str(tmp_path / "nope.xtc"))
    with pytest.raises(OSError):
        list(tnat.iter_xtc(str(tmp_path / "nope.xtc"), 10))
    # No compiler, nothing built: the build raises (no numpy stand-in).
    monkeypatch.setattr(_build, "_host_libs", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "empty_build")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CXX", raising=False)
    with pytest.raises(RuntimeError, match="compiler"):
        _build.load_host("xtc")


@pytest.mark.parametrize("ext", ["xtc", "npz", "npy", "pdb"])
def test_trajectory_readers_match_jax(system, ext):
    """load_trajectory and iter_trajectory (chunks of 1, the stage's
    timestep probe, and of 100) on every format the port reads."""
    xyz = system["xyz"][:120]
    fn = str(system["tmp"] / f"t.{ext}")
    if ext == "xtc":
        tnat.write_xtc(fn, xyz, times=system["times"][:120], precision=100000.0)
    elif ext == "npz":
        ttraj.save_trajectory_npz(fn, xyz, timestep=2.5)
    elif ext == "npy":
        np.save(fn, xyz)
    else:
        top = tpdb.Topology(atom_names=["CA"] * 11, res_seqs=np.arange(11) + 1,
                            res_names=["GLY"] * 11, chain_ids=["A"] * 11,
                            occupancies=np.ones(11), elements=["C"] * 11)
        tpdb.write_pdb(fn, top, xyz[:7])
    assert ttraj.is_timeless(fn) == jtraj.is_timeless(fn) == (ext in ("npy", "pdb"))
    (a, dta), (b, dtb) = ttraj.load_trajectory(fn), jtraj.load_trajectory(fn)
    np.testing.assert_array_equal(a, b)
    assert dta == dtb
    for chunk in (1, 100):
        got = list(ttraj.iter_trajectory(fn, chunk, timestep=0.5))
        want = list(jtraj.iter_trajectory(fn, chunk, timestep=0.5))
        assert len(got) == len(want)
        for (xa, da), (xb, db) in zip(got, want):
            np.testing.assert_array_equal(xa, xb)
            assert da == db


@pytest.mark.parametrize("name", ["t.trr", "t.dcd", "t.gro", "t.nc", "t.mdcrd", "t.xyz", "t.h5"])
def test_other_trajectory_formats_name_their_roadmap_item(name):
    for call in (lambda: ttraj.load_trajectory(name),
                 lambda: next(ttraj.iter_trajectory(name, 10)),
                 lambda: ttraj.is_timeless(name)):
        with pytest.raises(NotImplementedError, match="item 14"):
            call()


def test_gz_and_structure_dispatch(tmp_path):
    with pytest.raises(ValueError, match="gzip"):
        ttraj.load_trajectory("t.xtc.gz")
    for fn in ("ref.gro", "top.psf", "top.prmtop"):
        with pytest.raises(NotImplementedError, match="item 14"):
            tpdb.read_topology(fn)
    with pytest.raises(NotImplementedError, match="item 14"):
        tpdb.read_structure("ref.gro")


def test_text_writers_write_the_jax_packages_bytes(tmp_path, rng):
    """print_sxylist (the pure-numpy route in the port, the native renderer
    in the JAX package) and print_xylist write the same bytes."""
    from spinrelax_tpu.io import xvg as jxvg

    x = (np.arange(40) + 1.0) * 2.5
    y = np.stack([rng.uniform(-1, 1, (3, 40)), rng.uniform(0, 1e-3, (3, 40))], axis=-1)
    y[0, 0] = [1.0, np.nan]
    for dtype in (np.float32, np.float64):
        a, b = str(tmp_path / "a.dat"), str(tmp_path / "b.dat")
        txvg.print_sxylist(a, [2, 3, 5], x, y.astype(dtype))
        jxvg.print_sxylist(b, [2, 3, 5], x, y.astype(dtype))
        assert open(a, "rb").read() == open(b, "rb").read()
        txvg.print_xylist(a, [2, 3, 5], y[:, :2, 0].T.astype(dtype), cols=True)
        jxvg.print_xylist(b, [2, 3, 5], y[:, :2, 0].T.astype(dtype), cols=True)
        assert open(a, "rb").read() == open(b, "rb").read()
