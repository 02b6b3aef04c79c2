"""The port's text I/O against spinrelax_tpu's on the CPU: libfastio
(spinrelax_tpu_torch.io.native, built from the port's own csrc/fastio.cpp
with the host C++ compiler), print_sxylist through it, and the colvar,
fittedCt and OpenDX formats.

Bytes are compared exactly; parsed tables exactly (both parsers are the
same C code), and against numpy to 1e-12 relative.
"""

import os

import jax
import numpy as np
import pytest
import torch

from spinrelax_tpu.io import colvar as jcolvar
from spinrelax_tpu.io import dx as jdx
from spinrelax_tpu.io import fittedct as jfct
from spinrelax_tpu.io import native as jnat
from spinrelax_tpu.io import xvg as jxvg
from spinrelax_tpu.models import CtModelSet as JCtModelSet
from spinrelax_tpu_torch import _build
from spinrelax_tpu_torch.io import colvar as tcolvar
from spinrelax_tpu_torch.io import dx as tdx
from spinrelax_tpu_torch.io import fittedct as tfct
from spinrelax_tpu_torch.io import native as tnat
from spinrelax_tpu_torch.io import xvg as txvg
from spinrelax_tpu_torch.models.ctmodel import CtModelSet


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_state():
    """Clear jax's compiled-program caches before this module (see
    tests/test_review_fixes_r3.py); two torch threads per xdist worker."""
    jax.clear_caches()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(2)


def _bytes(fn):
    with open(fn, "rb") as fp:
        return fp.read()


@pytest.fixture(scope="module")
def table(tmp_path_factory):
    """A 20 000-row colvar in "%16g" rows, with #, @ and & lines."""
    fn = str(tmp_path_factory.mktemp("fastio") / "colvar")
    data = np.random.default_rng(0).normal(size=(20000, 5))
    with open(fn, "w") as fp:
        fp.write("#! FIELDS time q.w q.x q.y q.z\n@ legend\n")
        for i, row in enumerate(data):
            fp.write(" ".join("%16g" % v for v in row) + "\n")
            if i == 7:
                fp.write("&\n# comment\n\n")
    return fn, data


# --- io.native: libfastio -------------------------------------------------------

def test_library_is_the_jax_source_built_into_build_dir():
    """csrc/fastio.cpp is the JAX package's source, unchanged; the library
    lands in spinrelax_tpu_torch/build/ under a name carrying its hash."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    src = open(os.path.join(here, "spinrelax_tpu", "native", "fastio.cpp"), "rb").read()
    assert (_build.CSRC / "fastio.cpp").read_bytes() == src
    assert tnat.available()
    path = _build.host_library_path("fastio")
    assert path.exists() and path.parent == _build.BUILD_DIR
    assert path.name.startswith("libfastio_") and path.suffix == ".so"


def test_load_table_and_headers_match_jax(table, tmp_path):
    fn, data = table
    got = tnat.load_table(fn)
    assert got.shape == (20000, 5) and got.dtype == np.float64
    np.testing.assert_array_equal(got, jnat.load_table(fn))
    np.testing.assert_allclose(got, np.loadtxt(fn, comments=("#", "@", "&")), rtol=1e-12)
    agg = str(tmp_path / "agg")
    with open(agg, "w") as fp:
        for _ in range(3):
            fp.write("#! FIELDS time q.w\n0.0 1.0\n1.0 0.9\n# a note on FIELDS\n")
    assert tnat.count_fields_headers(agg) == jnat.count_fields_headers(agg) == 3
    ragged = tmp_path / "ragged.txt"
    ragged.write_text("1 2 3\n4 5 6 7\n")
    with pytest.raises(OSError):
        tnat.load_table(str(ragged))


@pytest.mark.parametrize("shape", [(700, 5), (50, 300), (1, 1)])
def test_write_table_bytes_match_jax(tmp_path, shape):
    """Plain and appended "%16g" rows, wide rows past the writer's slack."""
    data = np.random.default_rng(1).normal(size=shape) * 10.0 ** (np.arange(shape[1]) % 7)
    t, j = str(tmp_path / "t"), str(tmp_path / "j")
    for fn, mod in ((t, tnat), (j, jnat)):
        with open(fn, "w") as fp:
            fp.write("#! FIELDS a\n")
        mod.write_table(fn, data, append=True)
        mod.write_table(fn, data[:1], append=True)
    assert _bytes(t) == _bytes(j)
    np.testing.assert_allclose(tnat.load_table(t)[:-1], data, rtol=1e-5, atol=1e-300)


def test_gzip_paths_raise(tmp_path):
    for call in (lambda: tnat.load_table(str(tmp_path / "a.gz")),
                 lambda: tnat.write_table(str(tmp_path / "a.gz"), np.zeros((2, 2)))):
        with pytest.raises(ValueError, match="gzip"):
            call()


def test_format_sxy_differential_fuzz():
    """tests/test_native.py's fuzz: every row equals numpy's rendering and
    the JAX wrapper's bytes."""
    rng = np.random.default_rng(20260818)
    for dtype in (np.float64, np.float32):
        for trial in range(1500):
            k = int(rng.integers(1, 4))
            vals = (rng.normal(size=k) * 10.0 ** rng.uniform(-18, 18, k)).astype(dtype)
            r = trial % 29
            if r == 0: vals[rng.integers(0, k)] = dtype(0.0)
            if r == 1: vals[rng.integers(0, k)] = dtype(-0.0)
            if r == 2: vals[rng.integers(0, k)] = dtype(np.nan)
            if r == 3: vals[rng.integers(0, k)] = dtype(np.inf)
            if r == 4: vals[rng.integers(0, k)] = dtype(-np.inf)
            if r == 5: vals[:] = dtype(np.nan)
            if r == 6:
                vals = np.round(vals, int(rng.integers(0, 4))).astype(dtype)
            if r == 7: vals = np.trunc(vals).astype(dtype)
            if r == 8:
                vals = np.trunc(rng.uniform(1e7, 1e8, k)).astype(dtype)
                vals *= np.where(rng.random(k) < 0.5, -1, 1).astype(dtype)
            if r == 9:
                vals = (rng.normal(size=k) * 10.0 ** rng.uniform(
                    -44 if dtype == np.float32 else -320,
                    -30 if dtype == np.float32 else -300)).astype(dtype)
            if r == 10 and dtype == np.float64:
                vals = (rng.normal(size=k) * 10.0 ** rng.uniform(-310, 305, k)).astype(dtype)
            x = np.array([rng.normal() * 10.0 ** rng.uniform(-12, 24)])
            got = tnat.format_sxy(x, vals.reshape(1, -1))
            assert got.decode() == f"{x[0]} {str(vals).strip('[]')}\n", (
                dtype.__name__, vals.tobytes().hex())
            assert got == jnat.format_sxy(x, vals.reshape(1, -1))


@pytest.mark.parametrize("x,y", [(np.arange(3, dtype=np.float32), np.zeros((3, 2))),
                                 (np.arange(3.0), np.zeros((3, 4))),
                                 (np.arange(3.0), np.zeros((2, 2))),
                                 (np.arange(3.0), np.zeros((3, 2), dtype=np.int64))])
def test_format_sxy_refuses_what_it_does_not_render(x, y):
    with pytest.raises(ValueError, match="format_sxy"):
        tnat.format_sxy(x, y)


def test_missing_compiler_raises(monkeypatch, tmp_path):
    """No compiler and nothing built: the first use raises, no numpy route
    stands in."""
    monkeypatch.setattr(_build, "_host_libs", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "empty_build")
    monkeypatch.setattr(tnat, "_typed", set())
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CXX", raising=False)
    for call in (tnat.available, lambda: tnat.load_table(str(tmp_path / "x")),
                 lambda: tnat.format_sxy(np.zeros(1), np.zeros((1, 1)))):
        with pytest.raises(RuntimeError, match="compiler"):
            call()


# --- io.xvg.print_sxylist --------------------------------------------------------

def _ct_block(rng, dtype):
    return np.stack([rng.uniform(0, 1, (5, 40)), 10 ** rng.uniform(-6, -2, (5, 40))],
                    axis=-1).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_print_sxylist_native_equals_row_formatter(tmp_path, monkeypatch, dtype):
    """The native rows, the row formatter's (forced), and the JAX writer's
    are the same bytes, headers, legends and '&' lines included."""
    y = _ct_block(np.random.default_rng(7), dtype)
    x, leg = np.arange(1.0, 41.0) * 2.5, [f"s{i}" for i in range(5)]
    fast, jax_fn, slow = (str(tmp_path / n) for n in ("f.dat", "j.dat", "s.dat"))
    txvg.print_sxylist(fast, leg, x, y, header=["# h1", "# h2"])
    jxvg.print_sxylist(jax_fn, leg, x, y, header=["# h1", "# h2"])
    assert txvg._native_rows(x, y)
    monkeypatch.setattr(txvg, "_default_printoptions", lambda: False)
    txvg.print_sxylist(slow, leg, x, y, header=["# h1", "# h2"])
    assert _bytes(fast) == _bytes(slow) == _bytes(jax_fn)


def test_print_sxylist_other_printoptions_take_the_row_route(tmp_path):
    y = np.array([[[0.123456789, 0.5]], [[1e-9, 3.0]]])
    x = np.array([1.0])
    t, j = str(tmp_path / "t.dat"), str(tmp_path / "j.dat")
    try:
        np.set_printoptions(precision=3)
        assert not txvg._native_rows(x, y)
        txvg.print_sxylist(t, ["a", "b"], x, y)
        jxvg.print_sxylist(j, ["a", "b"], x, y)
    finally:
        np.set_printoptions(precision=8)
    assert "0.123 0.5" in open(t).read()
    assert _bytes(t) == _bytes(j)
    # float32 x and 2-D sets also take the row route, as in JAX
    for xx, yy in ((x.astype(np.float32), y), (np.arange(3.0), np.ones((2, 3)))):
        txvg.print_sxylist(t, ["a", "b"], xx, yy)
        jxvg.print_sxylist(j, ["a", "b"], xx, yy)
        assert _bytes(t) == _bytes(j)


# --- io.colvar -------------------------------------------------------------------

def test_colvar_readers_match_jax(table, tmp_path):
    fn, _ = table
    tn, td = tcolvar.read_colvar(fn)
    jn, jd = jcolvar.read_colvar(fn)
    assert tn == jn and td.shape == (5, 20000)
    np.testing.assert_array_equal(td, jd)
    assert tcolvar.count_colvar_rows(fn) == jcolvar.count_colvar_rows(fn) == 20000
    got = list(tcolvar.iter_colvar_chunks(fn, 6000))
    want = list(jcolvar.iter_colvar_chunks(fn, 6000))
    assert [g[1].shape[0] for g in got] == [6000, 6000, 6000, 2000]
    for (a, b), (c, d) in zip(got, want):
        assert a == c
        np.testing.assert_array_equal(b, d)
    # gzip goes through numpy: the same values
    import gzip

    gz = str(tmp_path / "c.gz")
    with open(fn, "rb") as src, gzip.open(gz, "wb") as dst:
        dst.write(src.read())
    np.testing.assert_array_equal(tcolvar.read_colvar(gz)[1], td)


def test_colvar_multi_and_writer_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    agg = str(tmp_path / "agg")
    with open(agg, "w") as fp:
        for n in (30, 30, 30):
            fp.write("#! FIELDS time q.w q.x q.y q.z\n")
            for row in rng.normal(size=(n, 5)):
                fp.write(" ".join("%16g" % v for v in row) + "\n")
    tn, td = tcolvar.read_colvar_multi(agg)
    jn, jd = jcolvar.read_colvar_multi(agg)
    assert tn == jn and td.shape == (3, 30, 5)
    np.testing.assert_array_equal(td, jd)
    a = [(r, f, b.tolist()) for r, f, b in tcolvar.iter_colvar_chunks_multi(agg, 20)]
    b = [(r, f, b.tolist()) for r, f, b in jcolvar.iter_colvar_chunks_multi(agg, 20)]
    assert a == b and [r for r, _, _ in a] == [0, 0, 1, 1, 2, 2]
    with pytest.warns(UserWarning, match="repeated FIELDS"):
        n_rows = sum(c.shape[0] for _, c in tcolvar.iter_colvar_chunks(agg, 50))
    assert n_rows == 90
    t, j = str(tmp_path / "t"), str(tmp_path / "j")
    data = rng.normal(size=(3, 17))
    tcolvar.write_colvar(t, ["a", "b", "c"], data)
    jcolvar.write_colvar(j, ["a", "b", "c"], data)
    assert _bytes(t) == _bytes(j)
    bad = tmp_path / "bad"
    bad.write_text("1 2\n")
    for call in (lambda: tcolvar.read_colvar(str(bad)),
                 lambda: list(tcolvar.iter_colvar_chunks(str(bad))),
                 lambda: tcolvar.read_colvar_multi(str(bad))):
        with pytest.raises(ValueError):
            call()


# --- io.fittedct and io.dx --------------------------------------------------------

def _models(pkg_from_lists, **kw):
    return pkg_from_lists(
        names=["2", "3", "5"], S2=[0.81, 0.7, 0.9], C_list=[[0.05, 0.1], [0.2], [0.03]],
        tau_list=[[12.5, 480.0], [33.3], [7.0]], s2fast=[True, False, True],
        dS2=[0.01, 0.02, 0.0], dC_list=[[0.001, 0.002], [0.01], [0.0]],
        dtau_list=[[0.5, 20.0], [1.0], [0.1]], chisq=[1e-5, np.nan, 3e-4], **kw)


def test_fittedct_round_trips_across_packages(tmp_path):
    """The port writes JAX's bytes (with and without curves) and each
    package reads the other's file to the same model."""
    tm = _models(CtModelSet.from_lists, device="cpu")
    jm = _models(JCtModelSet.from_lists)
    dt = np.arange(1.0, 21.0) * 2.0
    targets = np.asarray(jm.eval(dt)) + 1e-3
    for kw in ({}, {"dt": dt}, {"dt": dt, "targets": targets}):
        t, j = str(tmp_path / "t.dat"), str(tmp_path / "j.dat")
        tfct.write_fittedct(t, tm, **kw)
        jfct.write_fittedct(j, jm, **kw)
        assert _bytes(t) == _bytes(j), kw
    back = tfct.read_fittedct(j, device="cpu")
    jback = jfct.read_fittedct(t)
    assert back.names == jback.names == ["2", "3", "5"]
    for f in ("S2", "C", "tau", "mask", "s2fast", "dS2", "dC", "dtau", "chisq"):
        np.testing.assert_array_equal(getattr(back, f).numpy(), np.asarray(getattr(jback, f)),
                                      err_msg=f)


def test_dx_matches_jax(tmp_path):
    data = np.random.default_rng(5).random((4, 3, 5))
    t, j = str(tmp_path / "t.dx"), str(tmp_path / "j.dx")
    args = (data, (4, 3, 5), [0.1, -0.2, 0.3], np.diag([0.5, 0.25, 0.125]))
    tdx.write_dx(t, *args, units="nm")
    jdx.write_dx(j, *args, units="nm")
    assert _bytes(t) == _bytes(j)
    for got, want in zip(tdx.read_dx(t, units="nm"), jdx.read_dx(j, units="nm")):
        np.testing.assert_array_equal(got, want)
    with open(t, "a") as fp:
        fp.write("1 2 3\n")
    with pytest.raises(ValueError, match="more data"):
        tdx.read_dx(t, units="nm")
