"""The port's command line (spinrelax_tpu_torch.pipeline.cli,
``python -m spinrelax_tpu_torch``) against spinrelax_tpu's, on the CPU.

Each command runs through the port's ``cli.main(argv, device="cpu")`` and
the JAX package's ``cli.main(argv)`` in separate directories on the same
inputs: a small raw system (a 6-residue solute from
entry.synthetic_system, 1600 frames 1 ps apart, drifting across images of
a 4 nm box with 40 waters, everything wrapped) goes through
center -> orient -> dq -> ct -> fit-ct -> relax -> rho / multifield, the
port's step each time reading the JAX step's upstream artefact.

Tolerances: bytes where the values are equal (the colvar, the Delta-q
files, rates from the same fitted model, the text formats); decoded .xtc
coordinates to one XTC rounding (1e-3 nm); C(t), S2 and the average
vector to 1e-5 (the JAX stage computes in float32, the port's CPU stage in
float64, as tests/test_torch_workflow.py); iRED / wiRED S2 to 1e-4 (an
eigendecomposition of float32 against float64 matrices); rungs equal and
rates from the same file to 1e-9 relative; the multi-field fit within
Powell's 1e-4 relative.
"""

import contextlib
import io
import os
import re
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from spinrelax_tpu.io import experiments as jexp
from spinrelax_tpu.pipeline import cli as jcli
from spinrelax_tpu_torch.entry import synthetic_system
from spinrelax_tpu_torch.io import fittedct as tfct
from spinrelax_tpu_torch.io import native as tnat
from spinrelax_tpu_torch.io import pdb as tpdb
from spinrelax_tpu_torch.io import xvg
from spinrelax_tpu_torch.pipeline import cli as tcli
from test_bmrb import STAR_TEXT  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOX = 4.0
TAU = "400"


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_state():
    """Clear jax's compiled-program caches before this module (see
    tests/test_review_fixes_r3.py); two torch threads per xdist worker."""
    jax.clear_caches()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(2)


def _run(pkg, argv, cwd):
    """One command in ``cwd`` -> (return value or exit code, stdout)."""
    out = io.StringIO()
    old = os.getcwd()
    os.chdir(cwd)
    try:
        with contextlib.redirect_stdout(out):
            try:
                rc = jcli.main(argv) if pkg == "jax" else tcli.main(argv, device="cpu")
            except SystemExit as e:
                rc = e.code
    finally:
        os.chdir(old)
    return rc, out.getvalue()


def _raw_system(tmp):
    """raw.xtc (solute + waters, wrapped, boxes) and system.pdb; the
    solute's reference.pdb and its unwrapped frames."""
    ref_fn, xtc_fn, _ = synthetic_system(tmp, n_res=6, n_frames=1600, dt=1.0, seed=13)
    rng = np.random.default_rng(13)
    sol, _boxes, times = tnat.read_xtc(xtc_fn)
    top, _ = tpdb.read_pdb(ref_fn)
    n_f, n_w = sol.shape[0], 40
    geom = np.array([[0, 0, 0], [0.08, 0.02, 0], [0, 0.08, 0.02]], np.float32)
    sites = rng.uniform(0, BOX, (1, n_w, 1, 3)).astype(np.float32)
    wat = (sites + geom + 0.02 * rng.normal(size=(n_f, n_w, 1, 3))).reshape(n_f, 3 * n_w, 3)
    drift = np.cumsum(rng.normal(scale=0.05, size=(n_f, 1, 3)), axis=0)
    raw = np.mod(np.concatenate([sol + drift + BOX / 2, wat], axis=1), BOX).astype(np.float32)
    sys_top = tpdb.Topology(
        atom_names=list(top.atom_names) + ["OW", "HW1", "HW2"] * n_w,
        res_seqs=np.concatenate([top.res_seqs, np.repeat(np.arange(1000, 1000 + n_w), 3)]),
        res_names=list(top.res_names) + ["SOL"] * (3 * n_w),
        chain_ids=list(top.chain_ids) + ["W"] * (3 * n_w),
        occupancies=np.concatenate([top.occupancies, np.zeros(3 * n_w)]),
        elements=list(top.elements) + ["O", "H", "H"] * n_w)
    sys_pdb = str(tmp / "system.pdb")
    tpdb.write_pdb(sys_pdb, sys_top, raw[:1])
    raw_xtc = str(tmp / "raw.xtc")
    boxes = np.zeros((n_f, 3, 3), np.float32)
    boxes[:, [0, 1, 2], [0, 1, 2]] = BOX
    tnat.write_xtc(raw_xtc, raw, times=times, boxes=boxes)
    return dict(ref=ref_fn, sys=sys_pdb, raw=raw_xtc, truth=sol + drift)


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """The quick-start chain in both packages; the port's step reads the
    JAX step's upstream artefacts (absolute paths into the jax directory)."""
    tmp = tmp_path_factory.mktemp("cli")
    s = _raw_system(tmp)
    d = {pkg: tmp / pkg for pkg in ("jax", "port")}
    for p in d.values():
        p.mkdir()
    J = d["jax"]
    steps = {
        "center": ["center", "-f", s["raw"], "-s", s["sys"], "-o", "solute.xtc",
                   "--output-group", "solute", "--batch", "500"],
        "orient": ["orient", "-f", str(J / "solute.xtc"), "-s", s["ref"], "-o",
                   "colvar-qorient"],
        "dq": ["dq", "-f", str(J / "colvar-qorient"), "-o", "rotdif", "--mindt", "4",
               "--maxdt", TAU, "--skip", "4", "--num_chunk", "4"],
        "ct": ["ct", "-s", s["ref"], "-f", str(J / "solute.xtc"), "-o", "rotdif", "-t", TAU,
               "--Ct", "--S2", "--vecHist", "--vecAvg"],
        "ired": ["ct", "-s", s["ref"], "-f", str(J / "solute.xtc"), "-o", "ired", "-t", TAU,
                 "--S2", "--S2mode", "ired"],
        "wired": ["ct", "-s", s["ref"], "-f", str(J / "solute.xtc"), "-o", "wired", "-t", TAU,
                  "--S2", "--S2mode", "wired", "--split", "2"],
        "s2": ["s2", "-s", s["ref"], "-f", str(J / "solute.xtc"), "-o", "s2only", "-t", TAU],
        "fit-ct": ["fit-ct", "-f", str(J / "rotdif_Ctint.dat"), "-o", "rotdif"],
        "fit-ct varpro": ["fit-ct", "-f", str(J / "rotdif_Ctint.dat"), "-o", "varpro",
                          "--optimiser", "varpro"],
    }
    logs = {}
    for name, argv in steps.items():
        for pkg in ("jax", "port"):
            rc, log = _run(pkg, argv, d[pkg])
            assert rc == 0, (name, pkg, log[-2000:])
            logs[name, pkg] = log
    hdr = {ln.split()[2]: float(ln.split()[4]) for ln in open(J / "rotdif-aniso2.dat")
           if ln.startswith("# Converted")}
    dten = f"{hdr['Diso'] * 1e-12:.6e},{hdr['Dani_L']:.6f}"
    more = {
        "relax": ["relax", "-f", str(J / "rotdif_fittedCt.dat"), "--distfn",
                  str(J / "rotdif_vecHistogram.npz"), "-D", dten, "-F", "600.133e6",
                  "-o", "r600"],
        "relax850": ["relax", "-f", str(J / "rotdif_fittedCt.dat"), "--distfn",
                     str(J / "rotdif_vecHistogram.npz"), "-D", dten, "-B", "19.97",
                     "--Jomega", "-o", "r850"],
        "theoretical": ["relax", "-f", "unused", "--tau", "4000", "-F", "600.133e6",
                        "--theoretical"],
    }
    for name, argv in more.items():
        for pkg in ("jax", "port"):
            rc, log = _run(pkg, argv, d[pkg])
            assert rc == 0, (name, pkg, log[-2000:])
            logs[name, pkg] = log
    # experiment files from the JAX run's rates: R1/R2/NOE at 600 MHz
    names, cols = None, {}
    for t in ("R1", "R2", "NOE"):
        m = xvg.load_matrix(J / f"r600_{t}.dat")
        names, cols[t] = [str(int(r)) for r in m[:, 0]], m[:, 1]
    exp_files = []
    for t, v in cols.items():
        fn = str(tmp / f"e_{t}.dat")
        jexp.write_experiment(fn, jexp.ExperimentData(
            t, "15N", "1H", 600.133, "MHz", np.asarray(names), 0.97 * v, 0.02 * np.abs(v)))
        exp_files.append(fn)
    with open(tmp / "rates.dat", "w") as fp:
        for i, n in enumerate(names):
            fp.write(f"{n} {cols['R1'][i]:.6f} {cols['R2'][i]:.6f} {cols['NOE'][i]:.6f}\n")
    tail = {
        "rho": ["rho", "-f", str(tmp / "rates.dat"), "-o", "rho.dat"],
        "multifield": ["multifield", *exp_files, "-f", str(J / "rotdif_fittedCt.dat"),
                       "--distfn", str(J / "rotdif_vecHistogram.npz"), "-D", dten,
                       "--opt", "Diso", "--cycles", "3", "-o", "mf"],
    }
    for name, argv in tail.items():
        for pkg in ("jax", "port"):
            rc, log = _run(pkg, argv, d[pkg])
            assert rc == 0, (name, pkg, log[-2000:])
            logs[name, pkg] = log
    return dict(s, tmp=tmp, dirs=d, logs=logs)


def _same_bytes(chain, *files):
    for f in files:
        a, b = ((chain["dirs"][p] / f).read_bytes() for p in ("port", "jax"))
        assert a == b, f


def _rows(fn):
    return np.array([[float(x) for x in ln.split()] for ln in open(fn)
                     if ln.strip() and ln[0] not in "#@&"])


def test_center_repairs_the_raw_system(chain):
    """center: the solute, whole and centred on the box centre, within one
    XTC rounding of the JAX package's output and two of the known truth
    (the unwrapped solute recentred)."""
    a, b = (tnat.read_xtc(str(chain["dirs"][p] / "solute.xtc")) for p in ("port", "jax"))
    np.testing.assert_allclose(a[0], b[0], rtol=0, atol=1.001e-3)
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[2], b[2])
    t = chain["truth"]
    want = t - t.mean(axis=1, keepdims=True) + BOX / 2
    np.testing.assert_allclose(a[0], want, rtol=0, atol=2e-3)
    assert "repaired 1600 frames" in chain["logs"]["center", "port"]


def test_orient_and_dq_write_the_jax_bytes(chain):
    _same_bytes(chain, "colvar-qorient", "rotdif-iso.dat", "rotdif-aniso2.dat",
                "rotdif-aniso_q.dat")
    assert re.search(r"D_iso = \S+ s\^-1", chain["logs"]["dq", "port"])


def test_ct_and_s2_match_jax(chain):
    P, J = chain["dirs"]["port"], chain["dirs"]["jax"]
    for f in ("rotdif_Ctint.dat", "rotdif_Ctext.dat"):
        la, xa, ya, dya = xvg.load_sxydylist(P / f)
        lb, xb, yb, dyb = xvg.load_sxydylist(J / f)
        assert la == lb
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_allclose(ya, yb, atol=1e-5)
        np.testing.assert_allclose(dya, dyb, atol=1e-4)
    for f in ("rotdif_S2.dat", "rotdif_avgvec.dat", "s2only_S2.dat"):
        np.testing.assert_allclose(xvg.load_matrix(P / f), xvg.load_matrix(J / f), atol=1e-5)
    ha, hb = (np.load(d / "rotdif_vecHistogram.npz", allow_pickle=True)["data"] for d in (P, J))
    assert ha.sum() == hb.sum() and np.abs(ha - hb).sum() / 2 <= 1e-3 * hb.sum()


@pytest.mark.parametrize("mode", ["ired", "wired"])
def test_ired_and_wired_match_jax(chain, mode):
    P, J = chain["dirs"]["port"], chain["dirs"]["jax"]
    for f in ("_S2.dat", "_iREDspectrum.dat"):
        a, b = _rows(P / (mode + f)), _rows(J / (mode + f))
        assert a.shape == b.shape and np.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4, err_msg=mode + f)


def test_fit_and_relax_match_jax(chain):
    P, J = chain["dirs"]["port"], chain["dirs"]["jax"]
    rung = [tfct.read_fittedct(str(d / "rotdif_fittedCt.dat"), device="cpu") for d in (P, J)]
    rung = [m.mask.sum(1).numpy() * 2 + m.s2fast.numpy() for m in rung]
    np.testing.assert_array_equal(rung[0], rung[1])
    for f in ("R1", "R2", "NOE", "rho"):
        a, b = xvg.load_matrix(P / f"r600_{f}.dat"), xvg.load_matrix(J / f"r600_{f}.dat")
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=0, err_msg=f)
    ja, ta = (xvg.load_sxydylist(d / "r850_Jw.dat") for d in (J, P))
    np.testing.assert_allclose(ta[2], ja[2], rtol=1e-9)
    lines = [[ln for ln in chain["logs"]["theoretical", p].splitlines()
              if ln.startswith(("R1:", "R2:", "NOE:"))] for p in ("port", "jax")]
    assert lines[0] == lines[1] and len(lines[0]) == 3


def test_fit_ct_varpro_matches_jax(chain):
    """fit-ct --optimiser varpro on the chain's Ctint file writes the JAX
    package's _fittedCt.dat: the same lines, every number equal as printed
    or within 1e-8 relative."""
    P, J = chain["dirs"]["port"], chain["dirs"]["jax"]
    a, b = ((d / "varpro_fittedCt.dat").read_text().splitlines() for d in (P, J))
    assert len(a) == len(b) and len(a) > 6
    num = re.compile(r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?")
    for la, lb in zip(a, b):
        assert num.sub("#", la) == num.sub("#", lb), (la, lb)
        for x, y in zip(num.findall(la), num.findall(lb)):
            assert x == y or abs(float(x) - float(y)) <= 1e-8 * abs(float(y)), (la, lb)
    assert "Completed C(t)-fits" in chain["logs"]["fit-ct varpro", "port"]


def test_rho_and_multifield_match_jax(chain):
    _same_bytes(chain, "rho.dat")
    P, J = chain["dirs"]["port"], chain["dirs"]["jax"]
    made = sorted(f for f in os.listdir(P) if f.startswith("mf"))
    assert made == sorted(f for f in os.listdir(J) if f.startswith("mf")) and made
    for f in made:
        a, b = (open(d / f).read().split() for d in (P, J))
        assert len(a) == len(b), f
        for x, y in zip(a, b):
            try:
                fx, fy = float(x), float(y)
            except ValueError:
                assert x == y, f
                continue
            assert abs(fx - fy) <= 1e-4 * abs(fy) + 1e-12, (f, x, y)
    chis = [re.search(r"Final chi-value: (\S+)", chain["logs"]["multifield", p]).group(1)
            for p in ("port", "jax")]
    assert abs(float(chis[0]) - float(chis[1])) <= 1e-4 * abs(float(chis[1]))


def test_run_all_through_the_cli(chain):
    """run-all on the centred .xtc: the same artefact set as the JAX
    package's run-all, the same Delta-q bytes, rungs and rates to 1e-4."""
    J = chain["dirs"]["jax"]
    argv = ["run-all", "-sxtc", str(J / "solute.xtc"), "-refpdb", chain["ref"], "-t_mem", TAU,
            "-num_chunks", "4", "-Bfields", "600.133", "-out", "rotdif", "-qfile",
            "colvar-qorient"]
    dirs = {}
    for pkg in ("jax", "port"):
        dirs[pkg] = chain["tmp"] / f"runall-{pkg}"
        dirs[pkg].mkdir()
        rc, log = _run(pkg, argv, dirs[pkg])
        assert rc == 0 and "run-all complete" in log, (pkg, log[-2000:])
    P, Jr = dirs["port"], dirs["jax"]
    files = sorted(f for f in os.listdir(P) if not f.endswith(".json"))
    assert files == sorted(f for f in os.listdir(Jr) if not f.endswith(".json"))
    assert "rotdif-0.4ns_fittedCt.pdf" in files
    for f in ("colvar-qorient", "rotdif-0.4ns-aniso2.dat"):
        assert (P / f).read_bytes() == (Jr / f).read_bytes(), f
    for f in ("R1", "R2", "NOE", "rho"):
        a, b = (xvg.load_matrix(d / f"rotdif-0.4ns-600_{f}.dat") for d in (P, Jr))
        np.testing.assert_allclose(a, b, rtol=1e-4)


def test_file_tools_match_jax(chain, tmp_path):
    """info, convert (selection, time window, stride; .gro / .dcd / .xyz /
    .npz / .trr / .nc outputs, --superpose), rotate and make-ref."""
    raw, sys_pdb, ref = chain["raw"], chain["sys"], chain["ref"]
    cmds = [
        ["info", raw, sys_pdb],
        ["convert", "-f", raw, "-s", sys_pdb, "-o", "sel.gro", "--select", "name N H",
         "-b", "10", "-e", "400", "--skip", "3", "--batch", "100"],
        ["convert", "-f", raw, "-o", "all.dcd", "--skip", "50"],
        ["convert", "-f", raw, "-s", sys_pdb, "-o", "sel.xyz", "--select", "name CA",
         "--skip", "100"],
        ["convert", "-f", raw, "-s", sys_pdb, "-o", "sol.npz", "--select", "not resname SOL",
         "--skip", "40", "--out-top", "sol.pdb"],
        ["convert", "-f", raw, "-o", "t.trr", "--skip", "200"],
        ["convert", "-f", raw, "-o", "t.nc", "--skip", "200"],
        ["convert", "-f", str(chain["dirs"]["jax"] / "solute.xtc"), "-s", ref, "-o",
         "fit.npz", "--superpose", ref, "--skip", "100"],
        ["rotate", "-f", ref, "-q", "0.7071068,0,0,0.7071068", "-o", "rot.pdb"],
        ["make-ref", "-f", raw, "-s", sys_pdb, "--frame", "3", "--box", "4", "4", "4",
         "-o", "mref.pdb"],
        ["make-ref", "-f", ref, "-o", "mref2.gro"],
    ]
    d = {p: tmp_path / p for p in ("port", "jax")}
    logs = {}
    for p in d.values():
        p.mkdir()
    for argv in cmds:
        for pkg in ("jax", "port"):
            rc, log = _run(pkg, argv, d[pkg])
            assert rc == 0, (argv, pkg, log[-2000:])
            logs[argv[0], pkg] = log
    info = [[ln for ln in logs["info", p].splitlines() if not ln.startswith("= = Finished")]
            for p in ("port", "jax")]
    assert info[0] == info[1] and "1600 frames x" in info[0][0]
    for f in ("sel.gro", "all.dcd", "sel.xyz", "sol.pdb", "t.trr", "rot.pdb", "mref.pdb",
              "mref2.gro"):
        assert (d["port"] / f).read_bytes() == (d["jax"] / f).read_bytes(), f
    for f in ("sol.npz", "fit.npz"):
        a, b = (np.load(d[p] / f) for p in ("port", "jax"))
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-5 if f == "fit.npz" else 0)
    from spinrelax_tpu_torch.io import amber as tamber

    _equal_nc = [tamber.read_nc(str(d[p] / "t.nc")) for p in ("port", "jax")]
    for x, y in zip(*_equal_nc):
        np.testing.assert_array_equal(x, y)


def test_nmr_commands_and_plot_match_jax(chain, tmp_path):
    """hydronmr (with --rotate), bmrb (a local NMR-STAR file), plot-ct."""
    res = tmp_path / "output.res"
    res.write_text("  Structural file: 1abc.pdb\n"
                   " Dx  1.5e7   eigenvector:  0.0 0.0 1.0\n"
                   " Dy  2.5e7   eigenvector:  1.0 0.0 0.0\n"
                   " Dz  2.0e7   eigenvector:  0.0 1.0 0.0\n")
    star = tmp_path / "entry.str"
    star.write_text(STAR_TEXT)
    d = {p: tmp_path / p for p in ("port", "jax")}
    logs = {}
    for pkg, p in d.items():
        p.mkdir()
        shutil.copy(chain["ref"], p / "prot.pdb")
        for argv in (["hydronmr", "-f", str(res), "--rotate", "--pdb", str(p / "prot.pdb"),
                      "-o", str(p / "paf.pdb")],
                     ["bmrb", "-f", str(star), "-o", "expt"],
                     ["plot-ct", "-f", str(chain["dirs"]["jax"] / "rotdif_fittedCt.dat"),
                      "-o", "fit.pdf"]):
            rc, log = _run(pkg, argv, p)
            assert rc == 0, (argv, pkg, log[-2000:])
            logs[argv[0], pkg] = log
    for f in ("paf.pdb", "prot.Dxyz", "prot.Dsymm"):
        assert (d["port"] / f).read_bytes() == (d["jax"] / f).read_bytes(), f
    expt = sorted(f for f in os.listdir(d["jax"]) if f.startswith("expt"))
    assert expt and expt == sorted(f for f in os.listdir(d["port"]) if f.startswith("expt"))
    for f in expt:
        assert (d["port"] / f).read_bytes() == (d["jax"] / f).read_bytes(), f
    for cmd in ("hydronmr", "bmrb"):
        a, b = ([ln for ln in logs[cmd, p].splitlines() if not ln.startswith("= = Finished.")]
                for p in ("port", "jax"))
        assert [x.replace(str(d["port"]), "D") for x in a] == \
            [x.replace(str(d["jax"]), "D") for x in b], cmd
    assert (d["port"] / "fit.pdf").stat().st_size > 1000
    assert (d["jax"] / "fit.pdf").stat().st_size > 1000


def _flags(pkg, cmd):
    """The option strings of a subcommand's parser, from its --help."""
    rc, out = _run(pkg, [cmd, "--help"], REPO)
    assert rc == 0, (pkg, cmd)
    return sorted(set(re.findall(r"(?<![\w-])(--?[A-Za-z][\w-]*)", out.split("options:")[-1])))


def test_every_command_with_the_jax_flags():
    assert list(tcli.COMMANDS) == list(jcli.COMMANDS) and len(tcli.COMMANDS) == 18
    for cmd in tcli.COMMANDS:
        if cmd == "check":
            continue  # no parser: check takes no arguments
        assert _flags("port", cmd) == _flags("jax", cmd), cmd


def test_check_and_main_exits():
    rc, out = _run("port", ["check"], REPO)
    assert rc == 0 and "check PASSED" in out and "J(omega) evaluates on cpu" in out
    assert _run("port", ["nonsense"], REPO)[0] == 1
    rc, out = _run("port", ["orient", "-f", "missing.xtc", "-s", "missing.pdb"], REPO)
    assert "file not found" in str(rc)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcli.main(["rho", "-f", "x.dat"])


def test_not_ported_options_raise_before_reading_files():
    """--devices 2 with no two-rank process group running (the multi-rank
    paths run under torchrun; tests/test_torch_parallel_cli.py) raises
    ValueError naming the launcher; the files named do not exist, so
    nothing was read first.  (fit-ct --optimiser varpro runs:
    test_fit_ct_varpro_matches_jax.)"""
    cases = [["fit-ct", "-f", "absent_Ctint.dat", "--devices", "2"],
             ["ct", "-s", "absent.pdb", "-f", "absent.xtc", "-t", "100", "--split", "2",
              "--devices", "2"],
             ["run-all", "-sxtc", "absent.xtc", "-refpdb", "absent.pdb", "-stream", "2",
              "-devices", "2"]]
    for argv in cases:
        with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
            tcli.main(argv, device="cpu")


def test_python_m_help_runs_in_a_subprocess():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-m", "spinrelax_tpu_torch", "--help"], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "Commands: " + ", ".join(sorted(tcli.COMMANDS)) in out.stdout
