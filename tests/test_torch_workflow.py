"""The port's run-all workflow (spinrelax_tpu_torch.pipeline.runall and the
stages under it) against spinrelax_tpu's, in process, on the CPU, on one
synthetic .xtc + .pdb: 4 residues, 1600 frames 1 ps apart, tau_memory
400 ps (lags of 4 ps), 4 uncertainty chunks, fields 600.133 and 850.13 MHz
with J(omega).

Artefacts are compared byte for byte where the values are equal (the
colvar, the Delta-q files, the fits and rates from the same upstream
files), otherwise parsed: C(t) of the .xtc's float32 frames to 1e-5 (the
JAX stage computes in float32, the port's CPU stage in float64), C(t) of
float64 frames to 1e-9, rates from the same fitted model to 1e-9
relative; the fit's selected rungs are equal.  Each port stage is also
run on the JAX package's upstream artefact.
"""

import argparse
import contextlib
import io
import os
import re
import shutil

import jax
import numpy as np
import pytest
import torch

from spinrelax_tpu.pipeline import config as jconfig
from spinrelax_tpu.pipeline import runall as jrunall
from spinrelax_tpu.pipeline import stages as jstages
from spinrelax_tpu.models import Diffusion as JDiffusion
from spinrelax_tpu_torch.entry import synthetic_system, workflow_entry
from spinrelax_tpu_torch.io import fittedct as tfct
from spinrelax_tpu_torch.io import native as tnat
from spinrelax_tpu_torch.io import xvg
from spinrelax_tpu_torch.models.diffusion import Diffusion
from spinrelax_tpu_torch.pipeline import cli as tcli
from spinrelax_tpu_torch.pipeline import config as tconfig
from spinrelax_tpu_torch.pipeline import runall as trunall
from spinrelax_tpu_torch.pipeline import stages as tstages

PREF = "rotdif-0.4ns"
FIELDS = ("600", "850")
STAGES = ("stage_orientation", "stage_dq", "stage_ct", "stage_ct_streamed",
          "stage_fit_ct", "stage_relax")


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_state():
    """Clear jax's compiled-program caches before this module (see
    tests/test_review_fixes_r3.py); two torch threads per xdist worker."""
    jax.clear_caches()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(2)


@contextlib.contextmanager
def _in_dir(path):
    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


def _cfg(pkg, system, **io_kw):
    """run-all's configuration, relative artefact names (the manifest then
    holds relative paths, so a copied directory resumes)."""
    return pkg.WorkflowConfig(
        io=pkg.IOParams(outpref="rotdif", traj=system["xtc"], refpdb=system["ref"],
                        qfile="colvar-qorient", **io_kw),
        tumbling=pkg.TumblingParams(tau_mem=400.0, num_chunks=4),
        experiments=pkg.ExperimentParams(bfields_mhz=(600.133, 850.13), do_jomega=True))


@pytest.fixture(scope="module")
def system(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("wf")
    ref_fn, xtc_fn, _ = synthetic_system(tmp, n_res=4, n_frames=1600, dt=1.0, seed=11)
    npy = str(tmp / "solute64.npy")
    np.save(npy, tnat.read_xtc(xtc_fn)[0].astype(np.float64))
    return dict(tmp=tmp, ref=ref_fn, xtc=xtc_fn, npy=npy)


def _no_plot(argv):
    raise RuntimeError("plot left out")


@pytest.fixture(scope="module")
def jax_run(system):
    """The JAX package's run_workflow: its directory and printed output.
    Both packages plot the fitted C(t) (matplotlib, cosmetic) into the
    same _fittedCt.pdf."""
    d = system["tmp"] / "jax"
    d.mkdir()
    out = io.StringIO()
    with _in_dir(d), contextlib.redirect_stdout(out):
        jrunall.run_workflow(_cfg(jconfig, system))
    return dict(dir=d, stdout=out.getvalue())


@pytest.fixture(scope="module")
def port_run(system):
    d = system["tmp"] / "port"
    d.mkdir()
    with _in_dir(d):
        summary = trunall.run_workflow(_cfg(tconfig, system), device="cpu")
    return dict(dir=d, summary=summary)


def _bytes(fn):
    with open(fn, "rb") as fp:
        return fp.read()


def _artefacts(d):
    return sorted(f for f in os.listdir(d) if not f.endswith(".json"))


def _assert_moi_agree(a, b):
    """-moi.xyz: the axes' rows up to sign (eigh returns either)."""
    ra, rb = (np.array([[float(x) for x in line.split()[1:]] for line in open(f)
                        if line[0] in "XYZ"]) for f in (a, b))
    s = np.where(np.sum(ra * rb, axis=-1, keepdims=True) >= 0, 1.0, -1.0)
    np.testing.assert_allclose(ra * s, rb, atol=2e-6)


def _assert_ct_files_agree(a, b, atol):
    la, xa, ya, dya = xvg.load_sxydylist(a)
    lb, xb, yb, dyb = xvg.load_sxydylist(b)
    assert la == lb
    np.testing.assert_array_equal(xa, xb)
    np.testing.assert_allclose(ya, yb, atol=atol)
    np.testing.assert_allclose(dya, dyb, atol=atol * 10)


def _rung(fn):
    m = tfct.read_fittedct(fn, device="cpu")
    return m.mask.sum(1).numpy() * 2 + m.s2fast.numpy()


def _assert_rates_agree(a, b, rtol):
    if _bytes(a) != _bytes(b):
        ma, mb = xvg.load_matrix(a), xvg.load_matrix(b)
        np.testing.assert_allclose(ma, mb, rtol=rtol, atol=0)


# --- the workflow ---------------------------------------------------------------

def test_workflow_matches_jax(jax_run, port_run):
    """The same artefact set; the colvar and the Delta-q files byte for byte
    (so the same Diso / Dani); C(t) to float32 precision; the same rungs;
    rates within 1e-4 relative of JAX's (whose C(t) is float32)."""
    j, t = jax_run["dir"], port_run["dir"]
    assert _artefacts(t) == _artefacts(j)
    for f in ("colvar-qorient", f"{PREF}-iso.dat", f"{PREF}-aniso2.dat", f"{PREF}-aniso_q.dat"):
        assert _bytes(t / f) == _bytes(j / f), f
    _assert_moi_agree(t / f"{PREF}-moi.xyz", j / f"{PREF}-moi.xyz")
    m = re.search(r"Diso=(\S+) ps\^-1, Daniso=(\S+)", jax_run["stdout"])
    s = port_run["summary"]
    assert ("%g" % s["diso"], "%g" % s["dani"]) == m.groups()
    for f in ("_Ctint.dat", "_Ctext.dat"):
        _assert_ct_files_agree(t / (PREF + f), j / (PREF + f), 1e-5)
    for f in ("_S2.dat", "_avgvec.dat"):
        np.testing.assert_allclose(xvg.load_matrix(t / (PREF + f)),
                                   xvg.load_matrix(j / (PREF + f)), atol=1e-5)
    np.testing.assert_array_equal(_rung(t / f"{PREF}_fittedCt.dat"),
                                  _rung(j / f"{PREF}_fittedCt.dat"))
    for bf in FIELDS:
        for f in ("R1", "R2", "NOE", "rho"):
            _assert_rates_agree(t / f"{PREF}-{bf}_{f}.dat", j / f"{PREF}-{bf}_{f}.dat", 1e-4)
        ja, ta = (xvg.load_sxydylist(d / f"{PREF}-{bf}_Jw.dat") for d in (j, t))
        np.testing.assert_allclose(ta[2], ja[2], rtol=1e-4)
    assert set(s["walls"]) == {"orient", "dq", "ct", "fit-ct", "relax"}


def _boom(*a, **k):
    raise AssertionError("a stage ran that should have been skipped")


def test_second_call_skips_every_stage(system, port_run, monkeypatch, capsys):
    for name in STAGES:
        monkeypatch.setattr(tstages, name, _boom)
    before = {f: _bytes(port_run["dir"] / f) for f in _artefacts(port_run["dir"])}
    with _in_dir(port_run["dir"]):
        again = trunall.run_workflow(_cfg(tconfig, system), device="cpu")
    assert capsys.readouterr().out.lower().count("skipping") == 6  # 4 stages + 2 fields
    assert {f: _bytes(port_run["dir"] / f) for f in before} == before
    assert (again["diso"], again["dani"]) == (port_run["summary"]["diso"],
                                              port_run["summary"]["dani"])


def test_removed_noe_reruns_the_relax_stage(system, port_run, monkeypatch):
    """tests/test_runall.py's interrupted-relax case: a missing NOE file
    reruns that field's relax stage only."""
    d = port_run["dir"]
    noe = d / f"{PREF}-600_NOE.dat"
    want = _bytes(noe)
    os.remove(noe)
    for name in STAGES[:-1]:
        monkeypatch.setattr(tstages, name, _boom)
    calls = []
    relax = tstages.stage_relax
    monkeypatch.setattr(tstages, "stage_relax",
                        lambda *a, **k: calls.append(a[1]) or relax(*a, **k))
    with _in_dir(d):
        trunall.run_workflow(_cfg(tconfig, system), device="cpu")
    assert _bytes(noe) == want and calls == [f"{PREF}-600"]


def test_port_resumes_over_the_jax_manifest(system, jax_run, monkeypatch, tmp_path):
    """A copy of the JAX package's run directory: the port skips every
    stage and reads its artefacts back to the same tensor."""
    d = tmp_path / "resume"
    shutil.copytree(jax_run["dir"], d)
    for name in STAGES:
        monkeypatch.setattr(tstages, name, _boom)
    with _in_dir(d):
        s = trunall.run_workflow(_cfg(tconfig, system), device="cpu")
    m = re.search(r"Diso=(\S+) ps\^-1, Daniso=(\S+)", jax_run["stdout"])
    assert ("%g" % s["diso"], "%g" % s["dani"]) == m.groups()


def test_stream_takes_the_streamed_stage(system, port_run, monkeypatch, tmp_path):
    """-stream 2 (groups of 2 Palmer chunks): stage_ct_streamed runs in
    place of stage_ct, to the in-memory stage's C(t) within float32
    precision (the streamed CPU stage keeps the frames' float32)."""
    monkeypatch.setattr(tstages, "stage_ct", _boom)
    with _in_dir(tmp_path):
        trunall.main(["-out", "rotdif", "-sxtc", system["xtc"], "-refpdb", system["ref"],
                      "-t_mem", "400", "-stream", "2", "-Bfields", "600.133"], device="cpu")
        _assert_ct_files_agree(tmp_path / f"{PREF}_Ctint.dat",
                               port_run["dir"] / f"{PREF}_Ctint.dat", 1e-5)
        assert os.path.exists(f"{PREF}-600_rho.dat")


def test_two_folders_take_the_multi_replica_dq(system, tmp_path):
    """A folders file of two replicas: the aggregate colvar with two FIELDS
    headers, Delta-q pooled over the replicas (analyse_dq_multi; its
    uncertainty chunks group whole replicas)."""
    for r in ("r0", "r1"):
        os.mkdir(tmp_path / r)
        shutil.copy(system["xtc"], tmp_path / r / "solute.xtc")
        shutil.copy(system["ref"], tmp_path / r / "reference.pdb")
    (tmp_path / "folders.txt").write_text("r0\nr1\n")
    with _in_dir(tmp_path):
        s = trunall.main(["-out", "rotdif", "-folders", "folders.txt", "-sxtc", "solute.xtc",
                          "-t_mem", "400", "-num_chunks", "2", "-Bfields", "600.133"],
                         device="cpu")
        assert tnat.count_fields_headers("colvar-qorient-aggregate") == 2
        assert os.path.exists(f"{PREF}-600_R1.dat") and np.isfinite(s["diso"])


def test_not_ported_options_raise_before_any_artefact(system, tmp_path):
    base = _cfg(tconfig, system)
    fit = tconfig.ExperimentParams(fit_modes=("Diso",), exp_files=("e.dat",))
    cases = [(tconfig.WorkflowConfig(
                  io=tconfig.IOParams(outpref="rotdif", traj=system["xtc"],
                                      refpdb=system["ref"], stream_groups=2, devices=2),
                  tumbling=base.tumbling, experiments=fit), "torchrun --nproc-per-node 2")]
    # -devices / --devices 2 with no two-rank process group running raise
    # before any artefact (tests/test_torch_parallel_cli.py runs the ranks)
    with _in_dir(tmp_path):
        for cfg, item in cases:
            with pytest.raises(ValueError, match=item):
                trunall.run_workflow(cfg, device="cpu")
        # fit-ct --optimiser varpro runs (test_torch_cli.py::test_fit_ct_varpro_matches_jax)
        for argv in (["fit-ct", "-f", "x_Ctint.dat", "--devices", "2"],
                     ["ct", "-s", system["ref"], "-f", system["xtc"], "-t", "400",
                      "--split", "2", "--devices", "2"]):
            with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
                tcli.main(argv, device="cpu")
        assert os.listdir(tmp_path) == []
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                trunall.run_workflow(base)
            with pytest.raises(RuntimeError, match="no CUDA device"):
                trunall.run_workflow(tconfig.WorkflowConfig(io=base.io, tumbling=base.tumbling,
                                                            experiments=fit))
            with pytest.raises(RuntimeError, match="no CUDA device"):
                workflow_entry(str(tmp_path / "w"))
            assert os.listdir(tmp_path) == []


def _plausible_experiments(d, outdir):
    """R1/R2/NOE at 600.133 and 850.13 MHz from the run's own C(t) models
    and vectors at 0.9 x its Diso (new-API rates, 2 % errors), residue 3
    left out of the 850 MHz NOE."""
    from spinrelax_tpu_torch.constants import NucleusPair
    from spinrelax_tpu_torch.io import experiments as texp
    from spinrelax_tpu_torch.io import vectors as tvec
    from spinrelax_tpu_torch.ops import observables as tobs

    cts = tfct.read_fittedct(str(d / f"{PREF}_fittedCt.dat"), device="cpu").with_zeta(0.890023)
    names, v, w = tvec.load_vector_distribution(str(d / f"{PREF}_vecHistogram.npz"))
    m = re.search(r"Diso=(\S+) ps\^-1, Daniso=(\S+)", open(d / "stdout.txt").read())
    diff = Diffusion.axisymmetric(diso=0.9 * float(m.group(1)), aniso=float(m.group(2)))
    files = []
    for f in (600.133, 850.13):
        r = tobs.predict_rates_newapi(NucleusPair(B0=2 * np.pi * f / 267.513, time_unit="ps"),
                                      diff, cts, vecs=v, weights=w)
        for t in ("R1", "R2", "NOE"):
            keep = np.asarray(names) != "3" if (f, t) == (850.13, "NOE") else slice(None)
            y = getattr(r, t).numpy()
            fn = str(outdir / f"exp_{t}_{int(f)}.dat")
            texp.write_experiment(fn, texp.ExperimentData(
                t, "15N", "1H", f, "MHz", np.asarray(names)[keep], y[keep],
                0.02 * np.abs(y[keep])))
            files.append(fn)
    return files


def test_fit_modes_match_jax(system, port_run, jax_run, tmp_path):
    """run_workflow with fit_modes ("Diso", "Diso,rsCSA") and experiment
    files: each package in a copy of the port's run directory (every
    earlier stage skips), the stage_multifield artefacts of both within
    Powell's 1e-4 relative (and one unit of a "%g" header's sixth digit)."""
    from spinrelax_tpu.pipeline import plotting

    src = tmp_path / "src"
    shutil.copytree(port_run["dir"], src)
    (src / "stdout.txt").write_text(jax_run["stdout"])
    exp_files = _plausible_experiments(src, tmp_path)
    dirs = {}
    for pkg, conf in (("jax", jconfig), ("port", tconfig)):
        d = dirs[pkg] = tmp_path / pkg
        shutil.copytree(src, d)
        cfg = _cfg(conf, system)
        cfg = conf.WorkflowConfig(io=cfg.io, tumbling=cfg.tumbling, experiments=conf.ExperimentParams(
            bfields_mhz=(600.133, 850.13), do_jomega=True, fit_modes=("Diso", "Diso,rsCSA"),
            exp_files=tuple(exp_files)))
        out = io.StringIO()
        with _in_dir(d), contextlib.redirect_stdout(out), pytest.MonkeyPatch.context() as mp:
            mp.setattr(plotting, "main", _no_plot)
            if pkg == "jax":
                jrunall.run_workflow(cfg)
            else:
                summary = trunall.run_workflow(cfg, device="cpu")
        assert out.getvalue().lower().count("skipping") == 6, pkg
    made = sorted(f for f in os.listdir(dirs["port"]) if "-opt" in f)
    assert made == sorted(f for f in os.listdir(dirs["jax"]) if "-opt" in f)
    assert len(made) == 2 * 6 + 1 and f"{PREF}-optDiso_rsCSA_CSA_opt.dat" in made
    for f in made:
        a, b = (open(dirs[p] / f).read().split() for p in ("port", "jax"))
        assert len(a) == len(b), f
        for x, y in zip(a, b):
            try:
                fx, fy = float(x), float(y)
            except ValueError:
                assert x == y, f
                continue
            assert abs(fx - fy) <= 1e-4 * abs(fy) + 10.0 ** (
                np.floor(np.log10(abs(fy) or 1.0)) - 5), (f, x, y)
    assert set(summary["walls"]) == {"orient", "dq", "ct", "fit-ct", "relax", "fit"}


def test_config_flags_match_jax():
    """add_workflow_args builds the same flags, destinations and defaults,
    and the same argv fills the same fields."""
    def flags(mod):
        p = argparse.ArgumentParser()
        mod.add_workflow_args(p)
        return [(a.option_strings, a.dest, a.default, a.nargs, a.type, a.choices,
                 type(a).__name__) for a in p._actions]

    assert flags(tconfig) == flags(jconfig)
    argv = ["-out", "x", "-t_mem", "2000", "-Bfields", "600", "700", "-Jw", "-stream", "3",
            "-q_ext", "1", "0", "0", "0", "-D_ext", "1e-4", "1.2"]
    parsed = []
    for mod in (tconfig, jconfig):
        p = argparse.ArgumentParser()
        mod.add_workflow_args(p)
        cfg = mod.config_from_namespace(p.parse_args(argv))
        parsed.append({k: vars(getattr(cfg, k)) for k in ("io", "tumbling", "physics",
                                                          "experiments")})
    assert parsed[0] == parsed[1]


# --- each stage against the JAX package's, from the JAX package's upstream -------

def test_stage_dq_on_the_jax_colvar(jax_run, tmp_path):
    j = jax_run["dir"]
    p = str(tmp_path / "t")
    res = tstages.stage_dq(str(j / "colvar-qorient"), p, 4.0, 400.0, 4.0, n_chunks=4,
                           device="cpu")
    for f in ("-iso.dat", "-aniso2.dat", "-aniso_q.dat"):
        assert _bytes(p + f) == _bytes(j / (PREF + f)), f
    _assert_moi_agree(p + "-moi.xyz", j / f"{PREF}-moi.xyz")
    assert res.iso_chunks.shape == (4, 100)


def _jax_quat(j):
    with open(j / f"{PREF}-aniso_q.dat") as fp:
        return np.array([float(x) for x in fp.readline().split()[1:5]])


def test_stage_ct_on_the_jax_quaternion(system, jax_run, tmp_path):
    """The .xtc with the JAX run's PAF quaternion: JAX's float32 artefacts
    to 1e-5; the float64 frames through both packages to 1e-9."""
    j, q = jax_run["dir"], _jax_quat(jax_run["dir"])
    p = str(tmp_path / "t")
    out = tstages.stage_ct([system["xtc"]], [system["ref"]], p, 400.0, q_rot=q, device="cpu")
    assert out["Ct"].dtype == np.float64 and out["Ct"].shape == (200, 4)
    for f in ("_Ctint.dat", "_Ctext.dat"):
        _assert_ct_files_agree(p + f, j / (PREF + f), 1e-5)
    for f in ("_S2.dat", "_avgvec.dat"):
        np.testing.assert_allclose(xvg.load_matrix(p + f), xvg.load_matrix(j / (PREF + f)),
                                   atol=1e-5)
    a, b = (np.load(f, allow_pickle=True)["data"] for f in
            (p + "_vecHistogram.npz", j / f"{PREF}_vecHistogram.npz"))
    assert a.dtype == b.dtype and np.abs(a.astype(int) - b).sum() <= 4  # float32 bin edges
    # float64 frames: both packages compute in float64
    kw = dict(q_rot=q, timestep=1.0, do_vec_dist=False)
    p64, j64 = str(tmp_path / "t64"), str(tmp_path / "j64")
    t64 = tstages.stage_ct([system["npy"]], [system["ref"]], p64, 400.0, device="cpu", **kw)
    jo = jstages.stage_ct([system["npy"]], [system["ref"]], j64, 400.0, **kw)
    np.testing.assert_allclose(t64["Ct"], np.asarray(jo["Ct"]), atol=1e-9)
    np.testing.assert_allclose(t64["dCt"], np.asarray(jo["dCt"]), atol=1e-9)
    np.testing.assert_allclose(t64["S2"], np.asarray(jo["S2"]), atol=1e-9)
    for f in ("_Ctint.dat", "_Ctext.dat"):
        _assert_ct_files_agree(p64 + f, j64 + f, 1e-9)


def test_stage_fit_ct_on_the_jax_ct(jax_run, tmp_path):
    """The DoF ladder on JAX's _Ctint.dat (float64 on both sides): the same
    rungs, the parameters to 1e-6 relative."""
    j = jax_run["dir"]
    p = str(tmp_path / "t")
    tstages.stage_fit_ct([str(j / f"{PREF}_Ctint.dat")], p, device="cpu")
    a = tfct.read_fittedct(p + "_fittedCt.dat", device="cpu")
    b = tfct.read_fittedct(str(j / f"{PREF}_fittedCt.dat"), device="cpu")
    np.testing.assert_array_equal(_rung(p + "_fittedCt.dat"), _rung(j / f"{PREF}_fittedCt.dat"))
    for f in ("S2", "C", "tau"):
        np.testing.assert_allclose(getattr(a, f).numpy(), getattr(b, f).numpy(), rtol=1e-5,
                                   err_msg=f)
    # two replicas of the same file: the averaged artefact and the fit
    tstages.stage_fit_ct([str(j / f"{PREF}_Ctint.dat")] * 2, p + "2", device="cpu")
    assert os.path.exists(p + "2_averageCt.dat")
    np.testing.assert_array_equal(_rung(p + "2_fittedCt.dat"), _rung(p + "_fittedCt.dat"))


def test_stage_relax_on_the_jax_fit(jax_run, tmp_path):
    """Rates and J(omega) at both fields from JAX's _fittedCt.dat, its
    vector histogram and its tensor: JAX's bytes, or 1e-9 relative."""
    j = jax_run["dir"]
    m = re.search(r"Diso=(\S+) ps\^-1, Daniso=(\S+)", jax_run["stdout"])
    diso, dani = (float(x) for x in m.groups())
    for bf, mhz in zip(FIELDS, (600.133, 850.13)):
        p = str(tmp_path / bf)
        jp = str(tmp_path / ("j" + bf))
        args = (str(j / f"{PREF}_fittedCt.dat"),)
        kw = dict(vec_file=str(j / f"{PREF}_vecHistogram.npz"), freq_mhz=mhz)
        for jomega in (False, True):
            tstages.stage_relax(*args, p, Diffusion.axisymmetric(diso=diso, aniso=dani),
                                jomega=jomega, device="cpu", **kw)
            jstages.stage_relax(*args, jp, JDiffusion.axisymmetric(diso=diso, aniso=dani),
                                jomega=jomega, **kw)
        for f in ("_R1.dat", "_R2.dat", "_NOE.dat", "_rho.dat"):
            _assert_rates_agree(p + f, jp + f, 1e-9)
        a, b = xvg.load_sxydylist(p + "_Jw.dat"), xvg.load_sxydylist(jp + "_Jw.dat")
        assert a[0] == b[0]
        np.testing.assert_allclose(a[2], b[2], rtol=1e-9)
        np.testing.assert_allclose(a[3], b[3], rtol=1e-9)


def test_stage_relax_theoretical_matches_jax():
    for kind in ("isotropic", "axisymmetric"):
        t = tstages.stage_relax_theoretical(
            Diffusion.isotropic(diso=1e-3) if kind == "isotropic"
            else Diffusion.axisymmetric(diso=1e-3, aniso=1.4), device="cpu")
        j = jstages.stage_relax_theoretical(
            JDiffusion.isotropic(diso=1e-3) if kind == "isotropic"
            else JDiffusion.axisymmetric(diso=1e-3, aniso=1.4))
        for f in ("R1", "R2", "NOE", "rho"):
            np.testing.assert_allclose(getattr(t, f).numpy(), np.asarray(getattr(j, f)),
                                       rtol=1e-12, err_msg=f)


def test_workflow_entry_writes_the_artefacts(tmp_path):
    out = workflow_entry(str(tmp_path), device="cpu", n_res=4, n_frames=1600,
                         tau_memory=400.0)
    names = {os.path.basename(p) for p in out["paths"]}
    for bf in FIELDS:
        for f in ("R1", "R2", "NOE", "rho", "Jw"):
            assert f"rotdif-0.4ns-{bf}_{f}.dat" in names
    assert {"colvar-qorient", "rotdif-0.4ns_fittedCt.dat", "rotdif-0.4ns-aniso2.dat"} <= names
    assert out["diso"] > 0
