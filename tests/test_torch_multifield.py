"""The port's experiment files, legacy single-field fits and fit stages
against spinrelax_tpu's, on the same files, float64 on the CPU:
io/experiments (the same bytes, each package reading the other's),
fit/legacyfit.fit_legacy (five modes, Powell / L-BFGS / device),
pipeline/stages.stage_multifield and stage_relax's legacy fit branch.

Tolerances: without a fit the xvg files are the same bytes; after a fit
the parsed values agree within 1e-4 relative for Powell (its own xtol /
ftol: a tie in a line search may send the packages down different paths)
and 1e-6 for the gradient and device methods; the printed "%g" headers
within one unit of their sixth digit beyond that.
"""

import os
import re
import shutil

import jax
import numpy as np
import pytest
import torch

from spinrelax_tpu.constants import NucleusPair as JPair
from spinrelax_tpu.constants import field_from_mhz
from spinrelax_tpu.core import geometry as jgeom
from spinrelax_tpu.fit.legacyfit import fit_legacy as jfit_legacy
from spinrelax_tpu.io import experiments as jexp
from spinrelax_tpu.io import fittedct as jfct
from spinrelax_tpu.io import vectors as jvec
from spinrelax_tpu.models import CtModelSet as JCts
from spinrelax_tpu.models import Diffusion as JDiff
from spinrelax_tpu.ops import observables as jobs
from spinrelax_tpu.pipeline import stages as jstages
from spinrelax_tpu_torch.constants import NucleusPair as TPair
from spinrelax_tpu_torch.fit import globalfit as tgf
from spinrelax_tpu_torch.fit.legacyfit import fit_legacy as tfit_legacy
from spinrelax_tpu_torch.io import experiments as texp
from spinrelax_tpu_torch.models.ctmodel import CtModelSet as TCts
from spinrelax_tpu_torch.models.diffusion import Diffusion as TDiff
from spinrelax_tpu_torch.pipeline import stages as tstages

N_RES, DISO, ANISO, ZETA = 8, 4e-5, 1.4, 0.890023


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


# ---------------------------------------------------------------------------
# io/experiments
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_errors", [True, False])
def test_experiment_files_roundtrip_across_packages(tmp_path, with_errors):
    rng = np.random.default_rng(0)
    kw = dict(expt_type="R2", nuclei_a="15N", nuclei_b="1H", frequency=850.13,
              freq_unit="MHz", names=np.array(["3", "4", "7"]),
              values=rng.uniform(5, 15, 3),
              errors=rng.uniform(0.1, 0.5, 3) if with_errors else None)
    jexp.write_experiment(str(tmp_path / "j.dat"), jexp.ExperimentData(**kw))
    texp.write_experiment(str(tmp_path / "t.dat"), texp.ExperimentData(**kw))
    texp.write_experiment(str(tmp_path / "t.dat.gz"), texp.ExperimentData(**kw))
    assert _bytes(tmp_path / "t.dat") == _bytes(tmp_path / "j.dat")
    for reader, fn in ((texp.read_experiment, "j.dat"), (jexp.read_experiment, "t.dat"),
                       (texp.read_experiment, "t.dat.gz")):
        back = reader(str(tmp_path / fn))
        assert (back.expt_type, back.nuclei_a, back.frequency) == ("R2", "15N", 850.13)
        np.testing.assert_array_equal(back.names, kw["names"])
        np.testing.assert_allclose(back.values, kw["values"], rtol=1e-11)  # "%.12g"
        assert (back.errors is None) == (not with_errors)
    (tmp_path / "bad.dat").write_text("# Type R1\n# NucleiA 15N\n# Frequency 600\n1 2.0 0.1\n2 3.0\n")
    for mod in (texp, jexp):
        with pytest.raises(ValueError, match="all entries have uncertainties or none"):
            mod.read_experiment(str(tmp_path / "bad.dat"))


# ---------------------------------------------------------------------------
# fit/legacyfit
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def legacy():
    """tests/test_legacyfit.py's setup; the truth has an S2 scale of 0.95
    and a per-residue CSA, so every mode has something to fit."""
    rng = np.random.default_rng(21)
    n, s = 6, 12
    names = [str(i + 2) for i in range(n)]
    args = (names, rng.uniform(0.6, 0.9, n), list(rng.uniform(0.02, 0.1, (n, 2))),
            list(np.stack([rng.uniform(5, 30, n), rng.uniform(100, 600, n)], -1)))
    kw = dict(s2fast=[True] * n, zeta=0.89, sort=False)
    v = rng.normal(size=(n, s, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    w = rng.uniform(0.5, 2.0, (n, s))
    jc = JCts.from_lists(*args, **kw)
    csa_true = rng.uniform(-190e-6, -150e-6, n)
    jp = JPair(B0=field_from_mhz(600.133), time_unit="ps")
    r = jobs.predict_rates(jp, JDiff.axisymmetric(diso=DISO, aniso=ANISO),
                           jc.with_zeta(0.89 * 0.95), vecs=v, weights=w, csa=csa_true)
    exp = np.stack([np.asarray(r.R1), np.asarray(r.R2), np.asarray(r.NOE)], -1)
    err = np.stack([np.asarray(r.dR1), np.asarray(r.dR2), np.asarray(r.dNOE)], -1)
    return dict(jc=jc, tc=TCts.from_lists(*args, device="cpu", **kw), v=v, w=w, exp=exp,
                err=np.maximum(err, 1e-3 * np.abs(exp)), jp=jp,
                tp=TPair(B0=field_from_mhz(600.133), time_unit="ps"))


@pytest.mark.parametrize("mode,method", [
    ("Diso", "powell"), ("DisoS2", "powell"), ("DisoCSA", "powell"), ("DisoS2CSA", "powell"),
    ("new", "powell"), ("DisoCSA", "gradient"), ("DisoS2CSA", "gradient"), ("new", "device"),
])
def test_fit_legacy_matches_jax(legacy, mode, method):
    kw = dict(vecs=legacy["v"], weights=legacy["w"], max_cycles=20, tol=1e-8, method=method)
    want = jfit_legacy(mode, legacy["jp"], JDiff.axisymmetric(diso=4.4e-5, aniso=ANISO),
                       legacy["jc"], legacy["exp"], legacy["err"], **kw)
    got = tfit_legacy(mode, legacy["tp"], TDiff.axisymmetric(diso=4.4e-5, aniso=ANISO),
                      legacy["tc"], legacy["exp"], legacy["err"], **kw)
    rtol = 1e-4 if method == "powell" else 1e-6
    assert got.mode == mode
    for k in ("diso", "s2_scale", "chisq"):
        np.testing.assert_allclose(getattr(got, k), getattr(want, k), rtol=rtol, err_msg=k)
    np.testing.assert_allclose(got.csa, want.csa, rtol=rtol)


def test_fit_legacy_device_only_for_new(legacy):
    with pytest.raises(ValueError, match="mode='new' only"):
        tfit_legacy("DisoCSA", legacy["tp"], TDiff.axisymmetric(diso=DISO, aniso=ANISO),
                    legacy["tc"], legacy["exp"], legacy["err"], vecs=legacy["v"],
                    weights=legacy["w"], method="device")
    with pytest.raises(ValueError, match="invalid optimisation mode"):
        tfit_legacy("Dfoo", legacy["tp"], TDiff.axisymmetric(diso=DISO, aniso=ANISO),
                    legacy["tc"], legacy["exp"], None, vecs=legacy["v"])


# ---------------------------------------------------------------------------
# pipeline/stages: stage_multifield and stage_relax's legacy fit
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A _fittedCt.dat and _vecHistogram.npz written by the JAX package,
    experiment files at three fields written by the port (every 4th
    residue left out of the 850 MHz NOE), and a 6-column legacy table."""
    d = tmp_path_factory.mktemp("mf")
    rng = np.random.default_rng(31)
    names = [str(i + 2) for i in range(N_RES)]
    cts = JCts.from_lists(names, rng.uniform(0.65, 0.9, N_RES),
                          list(rng.uniform(0.02, 0.08, (N_RES, 2))),
                          list(np.stack([rng.uniform(8, 25, N_RES),
                                         rng.uniform(150, 500, N_RES)], -1)),
                          s2fast=[True] * N_RES, sort=False)
    dt = np.arange(1.0, 50.0)
    fitted = str(d / "in_fittedCt.dat")
    jfct.write_fittedct(fitted, cts, dt=dt, targets=np.asarray(cts.eval(dt)))
    v = rng.normal(size=(N_RES, 600, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    hist, ep, ec = jgeom.lambert_histogram(jax.numpy.asarray(v), 24, 12)
    vec_fn = str(d / "in_vecHistogram.npz")
    jvec.save_histogram(vec_fn, names, np.asarray(hist), np.asarray(ep), np.asarray(ec))
    _, v_used, w_used = jvec.load_vector_distribution(vec_fn)
    csa_true = rng.uniform(-190e-6, -150e-6, N_RES)
    truth = JDiff.axisymmetric(diso=DISO, aniso=ANISO)
    expt_files = []
    for f in (600.133, 700.13, 850.13):
        pair = JPair(B0=field_from_mhz(f), time_unit="ps")
        r = jobs.predict_rates_newapi(pair, truth, cts.with_zeta(ZETA), vecs=v_used,
                                      weights=w_used, csa=csa_true)
        for t in ("R1", "R2", "NOE"):
            keep = np.arange(N_RES) % 4 != 1 if (f, t) == (850.13, "NOE") else slice(None)
            fn = str(d / f"expt_{t}_{f}.dat")
            texp.write_experiment(fn, texp.ExperimentData(
                expt_type=t, nuclei_a="15N", nuclei_b="1H", frequency=f, freq_unit="MHz",
                names=np.array(names)[keep], values=np.asarray(getattr(r, t))[keep],
                errors=np.maximum(np.asarray(getattr(r, "d" + t)), 1e-3)[keep]))
            expt_files.append(fn)
    legacy_rates = jobs.predict_rates(JPair(B0=field_from_mhz(600.133), time_unit="ps"), truth,
                                      cts.with_zeta(ZETA * 0.95), vecs=v_used, weights=w_used,
                                      csa=csa_true)
    table = str(d / "legacy6.dat")
    with open(table, "w") as fp:
        for i, n in enumerate(names[1:]):  # residue 2 has no measurement
            row = []
            for k in ("R1", "R2", "NOE"):
                val = float(np.asarray(getattr(legacy_rates, k))[i + 1])
                row += [val, max(float(np.asarray(getattr(legacy_rates, "d" + k))[i + 1]),
                                 1e-3 * abs(val))]
            print(n, *row, file=fp)
    return dict(dir=d, fitted=fitted, vec=vec_fn, expts=expt_files, table=table,
                csa_true=csa_true)


def _run_pair(files, tmp, stage, **kw):
    """Run ``stage`` of both packages on the same files into tmp/jax and
    tmp/port; returns the two directories and results."""
    out = []
    for pkg, mod, Diff in (("jax", jstages, JDiff), ("port", tstages, TDiff)):
        d = tmp / pkg
        d.mkdir(exist_ok=True)
        extra = {} if pkg == "jax" else dict(device="cpu")
        start = Diff.axisymmetric(diso=4.6e-5, aniso=ANISO)
        if stage == "multifield":
            res = mod.stage_multifield(files["fitted"], files["expts"], str(d / "mf"), start,
                                       vec_file=files["vec"], zeta=ZETA, **kw, **extra)
        else:
            res = mod.stage_relax(files["fitted"], str(d / "rl"), start, vec_file=files["vec"],
                                  zeta=ZETA, expt_file=files["table"], **kw, **extra)
        out.append((d, res))
    return out


def _headers_and_rows(fn):
    heads, rows = [], []
    for line in open(fn):
        if line.startswith("#"):
            heads.append(line.split())
        elif line[:1].isdigit():
            rows.append([float(x) for x in line.split()])
    return heads, np.array(rows)


def _same_parsed(a, b, rtol):
    """Two artefacts: the same header words, the header numbers within
    rtol plus one unit of their sixth printed digit, rows within rtol."""
    (ha, ra), (hb, rb) = _headers_and_rows(a), _headers_and_rows(b)
    assert len(ha) == len(hb) and ra.shape == rb.shape
    for la, lb in zip(ha, hb):
        assert len(la) == len(lb)
        for x, y in zip(la, lb):
            try:
                fx, fy = float(x), float(y)
            except ValueError:
                assert x == y, (la, lb)
                continue
            assert abs(fx - fy) <= rtol * abs(fy) + 10.0 ** (np.floor(np.log10(abs(fy) or 1)) - 5)
    np.testing.assert_allclose(ra, rb, rtol=rtol, atol=1e-12)


def test_stage_multifield_without_fit_is_byte_equal(files, tmp_path):
    (jd, jres), (td, tres) = _run_pair(files, tmp_path, "multifield", include_expt=True)
    names = sorted(os.listdir(jd))
    assert names == sorted(os.listdir(td)) and len(names) == 9
    for f in names:
        assert _bytes(td / f) == _bytes(jd / f), f
    assert tres["chisq"] is None and tres["diso"] == jres["diso"]


@pytest.mark.parametrize("opt,method", [("Diso,rsCSA", "powell"), ("Diso,Daniso", "device"),
                                        ("Diso,rsCSA", "device")])
def test_stage_multifield_fit_matches_jax(files, tmp_path, opt, method):
    (jd, jres), (td, tres) = _run_pair(files, tmp_path, "multifield",
                                       opt_params=opt.split(","), method=method,
                                       include_expt=True, tol=1e-8)
    rtol = 1e-4 if method == "powell" else 1e-6
    names = sorted(os.listdir(jd))
    assert names == sorted(os.listdir(td))
    assert ("mf_CSA_opt.dat" in names) == ("rsCSA" in opt)
    for f in names:
        _same_parsed(td / f, jd / f, rtol)
    for k in ("diso", "aniso"):
        np.testing.assert_allclose(tres[k], jres[k], rtol=rtol, err_msg=k)
    # chisq ~1e-11 at the truth: held in absolute terms
    np.testing.assert_allclose(tres["chisq"], jres["chisq"], rtol=rtol, atol=1e-14)
    if "rsCSA" in opt:  # the experiments carry a per-residue CSA
        np.testing.assert_allclose(tres["diso"], DISO, rtol=1e-3)
        np.testing.assert_allclose(tres["csa"], files["csa_true"], rtol=5e-3)


def test_stage_multifield_devices_raise_before_reading(tmp_path):
    """devices=2 with no two-rank process group running raises, naming
    the launcher, before any file is read or written."""
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        tstages.stage_multifield("missing_fittedCt.dat", ["missing.dat"], str(tmp_path / "x"),
                                 TDiff.isotropic(diso=4e-5), opt_params=["Diso"], devices=2,
                                 device="cpu")
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("mode,method", [("Diso", "powell"), ("DisoS2CSA", "powell"),
                                         ("new", "powell"), ("new", "device"),
                                         ("DisoS2", "gradient")])
def test_stage_relax_legacy_fit_matches_jax(files, tmp_path, mode, method, capsys):
    """The 6-column table, residue 2 unmeasured: the fit on the shared
    residues, the '# Optimised/Fixed' header on R1/R2/NOE (not rho), and
    _CSA_values.dat for mode 'new'."""
    (jd, _), (td, _) = _run_pair(files, tmp_path, "relax", opt_mode=mode, opt_method=method,
                                 tol=1e-8, max_cycles=30)
    printed = [line for line in capsys.readouterr().out.splitlines() if line.startswith("# ")]
    assert len(printed) == 8 and printed[:4][0].split()[:3] == printed[4:][0].split()[:3]
    names = sorted(os.listdir(jd))
    assert names == sorted(os.listdir(td))
    assert ("rl_CSA_values.dat" in names) == (mode == "new")
    rtol = 1e-4 if method == "powell" else 1e-6
    for f in names:
        _same_parsed(td / f, jd / f, rtol)
    head = open(td / "rl_R1.dat").read().splitlines()[:4]
    assert [h.split()[1:3] for h in head] == [
        ["Optimised", "Diso:"], ["Optimised" if "S2" in mode else "Fixed", "zeta:"],
        ["Optimised" if mode in ("DisoS2CSA", "new") else "Fixed", "CSA:"],
        ["Optimised", "chi:"]]
    assert not open(td / "rl_rho.dat").read().startswith("#")


def test_stage_relax_three_column_table(files, tmp_path):
    """A 3-column table (no errors): the unweighted chi-square."""
    block = np.loadtxt(files["table"])
    table3 = tmp_path / "legacy3.dat"
    np.savetxt(table3, block[:, [0, 1, 3, 5]], fmt=["%d", "%.12g", "%.12g", "%.12g"])
    shutil.copy(table3, files["dir"] / "legacy3.dat")
    files3 = dict(files, table=str(files["dir"] / "legacy3.dat"))
    (jd, _), (td, _) = _run_pair(files3, tmp_path, "relax", opt_mode="Diso")
    for f in sorted(os.listdir(jd)):
        _same_parsed(td / f, jd / f, 1e-4)
    chi = float(re.search(r"chi: (\S+)", open(td / "rl_R1.dat").read()).group(1))
    assert np.isfinite(chi)


def test_fit_reads_are_counted(files):
    """GlobalFitter's Powell reads one scalar an evaluation (plus its
    final chisq); the device LM one flag a window and one result."""
    from spinrelax_tpu_torch.io import fittedct as tfct
    from spinrelax_tpu_torch.io import vectors as tvec
    from spinrelax_tpu_torch.models.experiments import ExperimentSet

    cts = tfct.read_fittedct(files["fitted"], device="cpu").with_zeta(ZETA)
    names, v, w = tvec.load_vector_distribution(files["vec"])
    es = ExperimentSet.build([texp.read_experiment(f) for f in files["expts"]], cts,
                             TDiff.axisymmetric(diso=4.6e-5, aniso=ANISO), vecs=v, weights=w,
                             vec_names=names)
    for method in ("powell", "device"):
        fit = tgf.GlobalFitter(es, ["Diso", "Daniso"])
        tgf.host_reads.count = 0
        fit.run(method=method)
        if method == "powell":
            assert tgf.host_reads.count == fit.counts["evaluations"]
        else:
            assert tgf.host_reads.count == fit.counts["lm_steps"] // tgf.LM_WINDOW + 1
