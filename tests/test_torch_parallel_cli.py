"""The port's multi-device command line and stages at 4 spawned gloo
ranks (tests/torch_mp_workers.cli_checks): ``fit-ct --devices 4`` and
``stage_multifield(devices=4)`` write the same bytes as the port's
unsharded run (the JAX package's tests/test_parallel.py:245, :303 demand
the same of ``--devices 8``), only rank 0 writes, and every rank fits the
same bits.  Also: run-all ``-stream 2 -devices 2`` against the unsharded
run, the ``--devices`` error exits against the JAX package's, the port's
``dryrun_multichip(8)``, and no item-15 ``NotImplementedError`` left.
"""

import contextlib
import os
import pathlib
import re

import jax
import numpy as np
import pytest
import torch

from spinrelax_tpu.pipeline import cli as jcli
from spinrelax_tpu.pipeline import stages as jstages
from spinrelax_tpu.models import Diffusion as JDiff
from spinrelax_tpu_torch.constants import NucleusPair, field_from_mhz
from spinrelax_tpu_torch.core import geometry
from spinrelax_tpu_torch.entry import synthetic_system
from spinrelax_tpu_torch.io import fittedct as fctio
from spinrelax_tpu_torch.io import vectors as vecio
from spinrelax_tpu_torch.io import xvg
from spinrelax_tpu_torch.io.experiments import ExperimentData, write_experiment
from spinrelax_tpu_torch.models.ctmodel import CtModelSet
from spinrelax_tpu_torch.models.diffusion import Diffusion
from spinrelax_tpu_torch.ops import observables as obs
from spinrelax_tpu_torch.parallel.dryrun import dryrun_multichip
from spinrelax_tpu_torch.parallel.launch import spawn
from spinrelax_tpu_torch.pipeline import cli as tcli
from spinrelax_tpu_torch.pipeline import config as tconfig
from spinrelax_tpu_torch.pipeline import runall as trunall
from spinrelax_tpu_torch.pipeline.stages import stage_multifield
from tests import torch_mp_workers as workers

REPO = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT = 240.0


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_state():
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


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """11 residues (divides no mesh): two-timescale C(t) with noise for
    fit-ct (so the ladder walks past its first rung), and fitted C(t)
    models, a 24 x 12 vector histogram and six R1/R2/NOE files at two
    fields for multifield (tests/test_parallel.py's systems)."""
    d = tmp_path_factory.mktemp("pcli")
    rng = np.random.default_rng(20261019)
    dt = np.arange(0.0, 120.0, 2.0)
    n = 11
    tau1, tau2 = rng.uniform(3.0, 8.0, n), rng.uniform(30.0, 60.0, n)
    s2, c1 = rng.uniform(0.7, 0.85, n), rng.uniform(0.05, 0.12, n)
    y = (s2[:, None] + c1[:, None] * np.exp(-dt[None] / tau1[:, None])
         + (1.0 - s2 - c1)[:, None] * np.exp(-dt[None] / tau2[:, None]))
    y += rng.normal(0.0, 4e-4, y.shape)
    xvg.print_sxylist(str(d / "in_Ctint.dat"), [str(i + 1) for i in range(n)], dt,
                      np.stack([y, np.full_like(y, 4e-4)], axis=-1))
    names = [str(i + 2) for i in range(n)]
    v = rng.normal(size=(n, 16, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    hist, ep, ec = geometry.lambert_histogram(torch.from_numpy(v), 24, 12)
    vecio.save_histogram(str(d / "vecs.npz"), names, hist.numpy(), ep.numpy(), ec.numpy())
    _, vu, wu = vecio.load_vector_distribution(str(d / "vecs.npz"))
    cts = CtModelSet.from_lists(
        names, rng.uniform(0.6, 0.9, n), list(rng.uniform(0.02, 0.1, (n, 2))),
        list(np.stack([rng.uniform(5, 30, n), rng.uniform(100, 800, n)], -1)),
        s2fast=[True] * n, zeta=0.89, sort=False, device="cpu")
    k = 0
    for f in (600.133, 850.13):
        r = obs.predict_rates_newapi(NucleusPair(B0=field_from_mhz(f), time_unit="ps"),
                                     Diffusion.axisymmetric(diso=4e-5, aniso=1.5), cts,
                                     vecs=torch.from_numpy(vu), weights=torch.from_numpy(wu))
        for t, va, er in (("R1", r.R1, r.dR1), ("R2", r.R2, r.dR2), ("NOE", r.NOE, r.dNOE)):
            yv = va.numpy().copy()
            write_experiment(str(d / f"expt_{k}.dat"), ExperimentData(
                t, "15N", "1H", f, "MHz", np.array(names), yv,
                np.maximum(er.numpy(), 0.02 * np.abs(yv))))
            k += 1
    dtf = np.arange(1.0, 50.0)
    fctio.write_fittedct(str(d / "in_fittedCt.dat"), cts, dt=dtf,
                         targets=cts.eval(torch.from_numpy(dtf)).numpy())
    return d


def _unsharded(d, tag):
    tcli.main(["fit-ct", "-f", str(d / "in_Ctint.dat"), "-o", str(d / tag)], device="cpu")
    return stage_multifield(
        str(d / "in_fittedCt.dat"), sorted(str(p) for p in d.glob("expt_*.dat")),
        str(d / tag), Diffusion.axisymmetric(diso=4.6e-5, aniso=1.3),
        vec_file=str(d / "vecs.npz"), zeta=0.89, opt_params=["Diso", "rsCSA"], max_cycles=4,
        method="device", device="cpu")


@pytest.fixture(scope="module")
def runs(files):
    ranks = spawn(workers.cli_checks, 4, str(files), device="cpu", timeout=TIMEOUT)
    plain = _unsharded(files, "plain")
    return ranks, plain


def test_fit_ct_devices_byte_identical(files, runs):
    a = (files / "plain_fittedCt.dat").read_bytes()
    assert a and (files / "mesh_fittedCt.dat").read_bytes() == a


def test_multifield_devices_byte_identical(files, runs):
    ranks, plain = runs
    suffixes = sorted(p.name[len("plain"):] for p in files.glob("plain_*")
                      if p.name != "plain_fittedCt.dat")
    assert len(suffixes) == 7  # six predictions and _CSA_opt.dat
    for s in suffixes:
        assert (files / ("mesh" + s)).read_bytes() == (files / ("plain" + s)).read_bytes(), s
    np.testing.assert_allclose(ranks[0]["final"][:2], [plain["diso"], plain["aniso"]],
                               rtol=1e-12)


def test_only_rank_zero_writes_and_ranks_agree(files, runs):
    """The mesh run wrote the unsharded run's files, none empty, and every
    rank fitted the same bits."""
    ranks, _ = runs
    plain = sorted(p.name[len("plain"):] for p in files.glob("plain_*"))
    assert ranks[0]["mine"] == ["mesh" + s for s in plain]
    assert all((files / f).stat().st_size > 0 for f in ranks[0]["mine"])
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["final"], ranks[0]["final"])


def test_runall_devices_matches_unsharded(tmp_path):
    """run-all -stream 2 -devices 2 (the C(t) stream and the C(t) fits
    over 2 ranks, the other steps on rank 0) writes the files of the
    unsharded run, their C(t) within float32 rounding (the ranks sum
    different chunks) and the same Diso."""
    ref, xtc, _ = synthetic_system(tmp_path, n_res=4, n_frames=1600, dt=1.0, seed=11)
    (tmp_path / "mesh").mkdir()
    (tmp_path / "flat").mkdir()
    got = spawn(workers.runall_checks, 2, str(tmp_path / "mesh"), xtc, ref, device="cpu",
                timeout=TIMEOUT)
    cfg = tconfig.WorkflowConfig(
        io=tconfig.IOParams(outpref="rotdif", traj=xtc, refpdb=ref, qfile="colvar-qorient",
                            stream_groups=2),
        tumbling=tconfig.TumblingParams(tau_mem=400.0, num_chunks=4),
        experiments=tconfig.ExperimentParams(bfields_mhz=(600.133,)))
    with _in_dir(tmp_path / "flat"):
        want = trunall.run_workflow(cfg, device="cpu")
    names = sorted(os.listdir(tmp_path / "flat"))
    assert sorted(os.listdir(tmp_path / "mesh")) == names
    for r in got:
        assert r["diso"] == want["diso"] and r["dani"] == want["dani"]
    for suffix in ("_Ctint.dat", "_Ctext.dat"):
        fn = "rotdif-0.4ns" + suffix
        a = xvg.load_sxydylist(str(tmp_path / "mesh" / fn), "legend")
        b = xvg.load_sxydylist(str(tmp_path / "flat" / fn), "legend")
        assert a[0] == b[0]
        np.testing.assert_allclose(np.asarray(a[2]), np.asarray(b[2]), rtol=0, atol=1e-6)
    for fn in ("rotdif-0.4ns-600_R1.dat", "rotdif-0.4ns_S2.dat", "colvar-qorient"):
        assert (tmp_path / "mesh" / fn).stat().st_size > 0, fn


def _exit_message(fn, argv):
    with pytest.raises(SystemExit) as e:
        fn(argv)
    return str(e.value.code)


def test_devices_error_exits_match_jax(files):
    """--devices without --split (ct) and without --opt (multifield) exit
    with the JAX package's messages, and stage_multifield(devices=) with
    no opt_params raises as the JAX stage does (the port's before reading
    a file, the JAX package's after)."""
    ct = ["ct", "-s", "absent.pdb", "-f", "absent.xtc", "-t", "100", "--devices", "2"]
    mf = ["multifield", str(files / "expt_0.dat"), "-f", str(files / "in_fittedCt.dat"),
          "--tau", "4000", "--devices", "2", "-o", str(files / "nofit")]
    for argv in (ct, mf):
        want = _exit_message(jcli.main, argv)
        assert "--devices" in want
        assert _exit_message(lambda a: tcli.main(a, device="cpu"), argv) == want
    with pytest.raises(ValueError, match="opt_params/--opt"):
        jstages.stage_multifield(str(files / "in_fittedCt.dat"), [str(files / "expt_0.dat")],
                                 str(files / "bad"), JDiff.isotropic(diso=4e-5), devices=4)
    with pytest.raises(ValueError, match="opt_params/--opt"):
        stage_multifield("absent_fittedCt.dat", ["absent.dat"], str(files / "bad"),
                         Diffusion.isotropic(diso=4e-5), devices=4, device="cpu")
    assert not list(files.glob("nofit*")) and not list(files.glob("bad*"))


def test_dryrun_multichip_prints_ok(capsys):
    line = dryrun_multichip(8)
    assert capsys.readouterr().out.strip() == line
    assert line.startswith("dryrun_multichip OK: mesh (4, 2) axes ('rep', 'res')")


def test_no_item15_raise_left():
    """Only fit_ct_ladder's pipeline_rungs raise NotImplementedError, on
    purpose; no source of the port says item 15 is not ported."""
    hits = []
    for p in sorted((REPO / "spinrelax_tpu_torch").rglob("*.py")):
        for i, line in enumerate(p.read_text().splitlines(), 1):
            if "NotImplementedError" in line or re.search(r"item 15", line):
                hits.append((p.relative_to(REPO).as_posix(), line.strip()))
    assert hits == [("spinrelax_tpu_torch/fit/expfit.py", "raise NotImplementedError(")]
