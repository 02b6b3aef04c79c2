"""The port's streamed finish against the JAX package's on the CPU, on the
same seeded numpy inputs: the physics it runs after the ladder (core.stats,
models.ctmodel, models.diffusion, ops.jomega, ops.observables), the state
carried across (convert), and parallel.streamed.run_finish against JAX
run_sharded_finish on a one-device mesh.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from spinrelax_tpu.constants import NucleusPair, field_from_mhz
from spinrelax_tpu.core import stats as jstats
from spinrelax_tpu.models.ctmodel import CtModelSet as JCts
from spinrelax_tpu.models.diffusion import Diffusion as JDiff
from spinrelax_tpu.ops import jomega as jjw
from spinrelax_tpu.ops import observables as jobs
from spinrelax_tpu.parallel.mesh import make_mesh
from spinrelax_tpu.parallel.streamed import ShardedCtStream, run_sharded_finish
from spinrelax_tpu_torch import convert
from spinrelax_tpu_torch.core import stats as tstats
from spinrelax_tpu_torch.entry import correlated_walk, finish_entry, paf_ensemble
from spinrelax_tpu_torch.models.ctmodel import CtModelSet
from spinrelax_tpu_torch.models.diffusion import Diffusion
from spinrelax_tpu_torch.ops import jomega as tjw
from spinrelax_tpu_torch.ops import observables as tobs
from spinrelax_tpu_torch.parallel.streamed import run_finish

GOLD = os.path.join(os.path.dirname(__file__), "golden")
PAIR = NucleusPair(B0=field_from_mhz(600.133), time_unit="ps")
KINDS = ("isotropic", "axisymmetric", "ellipsoid", "direct")


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_state():
    """Clear jax's compiled-program caches before this module (see
    tests/test_review_fixes_r3.py); two torch threads per xdist worker."""
    jax.clear_caches()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=float))


def _close(got, want, rtol=1e-12, atol=0.0, msg=""):
    got = got.cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=msg)


def _diffusions(kind):
    """(JAX, port) pair of one diffusion tensor of each kind (Daniso > 1
    and < 1 for the axisymmetric kind, through both of its constructors)."""
    if kind == "isotropic":
        return [(JDiff.isotropic(tau=4242.0), Diffusion.isotropic(tau=4242.0))]
    if kind == "axisymmetric":
        return [(JDiff.axisymmetric(diso=4e-5, aniso=1.5), Diffusion.axisymmetric(diso=4e-5, aniso=1.5)),
                (JDiff.axisymmetric(dpar=3e-5, dperp=4.5e-5),
                 Diffusion.axisymmetric(dpar=3e-5, dperp=4.5e-5))]
    if kind == "ellipsoid":
        d = np.array([5.6e-5, 2.8e-5, 3.6e-5])
        return [(JDiff.ellipsoid(d), Diffusion.ellipsoid(d))]
    return [(JDiff.direct(), Diffusion.direct())]


def _models(rng, n=9, K=3):
    """Per-residue C(t) parameters with a ragged component mask."""
    S2 = rng.uniform(0.5, 0.9, n)
    C = rng.uniform(0.01, 0.1, (n, K))
    tau = rng.uniform(5.0, 900.0, (n, K))
    mask = (np.arange(K)[None] < rng.integers(1, K + 1, n)[:, None]).astype(float)
    return S2, C * mask, np.where(mask > 0, tau, 1.0), mask


def _unit(rng, shape):
    v = rng.normal(size=shape + (3,))
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def test_stats_match_jax(rng):
    vals, w = rng.normal(size=(5, 7)), rng.uniform(0.5, 2.0, (5, 7))
    for weights in (None, w, np.zeros((5, 7))):
        a = tstats.weighted_mean_std(_t(vals), None if weights is None else _t(weights))
        b = jstats.weighted_mean_std(vals, weights)
        for x, y in zip(a, b):
            _close(x, y)
    means, sig = rng.normal(size=(4, 6)), rng.uniform(0.1, 1.0, (4, 6))
    _close(tstats.simple_total_mean_square(_t(means), _t(sig)),
           jstats.simple_total_mean_square(means, sig))
    _close(tstats._safe_sqrt(_t([0.0, 4.0, -1.0])), [0.0, 2.0, 0.0])


def test_ctmodel_eval_golden():
    """CtModelSet.eval against tests/golden/ctmodel_eval.npz (the JAX
    suite's 1e-10)."""
    g = np.load(os.path.join(GOLD, "ctmodel_eval.npz"))
    n = len(g["S2"])
    cts = CtModelSet.from_lists([str(i + 2) for i in range(n)], g["S2"], list(g["consts"]),
                                list(g["taus"]), s2fast=[True] * n, zeta=float(g["zeta"]),
                                sort=False, device="cpu")
    _close(cts.eval(g["dt"]), g["curves"], rtol=1e-10)


def test_ctmodel_set_matches_jax(rng):
    """from_lists (ragged lists sorted fast to slow, padded), the
    properties, s2_fast, select and with_zeta, against JAX."""
    names = ["a", "b", "c", "d"]
    C_l = [rng.uniform(0.01, 0.1, k) for k in (1, 3, 2, 3)]
    t_l = [rng.uniform(1, 900, len(c)) for c in C_l]
    S2 = rng.uniform(0.5, 0.9, 4)
    kw = dict(s2fast=[True, False, True, False], zeta=0.89, dS2=S2 / 10,
              dC_list=[c / 10 for c in C_l], dtau_list=[t / 10 for t in t_l], chisq=S2 * 2)
    j = JCts.from_lists(names, S2, C_l, t_l, **kw)
    t = CtModelSet.from_lists(names, S2, C_l, t_l, device="cpu", **kw)
    for f in ("S2", "C", "tau", "mask", "zeta", "s2fast", "dS2", "dC", "dtau", "chisq"):
        _close(getattr(t, f), getattr(j, f), msg=f)
    assert (t.n_models, t.max_comps, t.names) == (j.n_models, j.max_comps, j.names)
    _close(t.n_comps(), j.n_comps())
    _close(t.s2_fast(), j.s2_fast())
    dt = np.arange(1.0, 50.0)
    _close(t.eval(dt), j.eval(dt))
    for idx in ([2, 0], np.array([True, False, False, True])):
        a, b = t.select(idx), j.select(idx)
        assert a.names == b.names
        _close(a.C, b.C)
    _close(t.with_zeta(0.5).eval(dt), j.with_zeta(0.5).eval(dt))


def test_ad_coefficients_golden():
    """The symmetric-top and ellipsoid A/D coefficients against
    tests/golden/ad_coeffs.npz (the JAX suite's 1e-12)."""
    g = np.load(os.path.join(GOLD, "ad_coeffs.npz"))
    _close(tjw.d_coefficients_symmtop(float(g["Dpar"]), float(g["Dperp"])), g["DJ"])
    _close(tjw.a_coefficients_symmtop(_t(g["vecs"]), prolate=True), g["AJ_pro"])
    _close(tjw.a_coefficients_symmtop(_t(g["vecs"]), prolate=False), g["AJ_obl"])
    DJ5, delta = tjw.d_coefficients_ellipsoid(_t(g["D3"]))
    _close(DJ5, g["DJ5"])
    _close(delta, g["delta"])
    _close(tjw.a_coefficients_ellipsoid(_t(g["vecs"][:, 0]), delta), g["AJ5"])


def test_j_combine_symmtop_golden():
    """The axisymmetric combined J against tests/golden/jomega_relax.npz,
    prolate and oblate (the JAX suite's 1e-10)."""
    g = np.load(os.path.join(GOLD, "jomega_relax.npz"))
    for sfx in ("", "_oblate"):
        got = tjw.j_combine_symmtop(_t(g["omega"]), _t(g["vecs"]), float(g["Dpar" + sfx]),
                                    float(g["Dperp" + sfx]), _t(g["S2"])[:, None],
                                    _t(g["consts"])[:, None, :], _t(g["taus"])[:, None, :])
        _close(got, g["J_symm" + sfx], rtol=1e-10)


def test_jomega_functions_match_jax(rng):
    """The rigid-body J's, the direct transform, symmtop_from_diso_aniso
    and the two combined J's on scattered and masked inputs, float64, to
    1e-12."""
    om = np.asarray(PAIR.omega5())
    v = _unit(rng, (6, 4))
    S2, C, tau, mask = _models(rng, n=6)
    _close(tjw.j_rigid_sphere_D(om, 4e-5), jjw.j_rigid_sphere_D(om, 4e-5))
    _close(tjw.j_rigid_sphere_tau(om, 4242.0), jjw.j_rigid_sphere_tau(om, 4242.0))
    for dpar, dperp in ((6e-5, 3e-5), (2e-5, 5e-5)):
        _close(tjw.j_rigid_symmtop(om, _t(v), dpar, dperp), jjw.j_rigid_symmtop(om, v, dpar, dperp))
    D3 = np.array([2.8e-5, 3.6e-5, 5.6e-5])
    _close(tjw.j_rigid_ellipsoid(om, _t(v), D3), jjw.j_rigid_ellipsoid(om, v, D3))
    for m in (None, mask):
        mt = None if m is None else _t(m)
        _close(tjw.j_direct_transform(om, _t(C), _t(tau), mt), jjw.j_direct_transform(om, C, tau, m))
        _close(tjw.j_combine_ellipsoid(om, _t(v), D3, _t(S2)[:, None], _t(C)[:, None],
                                       _t(tau)[:, None], comp_mask=None if m is None else mt[:, None],
                                       zeta=0.9),
               jjw.j_combine_ellipsoid(om, v, D3, S2[:, None], C[:, None], tau[:, None],
                                       comp_mask=None if m is None else m[:, None], zeta=0.9))
    for a in (tjw.symmtop_from_diso_aniso(4e-5, 1.3), tjw.symmtop_from_diso_aniso(_t(4e-5), _t(0.7))):
        _close(torch.stack([torch.as_tensor(x, dtype=torch.float64) for x in a]),
               jjw.symmtop_from_diso_aniso(4e-5, float(a[0] / a[1])))


@pytest.mark.parametrize("kind", KINDS)
def test_j_combined_matches_jax(rng, kind):
    """Diffusion.j_combined for every kind, without and with a sample
    axis, without and with a component mask, float64 to 1e-12."""
    om = np.asarray(PAIR.omega5())
    S2, C, tau, mask = _models(rng)
    for jd, td in _diffusions(kind):
        for v in (_unit(rng, (9,)), _unit(rng, (9, 5))):
            for m in (None, mask):
                want = jd.j_combined(om, S2, C, tau, mask=m, vecs=v, zeta=0.89)
                got = td.j_combined(_t(om), _t(S2), _t(C), _t(tau),
                                    mask=None if m is None else _t(m), vecs=v, zeta=0.89)
                assert tuple(got.shape) == np.shape(want)
                _close(got, want)
        _close(td.tau_iso, jd.tau_iso)
        if kind != "direct":
            _close(torch.stack(list(td.dpar_dperp())), np.stack(jd.dpar_dperp()))
        if kind in ("isotropic", "axisymmetric", "ellipsoid"):
            v = _unit(rng, (9, 5))
            _close(td.j_rigid(om, v), jd.j_rigid(om, v))


def test_diffusion_rescale_and_refusal():
    """with_diso rescales the ellipsoid's principal values (shape kept);
    with_aniso refuses the ellipsoid and replaces the others'."""
    d3 = np.array([2.8e-5, 3.6e-5, 5.6e-5])
    t, j = Diffusion.ellipsoid(d3).with_diso(6e-5), JDiff.ellipsoid(d3).with_diso(6e-5)
    _close(t.dxyz, j.dxyz)
    _close(t.diso, j.diso)
    with pytest.raises(ValueError, match="ellipsoid"):
        Diffusion.ellipsoid(d3).with_aniso(1.2)
    a = Diffusion.axisymmetric(diso=4e-5, aniso=1.5).with_aniso(0.8).with_diso(5e-5)
    b = JDiff.axisymmetric(diso=4e-5, aniso=1.5).with_aniso(0.8).with_diso(5e-5)
    assert not bool(a.prolate) and not bool(b.prolate)
    _close(torch.stack(list(a.dpar_dperp())), np.stack(b.dpar_dperp()))


@pytest.mark.parametrize("kind", KINDS)
def test_predict_rates_matches_jax(rng, kind):
    """predict_rates (legacy per-sample NOE, weighted ensemble mean and
    sd) without and with weights, with the default, a scalar and a
    per-residue CSA, float64 to 1e-12; the state crosses by convert."""
    S2, C, tau, mask = _models(rng)
    jc = JCts.from_lists([str(i) for i in range(9)], S2, list(C), list(tau), sort=False)
    jc = dataclasses.replace(jc, mask=jc.mask * mask)
    tc = convert.ctmodel_from_numpy(**{f: np.asarray(getattr(jc, f)) for f in
                                       ("S2", "C", "tau", "mask", "zeta", "s2fast")},
                                    names=jc.names, device="cpu")
    v = _unit(rng, (9, 6))
    w = rng.uniform(0.5, 2.0, (9, 6))
    for jd, _ in _diffusions(kind):
        td = convert.diffusion_from_numpy(jd.kind, float(jd.diso), float(jd.aniso),
                                          None if jd.dxyz is None else np.asarray(jd.dxyz))
        for weights in (None, w):
            for csa in (None, -172e-6, rng.uniform(-180e-6, -160e-6, 9)):
                want = jobs.predict_rates(PAIR, jd, jc, vecs=v, weights=weights, csa=csa)
                got = tobs.predict_rates(PAIR, td, tc, vecs=_t(v),
                                         weights=None if weights is None else _t(weights),
                                         csa=csa)
                for f, a, b in zip(want._fields, got, want):
                    assert (a is None) == (b is None), f
                    if b is not None:
                        _close(a, b, rtol=1e-12, atol=1e-300, msg=f)


def _stream(n_chunks=8, n_frames=200, n_res=64, seed=3):
    """A JAX ShardedCtStream's float64 accumulators on a one-device mesh,
    filled from a seeded correlated walk in two groups."""
    chunks = correlated_walk(n_chunks, n_frames, n_res, seed=seed).astype(float)
    mesh = make_mesh(1)
    stream = ShardedCtStream(mesh, n_frames, n_res, dtype=np.float64)
    stream.update(chunks[:5])
    stream.update(chunks[5:])
    return mesh, stream.accumulators()


@pytest.mark.parametrize("kind", ["axisymmetric", "ellipsoid"])
def test_run_finish_matches_jax(kind):
    """run_finish(device="cpu") against JAX run_sharded_finish on a
    one-device mesh: the same float64 accumulators (n_res = 64), 16 PAF
    samples per residue, without and with weights and a per-residue CSA.
    C(t) to 1e-12; selection equal; rates and their errors to 1e-6 (the
    ladder's parameters agree to ~1e-8, test_torch_ladder.py)."""
    n_res = 64
    mesh, (acc_s, acc_s2, count) = _stream(n_res=n_res)
    vecs, weights = paf_ensemble(n_res, 16, seed=5)
    csa = np.random.default_rng(6).uniform(-180e-6, -160e-6, n_res)
    jd, td = _diffusions(kind)[0]
    acc = (torch.from_numpy(np.asarray(acc_s)[:n_res].T.copy()),
           torch.from_numpy(np.asarray(acc_s2)[:n_res].T.copy()), int(count))
    for w, c in ((None, None), (weights, csa)):
        want = run_sharded_finish(mesh, acc_s, acc_s2, count, n_res=n_res, delta_t=1.0,
                                  diffusion=jd, pair=PAIR, vecs=vecs, weights=w, csa=c,
                                  zeta=0.89)
        got = run_finish(*acc, n_res=n_res, delta_t=1.0, diffusion=td, pair=PAIR, vecs=vecs,
                         weights=w, csa=c, zeta=0.89)
        _close(got.Ct, want.Ct)
        _close(got.dCt, want.dCt, rtol=1e-10, atol=1e-14)
        np.testing.assert_array_equal(got.cts.mask.numpy(), np.asarray(want.cts.mask))
        for f in ("R1", "R2", "NOE", "rho", "dR1", "dR2", "dNOE", "drho"):
            _close(getattr(got, f), getattr(want, f), rtol=1e-6, atol=1e-12, msg=f)


def test_finish_entry_on_cpu():
    """entry.finish_entry runs the whole finish (here on the CPU): finite
    rates and errors for every residue, and a ladder selection."""
    out = finish_entry(device="cpu")
    assert out.Ct.shape == (32, 100) and out.cts.n_models == 32
    for f in ("R1", "R2", "NOE", "rho", "dR1", "dR2", "dNOE", "drho"):
        x = getattr(out, f)
        assert x.shape == (32,) and torch.isfinite(x).all(), f
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            finish_entry()
