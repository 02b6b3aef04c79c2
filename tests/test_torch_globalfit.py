"""The port's multi-field fit against spinrelax_tpu's, on the same seeded
numpy inputs, float64 on the CPU: the A-coefficient moments and G factors
(ops/jomega), the new-API and moment-collapsed rates (ops/observables),
ExperimentSet.build (models/experiments), golden_vec (fit/scalar), the
chi-square functions, their gradients and GlobalFitter (fit/globalfit).

Tolerances, each against the JAX function on the same inputs:
- closed-form values (moments, G, rates, chi-square, residuals): 1e-12
  relative, the two packages' float64 rounding;
- the ensemble sd and the collapsed path against the sample path: 1e-9
  relative (tests/test_moment_collapse.py's), an sd is a difference of
  near-equal sums;
- gradients: 1e-9 relative (autograd and jax.grad order their sums
  differently);
- golden_vec on a kinked objective: 1e-12 (its comparisons are exact);
- GlobalFitter.run: 'powell' within 1e-4 relative (its own xtol/ftol: a
  tie in a line search may send the packages down different paths),
  'gradient' and 'device' within 1e-6, and each package to the synthetic
  truth at tests/test_globalfit.py's tolerances.
"""

import dataclasses
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spinrelax_tpu.constants import NucleusPair as JPair
from spinrelax_tpu.constants import field_from_mhz
from spinrelax_tpu.fit import globalfit as jgf
from spinrelax_tpu.fit.scalar import golden_vec as jgolden
from spinrelax_tpu.io import experiments as jexp
from spinrelax_tpu.models import CtModelSet as JCts
from spinrelax_tpu.models import Diffusion as JDiff
from spinrelax_tpu.models.experiments import AlignedExperiment as JAligned
from spinrelax_tpu.models.experiments import ExperimentSet as JSet
from spinrelax_tpu.ops import jomega as jjw
from spinrelax_tpu.ops import observables as jobs
from spinrelax_tpu_torch.constants import NucleusPair as TPair
from spinrelax_tpu_torch.fit import globalfit as tgf
from spinrelax_tpu_torch.fit.scalar import golden_vec as tgolden
from spinrelax_tpu_torch.io import experiments as texp
from spinrelax_tpu_torch.models.ctmodel import CtModelSet as TCts
from spinrelax_tpu_torch.models.diffusion import Diffusion as TDiff
from spinrelax_tpu_torch.models.experiments import AlignedExperiment as TAligned
from spinrelax_tpu_torch.models.experiments import ExperimentSet as TSet
from spinrelax_tpu_torch.ops import jomega as tjw
from spinrelax_tpu_torch.ops import observables as tobs

GOLD = os.path.join(os.path.dirname(__file__), "golden")
RATES = ("R1", "R2", "NOE", "dR1", "dR2", "dNOE")


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_state():
    """Clear jax's compiled-program caches before this module (see
    tests/test_review_fixes_r3.py); two torch threads per xdist worker."""
    jax.clear_caches()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(2)


def _system(seed, n_res=6, n_samp=16, weighted=True, w_lo=0.5):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n_res, n_samp, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return dict(
        rng=rng,
        names=[str(i + 2) for i in range(n_res)],
        S2=rng.uniform(0.6, 0.9, n_res),
        C=rng.uniform(0.02, 0.1, (n_res, 2)),
        tau=np.stack([rng.uniform(5, 30, n_res), rng.uniform(100, 800, n_res)], -1),
        v=v,
        w=rng.uniform(w_lo, 2.0, (n_res, n_samp)) if weighted else None,
    )


def _cts(pkg, s, zeta=0.89):
    n = len(s["names"])
    args = (s["names"], s["S2"], list(s["C"]), list(s["tau"]))
    kw = dict(s2fast=[True] * n, zeta=zeta, sort=False)
    return JCts.from_lists(*args, **kw) if pkg == "jax" else TCts.from_lists(
        *args, device="cpu", **kw)


def _expts(s, diso, aniso, csa=None, fields=(600.133, 850.13), types=("R1", "R2", "NOE"),
           covered=None, err_floor=1e-3):
    """Experiment records at the truth (the JAX package's new-API rates),
    as ExperimentData keyword dicts."""
    cts = _cts("jax", s)
    diff = JDiff.axisymmetric(diso=diso, aniso=aniso)
    idx = np.arange(len(s["names"])) if covered is None else np.asarray(covered)
    out = []
    for f in fields:
        r = jobs.predict_rates_newapi(JPair(B0=field_from_mhz(f), time_unit="ps"), diff, cts,
                                      vecs=s["v"], weights=s["w"], csa=csa)
        for t in types:
            y = np.asarray(getattr(r, t))
            e = np.maximum(np.asarray(getattr(r, "d" + t)), err_floor)
            out.append(dict(expt_type=t, nuclei_a="15N", nuclei_b="1H", frequency=f,
                            freq_unit="MHz", names=np.array(s["names"])[idx],
                            values=y[idx].copy(), errors=e[idx].copy()))
    return out


def _sets(s, expts, diso, aniso, csa=None, kind="axisymmetric"):
    """The same experiments as a JAX and a port ExperimentSet."""
    out = []
    for pkg, Set, Exp, Diff in (("jax", JSet, jexp, JDiff), ("torch", TSet, texp, TDiff)):
        diff = (Diff.axisymmetric(diso=diso, aniso=aniso) if kind == "axisymmetric"
                else Diff.isotropic(diso=diso))
        out.append(Set.build([Exp.ExperimentData(**e) for e in expts], _cts(pkg, s), diff,
                             vecs=s["v"], weights=s["w"], csa=csa))
    return out


def _close(got, want, rtol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=0,
                               err_msg=what)


# ---------------------------------------------------------------------------
# ops/jomega, ops/observables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weighted", [True, False])
def test_moments_and_g_factors_match_jax(weighted):
    s = _system(1, n_res=9, n_samp=30, weighted=weighted)
    for a, b in zip(tjw.a_moments_symmtop(s["v"], s["w"]), jjw.a_moments_symmtop(s["v"], s["w"])):
        _close(a, b, 1e-12, "moments")
    omega = np.asarray(JPair(B0=field_from_mhz(700.13), time_unit="ps").omega5())
    jc, tc = _cts("jax", s), _cts("torch", s)
    for dpar, dperp in ((6e-5, 3e-5), (2e-5, 5e-5)):
        want = jjw.symmtop_g_factors(jnp.asarray(omega), dpar, dperp, jc.S2, jc.C, jc.tau,
                                     comp_mask=jc.mask, zeta=jc.zeta)
        got = tjw.symmtop_g_factors(torch.from_numpy(omega), torch.tensor(dpar, dtype=torch.float64),
                                    torch.tensor(dperp, dtype=torch.float64), tc.S2, tc.C, tc.tau,
                                    comp_mask=tc.mask, zeta=tc.zeta)
        _close(got, want, 1e-12, "G")


def test_newapi_golden():
    """tests/golden/newapi_relax.npz at test_observables.py's tolerances,
    through the sample path and the collapsed path."""
    g = np.load(os.path.join(GOLD, "newapi_relax.npz"))
    n = len(g["S2"])
    cts = TCts.from_lists([str(i + 2) for i in range(n)], g["S2"], list(g["consts"]),
                          list(g["taus"]), s2fast=[True] * n, zeta=float(g["zeta"]),
                          sort=False, device="cpu")
    pair = TPair(B0=field_from_mhz(600.133), time_unit="ps")
    diff = TDiff.axisymmetric(diso=float(g["Diso"]), aniso=float(g["aniso"]))
    sample = tobs.predict_rates_newapi(pair, diff, cts, vecs=g["vecs"], weights=g["weights"])
    mu_p, cov_p, mu_o, cov_o = tjw.a_moments_symmtop(g["vecs"], g["weights"])
    mu, cov = (mu_p, cov_p) if float(g["aniso"]) > 1.0 else (mu_o, cov_o)
    dpar, dperp = diff.dpar_dperp()
    G = tjw.symmtop_g_factors(torch.tensor(pair.omega5(), dtype=torch.float64), dpar, dperp,
                              cts.S2, cts.C, cts.tau, comp_mask=cts.mask, zeta=cts.zeta)
    fast = tobs.rates_from_a_moments_newapi(pair, G, torch.from_numpy(mu), torch.from_numpy(cov))
    for out in (sample, fast):
        for k, gk, tol in (("R1", "R1", 1e-8), ("R2", "R2", 1e-8), ("NOE", "NOE", 1e-8),
                           ("dR1", "R1err", 1e-7), ("dR2", "R2err", 1e-7),
                           ("dNOE", "NOEerr", 1e-7)):
            np.testing.assert_allclose(getattr(out, k).numpy(), g[gk], rtol=tol, err_msg=k)
    assert fast.drho is None


@pytest.mark.parametrize("aniso", [1.5, 0.7])
@pytest.mark.parametrize("weighted", [True, False])
def test_newapi_rates_match_jax_and_collapse(aniso, weighted):
    """predict_rates_newapi against JAX's (1e-12; sds 1e-9), the port's
    collapsed rates against its sample path (1e-9, atol 1e-12) and against
    JAX's collapsed rates (1e-12; sds 1e-9), prolate and oblate, with
    per-residue CSA; rates_from_j_newapi without an ensemble axis too."""
    s = _system(2, n_res=17, n_samp=40, weighted=weighted, w_lo=0.0)
    csa = s["rng"].uniform(-180e-6, -160e-6, 17)
    pair_j, pair_t = (P(B0=field_from_mhz(600.133), time_unit="ps") for P in (JPair, TPair))
    jc, tc = _cts("jax", s), _cts("torch", s)
    jd, td = JDiff.axisymmetric(diso=4e-5, aniso=aniso), TDiff.axisymmetric(diso=4e-5, aniso=aniso)
    want = jobs.predict_rates_newapi(pair_j, jd, jc, vecs=s["v"], weights=s["w"], csa=csa)
    got = tobs.predict_rates_newapi(pair_t, td, tc, vecs=s["v"], weights=s["w"], csa=csa)
    for k in RATES + ("rho", "drho"):
        _close(getattr(got, k), getattr(want, k), 1e-9 if k.startswith("d") else 1e-12, k)

    mus = tjw.a_moments_symmtop(s["v"], s["w"])
    mu, cov = (mus[0], mus[1]) if aniso > 1.0 else (mus[2], mus[3])
    dpar, dperp = td.dpar_dperp()
    omega = torch.tensor(pair_t.omega5(), dtype=torch.float64)
    G = tjw.symmtop_g_factors(omega, dpar, dperp, tc.S2, tc.C, tc.tau, comp_mask=tc.mask,
                              zeta=tc.zeta)
    fast = tobs.rates_from_a_moments_newapi(pair_t, G, torch.from_numpy(mu),
                                            torch.from_numpy(cov), csa=torch.from_numpy(csa))
    jdp, jdq = jd.dpar_dperp()
    jG = jjw.symmtop_g_factors(jnp.asarray(pair_j.omega5()), jdp, jdq, jc.S2, jc.C, jc.tau,
                               comp_mask=jc.mask, zeta=jc.zeta)
    jfast = jobs.rates_from_a_moments_newapi(pair_j, jG, mu, cov, csa=jnp.asarray(csa))
    for k in RATES:
        np.testing.assert_allclose(getattr(fast, k).numpy(), getattr(got, k).numpy(),
                                   rtol=1e-9, atol=1e-12, err_msg=k)
        _close(getattr(fast, k), getattr(jfast, k), 1e-9 if k.startswith("d") else 1e-12, k)
    _close(fast.rho, jfast.rho, 1e-12, "rho")
    assert fast.drho is None

    J1 = td.j_combined(omega, tc.S2, tc.C, tc.tau, mask=tc.mask, vecs=s["v"][:, 0])
    jJ1 = jd.j_combined(jnp.asarray(pair_j.omega5()), jc.S2, jc.C, jc.tau, mask=jc.mask,
                        vecs=s["v"][:, 0])
    one = tobs.rates_from_j_newapi(pair_t, J1, csa=torch.from_numpy(csa))
    jone = jobs.rates_from_j_newapi(pair_j, jJ1, csa=jnp.asarray(csa))
    for k in ("R1", "R2", "NOE", "rho"):
        _close(getattr(one, k), getattr(jone, k), 1e-12, k)
    assert one.dR1 is None


# ---------------------------------------------------------------------------
# models/experiments, fit/scalar
# ---------------------------------------------------------------------------

def test_experiment_set_build_matches_jax():
    """Duplicate and unmatched peaks: the same two warnings, masks, targets,
    errors, coverage and fields; a Hz and a T frequency unit; an
    experiment without errors."""
    s = _system(3, n_res=5)
    recs = [
        dict(expt_type="R1", nuclei_a="15N", nuclei_b="1H", frequency=600.133,
             freq_unit="MHz", names=np.array(["2", "3", "3", "99", "5"]),
             values=np.array([1.5, 1.6, 9.9, 2.0, 1.7]),
             errors=np.array([0.1, 0.2, 0.3, 0.4, 0.5])),
        dict(expt_type="NOE", nuclei_a="15N", nuclei_b="1H", frequency=850.13e6,
             freq_unit="Hz", names=np.array(["6", "4"]), values=np.array([0.7, 0.8]),
             errors=None),
        dict(expt_type="R2", nuclei_a="15N", nuclei_b="1H", frequency=16.4, freq_unit="T",
             names=np.array(["4", "100", "101"]), values=np.array([12.0, 1.0, 2.0]),
             errors=np.array([0.5, 0.5, 0.5])),
    ]
    sets, messages = [], []
    for pkg, Set, Exp in (("jax", JSet, jexp), ("torch", TSet, texp)):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            sets.append(Set.build([Exp.ExperimentData(**r) for r in recs], _cts(pkg, s),
                                  (JDiff if pkg == "jax" else TDiff).isotropic(diso=4e-5)))
        messages.append([str(w.message) for w in caught])
    assert messages[1] == messages[0] and len(messages[0]) == 3
    j, t = sets
    np.testing.assert_array_equal(t.coverage_counts(), j.coverage_counts())
    for a, b in zip(t.experiments, j.experiments):
        assert (a.expt_type, a.pair.B0, a.pair.isotope_a) == (b.expt_type, b.pair.B0,
                                                               b.pair.isotope_a)
        for k in ("target", "error", "mask"):
            if getattr(b, k) is None:
                assert getattr(a, k) is None
            else:
                np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    assert t.experiments[0].target[1] == 1.6  # the first duplicate wins
    with pytest.raises(ValueError, match="residue names differ"):
        TSet.build([], _cts("torch", s), TDiff.isotropic(diso=4e-5), vec_names=["1"])


def test_golden_vec_matches_jax():
    """A kinked objective s |c - x0|: its comparisons are exact in both
    packages, so the two searches take the same branches (1e-12)."""
    rng = np.random.default_rng(4)
    x0, sc = rng.uniform(-3, 3, 16), rng.uniform(0.5, 2.0, 16)
    lo, hi = x0 - rng.uniform(0.1, 2.0, 16), x0 + rng.uniform(0.1, 2.0, 16)
    want = jgolden(lambda c: sc * jnp.abs(c - x0), jnp.asarray(lo), jnp.asarray(hi))
    t0, tsc = torch.from_numpy(x0), torch.from_numpy(sc)
    got = tgolden(lambda c: tsc * torch.abs(c - t0), torch.from_numpy(lo), torch.from_numpy(hi))
    _close(got, want, 1e-12)
    _close(got, x0, 1e-10)


# ---------------------------------------------------------------------------
# fit/globalfit: the chi-square functions and their gradients
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["collapsed", "sample", "isotropic"])
def chi_sets(request):
    """Partial coverage (residues 4 and 7 uncovered), three fields, an
    experiment without errors, on the collapsed path, the per-sample path
    and the isotropic kind."""
    s = _system(5, n_res=7, n_samp=20)
    csa = s["rng"].uniform(-190e-6, -150e-6, 7)
    expts = _expts(s, 4e-5, 1.4, csa=csa, fields=(600.133, 700.13, 850.13),
                   covered=[0, 1, 3, 4, 6])
    expts[2]["errors"] = None
    expts[4]["values"] *= 1.03
    j, t = _sets(s, expts, 4.4e-5, 1.2,
                 kind="isotropic" if request.param == "isotropic" else "axisymmetric")
    return dict(jax=j, torch=t, path=request.param, n=7)



def _path(monkeypatch, path):
    """The per-sample path: the moment collapse off in both packages."""
    if path == "sample":
        monkeypatch.setattr(jgf, "USE_MOMENT_COLLAPSE", False)
        monkeypatch.setattr(tgf, "USE_MOMENT_COLLAPSE", False)


def _points(n_res, k=20, seed=6):
    rng = np.random.default_rng(seed)
    return [(rng.uniform(3e-5, 6e-5), rng.uniform(0.6, 1.8), rng.uniform(0.8, 1.0),
             rng.uniform(-200e-6, -140e-6, n_res)) for _ in range(k)]


def test_chisq_functions_match_jax(chi_sets, monkeypatch):
    """chisq_total, residuals_total and chisq_per_residue at 20 random
    points (prolate and oblate) against JAX's, and chisq_total ==
    sum(residuals^2) within 1e-12.

    1e-12 relative on the sample path and the isotropic kind (residuals:
    1e-12 of the vector's largest, as an element near 0 is a difference of
    near-equal v and t).  The collapsed path holds 1e-10: its error bar is
    sqrt(r^T cov r), and cov's rows sum to ~0 (the three A coefficients
    sum to 1 for every vector), so the product cancels and the two
    packages' roundings of it differ by up to ~2e-11 relative in the sd
    (the values themselves agree exactly)."""
    _path(monkeypatch, chi_sets["path"])
    j, t = chi_sets["jax"], chi_sets["torch"]
    tol = 1e-10 if chi_sets["path"] == "collapsed" else 1e-12
    for d, a, z, c in _points(chi_sets["n"]):
        targs = [torch.tensor(x, dtype=torch.float64) for x in (d, a, z)] + [torch.from_numpy(c)]
        for name in ("chisq_total", "chisq_per_residue"):
            want = getattr(jgf, name)(j, d, a, z, jnp.asarray(c))
            _close(getattr(tgf, name)(t, *targs), want, tol, name)
        r = tgf.residuals_total(t, *targs)
        jr = np.asarray(jgf.residuals_total(j, d, a, z, jnp.asarray(c)))
        np.testing.assert_allclose(r.numpy(), jr, rtol=0, atol=tol * np.abs(jr).max())
        _close(torch.sum(r * r), tgf.chisq_total(t, *targs), 1e-12, "sum r^2")


def test_chisq_gradients_match_jax(chi_sets, monkeypatch):
    """autograd of chisq_total with respect to (diso, aniso, zeta, csa)
    against jax.grad, 1e-9 relative, finite."""
    _path(monkeypatch, chi_sets["path"])
    j, t = chi_sets["jax"], chi_sets["torch"]
    jgrad = jax.grad(lambda *p: jgf.chisq_total(j, *p), argnums=(0, 1, 2, 3))
    for d, a, z, c in _points(chi_sets["n"], k=5, seed=7):
        want = jgrad(d, a, z, jnp.asarray(c))
        p = [torch.tensor(x, dtype=torch.float64, requires_grad=True) for x in (d, a, z)]
        p.append(torch.tensor(c, requires_grad=True))
        # the isotropic kind does not use aniso: its gradient is 0, as JAX's
        got = torch.autograd.grad(tgf.chisq_total(t, *p), p, allow_unused=True,
                                  materialize_grads=True)
        for g, w in zip(got, want):
            assert torch.isfinite(g).all()
            _close(g, w, 1e-9, "gradient")


@pytest.mark.parametrize("path", ["collapsed", "sample"])
def test_zero_variance_ensemble_keeps_gradients_finite(path, monkeypatch):
    """A residue whose ensemble collapses to one vector (zero variance):
    the gradient stays finite and equals JAX's (1e-9)
    (test_moment_collapse.py's case)."""
    _path(monkeypatch, path)
    s = _system(8, n_res=5, n_samp=7)
    s["v"][2] = s["v"][2, :1]
    pair_j, pair_t = (P(B0=field_from_mhz(600.133), time_unit="ps") for P in (JPair, TPair))
    jc, tc = _cts("jax", s), _cts("torch", s)
    jd = JDiff.axisymmetric(diso=4e-5, aniso=1.3)
    rates = jobs.predict_rates_newapi(pair_j, jd, jc, vecs=s["v"], weights=s["w"])
    target = np.asarray(rates.R1) * 1.01
    error = np.abs(np.asarray(rates.dR1)) + 1e-3
    mask = np.ones(5)
    j = JSet(experiments=[JAligned("R1", pair_j, target, error, mask)], cts=jc, diffusion=jd,
             vecs=s["v"], weights=s["w"])
    t = TSet(experiments=[TAligned("R1", pair_t, target, error, mask)], cts=tc,
             diffusion=TDiff.axisymmetric(diso=4e-5, aniso=1.3), vecs=s["v"], weights=s["w"])
    csa = np.full(5, pair_j.csa_value)
    want = jax.grad(lambda d: jgf.chisq_total(j, d, 1.3, 0.89, jnp.asarray(csa)))(4e-5)
    d = torch.tensor(4e-5, dtype=torch.float64, requires_grad=True)
    (got,) = torch.autograd.grad(tgf.chisq_total(t, d, 1.3, 0.89, csa), d)
    assert np.isfinite(float(want)) and torch.isfinite(got)
    _close(got, want, 1e-9)


# ---------------------------------------------------------------------------
# fit/globalfit: GlobalFitter.run
# ---------------------------------------------------------------------------

TRUE_DISO, TRUE_ANISO = 4e-5, 1.5
# opt vars -> (start Diso, start Daniso, fields, types, rsCSA truth?, n_res),
# tests/test_globalfit.py's setups and starts
CASES = {
    "Diso": (4.8e-5, 1.5, (600.133, 850.13), ("R1", "R2", "NOE"), False, 8),
    "Diso,Daniso": (5e-5, 1.2, (600.133, 850.13), ("R1", "R2", "NOE"), False, 8),
    "rsCSA": (4e-5, 1.5, (600.133, 850.13), ("R1", "R2"), True, 6),
    "Diso,rsCSA": (4.6e-5, 1.5, (600.133, 750.13, 850.13), ("R1", "R2", "NOE"), True, 5),
}


@pytest.fixture(scope="module")
def fitters():
    """One JAX GlobalFitter per variable set (each compiles its own
    closures), shared by the methods; the port builds its own."""
    cache = {}

    def get(name):
        if name not in cache:
            d0, a0, fields, types, rscsa, n_res = CASES[name]
            s = _system(9, n_res=n_res)
            csa = s["rng"].uniform(-190e-6, -150e-6, n_res) if rscsa else None
            expts = _expts(s, TRUE_DISO, TRUE_ANISO, csa=csa, fields=fields, types=types)
            j, t = _sets(s, expts, d0, a0)
            jfit = jgf.GlobalFitter(j, name.split(","))
            cache[name] = dict(jfit=jfit, start=dataclasses.replace(
                jfit.state, csa=jfit.state.csa.copy()), tset=t, csa=csa)
        return cache[name]

    return get


# L-BFGS-B is unbounded: from these Diso starts its first step takes Diso
# below 0 in both packages (a chisq minimum of the negative branch), so
# there the port is held to JAX only, and JAX is shown to miss the truth.
JAX_MISSES_TRUTH = {("gradient", "Diso"), ("gradient", "Diso,rsCSA")}


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("method", ["powell", "gradient", "device"])
def test_global_fitter_matches_jax_and_truth(fitters, name, method):
    """GlobalFitter.run against JAX's from the same start (Powell 1e-4,
    gradient and device 1e-6 relative; CSA to that share of its largest
    magnitude, as a CSA the fit drives to ~0 is 0 up to rounding) and
    against the truth."""
    c = fitters(name)
    jfit = c["jfit"]
    jfit.state = dataclasses.replace(c["start"], csa=c["start"].csa.copy())
    kw = dict(max_cycles=10, tol=1e-8) if name == "Diso,rsCSA" else {}
    want = jfit.run(method=method, **kw)
    tfit = tgf.GlobalFitter(c["tset"], name.split(","))
    got = tfit.run(method=method, **kw)
    rtol = 1e-4 if method == "powell" else 1e-6
    for k in ("diso", "aniso", "zeta"):
        _close(getattr(got, k), getattr(want, k), rtol, k)
    np.testing.assert_allclose(got.csa, want.csa, rtol=rtol,
                               atol=rtol * np.abs(want.csa).max(), err_msg="csa")
    assert np.isfinite(got.chisq)
    if (method, name) in JAX_MISSES_TRUTH:
        assert want.diso < 0
        return
    # the truth, at tests/test_globalfit.py's tolerances
    if name.startswith("Diso"):
        _close(got.diso, TRUE_DISO, 1e-4 if (name, method) == ("Diso", "powell") else 1e-3)
    if name == "Diso,Daniso":
        _close(got.aniso, TRUE_ANISO, 1e-2)
    if c["csa"] is not None:
        _close(got.csa, c["csa"], 5e-3 if name == "Diso,rsCSA" else 1e-3, "csa truth")
    if method == "device" and name != "rsCSA":
        assert tfit.counts["lm_steps"] % tgf.LM_WINDOW == 0 and tfit.counts["lm_iterations"] > 0


def test_partial_coverage_keeps_uncovered_csa():
    """rsCSA with residues 4 and 8 uncovered: the covered recover the truth
    (1e-3), the uncovered keep their start exactly, as in JAX."""
    s = _system(10, n_res=6)
    csa_true = s["rng"].uniform(-190e-6, -150e-6, 6)
    expts = _expts(s, 4e-5, 1.5, csa=csa_true, types=("R1", "R2"), covered=[0, 1, 3, 5])
    start = np.full(6, -170e-6)
    j, t = _sets(s, expts, 4e-5, 1.5, csa=start)
    want = jgf.GlobalFitter(j, ["rsCSA"]).run()
    got = tgf.GlobalFitter(t, ["rsCSA"]).run()
    _close(got.csa[[0, 1, 3, 5]], csa_true[[0, 1, 3, 5]], 1e-3)
    np.testing.assert_array_equal(got.csa[[2, 4]], start[[2, 4]])
    _close(got.csa, want.csa, 1e-6)


def test_lm_window_equals_step_by_step_loop():
    """The device LM read once per LM_WINDOW steps gives the same bits as
    the loop that reads its flag before every step; reads are counted."""
    s = _system(11, n_res=6)
    _j, t = _sets(s, _expts(s, TRUE_DISO, TRUE_ANISO), 5e-5, 1.2)
    fit = tgf.GlobalFitter(t, ["Diso", "Daniso"])
    tgf.host_reads.count = 0
    windowed = fit._lm(*fit._params())
    reads = tgf.host_reads.count
    eager = fit._lm(*fit._params(), _eager=True)
    n_it = int(windowed[2])
    assert 0 < n_it < tgf.LM_MAX_IT and reads == -(-n_it // tgf.LM_WINDOW)
    flat = [windowed[0], *windowed[1], windowed[2]]
    for a, b in zip(flat, [eager[0], *eager[1], eager[2]]):
        assert torch.equal(a, b)


def test_fitter_rejects_and_evaluates():
    s = _system(12, n_res=4)
    _j, t = _sets(s, _expts(s, TRUE_DISO, TRUE_ANISO), 4e-5, 1.5)
    with pytest.raises(ValueError, match="unknown optimisation variable"):
        tgf.GlobalFitter(t, ["Dfoo"])
    with pytest.raises(ValueError, match="both global CSA and rsCSA"):
        tgf.GlobalFitter(t, ["CSA", "rsCSA"])
    fit = tgf.GlobalFitter(t, [])
    before = fit.state.csa.copy()
    st = fit.run()
    np.testing.assert_array_equal(st.csa, before)
    assert st.chisq < 1e-20
