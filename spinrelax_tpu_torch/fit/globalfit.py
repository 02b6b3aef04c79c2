"""Global parameter optimisation against multi-field experiments (port of
``spinrelax_tpu/fit/globalfit.py``).

Replaces the reference's optimisation machinery in
``spinRelaxationExperiments`` (spectral_densities.py:1217-1447): a
registry of optimisable globals {Diso, Daniso, zeta, CSA} plus the
residue-specific CSA (rsCSA) local stage, alternated until convergence.

The multi-experiment chi-square is one differentiable function of tensors
on the device of the set's C(t) models, in float64 on every device: every
experiment, every residue and (on the axisymmetric path) the vector
ensemble through its A-coefficient moments.  Three optimisers drive it:

- 'powell'  : scipy fmin_powell with the reference's diagonal step-size
  direction matrix (spectral_densities.py:1387-1397); one scalar read
  from the device per evaluation.
- 'gradient': L-BFGS-B on f and its gradient from one autograd backward,
  one read of (f, g) per iterate.
- 'device'  : Levenberg-Marquardt on the residual vector (chisq is a sum
  of squares) over the log-space positive parameters, its Jacobian from
  ``torch.func.jacfwd``.  One step is a fixed function of the state
  tensors that freezes the state once the loop's condition fails, so the
  host reads the stop flag once per ``LM_WINDOW`` steps and the result
  equals a loop that reads it every step, bit for bit.  With rsCSA each
  global+local cycle (the LM, then the bracket-expanding golden-section
  over all residues' CSA, one flag read a round) ends in one packed
  fetch (``_cycle_device``).

Every device-to-host read goes through :func:`host`, which counts them in
``host_reads.count``.  The rsCSA local stage is a batched golden-section
over all residues at once (the chi-square separates per residue),
replacing nResidues sequential scalar Powell runs
(spectral_densities.py:1371-1382).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..models.diffusion import AXISYMMETRIC, ISOTROPIC, Diffusion
from ..models.experiments import ExperimentSet
from ..ops import jomega as jw
from ..ops import observables as obs
from .lm import _chol_solve_small
from .scalar import golden_vec

# (half_width [CSA units], n_iter, max_expand) shared by
# GlobalFitter.local_step and the fused cycle, so the two rsCSA walks
# cannot drift apart.
_LOCAL_STEP_DEFAULTS = (150e-6, 60, 8)

ALLOWED_VARIABLES = ("Diso", "Daniso", "CSA", "zeta", "rsCSA")
# Moment-collapsed ensemble statistics for the axisymmetric fit (exact;
# see _eval_all).  Module-level so benchmarks can A/B the paths.
USE_MOMENT_COLLAPSE = True
# Powell step sizes (spectral_densities.py:1219)
STEP_SIZES = {"Diso": 1e-5, "Daniso": 0.1, "zeta": 0.1, "CSA": 1e-5, "rsCSA": 1e-5}
EXPORT_SCALING = {"Diso": 1.0, "Daniso": 1.0, "zeta": 1.0, "CSA": 1e6, "rsCSA": 1e6}
EXPORT_UNITS = {"Diso": "ps^-1", "Daniso": "a.u.", "zeta": "a.u.", "CSA": "ppm", "rsCSA": "ppm"}
LM_MAX_IT = 80  # the device LM's iteration cap
LM_WINDOW = 8  # LM steps between two reads of the stop flag

_F64 = torch.float64


class _Reads:
    """Counter of device-to-host reads (``count``)."""

    def __init__(self):
        self.count = 0


host_reads = _Reads()


def host(*xs):
    """The tensors ``xs`` as float64 numpy arrays, through one copy to the
    host (one read counted in ``host_reads``)."""
    host_reads.count += 1
    flat = torch.cat([x.detach().reshape(-1).to(_F64) for x in xs]).cpu().numpy()
    out, i = [], 0
    for x in xs:
        out.append(flat[i : i + x.numel()].reshape(tuple(x.shape)))
        i += x.numel()
    return out


@dataclasses.dataclass
class FitState:
    diso: float
    aniso: float
    zeta: float
    csa: np.ndarray  # (nRes,) residue-specific (may be uniform)
    chisq: float = np.nan


def _arg(x, dev):
    """A parameter as a float64 tensor on ``dev`` (a tensor already there
    passes through unchanged)."""
    if x is None:
        return None
    if torch.is_tensor(x):
        return x.to(device=dev, dtype=_F64)
    return torch.as_tensor(np.asarray(x, dtype=np.float64), device=dev)


def _eval_all(es: ExperimentSet, diso, aniso, zeta, csa):
    """Predicted (value, error) for every experiment, batched.

    Returns a list of (v (nRes,), e (nRes,) or None)."""
    kind = es.diffusion.kind
    if kind not in (ISOTROPIC, AXISYMMETRIC):
        raise ValueError(f"optimisation unsupported for kind {kind}")
    arr = es.device_arrays()
    dev = es.device
    diso, aniso, zeta, csa = (_arg(x, dev) for x in (diso, aniso, zeta, csa))
    cts = es.cts
    # One J evaluation over the stacked omega5 grids of all unique pairs:
    # the geometry (A) and decay (D) coefficients do not depend on the
    # field (the reference evaluates each experiment object separately,
    # spectral_densities.py:803-818).
    rates = []
    if (USE_MOMENT_COLLAPSE and kind == AXISYMMETRIC
            and arr.vecs is not None and arr.vecs.ndim == 3):
        # Moment-collapsed path: rates are linear in the per-sample A
        # coefficients, so the ensemble statistics follow from the A
        # moments -- O(nRes x 3) a call instead of O(nRes x nSamp)
        # (spectral_densities.py:751-763, 1710-1737).  Both branches'
        # moments are on the device; the branch is picked there, since
        # Daniso is a tensor the optimiser moves.
        mu_p, cov_p, mu_o, cov_o = es.symmtop_a_moments_device()
        dpar, dperp = jw.symmtop_from_diso_aniso(diso, aniso)
        prolate = dpar > dperp
        mu = torch.where(prolate, mu_p, mu_o)
        cov = torch.where(prolate, cov_p, cov_o)
        G_all = jw.symmtop_g_factors(arr.omega, dpar, dperp, cts.S2, cts.C, cts.tau,
                                     comp_mask=cts.mask, zeta=zeta)
        for i, p in enumerate(arr.pairs):
            rates.append(obs.rates_from_a_moments_newapi(
                p, G_all[..., 5 * i : 5 * (i + 1)], mu, cov, csa=csa))
    else:
        J_all = Diffusion(kind=kind, diso=diso, aniso=aniso).j_combined(
            arr.omega, cts.S2, cts.C, cts.tau, mask=cts.mask, vecs=arr.vecs, zeta=zeta)
        for i, p in enumerate(arr.pairs):
            rates.append(obs.rates_from_j_newapi(
                p, J_all[..., 5 * i : 5 * (i + 1)], weights=arr.weights, csa=csa))
    out = []
    for e, k in zip(es.experiments, arr.pair_of):
        r = rates[k]
        if e.expt_type == "R1":
            out.append((r.R1, r.dR1))
        elif e.expt_type == "R2":
            out.append((r.R2, r.dR2))
        elif e.expt_type == "NOE":
            out.append((r.NOE, r.dNOE))
        else:
            raise ValueError(f"unknown experiment type {e.expt_type!r}")
    return out


def _combined_weight(err, dv, like):
    """The reference's composite error weight dTarget^2 + dSim^2 with the
    both-absent -> 1.0 fallback (calc_chisq, spectral_densities.py:
    803-818), plus the nonpositive -> 1.0 clamp the reference applies only
    in its rsCSA inner objective (:1430-1447).  Extending the clamp to the
    global chi-square is a deliberate deviation: a zero error bar in an
    experiment file makes the reference's global objective inf.  The one
    home of this rule: chisq_total, residuals_total and chisq_per_residue
    must stay consistent (chisq_total == sum(residuals^2) is what the LM
    relies on; the rsCSA stage must weight like the global stage).

    ``err`` is the experiment's error tensor or None.  The clamp keeps the
    gradient finite: the unselected branch's gradient is multiplied by 0."""
    if err is not None and dv is not None:
        w = err**2 + dv**2
    elif err is not None:
        w = err**2
    elif dv is not None:
        w = dv**2
    else:
        w = torch.ones_like(like)
    return torch.where(w > 0, w, 1.0)


def chisq_total(es: ExperimentSet, diso, aniso, zeta, csa, reduce: bool = True):
    """Reference chi-square: per-experiment masked mean of
    (v-t)^2 / (dTarget^2 + dSim^2), summed over experiments / nExpt
    (spectral_densities.py:803-818, 1409-1413).  A 0-d tensor.

    Of a residue-sharded set, the sum over every rank; ``reduce=False``
    gives this rank's share of it instead (differentiable: the shares'
    gradients sum to the gradient)."""
    preds = _eval_all(es, diso, aniso, zeta, csa)
    arr = es.device_arrays()
    nums = []
    for (t, err, m), (v, dv) in zip(arr.targets, preds):
        sq = (v - t) ** 2
        w = _combined_weight(err, dv, sq)
        nums.append(torch.sum(m * sq / w))
    nums = torch.stack(nums)
    if reduce:
        nums = es.residue_sum(nums)
    total = 0.0
    for num, cnt in zip(nums, arr.counts):
        total = total + num / torch.clamp(cnt, min=1.0)
    return total / len(es.experiments)


def residuals_total(es: ExperimentSet, diso, aniso, zeta, csa):
    """Flat residual vector r with chisq_total == sum(r^2) (the masked
    per-experiment normalisation folded into each element): the
    least-squares form the device LM takes."""
    preds = _eval_all(es, diso, aniso, zeta, csa)
    n_e = len(es.experiments)
    arr = es.device_arrays()
    rs = []
    for (t, err, m), (v, dv), cnt in zip(arr.targets, preds, arr.counts):
        w = _combined_weight(err, dv, v)
        norm = torch.clamp(cnt, min=1.0) * n_e
        # sqrt(m/norm) does not depend on the parameters (w does): the
        # mask outside the w-bearing factor keeps the Jacobian of masked
        # entries exactly 0 instead of NaN.
        rs.append(torch.sqrt(m / norm) * ((v - t) / torch.sqrt(w)))
    return torch.cat(rs)


def chisq_per_residue(es: ExperimentSet, diso, aniso, zeta, csa):
    """Per-residue chi-square for the rsCSA local stage
    (optimisation_loop_rsCSA_inner_function, spectral_densities.py:
    1430-1447): mean over covering experiments of (v-t)^2 / (dv^2 + dt^2),
    weight 1 when both vanish."""
    preds = _eval_all(es, diso, aniso, zeta, csa)
    num = 0.0
    cnt = 0.0
    for (t, err, m), (v, dv) in zip(es.device_arrays().targets, preds):
        w = _combined_weight(err, dv, v)
        num = num + m * (v - t) ** 2 / w
        cnt = cnt + m
    return num / torch.clamp(cnt, min=1.0)


class GlobalFitter:
    """Drives the global/local optimisation loops
    (perform_optimisation, spectral_densities.py:1302-1382) on the device
    of the set's C(t) models.

    ``counts`` accumulates what the fit did: ``evaluations`` (objective
    calls of Powell, (f, g) calls of L-BFGS), ``lm_steps`` (steps the LM
    ran, frozen ones included), ``lm_iterations`` (steps that were live),
    ``golden_rounds`` and ``uploads`` (copies of the parameters to the
    device, one a Powell evaluation or L-BFGS iterate)."""

    def __init__(self, es: ExperimentSet, opt_vars: Sequence[str]):
        for v in opt_vars:
            if v not in ALLOWED_VARIABLES:
                raise ValueError(
                    f"unknown optimisation variable {v!r}; allowed: {ALLOWED_VARIABLES}"
                )
        if "CSA" in opt_vars and "rsCSA" in opt_vars:
            raise ValueError("cannot optimise both global CSA and rsCSA")
        self.es = es
        self.dev = es.device
        self.global_vars = [v for v in opt_vars if v != "rsCSA"]
        self.do_local = "rsCSA" in opt_vars
        self._idx = {v: i for i, v in enumerate(self.global_vars)}
        # The state's CSA covers every rank's residues; a sharded set's
        # rank uploads and fits its own slice of it.
        self._sl = slice(None)
        csa0 = es.csa
        if es.mesh is not None:
            from ..parallel.mesh import residue_sharding

            self._sl = residue_sharding(es.mesh, es.n_global)
            if csa0 is not None:
                csa0 = host(es.gather_residues(_arg(csa0, self.dev)))[0]
        if csa0 is None:
            csa0 = np.full(es.n_global, es.experiments[0].pair.csa_value)
        zeta = es.cts.zeta
        self.state = FitState(
            diso=float(np.asarray(es.diffusion.diso)),
            aniso=float(np.asarray(es.diffusion.aniso)),
            zeta=float(host(zeta)[0]) if torch.is_tensor(zeta) else float(zeta),
            csa=np.asarray(csa0, dtype=float).copy(),
        )
        self.counts = dict(evaluations=0, lm_steps=0, lm_iterations=0, golden_rounds=0,
                           uploads=0)

    # -- parameter packing ---------------------------------------------
    def _get_globals(self) -> np.ndarray:
        vals = []
        for v in self.global_vars:
            if v == "Diso":
                vals.append(self.state.diso)
            elif v == "Daniso":
                vals.append(self.state.aniso)
            elif v == "zeta":
                vals.append(self.state.zeta)
            elif v == "CSA":
                vals.append(float(np.mean(self.state.csa)))
        return np.array(vals)

    def _set_globals(self, x: np.ndarray):
        for v, val in zip(self.global_vars, x):
            if v == "Diso":
                self.state.diso = float(val)
            elif v == "Daniso":
                self.state.aniso = float(val)
            elif v == "zeta":
                self.state.zeta = float(val)
            elif v == "CSA":
                self.state.csa[:] = float(val)

    def _packed(self) -> torch.Tensor:
        """(diso, aniso, zeta, csa...) of the state on the device, in one
        copy (the csa of this rank's residues)."""
        s = self.state
        self.counts["uploads"] += 1
        return torch.as_tensor(np.concatenate([[s.diso, s.aniso, s.zeta], s.csa[self._sl]]),
                               dtype=_F64, device=self.dev)

    def _params(self):
        p = self._packed()
        return p[0], p[1], p[2], p[3:]

    def chisq(self) -> float:
        return float(host(chisq_total(self.es, *self._params()))[0])

    def _objective_np(self, x) -> float:
        self._set_globals(np.atleast_1d(np.asarray(x, dtype=float)))
        self.counts["evaluations"] += 1
        return self.chisq()

    # -- the device LM ------------------------------------------------------
    def _csa_mean(self, csa):
        """Mean of the CSA over every rank's residues."""
        if self.es.mesh is None:
            return torch.mean(csa)
        return self.es.residue_sum(torch.sum(csa)) / self.es.n_global

    def _unpack(self, z, d0, a0, zeta0, csa0, ref=None):
        """Positive parameters in log space (x = x0 e^z): z = 0 is the
        current value and positivity is structural.  CSA (sign-free) moves
        linearly in units of its magnitude (``ref``, the mean of csa0)."""
        idx = self._idx
        d = d0 * torch.exp(z[idx["Diso"]]) if "Diso" in idx else d0
        a = a0 * torch.exp(z[idx["Daniso"]]) if "Daniso" in idx else a0
        zz = zeta0 * torch.exp(z[idx["zeta"]]) if "zeta" in idx else zeta0
        if "CSA" in idx:
            ref = self._csa_mean(csa0) if ref is None else ref
            val = ref + z[idx["CSA"]] * torch.clamp(torch.abs(ref), min=1e-6)
            c = torch.zeros_like(csa0) + val
        else:
            c = csa0
        return d, a, zz, c

    def _lm(self, d0, a0, zeta0, csa0, _eager: bool = False):
        """Levenberg-Marquardt on ``residuals_total`` over the log-space
        globals from (d0, a0, zeta0, csa0), device tensors.  Returns the
        final chisq and parameters and the iteration count, on the device.

        ``step`` maps the state (z, lam, f, it, moved) to the next state
        and leaves it unchanged once the loop's condition (it < 80,
        lam < 1e10, moved > 1e-6) fails.  The host reads that condition
        once per LM_WINDOW steps; ``_eager`` (tests) reads it before
        every step instead, as a while loop does."""
        n_p = len(self._idx)
        eye = torch.eye(n_p, dtype=_F64, device=self.dev)
        es = self.es
        ref = self._csa_mean(csa0) if "CSA" in self._idx else None

        def resid(z):
            return residuals_total(es, *self._unpack(z, d0, a0, zeta0, csa0, ref))

        def resid_aux(z):
            r = resid(z)
            return r, r

        # jacfwd is vmap of jvp over the basis; with has_aux the residual
        # comes from the same primal evaluation.
        jac = torch.func.jacfwd(resid_aux, has_aux=True)

        def live_of(state):
            _z, lam, _f, it, moved = state
            return (it < LM_MAX_IT) & (lam < 1e10) & (moved > 1e-6)

        def step(state):
            z, lam, f, it, moved = state
            live = live_of(state)
            J, r = jac(z)  # (nR, n_p), (nR,) of this rank's residues
            Hg = es.residue_sum(torch.cat([J.T @ J, (J.T @ r)[:, None]], dim=1))
            H, g = Hg[:, :n_p], Hg[:, n_p]
            dz = _chol_solve_small(H + lam * eye, -g)
            z_new = z + dz
            r_new = resid(z_new)
            f_new = es.residue_sum(torch.sum(r_new * r_new))
            ok = f_new < f
            new = (
                torch.where(ok, z_new, z),
                torch.where(ok, lam * 0.25, lam * 4.0),
                torch.where(ok, f_new, f),
                it + 1,
                torch.where(ok, torch.amax(torch.abs(dz)), torch.full_like(f, float("inf"))),
            )
            return tuple(torch.where(live, b, a) for a, b in zip(state, new))

        z0 = torch.zeros(n_p, dtype=_F64, device=self.dev)
        r0 = resid(z0)
        f0 = es.residue_sum(torch.sum(r0 * r0))
        state = (z0, torch.full_like(f0, 1e-3), f0,
                 torch.zeros((), dtype=torch.int64, device=self.dev),
                 torch.full_like(f0, float("inf")))
        steps = 0
        if _eager:
            while bool(host(live_of(state))[0]):
                state = step(state)
                steps += 1
        else:
            while steps < LM_MAX_IT:
                for _ in range(LM_WINDOW):
                    state = step(state)
                steps += LM_WINDOW
                if not bool(host(live_of(state))[0]):
                    break
        self.counts["lm_steps"] += steps
        z, _lam, f, it, _moved = state
        return f, self._unpack(z, d0, a0, zeta0, csa0, ref), it

    def _solve_device(self, d0, a0, zeta0, csa0, _eager: bool = False):
        """The device LM from the given start; one packed read of its
        result: (chisq, {name: value}) on the host."""
        f, (d, a, z, c), it = self._lm(d0, a0, zeta0, csa0, _eager=_eager)
        h = host(torch.stack([f, d, a, z, c[0], it.to(_F64)]))[0]
        self.counts["lm_iterations"] += int(h[5])
        return float(h[0]), {"Diso": h[1], "Daniso": h[2], "zeta": h[3], "CSA": h[4]}

    def _golden_walk(self, d, a, z, csa0, half_width, n_iter, max_expand):
        """Batched rsCSA: golden-section over each residue's CSA in a
        bracket around ``csa0``; a residue whose minimiser lands within 1 %
        of a bracket edge is re-centred there with its half-width doubled,
        up to ``max_expand`` rounds (the reference's per-residue Powell is
        unbounded, so the bracket must not clamp a far-off optimum).  One
        flag read a round; returns the walk's result on the device
        (covered or not)."""
        covered = self.es.device_arrays().covered

        def f(c):
            return chisq_per_residue(self.es, d, a, z, c)

        hw = torch.full_like(csa0, half_width)
        best = csa0
        for r in range(max_expand):
            lo = best - hw
            hi = best + hw
            best = golden_vec(f, lo, hi, n_iter=n_iter)
            self.counts["golden_rounds"] += 1
            at_edge = torch.minimum(best - lo, hi - best) < 0.01 * hw
            if r == max_expand - 1:
                break
            n_edge = self.es.residue_sum(torch.sum(at_edge & covered))
            if not bool(host(n_edge)[0]):
                break
            hw = torch.where(at_edge, 2.0 * hw, hw)
        return best

    def _cycle_device(self, d0, a0, zeta0, csa0, _eager: bool = False):
        """One fused global+local cycle (method="device" with rsCSA): the LM
        on the globals, then the golden walk at its result; uncovered
        residues keep their CSA.  One packed read at the end:
        (diso, aniso, zeta, csa) on the host."""
        _f, (d1, a1, z1, _c), it = self._lm(d0, a0, zeta0, csa0, _eager=_eager)
        best = self._golden_walk(d1, a1, z1, csa0, *_LOCAL_STEP_DEFAULTS)
        csa1 = torch.where(self.es.device_arrays().covered, best, csa0)
        h = host(torch.stack([d1, a1, z1, it.to(_F64)]), self.es.gather_residues(csa1))
        self.counts["lm_iterations"] += int(h[0][3])
        return h[0][0], h[0][1], h[0][2], h[1]

    # -- optimisation stages --------------------------------------------
    def global_step(self, method: str = "powell") -> float:
        x0 = self._get_globals()
        if len(x0) == 0:
            return self.chisq()
        if method == "powell":
            from scipy.optimize import fmin_powell

            direc = np.diag([STEP_SIZES[v] for v in self.global_vars])
            out = fmin_powell(
                self._objective_np, x0=x0, direc=direc, full_output=True, disp=False
            )
            xbest, fbest = out[0], out[1]
        elif method == "gradient":
            from scipy.optimize import minimize

            which = {"Diso": 1, "Daniso": 2, "zeta": 3, "CSA": 4}

            def f_and_g(x):
                self._set_globals(np.atleast_1d(x))
                self.counts["evaluations"] += 1
                p = self._packed().requires_grad_(True)
                # this rank's share of chisq; the shares' gradients sum
                f = chisq_total(self.es, p[0], p[1], p[2], p[3:], reduce=False)
                (g,) = torch.autograd.grad(f, p)
                # dchi/dCSA_scalar = sum_i dchi/dcsa_i
                h = host(self.es.residue_sum(
                    torch.stack([f.detach(), g[0], g[1], g[2], torch.sum(g[3:])])))[0]
                return float(h[0]), np.array([h[which[v]] for v in self.global_vars])

            # Parameters scaled to O(1) for L-BFGS; jac=True takes (f, g)
            # from one evaluation.
            scales = np.array([abs(v) if abs(v) > 0 else 1.0 for v in x0], dtype=float)

            def fg_scaled(z):
                f, g = f_and_g(z * scales)
                return f, g * scales

            res = minimize(fg_scaled, x0 / scales, jac=True, method="L-BFGS-B")
            xbest, fbest = res.x * scales, res.fun
        elif method == "device":
            fbest, vals = self._solve_device(*self._params())
            xbest = np.array([vals[v] for v in self.global_vars])
        else:
            raise ValueError(f"unknown method {method!r}")
        self._set_globals(np.atleast_1d(xbest))
        self.state.chisq = float(fbest)
        return self.state.chisq

    def local_step(self, half_width: float = _LOCAL_STEP_DEFAULTS[0],
                   n_iter: int = _LOCAL_STEP_DEFAULTS[1],
                   max_expand: int = _LOCAL_STEP_DEFAULTS[2]):
        """Batched rsCSA golden-section walk (:meth:`_golden_walk`) from the
        current state: cumulative reach +-(2^max_expand - 1) half_width
        (~+-38 000 ppm at the defaults).  Residues with no experimental
        coverage keep their CSA (the reference skips them: nExpts>0
        check, :1375-1377)."""
        s = self.state
        d, a, z, csa0 = self._params()
        best = self._golden_walk(d, a, z, csa0, half_width, n_iter, max_expand)
        covered = self.es.gather_residues(self.es.device_arrays().covered)
        best, covered = host(self.es.gather_residues(best), covered)
        s.csa = np.where(covered > 0, best, s.csa)

    def run(
        self,
        max_cycles: int = 10,
        tol: float = 1e-6,
        method: str = "powell",
        verbose: bool = False,
    ) -> FitState:
        """Alternating global/local loop (perform_optimisation,
        spectral_densities.py:1302-1358)."""
        has_global = len(self.global_vars) > 0
        if not has_global and not self.do_local:
            # Nothing to optimise: evaluate only (no rsCSA pass).
            self.state.chisq = self.chisq()
            return self.state
        if has_global and not self.do_local:
            self.global_step(method)
            return self.state
        if self.do_local and not has_global:
            self.local_step()
            self.state.chisq = self.chisq()
            return self.state
        # method="device": the global+local cycle runs on the device with
        # one packed read; the host applies the reference's convergence
        # checks between cycles.
        fused = method == "device"
        first = True
        for n in range(max_cycles):
            prev_glob = self._get_globals()
            if fused:
                d1, a1, z1, csa1 = self._cycle_device(*self._params())
                vals = {"Diso": d1, "Daniso": a1, "zeta": z1}
                self._set_globals(np.array([vals[v] for v in self.global_vars]))
            else:
                self.global_step(method)
            now_glob = self._get_globals()
            # atol=0: allclose's default atol=1e-8 would dominate rtol for
            # the small-magnitude parameters here (Diso ~4e-5 ps^-1,
            # CSA ~1.7e-4) and stop the alternation early.
            if not first and np.allclose(prev_glob, now_glob, rtol=tol, atol=0.0):
                break
            prev_csa = self.state.csa.copy()
            if fused:
                self.state.csa = np.asarray(csa1, dtype=float).copy()
            else:
                self.local_step()
            if not first and np.allclose(prev_csa, self.state.csa, rtol=tol, atol=0.0):
                self.state.chisq = self.chisq()
                break
            first = False
            if verbose:
                print(f"    ...cycle {n}: chisq {self.chisq():.6g}")
        self.state.chisq = self.chisq()
        return self.state
