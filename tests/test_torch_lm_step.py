"""The plain versions of kernels D and E (ops.cuda_lm.step_solve_plain /
step_gate_plain, the LM step of fit.engine around kernels B and C) on the
CPU: the solve against the JAX package's own pieces in float64, the gates
against a step of the loop the engine ran before its step was split,
bit for bit.  Kernels D and E themselves run only on the GPU
(tests/test_torch_cuda.py).
"""

import os
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spinrelax_tpu.fit import lm as jlm
from spinrelax_tpu_torch import _build
from spinrelax_tpu_torch.fit import lm as tlm
from spinrelax_tpu_torch.ops import cuda_lm


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_state():
    """Clear jax's compiled-program caches before this module (see
    tests/test_review_fixes_r3.py); two torch threads per xdist worker."""
    jax.clear_caches()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(2)


def _solve_inputs(rng, B, P, dtype=np.float64):
    """Seeded SPD H_p (B, P, P), g_p, t, lam, lo, span; lane 1's H_p is
    negative definite (its damped A is not positive definite)."""
    M = rng.normal(size=(B, P, P)) / np.sqrt(P)
    H_p = M @ np.swapaxes(M, 1, 2) + np.eye(P)
    if B > 1:
        H_p[1] = -np.eye(P)
    g_p = rng.normal(size=(B, P))
    t = rng.uniform(-3.0, 3.0, (B, P))
    lam = 10.0 ** rng.uniform(-6.0, 0.0, B)
    lo = rng.uniform(0.0, 1.0, P)
    span = rng.uniform(0.5, 2.0, P)
    return [a.astype(dtype) for a in (H_p, g_p, t, lam, lo, span)]


def _jax_solve(H_p, g_p, t, lam, lo, span):
    """_engine_jit's body between hgc and cost, from the JAX package's own
    pieces: jax.nn.sigmoid, _chol_solve_small, _to_constrained."""
    H_p, g_p, t, lam, lo, span = map(jnp.asarray, (H_p, g_p, t, lam, lo, span))
    P = t.shape[1]
    s = jax.nn.sigmoid(t)
    D = span[None, :] * s * (1.0 - s)
    H = H_p * D[:, :, None] * D[:, None, :]
    g = g_p * D
    eye = jnp.eye(P, dtype=t.dtype)
    A = H + (lam[:, None, None] * eye
             * jnp.maximum(jnp.diagonal(H, axis1=1, axis2=2), 1e-12)[:, None, :] * eye)
    step = -jlm._chol_solve_small(A, g)
    t_new = t + step
    p = jlm._to_constrained(t_new, lo, lo + span)
    return tuple(np.asarray(a) for a in (t_new, p, step))


@pytest.mark.parametrize("P", [1, 3, 5, 9, 17, 33])
def test_step_solve_plain_matches_jax_f64(rng, P):
    """Kernel D's plain version equals the JAX engine's solve in float64
    (rtol 1e-12): t_new, kernel C's trial parameters, max |step|, ||step||
    and ||t||; a non-positive-definite A gives NaN in both; live is
    cleared."""
    B = 24
    args = _solve_inputs(rng, B, P)
    live = torch.tensor(True)
    t_new, pt, stats = cuda_lm.step_solve_plain(*map(torch.from_numpy, args), live)
    jt, jp, jstep = _jax_solve(*args)
    assert not bool(live)
    assert t_new.shape == (B, P) and pt.shape == (P, B) and stats.shape == (3, B)
    assert pt.is_contiguous()
    np.testing.assert_allclose(t_new.numpy(), jt, rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(pt.numpy(), jp.T, rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(stats[0].numpy(), np.max(np.abs(jstep), axis=1), rtol=1e-12)
    np.testing.assert_allclose(stats[1].numpy(), np.linalg.norm(jstep, axis=1), rtol=1e-12)
    np.testing.assert_allclose(stats[2].numpy(), np.linalg.norm(args[2], axis=1), rtol=1e-12)
    if B > 1:  # lane 1: A not positive definite
        assert np.isnan(jt[1]).all() and torch.isnan(t_new[1]).all()
        assert torch.isnan(stats[0, 1]) and torch.isnan(stats[1, 1])
    assert np.isfinite(jt[0]).all() and torch.isfinite(t_new[0]).all()


def _old_gate(c_new, c_old, t_new, step_v, t, lam, it, c_best, c_mark, done, lo, hi, max_iter):
    """The gates of fit.engine's loop before its step was split: a literal
    copy of the loop body after kernel C (tests/test_torch_lm.py's
    _old_engine), returning the next state, B's next parameters and the
    branch of each gate."""
    f = t.dtype
    eps = torch.finfo(f).eps
    ftol = 10.0 * eps
    xtol = 1e-10
    xtol_rel = float(np.sqrt(eps))
    stall_window = 8
    lam0 = 1e-3
    lam_stuck = 1e6
    improved = (c_new < c_old) & torch.isfinite(c_new)
    t_next = torch.where(improved[:, None], t_new, t)
    lam_next = torch.where(improved, torch.clamp(lam * 0.33, min=1e-12),
                           torch.clamp(lam * 3.0, max=1e10))
    small = torch.amax(torch.abs(step_v), dim=1) < xtol
    flat = improved & ((c_old - c_new) <= ftol * c_old)
    small_rel = improved & (lam <= lam0) & (
        torch.linalg.vector_norm(step_v, dim=1)
        < xtol_rel * (xtol_rel + torch.linalg.vector_norm(t, dim=1))
    )
    c_best_next = torch.minimum(
        torch.minimum(c_best, torch.where(torch.isfinite(c_old), c_old, c_best)),
        torch.where(torch.isfinite(c_new), c_new, c_best),
    )
    at_window = (it + 1) % stall_window == 0
    stalled = (
        at_window & torch.isfinite(c_mark) & (lam_next <= 100.0 * lam0)
        & ((c_mark - c_best_next) <= stall_window * ftol * c_best_next)
    )
    c_mark = torch.where(at_window, c_best_next, c_mark)
    c_best = c_best_next
    stuck = lam_next >= lam_stuck
    done_next = (done | (improved & small) | flat | small_rel | stalled | stuck)
    t = torch.where(done[:, None], t, t_next)
    lam = torch.where(done, lam, lam_next)
    it = torch.where(done, it, it + 1)
    pt = tlm._to_constrained(t, lo, hi).T.contiguous()
    branches = dict(improved=improved, small=improved & small, flat=flat, small_rel=small_rel,
                    stalled=stalled, stuck=stuck)
    return (t, lam, it, c_best, c_mark, done_next, pt), {
        k: v & ~done for k, v in branches.items()}


def _gate_state(rng, B, P, dtype):
    """A state that reaches every gate: steps from 1e-13 to 1, cost changes
    of either sign from a few ulp to 1e-3, NaN and inf trial costs, lam
    from 1e-13 to 1e7 (lam0 itself on some lanes), every phase of the
    stall window, a fifth of the lanes done."""
    eps = np.finfo(dtype).eps
    t = rng.uniform(-4.0, 4.0, (B, P))
    step_v = (10.0 ** rng.uniform(-13.0, 0.0, (B, 1))) * rng.normal(size=(B, P))
    t_new = t + step_v
    c_old = rng.uniform(1.0, 100.0, B)
    rel = rng.choice([-1e-3, -3 * eps, -30 * eps, 0.0, 1e-3], B)
    c_new = c_old * (1.0 + rel)
    c_new[rng.uniform(size=B) < 0.05] = np.nan
    c_new[rng.uniform(size=B) < 0.05] = np.inf
    lam = 10.0 ** rng.uniform(-13.0, 7.0, B)
    lam[rng.uniform(size=B) < 0.2] = 1e-3
    it = rng.integers(0, 59, B).astype(np.int32)
    c_best = c_old * rng.choice([1.0, 1.0 + 1e-4], B)
    c_best[rng.uniform(size=B) < 0.05] = np.inf
    c_mark = c_best * rng.choice([1.0, 1.0 + 3 * eps, 1.1], B)
    c_mark[rng.uniform(size=B) < 0.1] = np.inf
    done = rng.uniform(size=B) < 0.2
    arrays = [np.ascontiguousarray(a, dtype=dtype)
              for a in (c_new, c_old, t_new, step_v, t, lam, c_best, c_mark)]
    return [torch.from_numpy(a) for a in arrays] + [torch.from_numpy(it), torch.from_numpy(done)]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_step_gate_plain_equals_a_step_of_the_old_loop(rng, dtype):
    """Kernel E's plain version, given the plain solve's outputs, writes the
    state the old loop's step computed, bit for bit (NaN == NaN): t, lam,
    it and done on every lane, c_best and c_mark on every lane not already
    done (the old loop went on updating them there; nothing reads them),
    and B's next parameters equal to the old loop's recomputation from t;
    live as the old loop's condition.  Every gate fires on some lane."""
    B, P, max_iter = 4000, 5, 60
    c_new, c_old, t_new, step_v, t, lam, c_best, c_mark, it, done = _gate_state(
        rng, B, P, dtype)
    lo = torch.tensor([0.0, 0.0, 1e-8, 1e-8, 0.0], dtype=t.dtype)
    hi = torch.tensor([1.0, 1.0, 5000.0, 5000.0, 1.0], dtype=t.dtype)
    span = hi - lo
    want, branches = _old_gate(c_new, c_old, t_new, step_v, t, lam, it, c_best, c_mark,
                               done, lo, hi, max_iter)
    for name, fired in branches.items():
        assert int(fired.sum()) >= 5, name
    stats = torch.stack([torch.amax(torch.abs(step_v), dim=1),
                         torch.linalg.vector_norm(step_v, dim=1),
                         torch.linalg.vector_norm(t, dim=1)])
    pt = tlm._to_constrained(t, lo, hi).T.contiguous()
    pt_trial = (lo + span * tlm._sigmoid(t_new)).T.contiguous()
    state = tuple(x.clone() for x in (t, lam, it, c_best, c_mark, done)) + (torch.tensor(False),)
    gates = cuda_lm.Gates(max_iter=max_iter, window=8, xtol=1e-10,
                          ftol=10.0 * torch.finfo(t.dtype).eps,
                          xtol_rel=float(np.sqrt(torch.finfo(t.dtype).eps)), lam0=1e-3,
                          lam_stuck=1e6)
    cuda_lm.step_gate_plain(c_new, c_old, t_new, pt_trial, stats, state, pt, gates)

    def same(a, b):
        return torch.equal(torch.nan_to_num(a.double(), nan=-7.0),
                           torch.nan_to_num(b.double(), nan=-7.0))

    got = state[:6] + (pt,)
    was_live = ~done
    for name, a, b in zip(("t", "lam", "it", "c_best", "c_mark", "done", "pt"), got, want):
        if name in ("c_best", "c_mark"):
            assert same(a[was_live], b[was_live]), name
            assert same(a[done], (c_best, c_mark)[name == "c_mark"][done]), name
        else:
            assert a.dtype == b.dtype and same(a, b), name
    assert bool(state[6]) == bool(torch.any((want[2] < max_iter) & ~want[5]))


def _c_params(src: str, name: str):
    body = re.search(rf"int {name}\(([^)]*)\)", src).group(1)
    return [p.strip() for p in body.split(",")]


def test_step_kernels_c_signatures_match_ctypes():
    """The C entry points of csrc/lm_step.cu take, in order, what
    _build._SIGNATURES tells ctypes to pass (a pointer, int or float
    each), the source's P_MAX is the P of K = K_MAX with S2 free, and
    kernel D's lane groups (at most G_MAX threads, each owning at most
    ROWS rows) stay inside one warp and cover P_MAX rows."""
    src = (Path(_build.CSRC) / "lm_step.cu").read_text()
    kinds = {_build._P: "*", _build._I: "int ", _build._F: "float "}
    for name in ("lm_step_solve_f32", "lm_step_gate_f32"):
        params = _c_params(src, name)
        sig = _build._SIGNATURES[name]
        assert len(params) == len(sig), name
        for p, c in zip(params, sig):
            assert kinds[c] in p, (name, p)
    assert f"constexpr int P_MAX = {cuda_lm.n_par(cuda_lm.K_MAX, True)};" in src
    g_max, rows = (int(re.search(rf"constexpr int {n} = (\d+);", src).group(1))
                   for n in ("G_MAX", "ROWS"))
    assert g_max <= 32 and rows * g_max >= cuda_lm.n_par(cuda_lm.K_MAX, True)


def test_step_dispatch_takes_the_plain_route_on_the_cpu(rng):
    """step_solve / step_gate on CPU tensors are the plain versions (no
    launch counted); the engine's step on the CPU is B, D, C, E in their
    plain versions."""
    args = [torch.from_numpy(a) for a in _solve_inputs(rng, 6, 5, np.float32)]
    before = (cuda_lm.step_solve_cuda.launches, cuda_lm.step_gate_cuda.launches)
    a = cuda_lm.step_solve(*args, torch.tensor(True))
    b = cuda_lm.step_solve_plain(*args, torch.tensor(True))
    assert all(torch.equal(torch.nan_to_num(x, nan=-7.0), torch.nan_to_num(y, nan=-7.0))
               for x, y in zip(a, b))
    assert (cuda_lm.step_solve_cuda.launches, cuda_lm.step_gate_cuda.launches) == before
