"""The port's CUDA kernels on the card, each against its plain version.

Needs an NVIDIA GPU and nvcc; every test skips without them.  The file
imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from spinrelax_tpu_torch.entry import (correlated_walk, finish_entry, hetero_cohort,
                                       workflow_entry)
from spinrelax_tpu_torch.fit.expfit import fit_ct_ladder
from spinrelax_tpu_torch.fit.lm import fit_multiexp
from spinrelax_tpu_torch.ops import autocorr as tac
from spinrelax_tpu_torch.ops import cuda_acf, cuda_lm
from spinrelax_tpu_torch.parallel.pipeline import make_forward

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(1234)


def _unit(shape, gen):
    v = torch.randn(shape + (3,), generator=gen, device="cuda")
    return v / v.norm(dim=-1, keepdim=True)


def _acf_input(layout, F, gen, n=None):
    """Kernel A's input in a layout of the main path, its bond count not a
    multiple of the kernel's bonds per block (but the whole pretiled tile):
    chunks (R, F, N, 3) seen as (R, N, F, 3); contiguous (B, F, 3); the
    pretiled (nTiles, 3, F, 128) seen as (nTiles, 128, F, 3), whole or cut
    to its first lanes (blocks straddle the tile boundary)."""
    if layout == "chunks":
        return _unit((3 if n is None else 1, F, n or 70), gen).transpose(1, 2)
    if layout == "contiguous":
        return _unit((n or 130, F), gen)
    v = tac.tile_palmer_group(_unit((2 if n is None else 1, F, n or 100), gen))
    v = v.permute(0, 3, 2, 1)
    return v if layout == "pretiled" else v[:, : n or 77]


@pytest.mark.parametrize("layout", ["chunks", "contiguous", "pretiled", "pretiled_cut"])
@pytest.mark.parametrize("F,D,n", [(64, 32, None), (101, 50, None), (1000, 500, None),
                                   (2, 1, None), (4097, 2048, None), (1000, 37, None),
                                   (18000, 9000, 5)])
def test_acf_kernel_matches_plain(gen, layout, F, D, n):
    """Kernel A against the float64 FFT plain version: max abs error on
    C(t) = -0.5 + 1.5 s / (F - d) <= 1e-6 (the TPU kernel's bound), from
    F = 2 to the largest F the kernel takes (with n bonds)."""
    v = _acf_input(layout, F, gen, n)
    before = cuda_acf.acf_lag_sums.launches
    s = tac.acf_sums(v, D, lag_major=True)
    assert cuda_acf.acf_lag_sums.launches == before + 1
    ref = tac.acf_sums_plain(v.double(), D).reshape(-1, D).T
    n = F - torch.arange(1, D + 1, device="cuda", dtype=torch.float64)
    err = (1.5 * (s.double() - ref) / n[:, None]).abs().max().item()
    assert err <= 1e-6, err


@pytest.mark.parametrize("layout", ["chunks", "contiguous", "pretiled_cut"])
def test_acf_kernel_bitwise_reproducible(gen, layout):
    """Two launches on the same input give bitwise-equal lag sums (every
    sum is in a fixed order; no atomics)."""
    v = _acf_input(layout, 1000, gen)
    before = cuda_acf.acf_lag_sums.launches
    a, b = (tac.acf_sums(v, 500, lag_major=True) for _ in range(2))
    assert cuda_acf.acf_lag_sums.launches == before + 2
    assert torch.equal(a, b)


@pytest.mark.parametrize("layout", ["chunks", "pretiled"])
@pytest.mark.parametrize("F", [18744, 20000, 40001])
def test_acf_slab_plan_matches_plain(gen, layout, F):
    """Chunks past one block's shared memory (the slab plan) against the
    float64 plain version to the same 1e-6 on C(t), D = F // 2, and a
    second launch equal to the first bit for bit."""
    D = F // 2
    if layout == "chunks":
        v = _unit((2, F, 3), gen).transpose(1, 2)
    else:
        v = tac.tile_palmer_group(_unit((1, F, 3), gen)).permute(0, 3, 2, 1)[:, :3]
    assert isinstance(cuda_acf.launch_plan(F, D), cuda_acf.SlabPlan)
    before = cuda_acf.acf_lag_sums.launches
    s = tac.acf_sums(v, D, lag_major=True)
    again = tac.acf_sums(v, D, lag_major=True)
    assert cuda_acf.acf_lag_sums.launches == before + 2
    assert torch.equal(s, again)
    ref = tac.acf_sums_plain(v.double(), D).reshape(-1, D).T
    n = F - torch.arange(1, D + 1, device="cuda", dtype=torch.float64)
    err = (1.5 * (s.double() - ref) / n[:, None]).abs().max().item()
    assert err <= 1e-6, err


def test_ct_palmer_long_chunk_on_card(gen):
    """ct_palmer on a (2, 20 000, 4, 3) float32 chunk (a 20 ns memory time
    at 1 ps) runs kernel A and agrees with float64 to 1e-6."""
    v = _unit((2, 20000, 4), gen)
    before = cuda_acf.acf_lag_sums.launches
    Ct, dCt = tac.ct_palmer(v)
    assert cuda_acf.acf_lag_sums.launches == before + 1
    Ct64, _ = tac.ct_palmer(v.double().cpu())
    assert (Ct.double().cpu() - Ct64).abs().max().item() <= 1e-6
    assert torch.isfinite(dCt).all()


def _lm_operands(gen, K, s2f, B, T):
    """Random p, and y = the model at p plus an offset of 0.1 to 0.5 of
    either sign, so no residual is a cancellation below what float32 can
    resolve (a near-zero residual has an unbounded relative error even
    when every operation is rounded correctly)."""
    def rand(*shape):
        return torch.rand(shape, generator=gen, device="cuda")

    dt = torch.arange(1, T + 1, device="cuda", dtype=torch.float32)
    # C scaled so S2 + sum C stays near 1 at any K: the model, and so the
    # cancellation in its residual, keeps the size it has at K <= 4.
    C, tau = (rand(K, B) * 0.39 + 0.01) * min(1.0, 4 / K), rand(K, B) * 199 + 1
    S2 = rand(1, B) * 0.6 + 0.2 if s2f else 1.0 - C.sum(0, keepdim=True)
    model = S2 + (C[:, None] * torch.exp(-dt[None, :, None] / tau[:, None])).sum(0)
    y = model + (rand(T, B) * 0.4 + 0.1) * torch.where(rand(T, B) < 0.5, -1.0, 1.0)
    isg = 1.0 / (rand(T, B) * 1.5 + 0.5)
    p = torch.cat([C, tau] + ([S2] if s2f else [])).contiguous()
    return p, y, isg, dt


def _assert_lm_matches_plain(p, y, isg, dt, K, s2f):
    """Kernels B and C against float64 hgc_plain with tests/test_engine.py's
    tolerances."""
    H, g, c = cuda_lm.hgc(p, y, isg, dt, K, s2f)
    c2 = cuda_lm.cost(p, y, isg, dt, K, s2f)
    Hr, gr, cr = cuda_lm.hgc_plain(p.double(), y.double(), isg.double(), dt.double(), K, s2f)
    torch.testing.assert_close(H.double(), Hr, rtol=3e-5, atol=1e-4)
    torch.testing.assert_close(g.double(), gr, rtol=3e-5, atol=1e-3)
    torch.testing.assert_close(c.double(), cr, rtol=1e-5, atol=0)
    torch.testing.assert_close(c2.double(), cr, rtol=1e-5, atol=0)
    return H, g, c


@pytest.mark.parametrize("T", [1, 31, 499])
@pytest.mark.parametrize("B", [1, 77, 1000, 1025])
@pytest.mark.parametrize("K", [1, 2, 3, 4])
@pytest.mark.parametrize("s2f", [False, True])
def test_lm_kernels_match_plain(gen, K, s2f, B, T):
    """Kernels B and C against float64 hgc_plain / cost_plain on shapes off
    the kernels' tile of 8 problems and lag slices, down to B = T = 1."""
    _assert_lm_matches_plain(*_lm_operands(gen, K, s2f, B, T), K, s2f)


@pytest.mark.parametrize("T", [1, 31, 499])
@pytest.mark.parametrize("B", [1, 77, 1025])
@pytest.mark.parametrize("K", [5, 6, 8, 16])
@pytest.mark.parametrize("s2f", [False, True])
def test_lm_wide_kernels_match_plain(gen, K, s2f, B, T):
    """K > 4 (the runtime-K variant, P up to 33) against float64 hgc_plain
    / cost_plain at the same tolerances, on the same ragged grid; C's cost
    equals B's bit for bit and a relaunch repeats bit for bit."""
    args = (*_lm_operands(gen, K, s2f, B, T), K, s2f)
    H, g, c = _assert_lm_matches_plain(*args)
    assert torch.equal(c, cuda_lm.cost_cuda(*args))
    assert all(torch.equal(x, z) for x, z in zip((H, g, c), cuda_lm.hgc_cuda(*args)))


@pytest.mark.parametrize("K,s2f", [(1, False), (2, True), (4, True), (6, True)])
def test_lm_kernels_isg_zero_lags(gen, K, s2f):
    """Lags with isg = 0 (scattered, and 20 trailing rows, as the TPU
    kernels' padding) add nothing: the kernels match the plain version and
    equal, bit for bit, a run on the operands without the trailing rows."""
    B, T = 333, 220
    p, y, isg, dt = _lm_operands(gen, K, s2f, B, T)
    isg = torch.where(torch.rand((T, B), generator=gen, device="cuda") < 0.3, 0.0, isg)
    isg[T - 20 :] = 0.0
    H, g, c = _assert_lm_matches_plain(p, y, isg, dt, K, s2f)
    cut = (y[: T - 20].contiguous(), isg[: T - 20].contiguous(), dt[: T - 20].contiguous())
    H2, g2, c2 = cuda_lm.hgc_cuda(p, *cut, K, s2f)
    assert torch.equal(H, H2) and torch.equal(g, g2) and torch.equal(c, c2)
    assert torch.equal(cuda_lm.cost_cuda(p, y, isg, dt, K, s2f), cuda_lm.cost_cuda(p, *cut, K, s2f))


@pytest.mark.parametrize("K", [1, 2, 3, 4])
@pytest.mark.parametrize("s2f", [False, True])
def test_lm_cost_bitwise_equals_hgc_cost(gen, K, s2f):
    """For equal p, kernel C's cost is kernel B's cost bit for bit: the LM
    accepts a step when C's cost is below B's."""
    p, y, isg, dt = _lm_operands(gen, K, s2f, 1025, 499)
    assert torch.equal(cuda_lm.hgc_cuda(p, y, isg, dt, K, s2f)[2],
                       cuda_lm.cost_cuda(p, y, isg, dt, K, s2f))


@pytest.mark.parametrize("K,s2f", [(2, True), (4, False), (5, True), (11, False)])
def test_lm_kernels_bitwise_reproducible(gen, K, s2f):
    """Two launches on the same operands give bitwise-equal H, g and cost."""
    args = (*_lm_operands(gen, K, s2f, 1000, 500), K, s2f)
    a, b = cuda_lm.hgc_cuda(*args), cuda_lm.hgc_cuda(*args)
    assert all(torch.equal(x, z) for x, z in zip(a, b))
    assert torch.equal(cuda_lm.cost_cuda(*args), cuda_lm.cost_cuda(*args))


def test_wrappers_raise_instead_of_falling_back(gen):
    v = _unit((2, 40), gen)
    with pytest.raises(TypeError):
        tac.acf_sums(v.double(), 20)
    with pytest.raises(ValueError):
        tac.acf_sums(v, 40)  # D >= F
    T, B = 10, 4
    y = torch.zeros((T, B), device="cuda")
    dt = torch.ones(T, device="cuda")
    with pytest.raises(ValueError, match="K = 1..16"):
        cuda_lm.hgc(torch.zeros((35, B), device="cuda"), y, y, dt, 17, True)
    with pytest.raises(ValueError):
        cuda_lm.hgc(torch.zeros((10, B), device="cuda"), y, y, dt, 5, True)
    with pytest.raises(ValueError):
        cuda_lm.cost(torch.zeros((B, 5), device="cuda").T, y, y, dt, 2, True)
    with pytest.raises(TypeError):
        cuda_lm.cost(torch.zeros((5, B), device="cuda", dtype=torch.float64), y, y, dt, 2, True)


def test_forward_on_card_matches_cpu(gen):
    """The forward on the card launches all three kernels and agrees with
    the same forward on the CPU in float32 (plain kernels): C(t) to 2e-6,
    the fit with test_engine's selection criteria."""
    v = correlated_walk(8, 200, 64)
    counters = (cuda_acf.acf_lag_sums, cuda_lm.hgc_cuda, cuda_lm.cost_cuda)
    before = [c.launches for c in counters]
    fwd = make_forward()
    a = fwd(torch.from_numpy(v).cuda())
    assert all(c.launches > n for c, n in zip(counters, before))
    b = fwd(torch.from_numpy(v))
    np.testing.assert_allclose(a.Ct.cpu().numpy(), b.Ct.numpy(), atol=2e-6)
    for out in a:
        assert torch.isfinite(out).all()

    def fit(o):
        dt = torch.arange(o.Ct.shape[0], dtype=o.Ct.dtype, device=o.Ct.device) + 1.0
        sg = torch.where(o.dCt.T > 0, o.dCt.T, torch.ones_like(o.dCt.T))
        return fit_multiexp(dt, o.Ct.T.contiguous(), sg, K=2, s2_free=True)

    fa, fb = fit(a), fit(b)
    rel = ((fa.chisq.cpu() - fb.chisq).abs() / fb.chisq).numpy()
    assert np.median(rel) < 1e-4 and np.mean(rel < 1e-2) > 0.95


@pytest.mark.parametrize("K", [5, 16])
def test_fit_beyond_k4_runs_on_kernels(gen, K):
    """fit_multiexp at K > 4 on the card runs kernels B and C (no
    ValueError, no plain route) and gives finite parameters."""
    v = torch.from_numpy(correlated_walk(4, 256, 16)).cuda()
    Ct, dCt = tac.ct_palmer(v)
    dt = torch.arange(Ct.shape[0], dtype=Ct.dtype, device="cuda") + 1.0
    before = (cuda_lm.hgc_cuda.launches, cuda_lm.cost_cuda.launches)
    f = fit_multiexp(dt, Ct.T.contiguous(), torch.ones_like(Ct.T), K=K, s2_free=True)
    assert cuda_lm.hgc_cuda.launches > before[0] and cuda_lm.cost_cuda.launches > before[1]
    assert f.C.shape == (16, K) and torch.isfinite(f.C).all() and torch.isfinite(f.tau).all()


def test_forward_n_components_5_on_card(gen):
    """make_forward(n_components=5) on entry.correlated_walk(4, 64, 16): all
    three kernels launch and the rates are finite."""
    v = torch.from_numpy(correlated_walk(4, 64, 16)).cuda()
    counters = (cuda_acf.acf_lag_sums, cuda_lm.hgc_cuda, cuda_lm.cost_cuda)
    before = [c.launches for c in counters]
    out = make_forward(n_components=5)(v)
    assert all(c.launches > n for c, n in zip(counters, before))
    assert out.C.shape == (16, 5)
    for x in (out.R1, out.R2, out.NOE, out.rho):
        assert torch.isfinite(x).all()


def test_ladder_on_card_matches_cpu_f32(gen):
    """fit_ct_ladder on the card (kernels B and C every iteration) on a
    256-row entry.hetero_cohort against the port's CPU float32 ladder: the
    rung equal on >= 98 % of rows, chisq within 1e-2 on >= 95 % (the
    float32 LM's gates, tests/test_engine.py)."""
    dt, y, dy = hetero_cohort(256, 400)
    names = [str(i) for i in range(256)]
    before = (cuda_lm.hgc_cuda.launches, cuda_lm.cost_cuda.launches)
    a = fit_ct_ladder(names, dt, y, dy)  # numpy in: the card, float32
    assert cuda_lm.hgc_cuda.launches > before[0] and cuda_lm.cost_cuda.launches > before[1]
    b = fit_ct_ladder(names, dt, *(torch.tensor(a, dtype=torch.float32) for a in (y, dy)))
    assert a.S2.is_cuda
    rung_a = a.mask.sum(1).cpu() * 2 + a.s2fast.cpu()
    rung_b = b.mask.sum(1) * 2 + b.s2fast
    assert (rung_a == rung_b).double().mean() >= 0.98
    rel = ((a.chisq.cpu() - b.chisq).abs() / b.chisq).numpy()
    assert np.mean(rel < 1e-2) >= 0.95


def test_run_finish_on_card_matches_cpu(gen):
    """entry.finish_entry's finish on the card against the same finish on
    the CPU: kernels B and C launch; rates within 1e-4 in median relative
    gap, all finite."""
    before = (cuda_lm.hgc_cuda.launches, cuda_lm.cost_cuda.launches)
    a = finish_entry()
    assert cuda_lm.hgc_cuda.launches > before[0] and cuda_lm.cost_cuda.launches > before[1]
    b = finish_entry(device="cpu")
    for f in ("R1", "R2", "NOE", "rho"):
        x, y = getattr(a, f).cpu(), getattr(b, f)
        assert torch.isfinite(x).all()
        assert float(((x - y).abs() / y.abs()).median()) < 1e-4, f


def _engine_case(case):
    """(dt, y, sigma) of entry.hetero_cohort on the card and the engine's
    keywords for one case of test_graph_loop_equals_eager_loop."""
    B, T = case.pop("B", 300), 200
    dt, y, dy = hetero_cohort(B, T)
    args = [torch.tensor(a, dtype=torch.float32, device="cuda") for a in (dt, y, dy)]
    rng = np.random.default_rng(5)
    kw = dict(case)
    if kw.pop("skip", False):
        kw["skip"] = torch.from_numpy(rng.uniform(size=B) < 0.4).cuda()
    if kw.pop("init", False):
        K = kw["K"]
        kw["init"] = [torch.tensor(a, dtype=torch.float32, device="cuda") for a in (
            rng.uniform(0.02, 0.2, (B, K)), np.sort(rng.uniform(2, 300, (B, K)), axis=1),
            rng.uniform(0.5, 0.9, B))]
    return args, kw


@pytest.mark.parametrize("case", [
    dict(K=2, s2_free=True), dict(K=2, s2_free=True, n_starts=8),
    dict(K=5, s2_free=True), dict(K=5, s2_free=False, n_starts=8, B=40),
    dict(K=2, s2_free=True, skip=True), dict(K=2, s2_free=True, init=True),
    dict(K=5, s2_free=True, init=True, skip=True), dict(K=1, s2_free=False, B=1),
    dict(K=3, s2_free=True, max_iter=1), dict(K=3, s2_free=True, max_iter=11)],
    ids=lambda c: "-".join(f"{k}{v}" for k, v in c.items()))
def test_graph_loop_equals_eager_loop(gen, case):
    """fit_multiexp_engine on the card replays one captured step and looks
    at the lanes once per stall window; its outputs equal the eager loop's
    (one host sync per iteration) bit for bit, the steps it ran cover the
    slowest lane's iterations and overshoot them by less than a window,
    and kernels B and C are counted once per step."""
    from spinrelax_tpu_torch.fit.engine import fit_multiexp_engine

    args, kw = _engine_case(dict(case))
    e_info, g_info = {}, {}
    eager = fit_multiexp_engine(*args, info=e_info, _eager=True, **kw)
    before = (cuda_lm.hgc_cuda.launches, cuda_lm.cost_cuda.launches)
    graph = fit_multiexp_engine(*args, info=g_info, **kw)
    for name, a, b in zip(graph._fields, graph, eager):
        assert torch.equal(torch.nan_to_num(a.double(), nan=-7.0),
                           torch.nan_to_num(b.double(), nan=-7.0)), name
    assert e_info["steps"] == e_info["iterations"] == g_info["iterations"]
    assert g_info["iterations"] <= g_info["steps"] <= kw.get("max_iter", 60)
    assert g_info["steps"] - g_info["iterations"] < 8
    assert cuda_lm.hgc_cuda.launches - before[0] == g_info["steps"]
    assert cuda_lm.cost_cuda.launches - before[1] == g_info["steps"]


def test_graph_loop_frees_its_pool(gen):
    """Ten engine calls in a row (a ladder's worth) leave no more device
    memory allocated than one: each call's graph and its private pool end
    with the call."""
    from spinrelax_tpu_torch.fit.engine import fit_multiexp_engine

    args, kw = _engine_case(dict(K=2, s2_free=True, B=2000))
    fit_multiexp_engine(*args, **kw)
    torch.cuda.synchronize()
    one = torch.cuda.memory_allocated()
    for _ in range(10):
        fit_multiexp_engine(*args, **kw)
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() <= one


def test_graph_loop_profiled_launches_equal_steps(gen):
    """torch.profiler sees kernels B and C run once per step of the graph
    loop (the eager first step and every replay)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from spinrelax_tpu_torch.fit.engine import fit_multiexp_engine

    args, kw = _engine_case(dict(K=2, s2_free=True))
    fit_multiexp_engine(*args, **kw)
    info = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fit_multiexp_engine(*args, info=info, **kw)
        torch.cuda.synchronize()
    n = sum("lm_kernel" in e.name for e in prof.events()
            if e.device_type == DeviceType.CUDA)
    assert n == 2 * info["steps"]


def test_stage_ct_streamed_on_card_matches_cpu(gen, tmp_path):
    """stage_ct_streamed on the card (kernel A twice a group) against the
    same stage on the CPU in float64: C(t) 2e-6, S2 and the average vector
    1e-5, at most 1e-3 of the histogram's samples in another bin; with a
    partial last group and q_rot."""
    from spinrelax_tpu_torch.entry import synthetic_system
    from spinrelax_tpu_torch.pipeline.stages import stage_ct_streamed

    ref_fn, xtc_fn, _ = synthetic_system(tmp_path, n_res=9, n_frames=3700, dt=2.0, seed=3)
    kw = dict(tau_memory=1000.0, chunk_groups=3, q_rot=np.array([0.5, -0.5, 0.5, 0.5]))
    before = cuda_acf.acf_lag_sums.launches
    a = stage_ct_streamed([xtc_fn], [ref_fn], str(tmp_path / "card"), **kw)
    assert a["n_chunks"] == 7 and a["acc"]["ct_int_s"].is_cuda
    assert cuda_acf.acf_lag_sums.launches - before == 2 * 3  # groups of 3, 3, 1
    b = stage_ct_streamed([xtc_fn], [ref_fn], str(tmp_path / "cpu"), device="cpu",
                          dtype=torch.float64, **kw)
    np.testing.assert_allclose(a["Ct"], b["Ct"], atol=2e-6)
    np.testing.assert_allclose(a["S2"][:, 0], b["S2"][:, 0], atol=1e-5)
    np.testing.assert_allclose(a["avgvec"], b["avgvec"], atol=1e-5)
    ha, hb = (np.load(str(tmp_path / f"{n}_vecHistogram.npz"), allow_pickle=True)["data"]
              for n in ("card", "cpu"))
    assert ha.sum() == hb.sum() == 9 * 7 * 500
    assert np.abs(ha - hb).sum() / 2 <= 1e-3 * hb.sum()


def test_ct_entry_on_card(gen):
    """entry.ct_entry(): file to rates on the card; kernels A, B and C all
    launch, the rates are finite and within 1e-3 (median) of the CPU run."""
    from spinrelax_tpu_torch.entry import ct_entry

    counters = (cuda_acf.acf_lag_sums, cuda_lm.hgc_cuda, cuda_lm.cost_cuda)
    before = [c.launches for c in counters]
    out, rates = ct_entry()
    assert all(c.launches > n for c, n in zip(counters, before))
    _, cpu = ct_entry(device="cpu")
    for f in ("R1", "R2", "NOE", "rho"):
        x, y = getattr(rates, f).cpu(), getattr(cpu, f)
        assert torch.isfinite(x).all()
        assert float(((x - y).abs() / y.abs()).median()) < 1e-3, f


def test_orient_on_card_matches_cpu_f64(gen):
    """bond_vectors_from_obs on the card in float32 against the CPU in
    float64 on the same observables: vectors to 1e-5 (eigh of Horn's
    matrix by two solvers)."""
    from spinrelax_tpu_torch.ops import orient

    rng = np.random.default_rng(2)
    q = rng.normal(size=(500, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    from spinrelax_tpu_torch.core import quaternion as qt

    R = qt.quat_to_mat(torch.from_numpy(q))
    S = (torch.diag(torch.tensor([1.0, 0.6, 0.3], dtype=torch.float64)) @ R.transpose(1, 2))
    raw = torch.from_numpy(rng.normal(size=(500, 12, 3)))
    a = orient.bond_vectors_from_obs(raw.float().cuda(), S.float().cuda())
    b = orient.bond_vectors_from_obs(raw, S)
    np.testing.assert_allclose(a.raw.cpu().numpy(), b.raw.numpy(), atol=1e-6)
    np.testing.assert_allclose(a.fitted.cpu().numpy(), b.fitted.numpy(), atol=1e-5)


def test_dq_on_card_matches_cpu(gen):
    """Delta-q in float64 on the card (statistics in lag blocks, sub-chunk
    segment sums, the one-fetch finalise) against the CPU, in memory and
    streamed: D to 1e-10 relative."""
    from spinrelax_tpu_torch.core import quaternion as qt
    from spinrelax_tpu_torch.ops import dq as tdq

    w = torch.randn((20000, 3), generator=gen, device="cuda", dtype=torch.float64)
    w = w * torch.sqrt(2.0 * torch.tensor([8e-4, 1.2e-3, 2.4e-3], device="cuda",
                                          dtype=torch.float64))
    th = w.norm(dim=1, keepdim=True)
    q = torch.cat([torch.cos(th / 2), w / th * torch.sin(th / 2)], dim=1)
    k = 1
    while k < q.shape[0]:
        q = torch.cat([q[:k], qt.qmult(q[:-k], q[k:])])
        k *= 2
    q = qt.qnorm(q)
    grid = (1.0, 5.0, 500.0, 5.0)
    card = tdq.analyse_dq(q, *grid, n_chunks=4)
    cpu = tdq.analyse_dq(q.cpu(), *grid, n_chunks=4)
    streamed = tdq.analyse_dq_streamed((q[i: i + 3000].cpu().numpy() for i in range(0, 20000, 3000)),
                                       *grid, chunk_frames=2048, n_chunks=4, n_total=20000)
    for r in (card, streamed):
        np.testing.assert_allclose(r.D_axes, cpu.D_axes, rtol=1e-10)
        np.testing.assert_allclose(r.D_iso, cpu.D_iso, rtol=1e-10)
        np.testing.assert_allclose(r.iso_chunks, cpu.iso_chunks, atol=1e-12)


def test_workflow_on_card_matches_cpu(gen, tmp_path):
    """entry.workflow_entry on the card (kernel A in stage_ct, B and C in the
    ladder) against the same workflow on the CPU in float64."""
    from spinrelax_tpu_torch.io import fittedct, xvg

    for c in (cuda_acf.acf_lag_sums, cuda_lm.hgc_cuda, cuda_lm.cost_cuda):
        c.launches = 0
    card = workflow_entry(str(tmp_path / "card"), n_res=6, n_frames=3000, tau_memory=500.0)
    assert cuda_acf.acf_lag_sums.launches == 2 and cuda_lm.hgc_cuda.launches > 0
    cpu = workflow_entry(str(tmp_path / "cpu"), device="cpu", n_res=6, n_frames=3000,
                         tau_memory=500.0)
    np.testing.assert_allclose(card["diso"], cpu["diso"], rtol=1e-6)
    pref = "rotdif-0.5ns"
    rungs = [fittedct.read_fittedct(str(tmp_path / d / f"{pref}_fittedCt.dat"), device="cpu")
             for d in ("card", "cpu")]
    rungs = [(m.mask.sum(1) * 2 + m.s2fast).numpy() for m in rungs]
    np.testing.assert_array_equal(*rungs)
    # every value within 1e-5 relative; atol: for the rates 1e-5 of the
    # file's largest value (an NOE near zero), for J(w) one unit in the
    # sixth digit that "%g" prints
    for bf in ("600", "850"):
        for f in ("R1", "R2", "NOE", "rho", "Jw"):
            fn = f"{pref}-{bf}_{f}.dat"
            if f == "Jw":
                a, b = (xvg.load_sxydylist(str(tmp_path / d / fn))[2] for d in ("card", "cpu"))
                atol = 10.0 ** (np.floor(np.log10(np.abs(b))) - 5)
            else:
                a, b = (xvg.load_matrix(str(tmp_path / d / fn))[:, 1] for d in ("card", "cpu"))
                atol = 1e-5 * np.abs(b).max()
            assert np.all(np.abs(a - b) <= 1e-5 * np.abs(b) + atol), fn


# --- the multi-field global fit and the legacy fits (float64 on the card) ---

def _fit_inputs(n_res=24, n_samp=64, seed=3, rscsa=False, fields=(600.133, 850.13)):
    """C(t) models, a weighted vector ensemble and experiments at the truth
    (Diso 4e-5, Daniso 1.5; a per-residue CSA with ``rscsa``), made from a
    numpy seed on the CPU; every 5th residue left out of the last NOE."""
    from spinrelax_tpu_torch.constants import NucleusPair, field_from_mhz
    from spinrelax_tpu_torch.io.experiments import ExperimentData
    from spinrelax_tpu_torch.models.ctmodel import CtModelSet
    from spinrelax_tpu_torch.models.diffusion import Diffusion
    from spinrelax_tpu_torch.ops import observables as obs

    rng = np.random.default_rng(seed)
    names = [str(i + 2) for i in range(n_res)]
    lists = (names, rng.uniform(0.6, 0.9, n_res), list(rng.uniform(0.02, 0.1, (n_res, 2))),
             list(np.stack([rng.uniform(5, 30, n_res), rng.uniform(100, 800, n_res)], -1)))
    v = rng.normal(size=(n_res, n_samp, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    w = rng.uniform(0.5, 2.0, (n_res, n_samp))
    csa = rng.uniform(-190e-6, -150e-6, n_res) if rscsa else None
    cpu_cts = CtModelSet.from_lists(*lists, s2fast=[True] * n_res, zeta=0.89, sort=False,
                                    device="cpu")
    expts = []
    for f in fields:
        r = obs.predict_rates_newapi(NucleusPair(B0=field_from_mhz(f), time_unit="ps"),
                                     Diffusion.axisymmetric(diso=4e-5, aniso=1.5), cpu_cts,
                                     vecs=v, weights=w, csa=csa)
        for t in ("R1", "R2", "NOE"):
            keep = (np.arange(n_res) % 5 != 0) if (f, t) == (fields[-1], "NOE") else slice(None)
            y = getattr(r, t).numpy()
            e = np.maximum(getattr(r, "d" + t).numpy(), 1e-3)
            expts.append(ExperimentData(t, "15N", "1H", f, "MHz", np.array(names)[keep],
                                        y[keep], e[keep]))
    return dict(lists=lists, v=v, w=w, csa=csa, expts=expts)


def _fit_set(inp, device, diso=5e-5, aniso=1.2):
    from spinrelax_tpu_torch.models.ctmodel import CtModelSet
    from spinrelax_tpu_torch.models.diffusion import Diffusion
    from spinrelax_tpu_torch.models.experiments import ExperimentSet

    n = len(inp["lists"][0])
    cts = CtModelSet.from_lists(*inp["lists"], s2fast=[True] * n, zeta=0.89, sort=False,
                                device=device)
    return ExperimentSet.build(inp["expts"], cts, Diffusion.axisymmetric(diso=diso, aniso=aniso),
                               vecs=inp["v"], weights=inp["w"])


@pytest.mark.parametrize("method", ["powell", "gradient", "device"])
def test_global_fitter_on_card_matches_cpu(gen, method):
    """GlobalFitter (Diso, Daniso) on the card against the CPU float64 fit:
    Powell within its own 1e-4 relative, L-BFGS and the LM within 1e-6;
    both at the truth."""
    from spinrelax_tpu_torch.fit.globalfit import GlobalFitter

    inp = _fit_inputs()
    card, cpu = (GlobalFitter(_fit_set(inp, d), ["Diso", "Daniso"]).run(method=method)
                 for d in ("cuda", "cpu"))
    rtol = 1e-4 if method == "powell" else 1e-6
    np.testing.assert_allclose([card.diso, card.aniso], [cpu.diso, cpu.aniso], rtol=rtol)
    np.testing.assert_allclose([card.diso, card.aniso], [4e-5, 1.5], rtol=1e-3)


def test_fused_rscsa_cycle_on_card_matches_cpu(gen):
    """method='device' with (Diso, rsCSA): the fused cycle (LM, then the
    golden walk) on the card against the CPU within 1e-6; the residues
    it covers at the truth, the rest (none here) untouched."""
    from spinrelax_tpu_torch.fit import globalfit

    inp = _fit_inputs(rscsa=True, fields=(600.133, 750.13, 850.13))
    fits = [globalfit.GlobalFitter(_fit_set(inp, d, diso=4.6e-5, aniso=1.5), ["Diso", "rsCSA"])
            for d in ("cuda", "cpu")]
    card, cpu = (f.run(method="device", max_cycles=10, tol=1e-8) for f in fits)
    np.testing.assert_allclose(card.diso, cpu.diso, rtol=1e-6)
    np.testing.assert_allclose(card.csa, cpu.csa, rtol=1e-6)
    np.testing.assert_allclose(card.diso, 4e-5, rtol=1e-3)
    np.testing.assert_allclose(card.csa, inp["csa"], rtol=5e-3)
    assert fits[0].counts["golden_rounds"] > 0


def test_lm_window_on_card_equals_step_by_step(gen):
    """The LM read once per LM_WINDOW steps against the loop that reads its
    flag before every step, on the card: the same bits, and one read a
    window."""
    from spinrelax_tpu_torch.fit import globalfit

    fit = globalfit.GlobalFitter(_fit_set(_fit_inputs(), "cuda"), ["Diso", "Daniso"])
    globalfit.host_reads.count = 0
    windowed = fit._lm(*fit._params())
    reads = globalfit.host_reads.count
    eager = fit._lm(*fit._params(), _eager=True)
    n_it = int(windowed[2])
    assert 0 < n_it and reads == -(-n_it // globalfit.LM_WINDOW)
    for a, b in zip([windowed[0], *windowed[1], windowed[2]],
                    [eager[0], *eager[1], eager[2]]):
        assert torch.equal(a, b)


def test_fit_legacy_new_device_on_card_matches_cpu(gen):
    """fit_legacy('new', method='device') on the card against the CPU within
    1e-6, at the truth within tests/test_legacyfit.py's 2e-3 / 5e-3."""
    from spinrelax_tpu_torch.constants import NucleusPair, field_from_mhz
    from spinrelax_tpu_torch.fit.legacyfit import fit_legacy
    from spinrelax_tpu_torch.models.ctmodel import CtModelSet
    from spinrelax_tpu_torch.models.diffusion import Diffusion
    from spinrelax_tpu_torch.ops import observables as obs

    inp = _fit_inputs(rscsa=True)
    n = len(inp["lists"][0])
    pair = NucleusPair(B0=field_from_mhz(600.133), time_unit="ps")
    cts = {d: CtModelSet.from_lists(*inp["lists"], s2fast=[True] * n, zeta=0.89, sort=False,
                                    device=d) for d in ("cuda", "cpu")}
    r = obs.predict_rates(pair, Diffusion.axisymmetric(diso=4e-5, aniso=1.5), cts["cpu"],
                          vecs=inp["v"], weights=inp["w"], csa=inp["csa"])
    exp = torch.stack([r.R1, r.R2, r.NOE], -1).numpy()
    err = np.maximum(torch.stack([r.dR1, r.dR2, r.dNOE], -1).numpy(), 1e-3 * np.abs(exp))
    card, cpu = (fit_legacy("new", pair, Diffusion.axisymmetric(diso=4.4e-5, aniso=1.5), cts[d],
                            exp, err, vecs=inp["v"], weights=inp["w"], max_cycles=20, tol=1e-8,
                            method="device") for d in ("cuda", "cpu"))
    np.testing.assert_allclose(card.diso, cpu.diso, rtol=1e-6)
    np.testing.assert_allclose(card.csa, cpu.csa, rtol=1e-6)
    np.testing.assert_allclose(card.diso, 4e-5, rtol=2e-3)
    np.testing.assert_allclose(card.csa, inp["csa"], rtol=5e-3)


def test_stage_multifield_on_card_matches_cpu(gen, tmp_path):
    """stage_multifield (Diso, rsCSA; Powell) on the card against the CPU:
    without a fit the same bytes; with it every number of every file
    within Powell's 1e-4 relative plus one unit of a '%g' sixth digit."""
    from spinrelax_tpu_torch.core import geometry
    from spinrelax_tpu_torch.io import experiments, fittedct, vectors
    from spinrelax_tpu_torch.models.ctmodel import CtModelSet
    from spinrelax_tpu_torch.models.diffusion import Diffusion
    from spinrelax_tpu_torch.pipeline import stages

    inp = _fit_inputs(rscsa=True)
    n = len(inp["lists"][0])
    cts = CtModelSet.from_lists(*inp["lists"], s2fast=[True] * n, sort=False, device="cpu")
    fittedct.write_fittedct(str(tmp_path / "in_fittedCt.dat"), cts)
    hist, ep, ec = geometry.lambert_histogram(torch.from_numpy(inp["v"]), 24, 12)
    vectors.save_histogram(str(tmp_path / "in_vecHistogram.npz"), inp["lists"][0],
                           hist.numpy(), ep.numpy(), ec.numpy())
    files = []
    for i, e in enumerate(inp["expts"]):
        files.append(str(tmp_path / f"e{i}.dat"))
        experiments.write_experiment(files[-1], e)
    for opt in (None, ["Diso", "rsCSA"]):
        for d in ("cuda", "cpu"):
            (tmp_path / d).mkdir(exist_ok=True)
            stages.stage_multifield(str(tmp_path / "in_fittedCt.dat"), files,
                                    str(tmp_path / d / ("fit" if opt else "plain")),
                                    Diffusion.axisymmetric(diso=4.6e-5, aniso=1.5),
                                    vec_file=str(tmp_path / "in_vecHistogram.npz"),
                                    opt_params=opt, include_expt=True, device=d)
    made = sorted(os.listdir(tmp_path / "cpu"))
    assert made == sorted(os.listdir(tmp_path / "cuda")) and "fit_CSA_opt.dat" in made
    for f in made:
        a, b = ((tmp_path / d / f).read_text() for d in ("cuda", "cpu"))
        if f.startswith("plain"):
            assert a == b, f
            continue
        for x, y in zip(a.split(), b.split(), strict=True):
            try:
                fx, fy = float(x), float(y)
            except ValueError:
                assert x == y, f
                continue
            assert abs(fx - fy) <= 1e-4 * abs(fy) + 10.0 ** (np.floor(np.log10(abs(fy) or 1)) - 5)


def _raw_frames(n_frames, seed):
    """A 30-atom chain and 60 waters wrapped into a 3.1 nm box, float32."""
    from spinrelax_tpu_torch.io.pdb import Topology

    rng = np.random.default_rng(seed)
    box = np.array([3.1, 3.1, 3.1])
    chain = np.cumsum(rng.normal(scale=0.1, size=(30, 3)), axis=0)
    drift = np.cumsum(rng.normal(scale=0.3, size=(n_frames, 1, 3)), axis=0)
    wat = (rng.uniform(0, 3.1, (n_frames, 60, 1, 3))
           + np.array([[0, 0, 0], [0.08, 0.02, 0], [0, 0.08, 0.02]])).reshape(n_frames, 180, 3)
    raw = np.mod(np.concatenate([chain[None] + drift, wat], axis=1), box).astype(np.float32)
    top = Topology(atom_names=["CA"] * 30 + ["OW", "HW1", "HW2"] * 60,
                   res_seqs=np.concatenate([np.arange(1, 31), np.repeat(np.arange(100, 160), 3)]),
                   res_names=["ALA"] * 30 + ["SOL"] * 180, chain_ids=["A"] * 30 + ["W"] * 180,
                   occupancies=np.ones(210), elements=[""] * 210)
    return top, raw, box


def test_center_solute_on_card_matches_cpu_f64(gen):
    """center_solute on the card against the CPU in float64 (solute 1e-4 nm,
    every atom within 1e-4 nm modulo whole boxes) and two card runs equal
    bit for bit."""
    from spinrelax_tpu_torch.ops.pbc import center_solute

    top, raw, box = _raw_frames(300, seed=3)
    card = center_solute(raw, box, top=top, batch=128)
    again = center_solute(raw, box, top=top, batch=128)
    assert card.dtype == np.float32 and np.array_equal(card, again)
    cpu = center_solute(raw.astype(np.float64), box, top=top, device="cpu")
    np.testing.assert_allclose(card[:, :30], cpu[:, :30], rtol=0, atol=1e-4)
    d = card - cpu
    np.testing.assert_allclose(d - np.round(d / box) * box, 0.0, atol=1e-4)


def test_ired_on_card_matches_cpu_f64(gen):
    """calculate_s2_ired and IredStream on the card (float32 vectors)
    against the CPU in float64."""
    from spinrelax_tpu_torch.ops import ired

    v = _unit((3000, 71), gen)
    cpu = ired.calculate_s2_ired(v.double().cpu(), 2.0, 200.0)
    card = ired.calculate_s2_ired(v, 2.0, 200.0)
    assert card.S2.is_cuda and card.S2.dtype == torch.float32
    for k in ("S2", "dS2", "eigenvalues"):
        err = float((getattr(card, k).double().cpu() - getattr(cpu, k)).abs().max())
        assert err <= 1e-4, (k, err)
    st = ired.IredStream(71, 500)
    for off in range(0, 3000, 700):
        st.update(v[off : off + 700])
    err = float((st.result().S2.double().cpu() - cpu.S2).abs().max())
    assert err <= 1e-4, err


def test_python_m_check_on_card():
    """python -m spinrelax_tpu_torch check exits 0 on the card."""
    import subprocess
    import sys

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-m", "spinrelax_tpu_torch", "check"], cwd=repo,
                         env=dict(os.environ, PYTHONPATH=repo), capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "check PASSED" in out.stdout and "device cuda" in out.stdout
