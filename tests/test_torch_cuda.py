"""The port's CUDA kernels on the card, each against its plain version.

Needs an NVIDIA GPU and nvcc; every test skips without them.  The file
imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from spinrelax_tpu_torch.entry import correlated_walk
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


def _lm_operands(gen, K, s2f, B, T):
    """Random p, and y = the model at p plus an offset of 0.1 to 0.5 of
    either sign, so no residual is a cancellation below what float32 can
    resolve (a near-zero residual has an unbounded relative error even
    when every operation is rounded correctly)."""
    def rand(*shape):
        return torch.rand(shape, generator=gen, device="cuda")

    dt = torch.arange(1, T + 1, device="cuda", dtype=torch.float32)
    C, tau = rand(K, B) * 0.39 + 0.01, rand(K, B) * 199 + 1
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


@pytest.mark.parametrize("K,s2f", [(1, False), (2, True), (4, True)])
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


@pytest.mark.parametrize("K,s2f", [(2, True), (4, False)])
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
    with pytest.raises(ValueError):
        cuda_lm.hgc(torch.zeros((11, B), device="cuda"), y, y, dt, 5, True)
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
