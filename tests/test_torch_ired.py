"""The port's iRED / wiRED S2 (spinrelax_tpu_torch.ops.ired) and the C(t)
stages' s2_mode="ired" / "wired" branches against spinrelax_tpu's, on the
CPU, on the same seeded inputs.

Tolerances: float64 1e-10 for S2, dS2 and eigenvalues (the same
eigenproblem; LAPACK in both packages, summation orders differ);
eigenvectors up to the sign of each column (eigh picks either); the
stream against the in-memory result 1e-9 (tests/test_ired.py's bound);
the stages' _S2.dat and _iREDspectrum.dat on float64 frames (an .npy) to
1e-9 as parsed numbers.
"""

import os

import jax
import numpy as np
import pytest
import torch

from spinrelax_tpu.ops import ired as jired
from spinrelax_tpu.pipeline import stages as jstages
from spinrelax_tpu_torch.io import native as tnat
from spinrelax_tpu_torch.entry import synthetic_system
from spinrelax_tpu_torch.ops import ired as tired
from spinrelax_tpu_torch.pipeline import stages as tstages


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_state():
    """Clear jax's compiled-program caches before this module (see
    tests/test_review_fixes_r3.py); two torch threads per xdist worker."""
    jax.clear_caches()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(2)


def tumbling(n_frames, n_res, seed, wobble=0.4):
    """Unit vectors of a body tumbling by small random rotations, each
    wobbling about its own axis (float64)."""
    rng = np.random.default_rng(seed)
    axes = rng.normal(size=(n_res, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    body = axes + wobble * np.cumsum(rng.normal(scale=0.2, size=(n_frames, n_res, 3)), 0) \
        / np.sqrt(np.arange(1, n_frames + 1))[:, None, None]
    ang = np.cumsum(rng.normal(scale=0.05, size=(n_frames, 3)), axis=0)
    c, s = np.cos(ang), np.sin(ang)
    out = body.copy()
    for k, (i, j) in enumerate(((1, 2), (0, 2), (0, 1))):  # rotations about x, y, z
        a, b = out[..., i].copy(), out[..., j].copy()
        out[..., i] = c[:, k, None] * a - s[:, k, None] * b
        out[..., j] = s[:, k, None] * a + c[:, k, None] * b
    return out / np.linalg.norm(out, axis=-1, keepdims=True)


def _same_up_to_column_sign(got, want, atol):
    s = np.sign(np.sum(got * want, axis=-2, keepdims=True))
    np.testing.assert_allclose(got * s, want, rtol=0, atol=atol)


@pytest.mark.parametrize("mode", ["ired", "wired"])
def test_calculate_s2_matches_jax(mode):
    v = tumbling(1500, 12, seed=3)
    fn_t = tired.calculate_s2_ired if mode == "ired" else tired.calculate_s2_wired
    fn_j = jired.calculate_s2_ired if mode == "ired" else jired.calculate_s2_wired
    got = fn_t(torch.from_numpy(v), 1.0, 40.0)
    want = fn_j(v, 1.0, 40.0)
    n_blocks = 1500 // (200 if mode == "ired" else 80)
    assert got.eigenvalues.shape == (n_blocks, 12) and got.modes.shape == (n_blocks, 12, 12)
    for k in ("S2", "dS2", "eigenvalues"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   rtol=0, atol=1e-10, err_msg=k)
    # the eigenvalues of a block are distinct here, so each column is one mode
    _same_up_to_column_sign(got.modes.numpy(), np.asarray(want.modes), 1e-9)


def test_helpers_match_jax():
    v = tumbling(300, 9, seed=4)
    M = tired._ired_matrix(torch.from_numpy(v))
    np.testing.assert_allclose(M.numpy(), np.asarray(jired._ired_matrix(v)), rtol=0, atol=1e-12)
    # the Q identity: M_ij = < P2(v_i . v_j) >
    d = np.einsum("tic,tjc->tij", v, v)
    np.testing.assert_allclose(M.numpy(), np.mean(1.5 * d**2 - 0.5, axis=0), atol=1e-12)
    assert tired._ired_matrix(torch.from_numpy(v).float()).dtype == torch.float32
    s2, vals, modes = tired.ired_block_s2(torch.from_numpy(v))
    js2, jvals, jmodes = jired.ired_block_s2(v)
    np.testing.assert_allclose(s2.numpy(), np.asarray(js2), atol=1e-10)
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), atol=1e-10)
    _same_up_to_column_sign(modes.numpy(), np.asarray(jmodes), 1e-9)
    with pytest.raises(ValueError, match="more residues"):
        tired.ired_block_s2(torch.from_numpy(v[:, :5]))
    with pytest.raises(ValueError, match="too short"):
        tired.calculate_s2_ired(torch.from_numpy(v), 1.0, 100.0)
    one = tired.calculate_s2_ired(torch.from_numpy(v), 1.0, 40.0)  # one 200-frame block
    assert one.eigenvalues.shape[0] == 1 and bool(torch.isnan(one.dS2).all())
    jone = jired.calculate_s2_ired(v, 1.0, 40.0)
    np.testing.assert_allclose(one.S2.numpy(), np.asarray(jone.S2), atol=1e-10)


def test_stream_matches_jax_stream_and_in_memory():
    v = tumbling(2100, 12, seed=5)
    W = 250
    ref = tired.calculate_s2_ired(torch.from_numpy(v), 1.0, 50.0)
    t, j = tired.IredStream(12, W, keep_modes=True), jired.IredStream(12, W, keep_modes=True)
    off = 0
    for size in [97, 512, 13, 700, 300, 478]:
        t.update(torch.from_numpy(v[off : off + size]))
        j.update(v[off : off + size])
        off += size
    got, want = t.result(), j.result()
    assert got.eigenvalues.shape == (8, 12)
    for k in ("S2", "dS2", "eigenvalues"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   rtol=0, atol=1e-10, err_msg=k)
        np.testing.assert_allclose(getattr(got, k).numpy(), getattr(ref, k).numpy(),
                                   rtol=0, atol=1e-9, err_msg=k)
    _same_up_to_column_sign(got.modes.numpy(), np.asarray(want.modes), 1e-9)
    # without keep_modes: empty modes; float32 vectors give float32 results
    s = tired.IredStream(12, W)
    s.update(torch.from_numpy(v).float())
    r = s.result()
    assert r.modes.shape == (0, 12, 12) and r.S2.dtype == torch.float32
    np.testing.assert_allclose(r.S2.numpy(), ref.S2.numpy(), atol=1e-5)
    with pytest.raises(ValueError, match="no complete iRED window"):
        short = tired.IredStream(12, W)
        short.update(torch.from_numpy(v[:100]))
        short.result()
    with pytest.raises(ValueError, match=">= 2"):
        tired.IredStream(12, 1)


@pytest.fixture(scope="module")
def system(tmp_path_factory):
    """A synthetic 8-residue .pdb + .xtc (entry.synthetic_system, 1600
    frames 1 ps apart) and the same frames in float64 as an .npy."""
    tmp = tmp_path_factory.mktemp("ired")
    ref_fn, xtc_fn, _ = synthetic_system(tmp, n_res=8, n_frames=1600, dt=1.0, seed=2)
    npy = str(tmp / "solute64.npy")
    np.save(npy, tnat.read_xtc(xtc_fn)[0].astype(np.float64))
    return dict(tmp=tmp, ref=ref_fn, npy=npy)


def _rows(fn):
    return np.array([[float(x) for x in ln.split()] for ln in open(fn)
                     if ln.strip() and ln[0] not in "#@&"])


@pytest.mark.parametrize("mode", ["ired", "wired"])
@pytest.mark.parametrize("streamed", [False, True], ids=["memory", "streamed"])
def test_stages_match_jax(system, mode, streamed):
    """stage_ct / stage_ct_streamed with s2_mode ired / wired: _S2.dat and
    _iREDspectrum.dat against the JAX stage's on the same float64 frames."""
    kw = dict(do_ct=False, do_vec_dist=False, do_vec_avg=False, s2_mode=mode, timestep=1.0)
    tmp = system["tmp"]
    prefs = {}
    for pkg, st in (("jax", jstages), ("port", tstages)):
        pref = prefs[pkg] = str(tmp / f"{pkg}-{mode}-{streamed}")
        extra = {} if pkg == "jax" else {"device": "cpu"}
        if streamed:
            out = st.stage_ct_streamed([system["npy"]], [system["ref"]], pref, 200.0,
                                       chunk_groups=2, **kw, **extra)
        else:
            out = st.stage_ct([system["npy"]], [system["ref"]], pref, 200.0, **kw, **extra)
        assert np.asarray(out["S2"]).shape == (8, 2)
    for f in ("_S2.dat", "_iREDspectrum.dat"):
        got, want = _rows(prefs["port"] + f), _rows(prefs["jax"] + f)
        assert got.shape == want.shape and np.isfinite(got).all(), f
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-9, err_msg=f)
    # the spectrum file's header and layout are the JAX writer's
    head = [ln for ln in open(prefs["port"] + "_iREDspectrum.dat") if ln.startswith("#")]
    assert head == [ln for ln in open(prefs["jax"] + "_iREDspectrum.dat") if ln.startswith("#")]


def test_streamed_stage_equals_in_memory_stage(system):
    """The port's streamed iRED S2 equals its in-memory iRED S2 (the same
    blocks: 200 ps tau_memory, 100-frame windows, chunks of 200 frames)."""
    kw = dict(do_ct=False, do_vec_dist=False, do_vec_avg=False, s2_mode="ired",
              timestep=1.0, device="cpu")
    tmp = system["tmp"]
    mem = tstages.stage_ct([system["npy"]], [system["ref"]], str(tmp / "m"), 200.0, **kw)
    st = tstages.stage_ct_streamed([system["npy"]], [system["ref"]], str(tmp / "s"), 200.0,
                                   chunk_groups=3, **kw)
    np.testing.assert_allclose(st["S2"], mem["S2"], rtol=0, atol=1e-9)
    np.testing.assert_allclose(_rows(str(tmp / "s_iREDspectrum.dat")),
                               _rows(str(tmp / "m_iREDspectrum.dat")), rtol=0, atol=1e-9)
    with pytest.raises(ValueError, match="memory time"):
        tstages.stage_ct([system["npy"]], [system["ref"]], str(tmp / "n"), None,
                         **dict(kw, do_ct=False))
