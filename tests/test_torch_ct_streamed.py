"""The port's streamed C(t): ops.autocorr's streamed drivers and S2, and
pipeline.stages.stage_ct_streamed as a whole, against spinrelax_tpu's on
the CPU, on one synthetic .pdb + trajectory written by the port's
entry.synthetic_system.

float32 runs agree to 1e-5 on C(t), dC(t), S2 and the average vector (two
float32 lag-sum formulations: the JAX package's matmul DFT, the port's
FFT); histogram counts are equal exactly; artefact files are equal byte for
byte where the values are, else parsed and compared.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spinrelax_tpu.ops import autocorr as jac
from spinrelax_tpu.pipeline import stages as jstages
from spinrelax_tpu_torch import convert
from spinrelax_tpu_torch.entry import ct_entry, synthetic_system
from spinrelax_tpu_torch.io import xvg
from spinrelax_tpu_torch.ops import autocorr as tac
from spinrelax_tpu_torch.pipeline import stages as tstages


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_state():
    """Clear jax's compiled-program caches before this module (see
    tests/test_review_fixes_r3.py); two torch threads per xdist worker."""
    jax.clear_caches()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(2)


def _unit(rng, *shape, dtype=np.float64):
    v = rng.normal(size=shape + (3,))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(dtype)


# --- ops.autocorr: the streamed drivers ----------------------------------------

@pytest.mark.parametrize("dtype,atol", [(np.float64, 1e-12), (np.float32, 2e-6)])
def test_streamed_drivers_match_jax(rng, dtype, atol):
    """ct_palmer_scan (batch 2), ct_palmer_streamed (groups of 3, 3, 2) and
    ct_palmer_direct against JAX's, and against the port's fused ct_palmer."""
    v = _unit(rng, 8, 60, 5, dtype=dtype)
    tv = torch.from_numpy(v)
    want = [np.asarray(a) for a in jac.ct_palmer(v)]
    for got in (tac.ct_palmer_scan(tv, batch=2),
                tac.ct_palmer_streamed(iter([tv[:3], tv[3:6], tv[6:]]), 60),
                tac.ct_palmer_direct(tv), tac.ct_palmer(tv)):
        assert got[0].dtype == tv.dtype and got[0].shape == (30, 5)
        np.testing.assert_allclose(got[0].numpy(), want[0], atol=atol)
        np.testing.assert_allclose(got[1].numpy(), want[1], atol=atol * 10)
    for jfn, tfn in ((jac.ct_palmer_scan, tac.ct_palmer_scan),
                     (jac.ct_palmer_direct, tac.ct_palmer_direct)):
        j = jfn(v)
        t = tfn(tv)
        np.testing.assert_allclose(t[0].numpy(), np.asarray(j[0]), atol=atol)
        np.testing.assert_allclose(t[1].numpy(), np.asarray(j[1]), atol=atol * 10)


def test_stream_accumulate_matches_jax(rng):
    """The (sum, sum of squares, count) triple: the port's is lag-leading,
    JAX's its transpose."""
    v = _unit(rng, 7, 40, 4)
    groups = [v[:2], v[2:5], v[5:]]
    js, js2, jn = jac.stream_accumulate(iter(groups), 40)
    ts, ts2, tn = tac.stream_accumulate((torch.from_numpy(g) for g in groups), 40)
    assert tn == jn == 7 and ts.shape == (20, 4)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js).T, atol=1e-12)
    np.testing.assert_allclose(ts2.numpy(), np.asarray(js2).T, atol=1e-12)
    one = tac.stream_update(torch.from_numpy(v), torch.zeros(20, 4, dtype=torch.float64),
                            torch.zeros(20, 4, dtype=torch.float64))
    np.testing.assert_allclose(one[0].numpy(), ts.numpy(), atol=1e-12)
    with pytest.raises(ValueError, match="frames"):
        tac.stream_accumulate(iter([torch.from_numpy(v[:, :30])]), 40)
    with pytest.raises(ValueError, match="empty"):
        tac.stream_accumulate(iter([]), 40)
    with pytest.raises(ValueError, match="divisible"):
        tac.ct_palmer_scan(torch.from_numpy(v), batch=2)


@pytest.mark.parametrize("call", [lambda v: tac.ct_palmer_scan(v, mesh=object()),
                                  lambda v: tac.ct_palmer_streamed(iter([v]), 40, mesh=object())])
def test_mesh_names_its_roadmap_item(rng, call):
    with pytest.raises(NotImplementedError, match="item 15"):
        call(torch.from_numpy(_unit(rng, 2, 40, 3)))


def test_reformat_and_s2_match_jax(rng):
    a, b = _unit(rng, 95, 4), _unit(rng, 61, 4)
    want = jac.reformat_by_tau([a, b], 2.0, 60.0)
    got = tac.reformat_by_tau([a, b], 2.0, 60.0)
    assert got.shape == (5, 30, 4, 3)
    np.testing.assert_array_equal(got, want)
    # vectors wobbling around an axis, so S2 is well above its floor
    v = _unit(rng, 1, 4) + 0.4 * _unit(rng, 120, 4)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    tv = torch.from_numpy(v)
    np.testing.assert_allclose(tac.s2_outer(tv).numpy(), np.asarray(jac.s2_outer(v)), atol=1e-12)
    np.testing.assert_allclose(float(tac.s2_outer(tv[:, 0])), float(jac.s2_outer(v[:, 0])),
                               atol=1e-12)
    np.testing.assert_allclose(tac.s2_outer_blocked(tv, 2.0, 60.0).numpy(),
                               np.asarray(jac.s2_outer_blocked(jnp.asarray(v), 2.0, 60.0)),
                               atol=1e-12)


# --- the stage as a whole -------------------------------------------------------

TAU = 400.0


@pytest.fixture(scope="module")
def system(tmp_path_factory):
    """5 residues, 1200 frames, 2.5 ps apart, as .xtc (7 whole Palmer chunks
    of 160 frames and a dropped tail: groups of 2, 2, 2 and a partial 1) and
    the same frames, as decoded, as .npy."""
    tmp = tmp_path_factory.mktemp("ct")
    ref_fn, xtc_fn, _ = synthetic_system(tmp, n_res=5, n_frames=1200, dt=2.5, seed=4)
    from spinrelax_tpu_torch.io import native

    npy_fn = str(tmp / "solute.npy")
    np.save(npy_fn, native.read_xtc(xtc_fn)[0])
    return dict(tmp=tmp, ref=ref_fn, xtc=xtc_fn, npy=npy_fn)


def _both(system, name, trj, **kw):
    """Run the stage of both packages on one input -> (port dict, JAX dict,
    port prefix, JAX prefix)."""
    tp, jp = str(system["tmp"] / f"t_{name}"), str(system["tmp"] / f"j_{name}")
    t = tstages.stage_ct_streamed([system[trj]], [system["ref"]], tp, tau_memory=TAU,
                                  device="cpu", **kw)
    j = jstages.stage_ct_streamed([system[trj]], [system["ref"]], jp, tau_memory=TAU, **kw)
    return t, j, tp, jp


def _assert_stage_outputs_agree(t, j, tp, jp, histogram=True):
    assert t["res_ids"] == j["res_ids"] and t["delta_t"] == j["delta_t"]
    for k in ("Ct", "dCt", "S2", "avgvec"):
        assert t[k].dtype == np.float32 and t[k].shape == np.shape(j[k]), k
        np.testing.assert_allclose(t[k], np.asarray(j[k]), atol=1e-5, err_msg=k)
    for suffix in ("_Ctint.dat", "_Ctext.dat"):
        a, b = open(tp + suffix, "rb").read(), open(jp + suffix, "rb").read()
        if a != b:  # values differ in a last digit: parse and compare
            la, xa, ya, dya = xvg.load_sxydylist(tp + suffix)
            lb, xb, yb, dyb = xvg.load_sxydylist(jp + suffix)
            assert la == lb
            np.testing.assert_array_equal(xa, xb)
            np.testing.assert_allclose(ya, yb, atol=1e-5)
            np.testing.assert_allclose(dya, dyb, atol=1e-5)
    for suffix in ("_S2.dat", "_avgvec.dat"):
        np.testing.assert_allclose(xvg.load_matrix(tp + suffix), xvg.load_matrix(jp + suffix),
                                   atol=1e-5)
    if histogram:
        a = np.load(tp + "_vecHistogram.npz", allow_pickle=True)
        b = np.load(jp + "_vecHistogram.npz", allow_pickle=True)
        assert a["data"].dtype == b["data"].dtype == np.int64
        np.testing.assert_array_equal(a["data"], b["data"])
        assert int(a["data"].sum()) == 5 * t["n_chunks"] * 160
        for k in ("names", "dataType", "bHistogram", "axisLabels"):
            np.testing.assert_array_equal(a[k], b[k])
        for ea, eb in zip(a["edges"], b["edges"]):
            np.testing.assert_allclose(ea, eb, atol=1e-6)


def test_stage_on_xtc_matches_jax(system):
    """The .xtc leg: fused decoder reduction, the 2.5 ps timestep probe
    (160 frames a chunk, 80 lags), a partial last group, a dropped tail."""
    t, j, tp, jp = _both(system, "xtc", "xtc", chunk_groups=2)
    assert t["Ct"].shape == (80, 5) and t["n_chunks"] == 7 and t["delta_t"] == 2.5
    _assert_stage_outputs_agree(t, j, tp, jp)
    # the accumulators the finish starts from reproduce the returned C(t)
    mean, dct = tac.palmer_pooled_stats(t["acc"]["ct_int_s"], t["acc"]["ct_int_s2"], 7)
    np.testing.assert_array_equal(mean.numpy(), t["Ct"])
    np.testing.assert_array_equal(dct.numpy(), t["dCt"])


def test_stage_on_npy_with_q_rot_matches_jax(system):
    """.npy input (host reduction through bond_obs_host) with an explicit
    timestep, a frame rotation q_rot, and groups of 3 (3, 3, 1)."""
    q = np.array([0.5, 0.5, -0.5, 0.5])
    t, j, tp, jp = _both(system, "npy", "npy", chunk_groups=3, timestep=2.5, q_rot=q)
    _assert_stage_outputs_agree(t, j, tp, jp)
    with pytest.raises(ValueError, match="time axis"):
        tstages.stage_ct_streamed([system["npy"]], [system["ref"]],
                                  str(system["tmp"] / "bad"), tau_memory=TAU, device="cpu")


def test_fused_xtc_reduction_equals_host_reduction(system):
    """The .xtc leg (reduction inside the decoder) and the .npy leg of the
    decoded frames (bond_obs_host) give byte-identical artefacts."""
    outs = []
    for name, trj in (("fx", "xtc"), ("fn", "npy")):
        p = str(system["tmp"] / name)
        tstages.stage_ct_streamed([system[trj]], [system["ref"]], p, tau_memory=TAU,
                                  chunk_groups=2, timestep=2.5, device="cpu")
        outs.append([open(p + s, "rb").read() for s in
                     ("_Ctint.dat", "_Ctext.dat", "_S2.dat", "_avgvec.dat", "_vecHistogram.npz")])
    assert outs[0] == outs[1]


@pytest.mark.parametrize("storage,ext", [("PhiTheta", "npz"), ("TextPhiTheta", "dat")])
def test_stage_phitheta_storage_matches_jax(system, storage, ext):
    t, j, tp, jp = _both(system, storage, "xtc", chunk_groups=2, vec_storage=storage)
    _assert_stage_outputs_agree(t, j, tp, jp, histogram=False)
    assert t["vec_file"] == tp + "_vecPhiTheta." + ext
    if ext == "npz":
        a, b = np.load(t["vec_file"], allow_pickle=True), np.load(j["vec_file"], allow_pickle=True)
        assert list(a["names"]) == list(b["names"]) and a["data"].shape == (5, 7 * 160, 2)
        np.testing.assert_allclose(a["data"], b["data"], atol=2e-5)
    else:
        np.testing.assert_allclose(xvg.load_sxydylist(t["vec_file"])[2],
                                   xvg.load_sxydylist(j["vec_file"])[2], atol=2e-5)


def test_stage_switches_and_two_trajectories(system):
    """do_ct / do_s2 / do_vec_* off write nothing of theirs; two
    trajectories pool their chunks; float64 arithmetic on request."""
    p = str(system["tmp"] / "few")
    out = tstages.stage_ct_streamed([system["xtc"]], [system["ref"]], p, tau_memory=TAU,
                                    do_s2=False, do_vec_dist=False, do_vec_avg=False,
                                    device="cpu")
    assert "S2" not in out and "avgvec" not in out and set(out["acc"]) == {
        "ct_ext_s", "ct_ext_s2", "ct_int_s", "ct_int_s2"}
    assert not os.path.exists(p + "_S2.dat") and not os.path.exists(p + "_vecHistogram.npz")
    two = tstages.stage_ct_streamed([system["xtc"], system["xtc"]], [system["ref"]],
                                    str(system["tmp"] / "two"), tau_memory=TAU, device="cpu",
                                    dtype=torch.float64)
    assert two["n_chunks"] == 14 and two["Ct"].dtype == np.float64
    np.testing.assert_allclose(two["Ct"], out["Ct"], atol=1e-5)


def test_stage_options_not_ported_name_their_roadmap_item(system):
    args = ([system["xtc"]], [system["ref"]], str(system["tmp"] / "no"))
    with pytest.raises(NotImplementedError, match="item 15"):
        tstages.stage_ct_streamed(*args, tau_memory=TAU, mesh=object(), device="cpu")
    for mode in ("ired", "wired"):  # ported (item 13); 5 bonds are too few for 5 global modes
        with pytest.raises(ValueError, match="more residues"):
            tstages.stage_ct_streamed(*args, tau_memory=TAU, s2_mode=mode, device="cpu")
    with pytest.raises(ValueError, match="s2_mode"):
        tstages.stage_ct_streamed(*args, tau_memory=TAU, s2_mode="other", device="cpu")
    with pytest.raises(ValueError, match="vec_storage"):
        tstages.stage_ct_streamed(*args, tau_memory=TAU, vec_storage="Other", device="cpu")
    with pytest.raises(ValueError, match="no complete"):
        tstages.stage_ct_streamed(*args, tau_memory=1e5, device="cpu")
    with pytest.raises(ValueError, match="matches no atoms"):
        tstages.stage_ct_streamed(*args, tau_memory=TAU, fit_sel="name XX", device="cpu")


def test_entry_points_default_to_the_card(system):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults run")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tstages.stage_ct_streamed([system["xtc"]], [system["ref"]],
                                  str(system["tmp"] / "c"), tau_memory=TAU)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ct_entry()


def test_histogram_spills_to_the_host_total(system, monkeypatch):
    """With the spill threshold lowered to one group, the int32 device
    histogram folds into the int64 host total after every group and the
    written counts are unchanged."""
    p0, p1 = str(system["tmp"] / "s0"), str(system["tmp"] / "s1")
    kw = dict(tau_memory=TAU, chunk_groups=2, do_ct=False, do_s2=False, device="cpu")
    tstages.stage_ct_streamed([system["xtc"]], [system["ref"]], p0, **kw)
    monkeypatch.setattr(tstages, "_HIST_SPILL_FRAMES", 100)
    out = tstages.stage_ct_streamed([system["xtc"]], [system["ref"]], p1, **kw)
    assert int(out["acc"]["hist"].sum()) == 0  # everything spilled
    a, b = (np.load(p + "_vecHistogram.npz", allow_pickle=True)["data"] for p in (p0, p1))
    np.testing.assert_array_equal(a, b)


def test_ct_entry_and_the_stage_dictionary_round_trip(system):
    """ct_entry runs file -> rates on the CPU; the JAX stage's dictionary
    converts to the port's accumulators (run_finish starts from them) and
    back, to float32 rounding."""
    out, rates = ct_entry(device="cpu", n_res=4, n_frames=1500, tau_memory=250.0)
    assert out["n_chunks"] == 6 and rates.R1.shape == (4,)
    for f in ("R1", "R2", "NOE", "rho"):
        assert torch.isfinite(getattr(rates, f)).all()
    j = jstages.stage_ct_streamed([system["xtc"]], [system["ref"]],
                                  str(system["tmp"] / "jc"), tau_memory=TAU, chunk_groups=2)
    s, s2, n = convert.palmer_state_from_stage(j, 7, device="cpu")
    assert s.shape == (80, 5) and n == 7
    back = convert.stage_from_palmer_state(s, s2, n, j["res_ids"], j["delta_t"])
    np.testing.assert_allclose(back["Ct"], np.asarray(j["Ct"]), atol=1e-6)
    np.testing.assert_allclose(back["dCt"], np.asarray(j["dCt"]), atol=1e-6)
    from spinrelax_tpu_torch.models.diffusion import Diffusion
    from spinrelax_tpu_torch.parallel.streamed import run_finish

    fin = run_finish(s, s2, n, n_res=5, delta_t=j["delta_t"],
                     diffusion=Diffusion.isotropic(diso=3.3e-4))
    np.testing.assert_allclose(fin.Ct.numpy().T, np.asarray(j["Ct"]), atol=1e-6)
    assert torch.isfinite(fin.R1).all()
    with pytest.raises(ValueError, match="n_chunks"):
        convert.palmer_state_from_stage(j, 1, device="cpu")
