"""The streamed C(t) stage's copies to the device (pipeline.h2d).

On the CPU: the stage takes no pinned path (``stage_ct.h2d_pinned_bytes``
stays 0, ``stage_ct.h2d_bytes`` counts every group's observables); its
accumulators equal those of the stage's loop before the pinned copies
(written out below) over groups in order, a short tail group and a
float64 S; a group's plan through the slots; the slots' host threads and
their scoped setting; the Lambert histogram's counts against
``torch.bincount``.

Marked ``cuda`` (they skip here): the device tensors equal the host arrays
bit for bit over more groups than slots, from a producer that reuses one
buffer too, and for a group above the slot cap that goes in pieces; the
stage's five artefacts are byte-identical to those of the pageable copies
on the same input; the histogram on the card equals bincount's.  The file
imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_h2d_staging.py
"""

import functools

import numpy as np
import pytest
import torch

from spinrelax_tpu_torch.core import geometry
from spinrelax_tpu_torch.entry import synthetic_system
from spinrelax_tpu_torch.io import native
from spinrelax_tpu_torch.ops import orient
from spinrelax_tpu_torch.pipeline import h2d, stages
from spinrelax_tpu_torch.utils import profiling

TAU, FPC, GROUPS = 400.0, 160, 2  # the synthetic system's 2.5 ps frames
ARTEFACTS = ("_Ctext.dat", "_Ctint.dat", "_avgvec.dat", "_vecHistogram.npz", "_S2.dat")


@pytest.fixture(scope="module")
def system(tmp_path_factory):
    """5 residues, 1200 frames 2.5 ps apart: the stage's bonds and dt."""
    tmp = tmp_path_factory.mktemp("h2d")
    ref, xtc, _ = synthetic_system(tmp, n_res=5, n_frames=1200, dt=2.5, seed=4)
    return dict(tmp=tmp, ref=ref, xtc=xtc)


def _observables(n_frames, n_bonds, s_dtype, seed):
    """(raw_diff f32 (F, nBonds, 3), S (F, 3, 3)) as a decoder gives them."""
    rng = np.random.default_rng(seed)
    raw = (0.1 * rng.standard_normal((n_frames, n_bonds, 3))).astype(np.float32)
    S = (rng.standard_normal((n_frames, 3, 3)) + 2.0 * np.eye(3)).astype(s_dtype)
    return raw, S


def _groups(raw, S, group_frames):
    return [(raw[lo: lo + group_frames], S[lo: lo + group_frames])
            for lo in range(0, raw.shape[0], group_frames)]


def _stage_on(system, monkeypatch, raw, S, prefix, device="cpu"):
    """stage_ct_streamed on the system's files, its decoder stood in for by
    the groups of (raw, S)."""
    def source(fn, chunk_frames, idx_h, idx_x, A, threads=1, out_dtype=np.float32):
        assert fn == system["xtc"] and len(idx_h) == raw.shape[1]
        for r, s in _groups(raw, S, chunk_frames):
            yield r, s, np.zeros(r.shape[0], np.float32)

    monkeypatch.setattr(native, "iter_xtc_obs", source)
    return stages.stage_ct_streamed([system["xtc"]], [system["ref"]], prefix, TAU,
                                    chunk_groups=GROUPS, device=device)


def _loop_before_pinned_copies(raw, S, device="cpu"):
    """The stage's loop as it was before the pinned copies: each group's
    arrays by ``torch.from_numpy(a).to(device, dtype)``, the bond vectors,
    the zero-padded tail and its weights from the host."""
    dev = torch.device(device)
    acc = {}
    for r, s in _groups(raw, S, FPC * GROUPS):
        n_full = r.shape[0] // FPC * FPC
        if n_full == 0:
            continue
        f = torch.from_numpy(r).dtype
        bv = orient.bond_vectors_from_obs(torch.from_numpy(r).to(device=dev, dtype=f),
                                          torch.from_numpy(s).to(device=dev, dtype=f))
        g = n_full // FPC
        vr = bv.raw[:n_full].reshape(g, FPC, -1, 3)
        vf = bv.fitted[:n_full].reshape(g, FPC, -1, 3)
        if not acc:
            acc.update(stages.init_accumulators(r.shape[1], FPC, f, dev))
        g_pad = GROUPS - g
        if g_pad > 0:
            z = vr.new_zeros((g_pad,) + vr.shape[1:])
            vr, vf = torch.cat([vr, z]), torch.cat([vf, z])
        w_g = torch.cat([torch.ones(g), torch.zeros(max(g_pad, 0))]).to(device=dev, dtype=f)
        new, _ = stages.fused_group_update(vr, vf, w_g, None, acc)
        acc.update(new)
    return acc


# -- the CPU ------------------------------------------------------------------

@pytest.mark.parametrize("n_frames,s_dtype", [
    (960, np.float32),  # three whole groups
    (1130, np.float32),  # and a tail group of one chunk and 10 frames
    (1130, np.float64),  # the decoder's float64 S, rounded to the raw's float32
    (1030, np.float64),  # a tail shorter than a chunk: dropped, not copied
])
def test_cpu_stage_equals_the_loop_before_pinned_copies(system, monkeypatch, tmp_path,
                                                        n_frames, s_dtype):
    raw, S = _observables(n_frames, 5, s_dtype, seed=n_frames)
    before = profiling.counters()
    out = _stage_on(system, monkeypatch, raw, S, str(tmp_path / "t"))
    after = profiling.counters()
    assert after["stage_ct.h2d_pinned_bytes"] == before["stage_ct.h2d_pinned_bytes"]
    copied = sum(r.nbytes + s.nbytes for r, s in _groups(raw, S, FPC * GROUPS)
                 if r.shape[0] >= FPC)
    assert after["stage_ct.h2d_bytes"] - before["stage_ct.h2d_bytes"] == copied
    want = _loop_before_pinned_copies(raw, S)
    assert out["n_chunks"] == n_frames // FPC
    for key in ("ct_ext_s", "ct_ext_s2", "ct_int_s", "ct_int_s2", "s2_s", "s2_s2", "vec_sum"):
        assert out["acc"][key].dtype == torch.float32
        assert torch.equal(out["acc"][key], want[key]), key
    hist = np.load(str(tmp_path / "t_vecHistogram.npz"), allow_pickle=True)["data"]
    np.testing.assert_array_equal(hist, want["hist"].numpy())


def test_cpu_copier_is_the_arrays_themselves():
    """On the CPU a group in its own dtype is the decoder's memory (no
    copy); another dtype is converted."""
    raw, S = _observables(40, 3, np.float64, seed=1)
    copy = h2d.copier("cpu")
    r, s = copy([raw, S], torch.float32)
    assert r.data_ptr() == raw.ctypes.data and s.dtype == torch.float32
    assert torch.equal(s, torch.from_numpy(S).to(torch.float32))


@pytest.mark.parametrize("counts,item,slot,piece,n_fills", [
    ([20000 * 370 * 3, 20000 * 9], 4, 256 << 20, 32 << 20, 1),  # the mbp group, 4 pieces
    ([1000, 9], 4, 4096, 32 << 20, 1),  # 4032 + 64 bytes: the slot exactly
    ([1100, 9], 4, 4096, 32 << 20, 2),  # over the cap: through both slots in turns
    ([1000, 9], 4, 4096, 1000, 2),  # pieces of 1000 bytes, each at a 64-byte boundary
    ([777, 1, 0, 65], 8, 1024, 256, 7),
    ([0], 4, 64, 64, 1),
])
def test_plan_covers_each_element_once_within_the_slot(counts, item, slot, piece, n_fills):
    fills = h2d.plan(counts, item, slot, piece)
    assert len(fills) == n_fills
    seen = [[] for _ in counts]
    for fill in fills:
        end = 0
        for i, lo, hi, off in fill:
            assert off % 64 == 0 and off >= end and lo < hi
            assert (hi - lo) * item <= piece
            end = off + (hi - lo) * item
            assert end <= slot
            seen[i].append((lo, hi))
    for n, pieces in zip(counts, seen):
        flat = [x for p in pieces for x in range(*p)]
        assert flat == list(range(n))
    for fill, nxt in zip(fills, fills[1:]):  # a fill closes when the next piece has no room
        i, lo, hi, _ = fill[-1]
        used = -(-(fill[-1][3] + (hi - lo) * item) // 64) * 64
        assert fill and slot - used < item


def test_host_threads_share_the_cores_among_a_hosts_ranks(monkeypatch):
    monkeypatch.setattr(h2d.os, "sched_getaffinity", lambda pid: set(range(32)))
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    assert h2d.host_threads(None) == 32
    assert h2d.host_threads(mesh=object()) == 8
    monkeypatch.delenv("LOCAL_WORLD_SIZE")
    assert h2d.host_threads(mesh=object()) == 32


def test_intra_op_threads_is_restored_after_the_block():
    was = torch.get_num_threads()
    with h2d.intra_op_threads(was + 1):
        assert torch.get_num_threads() == was + 1
    assert torch.get_num_threads() == was
    with pytest.raises(RuntimeError, match="inside"):
        with h2d.intra_op_threads(1):
            raise RuntimeError("inside")
    assert torch.get_num_threads() == was


def _bincount_histogram(vecs, valid, bins_phi, bins_cos):
    phi = torch.arctan2(vecs[..., 1], vecs[..., 0])
    cth = torch.clamp(vecs[..., 2], -1.0, 1.0)
    ix = torch.clamp(((phi + np.pi) / (2 * np.pi) * bins_phi).to(torch.int32), 0, bins_phi - 1)
    iy = torch.clamp(((cth + 1.0) / 2.0 * bins_cos).to(torch.int32), 0, bins_cos - 1)
    flat = (ix * bins_cos + iy).to(torch.int64)
    flat = torch.where(valid.broadcast_to(flat.shape), flat, bins_phi * bins_cos)
    rows = [torch.bincount(r, minlength=bins_phi * bins_cos + 1)[: bins_phi * bins_cos]
            for r in flat.reshape(-1, flat.shape[-1])]
    return torch.stack(rows).reshape(flat.shape[:-1] + (bins_phi, bins_cos)).to(torch.int32)


def _histogram_equals_bincount(device):
    g = torch.Generator(device=device).manual_seed(7)
    v = torch.randn((3, 4, 5000, 3), generator=g, device=device)
    v = v / v.norm(dim=-1, keepdim=True)
    v[0, 0, :3] = torch.tensor([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, 0.0, -1.0]])
    valid = torch.rand((1, 5000), generator=g, device=device) > 0.25
    got, _, _ = geometry.lambert_histogram(v, 72, 36, valid=valid)
    assert got.dtype == torch.int32 and got.shape == (3, 4, 72, 36)
    assert torch.equal(got, _bincount_histogram(v, valid, 72, 36))
    assert int(got.sum()) == 12 * int(valid.sum())


def test_lambert_histogram_equals_bincount():
    _histogram_equals_bincount("cpu")


# -- the card -----------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the pinned copies run on a card)")
    return torch.device("cuda")


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint8 if a.dtype.itemsize == 1 else f"u{a.dtype.itemsize}")


def _special(raw):
    """Plant bits a value-wise compare would miss: NaN payloads, -0, inf,
    subnormals."""
    flat = raw.reshape(-1).view(np.uint32)
    flat[:5] = [0x7FC00001, 0x80000000, 0x7F800000, 0x00000001, 0xFFFFFFFF]
    return raw


@pytest.mark.cuda
def test_copies_equal_the_host_arrays_over_more_groups_than_slots(card):
    copy = h2d.PinnedCopier(card, threads=4)
    groups = [_observables(n, 37, np.float32, seed=n) for n in (400, 400, 400, 400, 130)]
    groups[0] = (_special(groups[0][0]), groups[0][1])
    before = profiling.counters()["stage_ct.h2d_pinned_bytes"]
    got = [copy([r, s], torch.float32) for r, s in groups]  # no sync between groups
    torch.cuda.synchronize()
    for (r, s), (rd, sd) in zip(groups, got):
        assert rd.device.type == "cuda" and rd.shape == r.shape and sd.shape == s.shape
        assert np.array_equal(_bits(rd.cpu().numpy()), _bits(r))
        assert np.array_equal(_bits(sd.cpu().numpy()), _bits(s))
    after = profiling.counters()["stage_ct.h2d_pinned_bytes"]
    assert after - before == sum(r.nbytes + s.nbytes for r, s in groups)
    # a later stage's copier takes the same stream, so the device blocks
    # the allocator keeps for it serve again: no new device memory
    del got, rd, sd
    torch.cuda.synchronize()
    segments = torch.cuda.memory_stats()["segment.all.allocated"]
    again = h2d.PinnedCopier(card, threads=4)
    assert again.stream == copy.stream
    got = [again([r, s], torch.float32) for r, s in groups]
    torch.cuda.synchronize()
    assert torch.cuda.memory_stats()["segment.all.allocated"] == segments


@pytest.mark.cuda
def test_float64_S_rounds_as_the_pageable_copy(card):
    raw, S = _observables(400, 37, np.float64, seed=3)
    S[0, 0, :3] = [1.0 + 2.0 ** -24, 1.0 + 3 * 2.0 ** -25, -(1.0 + 2.0 ** -25)]  # ties
    got = h2d.PinnedCopier(card, threads=4)([raw, S], torch.float32)
    want = h2d.pageable([raw, S], torch.float32, card)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == torch.float32
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
def test_a_producer_reusing_its_buffer_gives_each_groups_bits(card):
    copy = h2d.PinnedCopier(card, threads=4)
    buf = np.empty((2000, 370, 3), np.float32)
    want, got = [], []
    for k in range(6):
        buf[:] = np.random.default_rng(k).standard_normal(buf.shape, dtype=np.float32)
        want.append(buf.copy())
        (d,) = copy([buf], torch.float32)
        got.append(d)
        # keep the card busy, so the copies of later groups queue behind it
        torch.cuda._sleep(2_000_000)
    torch.cuda.synchronize()
    for w, d in zip(want, got):
        assert np.array_equal(_bits(d.cpu().numpy()), _bits(w))


@pytest.mark.cuda
def test_a_group_above_the_cap_goes_in_pieces(card, monkeypatch):
    monkeypatch.setattr(h2d, "SLOT_BYTES", 1 << 16)
    copy = h2d.PinnedCopier(card, threads=4)
    groups = [_observables(n, 37, np.float32, seed=n) for n in (400, 400, 171)]
    got = [copy([r, s], torch.float32) for r, s in groups]
    torch.cuda.synchronize()
    assert [t.numel() for t in copy.slots] == [1 << 16, 1 << 16]
    for (r, s), (rd, sd) in zip(groups, got):
        assert np.array_equal(_bits(rd.cpu().numpy()), _bits(r))
        assert np.array_equal(_bits(sd.cpu().numpy()), _bits(s))


@pytest.mark.cuda
def test_stage_artefacts_equal_the_pageable_copies(card, tmp_path, monkeypatch):
    ref, xtc, _ = synthetic_system(tmp_path, n_res=40, n_frames=4000, dt=2.0, seed=5)
    outs, counts = {}, {}
    for name in ("pinned", "pageable"):
        if name == "pageable":
            monkeypatch.setattr(h2d, "copier",
                                lambda dev, mesh=None: functools.partial(h2d.pageable,
                                                                         dev=torch.device(dev)))
        before = profiling.counters()
        outs[name] = stages.stage_ct_streamed([xtc], [ref], str(tmp_path / name), 400.0,
                                              chunk_groups=2, device="cuda")
        after = profiling.counters()
        counts[name] = {k: after[k] - before[k]
                        for k in ("stage_ct.h2d_bytes", "stage_ct.h2d_pinned_bytes")}
    assert counts["pinned"]["stage_ct.h2d_pinned_bytes"] == counts["pinned"]["stage_ct.h2d_bytes"]
    assert counts["pageable"]["stage_ct.h2d_pinned_bytes"] == 0
    assert counts["pageable"]["stage_ct.h2d_bytes"] == counts["pinned"]["stage_ct.h2d_bytes"] > 0
    for suffix in ARTEFACTS:
        a = (tmp_path / ("pinned" + suffix)).read_bytes()
        assert a == (tmp_path / ("pageable" + suffix)).read_bytes(), suffix
    for key, t in outs["pinned"]["acc"].items():
        assert torch.equal(t, outs["pageable"]["acc"][key]), key


@pytest.mark.cuda
def test_lambert_histogram_on_the_card_equals_bincount(card):
    _histogram_equals_bincount("cuda")
