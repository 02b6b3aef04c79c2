"""Workflow stages of the port: the streamed C(t) stage (port of
``spinrelax_tpu/pipeline/stages.py:1188 stage_ct_streamed`` and its fused
per-group update, ``:1105 _streamed_update_program``).

The in-memory ``stage_ct`` and the other stages come with ROADMAP item 14.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .. import checked_device
from ..constants import DEFAULT_ZETA
from ..core import geometry
from ..core import quaternion as qt
from ..io import native as natio
from ..io import pdb as pdbio
from ..io import trajectory as trajio
from ..io import vectors as vecio
from ..io import xvg
from ..ops import autocorr, orient


def _fit_weights(top, fit_sel: str) -> np.ndarray:
    """0/1 fit-weight vector for the orientation/superpose functions.
    Raises on an empty selection: an all-zero weight vector makes the
    weight normalisation 0/0, so every quaternion -- and all downstream
    C(t)/S2 -- would be silently NaN."""
    fit_idx = top.select(fit_sel)
    if len(fit_idx) == 0:
        raise ValueError(
            f"fit selection {fit_sel!r} matches no atoms -- orientation "
            "fitting needs at least one reference atom"
        )
    w = np.zeros(top.n_atoms)
    w[fit_idx] = 1.0
    return w


def init_accumulators(n_bonds: int, fpc: int, dtype, device, do_ct: bool = True,
                      do_s2: bool = True, do_vec_avg: bool = True,
                      do_hist: bool = True, hist_bins=(72, 36)) -> dict:
    """Zeroed accumulators of :func:`fused_group_update` for ``n_bonds``
    bonds and Palmer chunks of ``fpc`` frames, on ``device``.  The C(t)
    sums are lag-leading (nDeltas, nBonds): kernel A's own orientation and
    what ``parallel.streamed.run_finish`` takes."""
    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    z = {}
    if do_ct:
        for key in ("ext", "int"):
            z[f"ct_{key}_s"] = zeros(fpc // 2, n_bonds)
            z[f"ct_{key}_s2"] = zeros(fpc // 2, n_bonds)
    if do_s2:
        z["s2_s"], z["s2_s2"] = zeros(n_bonds), zeros(n_bonds)
    if do_vec_avg:
        z["vec_sum"] = zeros(n_bonds, 3)
    if do_hist:
        z["hist"] = zeros(n_bonds, *hist_bins, dt=torch.int32)
    return z


def fused_group_update(vec_raw_g, vec_fit_g, w_g, q_rot, acc: dict,
                       want_pt: bool = False):
    """One group step of :func:`stage_ct_streamed`: the C(t) lag sums of
    the raw and the superposed vectors (kernel A, twice, on the card) with
    their Palmer statistics, the S2 blocks, the average vector and the
    Lambert histogram, each added to the accumulator ``acc`` holds for it
    (:func:`init_accumulators`; a missing key skips its part).

    vec_raw_g, vec_fit_g : (g, fpc, nBonds, 3) unit vectors of g chunks.
    w_g : (g,) 1.0 for real chunks, 0.0 for the zero-padded tail chunks of
        a partial final group.
    q_rot : optional (4,) quaternion applied to the superposed vectors
        before S2, the average and the histogram.
    want_pt : also return the (g * fpc, nBonds, 2) (phi, theta) of the
        superposed vectors (the PhiTheta storages).

    Returns (new accumulators, (phi, theta) or None)."""
    g, fpc, n_bonds, _ = vec_raw_g.shape
    out = dict(acc)

    if "ct_int_s" in acc:
        for key, vv in (("ext", vec_raw_g), ("int", vec_fit_g)):
            out[f"ct_{key}_s"], out[f"ct_{key}_s2"] = autocorr.stream_update(
                vv, acc[f"ct_{key}_s"], acc[f"ct_{key}_s2"], weights=w_g)

    flat = vec_fit_g.reshape(-1, n_bonds, 3)
    if q_rot is not None:
        flat = qt.rotate_vector(flat, q_rot)
    wf = torch.repeat_interleave(w_g, fpc)  # per-frame weights

    if "s2_s" in acc:
        # palmer_pooled_stats convention: e = S2_block - 1, e**2.
        e2b = autocorr.s2_block_values(flat.reshape(g, fpc, n_bonds, 3)) - 1.0
        out["s2_s"] = acc["s2_s"] + torch.sum(w_g[:, None] * e2b, dim=0)
        out["s2_s2"] = acc["s2_s2"] + torch.sum(w_g[:, None] * e2b**2, dim=0)

    if "vec_sum" in acc:
        out["vec_sum"] = acc["vec_sum"] + torch.sum(wf[:, None, None] * flat, dim=0)

    if "hist" in acc:
        nb_x, nb_y = acc["hist"].shape[1:]
        h, _, _ = geometry.lambert_histogram(flat.transpose(0, 1), nb_x, nb_y,
                                             valid=(wf > 0)[None, :])
        out["hist"] = acc["hist"] + h

    return out, (geometry.xyz_to_pt(flat) if want_pt else None)


_HIST_SPILL_FRAMES = 2**31 - 2**24


def stage_ct_streamed(
    traj_files: Sequence[str],
    ref_pdbs: Sequence[str],
    out_prefix: str,
    tau_memory: float,
    chunk_groups: int = 4,
    timestep: Optional[float] = None,
    q_rot: Optional[np.ndarray] = None,
    h_sel: str = "name H",
    x_sel: str = "name N and not resname PRO",
    fit_sel: str = "occupancy > 0",
    zeta: float = DEFAULT_ZETA,
    do_ct: bool = True,
    do_s2: bool = True,
    s2_mode: str = "outer",  # outer | ired | wired
    do_vec_dist: bool = True,
    do_vec_avg: bool = True,
    vec_storage: str = "Histogram",
    hist_bins: int = 72,
    mesh=None,
    device="cuda",
    dtype=None,
):
    """Streamed C(t) stage: trajectories are consumed in groups of Palmer
    chunks (``chunk_groups`` chunks of tau_memory each per device step)
    with running accumulators for C(t), S2, the average vector and the
    Lambert histograms -- the full trajectory never exists in host or
    device memory.  Replaces the reference's ``--split`` memory workaround
    (calculate-Ct-from-traj.py:426-453) with true streaming.

    The host reduces each group of frames to bond differences and 3x3 Horn
    correlations (inside the .xtc decoder for .xtc input); the device turns
    them into raw and superposed unit bond vectors and runs
    :func:`fused_group_update`.  Writes ``_Ctext.dat``, ``_Ctint.dat``,
    ``_S2.dat``, ``_avgvec.dat`` and the vector distribution
    (``_vecHistogram.npz``, or ``_vecPhiTheta.npz`` / ``.dat``).

    ``timestep`` is required for inputs with no time axis (.npy, .pdb).
    ``device``: the card unless the caller asks for ``"cpu"``; raises
    without one.  ``dtype``: the device arithmetic's dtype (default: the
    observables', float32 for every binary trajectory format).

    Returns a dict: res_ids, delta_t, Ct and dCt (nDeltas, nBonds; of the
    superposed vectors), S2 (nBonds, 2), avgvec (nBonds, 3), vec_file (all
    numpy), and for ``parallel.streamed.run_finish`` the device
    accumulators ``acc`` and the chunk count ``n_chunks``.

    Not ported yet: ``mesh`` (ROADMAP item 15) and ``s2_mode`` "ired" /
    "wired" (ROADMAP item 13) raise ``NotImplementedError``.
    """
    if mesh is not None:
        raise NotImplementedError(
            "stage_ct_streamed(mesh=...): the sharded stream comes with ROADMAP item 15")
    if s2_mode not in ("outer", "ired", "wired"):
        raise ValueError(f"unknown s2_mode {s2_mode!r}")
    if do_s2 and s2_mode != "outer":
        raise NotImplementedError(
            f"s2_mode={s2_mode!r}: ops/ired.py (IredStream) comes with ROADMAP item 13")
    if do_vec_dist and vec_storage not in ("Histogram", "PhiTheta", "TextPhiTheta"):
        raise ValueError(f"unknown vec_storage {vec_storage!r}")
    dev = checked_device(device)
    if len(ref_pdbs) == 1:
        ref_pdbs = list(ref_pdbs) * len(traj_files)

    res_ids = None
    delta_t = None
    fpc = None  # frames per Palmer chunk
    acc = {}
    n_chunks_total = 0
    pt_writer = None  # lazy PhiTheta stream writer (storage != Histogram)
    hist_nb = (hist_bins, hist_bins // 2)
    do_hist = bool(do_vec_dist and vec_storage == "Histogram")
    want_pt = bool(do_vec_dist and not do_hist)
    hist_host = None  # int64 host total the int32 device histogram spills into
    frames_since_spill = 0
    vec_dtype = None  # dtype of the device arithmetic

    def spill_hist():
        """Fold the int32 device histogram into the int64 host total and
        zero the device accumulator (a long stream can exceed int32; the
        worst case is every frame of one bond in one bin, so spilling
        while frames-since-spill < 2^31 is always safe)."""
        nonlocal hist_host
        if "hist" in acc:
            h = acc["hist"].cpu().numpy().astype(np.int64)
            hist_host = h if hist_host is None else hist_host + h
            acc["hist"] = torch.zeros_like(acc["hist"])

    def accumulate(vec_raw_g, vec_fit_g):
        """vec_*_g: (g, fpc, nBonds, 3) device tensors for one group."""
        nonlocal n_chunks_total, pt_writer, frames_since_spill, vec_dtype
        g = vec_raw_g.shape[0]
        vec_dtype = vec_raw_g.dtype
        if not acc:
            acc.update(init_accumulators(
                vec_raw_g.shape[2], fpc, vec_raw_g.dtype, dev, do_ct=do_ct,
                do_s2=do_s2, do_vec_avg=do_vec_avg, do_hist=do_hist, hist_bins=hist_nb))
        # Zero-pad a partial final group to the fixed group size, so every
        # group step has one shape; padded chunks carry weight 0.
        g_pad = chunk_groups - g
        if g_pad > 0:
            z = vec_raw_g.new_zeros((g_pad,) + vec_raw_g.shape[1:])
            vec_raw_g = torch.cat([vec_raw_g, z], dim=0)
            vec_fit_g = torch.cat([vec_fit_g, z], dim=0)
        w_g = torch.cat([torch.ones(g), torch.zeros(max(g_pad, 0))]).to(
            device=dev, dtype=vec_raw_g.dtype)
        new_acc, pt = fused_group_update(vec_raw_g, vec_fit_g, w_g, q_rot_t, acc, want_pt)
        acc.update(new_acc)
        if pt is not None:
            if pt_writer is None:
                text = vec_storage == "TextPhiTheta"
                pt_writer = vecio.PhiThetaStreamWriter(
                    out_prefix + ("_vecPhiTheta.dat" if text else "_vecPhiTheta.npz"),
                    res_ids, fmt="text" if text else "npz")
            # Slice off the zero-padded tail frames before writing.
            pt_writer.append(pt[: g * fpc].cpu().numpy())
        frames_since_spill += g * fpc
        if frames_since_spill > _HIST_SPILL_FRAMES:
            spill_hist()
            frames_since_spill = 0
        n_chunks_total += g

    q_rot_t = None
    for trj_fn, ref_fn in zip(traj_files, ref_pdbs):
        top, ref_xyz = pdbio.read_structure(ref_fn)
        idx_h, idx_x, res_h = pdbio.bond_indices(top, h_sel, x_sel)
        w = _fit_weights(top, fit_sel)
        ref0 = ref_xyz[0]

        if timestep is None and trajio.is_timeless(trj_fn):
            # No time axis in the file: iter_trajectory would echo a
            # silent 1.0 ps back, mis-scaling fpc and every lag time.
            raise ValueError(
                f"{trj_fn!r}: this format carries no time axis -- pass "
                "timestep explicitly"
            )
        # Probe the timestep with a single-frame read (each iter_trajectory
        # call restarts the file, so the probe consumes nothing).
        _, dt = next(trajio.iter_trajectory(trj_fn, chunk_frames=1, top_fn=ref_fn,
                                            timestep=timestep or 1.0))
        if delta_t is None:
            delta_t = dt if timestep is None else timestep
            fpc = int(tau_memory / delta_t)
            res_ids = list(res_h)
        elif list(res_h) != res_ids or (
            timestep is None and abs(dt - delta_t) > 1e-9 * max(dt, delta_t)
        ):
            raise ValueError("trajectories disagree in residues or timestep")

        group_frames = fpc * chunk_groups

        def obs_chunks():
            """Stream (raw_diff, S) group observables.  Plain .xtc input
            routes the bond_obs reduction INTO the decoder
            (io.native.iter_xtc_obs): the full (F, nAtoms, 3) coordinate
            block never materialises.  Everything else decodes full chunks
            and reduces via bond_obs_host (identical contract)."""
            if trj_fn.endswith(".xtc"):
                A = orient.bond_obs_matrix(ref0, w)
                for raw_diff, S, _times in natio.iter_xtc_obs(
                        trj_fn, group_frames, idx_h, idx_x, A, threads=0):
                    yield raw_diff, S
                return
            for xyz_chunk, _ in trajio.iter_trajectory(
                    trj_fn, chunk_frames=group_frames, top_fn=ref_fn, timestep=delta_t):
                yield orient.bond_obs_host(xyz_chunk, ref0, idx_h, idx_x, w)

        for raw_diff, S in obs_chunks():
            # Only the (F, nBonds, 3) bond differences and the (F, 3, 3)
            # Horn correlations cross host -> device, not the (F, nAtoms, 3)
            # coordinate block the decoder produced.
            n_full = (raw_diff.shape[0] // fpc) * fpc
            if n_full == 0:
                continue  # tail shorter than one Palmer chunk: dropped
            f = dtype or torch.from_numpy(raw_diff).dtype
            bv = orient.bond_vectors_from_obs(
                torch.from_numpy(raw_diff).to(device=dev, dtype=f),
                torch.from_numpy(S).to(device=dev, dtype=f))
            if q_rot is not None and q_rot_t is None:
                q_rot_t = torch.as_tensor(np.asarray(q_rot), dtype=f, device=dev)
            g = n_full // fpc
            accumulate(bv.raw[:n_full].reshape(g, fpc, -1, 3),
                       bv.fitted[:n_full].reshape(g, fpc, -1, 3))

    if n_chunks_total == 0:
        raise ValueError("no complete Palmer chunks found in the input")

    out = {"res_ids": res_ids, "delta_t": delta_t, "n_chunks": n_chunks_total}
    dt_lags = autocorr.lag_times(delta_t, tau_memory).numpy()
    R = float(n_chunks_total)

    if do_ct:
        for key, suffix in (("ext", "_Ctext.dat"), ("int", "_Ctint.dat")):
            mean, dct = autocorr.palmer_pooled_stats(acc[f"ct_{key}_s"],
                                                     acc[f"ct_{key}_s2"], R)
            mean, dct = mean.cpu().numpy(), dct.cpu().numpy()  # (nDeltas, nBonds)
            xvg.print_sxylist(out_prefix + suffix, res_ids, dt_lags,
                              np.stack([mean.T, dct.T], axis=-1))
            if key == "int":
                out["Ct"], out["dCt"] = mean, dct

    if do_vec_avg:
        avg = qt.vecnorm(acc["vec_sum"] / (R * fpc)).cpu().numpy()
        xvg.print_xylist(out_prefix + "_avgvec.dat", res_ids, avg.T, cols=True)
        out["avgvec"] = avg

    if do_vec_dist:
        if do_hist:
            spill_hist()  # fold the device int32 into the int64 total
            ep, ec = geometry.lambert_edges(*hist_nb, dtype=vec_dtype)
            vecio.save_histogram(out_prefix + "_vecHistogram.npz", res_ids, hist_host,
                                 ep.numpy(), ec.numpy())
            out["vec_file"] = out_prefix + "_vecHistogram.npz"
        elif pt_writer is not None:
            pt_writer.close()
            out["vec_file"] = pt_writer.fn

    if do_s2:
        s2, ds2 = autocorr.palmer_pooled_stats(acc["s2_s"], acc["s2_s2"], R)
        arr = np.stack([s2.cpu().numpy(), ds2.cpu().numpy()], axis=-1)
        xvg.print_xylist(out_prefix + "_S2.dat", res_ids, (arr.T) * zeta, cols=True)
        out["S2"] = arr
    out["acc"] = acc
    return out
