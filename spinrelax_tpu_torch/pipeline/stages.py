"""Workflow stages: functions with file artefacts at the boundaries (port
of ``spinrelax_tpu/pipeline/stages.py``).

Each stage mirrors one reference CLI script and runs its compute on a
torch device, the card unless the caller asks for the CPU; the artefact
formats are byte-compatible with the JAX package's and the reference's, so
a stage of either package reads the other's files.  Ported: the
orientation colvar, Delta-q -> D tensor, the in-memory and the streamed
C(t) stages (outer-product and iRED / wiRED S2), the C(t) fit, the
relaxation predictions with the legacy single-field fits, and the
multi-field global fit (``stage_multifield``).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import checked_device
from ..constants import BOND_ISOTOPES, DEFAULT_ZETA, NucleusPair, field_from_mhz
from ..core import geometry
from ..core import quaternion as qt
from ..core.stats import simple_total_mean_square
from ..fit.expfit import fit_ct_ladder
from ..io import colvar as colvario
from ..io import dx as dxio
from ..io import fittedct as fctio
from ..io import native as natio
from ..io import pdb as pdbio
from ..io import trajectory as trajio
from ..io import vectors as vecio
from ..io import xvg
from ..io.zopen import is_gz, topen
from ..models.ctmodel import CtModelSet
from ..models.diffusion import Diffusion
from ..ops import autocorr, ired, observables, orient
from ..ops import dq as dqops
from ..parallel.mesh import barrier, device_of, is_writer
from ..utils import profiling
from . import h2d


def _written(mesh, write) -> None:
    """Run ``write`` (an artefact write) on the writing rank only -- every
    process without a mesh, rank 0 with one -- then wait for every rank,
    so none reads the file before it exists."""
    if is_writer(mesh):
        write()
    barrier(mesh)


def _artefact(mesh, write, *paths) -> None:
    """One artefact of :func:`stage_ct_streamed`: ``write`` on the writing
    rank, its files' sizes then counted in ``stage_ct.write_bytes``."""
    _written(mesh, write)
    if is_writer(mesh):
        profiling.count("stage_ct.write_bytes", sum(os.path.getsize(p) for p in paths))


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


# ---------------------------------------------------------------------------
# Stage 1: orientation quaternions (replaces GROMACS+PLUMED external step)
# ---------------------------------------------------------------------------


def stage_orientation(
    traj_files: Sequence[str],
    ref_pdb: str,
    out_colvar: str,
    fit_sel: str = "occupancy > 0",
    force: bool = False,
    timestep: Optional[float] = None,
    device="cuda",
) -> str:
    """Compute q(t) of each trajectory vs the reference structure and write
    a PLUMED-format colvar (concatenated for multiple trajectories, as
    run-all.bash:366 does with `cat`).

    The frames go to ``device`` (the card unless ``device="cpu"``) and the
    Horn fit runs in float64, as the JAX stage's does; the rows are written
    in one native call (``io.native.write_table``, "%16g"), or by numpy for
    a .gz colvar.

    ``timestep`` overrides the frame spacing -- REQUIRED for formats with
    no time axis (.pdb/bare .npy): the colvar's time column is what the dq
    stage later reads delta_t from."""
    if os.path.exists(out_colvar) and not force:
        return out_colvar
    dev = checked_device(device)
    top, ref_xyz = pdbio.read_structure(ref_pdb)
    weights = torch.as_tensor(_fit_weights(top, fit_sel), device=dev)
    ref = torch.as_tensor(ref_xyz[0], dtype=torch.float64, device=dev)
    mode = "w"
    for fn in traj_files:
        if timestep is None and trajio.is_timeless(fn):
            raise ValueError(
                f"{fn!r}: this format carries no time axis -- pass "
                "timestep explicitly (the colvar's time column defines "
                "the dq stage's delta_t)"
            )
        xyz, dt = trajio.load_trajectory(fn, top_fn=ref_pdb)
        if timestep is not None:
            dt = timestep
        frames = torch.from_numpy(np.ascontiguousarray(xyz)).to(dev).double()
        q = orient.orientation_quats(frames, ref, weights).cpu().numpy()
        del frames
        t = np.arange(q.shape[0]) * dt
        data = np.concatenate([t[:, None], q], axis=1)
        with topen(out_colvar, mode) as fp:
            print("#! FIELDS time q.w q.x q.y q.z", file=fp)
        if is_gz(out_colvar):
            with topen(out_colvar, "a") as fp:
                np.savetxt(fp, data, fmt="%16g", delimiter=" ")
        else:
            natio.write_table(out_colvar, data, append=True)
        mode = "a"
    return out_colvar


# ---------------------------------------------------------------------------
# Stage 2: Delta-q -> D tensor (calculate-dq-distribution.py)
# ---------------------------------------------------------------------------


def _format_dq_headers(res: dqops.DqResult) -> Tuple[List[str], List[str]]:
    """Reproduce the reference's iso/aniso header formats exactly -- the
    run-all script greps Diso/Dani_L/Drho_L/Dani_S/Drho_S and the PAF
    quaternion out of them (run-all.bash:393,412-416;
    calculate-dq-distribution.py:221-275)."""
    has_chunks = res.iso_tau_chunks.size > 0

    def flex_bounds(x, samples):
        mean, sig = np.mean(samples), np.std(samples)
        return x, sig + x - mean, sig + mean - x

    iso_lines = []
    if has_chunks:
        b = flex_bounds(res.iso_tau, res.iso_tau_chunks)
        iso_lines.append("# model fit, tau = %e +- %e %e [ps]" % b)
        dvals = 0.5e12 / res.iso_tau_chunks
        b = flex_bounds(res.D_iso, dvals)
        iso_lines.append("# Converted D_iso = %e +- %e %e [s^-1]" % b)
        for i, d in enumerate(dvals):
            iso_lines.append("# Chunk_%d D_iso = %e [s^-1]" % (i, d))
    else:
        iso_lines.append("# model fit, tau = %e [ps]" % res.iso_tau)
        iso_lines.append("# Converted D_iso = %e [s^-1]" % res.D_iso)
    iso_lines.append("# t cos(th) P2[cos(th)] cos(th/2) th")

    aniso_lines = []
    Dval = res.D_axes
    anis = res.anisotropies
    if has_chunks:
        Dch = 0.5e12 / res.aniso_tau_chunks  # (nChunk, 3)
        for i in range(3):
            b = flex_bounds(res.aniso_taus[i], res.aniso_tau_chunks[:, i])
            aniso_lines.append("# model fit, e_%i tau = %e +- %e %e [ps]" % ((i,) + b[:3]))
            b = flex_bounds(Dval[i], Dch[:, i])
            aniso_lines.append("# Converted D_%i = %e +- %e %e [s^-1]" % ((i,) + b[:3]))
        errs = np.std(res.anis_chunk_samples, axis=0)
        labels = ["Diso", "Dani_L", "Drho_L", "Dani_S", "Drho_S"]
        fmts = ["# Converted %s = %e +- %e [s^-1]", "# Converted %s = %f +- %f",
                "# Converted %s = %f +- %f", "# Converted %s = %f +- %f",
                "# Converted %s = %f +- %f"]
        for lab, fmt, v, e in zip(labels, fmts, anis, errs):
            aniso_lines.append(fmt % (lab, float(v), e))
        for j in range(Dch.shape[0]):
            for i in range(3):
                aniso_lines.append("# Chunk_%d D_%d = %e [s^-1]" % (j, i, Dch[j, i]))
    else:
        for i in range(3):
            aniso_lines.append("# model fit, e_%i tau = %e [ps]" % (i, res.aniso_taus[i]))
            aniso_lines.append("# Converted D_%i = %e [s^-1]" % (i, Dval[i]))
        aniso_lines.append("# Converted Diso = %e [s^-1]" % anis[0])
        aniso_lines.append("# Converted Dani_L = %f" % anis[1])
        aniso_lines.append("# Converted Drho_L = %f" % anis[2])
        aniso_lines.append("# Converted Dani_S = %f" % anis[3])
        aniso_lines.append("# Converted Drho_S = %f" % anis[4])
    aniso_lines.append("# t <1-2x^2> <1-2y^2> <1-2z^2>")
    aniso_lines.append(
        "# Quaternion orientation frame: %f %f %f %f" % tuple(res.q_frame)
    )
    return iso_lines, aniso_lines


def _print_graphs(fn, header, x, groups):
    """print_model_fits_gen equivalent
    (calculate-dq-distribution.py:277-328): groups is a list of 2D arrays
    (nPlots, nPts); one graph per group."""
    with open(fn, "w") as fp:
        for line in header:
            print(line, file=fp)
        if len(groups) == 1:
            s = 0
            for row in groups[0]:
                print("@target g0.s%d" % s, file=fp)
                for xi, yi in zip(x, row):
                    print("%g %g" % (xi, yi), file=fp)
                print("&", file=fp)
                s += 1
        else:
            for g in range(len(groups)):
                print("@g%d on" % g, file=fp)
            for g, grp in enumerate(groups):
                s = 0
                for row in grp:
                    print("@target g%d.s%d" % (g, s), file=fp)
                    for xi, yi in zip(x, row):
                        print("%g %g" % (xi, yi), file=fp)
                    print("&", file=fp)
                    s += 1
            print("@arrange(%i, %i, 0.1, 0.1, 0.1)" % (2, int(0.5 * len(groups) + 0.5)), file=fp)
            for i in range(len(groups)):
                print("@with g%i" % i, file=fp)
                if i == 0:
                    print('@subtitle "Aggregate Data"', file=fp)
                print("@autoscale", file=fp)


def stage_dq(
    colvar_file: str,
    out_prefix: str,
    min_dt: float,
    max_dt: float,
    skip_dt: float,
    n_chunks: int = 0,
    multi: bool = False,
    do_hist: bool = False,
    hist_bins: int = 101,
    hist_format: str = "dat",  # 'dx' | 'dat' | 'none'
    do_full_tensor: bool = False,
    force: bool = False,
    stream_chunk: int = 0,
    do_iso: bool = True,
    do_aniso: bool = True,
    device="cuda",
) -> dqops.DqResult:
    """Global tumbling analysis; writes {pref}-iso.dat, {pref}-aniso2.dat,
    {pref}-aniso_q.dat, {pref}-moi.xyz; optionally per-lag 3D delta-q
    histograms ({pref}-hist-<dt>ps.dx/.dat) and the full 3x3 tensor trace
    ({pref}-tensor.dat).  The statistics run in float64 on ``device`` (the
    card unless ``device="cpu"``).

    stream_chunk > 0 enables the constant-memory streaming path: the
    colvar is read and analysed in blocks of that many frames.  Chunked
    uncertainties (n_chunks), per-lag histograms, the full-tensor trace
    and multi-replica aggregates all work in this mode (single-colvar
    uncertainties add one frame-counting pre-pass).

    Resume lives in the orchestrator (runall's content-hash manifest) --
    this stage always computes; ``force`` is accepted for signature
    symmetry with the other stages.
    """
    dev = checked_device(device)

    def _load_q(fn):
        """(delta_t, q (N,4)) from a PLUMED colvar or a GROMACS
        ``gmx rotmat`` .xvg (rotation matrices -> INVERSE quaternions,
        calculate-dq-distribution.py:389-407,490-495)."""
        if fn.endswith((".xvg", ".xvg.gz")):
            t, ys = xvg.load_xys(fn)
            R = torch.as_tensor(np.asarray(ys, dtype=np.float64).reshape(len(t), 3, 3))
            return float(t[1] - t[0]), qt.qconj(qt.mat_to_quat(R)).numpy()
        fields, data = colvario.read_colvar(fn)
        return float(data[0, 1] - data[0, 0]), data[1:5].T.astype(np.float64)

    if stream_chunk > 0 and multi:
        # Constant-memory multi-replica path: replica boundaries are the
        # FIELDS headers, exactly like read_colvar_multi; per-replica
        # streamed sums pool like analyse_dq_multi.
        if colvar_file.endswith((".xvg", ".xvg.gz")):
            raise ValueError(
                "--multi reads aggregate PLUMED colvars; gmx-rotmat .xvg "
                "files are single-trajectory (no replica headers)"
            )
        if stream_chunk < 2:
            raise ValueError("--stream chunk size must be >= 2")
        it = colvario.iter_colvar_chunks_multi(colvar_file, stream_chunk)
        try:
            rep0, _fields0, first = next(it)
        except StopIteration:
            raise ValueError(f"{colvar_file!r}: no data rows") from None
        if first.shape[0] < 2:
            raise ValueError(
                f"{colvar_file!r}: need >= 2 data rows in the first "
                "replica block to infer the timestep"
            )
        delta_t = float(first[1, 0] - first[0, 0])

        def rep_chunks():
            yield rep0, first[:, 1:5]
            for rep, _f, block in it:
                yield rep, block[:, 1:5]

        res = dqops.analyse_dq_multi_streamed(
            rep_chunks(), delta_t, min_dt, max_dt, skip_dt,
            chunk_frames=stream_chunk, n_chunks=n_chunks, device=dev,
        )
    elif stream_chunk > 0:
        n_total = None
        if colvar_file.endswith((".xvg", ".xvg.gz")):
            delta_t, q_all = _load_q(colvar_file)
            n_total = q_all.shape[0]

            def q_chunks():
                for off in range(0, q_all.shape[0], stream_chunk):
                    yield q_all[off: off + stream_chunk]
        else:
            if n_chunks > 0:
                # Sub-chunk uncertainties need the total length up front
                # (the reference's blocking is defined on it, calculate-
                # dq-distribution.py:128-144): one counting pre-pass.
                n_total = colvario.count_colvar_rows(colvar_file)
            if stream_chunk < 2:
                raise ValueError("--stream chunk size must be >= 2")
            it = colvario.iter_colvar_chunks(colvar_file, stream_chunk)
            try:
                fields0, first = next(it)
            except StopIteration:
                raise ValueError(f"{colvar_file!r}: no data rows") from None
            if first.shape[0] < 2:
                raise ValueError(
                    f"{colvar_file!r}: need >= 2 data rows to infer the "
                    "timestep"
                )
            delta_t = float(first[1, 0] - first[0, 0])

            def q_chunks():
                yield first[:, 1:5]
                for _, block in it:
                    yield block[:, 1:5]

        res = dqops.analyse_dq_streamed(
            q_chunks(), delta_t, min_dt, max_dt, skip_dt,
            chunk_frames=stream_chunk, n_chunks=n_chunks, n_total=n_total,
            hist_bins=(hist_bins if do_hist and hist_format != "none" else 0),
            device=dev,
        )
    elif multi:
        # (nReplicas, nTime, nFields): per-replica statistics, pooled
        # delta-q samples (calculate-dq-distribution-multi.py).
        fields, data = colvario.read_colvar_multi(colvar_file)
        qs = [d[:, 1:5] for d in data]
        delta_t = float(data[0][1, 0] - data[0][0, 0])
        res = dqops.analyse_dq_multi(qs, delta_t, min_dt, max_dt, skip_dt, n_chunks,
                                     device=dev)
    else:
        delta_t, q = _load_q(colvar_file)
        res = dqops.analyse_dq(q, delta_t, min_dt, max_dt, skip_dt, n_chunks, device=dev)

    iso_hdr, aniso_hdr = _format_dq_headers(res)
    x = res.lag_times
    if do_iso:
        groups = [np.stack([res.iso, res.iso_models[0]])]
        for i in range(res.iso_chunks.shape[0]):
            groups.append(np.stack([res.iso_chunks[i], res.iso_models[1 + i]]))
        _print_graphs(out_prefix + "-iso.dat", iso_hdr, x, groups)

    if do_aniso:
        groups = [np.concatenate([res.aniso, res.aniso_models[0]])]
        for i in range(res.aniso_chunks.shape[0]):
            groups.append(np.concatenate([res.aniso_chunks[i], res.aniso_models[1 + i]]))
        _print_graphs(out_prefix + "-aniso2.dat", aniso_hdr, x, groups)

        # Per-lag PAF quaternions; first line carries the locked PAF, which
        # run-all extracts with `head -n 1 ... | awk '{print $2,$3,$4,$5}'`.
        xvg.print_xylist(out_prefix + "-aniso_q.dat", x, res.q_per_lag.T, cols=True)

        with open(out_prefix + "-moi.xyz", "w") as fp:
            for axes in res.axes_per_lag:
                print("3", file=fp)
                print("AXES", file=fp)
                for lab, row in zip("XYZ", axes):
                    print("%s %g %g %g" % (lab, row[0], row[1], row[2]), file=fp)

    if do_full_tensor and do_aniso:
        # <(Rv)(Rv)^T> components per lag in the locked PAF
        # (calculate-dq-distribution.py:610-611,722-723), from the raw M
        # every analyse path carries.
        R = qt.quat_to_mat(torch.as_tensor(res.q_frame)).numpy()
        MR = np.einsum("ab,lbc,dc->lad", R, res.M, R)
        xvg.print_xylist(out_prefix + "-tensor.dat", res.lag_times,
                         MR.reshape(len(x), 9).T, cols=True)

    if do_hist and hist_format != "none" and not multi:
        lags = np.rint(res.lag_times / delta_t).astype(int)
        hedges = tuple(np.linspace(-1.0, 1.0, hist_bins + 1) for _ in range(3))
        for li, delta in enumerate(lags):
            if res.hist is not None:
                # streamed: analyse_dq_streamed already density-normalised
                # the pooled counts -- do NOT normalise again.
                hist = res.hist[li]
            else:
                hist, hedges = np.histogramdd(
                    dqops.dq_vectors(q, int(delta)), bins=(hist_bins,) * 3,
                    range=((-1, 1),) * 3, density=True,
                )
            out_file = "%s-hist-%sps.%s" % (out_prefix, res.lag_times[li], hist_format)
            if hist_format == "dx":
                xmin = [0.5 * (e[0] + e[1]) for e in hedges]
                abc = np.diag([(e[-1] - e[0]) / hist_bins for e in hedges])
                dxio.write_dx(out_file, hist, (hist_bins,) * 3, xmin, abc, units="nm")
            else:
                xvg.print_gplot_hist(out_file, hist, hedges)
    return res


# ---------------------------------------------------------------------------
# Stage 3: trajectory -> C(t), S2, vector distributions
# (calculate-Ct-from-traj.py)
# ---------------------------------------------------------------------------


def stage_ct(
    traj_files: Sequence[str],
    ref_pdbs: Sequence[str],
    out_prefix: str,
    tau_memory: Optional[float],
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
    vec_storage: str = "Histogram",  # Histogram | PhiTheta | TextPhiTheta
    hist_bins: int = 72,
    force: bool = False,
    timestep: Optional[float] = None,
    device="cuda",
):
    """Compute bond-vector statistics with the whole trajectory in memory.
    Writes {pref}_Ctext.dat, {pref}_Ctint.dat, {pref}_vecHistogram.npz /
    _vecPhiTheta.*, {pref}_avgvec.dat, {pref}_S2.dat.

    The host reduces each trajectory to bond differences and 3x3 Horn
    correlations (``orient.bond_obs_host``), which go to ``device`` (the
    card unless ``device="cpu"``) in one copy; there the raw and superposed
    bond vectors are formed and their C(t) taken by kernel A
    (``autocorr.ct_palmer``), in float32 on the card (kernel A's dtype) and
    float64 on the CPU.

    ``timestep`` overrides the frame spacing reported by the trajectory
    loader (for formats that carry no time axis).  ``s2_mode`` "ired" /
    "wired" take S2 from the eigenmodes of the raw vectors' blocks
    (``ops.ired``) and also write ``{pref}_iREDspectrum.dat``."""
    if s2_mode not in ("outer", "ired", "wired"):
        raise ValueError(f"unknown s2_mode {s2_mode!r}")
    if do_vec_dist and vec_storage not in ("Histogram", "PhiTheta", "TextPhiTheta"):
        raise ValueError(f"unknown vec_storage {vec_storage!r}")
    dev = checked_device(device)
    f = torch.float32 if dev.type == "cuda" else torch.float64
    if len(ref_pdbs) == 1:
        ref_pdbs = list(ref_pdbs) * len(traj_files)

    res_ids = None
    delta_t = None
    vec_raw_list, vec_fit_list = [], []
    for trj_fn, ref_fn in zip(traj_files, ref_pdbs):
        top, ref_xyz = pdbio.read_structure(ref_fn)
        idx_h, idx_x, res_h = pdbio.bond_indices(top, h_sel, x_sel)
        w = _fit_weights(top, fit_sel)
        if timestep is None and trajio.is_timeless(trj_fn):
            raise ValueError(
                f"{trj_fn!r}: this format carries no time axis -- pass "
                "timestep explicitly"
            )
        xyz, dt = trajio.load_trajectory(trj_fn, top_fn=ref_fn)
        if timestep is not None:
            dt = timestep
        raw_diff, S = orient.bond_obs_host(xyz, ref_xyz[0], idx_h, idx_x, w)
        del xyz
        bv = orient.bond_vectors_from_obs(torch.from_numpy(raw_diff).to(dev, f),
                                          torch.from_numpy(S).to(dev, f))
        if res_ids is None:
            res_ids, delta_t = list(res_h), dt
        elif list(res_h) != res_ids or (
            # relative tolerance: f32 timestamps of a late-starting
            # segment differ in the last ulp
            abs(dt - delta_t) > 1e-9 * max(abs(dt), abs(delta_t))
        ):
            raise ValueError("trajectories disagree in residues or timestep")
        vec_raw_list.append(bv.raw)
        vec_fit_list.append(bv.fitted)

    if tau_memory is None:
        # No memory time (calculate-Ct-from-traj.py:509-514,643-644):
        # statistics run unblocked over all frames; C(t) is refused.
        if do_ct:
            raise ValueError("C(t) analysis needs a memory time (tau_memory=None)")
        vec_raw = torch.cat(vec_raw_list)[None]
        vec_fit = torch.cat(vec_fit_list)[None]
        dt_lags = None
    else:
        vec_raw = autocorr.reformat_by_tau(vec_raw_list, delta_t, tau_memory)
        vec_fit = autocorr.reformat_by_tau(vec_fit_list, delta_t, tau_memory)
        dt_lags = autocorr.lag_times(delta_t, tau_memory).numpy()
    del vec_raw_list, vec_fit_list

    out = {}
    if do_ct:
        for vv, suffix in ((vec_raw, "_Ctext.dat"), (vec_fit, "_Ctint.dat")):
            Ct, dCt = (a.cpu().numpy() for a in autocorr.ct_palmer(vv))
            xvg.print_sxylist(out_prefix + suffix, res_ids, dt_lags,
                              np.stack([Ct.T, dCt.T], axis=-1))
        out["Ct"], out["dCt"] = Ct, dCt

    # Flatten chunks for the remaining statistics; iRED works on the raw
    # (lab-frame) vectors: the tumbling modes are separated spectrally.
    flat = vec_fit.reshape(-1, vec_fit.shape[-2], vec_fit.shape[-1])
    raw_flat = (vec_raw.reshape(-1, vec_raw.shape[-2], vec_raw.shape[-1])
                if do_s2 and s2_mode != "outer" else None)
    del vec_raw, vec_fit
    if q_rot is not None:
        flat = qt.rotate_vector(flat, torch.as_tensor(np.asarray(q_rot), dtype=f, device=dev))

    if do_vec_avg:
        avg = qt.vecnorm(flat.mean(dim=0)).cpu().numpy()
        xvg.print_xylist(out_prefix + "_avgvec.dat", res_ids, avg.T, cols=True)
        out["avgvec"] = avg

    if do_vec_dist:
        per_res = flat.transpose(0, 1)  # (nRes, nFrames, 3)
        if vec_storage == "Histogram":
            hist, ep, ec = geometry.lambert_histogram(per_res, hist_bins, hist_bins // 2)
            out["vec_file"] = out_prefix + "_vecHistogram.npz"
            vecio.save_histogram(out["vec_file"], res_ids, hist.cpu().numpy(),
                                 ep.cpu().numpy(), ec.cpu().numpy())
        elif vec_storage == "PhiTheta":
            out["vec_file"] = out_prefix + "_vecPhiTheta.npz"
            vecio.save_phitheta(out["vec_file"], res_ids,
                                geometry.xyz_to_pt(per_res).cpu().numpy())
        else:
            rtp = geometry.xyz_to_rtp(per_res).cpu().numpy()
            out["vec_file"] = out_prefix + "_vecPhiTheta.dat"
            with open(out["vec_file"], "w") as fp:
                for i, rid in enumerate(res_ids):
                    print('@s%d legend "%s"' % (i, rid), file=fp)
                    for j in range(rtp.shape[1]):
                        print("%g %g" % (rtp[i, j, 1], rtp[i, j, 2]), file=fp)
                    print("&", file=fp)

    if do_s2:
        if s2_mode != "outer":
            if tau_memory is None:
                raise ValueError("iRED/wiRED S2 needs a memory time")
            fn = ired.calculate_s2_ired if s2_mode == "ired" else ired.calculate_s2_wired
            s2 = _ired_spectrum_artefact(out_prefix, fn(raw_flat, delta_t, tau_memory / 10.0))
        elif tau_memory is None:
            # Unblocked S2, value only (calculate-S2.py:122-125,143).
            s2 = autocorr.s2_outer(flat).cpu().numpy()
        else:
            s2 = autocorr.s2_outer_blocked(flat, delta_t, tau_memory).cpu().numpy()
        xvg.print_xylist(out_prefix + "_S2.dat", res_ids, (s2.T) * zeta, cols=True)
        out["S2"] = s2

    out["res_ids"] = res_ids
    out["delta_t"] = delta_t
    return out


def _ired_spectrum_artefact(out_prefix: str, res_i, mesh=None) -> np.ndarray:
    """Write {pref}_iREDspectrum.dat (block-mean eigenvalues, descending,
    with sqrt(n)-1 SEM; the reorientational 5-mode subspace leads; rank 0
    of a ``mesh`` writes) and return the (nRes, 2) [S2, dS2] array --
    shared by the in-memory and streamed C(t) stages."""
    s2 = np.stack([res_i.S2.cpu().numpy(), res_i.dS2.cpu().numpy()], axis=-1)
    vals = res_i.eigenvalues.cpu().numpy()  # (nBlocks, nRes)
    lam = np.mean(vals, axis=0)
    dlam = np.std(vals, axis=0) / max(np.sqrt(vals.shape[0]) - 1.0, 1.0)
    _written(mesh, lambda: xvg.print_xydy(
        out_prefix + "_iREDspectrum.dat",
        np.arange(1, lam.shape[0] + 1), lam, dlam,
        header="# iRED eigenmode spectrum (descending); "
               "modes 1-5 span global reorientation",
    ))
    return s2


# ---------------------------------------------------------------------------
# Stage 4: C(t) -> fitted multi-exponential parameters
# (calculate-fitted-Ct.py)
# ---------------------------------------------------------------------------


def stage_fit_ct(
    ct_files: Sequence[str],
    out_prefix: str,
    n_components: Optional[int] = None,
    use_s2fast: bool = True,
    force: bool = False,
    optimiser: str = "lm",
    n_starts: int = 1,
    retry_starts: int = 8,
    mesh=None,
    device="cuda",
) -> CtModelSet:
    """Fit every residue's C(t) of ``ct_files`` with the DoF ladder
    (``fit_ct_ladder``: kernels B and C on the card, float64 on the CPU)
    and write {pref}_fittedCt.dat; several files are averaged first, with
    their errors pooled, into {pref}_averageCt.dat.  ``optimiser="varpro"``
    walks the ladder with the variable-projection fit (``fit_ct_ladder``).
    ``mesh`` (``parallel.mesh.make_mesh``): every rank reads the files and
    the ladder's LMs fit each rank's slice of the residues on its device
    (``fit_ct_ladder(mesh=)``); rank 0 writes the artefacts."""
    if mesh is not None:
        device = device_of(mesh)
    out_fn = out_prefix + "_fittedCt.dat"
    legs, dts, cts, dcts = xvg.load_sxydylist(ct_files[0], "legend")
    dt = np.asarray(dts)[0]
    decays = np.asarray(cts)
    ddecays = np.asarray(dcts) if len(dcts) else None
    if len(ct_files) > 1:
        # Replica averaging with error pooling
        # (calculate-fitted-Ct.py:113-147).
        all_ct, all_dct = [decays], [ddecays]
        for fn in ct_files[1:]:
            l2, d2, c2, e2 = xvg.load_sxydylist(fn, "legend")
            if l2 != legs or not np.allclose(np.asarray(d2)[0], dt):
                raise ValueError(f"{fn}: time/legend entries differ")
            all_ct.append(np.asarray(c2))
            all_dct.append(np.asarray(e2) if len(e2) else None)
        stack = np.stack(all_ct)
        decays = np.mean(stack, axis=0)
        if any(d is None for d in all_dct):
            ddecays = np.std(stack, axis=0)
        else:
            ddecays = np.sqrt(simple_total_mean_square(
                torch.from_numpy(stack), torch.from_numpy(np.stack(all_dct))).numpy())
        # Averaged-C(t) report artefact in the reference's INTENDED
        # format (calculate-fitted-Ct.py:140-147: bare float prints,
        # one '&' per leg).
        def write_average():
            with open(out_prefix + "_averageCt.dat", "w") as fp:
                for i in range(len(legs)):
                    for j in range(decays.shape[1]):
                        print(dt[j], decays[i][j], ddecays[i][j], file=fp)
                    print("&", file=fp)

        _written(mesh, write_average)

    model = fit_ct_ladder(
        names=legs,
        dt=dt,
        decays=decays,
        ddecays=ddecays,
        use_s2fast=use_s2fast,
        n_components=n_components,
        optimiser=optimiser,
        n_starts=n_starts,
        retry_starts=retry_starts,
        mesh=mesh,
        device=device,
    )
    _written(mesh, lambda: fctio.write_fittedct(out_fn, model, dt=dt, targets=decays))
    return model


# ---------------------------------------------------------------------------
# Stage 5: relaxation prediction (calculate-relaxations-from-Ct)
# ---------------------------------------------------------------------------


def stage_relax(
    fittedct_file: str,
    out_prefix: str,
    diffusion: Diffusion,
    vec_file: Optional[str] = None,
    q_rot: Optional[np.ndarray] = None,
    freq_mhz: float = 600.133,
    nuclei: str = "NH",
    time_unit: str = "ps",
    zeta: float = DEFAULT_ZETA,
    csa: Optional[np.ndarray] = None,
    jomega: bool = False,
    shift_res: int = 0,
    expt_file: Optional[str] = None,
    opt_mode: Optional[str] = None,
    max_cycles: int = 100,
    tol: float = 1e-6,
    opt_method: str = "powell",
    force: bool = False,
    vec_avg_file: Optional[str] = None,
    ref_pdb: Optional[str] = None,
    traj_file: Optional[str] = None,
    ref_hsel: str = "name H",
    ref_xsel: str = "name N and not resname PRO",
    device="cuda",
):
    """Predict R1/R2/NOE/rho (or J(w)) at one field on ``device`` (the card
    unless ``device="cpu"``, float64); writes {pref}_R1.dat, _R2.dat,
    _NOE.dat, _rho.dat or _Jw.dat.

    Vector sources, in reference precedence
    (calculate-relaxations-from-Ct.py:636-656): ``vec_avg_file`` (-v,
    average X-H vectors as an xvg table), then ``vec_file`` (--distfn
    npz distribution), then ``ref_pdb`` [+ ``traj_file``] (vectors taken
    directly from structure/trajectory, no fitting).

    With ``expt_file`` + ``opt_mode``, first fits global parameters
    against a 3/6-column experimental table (legacy modes Diso / DisoS2 /
    DisoCSA / DisoS2CSA / new, calculate-relaxations-from-Ct.py:865-1000)
    on ``device`` (``fit.legacyfit.fit_legacy``).
    """
    cts = fctio.read_fittedct(fittedct_file, device=device).with_zeta(zeta)
    pair = NucleusPair(isotope_a=BOND_ISOTOPES[nuclei], B0=field_from_mhz(freq_mhz),
                       time_unit=time_unit)

    vecs = weights = None
    if diffusion.kind != "isotropic":
        names = None
        if vec_avg_file is not None:
            res_v, block = xvg.load_xys(vec_avg_file)
            names = [str(int(x) + shift_res) for x in res_v]
            vecs = np.asarray(block[:, :3], dtype=np.float64)
            vecs /= np.linalg.norm(vecs, axis=-1, keepdims=True)
        elif vec_file is not None:
            names, vecs, weights = vecio.load_vector_distribution(vec_file)
            names = [str(int(x) + shift_res) for x in names]
        elif ref_pdb is not None:
            # Vectors straight from the structure (no fitting); with a
            # trajectory, every frame contributes an ensemble sample
            # (reference's extract_vectors_from_structure, :44-69,
            # implemented as intended).
            top, ref_xyz = pdbio.read_structure(ref_pdb)
            idx_h, idx_x, res_h = pdbio.bond_indices(top, ref_hsel, ref_xsel)
            if traj_file is not None:
                xyz, _ = trajio.load_trajectory(traj_file, top_fn=ref_pdb)
            else:
                xyz = ref_xyz
            v = xyz[:, idx_h, :] - xyz[:, idx_x, :]
            v /= np.linalg.norm(v, axis=-1, keepdims=True)
            names = [str(int(x) + shift_res) for x in res_h]
            vecs = v[0] if v.shape[0] == 1 else np.swapaxes(v, 0, 1)
        if vecs is not None:
            if names != cts.names:
                raise ValueError("resid mismatch between fittedCt and vector source")
            if q_rot is not None:
                vecs = qt.rotate_vector(torch.as_tensor(np.asarray(vecs, dtype=np.float64)),
                                        torch.as_tensor(np.asarray(q_rot, dtype=np.float64))
                                        ).numpy()

    sim_resid = cts.names
    opt_header = ""
    if expt_file is not None and opt_mode is not None:
        from ..fit.legacyfit import fit_legacy

        exp_resid, expblock = xvg.load_xys(expt_file)
        exp_names = [str(int(x)) for x in exp_resid]
        ny = expblock.shape[1]
        if ny == 6:
            exp = expblock.reshape(len(exp_resid), 3, 2)[..., 0]
            exp_err = expblock.reshape(len(exp_resid), 3, 2)[..., 1]
        elif ny == 3:
            exp, exp_err = expblock, None
        else:
            raise ValueError(f"{expt_file}: expected 3 or 6 data columns")

        # Residue-intersection filtering
        # (calculate-relaxations-from-Ct.py:801-851).
        shared = [n for n in sim_resid if n in exp_names]
        if not shared:
            raise ValueError("no overlap between experimental and simulated residues")
        sim_idx = np.array([sim_resid.index(n) for n in shared])
        exp_idx = np.array([exp_names.index(n) for n in shared])
        result = fit_legacy(
            opt_mode, pair, diffusion, cts.select(sim_idx),
            exp[exp_idx], None if exp_err is None else exp_err[exp_idx],
            vecs=None if vecs is None else vecs[sim_idx],
            weights=None if weights is None else weights[sim_idx],
            csa0=None if csa is None else np.asarray(csa)[sim_idx],
            max_cycles=max_cycles, tol=tol, method=opt_method,
        )
        diffusion = diffusion.with_diso(result.diso)
        zeta_eff = zeta * result.s2_scale
        cts = cts.with_zeta(zeta_eff)
        if csa is None:
            csa = np.full(len(sim_resid), pair.csa_value)
        csa = np.asarray(csa, dtype=float).copy()
        csa[sim_idx] = result.csa
        if opt_mode == "new":
            xvg.print_xy(out_prefix + "_CSA_values.dat", sim_resid, csa)
        lines = []
        for name, val, scale, unit, was_fit in (
            ("Diso", result.diso, 1.0, "ps^-1", True),
            ("zeta", zeta_eff, 1.0, "a.u.", "S2" in opt_mode),
            ("CSA", float(np.mean(csa)), 1e6, "ppm", "CSA" in opt_mode or opt_mode == "new"),
            ("chi", np.sqrt(result.chisq), 1.0, "a.u.", True),
        ):
            status = "Optimised" if was_fit else "Fixed"
            lines.append("# %s %s: %g %s" % (status, name, val * scale, unit))
        opt_header = "\n".join(lines)
        print(opt_header)

    if jomega:
        J, dJ = observables.predict_jomega(pair, diffusion, cts, vecs=vecs, weights=weights)
        omega = np.abs(np.asarray(pair.omega5()))
        order = np.argsort(omega)
        J_np = J.cpu().numpy()
        dJ_np = None if dJ is None else dJ.cpu().numpy()
        with open(out_prefix + "_Jw.dat", "w") as fp:
            if dJ_np is not None:
                print("@type xydy", file=fp)
            for i, rid in enumerate(sim_resid):
                print('@s%d legend "Resid: %s"' % (i, rid), file=fp)
                for j in order:
                    if dJ_np is not None:
                        print("%g %g %g" % (omega[j], J_np[i, j], dJ_np[i, j]), file=fp)
                    else:
                        print("%g %g" % (omega[j], J_np[i, j]), file=fp)
                print("&", file=fp)
        return J

    rates = observables.predict_rates(pair, diffusion, cts, vecs=vecs, weights=weights,
                                      csa=csa)
    host = {k: None if v is None else v.cpu().numpy() for k, v in rates._asdict().items()}
    for name in ("R1", "R2", "NOE", "rho"):
        header = "" if name == "rho" else opt_header
        if host["d" + name] is not None:
            xvg.print_xydy(f"{out_prefix}_{name}.dat", sim_resid, host[name], host["d" + name],
                           header=header)
        else:
            xvg.print_xy(f"{out_prefix}_{name}.dat", sim_resid, host[name], header=header)
    return rates


def stage_relax_theoretical(
    diffusion: Diffusion,
    freq_mhz: float = 600.133,
    nuclei: str = "NH",
    zeta: float = DEFAULT_ZETA,
    device="cuda",
):
    """Rigid-baseline shortcut (--theoretical,
    calculate-relaxations-from-Ct.py:671-687): relaxation of a rigid body
    with no internal motion.  Isotropic -> one triple; axisymmetric ->
    per-axis triples for the three lab axes."""
    pair = NucleusPair(isotope_a=BOND_ISOTOPES[nuclei], B0=field_from_mhz(freq_mhz),
                       time_unit="ps")
    if diffusion.kind == "isotropic":
        cts = CtModelSet.from_lists(["1"], [zeta], [[0.0]], [[99999.0]], device=device)
        return observables.predict_rates(pair, diffusion, cts)
    cts = CtModelSet.from_lists(["1", "2", "3"], [zeta] * 3, [[0.0]] * 3, [[99999.0]] * 3,
                                device=device)
    return observables.predict_rates(pair, diffusion, cts, vecs=np.eye(3))


# ---------------------------------------------------------------------------
# Stage 6: multi-field global fitting (calculate-relaxations-multi-field)
# ---------------------------------------------------------------------------


def stage_multifield(
    fittedct_file: str,
    expt_files: Sequence[str],
    out_prefix: str,
    diffusion: Diffusion,
    vec_file: Optional[str] = None,
    zeta: float = DEFAULT_ZETA,
    csa: Optional[np.ndarray] = None,
    opt_params: Optional[Sequence[str]] = None,
    max_cycles: int = 10,
    tol: float = 1e-6,
    method: str = "powell",
    include_expt: bool = False,
    ref_pdb: Optional[str] = None,
    devices: int = 0,
    device="cuda",
):
    """Fit global parameters against N experiments on ``device`` (the card
    unless ``device="cpu"``, float64) and export per-experiment xvg
    predictions (+ the optimised CSA table when rsCSA is fitted).

    ``ref_pdb`` is the --refpdb alternative vector source (one X-H vector
    per residue straight from the structure,
    calculate-relaxations-multi-field.py:126-129).  ``devices`` > 0 runs
    the optimisation residue-sharded over a ``devices``-rank mesh
    (``parallel.fit.shard_experiment_set``; every rank of the process
    group calls the stage) with the same exports; rank 0 writes them.  It
    needs ``opt_params`` (ValueError before any file is read)."""
    if devices and not opt_params:
        raise ValueError(
            "devices/--devices shards the optimisation: it requires "
            "opt_params/--opt (the plain evaluation is a single cheap "
            "dispatch)"
        )
    mesh = None
    if devices:
        from ..parallel.mesh import make_mesh

        mesh = make_mesh(int(devices), device=device)
        device = device_of(mesh)
    from ..fit.globalfit import EXPORT_SCALING, EXPORT_UNITS, GlobalFitter, _eval_all, host
    from ..io.experiments import read_experiment
    from ..models.experiments import ExperimentSet

    cts = fctio.read_fittedct(fittedct_file, device=device).with_zeta(zeta)
    vecs = weights = vec_names = None
    if vec_file is not None:
        vec_names, vecs, weights = vecio.load_vector_distribution(vec_file)
    elif ref_pdb is not None:
        top, ref_xyz = pdbio.read_structure(ref_pdb)
        idx_h, idx_x, res_h = pdbio.bond_indices(top)
        v = ref_xyz[0, idx_h, :] - ref_xyz[0, idx_x, :]
        vecs = v / np.linalg.norm(v, axis=-1, keepdims=True)
        vec_names = np.asarray(res_h)
    expts = [read_experiment(f) for f in expt_files]
    es = ExperimentSet.build(expts, cts, diffusion, vecs=vecs, weights=weights,
                             vec_names=vec_names, csa=csa)

    if opt_params:
        es_fit = es
        if mesh is not None:
            from ..parallel.fit import shard_experiment_set

            es_fit = shard_experiment_set(es, mesh)
        state = GlobalFitter(es_fit, list(opt_params)).run(max_cycles=max_cycles, tol=tol,
                                                           method=method)
        # the padded residues of a sharded fit ride along; drop them
        final = dict(diso=state.diso, aniso=state.aniso, zeta=state.zeta,
                     csa=np.asarray(state.csa)[: es.n_residues], chisq=state.chisq)
    else:
        csa0 = es.csa
        if csa0 is None:
            csa0 = np.full(es.n_residues, es.experiments[0].pair.csa_value)
        final = dict(diso=float(np.asarray(diffusion.diso)),
                     aniso=float(np.asarray(diffusion.aniso)),
                     zeta=float(zeta), csa=np.asarray(csa0), chisq=None)

    # Predictions at the final parameters, fetched in one read, exported
    # per experiment (export_xvg, spectral_densities.py:1178-1194).
    preds = _eval_all(es, final["diso"], final["aniso"], final["zeta"], final["csa"])
    flat = host(*[x for pr in preds for x in pr if x is not None])
    preds_h = []
    for v, dv in preds:
        va = flat.pop(0)
        preds_h.append((va, None if dv is None else flat.pop(0)))
    opt_list = list(opt_params) if opt_params else []

    def write_exports():
        for e, (va, dva) in zip(es.experiments, preds_h):
            mhz = round(e.pair.B0 * 267.513 / (2.0 * np.pi))
            fn = "%s_%s%s_%iMHz_%s.xvg" % (out_prefix, e.pair.isotope_a, e.pair.isotope_b, mhz,
                                            e.expt_type)
            with open(fn, "w") as fp:
                print("# Type %s" % e.expt_type, file=fp)
                print("# NucleiA %s" % e.pair.isotope_a, file=fp)
                print("# NucleiB %s" % e.pair.isotope_b, file=fp)
                print("# Frequency %g %s" % (e.pair.B0 * 267.513 / (2 * np.pi), "MHz"), file=fp)
                for name in ("Diso", "Daniso", "zeta", "CSA"):
                    val = {"Diso": final["diso"], "Daniso": final["aniso"], "zeta": final["zeta"],
                           "CSA": float(np.mean(final["csa"]))}[name]
                    status = "Optimised" if name in opt_list else "Fixed"
                    if name == "CSA" and "rsCSA" in opt_list:
                        status = "OptimisedMean"
                    print("# %s %s: %g %s"
                          % (status, name, val * EXPORT_SCALING[name], EXPORT_UNITS[name]), file=fp)
                if final["chisq"] is not None:
                    print("# Optimised chi: %g a.u." % np.sqrt(final["chisq"]), file=fp)
                print("", file=fp)
                print("@target s0", file=fp)
                if dva is not None:
                    print("@type xydy", file=fp)
                    for n, yy, ee in zip(cts.names, va, dva):
                        print("%s %g %g" % (n, yy, ee), file=fp)
                else:
                    print("@type xy", file=fp)
                    for n, yy in zip(cts.names, va):
                        print("%s %g" % (n, yy), file=fp)
                print("&", file=fp)
                if include_expt and e.raw is not None:
                    print("@target s1", file=fp)
                    d = e.raw
                    if d.errors is not None:
                        print("@type xydy", file=fp)
                        for n, yy, ee in zip(d.names, d.values, d.errors):
                            print("%s %g %g" % (n, yy, ee), file=fp)
                    else:
                        print("@type xy", file=fp)
                        for n, yy in zip(d.names, d.values):
                            print("%s %g" % (n, yy), file=fp)
                    print("&", file=fp)

        if "rsCSA" in opt_list:
            xvg.print_xy(out_prefix + "_CSA_opt.dat", cts.names, final["csa"])

    _written(mesh, write_exports)
    return final


# ---------------------------------------------------------------------------
# Stage 3, streamed: constant-memory C(t) over trajectory groups
# ---------------------------------------------------------------------------


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


@profiling.span("stage_ct")
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
    correlations (inside the .xtc decoder for .xtc input) and copies them
    to the device (on a card through pinned slots, overlapped with the
    previous group's compute: :mod:`pipeline.h2d`); the device turns
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

    ``s2_mode`` "ired" / "wired" stream the raw vectors through their own
    per-block (nBonds, nBonds) accumulator (``ops.ired.IredStream``)
    instead of the outer-product S2 sums.

    ``mesh`` (``parallel.mesh.make_mesh``): every rank of the mesh calls
    the stage on the same files; the C(t) accumulation (the dominant cost)
    runs through :class:`parallel.streamed.ShardedCtStream` (chunks over
    "rep", bonds over "res", kernel A on each rank's block, one
    all-reduce per sum over "rep"), with the same statistics; the light
    accumulators (S2, histograms, average vector) stay whole on every
    rank, and rank 0 writes the artefacts.  ``acc`` then holds no C(t)
    sums: ``streams`` holds the two ShardedCtStreams ("ext", "int").
    """
    if s2_mode not in ("outer", "ired", "wired"):
        raise ValueError(f"unknown s2_mode {s2_mode!r}")
    do_s2_outer = bool(do_s2 and s2_mode == "outer")
    ired_stream = None
    if do_vec_dist and vec_storage not in ("Histogram", "PhiTheta", "TextPhiTheta"):
        raise ValueError(f"unknown vec_storage {vec_storage!r}")
    dev = checked_device(device) if mesh is None else device_of(mesh)
    if len(ref_pdbs) == 1:
        ref_pdbs = list(ref_pdbs) * len(traj_files)
    do_ct_here = bool(do_ct and mesh is None)
    ct_streams = {}

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
        nonlocal n_chunks_total, pt_writer, frames_since_spill, vec_dtype, ired_stream
        g = vec_raw_g.shape[0]
        vec_dtype = vec_raw_g.dtype
        if do_s2 and not do_s2_outer:
            # Lab-frame (un-superposed) vectors, exactly like the
            # in-memory stage: iRED separates tumbling spectrally.
            if ired_stream is None:
                wf = 5.0 if s2_mode == "ired" else 2.0
                W = max(int(wf * (tau_memory / 10.0) / delta_t), 2)
                ired_stream = ired.IredStream(vec_raw_g.shape[2], W)
            ired_stream.update(vec_raw_g.reshape(-1, vec_raw_g.shape[2], 3))
        if do_ct and mesh is not None:
            from ..parallel.streamed import ShardedCtStream

            for key, vv in (("ext", vec_raw_g), ("int", vec_fit_g)):
                if key not in ct_streams:
                    ct_streams[key] = ShardedCtStream(mesh, fpc, vv.shape[2], dtype=vv.dtype)
                ct_streams[key].update(vv)
        if not acc:
            acc.update(init_accumulators(
                vec_raw_g.shape[2], fpc, vec_raw_g.dtype, dev, do_ct=do_ct_here,
                do_s2=do_s2_outer, do_vec_avg=do_vec_avg, do_hist=do_hist, hist_bins=hist_nb))
        # Zero-pad a partial final group to the fixed group size, so every
        # group step has one shape; padded chunks carry weight 0.
        g_pad = chunk_groups - g
        if g_pad > 0:
            z = vec_raw_g.new_zeros((g_pad,) + vec_raw_g.shape[1:])
            vec_raw_g = torch.cat([vec_raw_g, z], dim=0)
            vec_fit_g = torch.cat([vec_fit_g, z], dim=0)
        # made on the device: a copy from the host would wait for the card
        w_g = (torch.arange(chunk_groups, device=dev) < g).to(vec_raw_g.dtype)
        new_acc, pt = fused_group_update(vec_raw_g, vec_fit_g, w_g, q_rot_t, acc, want_pt)
        acc.update(new_acc)
        if pt is not None and is_writer(mesh):
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
    copy = h2d.copier(dev, mesh)  # the group's copy to the device (pinned on a card)
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

        for raw_diff, S in profiling.spanned("stage_ct.decode", obs_chunks()):
            # Only the (F, nBonds, 3) bond differences and the (F, 3, 3)
            # Horn correlations cross host -> device, not the (F, nAtoms, 3)
            # coordinate block the decoder produced.  On a card the copy
            # runs while the card still computes the previous group (the
            # loop's only waits on the card: the copy's slot, and the Horn
            # fit in bond_vectors_from_obs, before kernel A is queued).
            n_full = (raw_diff.shape[0] // fpc) * fpc
            if n_full == 0:
                continue  # tail shorter than one Palmer chunk: dropped
            f = dtype or torch.from_numpy(raw_diff).dtype
            with profiling.span("stage_ct.h2d"):
                raw_dev, S_dev = copy([raw_diff, S], f)
            profiling.count("stage_ct.h2d_bytes", raw_diff.nbytes + S.nbytes)
            bv = orient.bond_vectors_from_obs(raw_dev, S_dev)
            if q_rot is not None and q_rot_t is None:
                q_rot_t = torch.as_tensor(np.asarray(q_rot), dtype=f, device=dev)
            g = n_full // fpc
            with profiling.span("stage_ct.accumulate"):
                accumulate(bv.raw[:n_full].reshape(g, fpc, -1, 3),
                           bv.fitted[:n_full].reshape(g, fpc, -1, 3))

    if n_chunks_total == 0:
        raise ValueError("no complete Palmer chunks found in the input")

    out = {"res_ids": res_ids, "delta_t": delta_t, "n_chunks": n_chunks_total}
    dt_lags = autocorr.lag_times(delta_t, tau_memory).numpy()
    R = float(n_chunks_total)

    # each artefact in its own span: the D2H read of its statistics, the
    # formatting and the write
    if do_ct:
        for key, suffix in (("ext", "_Ctext.dat"), ("int", "_Ctint.dat")):
            with profiling.span("stage_ct.write"):
                if mesh is not None:
                    mean, dct = ct_streams[key].finalize()
                else:
                    mean, dct = autocorr.palmer_pooled_stats(acc[f"ct_{key}_s"],
                                                             acc[f"ct_{key}_s2"], R)
                mean, dct = mean.cpu().numpy(), dct.cpu().numpy()  # (nDeltas, nBonds)
                _artefact(mesh, lambda: xvg.print_sxylist(
                    out_prefix + suffix, res_ids, dt_lags, np.stack([mean.T, dct.T], axis=-1)),
                    out_prefix + suffix)
            if key == "int":
                out["Ct"], out["dCt"] = mean, dct

    if do_vec_avg:
        with profiling.span("stage_ct.write"):
            avg = qt.vecnorm(acc["vec_sum"] / (R * fpc)).cpu().numpy()
            _artefact(mesh, lambda: xvg.print_xylist(out_prefix + "_avgvec.dat", res_ids, avg.T,
                                                     cols=True), out_prefix + "_avgvec.dat")
        out["avgvec"] = avg

    if do_vec_dist:
        with profiling.span("stage_ct.write"):
            if do_hist:
                spill_hist()  # fold the device int32 into the int64 total
                ep, ec = geometry.lambert_edges(*hist_nb, dtype=vec_dtype)
                out["vec_file"] = out_prefix + "_vecHistogram.npz"
                _artefact(mesh, lambda: vecio.save_histogram(
                    out["vec_file"], res_ids, hist_host, ep.numpy(), ec.numpy()), out["vec_file"])
            else:
                out["vec_file"] = out_prefix + ("_vecPhiTheta.dat"
                                                if vec_storage == "TextPhiTheta"
                                                else "_vecPhiTheta.npz")
                _artefact(mesh, lambda: pt_writer is not None and pt_writer.close(),
                          out["vec_file"])

    if do_s2:
        with profiling.span("stage_ct.write"):
            if do_s2_outer:
                s2, ds2 = autocorr.palmer_pooled_stats(acc["s2_s"], acc["s2_s2"], R)
                arr = np.stack([s2.cpu().numpy(), ds2.cpu().numpy()], axis=-1)
                spectrum = ()
            else:
                arr = _ired_spectrum_artefact(out_prefix, ired_stream.result(), mesh)
                spectrum = (out_prefix + "_iREDspectrum.dat",)
            _artefact(mesh, lambda: xvg.print_xylist(out_prefix + "_S2.dat", res_ids,
                                                     (arr.T) * zeta, cols=True),
                      out_prefix + "_S2.dat", *spectrum)
        out["S2"] = arr
    out["acc"] = acc
    if mesh is not None:
        out["streams"] = ct_streams
    return out
