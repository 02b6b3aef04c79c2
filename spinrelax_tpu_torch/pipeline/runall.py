"""End-to-end workflow orchestrator (run-all.bash equivalent; port of
``spinrelax_tpu/pipeline/runall.py``).

Drives: orientation quaternions -> global rotational diffusion (+ PAF)
-> local C(t)/S2/vector distributions -> multi-exponential fits ->
relaxation predictions per field.  Every step runs on one torch device,
the card unless the caller asks for the CPU.

Stage resume follows the reference's output-file-existence convention
through the content-hash manifest of ``pipeline.manifest`` -- the JAX
package's file format at the same path, so either package resumes over
the other's artefacts; ``--force`` reruns everything.  The temperature /
viscosity / D2O correction of D_iso reproduces run-all.bash:15-28.

With ``-fit`` / ``-expfiles`` the multi-field global fit
(``stages.stage_multifield``) runs once per mode after the relaxations.
The fitted C(t) is plotted to ``{pref}_fittedCt.pdf`` (cosmetic: without
matplotlib a note is printed and the run goes on).

``-devices N`` runs on a ("rep", "res") mesh of N processes, one per
device (``torchrun --nproc-per-node N``; one process needs no launcher):
the streamed C(t) stage (with ``-stream``), the C(t) fits and the
multi-field fits shard over it, every rank taking the same decisions.
Rank 0 alone runs the other steps and writes every artefact and manifest
entry, and the ranks wait for each other after each write; a stage that
every rank runs is checked against the manifest by every rank, after a
barrier.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import time

import numpy as np

from .. import checked_device
from ..io import fittedct as fctio
from ..models.diffusion import Diffusion
from ..parallel.mesh import barrier, device_of, is_writer
from . import stages
from .cli import _parse_csa
from .config import WorkflowConfig, add_workflow_args, config_from_namespace
from .corrections import convert_diso
from .manifest import record_stage, stage_is_current


def _resolve_ref(path: str, refpdb: str) -> str:
    """Per-folder reference PDB resolution: absolute paths win, then the
    folder-local copy, then a top-level fallback (run-all.bash keeps one
    refpdb per replica folder)."""
    rl = refpdb if os.path.isabs(refpdb) else os.path.join(path, refpdb)
    if not os.path.exists(rl) and os.path.exists(refpdb):
        rl = refpdb
    return rl


def main(argv=None, device="cuda"):
    """The run-all command line: parse ``argv`` into a WorkflowConfig and
    run it on ``device``.  Returns run_workflow's summary."""
    p = argparse.ArgumentParser(
        prog="spinrelax run-all",
        description="Full MD-to-spin-relaxation workflow.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    add_workflow_args(p)
    ns = p.parse_args(argv)
    try:
        cfg = config_from_namespace(ns)
    except ValueError as exc:
        sys.exit(f"= = ERROR: {exc}!")
    return run_workflow(cfg, device=device)


def run_workflow(cfg: WorkflowConfig, device="cuda") -> dict:
    """Run the full workflow from a typed config on ``device`` (the card
    unless ``device="cpu"``; raises without one).

    Returns a summary: ``outpref``, the D_iso [ps^-1] and Daniso used,
    the PAF quaternion, and ``walls``, the host-clock seconds of each step
    (orient, dq, ct, fit-ct, relax, and fit with ``-fit``)."""
    cfg.validate()
    io, tum, phy, exp = cfg.io, cfg.tumbling, cfg.physics, cfg.experiments
    dev = checked_device(device)
    mesh = None
    if io.devices > 0:
        from ..parallel.mesh import make_mesh

        mesh = make_mesh(io.devices, device=dev)
        dev = device_of(mesh)
    lead = is_writer(mesh)

    tau_ns = tum.tau_mem / 1000.0
    outpref = f"{io.outpref}-{tau_ns:g}ns"
    t100 = tum.tau_mem / 100.0
    walls = {}
    clock = [time.perf_counter()]

    def lap(step):
        now = time.perf_counter()
        walls[step] = now - clock[0]
        clock[0] = now

    folders = ["."]
    if io.folders_file:
        with open(io.folders_file) as fp:
            folders = [line.strip() for line in fp if line.strip()]
    multi = len(folders) > 1

    d_fact = convert_diso(1.0, phy.temp_md, phy.temp_exp, phy.d2o_exp)
    print("= = Diso conversion factor (T/viscosity/D2O): %g" % d_fact)

    # ------------------------------------------------------------------
    print("= Step 1: Orientation quaternions (colvar-qorient)...")
    qfiles = []
    for path in folders:
        qfile_loc = os.path.join(path, io.qfile)
        sxtc_loc = os.path.join(path, io.traj)
        ref_loc = _resolve_ref(path, io.refpdb)
        qfiles.append(qfile_loc)
        if not lead:
            continue
        if cfg.force or not stage_is_current(
            outpref, f"orient:{path}", [sxtc_loc, ref_loc], [qfile_loc],
            params=dict(fitsel=phy.fit_atoms),
        ):
            stages.stage_orientation(
                [sxtc_loc], ref_loc, qfile_loc, fit_sel=phy.fit_atoms, force=True,
                device=dev,
            )
            record_stage(outpref, f"orient:{path}", [sxtc_loc, ref_loc],
                         params=dict(fitsel=phy.fit_atoms))
        else:
            print(" = = = Note: Pre-existing quaternion file found, skipping.")
    if multi:
        qfile_agg = io.qfile + "-aggregate"
        if lead:
            with open(qfile_agg, "w") as out:
                for qf in qfiles:
                    with open(qf) as src:
                        shutil.copyfileobj(src, out)  # constant memory
    else:
        qfile_agg = qfiles[0]
    barrier(mesh)
    lap("orient")

    # ------------------------------------------------------------------
    print("= Step 2: Global rotational diffusion...")
    use_ext = (
        tum.q_ext is not None and tum.d_ext is not None and len(tum.d_ext) >= 2
    )
    if use_ext:
        quat = np.array(tum.q_ext)
        # an explicit -tau_ext wins over D_ext[0] (run-all.bash:206-216)
        diso = (
            1.0 / (6.0 * tum.tau_ext) if tum.tau_ext is not None
            else tum.d_ext[0]
        )
        dani = tum.d_ext[1]
    else:
        dq_params = dict(t100=t100, tau=tum.tau_mem, chunks=tum.num_chunks, multi=multi)
        if lead:
            if cfg.force or not stage_is_current(
                outpref, "dq", [qfile_agg],
                [outpref + "-aniso_q.dat", outpref + "-aniso2.dat"], params=dq_params,
            ):
                stages.stage_dq(
                    qfile_agg, outpref, min_dt=t100, max_dt=tum.tau_mem, skip_dt=t100,
                    n_chunks=tum.num_chunks, multi=multi, force=cfg.force, device=dev,
                )
                record_stage(outpref, "dq", [qfile_agg], params=dq_params)
            else:
                print(" = = = Note: Pre-existing rotdif data found, skipping.")
        barrier(mesh)
        # Extract from artefacts (so resume works identically).
        with open(outpref + "-aniso_q.dat") as fp:
            quat = np.array([float(x) for x in fp.readline().split()[1:5]])
        hdr = {}
        with open(outpref + "-aniso2.dat") as fp:
            for line in fp:
                if not line.startswith("#"):
                    break
                parts = line.split()
                if "Diso" in line:
                    hdr["Diso"] = float(parts[4]) * 1e-12 * d_fact
                for key in ("Dani_L", "Drho_L", "Dani_S", "Drho_S"):
                    if key in line:
                        hdr[key] = float(parts[4])
        if tum.tau_ext is not None:
            diso = 1.0 / (6.0 * tum.tau_ext)
        elif tum.d_ext:
            diso = tum.d_ext[0]
        else:
            diso = hdr["Diso"]
        # Prolate/oblate unique-axis rule (run-all.bash:404-435), skipped
        # when both external D values are given (run-all.bash:409).
        if tum.d_ext and len(tum.d_ext) >= 2:
            dani = tum.d_ext[1]
        elif hdr["Drho_L"] < 1.0:
            print("= = = Long axis ellipsoid detected, pointing along Dz.")
            dani = hdr["Dani_L"]
        elif hdr["Drho_S"] < 1.0:
            print("= = = Short axis ellipsoid detected, pointing along Dx.")
            dani = hdr["Dani_S"]
        else:
            sys.exit("= = = ERROR: neither Drho value is below one.")
        if tum.q_ext is not None:
            quat = np.array(tum.q_ext)
    print(f"= = Global Diffusion used: Diso={diso:g} ps^-1, Daniso={dani:g}")
    print(f"= = PAF quaternion used: {quat}")
    lap("dq")

    # ------------------------------------------------------------------
    print("= Step 3: Local motion (C(t), S2, vector distributions)...")
    vec_files = {
        "Histogram": outpref + "_vecHistogram.npz",
        "PhiTheta": outpref + "_vecPhiTheta.npz",
        "TextPhiTheta": outpref + "_vecPhiTheta.dat",
    }
    vec_file = vec_files[io.vec_storage]
    trajs = [os.path.join(path, io.traj) for path in folders]
    refs = [_resolve_ref(path, io.refpdb) for path in folders]
    ct_params = dict(tau=tum.tau_mem, quat=[float(x) for x in quat],
                     storage=io.vec_storage, zeta=phy.zeta,
                     fit_atoms=phy.fit_atoms)
    # every rank runs the streamed C(t) stage on a mesh; rank 0 the in-memory one
    if lead or (mesh is not None and io.stream_groups > 0):
        if cfg.force or not stage_is_current(
            outpref, "ct", trajs + refs, [vec_file, outpref + "_Ctint.dat"],
            params=ct_params,
        ):
            if io.stream_groups > 0:
                stages.stage_ct_streamed(
                    trajs, refs, outpref, tum.tau_mem,
                    chunk_groups=io.stream_groups, q_rot=quat, fit_sel=phy.fit_atoms,
                    zeta=phy.zeta, vec_storage=io.vec_storage, mesh=mesh, device=dev,
                )
            else:
                stages.stage_ct(
                    trajs, refs, outpref, tum.tau_mem,
                    q_rot=quat, fit_sel=phy.fit_atoms, zeta=phy.zeta,
                    vec_storage=io.vec_storage, force=cfg.force, device=dev,
                )
            if lead:
                record_stage(outpref, "ct", trajs + refs, params=ct_params)
        else:
            print(" = = = Note: Pre-existing C(t)/vector files found, skipping.")
    barrier(mesh)
    lap("ct")

    if cfg.force or not stage_is_current(
        outpref, "fit-ct", [outpref + "_Ctint.dat"], [outpref + "_fittedCt.dat"]
    ):
        stages.stage_fit_ct([outpref + "_Ctint.dat"], outpref, mesh=mesh, device=dev)
        if lead:
            record_stage(outpref, "fit-ct", [outpref + "_Ctint.dat"])
    else:
        print(" = = = Note: Pre-existing fitted-Ct file found, skipping.")
    barrier(mesh)
    if lead and (not os.path.exists(outpref + "_fittedCt.pdf") or cfg.force):
        try:
            from .plotting import main as plot_main

            plot_main(["-f", outpref + "_fittedCt.dat", "-o", outpref + "_fittedCt.pdf"])
        except Exception as exc:  # plotting is cosmetic; never fatal
            print(f"= = = NOTE: plotting skipped ({exc})")
    lap("fit-ct")

    # ------------------------------------------------------------------
    print(f"= Step 4: Relaxations for B fields {list(exp.bfields_mhz)} ...")
    diffusion = Diffusion.axisymmetric(diso=diso, aniso=dani)
    names = fctio.read_fittedct(outpref + "_fittedCt.dat", device="cpu").names
    csa = _parse_csa(phy.csa_file, names)
    for bf in exp.bfields_mhz if lead else ():
        of = f"{outpref}-{int(bf)}"
        # csa_file is an INPUT so edited CSA contents invalidate the stage
        # through the content-hash manifest (its path also sits in params).
        relax_params = dict(bf=bf, diso=float(diso), dani=float(dani),
                            zeta=phy.zeta, csa_file=phy.csa_file)
        relax_inputs = [outpref + "_fittedCt.dat", vec_file]
        if phy.csa_file:
            relax_inputs.append(phy.csa_file)
        if cfg.force or not stage_is_current(
            outpref, f"relax:{bf}", relax_inputs,
            # ALL four artefacts: a run interrupted between two writes
            # must not be skipped.
            [of + "_R1.dat", of + "_R2.dat", of + "_NOE.dat", of + "_rho.dat"],
            params=relax_params,
        ):
            stages.stage_relax(
                outpref + "_fittedCt.dat", of, diffusion,
                vec_file=vec_file, freq_mhz=bf, zeta=phy.zeta, csa=csa, device=dev,
            )
            record_stage(outpref, f"relax:{bf}", relax_inputs, params=relax_params)
        else:
            print(f" = = = Note: relaxations at {bf} already done. Skipping.")
        if exp.do_jomega and (not os.path.exists(of + "_Jw.dat") or cfg.force):
            stages.stage_relax(
                outpref + "_fittedCt.dat", of, diffusion,
                vec_file=vec_file, freq_mhz=bf, zeta=phy.zeta, jomega=True, device=dev,
            )
    barrier(mesh)
    lap("relax")

    if exp.fit_modes:
        for mode in exp.fit_modes:
            stages.stage_multifield(
                outpref + "_fittedCt.dat", list(exp.exp_files),
                f"{outpref}-opt{mode.replace(',', '_')}",
                diffusion, vec_file=vec_file, zeta=phy.zeta, csa=csa,
                opt_params=mode.split(","), include_expt=True, devices=io.devices,
                device=dev,
            )
        lap("fit")
    print("= = run-all complete.")
    return dict(outpref=outpref, diso=float(diso), dani=float(dani),
                quat=np.asarray(quat, dtype=float), walls=walls)
