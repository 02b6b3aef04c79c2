"""Command-line entry points of the port (``spinrelax_tpu/pipeline/cli.py``):
the reference's stage scripts plus the run-all orchestrator.

    python -m spinrelax_tpu_torch <command> [arguments]

runs every command's compute on the card; ``main(argv, device="cpu")``
runs it on the CPU instead.  ``ct --split G --devices N``, ``fit-ct
--devices N`` and ``multifield --devices N`` shard their compute over a
("rep", "res") mesh of N processes, one per device:

    torchrun --nproc-per-node N -m spinrelax_tpu_torch ct ... --split G --devices N

(``--devices 1`` needs no launcher: the process starts its own one-rank
group); rank 0 writes the artefacts.

    spinrelax center      <- center-solute-gromacs.bash (native trjconv)
    spinrelax orient      <- PLUMED QUATERNION + gmx steps (now native)
    spinrelax dq          <- calculate-dq-distribution[-multi].py
    spinrelax ct          <- calculate-Ct-from-traj.py / calculate-S2.py
    spinrelax fit-ct      <- calculate-fitted-Ct.py
    spinrelax relax       <- calculate-relaxations-from-Ct.py
    spinrelax multifield  <- calculate-relaxations-multi-field.py
    spinrelax rho         <- calculate-rho-from-expt.py
    spinrelax hydronmr    <- parse-hydroNMR-results.py
    spinrelax bmrb        <- parse-relaxations-from-BMRB-entry.py
    spinrelax plot-ct     <- plot-fittedCt-values.py
    spinrelax rotate      <- rotate-coordinate-file.py
    spinrelax run-all     <- run-all.bash
    spinrelax center      <- center-solute-gromacs.bash
    spinrelax convert / info / make-ref / check: trjconv / gmx check /
                             create-reference-pdb.bash / check-installation
"""

from __future__ import annotations

import argparse
import os
import re
import sys
import time

import numpy as np
import torch

from .. import checked_device


def _split_floats(s: str):
    return [float(x) for x in re.split(r"[,\s]+", s.strip()) if x]


def _dxyz_from_iso_aniso_rhomb(diso, aniso, rhomb):
    """(Diso, Daniso, Drhomb) -> (Dx, Dy, Dz), the exact inverse of the
    reference's translate_D (parse-hydroNMR-results.py:90-98):
    Diso = mean(D), aniso = 2Dz/(Dx+Dy), rhomb = 3(Dy-Dx)/(2Dz-Dx-Dy)."""
    s = 6.0 * diso / (2.0 + aniso)  # Dx + Dy
    dz = 3.0 * diso * aniso / (2.0 + aniso)
    half_diff = rhomb * s * (aniso - 1.0) / 6.0
    return [s / 2.0 - half_diff, s / 2.0 + half_diff, dz]


_D_HELP = {
    "relax": "diffusion tensor: Diso | 'Diso,Daniso' | 'Diso,Daniso,Drhomb' "
             "[1/time_unit] (reference -D convention, "
             "calculate-relaxations-from-Ct.py:600-611)",
    "multifield": "diffusion tensor: Diso | 'Dpar,Dperp' (converted to "
                  "Diso/Daniso like the reference's bConvert, "
                  "calculate-relaxations-multi-field.py:34) | "
                  "'Diso,Daniso,Drhomb' [1/ps]",
}


def _parse_diffusion(args, flavor: str = "relax"):
    """Shared -D/--tau/--aniso parsing.  The two reference front-ends
    disagree on what TWO -D values mean, and both meanings are kept:

    - flavor="relax": (Diso, Daniso) — calculate-relaxations-from-Ct.py
      :600-611; three values are the documented (Diso, Daniso, Drhomb)
      (:506 — the reference documents but never wires the 3-value case;
      we implement the documented interface).
    - flavor="multifield": (Dpar, Dperp), converted like bConvert=True
      (calculate-relaxations-multi-field.py:34,
      spectral_densities.py:477).
    """
    from ..models.diffusion import Diffusion

    D = getattr(args, "D", None)
    tau = getattr(args, "tau", None)
    aniso = getattr(args, "aniso", None)
    if D is None:
        if tau is None:
            return Diffusion.direct()
        diso = 1.0 / (6.0 * tau)
        if aniso is None or aniso == 1.0:
            return Diffusion.isotropic(diso=diso)
        return Diffusion.axisymmetric(diso=diso, aniso=aniso)
    vals = _split_floats(D)
    if len(vals) == 1:
        if aniso is None or aniso == 1.0:
            return Diffusion.isotropic(diso=vals[0])
        return Diffusion.axisymmetric(diso=vals[0], aniso=aniso)
    if len(vals) == 2:
        if flavor == "multifield":
            return Diffusion.axisymmetric(dpar=vals[0], dperp=vals[1])
        return Diffusion.axisymmetric(diso=vals[0], aniso=vals[1])
    if len(vals) == 3:
        return Diffusion.ellipsoid(_dxyz_from_iso_aniso_rhomb(*vals))
    sys.exit(f"= = = ERROR: -D takes 1-3 values, got {len(vals)}")


def _parse_csa(csa_arg, names):
    """--csa argument: numeric value or file; autoscale from ppm
    (calculate-relaxations-from-Ct.py:701-743)."""
    if csa_arg is None:
        return None
    if os.path.exists(csa_arg):
        from ..io import xvg

        resid, vals = xvg.load_xy(csa_arg)
        if abs(vals[0]) > 1.0:
            vals = vals * 1e-6
        order = {str(int(r)): v for r, v in zip(resid, vals)}
        missing = [str(n) for n in names if str(n) not in order]
        if missing:
            # The reference exits with a resid-mismatch message here
            # (sanity_check_two_list, calculate-relaxations-from-Ct.py:730).
            sys.exit(
                "= = = ERROR: CSA file %r lacks residues present in the "
                "fitted-Ct data: %s" % (csa_arg, ", ".join(missing[:8]))
            )
        return np.array([order[str(n)] for n in names])
    val = float(csa_arg)
    if abs(val) > 1.0:
        val *= 1e-6
    return np.full(len(names), val)


# ---------------------------------------------------------------------------
# Subcommands
# ---------------------------------------------------------------------------


def cmd_orient(argv, device="cuda"):
    p = argparse.ArgumentParser(
        prog="spinrelax orient",
        description="Compute per-frame orientation quaternions vs a reference "
        "structure (replaces the GROMACS+PLUMED toolchain).",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("-f", "--infn", nargs="+", required=True, help="trajectories (npz/pdb/xtc)")
    p.add_argument("-s", "--refpdb", required=True, help="reference PDB (occupancy marks fit atoms)")
    p.add_argument("-o", "--outfn", default="colvar-qorient", help="output colvar file")
    p.add_argument("--fitsel", default="occupancy > 0", help="fit atom selection")
    p.add_argument("--timestep", type=float, default=None,
                   help="frame spacing [ps]: required for formats with no "
                        "time axis (the colvar's time column defines the "
                        "dq stage's delta_t)")
    p.add_argument("--force", action="store_true")
    a = p.parse_args(argv)
    from .stages import stage_orientation

    out = stage_orientation(a.infn, a.refpdb, a.outfn, fit_sel=a.fitsel,
                            force=a.force, timestep=a.timestep, device=device)
    print(f"= = Wrote {out}")


def cmd_dq(argv, device="cuda"):
    p = argparse.ArgumentParser(
        prog="spinrelax dq",
        description="Global rotational diffusion from quaternion trajectories.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("-f", "--infn", default="colvar-qorient")
    p.add_argument("-o", "--outpref", default="out")
    p.add_argument("--mindt", type=float, default=0.0)
    p.add_argument("--maxdt", type=float, default=1000.0)
    p.add_argument("--skip", type=float, default=0.0)
    p.add_argument("--num_chunk", type=int, default=0)
    p.add_argument("--multi", action="store_true", help="aggregate colvar with repeated FIELDS headers")
    p.add_argument("--iso", action="store_true",
                   help="write the isotropic decay analysis (-iso.dat)")
    p.add_argument("--aniso", action="store_true",
                   help="write the anisotropic analysis (-aniso2.dat, -aniso_q.dat, -moi.xyz)")
    p.add_argument("--hist", dest="do_hist", action="store_true",
                   help="write per-lag 3D delta-q histograms")
    p.add_argument("-n", "--num_bins", type=int, default=101)
    p.add_argument("-o2", "--outtype", dest="out_suff", default="dat",
                   choices=("dx", "dat", "none"))
    p.add_argument("--fulltensor", action="store_true",
                   help="write all nine <q_i q_j> components per lag in the PAF")
    p.add_argument("--stream", type=int, default=0, metavar="FRAMES",
                   help="constant-memory streaming mode: analyse the colvar "
                        "in blocks of FRAMES frames (chunked errors, "
                        "histograms, the full tensor and --multi "
                        "aggregates all supported)")
    a = p.parse_args(argv)
    from .stages import stage_dq

    # Reference semantics (calculate-dq-distribution.py:435-439,658-679):
    # each analysis is opt-in; for convenience, giving NEITHER flag writes
    # both (the common run-all invocation passes --iso --aniso anyway).
    do_iso, do_aniso = a.iso, a.aniso
    if not (a.iso or a.aniso):
        do_iso = do_aniso = True
    res = stage_dq(
        a.infn, a.outpref, a.mindt, a.maxdt, a.skip, n_chunks=a.num_chunk,
        multi=a.multi, do_hist=a.do_hist, hist_bins=a.num_bins,
        hist_format=a.out_suff, do_full_tensor=a.fulltensor,
        stream_chunk=a.stream, do_iso=do_iso, do_aniso=do_aniso, device=device,
    )
    print(f"= = D_iso = {res.D_iso:.6g} s^-1 ; PAF quaternion {res.q_frame}")


def cmd_ct(argv, device="cuda"):
    p = argparse.ArgumentParser(
        prog="spinrelax ct",
        description="Bond-vector autocorrelation C(t), S2, and vector "
        "distributions from solute trajectories.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("-s", "--topfn", nargs="+", required=True)
    p.add_argument("-f", "--infn", nargs="+", required=True)
    p.add_argument("-o", "--outpref", default="out")
    p.add_argument("-t", "--tau", type=float, default=None,
                   help="memory time [ps]; optional like the reference "
                        "(calculate-Ct-from-traj.py:313-316) — without it "
                        "S2/vector statistics run unblocked over all "
                        "frames and C(t) analysis is refused")
    p.add_argument("--prefact", type=float, default=(1.02 / 1.04) ** 6, dest="zeta")
    p.add_argument("--S2", dest="do_s2", action="store_true")
    p.add_argument("--S2mode", default="outer", choices=("outer", "ired", "wired"),
                   help="outer-product S2 or (w)iRED eigenmode S2 "
                        "(Gu/Li/Brueschweiler 2014)")
    p.add_argument("--Ct", dest="do_ct", action="store_true")
    p.add_argument("--vecDist", dest="do_vec", action="store_true")
    p.add_argument("--vecHist", dest="do_hist", action="store_true")
    p.add_argument("--vecAvg", dest="do_avg", action="store_true")
    p.add_argument("--binary", action="store_true")
    p.add_argument("--histBin", type=int, default=72)
    p.add_argument("--vecRot", default="", help='PAF rotation quaternion "w x y z"')
    p.add_argument("--Hsel", default="name H")
    p.add_argument("--Xsel", default="name N and not resname PRO")
    p.add_argument("--fitsel", default="occupancy > 0")
    p.add_argument("--split", type=int, dest="split_groups", default=-1,
                   help="stream the trajectory N Palmer chunks at a time "
                        "(true streaming, replaces the reference's memory "
                        "workaround; all vector-storage modes supported)")
    p.add_argument("--timestep", type=float, default=None,
                   help="frame spacing [ps]: required for bare .npy "
                        "trajectories, overrides the file value otherwise "
                        "(e.g. a DCD's float32-quantised DELTA)")
    p.add_argument("--devices", type=int, default=0, metavar="N",
                   help="with --split: shard the streamed C(t) "
                        "accumulation over an N-device ('rep','res') mesh "
                        "(one process per device, started by torchrun)")
    p.add_argument("--help_sel", action="store_true",
                   help="display help for selection texts and exit")
    if "--help_sel" in argv:
        print(
            "Selection syntax (io/pdb.Topology.select):\n"
            "  name H | name N CA       atom-name match (multiple allowed)\n"
            "  resname PRO              residue-name match\n"
            "  occupancy > 0            occupancy threshold\n"
            "  not <clause>             negation\n"
            "  <clause> and <clause>    conjunction\n"
            "Examples: 'name N and not resname PRO', 'name CA and occupancy > 0'"
        )
        return
    a = p.parse_args(argv)
    from .stages import stage_ct, stage_ct_streamed

    q_rot = None
    if a.vecRot:
        q_rot = np.array(_split_floats(a.vecRot))
        if len(q_rot) != 4 or not np.allclose(np.dot(q_rot, q_rot), 1, atol=1e-5):
            sys.exit(f"= = = ERROR: input rotation quaternion is malformed! {q_rot}")
    storage = "Histogram" if a.do_hist else ("PhiTheta" if a.binary else "TextPhiTheta")
    if a.devices > 0 and a.split_groups <= 0:
        sys.exit("= = = ERROR: --devices requires the streaming path (--split N).")
    if a.tau is None:
        # Reference semantics (calculate-Ct-from-traj.py:358-360): S2 and
        # vector statistics are legal without a memory time (unblocked, no
        # error bars); C(t) is not.
        if a.do_ct:
            sys.exit(
                "= = = Refusing to do C(t)-analysis without using a block "
                "averaging over memory_time tau!"
            )
        if a.split_groups > 0:
            sys.exit("= = = ERROR: --split streams in memory-time chunks; "
                     "it requires -t/--tau.")
        if a.S2mode != "outer":
            sys.exit("= = = ERROR: --S2mode ired/wired needs a tumbling "
                     "estimate; pass -t/--tau.")
    if a.split_groups > 0:
        mesh = None
        if a.devices > 0:
            from ..parallel.mesh import make_mesh

            mesh = make_mesh(a.devices, device=device)
        stage_ct_streamed(
            a.infn, a.topfn, a.outpref, a.tau,
            chunk_groups=a.split_groups, timestep=a.timestep,
            q_rot=q_rot, h_sel=a.Hsel, x_sel=a.Xsel, fit_sel=a.fitsel,
            zeta=a.zeta, do_ct=a.do_ct, do_s2=a.do_s2, s2_mode=a.S2mode,
            do_vec_dist=(a.do_vec or a.do_hist), do_vec_avg=a.do_avg,
            vec_storage=storage, hist_bins=a.histBin, mesh=mesh, device=device,
        )
    else:
        stage_ct(
            a.infn, a.topfn, a.outpref, a.tau, timestep=a.timestep,
            q_rot=q_rot, h_sel=a.Hsel, x_sel=a.Xsel, fit_sel=a.fitsel, zeta=a.zeta,
            do_ct=a.do_ct, do_s2=a.do_s2, s2_mode=a.S2mode,
            do_vec_dist=(a.do_vec or a.do_hist),
            do_vec_avg=a.do_avg, vec_storage=storage, hist_bins=a.histBin,
            device=device,
        )
    print("= = C(t)/S2 stage complete.")


def cmd_s2(argv, device="cuda"):
    """Standalone S2 computation (calculate-S2.py equivalent): the ct
    stage restricted to order parameters.

    Unlike the ct stage (whose --prefact DEFAULTS to the libration
    factor, calculate-Ct-from-traj.py:317), calculate-S2.py applies
    zeta=1 unless its boolean --zeta switch is given
    (calculate-S2.py:265,288-292); replicate that here while still
    honouring an explicit --prefact passthrough."""
    argv = list(argv)
    zeta = 1.0
    while "--zeta" in argv:
        argv.remove("--zeta")
        zeta = (1.02 / 1.04) ** 6
    if not any(s == "--prefact" or s.startswith("--prefact=") for s in argv):
        argv += ["--prefact", repr(zeta)]
    cmd_ct(argv + ["--S2"], device)


def cmd_fit_ct(argv, device="cuda"):
    p = argparse.ArgumentParser(
        prog="spinrelax fit-ct",
        description="Fit multi-exponential models to C(t) curves with "
        "automatic model selection.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("-f", "--infn", nargs="+", required=True)
    p.add_argument("-o", "--outpref", default="out")
    p.add_argument("--nc", type=int, default=-1)
    p.add_argument("--nofast", action="store_true")
    p.add_argument("--optimiser", choices=("lm", "varpro"), default="lm",
                   help="lm = curve_fit-parity joint solve; varpro = "
                        "variable projection (closed-form amplitudes per "
                        "tau step)")
    p.add_argument("--nstarts", type=int, default=1,
                   help="batched multi-start: extra deterministic tau "
                        "starts per residue per ladder rung, best fit "
                        "wins (1 = the reference's single cold start; "
                        "8 beats scipy TRF robustness on hard "
                        "adjacent-timescale mixes at ~8x rung compute)")
    p.add_argument("--retry-starts", type=int, default=8,
                   dest="retry_starts", metavar="N",
                   help="multi-start escalation for quality-failed and "
                        "chisq-outlier rows ONLY (default-on TRF-grade "
                        "robustness at ~zero clean-workload cost; 1 "
                        "disables)")
    p.add_argument("--devices", type=int, default=0, metavar="N",
                   help="shard the batched ladder fits over an N-device mesh "
                        "(0 = single-device; one process per device)")
    a = p.parse_args(argv)
    from .stages import stage_fit_ct

    mesh = None
    if a.devices > 0:
        from ..parallel.mesh import make_mesh

        mesh = make_mesh(a.devices, device=device)
    stage_fit_ct(
        a.infn, a.outpref,
        n_components=None if a.nc < 0 else a.nc,
        use_s2fast=not a.nofast,
        optimiser=a.optimiser,
        n_starts=a.nstarts,
        retry_starts=a.retry_starts,
        mesh=mesh,
        device=device,
    )
    print(" = = Completed C(t)-fits.")


def cmd_relax(argv, device="cuda"):
    p = argparse.ArgumentParser(
        prog="spinrelax relax",
        description="R1/R2/NOE/rho (or J(w)) from fitted C(t) + global tumbling.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("-f", "--infn", dest="in_ct", required=True)
    p.add_argument("-o", "--outpref", default="out")
    p.add_argument("--distfn", default=None)
    p.add_argument("-v", "--vecfn", default=None,
                   help="average X-H vectors as an xvg table (takes "
                        "precedence over --distfn)")
    p.add_argument("--ref", dest="reffn", default=None,
                   help="reference PDB to take vectors from directly "
                        "(no fitting); combine with --traj for an ensemble")
    p.add_argument("--refHsel", default="name H")
    p.add_argument("--refXsel", default="name N and not resname PRO")
    p.add_argument("--traj", dest="trjfn", default=None)
    p.add_argument("--rXH", type=float, default=None,
                   help="effective X-H bond length [Angs]; alternative to "
                        "--zeta via zeta=(1.02/rXH)^6 (the reference parses "
                        "but never applies this flag; implemented as "
                        "documented)")
    p.add_argument("-q", "--q_rot", default="")
    p.add_argument("-n", "--nuclei", default="NH", choices=("NH", "CH"))
    p.add_argument("-B", "--B0", type=float, default=None)
    p.add_argument("-F", "--freq", type=float, default=None, help="1H frequency [Hz]")
    p.add_argument("--Jomega", action="store_true")
    p.add_argument("--tu", "--time_units", dest="time_unit", default="ps",
                   help="time units of the autocorrelation file")
    p.add_argument("--tau", type=float, default=None)
    p.add_argument("--aniso", type=float, default=1.0)
    p.add_argument("-D", "--DTensor", dest="D", default=None,
                   help=_D_HELP["relax"])
    p.add_argument("--zeta", type=float, default=0.890023)
    p.add_argument("--csa", default=None)
    p.add_argument("--shiftres", type=int, default=0)
    p.add_argument("-e", "--expfn", default=None,
                   help="experimental ResID/R1/R2/NOE table (3 or 6 data columns)")
    p.add_argument("--opt", "--fit", dest="opt", default=None,
                   choices=("Diso", "DisoS2", "DisoCSA", "DisoS2CSA", "new"))
    p.add_argument("--cycles", type=int, default=100)
    p.add_argument("--tol", type=float, default=1e-6)
    p.add_argument("--method", choices=("powell", "gradient", "device"),
                   default="powell",
                   help="optimiser: reference-parity Powell, exact-gradient "
                   "L-BFGS, or (--opt new only) the whole alternating fit "
                   "as ONE device dispatch")
    p.add_argument("--theoretical", action="store_true",
                   help="rigid-body baseline rates; exits after reporting")
    a = p.parse_args(argv)
    from ..constants import field_to_mhz
    from ..io import fittedct as fctio
    from .stages import stage_relax, stage_relax_theoretical

    if a.freq is not None:
        freq_mhz = a.freq / 1e6
    elif a.B0 is not None:
        freq_mhz = field_to_mhz(a.B0)
    else:
        sys.exit("= = = ERROR: give either --B0 [T] or --freq [Hz]")
    diffusion = _parse_diffusion(a)
    # --rXH applies to EVERY prediction path, including --theoretical
    # (calculate-relaxations-from-Ct.py:747-750 scales zeta before any
    # branch).
    zeta = a.zeta if a.rXH is None else (1.02 / a.rXH) ** 6
    if a.theoretical:
        if diffusion.kind == "direct":
            # Reference errors here too (calculate-relaxations-from-Ct.py
            # :672-674): a rigid baseline needs a tumbling model.
            sys.exit(
                "= = = ERROR: --theoretical requires --tau or -D "
                "(a rigid baseline needs a diffusion model)"
            )
        rates = stage_relax_theoretical(
            diffusion, freq_mhz=freq_mhz, nuclei=a.nuclei, zeta=zeta, device=device
        )
        label = {
            "isotropic": "Isotropic",
            "axisymmetric": "Anisotropic axial",
        }.get(diffusion.kind, diffusion.kind.capitalize())
        print(f"...{label} baseline values:")
        print("R1:", rates.R1.cpu().numpy())
        print("R2:", rates.R2.cpu().numpy())
        print("NOE:", rates.NOE.cpu().numpy())
        return
    if a.opt is not None and a.expfn is None:
        sys.exit("= = = ERROR: --opt requires an experimental file (--expfn)")
    csa = None
    if a.csa is not None:
        names = fctio.read_fittedct(a.in_ct, device="cpu").names
        csa = _parse_csa(a.csa, names)
    q_rot = np.array(_split_floats(a.q_rot)) if a.q_rot else None
    stage_relax(
        a.in_ct, a.outpref, diffusion,
        vec_file=a.distfn, q_rot=q_rot, freq_mhz=freq_mhz, nuclei=a.nuclei,
        time_unit=a.time_unit, zeta=zeta, csa=csa, jomega=a.Jomega,
        shift_res=a.shiftres,
        expt_file=a.expfn, opt_mode=a.opt, max_cycles=a.cycles, tol=a.tol,
        opt_method=a.method,
        vec_avg_file=a.vecfn, ref_pdb=a.reffn, traj_file=a.trjfn,
        ref_hsel=a.refHsel, ref_xsel=a.refXsel, device=device,
    )
    print(" = = Completed Relaxation calculations.")


def cmd_multifield(argv, device="cuda"):
    p = argparse.ArgumentParser(
        prog="spinrelax multifield",
        description="Global parameter optimisation against multiple "
        "experimental spin-relaxation datasets.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("expFiles", nargs="+")
    p.add_argument("-f", "--infn", dest="in_ct", required=True)
    p.add_argument("-o", "--outpref", default="out")
    p.add_argument("--distfn", default=None)
    p.add_argument("--refpdb", default=None,
                   help="take one X-H vector per residue from this PDB "
                        "instead of a --distfn distribution")
    p.add_argument("--tau", type=float, default=None)
    p.add_argument("--aniso", type=float, default=None)
    p.add_argument("-D", "--DTensor", dest="D", default=None,
                   help=_D_HELP["multifield"])
    p.add_argument("--zeta", type=float, default=0.890023)
    p.add_argument("--csa", default=None)
    p.add_argument("--opt", "--fit", dest="opt", default=None)
    p.add_argument("--cycles", type=int, default=10)
    p.add_argument("--tol", type=float, default=1e-6)
    p.add_argument("--method", choices=("powell", "gradient", "device"),
                   default="powell")
    p.add_argument("--devices", type=int, default=0, metavar="N",
                   help="run the optimisation residue-sharded over an "
                   "N-device mesh (requires --opt; exports are unchanged)")
    a = p.parse_args(argv)
    from ..io import fittedct as fctio
    from .stages import stage_multifield

    diffusion = _parse_diffusion(a, flavor="multifield")
    if diffusion.kind == "direct":
        # Match the reference's immediate, actionable exit
        # (calculate-relaxations-multi-field.py:16-18) instead of a
        # ValueError traceback out of the evaluation internals.
        sys.exit("= = ERROR: No global tumbling parameters given! "
                 "(pass --tau or -D)")
    csa = None
    if a.csa is not None:
        names = fctio.read_fittedct(a.in_ct, device="cpu").names
        csa = _parse_csa(a.csa, names)
    opt = a.opt.split(",") if a.opt else None
    if a.devices > 0 and opt is None:
        sys.exit("= = = ERROR: --devices shards the optimisation; it "
                 "requires --opt.")
    final = stage_multifield(
        a.in_ct, a.expFiles, a.outpref, diffusion,
        vec_file=a.distfn, zeta=a.zeta, csa=csa, opt_params=opt,
        max_cycles=a.cycles, tol=a.tol, method=a.method,
        include_expt=opt is not None, ref_pdb=a.refpdb, devices=a.devices,
        device=device,
    )
    if final["chisq"] is not None:
        print(
            "= = = Optimisation complete. Final chi-value: %g"
            % np.sqrt(final["chisq"])
        )


def cmd_rho(argv, device="cuda"):
    p = argparse.ArgumentParser(
        prog="spinrelax rho",
        description="rho = R1'/R2' ratio from experimental R1/R2/NOE.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("-f", dest="exptFile", required=True)
    p.add_argument("-o", dest="outputFile", default="out_expRho.dat")
    p.add_argument("-n", "--nuclei", default="NH", choices=("NH", "CH"))
    a = p.parse_args(argv)
    from ..constants import BOND_ISOTOPES, gamma
    from ..io import xvg
    from ..ops.relaxation import rho_from_rates

    dev = checked_device(device)

    iso_a = BOND_ISOTOPES[a.nuclei]
    resid, block = xvg.load_xys(a.exptFile)
    ny = block.shape[1]
    if ny == 6:
        block = block.reshape(len(resid), 3, 2)[..., 0]
    elif ny != 3:
        sys.exit("= = = ERROR: expected 3 or 6 data columns (R1 R2 NOE [errs])")
    r = torch.as_tensor(block, dtype=torch.float64, device=dev)
    rho = rho_from_rates(
        r[:, 0], r[:, 1], r[:, 2], gamma_a=gamma(iso_a), gamma_b=gamma("1H"),
    ).cpu().numpy()
    xvg.print_xy(a.outputFile, resid, rho)
    print(f"= = Wrote {a.outputFile}")


def cmd_hydronmr(argv, device="cuda"):
    from ..io.hydronmr import main as hydronmr_main

    hydronmr_main(argv)


def cmd_bmrb(argv, device="cuda"):
    from ..io.bmrb import main as bmrb_main

    bmrb_main(argv)


def cmd_plot_ct(argv, device="cuda"):
    from .plotting import main as plot_main

    plot_main(argv)


def cmd_rotate(argv, device="cuda"):
    p = argparse.ArgumentParser(
        prog="spinrelax rotate",
        description="Quaternion-rotate a PDB about its centre of mass.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("-f", dest="fileInput", required=True)
    p.add_argument("-q", dest="qRot", required=True, help='"w,x,y,z" or "w x y z"')
    p.add_argument("-o", dest="fileOutput", default="rotated.pdb")
    a = p.parse_args(argv)
    from ..core import quaternion as qt
    from ..io import pdb as pdbio

    dev = checked_device(device)
    q_rot = np.array(_split_floats(a.qRot))
    top, xyz = pdbio.read_structure(a.fileInput)
    com = xyz.mean(axis=1, keepdims=True)
    rotated = qt.rotate_vector(
        torch.as_tensor(xyz - com, device=dev),
        torch.as_tensor(q_rot, dtype=torch.float64, device=dev),
    ).cpu().numpy() + com
    pdbio.write_structure(a.fileOutput, top, rotated)
    print(f"= = = Done. Output file {a.fileOutput} has been written.")


def _ortho_box(boxes33):
    """(nFrames, 3, 3) box matrices -> (nFrames, 3) orthorhombic lengths;
    the native PBC repair supports orthorhombic cells only."""
    off = boxes33 - boxes33 * np.eye(3)
    if np.abs(off).max() > 1e-5:
        raise SystemExit(
            "= = Triclinic box detected; the native PBC repair supports "
            "orthorhombic cells only (convert with gmx trjconv -ur rect)."
        )
    return np.einsum("fii->fi", boxes33)


def cmd_center(argv, device="cuda"):
    """Native center-solute-gromacs.bash: make molecules whole, cluster
    the solute across periodic images, centre it, and re-pack the solvent
    compactly (3-stage trjconv pipeline, center-solute-gromacs.bash:70-80)
    — no GROMACS required."""
    p = argparse.ArgumentParser(
        prog="spinrelax center",
        description="PBC-repair a solvated trajectory: -pbc mol, "
        "-pbc cluster -center on the solute, -pbc mol (native trjconv).",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("-f", "--infn", required=True,
                   help="trajectory (npz/npy/xtc/trr/dcd/nc/gro/pdb/mdcrd/xyz)")
    p.add_argument("-s", "--topfn", required=True,
                   help="topology structure: .pdb/.gro, or .psf (exact "
                        "bond-graph molecule decomposition)")
    p.add_argument("-o", "--outfn", default="centered.npz", help="output (npz or xtc)")
    p.add_argument("--box", default=None,
                   help='"x,y,z" box lengths [nm] when the file has none')
    p.add_argument("--solute", default=None,
                   help="solute selection expr (default: not water/ions); "
                        "with --ndx, the name of an index group instead")
    p.add_argument("--ndx", default=None,
                   help="GROMACS index file; --solute names a group in it "
                        "(the reference feeds trjconv the auto-generated "
                        "solute.ndx this way)")
    p.add_argument("--write-ndx", default=None, metavar="FILE",
                   help="also write the solute group as a .ndx index file "
                        "(interop with real GROMACS tooling)")
    p.add_argument("--output-group", choices=["system", "solute"],
                   default="system",
                   help="atoms written out (the reference keeps Solute)")
    p.add_argument("--batch", type=int, default=256, help="frames per device step")
    p.add_argument("--mol-breaks", default=None, metavar="RESID[,RESID...]",
                   help="force new-molecule boundaries at these residue "
                        "numbers (a ligand numbered contiguously after the "
                        "protein is otherwise imaged as part of it — a PDB "
                        "carries no bond table)")
    a = p.parse_args(argv)
    from ..io import pdb as pdbio
    from ..io import trajectory as trjio
    from ..io.zopen import fmt_name
    from ..ops.pbc import apply_molecule_breaks, center_solute, molecule_ids, solute_mask

    dev = checked_device(device)

    psf_mol_id = None
    if fmt_name(a.topfn).endswith((".psf", ".prmtop", ".parm7")):
        # PSF/prmtop topologies carry the bond table: molecule
        # decomposition is EXACT (connected components) — no residue-
        # contiguity heuristic, no --mol-breaks needed for ligands.
        from ..io import psf as psfio

        if fmt_name(a.topfn).endswith(".psf"):
            top, bonds = psfio.read_psf(a.topfn)
        else:
            from ..io import prmtop as prmio

            top, bonds = prmio.read_prmtop(a.topfn)
        if bonds.size:
            psf_mol_id = psfio.molecule_ids_from_bonds(top.n_atoms, bonds)
    else:
        top, _ = pdbio.read_structure(a.topfn)
    box_override = (
        np.asarray(_split_floats(a.box)) if a.box is not None else None
    )

    # xtc/trr inputs stream in --batch-sized chunks (the command targets
    # multi-GB solvated trajectories; the frames are repaired
    # independently, so chunking is exact); .xtc outputs append
    # incrementally so system-group conversions stay constant-memory.
    def chunk_iter():
        if a.infn.endswith(".xtc"):
            from ..io import native

            for xyz_c, b33, t_c in native.iter_xtc(a.infn, a.batch,
                                                   threads=0):
                yield xyz_c, _ortho_box(b33), t_c
        elif a.infn.endswith(".trr"):
            from ..io import gmx

            fs, bs, ts = [], [], []
            for xyz_f, box_f, t_f in gmx.iter_trr(a.infn):
                fs.append(xyz_f)
                bs.append(box_f)
                ts.append(t_f)
                if len(fs) == a.batch:
                    yield np.stack(fs), _ortho_box(np.stack(bs)), np.asarray(ts)
                    fs, bs, ts = [], [], []
            if fs:
                yield np.stack(fs), _ortho_box(np.stack(bs)), np.asarray(ts)
        elif a.infn.endswith(".dcd"):
            from ..io import dcd as dcdio

            for xyz_c, b33, t_c in dcdio.iter_dcd(a.infn, a.batch):
                yield (
                    xyz_c,
                    None if b33 is None else _ortho_box(b33),
                    t_c,
                )
        elif a.infn.endswith(".nc"):
            from ..io import amber

            for xyz_c, b33, t_c in amber.iter_nc(a.infn, a.batch):
                yield (
                    xyz_c,
                    None if b33 is None else _ortho_box(b33),
                    t_c,
                )
        elif a.infn.endswith((".gro", ".gro.gz")):
            from ..io import gro

            _gtop, xyz, b33, t = gro.read_gro(a.infn)
            yield xyz, _ortho_box(b33), t
        elif a.infn.endswith(".npz"):
            # One archive read: load_trajectory would decode the same
            # multi-GB npz a second time just to drop the box.
            obj = np.load(a.infn)
            xyz = np.asarray(obj["xyz"])
            if "time" in obj:
                t = np.asarray(obj["time"])
            elif "timestep" in obj:
                # load_trajectory honours this key too; dropping it here
                # silently reset the output timestep to 1.0.
                t = np.arange(xyz.shape[0]) * float(obj["timestep"])
            else:
                t = None
            boxes = np.asarray(obj["box"]) if "box" in obj else None
            if boxes is not None and boxes.ndim == 3:
                # Per-frame box matrices (the layout cmd_center's own XTC
                # writer emits): reduce to orthorhombic lengths like the
                # xtc/trr input paths — a diagonal matrix would otherwise
                # fail the all-positive check on its off-diagonal zeros.
                yield xyz, _ortho_box(boxes), t
            elif boxes is not None and boxes.shape == (3, 3) and not (
                xyz.shape[0] == 3 and np.all(boxes > 0)
            ):
                # ONE box matrix for the whole trajectory — broadcast to
                # every frame.  The (3,3) shape is ambiguous with three
                # frames of per-frame lengths; an all-positive array for
                # a 3-frame trajectory is read as lengths (a box MATRIX
                # always has zero off-diagonals in the orthorhombic case
                # this command supports).
                b = _ortho_box(boxes[None])
                yield xyz, np.broadcast_to(b, (xyz.shape[0], 3)).copy(), t
            else:
                yield xyz, boxes, t
        else:
            xyz, dt_ = trjio.load_trajectory(a.infn, top_fn=a.topfn)
            yield xyz, None, np.arange(xyz.shape[0]) * dt_

    solute = None
    if a.ndx is not None:
        from ..io import ndx as ndxio

        try:
            groups = ndxio.read_ndx(a.ndx)
            solute = ndxio.group_mask(
                groups, a.solute or "Solute", top.n_atoms
            )
        except ndxio.NdxError as e:
            raise SystemExit(f"= = Bad index file {a.ndx!r}: {e}")
    elif a.solute is not None:
        mask = np.zeros(top.n_atoms, dtype=bool)
        mask[top.select(a.solute)] = True
        solute = mask
    if a.write_ndx is not None:
        from ..io import ndx as ndxio

        sol = solute if solute is not None else solute_mask(top)
        ndxio.write_ndx(
            a.write_ndx, {"Solute": np.where(np.asarray(sol))[0]}
        )
        print(f"= = Wrote index file {a.write_ndx}")
    mol_id = psf_mol_id  # exact bond-graph molecules when -s was a PSF
    if a.mol_breaks is not None:
        # Specs stay strings: apply_molecule_breaks accepts both plain
        # residue numbers and chain-qualified "A:200" forms.
        breaks = [x.strip() for x in a.mol_breaks.split(",") if x.strip()]
        try:
            mol_id = apply_molecule_breaks(
                molecule_ids(top) if mol_id is None else mol_id,
                top, breaks,
            )
        except ValueError as e:
            raise SystemExit(
                f"= = Bad --mol-breaks spec {a.mol_breaks!r} "
                f"(use RESID or CHAIN:RESID, comma-separated): {e}"
            )
    # The topology's molecules and solute once, not once a chunk.
    if mol_id is None:
        mol_id = molecule_ids(top)
    if solute is None:
        solute = solute_mask(top)
    keep = solute if a.output_group == "solute" else None

    out_chunks = []  # npz path only; .xtc appends incrementally
    n_done = 0
    first_times = []  # first two timestamps across chunk boundaries
    for xyz_c, boxes_c, times_c in chunk_iter():
        if box_override is not None:
            boxes_c = box_override
        if boxes_c is None:
            raise SystemExit("= = No box in input; pass --box x,y,z [nm].")
        if not np.all(np.asarray(boxes_c) > 0):
            # A TRR/XTC written without a box block decodes as zeros;
            # imaging with box=0 would silently emit all-NaN coordinates.
            raise SystemExit(
                "= = Input frames carry a zero/absent box; pass --box x,y,z [nm]."
            )
        if times_c is not None and len(first_times) < 2:
            first_times.extend(
                float(t) for t in np.atleast_1d(times_c)[: 2 - len(first_times)]
            )
        out = center_solute(xyz_c, boxes_c, top=top, mol_id=mol_id,
                            solute=solute, batch=a.batch, device=dev)
        if keep is not None:
            out = out[:, keep]
        if a.outfn.endswith(".xtc"):
            from ..io import native

            nf = out.shape[0]
            b = (
                np.broadcast_to(boxes_c, (nf, 3))
                if np.ndim(boxes_c) == 1 else boxes_c
            )
            boxes33 = np.zeros((nf, 3, 3), dtype=np.float32)
            boxes33[:, [0, 1, 2], [0, 1, 2]] = b
            times_w = (
                np.asarray(times_c, dtype=np.float32)
                if times_c is not None
                else np.arange(n_done, n_done + nf, dtype=np.float32)
            )
            native.write_xtc(a.outfn, out, times=times_w, boxes=boxes33,
                             append=n_done > 0, step0=n_done)
        else:
            out_chunks.append(np.asarray(out))
        n_done += out.shape[0]
        print(f"= = ...repaired {n_done} frames x {xyz_c.shape[1]} atoms")
    if n_done == 0:
        raise SystemExit("= = Empty trajectory input.")
    if not a.outfn.endswith(".xtc"):
        dt = (
            first_times[1] - first_times[0] if len(first_times) == 2 else 1.0
        )
        trjio.save_trajectory_npz(
            a.outfn, np.concatenate(out_chunks, axis=0), timestep=dt
        )
    print(f"= = Wrote {a.outfn}")


def cmd_run_all(argv, device="cuda"):
    from .runall import main as runall_main

    runall_main(argv, device=device)


def cmd_make_ref(argv, device="cuda"):
    """Create a centred reference PDB from a trajectory frame
    (create-reference-pdb.bash equivalent: gmx editconf -center)."""
    p = argparse.ArgumentParser(
        prog="spinrelax make-ref",
        description="Write a centred reference structure from a trajectory frame.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("-f", "--infn", required=True, help="trajectory (npz/pdb)")
    p.add_argument("-s", "--topfn", default=None,
                   help="topology PDB (required for npz trajectories)")
    p.add_argument("-o", "--outfn", default="reference.pdb")
    p.add_argument("--frame", type=int, default=0)
    p.add_argument("--box", type=float, nargs=3, default=None,
                   help="orthorhombic box lengths [nm] to unwrap PBC first")
    a = p.parse_args(argv)
    from ..io import pdb as pdbio
    from ..io import trajectory as trajio
    from ..io.zopen import fmt_name

    dev = checked_device(device)

    top_fn = a.topfn or (
        a.infn
        if fmt_name(a.infn).endswith((".pdb", ".gro"))
        else None
    )
    if top_fn is None:
        sys.exit("= = = ERROR: npz trajectories need a topology PDB (-s)")
    top, _ = pdbio.read_structure(top_fn)
    xyz, _ = trajio.load_trajectory(a.infn, top_fn=top_fn)
    if not (-xyz.shape[0] <= a.frame < xyz.shape[0]):
        # An out-of-range slice is silently empty — it would "succeed"
        # writing an atom-less reference PDB.
        sys.exit(
            f"= = = ERROR: --frame {a.frame} out of range "
            f"(trajectory has {xyz.shape[0]} frames)"
        )
    frame = xyz[a.frame][None]
    if a.box is not None:
        from ..ops.pbc import unwrap_and_center

        frame = unwrap_and_center(torch.as_tensor(frame, device=dev), a.box).cpu().numpy()
    else:
        frame = frame - frame.mean(axis=1, keepdims=True)
    pdbio.write_structure(a.outfn, top, frame)
    print(f"= = Wrote {a.outfn} (frame {a.frame}, centred)")


def cmd_check(argv, device="cuda"):
    """Environment self-check (check-installation.bash + check-packages.py
    equivalent): the required and optional packages, the compute device,
    the host libraries' builds (libfastio, the XTC codec) and one J(omega)
    evaluation on the device."""
    import importlib

    print("= = spinrelax_tpu_torch installation check = =")
    ok = True
    for mod, required in (
        ("torch", True), ("numpy", True), ("scipy", True),
        ("matplotlib", False), ("mdtraj", False), ("pynmrstar", False),
    ):
        try:
            m = importlib.import_module(mod)
            ver = getattr(m, "__version__", "?")
            print(f"  [ok]   {mod} {ver}")
        except ImportError:
            status = "MISSING (required)" if required else "absent (optional)"
            print(f"  [{'!!' if required else '--'}]   {mod}: {status}")
            ok &= not required
    try:
        dev = checked_device(device)
    except RuntimeError as exc:
        print(f"  [!!]   {exc}")
        print("= = check FAILED = =")
        sys.exit(1)
    if dev.type == "cuda":
        print(f"  [ok]   device {dev}: {torch.cuda.get_device_name(dev)} "
              f"(CUDA {torch.version.cuda})")
    else:
        print(f"  [ok]   device {dev}")
    from .. import _build

    for name, what in (("fastio", "text I/O library"), ("xtc", "XTC codec")):
        try:
            _build.load_host(name)
            print(f"  [ok]   {what} ({_build.host_library_path(name).name})")
        except (OSError, RuntimeError) as exc:
            print(f"  [!!]   {what} failed to build or load: {exc}")
            ok = False
    from ..ops.jomega import j_rigid_sphere_D

    val = float(j_rigid_sphere_D(torch.zeros((), dtype=torch.float64, device=dev),
                                 torch.tensor(1.0 / 6.0, dtype=torch.float64, device=dev)))
    if abs(val - 1.0) < 1e-6:
        print(f"  [ok]   J(omega) evaluates on {dev}")
    else:
        print(f"  [!!]   J(omega) on {dev} gave {val!r}, expected 1")
        ok = False
    print("= = check %s = =" % ("PASSED" if ok else "FAILED"))
    if not ok:
        sys.exit(1)


def cmd_convert(argv, device="cuda"):
    """Native trjconv-style trajectory conversion: any supported input
    format -> npz/npy/xtc/trr/dcd/nc/gro/pdb/xyz, with optional atom
    selection
    (expression or index group) and frame range/stride.  Streaming
    (constant-memory) wherever both codecs allow — xtc/dcd/gro outputs
    append chunk by chunk; npz/trr/nc/pdb outputs buffer in RAM."""
    p = argparse.ArgumentParser(
        prog="spinrelax convert",
        description="Convert trajectories between the native formats "
        "(npz/npy/pdb/gro/trr/xtc/dcd/nc/mdcrd/xyz in; "
        "npz/npy/xtc/trr/dcd/nc/gro/pdb/xyz out), with atom selection and frame ranges — the trjconv "
        "conversions the reference workflow shells out for.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("-f", "--infn", required=True)
    p.add_argument("-o", "--outfn", required=True)
    p.add_argument("-s", "--topfn", default=None,
                   help="topology (.pdb/.gro/.psf); required for pdb/gro "
                        "output and for --select/--ndx")
    p.add_argument("--select", default=None,
                   help="atom selection expression (io.pdb DSL)")
    p.add_argument("--ndx", default=None, help="GROMACS index file")
    p.add_argument("--group", default=None,
                   help="index group to keep (with --ndx)")
    p.add_argument("-b", "--begin", type=float, default=None,
                   help="first frame time [ps]")
    p.add_argument("-e", "--end", type=float, default=None,
                   help="last frame time [ps]")
    p.add_argument("--skip", type=int, default=1,
                   help="write every N-th in-range frame")
    p.add_argument("--timestep", type=float, default=1.0,
                   help="frame spacing [ps] when the input stores none")
    p.add_argument("--batch", type=int, default=1000,
                   help="frames per streamed chunk")
    p.add_argument("--precision", type=float, default=1000.0,
                   help=".xtc output quantisation (1000 = 0.001 nm)")
    p.add_argument("--superpose", default=None, metavar="REF",
                   help="least-squares fit every frame onto this "
                        "reference structure (.pdb/.gro) before writing "
                        "(trjconv -fit rot+trans; boxes pass through "
                        "unchanged, as trjconv's do)")
    p.add_argument("--fitsel", default="occupancy > 0",
                   help="atoms the --superpose fit uses (reference's "
                        "occupancy-flag convention)")
    p.add_argument("--out-top", default=None, metavar="FILE",
                   help="also write the (selected) topology as a "
                        ".pdb/.gro structure using the first output "
                        "frame's coordinates (needs -s)")
    a = p.parse_args(argv)
    from ..io import pdb as pdbio
    from ..io import trajectory as trjio
    from ..io.zopen import fmt_name as _fmt_name

    dev = checked_device(device)

    out_base = _fmt_name(a.outfn)  # text writers gzip a .gz suffix
    out_ext = out_base.rsplit(".", 1)[-1] if "." in out_base else ""
    if out_ext not in ("npz", "npy", "xtc", "trr", "dcd", "nc", "gro",
                       "pdb", "xyz"):
        sys.exit(f"= = = ERROR: unsupported output format {a.outfn!r} "
                 "(npz/npy/xtc/trr/dcd/nc/gro/pdb/xyz; text formats may "
                 "add .gz)")
    if a.outfn != out_base and out_ext not in ("gro", "pdb", "xyz"):
        sys.exit(f"= = = ERROR: cannot gzip binary output {a.outfn!r} "
                 "(only gro/pdb/xyz support a .gz suffix)")
    if a.skip < 1:
        sys.exit("= = = ERROR: --skip must be >= 1")
    if a.batch < 1:
        sys.exit("= = = ERROR: --batch must be >= 1")

    top = None
    if a.topfn is not None:
        top = pdbio.read_topology(a.topfn)
    sel_idx = None
    if a.ndx is not None:
        from ..io import ndx as ndxio

        if top is None:
            sys.exit("= = = ERROR: --ndx needs a topology (-s)")
        gname = a.group or "Solute"
        try:
            groups = ndxio.read_ndx(a.ndx)
            ndxio.group_mask(groups, gname, top.n_atoms)  # name+bounds
        except ndxio.NdxError as e:
            sys.exit(f"= = = ERROR: bad index file {a.ndx!r}: {e}")
        # keep the group's own atom ORDER (trjconv -n writes atoms in
        # group order, which users rely on to reorder systems)
        sel_idx = groups[gname]
        if len(np.unique(sel_idx)) != len(sel_idx):
            sys.exit(f"= = = ERROR: group {gname!r} lists atoms twice")
    elif a.group is not None:
        sys.exit("= = = ERROR: --group needs --ndx")
    elif a.select is not None:
        if top is None:
            sys.exit("= = = ERROR: --select needs a topology (-s)")
        sel_idx = top.select(a.select)
        if len(sel_idx) == 0:
            sys.exit(f"= = = ERROR: selection {a.select!r} matches no atoms")
    if out_ext in ("gro", "pdb") and top is None:
        sys.exit(f"= = = ERROR: .{out_ext} output needs a topology (-s)")

    top_out = top
    if sel_idx is not None and top is not None:
        top_out = pdbio.Topology(
            atom_names=[top.atom_names[i] for i in sel_idx],
            res_seqs=np.asarray(top.res_seqs)[sel_idx],
            res_names=[top.res_names[i] for i in sel_idx],
            chain_ids=[top.chain_ids[i] for i in sel_idx],
            occupancies=np.asarray(top.occupancies)[sel_idx],
            elements=[top.elements[i] for i in sel_idx],
        )

    if a.out_top is not None and top is None:
        sys.exit("= = = ERROR: --out-top needs a topology (-s)")

    sup_ref = sup_w = None
    if a.superpose is not None:
        rtop, rxyz = pdbio.read_structure(a.superpose)
        fit_idx = rtop.select(a.fitsel)
        if len(fit_idx) == 0:
            sys.exit(f"= = = ERROR: --fitsel {a.fitsel!r} matches no atoms "
                     f"of {a.superpose!r}")
        sup_w = np.zeros(rtop.n_atoms)
        sup_w[fit_idx] = 1.0
        sup_ref = rxyz[0]

    streaming = out_ext in ("xtc", "dcd", "gro", "xyz")
    buf_xyz, buf_box, buf_t = [], [], []
    first_frame = None  # first written frame (--out-top coordinates)
    n_in = n_written = 0
    kept = 0  # in-window frames seen (stride counter)
    dt_out = a.timestep * a.skip
    dt_fixed = False
    prev_last_t = None  # last written timestamp (spans chunk boundaries)
    any_box = None  # None = unknown yet; the writers need a consistent layout
    for xyz_c, boxes_c, times_c in trjio.iter_trajectory_full(
        a.infn, a.batch, top_fn=a.topfn
    ):
        c = xyz_c.shape[0]
        if n_in == 0:
            if top is not None and xyz_c.shape[1] != top.n_atoms:
                sys.exit(
                    f"= = = ERROR: trajectory has {xyz_c.shape[1]} atoms, "
                    f"topology has {top.n_atoms}"
                )
            any_box = boxes_c is not None
        if (boxes_c is not None) != any_box:
            sys.exit("= = = ERROR: box records appear/disappear mid-file")
        t_c = (
            np.asarray(times_c, dtype=float)
            if times_c is not None
            else (n_in + np.arange(c, dtype=float)) * a.timestep
        )
        n_in += c
        window = np.ones(c, dtype=bool)
        if a.begin is not None:
            window &= t_c >= a.begin
        if a.end is not None:
            window &= t_c <= a.end
        in_win = np.where(window)[0]
        pick = in_win[(kept + np.arange(len(in_win))) % a.skip == 0]
        kept += len(in_win)
        if len(pick) == 0:
            continue
        xyz_m = xyz_c[pick]
        if sup_ref is not None:
            if xyz_m.shape[1] != sup_ref.shape[0]:
                sys.exit(
                    f"= = = ERROR: --superpose reference has "
                    f"{sup_ref.shape[0]} atoms, trajectory {xyz_m.shape[1]}"
                )
            from ..ops.orient import superpose as _superpose

            f64 = dict(dtype=torch.float64, device=dev)
            xyz_m = _superpose(torch.as_tensor(xyz_m, **f64), torch.as_tensor(sup_ref, **f64),
                               torch.as_tensor(sup_w, **f64)).cpu().numpy()
        if sel_idx is not None:
            xyz_m = xyz_m[:, sel_idx]
        box_m = boxes_c[pick] if boxes_c is not None else None
        t_m = t_c[pick]
        if not dt_fixed:
            # output spacing from the first two written timestamps
            pair = (
                np.concatenate([[prev_last_t], t_m])
                if prev_last_t is not None else t_m
            )
            if len(pair) > 1:
                dt_out = float(pair[1] - pair[0])
                dt_fixed = True
        prev_last_t = float(t_m[-1])
        if streaming:
            if out_ext == "xtc":
                from ..io import native

                native.write_xtc(
                    a.outfn, xyz_m, times=t_m.astype(np.float32),
                    boxes=None if box_m is None
                    else np.asarray(box_m, dtype=np.float32),
                    precision=a.precision,
                    append=n_written > 0, step0=n_written,
                )
            elif out_ext == "dcd":
                from ..io import dcd as dcdio

                dcdio.write_dcd(
                    a.outfn, xyz_m, boxes=box_m, timestep_ps=dt_out,
                    append=n_written > 0,
                )
            elif out_ext == "xyz":
                from ..io import xyz as xyzio

                xyzio.write_xyz(
                    a.outfn, xyz_m,
                    elements=(
                        top_out.elements if top_out is not None else None
                    ),
                    comments=[f"t= {t:g} ps" for t in t_m],
                    append=n_written > 0,
                )
            else:  # gro
                from ..io import gro as groio

                groio.write_gro(
                    a.outfn, top_out, xyz_m,
                    boxes=box_m, times=t_m, append=n_written > 0,
                )
        else:
            buf_xyz.append(xyz_m)
            if box_m is not None:
                buf_box.append(box_m)
            buf_t.append(t_m)
        if first_frame is None:
            first_frame = np.asarray(xyz_m[0])
        n_written += len(pick)
    if n_written == 0:
        sys.exit("= = = ERROR: no frames selected (empty input or "
                 "begin/end window excludes everything).")
    if not streaming:
        xyz_all = np.concatenate(buf_xyz)
        t_all = np.concatenate(buf_t)
        box_all = np.concatenate(buf_box) if buf_box else None
        if out_ext == "npz":
            payload = {"xyz": xyz_all, "time": t_all, "timestep": dt_out}
            if box_all is not None:
                payload["box"] = box_all
            np.savez_compressed(a.outfn, **payload)
        elif out_ext == "npy":
            # bare array: the memmap out-of-core ingest format
            # (iter_trajectory .npy branch) — no time axis, so echo the
            # spacing for the downstream --timestep flag
            np.save(a.outfn, xyz_all)
            print(f"= = .npy carries no times: pass --timestep {dt_out:g} "
                  "downstream")
        elif out_ext == "trr":
            from ..io import gmx

            gmx.write_trr(a.outfn, xyz_all, times=t_all, box=box_all)
        elif out_ext == "nc":
            from ..io import amber

            amber.write_nc(a.outfn, xyz_all, boxes=box_all,
                           timestep_ps=dt_out, times=t_all)
        else:  # pdb
            pdbio.write_pdb(a.outfn, top_out, xyz_all)
    if a.out_top is not None:
        pdbio.write_structure(a.out_top, top_out, first_frame[None])
        print(f"= = Wrote topology {a.out_top}")
    print(f"= = Wrote {a.outfn}: {n_written}/{n_in} frames"
          + (f", {len(sel_idx)} atoms" if sel_idx is not None else ""))


def _traj_info(fn: str, top_fn=None):
    """-> dict(frames, atoms, dt [ps or None], t0, box (3,) lengths or
    None) using header-only scans where the format allows."""
    import os

    rec = {"frames": None, "atoms": None, "dt": None, "t0": None,
           "box": None, "size": os.path.getsize(fn)}

    def first_chunk(n=2):
        from ..io import trajectory as trjio

        return next(trjio.iter_trajectory_full(fn, n, top_fn=top_fn))

    if fn.endswith(".xtc"):
        from ..io import native

        rec["frames"], rec["atoms"] = native.info_xtc(fn)
        if rec["frames"]:
            xyz, boxes, times = first_chunk()
            rec["t0"] = float(times[0])
            if len(times) > 1:
                rec["dt"] = float(times[1] - times[0])
            rec["box"] = np.diag(boxes[0]) if np.any(boxes[0]) else None
    elif fn.endswith(".trr"):
        from ..io import gmx

        rec["frames"], rec["atoms"], times = gmx.info_trr(fn)
        if times:
            rec["t0"] = times[0]
            if len(times) > 1:
                rec["dt"] = times[1] - times[0]
        if rec["frames"]:
            _, boxes, _ = first_chunk(1)
            if boxes is not None and np.any(boxes[0]):
                rec["box"] = np.diag(boxes[0])
    elif fn.endswith(".dcd"):
        from ..io import dcd as dcdio

        rec["frames"], rec["atoms"], dt = dcdio.info_dcd(fn)
        rec["dt"] = dt or None
        rec["t0"] = 0.0
        if rec["frames"]:
            _, boxes, _ = first_chunk(1)
            if boxes is not None:
                rec["box"] = np.diag(boxes[0])
    elif fn.endswith(".nc"):
        from ..io import amber

        nc = amber._open(fn)
        try:
            shape = nc.variables["coordinates"].shape
            rec["frames"], rec["atoms"] = int(shape[0]), int(shape[1])
            if "time" in nc.variables and shape[0]:
                t = np.array(nc.variables["time"][:2], dtype=float)
                rec["t0"] = float(t[0])
                if len(t) > 1:
                    rec["dt"] = float(t[1] - t[0])
            if shape[0]:
                boxes = amber._boxes_from(nc, slice(0, 1))
                if boxes is not None:
                    rec["box"] = np.diag(boxes[0])
        finally:
            nc.close()
    else:
        from ..io import trajectory as trjio

        n = 0
        for xyz, boxes, times in trjio.iter_trajectory_full(
            fn, 1024, top_fn=top_fn
        ):
            if n == 0:
                rec["atoms"] = xyz.shape[1]
                if times is not None:
                    rec["t0"] = float(times[0])
                    if len(times) > 1:
                        rec["dt"] = float(times[1] - times[0])
                if boxes is not None and np.any(boxes[0]):
                    rec["box"] = np.diag(boxes[0])
            n += xyz.shape[0]
        rec["frames"] = n
    return rec


def cmd_info(argv, device="cuda"):
    """Inspect trajectory files (gmx check equivalent: frame/atom counts,
    timestep, duration, box) using header-only scans where possible."""
    p = argparse.ArgumentParser(
        prog="spinrelax info",
        description="Print frames, atoms, timestep, duration and box of "
        "trajectory files (npz/npy/pdb/gro/trr/xtc/dcd/nc/mdcrd/xyz).",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("files", nargs="+")
    p.add_argument("-s", "--topfn", default=None,
                   help="topology (needed for headerless .mdcrd/.crd)")
    a = p.parse_args(argv)
    bad = 0
    for fn in a.files:
        try:
            r = _traj_info(fn, top_fn=a.topfn)
        except Exception as e:
            print(f"{fn}: ERROR: {e}")
            bad += 1
            continue
        parts = [f"{r['frames']} frames x {r['atoms']} atoms"]
        if r["dt"]:
            dur = (r["frames"] - 1) * r["dt"]
            t0 = r["t0"] or 0.0
            parts.append(f"dt {r['dt']:g} ps, t {t0:g}..{t0 + dur:g} ps")
        else:
            parts.append("no timestep recorded")
        if r["box"] is not None:
            parts.append(
                "box " + "x".join(f"{v:.4g}" for v in r["box"]) + " nm"
            )
        parts.append(f"{r['size'] / 1e6:.6g} MB")
        print(f"{fn}: " + ", ".join(parts))
    if bad:
        sys.exit(1)


COMMANDS = {
    "center": cmd_center,
    "convert": cmd_convert,
    "info": cmd_info,
    "orient": cmd_orient,
    "dq": cmd_dq,
    "ct": cmd_ct,
    "s2": cmd_s2,
    "fit-ct": cmd_fit_ct,
    "relax": cmd_relax,
    "multifield": cmd_multifield,
    "rho": cmd_rho,
    "hydronmr": cmd_hydronmr,
    "bmrb": cmd_bmrb,
    "plot-ct": cmd_plot_ct,
    "rotate": cmd_rotate,
    "run-all": cmd_run_all,
    "check": cmd_check,
    "make-ref": cmd_make_ref,
}


def main(argv=None, device="cuda"):
    """Run one command of ``argv`` (default: the process's arguments) with
    its compute on ``device``: the card unless the caller asks for the
    CPU."""
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        print("Commands:", ", ".join(sorted(COMMANDS)))
        return 0
    cmd = argv[0]
    if cmd not in COMMANDS:
        print(f"unknown command {cmd!r}; available: {sorted(COMMANDS)}", file=sys.stderr)
        return 1
    # The JAX package turns on XLA's persistent compile cache here; the
    # port's counterpart is _build's hashed libraries, built once and
    # reused by every later process.
    t0 = time.time()
    try:
        COMMANDS[cmd](argv[1:], device)
    except FileNotFoundError as exc:
        # Reference-style bail (_BAIL, spectral_densities.py:1818-1823)
        # instead of a raw traceback for the most common user error.
        # Library callers (stages.*) still see the exception.
        sys.exit(f"= = = ERROR: file not found: {exc.filename or exc}")
    print("= = Finished. Total seconds elapsed: %g" % (time.time() - t0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
