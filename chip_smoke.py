#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (spinrelax_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ and runs, in order:

1. kernel A (C(t) lag sums) against its plain version in float64 on the
   card, at the forward's (32 x 1024 bonds, 1000 frames) chunk layout, a
   pretiled (256, 3, 1000, 128) group, and ragged and edge shapes (bond
   counts off the kernel's bonds per block in each layout, D = 37,
   F = 18 000); bound 1e-6 max abs on C(t) = -0.5 + 1.5 s / (F - d); its
   time at the forward's shape in the chunk, pretiled and contiguous
   layouts, each with its share of the bound;
2. kernels B and C (LM H/g/cost) against their plain versions in float64
   on the card at B = 1024, T = 500 for (K, s2_free) in (1, fixed),
   (2, free), (4, free) and on ragged (B, T) down to (1, 1);
   tests/test_engine.py's tolerances; C's cost equal to B's bit for bit,
   and a second launch equal to the first; their times at the forward's
   shape and at a ladder rung (B = 10 000, T = 500, K = 4, S2 free);
   then kernels D and E (the LM step around B and C: lm_step_solve,
   lm_step_gate) against their plain versions from the same state at
   those shapes, at K 1 and 3 with S2 fixed, at K 5, 8 and 16, and at
   the lane groups' edges (P 8, 9, 16, 17, 32, 33 at B 1, 7, 1025): D's
   t_new, trial parameters and norms within STEP_TOL of the plain version
   on every lane, t_new bit for bit on every positive-definite lane
   (STEP_BITS), NaN in both on exactly the lanes whose damped matrix is
   not positive definite, its error against a float64 solve at most twice
   the plain float32 version's; E equal to its plain version bit for bit;
   relaunches bit for bit; their times against their bounds, as CUDA
   events and as torch.profiler read them, and torch.linalg's Cholesky
   solve of D's damped matrices beside D;
3. the full-width forward step (32 Palmer chunks x 1000 frames x 1024
   N-H bonds, float32) on the card, counting kernel launches, held to the
   same forward on the CPU in float64 (C(t), rates, flags, median
   chi-square) and float32 (the fit's chi-square per lane, with
   tests/test_engine.py's criteria); one forward under torch.profiler for
   the device-busy time and kernels A's to E's launches and time per
   launch;
4. ten streamed pretiled group steps plus the pooled finish, held to a
   float64 plain route on the card (each residue's bond wobbles around
   its own axis: the forward's correlated walk, rolled over residues
   from group to group);
5. the DoF ladder (fit_ct_ladder: default ladder, warm retry, 8-start
   escalation) on entry.hetero_cohort (tests/test_walk.py's cohort mix)
   at B = 10 000 residues x T = 500 lags, float32, weighted: median wall
   of 3 calls, rows and kernel B/C launches per LM call (the ladder's
   trace), device busy, and on a 1024-row subset the rung selected on
   the card against the port's CPU float32 ladder (>= 98 % equal) and
   CPU float64 ladder (printed);
5b. the varpro ladder and the stacked ladder (fit_ct_ladder(optimiser=
   "varpro") and (stacked=True), over the generic LM fit.lm.lm_solve) on
   the same cohort at the same width: median wall of 3 calls, steps, each
   LM call's rows and iterations, device busy and idle share, peak device
   memory, kernel B/C launches (from varpro's warm retries only, which run
   fit.engine; counters and profiler), the graph loop equal to the eager
   loop bit for bit, and on the 1024-row subset the rung equal to the CPU
   float32 ladder's on >= 98 % of rows and the card in float64 within
   1e-8 of the CPU in float64 (fitted C(t) and chisq, rung on every row);
   then spectral_density's seven models (1e-12) and a batched legacy
   do_expstyle_fit (1e-8) on the card against the CPU in float64;
6. the streamed finish (run_finish: ladder -> axisymmetric J(omega) with
   64 weighted PAF samples -> ensemble rates) on phase 4's accumulators,
   held to the same finish on the CPU in float64 (median relative gap of
   every rate < 1e-4).

7. the streamed C(t) stage: (a) stage_ct_streamed on a synthetic .xtc of
   ubiquitin's size (1231 atoms, 71 N-H bonds, 20 000 frames 2 ps apart,
   tau_memory 4000 ps: chunks of 2000 frames, 1000 lags), read by the
   native codec and written by libfastio (both built here with the host
   C++ compiler), held to the same stage on the CPU in float64 (C(t) 2e-6,
   S2 and the average vector 1e-5, <= 1e-3 of the histogram's samples in
   another bin: float32 vectors differ from float64 ones by ~1e-7, so a
   sample that close to a bin edge lands next door), with the C(t) writer
   timed through libfastio and through numpy's row formatter (the same
   bytes); (b) 10 group steps of 4 chunks x 2000 frames x 1024 bonds from
   observables made on the card, through bond_vectors_from_obs and the
   fused update, held to a float64 plain route on the card, with the
   step's time, kernel A's launches (2 a group) and time from the
   profiler, eigh's time and the idle share; (c) entry.ct_entry() from
   file to rates, held to its CPU run;
8. run-all: (a) pipeline.runall.main on phase 7a's file (-t_mem 4000,
   -num_chunks 4, -Bfields 600.133 850.13, -Jw, the in-memory C(t)):
   orientation colvar, Delta-q -> D tensor, stage_ct (kernel A twice),
   the DoF ladder (kernels B and C), rates and J(w) at both fields, held
   to the same workflow on the CPU in float64 (D_i and Diso 1e-6
   relative, the anisotropies as printed, C(t) 2e-6, rungs equal on
   >= 98 %, every rate and J(w) value of a residue of equal rung 1e-5
   relative plus a small atol), with each step's wall,
   the launches of A, B and C from the wrappers and the profiler, the
   device's idle share, and a second main() that skips every stage;
   (b) Delta-q at 10^6 frames of anisotropic Brownian tumbling made on
   the card (a prefix product by doubling), written as a colvar through
   io.colvar, through stage_dq in memory and streamed (65 536 frames a
   part), 100 lags of 10 ps, 4 sub-chunks, held to each other and to the
   CPU in float64 (D 1e-10 relative), with the read, statistics and
   finalise times, frames/s and peak device memory.

9. the multi-field global fit and the legacy fits: (a) run-all -fit Diso
   and Diso,rsCSA (pipeline.runall.main with -expfiles) from the .xtc on
   the card (kernels A, B and C counted), against experiments made at a
   truth (0.85 x the run's Diso, its Daniso, a CSA per residue drawn in
   [-190, -150] ppm, R1/R2/NOE at 600.133 and 850.13 MHz, 2 % errors,
   every 7th residue unmeasured): run-all's 10-cycle result within 1e-2
   of the truth, its continuation to convergence (the fused device cycle)
   within 1e-3, uncovered residues keeping their CSA; the same fits on
   phase 8a's CPU directory (earlier steps skipped) on the card and on
   the CPU in float64, every value of every artefact within Powell's
   1e-4 relative; stage_relax's legacy fits Diso, DisoS2CSA and new on
   the run's average vectors, each against the truth (tests/
   test_legacyfit.py's tolerances) and the CPU; (b) GlobalFitter at a
   large protein's size (370 residues, maltose-binding protein's length,
   x 2592 weighted samples, stage_ct's 72 x 36 histogram bins; R1/R2/NOE
   at 600.133, 700.13 and 850.13 MHz; made on the card): powell,
   gradient and device on (Diso, Daniso), device on (Diso, rsCSA), each
   against the CPU float64 fit (Powell 1e-4, the others 1e-6) and the
   truth, the card's synchronising calls (torch's sync debug mode) equal
   to its counted host reads plus parameter uploads; the collapsed and
   the per-sample chi-square on the card within 1e-10.  Each fit prints
   its wall, evaluations or LM steps, host reads and device busy / idle
   share.

10. the command line (python -m spinrelax_tpu_torch) on a raw solvated
   system: phase 7a's solute (its first 5000 frames, its shell atoms in
   nearest-neighbour order) drifting across images of a cubic 6.0 nm box
   with 6900 three-site waters (21 931 atoms), wrapped, written as one
   .xtc; (a) check, info and center (--output-group solute) as
   subprocesses, center again through cli.main and once more under the
   profiler (wall, frames/s, decode / encode shares, busy / idle share,
   peak device memory), the three outputs the same bytes, the solute
   within 2e-3 nm (two XTC roundings) of the unwrapped truth recentred,
   and one batch against the CPU float64 center_solute (solute 1e-4 nm,
   every atom 1e-4 nm modulo whole boxes, the molecules imaged a box away
   counted, two card runs bit for bit); (b) the quick-start chain through
   cli.main on the centred .xtc: orient, dq, ct (--Ct --S2 --vecHist),
   ct --S2mode ired, ct --split 2 --S2mode wired, fit-ct, fit-ct
   --optimiser varpro, relax at
   600.133 and 850.13 MHz, rho; each step's wall, kernel A..E launches
   (wrappers and profiler) and idle share, held to the same chain on the
   CPU in float64 (phase 8a's tolerances; iRED / wiRED S2 1e-4).

11. the sharded paths (``parallel/``) on a one-rank NCCL group
   (``parallel.launch.start_one_rank``), at full width, each against its
   unsharded twin in this process: (a) ShardedCtStream over phase 4's ten
   groups (accumulators within 1e-6 of phase 4's, C(t) within 2e-6 of
   float64; kernel A's launches, the wall a group, the all-reduces' share
   of the busy time); (b) make_sharded_forward at phase 3's shape: every
   output equal bit for bit to the one-card forward over the same pooled
   sums, C(t) and the rates held to phase 3's forward at its tolerances;
   (c) run_sharded_finish on (a)'s accumulators against phase
   6's finish (rung equal on >= 98 %, rates within 1e-5 on equal rungs)
   and the CPU in float64; (d) shard_experiment_set at phase 9b's size:
   chisq_total within 1e-10, the device and Powell fits on (Diso, Daniso)
   within 1e-6 / 1e-4 of the unsharded card fits; (e) ct --split 2,
   fit-ct, multifield --opt Diso --method device and run-all -stream 2 on
   phase 7a's file through cli.main with and without --devices 1: the
   same files, byte for byte.  Each prints its wall, A..E launches and
   idle share.  ``chip_smoke.py 11`` runs phase 11 alone (after phases 4
   and 6, whose data it takes).

Phases 3, 5, 5b and 6 run their LM loops both ways in turns -- the CUDA graph
of one step, and the eager loop that issues every step from the host --
and hold the outputs equal bit for bit.  Kernel A is also timed against
its plain version (torch.fft) at the stage's chunk lengths, 1024 bonds at
F 2000 / D 1000 and F 10 000 / D 5000.

Kernel A also runs a chunk past one block's shared memory (F = 20 000,
the slab plan) and kernels B and C K = 5 and 8 (the runtime-K variant),
each held to its plain version and timed against its bound.

Prints ptxas' register report of the build, timing lines (kernel vs
plain, CUDA events, in turns), the card's name and power limit, one
``{"kernels": [...]}`` line, and last ``{"ok": true, "device": {...}}``.
Each kernel's ``bound_ms`` is the larger of its bytes (each input read
once, each output written once) over 3.35 TB/s and its float32 operations
(an FMA counts 2, a multiply, add or exp 1) over 67 TFLOP/s, the H100
SXM's published peaks, computed from this run's shapes; kernel A's
operations are the fewer of the direct lag sum's and an FFT
autocorrelation's (``acf_bound``).
Exits non-zero, without the last line, when there is no GPU, the package
is not beside the script, or any check fails.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
N_REP, N_FRAMES, N_RES = 32, 1000, 1024
N_DELTAS = N_FRAMES // 2
LONG_F, LONG_BONDS = 20_000, 64  # kernel A past one block's shared memory
LADDER_B, LADDER_T, SUBSET = 10_000, 500, 1024  # phase 5
ACF_BOUND = 1e-6  # max abs error on C(t) against float64
LM_TOL = dict(H=(3e-5, 1e-4), g=(3e-5, 1e-3), cost=(1e-5, 0.0))  # (rtol, atol)
HBM_BYTES_S, FP32_FLOP_S = 3.35e12, 67e12  # H100 SXM peaks at 700 W

failures: list[str] = []


def check(ok: bool, what: str) -> None:
    print(f"  [{'ok' if ok else 'FAIL'}] {what}", flush=True)
    if not ok:
        failures.append(what)


def cuda_ms(torch, fn, reps: int = 5) -> float:
    """Mean device time of fn() over reps launches (CUDA events, after a
    warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(torch, fn, reps: int = 5) -> float:
    """Device time per call of fn: reps calls captured in one CUDA graph and
    replayed between two CUDA events, so the host's cost of issuing a
    launch from Python, which exceeds a few-microsecond kernel, is not in
    the timing (after a warm-up call and a warm-up replay)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def paired_ms(torch, kernel_fn, plain_fn, reps: int = 5, timer=cuda_ms):
    """(kernel ms, plain ms): timer of each, timed in turns kernel,
    plain, plain, kernel so a drift of the card's clocks hits both."""
    k1, p1 = timer(torch, kernel_fn, reps), timer(torch, plain_fn, reps)
    p2, k2 = timer(torch, plain_fn, reps), timer(torch, kernel_fn, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def bound_ms(n_bytes: float, n_flops: float):
    """(least time in ms, what bounds it) at the card's published peaks."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_S, n_flops / FP32_FLOP_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def lm_bound(K: int, s2f: bool, B: int, T: int, full: bool):
    """bound_ms of kernel B (full) or C at (B, T).  Per (t, b) the residual
    takes K multiplies, K exps, K FMAs and 3 flops more, its square 1 FMA;
    kernel B adds the P Jacobian planes (2K or 3K multiplies, 3K) and the
    P(P+1)/2 + P FMAs of J^T J and J^T r."""
    P = 2 * K + int(s2f)
    flops = 4 * K + 5
    if full:
        flops += (K if s2f else 2 * K) + 3 * K + 2 * (P * (P + 1) // 2 + P)
    out = B * (P * P + P + 1) if full else B
    return bound_ms(4 * (2 * T * B + T + P * B + out), flops * T * B)


def wall_s(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"


def unit(torch, shape, gen):
    v = torch.randn(shape + (3,), generator=gen, device="cuda")
    return v / v.norm(dim=-1, keepdim=True)


def c_err(torch, s, ref, n_frames):
    """Max abs error on C(t) of lag-major lag sums (D, B)."""
    n = n_frames - torch.arange(1, s.shape[0] + 1, device=s.device,
                                dtype=torch.float64)
    return float((1.5 * (s.double() - ref) / n[:, None]).abs().max())


def acf_bound(n_bonds: int, n_frames: int, n_deltas: int):
    """bound_ms of kernel A: the input read once and the (D, B) output
    written once, and the fewer flops of two ways to the same sums.  The
    direct sum: sum_{d<=D} (F - d) terms a bond, each a 3-term dot (1
    multiply, 2 FMAs) and 1 FMA, 7 flops.  By FFT: s[d] = sum_{i<=j} w_ij
    autocorr(v_i v_j)[d] over the 6 component products (6F multiplies),
    each autocorrelation a real FFT and its inverse at N = the power of two
    >= F + D (2 x 2.5 N log2 N) and its power spectrum (1.5 N), and the
    weighted sum of the 6 (6 FMAs a lag)."""
    direct = 7 * (n_deltas * n_frames - n_deltas * (n_deltas + 1) // 2)
    n = 1 << (n_frames + n_deltas - 1).bit_length()
    log2n = n.bit_length() - 1
    fft = 6 * n_frames + 6 * (5 * n * log2n + 1.5 * n) + 12 * n_deltas
    return bound_ms(4 * n_bonds * (3 * n_frames + n_deltas), n_bonds * min(direct, fft))


def phase_acf(torch, tac, cuda_acf, vecs, gen):
    print("phase 1: kernel A (acf_lag_sums) vs acf_sums_plain, float64 reference",
          flush=True)
    worst = 0.0
    grp = unit(torch, (N_REP, N_FRAMES, N_RES), gen)
    vt = tac.tile_palmer_group(grp).permute(0, 3, 2, 1)  # (256, 128, F, 3) view
    del grp
    # (name, (nOuter, nInner, F, 3) view, D); bond counts that are not a
    # multiple of the kernel's bonds per block in every layout.
    cases = [("forward chunks (32, 1000, 1024, 3)", vecs.transpose(1, 2), N_DELTAS),
             ("pretiled (256, 3, 1000, 128)", vt, N_DELTAS),
             ("ragged B = 3 x 77, odd F = 1001",
              unit(torch, (3, 1001, 77), gen).transpose(1, 2), 500),
             ("D = 37, F = 1000, B = 3 x 77",
              unit(torch, (3, 1000, 77), gen).transpose(1, 2), 37),
             ("F = 64, B = 2 x 200", unit(torch, (2, 64, 200), gen).transpose(1, 2), 32),
             ("contiguous (300, 257, 3)", unit(torch, (300, 257), gen)[None], 128),
             ("pretiled cut to 2 x 77 lanes, F = 257",
              tac.tile_palmer_group(unit(torch, (2, 257, 100), gen))
              .permute(0, 3, 2, 1)[:, :77], 128),
             ("F = 18000, D = 9000, B = 5",
              unit(torch, (1, 18000, 5), gen).transpose(1, 2), 9000),
             ("slab plan: F = 20000, D = 10000, B = 64 (chunk layout)",
              unit(torch, (1, LONG_F, LONG_BONDS), gen).transpose(1, 2), LONG_F // 2),
             ("slab plan: pretiled cut to 3 lanes, F = 18744",
              tac.tile_palmer_group(unit(torch, (1, 18744, 3), gen))
              .permute(0, 3, 2, 1)[:, :3], 9372)]
    for name, v, D in cases:
        s = cuda_acf.acf_lag_sums(v, D)
        ref = tac.acf_sums_plain(v.double(), D)
        err = c_err(torch, s, ref.reshape(-1, D).T, v.shape[2])
        worst = max(worst, err)
        check(err <= ACF_BOUND, f"A {name}: max C(t) err {err:.3e} <= {ACF_BOUND}")
    del ref, s

    bound, by = acf_bound(N_REP * N_RES, N_FRAMES, N_DELTAS)
    v = vecs.transpose(1, 2)
    flat = v.contiguous()  # (32, 1024, F, 3): contiguous (B, F, 3) bonds
    t = {"bound": bound, "by": by}
    t["chunks"], t["plain"] = paired_ms(torch, lambda: cuda_acf.acf_lag_sums(v, N_DELTAS),
                                        lambda: tac.acf_sums_plain(v, N_DELTAS))
    t["pretiled"] = cuda_ms(torch, lambda: cuda_acf.acf_lag_sums(vt, N_DELTAS))
    t["contiguous"] = cuda_ms(torch, lambda: cuda_acf.acf_lag_sums(flat, N_DELTAS))
    del flat
    print(f"  time A at (32 x 1024 bonds, F 1000, D 500), bound {bound:.4f} ms ({by}); "
          f"plain f32 FFT {t['plain']:.4f} ms; kernel: "
          + ", ".join(f"{k} layout {t[k]:.4f} ms ({bound / t[k]:.1%} of bound)"
                      for k in ("chunks", "pretiled", "contiguous")), flush=True)
    vl = unit(torch, (1, LONG_F, LONG_BONDS), gen).transpose(1, 2)
    t["long_bound"], t["long_by"] = acf_bound(LONG_BONDS, LONG_F, LONG_F // 2)
    t["long"], t["long_plain"] = paired_ms(torch, lambda: cuda_acf.acf_lag_sums(vl, LONG_F // 2),
                                           lambda: tac.acf_sums_plain(vl, LONG_F // 2), reps=3)
    print(f"  time A slab plan at ({LONG_BONDS} bonds, F {LONG_F}, D {LONG_F // 2}): kernel "
          f"{t['long']:.4f} ms, plain f32 FFT {t['long_plain']:.4f} ms, bound "
          f"{t['long_bound']:.4f} ms ({t['long_by']}), {t['long_bound'] / t['long']:.1%} of bound",
          flush=True)
    return worst, t


def lm_operands(torch, gen, K, s2f, B, T):
    """Random p (taus up to T), and y = the model at p plus an offset of
    0.1 to 0.5 of either sign, so no residual is a cancellation below what
    float32 can resolve (its relative error would be unbounded)."""
    def rand(*shape):
        return torch.rand(shape, generator=gen, device="cuda")

    dt = torch.arange(1, T + 1, device="cuda", dtype=torch.float32)
    C, tau = rand(K, B) * 0.39 + 0.01, rand(K, B) * (T - 1) + 1
    S2 = rand(1, B) * 0.6 + 0.2 if s2f else 1.0 - C.sum(0, keepdim=True)
    model = S2 + (C[:, None] * torch.exp(-dt[None, :, None] / tau[:, None])).sum(0)
    y = model + (rand(T, B) * 0.4 + 0.1) * torch.where(rand(T, B) < 0.5, -1.0, 1.0)
    isg = 1.0 / (rand(T, B) * 1.5 + 0.5)
    p = torch.cat([C, tau] + ([S2] if s2f else [])).contiguous()
    return p, y, isg, dt


def phase_lm(torch, cuda_lm, gen):
    print("phase 2: kernels B/C (lm_hgc, lm_cost) vs hgc_plain/cost_plain, float64 "
          "reference", flush=True)
    worst_b = worst_c = 0.0
    cases = [(1, False, 1024, 500), (2, True, 1024, 500), (4, True, 1024, 500),
             (2, True, 1, 1), (3, False, 77, 31), (4, False, 1025, 499),
             (2, True, 10_000, 500), (5, True, 10_000, 500), (8, True, 10_000, 500),
             (6, False, 77, 31), (16, True, 1025, 499)]
    for K, s2f, B, T in cases:
        args = (*lm_operands(torch, gen, K, s2f, B, T), K, s2f)
        got = cuda_lm.hgc_cuda(*args)
        c2 = cuda_lm.cost_cuda(*args)
        tag = f"K={K} s2_free={s2f} B={B} T={T}"
        ref = cuda_lm.hgc_plain(*(a.double() for a in args[:4]), K, s2f)
        for name, a, b in zip(("H", "g", "cost"), got, ref):
            rtol, atol = LM_TOL[name]
            diff = (a.double() - b).abs()
            ok = bool((diff <= atol + rtol * b.abs()).all())
            worst_b = max(worst_b, float(diff.max()))
            check(ok, f"B {tag} {name}: max abs err {float(diff.max()):.3e} "
                      f"(rtol {rtol}, atol {atol})")
        diff = (c2.double() - ref[2]).abs()
        worst_c = max(worst_c, float(diff.max()))
        check(bool((diff <= LM_TOL["cost"][0] * ref[2].abs()).all()),
              f"C {tag} cost: max abs err {float(diff.max()):.3e}")
        again = cuda_lm.hgc_cuda(*args)
        check(torch.equal(got[2], c2) and all(map(torch.equal, got, again))
              and torch.equal(c2, cuda_lm.cost_cuda(*args)),
              f"B/C {tag}: C's cost == B's bit for bit; relaunch bitwise equal")

    times = {}
    for key, (K, s2f, B, T), reps in (("fwd", (2, True, 1024, 500), 50),
                                      ("rung", (4, True, 10_000, 500), 20),
                                      ("k5", (5, True, 10_000, 500), 10),
                                      ("k8", (8, True, 10_000, 500), 10)):
        args = (*lm_operands(torch, gen, K, s2f, B, T), K, s2f)
        t = times[key] = {"shape": f"B {B}, T {T}, K {K}, S2 {'free' if s2f else 'fixed'}"}
        t["B"], t["B_plain"] = paired_ms(
            torch, lambda: cuda_lm.hgc_cuda(*args), lambda: cuda_lm.hgc_plain(*args),
            reps=reps, timer=graph_ms)
        t["C"], t["C_plain"] = paired_ms(
            torch, lambda: cuda_lm.cost_cuda(*args), lambda: cuda_lm.cost_plain(*args),
            reps=reps, timer=graph_ms)
        t["B_bound"], t["B_by"] = lm_bound(K, s2f, B, T, True)
        t["C_bound"], t["C_by"] = lm_bound(K, s2f, B, T, False)
        for k in "BC":
            print(f"  time {k} at {t['shape']}: kernel {t[k] * 1e3:.2f} us (plain "
                  f"{t[k + '_plain'] * 1e3:.2f} us), bound {t[k + '_bound'] * 1e3:.2f} us "
                  f"({t[k + '_by']}), {t[k + '_bound'] / t[k]:.1%} of bound", flush=True)
    return worst_b, worst_c, times


# Kernel D against its plain version: t_new, the trial parameters and the
# three norms within rtol / atol on >= share of lanes (NaN matching NaN).
STEP_TOL = dict(rtol=1e-4, atol=1e-5, share=1.0)


def step_bound(P: int, B: int, gate: bool, improved: int = 0, at_window: int = 0):
    """bound_ms of kernel D (gate False) or E at P parameters and B lanes.
    Bytes: each input read once, each output written once.  D reads H_p's
    lower triangle (all the Cholesky needs; 32-byte sectors make the
    kernel fetch nearly the whole matrix), g_p, t, lam, lo and span, and
    writes t_new, the trial parameters and the three norms.  E (on lanes
    none of which is frozen, as phase_step times it) reads the two costs,
    the three norms, lam, it, c_best, c_mark and done, and t_new and the
    trial parameters on the ``improved`` lanes; it writes lam, it, c_best
    and done, c_mark on the ``at_window`` lanes, t and the next (P, B)
    parameters on the ``improved`` lanes, and live.  Operations (an exp,
    multiply, add, division or square root 1): D's sigmoids, chain rule,
    damped matrix, Cholesky and substitutions as csrc/lm_step.cu does
    them; E's 11 a lane."""
    if gate:
        n_bytes = B * (4 * 9 + 1 + 4 * 3 + 1) + improved * 4 * 4 * P + at_window * 4 + 1
        return bound_ms(n_bytes, 11 * B)
    tri = P * (P + 1) // 2
    flops = 8 * P + 2 * tri + 8 * P + (tri - P) + P  # sigmoids, D, ||t||; A; g
    flops += sum(2 * j + 2 + (P - 1 - j) * (2 * j + 1) for j in range(P))  # Cholesky
    flops += 2 * sum(2 * i + 1 for i in range(P))  # the two substitutions
    flops += 9 * P + 2  # step, t_new, trial parameters, norms
    n_bytes = 4 * B * (tri + 2 * P + 1) + 8 * P + 4 * B * (2 * P + 3) + 1
    return bound_ms(n_bytes, flops * B)


def not_pd_lanes(B: int):
    """The lanes whose H_p step_state negates, so their damped matrix is
    not positive definite: the second, one at a third and the last but
    one."""
    return sorted({min(1, B - 1), B // 3, max(B - 2, 0)})


def step_state(torch, cuda_lm, gen, K, s2f, B, T, not_pd=True):
    """Kernels D and E's inputs on the card around kernel B's outputs at
    lm_operands' parameters: (solve arguments, gate inputs, state, pt,
    gates, not-positive-definite lane mask).  H_p negated on not_pd_lanes
    if ``not_pd`` (the checks; not the timings: a NaN operand sends IEEE
    division and square root down their slow path, which an LM's
    positive-definite steps do not take); lam log-uniform in [1e-6, 1] for D; for E lam from 1e-13 to 1e7 (lam0
    on a fifth of the lanes), every phase of the stall window, c_best /
    c_mark at and around c_old, a fifth of the lanes done."""
    from spinrelax_tpu_torch.fit import engine
    from spinrelax_tpu_torch.fit.lm import _to_constrained, _to_unconstrained

    def rand(*shape):
        return torch.rand(shape, generator=gen, device="cuda")

    def pick(choices, n):
        c = torch.tensor(choices, device="cuda")
        return c[torch.randint(len(choices), (n,), generator=gen, device="cuda")]

    p, y, isg, dt = lm_operands(torch, gen, K, s2f, B, T)
    lo, hi = engine._bounds(K, s2f, dt[-1] * 10.0, torch.float32, "cuda")
    t = _to_unconstrained(p.T, lo, hi).contiguous()
    pt = _to_constrained(t, lo, hi).T.contiguous()
    H_p, g_p, c_old = cuda_lm.hgc_cuda(pt, y, isg, dt, K, s2f)
    npd = torch.zeros(B, dtype=torch.bool, device="cuda")
    npd[not_pd_lanes(B) if not_pd else []] = True
    H_p[npd] = -H_p[npd]
    solve = (H_p, g_p, t, 10.0 ** (rand(B) * 6.0 - 6.0), lo, hi - lo)
    live = torch.ones((), dtype=torch.bool, device="cuda")
    t_new, pt_trial, stats = cuda_lm.step_solve_cuda(*solve, live)
    c_new = cuda_lm.cost_cuda(pt_trial, y, isg, dt, K, s2f)
    lam = 10.0 ** (rand(B) * 20.0 - 13.0)
    lam = torch.where(rand(B) < 0.2, 1e-3, lam)
    c_best = c_old * pick([1.0, 1.0 + 1e-4, float("inf")], B)
    c_mark = c_best * pick([1.0, 1.0 + 3e-7, 1.1, float("inf")], B)
    state = (t.clone(), lam, (rand(B) * 60).int(), c_best, c_mark, rand(B) < 0.2, live)
    eps = torch.finfo(torch.float32).eps
    gates = cuda_lm.Gates(max_iter=60, window=8, xtol=1e-10, ftol=10.0 * eps,
                          xtol_rel=math.sqrt(eps), lam0=1e-3, lam_stuck=1e6)
    return solve, (c_new, c_old, t_new, pt_trial, stats), state, pt.clone(), gates, npd


# D's share of positive-definite lanes whose t_new equals the plain
# version's bit for bit may not fall below the one-thread-a-lane kernel's
# on the same cases (1.0 in every run of it).
STEP_BITS = 1.0
# Phase 2's lane-group edges: P = 8, 9, 16, 17, 32, 33 (K 4, 8, 16, S2
# fixed or free) at B = 1, 7, 1025, none a multiple of a block's lanes.
STEP_EDGES = [(K, s2f, B, 64) for K in (4, 8, 16) for s2f in (False, True)
              for B in (1, 7, 1025)]


def damped(torch, H_p, g_p, t, lam, lo, span):
    """Kernel D's damped matrix A (B, P, P) and right-hand side g (B, P),
    as step_solve_plain forms them: what D's Cholesky solve takes."""
    s = 1.0 / (1.0 + torch.exp(-t))
    D = span * s * (1.0 - s)
    H = H_p * D[:, :, None] * D[:, None, :]
    eye = torch.eye(t.shape[1], dtype=t.dtype, device=t.device)
    diag = torch.clamp(torch.diagonal(H, dim1=1, dim2=2), min=1e-12)
    return H + lam[:, None, None] * eye * diag[:, None, :] * eye, g_p * D


def profiled_us(torch, fn, key: str, reps: int) -> float:
    """Kernel ``key``'s device time per launch as torch.profiler reads it
    (CUPTI's kernel records), over a CUDA graph of reps launches of fn:
    the measure of the in-situ times of phases 3, 5 and 6, on the launches
    graph_ms times with CUDA events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    _, per = device_profile(torch, graph.replay,
                            lambda per: kernel_times(per).get(key, (0,))[0] == reps, cpu=False)
    n, us = kernel_times(per).get(key, (0, float("nan")))
    check(n == reps, f"profiler saw {n} of {reps} graph launches of kernel {key}")
    return us


def timed_step_state(torch, cuda_lm, gen, K, s2f, B, T):
    """step_state's inputs for timing kernels D and E (no lane that is not
    positive definite), with E on a state it never freezes (every lane
    improves, copies its row and column, and stays live): the same work
    every launch.  -> (solve arguments, gate inputs, state, pt, gates)."""
    solve, ins, state, pt, gates, _ = step_state(torch, cuda_lm, gen, K, s2f, B, T,
                                                 not_pd=False)
    c_new, c_old, t_new, pt_trial, stats = ins
    ins = (0.5 * c_old, c_old, t_new, pt_trial, torch.ones_like(stats))
    live = torch.ones((), dtype=torch.bool, device="cuda")
    st = (state[0], torch.zeros_like(state[1]), state[2], state[3],
          torch.full_like(state[4], float("inf")), torch.zeros_like(state[5]), live)
    return solve, ins, st, pt, gates._replace(max_iter=2**31 - 1)


def phase_step(torch, cuda_lm, times):
    """Phase 2's second half: kernels D and E against their plain versions
    from the same state, and their times in ``times``.  Its own generator,
    so the later phases' random inputs do not depend on this phase."""
    print("phase 2 (D, E): kernels D/E (lm_step_solve, lm_step_gate) vs "
          "step_solve_plain/step_gate_plain on the same state", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(20261017)
    worst_d = 0.0
    # Every (B, P) at which the forward, the ladder and the finish launch D
    # and E: (1024, 5), (1024, 2), (1024, 3), (10 000, 2), (10 000, 3),
    # (9400, 5), (9176, 7), (1433, 7), (1147, 7), (520, 2), and P 4 at B
    # 1433; the escalation's (8, 9) and (1, 9) as STEP_EDGES' (7, 9), (1, 9).
    cases = [(2, True, 1024, 500), (1, False, 1024, 500), (1, True, 1024, 500),
             (1, False, 10_000, 500), (1, True, 10_000, 500), (2, True, 9400, 500),
             (3, True, 9176, 500), (3, True, 1433, 500), (3, True, 1147, 500),
             (1, False, 520, 500), (2, False, 1433, 500), (4, True, 10_000, 500),
             (3, False, 10_000, 500), (5, True, 10_000, 500), (8, True, 10_000, 500),
             (16, True, 1025, 499)]
    bits = []
    for K, s2f, B, T in cases + STEP_EDGES:
        edge = (K, s2f, B, T) in STEP_EDGES
        tag = f"K={K} s2_free={s2f} (P {cuda_lm.n_par(K, s2f)}) B={B}"
        solve, ins, state, pt, gates, npd = step_state(torch, cuda_lm, gen, K, s2f, B, T)
        live = torch.ones((), dtype=torch.bool, device="cuda")
        got = cuda_lm.step_solve_cuda(*solve, live)
        again = cuda_lm.step_solve_cuda(*solve, live)
        plain = cuda_lm.step_solve_plain(*solve, torch.ones_like(live))
        ref = cuda_lm.step_solve_plain(*(a.double() for a in solve), torch.ones_like(live))
        shares = []
        for name, a, b in zip(("t_new", "pt_trial", "stats"), got, plain):
            a, b = a.double(), b.double()
            near = ((a - b).abs() <= STEP_TOL["atol"] + STEP_TOL["rtol"] * b.abs()) | (
                a.isnan() & b.isnan())
            shares.append(share_of(near.all(dim=1 if name == "t_new" else 0)))
        fin = (torch.isfinite(got[0]).all(1) & torch.isfinite(plain[0]).all(1)
               & torch.isfinite(ref[0]).all(1))
        err_k = float((got[0].double() - ref[0]).abs().amax(1)[fin].mean()) if fin.any() else 0.0
        err_p = float((plain[0].double() - ref[0]).abs().amax(1)[fin].mean()) if fin.any() else 0.0
        diff = (got[0].double() - plain[0].double()).abs()[fin]
        worst_d = max(worst_d, float(diff.max()) if fin.any() else 0.0)
        same = share_of((got[0] == plain[0]).all(1))
        same_pd = (got[0] == plain[0]).all(1)[~npd]
        bits.append((int(same_pd.sum()), int(same_pd.numel())))
        nan_k, nan_p = got[0].isnan().any(1), plain[0].isnan().any(1)
        check(torch.equal(nan_k, npd) and torch.equal(nan_p, npd),
              f"D {tag}: t_new NaN on exactly the {int(npd.sum())} lanes whose damped "
              f"matrix is not positive definite (kernel {int(nan_k.sum())}, plain "
              f"{int(nan_p.sum())} NaN lanes)")
        check(min(shares) >= STEP_TOL["share"] and not bool(live),
              f"D {tag}: t_new / trial parameters / norms within rtol {STEP_TOL['rtol']} atol "
              f"{STEP_TOL['atol']} of plain on {shares[0]:.5f} / {shares[1]:.5f} / "
              f"{shares[2]:.5f} of lanes (>= {STEP_TOL['share']}); t_new bit for bit on "
              f"{same:.4f}; live cleared")
        share_pd = share_of(same_pd) if same_pd.numel() else 1.0
        check(share_pd >= STEP_BITS,
              f"D {tag}: t_new bit for bit on {share_pd:.4f} of the {same_pd.numel()} "
              f"positive-definite lanes (>= {STEP_BITS})")
        if edge:  # few lanes, three of them (or all) not positive definite
            check(torch.equal(fin, ~npd) and err_k <= 2 * err_p + 1e-12,
                  f"D {tag}: finite in kernel, plain and float64 on exactly the "
                  f"{int((~npd).sum())} positive-definite lanes; mean |t_new - f64 solve| "
                  f"{err_k:.3e} <= 2 x plain f32's {err_p:.3e}")
        else:
            check(err_k <= 2 * err_p + 1e-12 and share_of(fin) >= 0.99,
                  f"D {tag}: mean |t_new - f64 solve| {err_k:.3e} <= 2 x plain f32's "
                  f"{err_p:.3e} ({share_of(fin):.4f} of lanes finite in all three)")
        check(all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                  for a, b in zip(got, again)), f"D {tag}: relaunch bitwise equal")
        outs = []
        for gate in (cuda_lm.step_gate_cuda, cuda_lm.step_gate_cuda, cuda_lm.step_gate_plain):
            st, p = tuple(x.clone() for x in state), pt.clone()
            st[-1].zero_()  # kernel D's part
            gate(*ins, st, p, gates)
            outs.append(st + (p,))
        check(all(same_bits(torch, a, b) for a, b in zip(outs[0], outs[2]))
              and all(same_bits(torch, a, b) for a, b in zip(outs[0], outs[1])),
              f"E {tag}: state, next parameters and live equal the plain version's bit for "
              f"bit; relaunch bitwise equal")
    n_same, n_pd = map(sum, zip(*bits))
    print(f"  D: t_new bit for bit on {n_same} of {n_pd} positive-definite lanes "
          f"({n_same / n_pd:.6f}) over {len(bits)} cases, P "
          f"{sorted({cuda_lm.n_par(K, s2f) for K, s2f, _, _ in cases + STEP_EDGES})}",
          flush=True)

    # 50 launches a graph at every shape: a replay's start (~20 us on an
    # H100) spread over 10 launches added ~2 us to each few-us launch.
    for key, (K, s2f, B, T) in (("fwd", (2, True, 1024, 500)), ("rung", (4, True, 10_000, 500)),
                                ("k5", (5, True, 10_000, 500)), ("k8", (8, True, 10_000, 500))):
        reps = 50
        solve, ins, st, pt, gates = timed_step_state(torch, cuda_lm, gen, K, s2f, B, T)
        live = st[-1]
        t = times[key]

        def solve_d():
            return cuda_lm.step_solve_cuda(*solve, live)

        def gate_e():
            return cuda_lm.step_gate_cuda(*ins, st, pt, gates)

        t["D"], t["D_plain"] = paired_ms(
            torch, solve_d, lambda: cuda_lm.step_solve_plain(*solve, live), reps=reps,
            timer=graph_ms)
        t["E"], t["E_plain"] = paired_ms(
            torch, gate_e, lambda: cuda_lm.step_gate_plain(*ins, st, pt, gates), reps=reps,
            timer=graph_ms)
        # The same launches as torch.profiler reads them (the in-situ times'
        # measure), and the damped solve alone by torch.linalg (a yardstick:
        # never called on the path).
        t["D_prof_us"] = profiled_us(torch, solve_d, "D", reps)
        t["E_prof_us"] = profiled_us(torch, gate_e, "E", reps)
        A, g = damped(torch, *solve)

        def chol_solve():
            L_, _ = torch.linalg.cholesky_ex(A)
            return torch.cholesky_solve(g[:, :, None], L_)

        # Eager calls: magma's batched Cholesky solve cannot be captured in
        # a CUDA graph (seen on an H100).
        t["D_solve_library"] = cuda_ms(torch, chol_solve, reps)
        P = cuda_lm.n_par(K, s2f)
        t["D_bound"], t["D_by"] = step_bound(P, B, False)
        t["E_bound"], t["E_by"] = step_bound(
            P, B, True, improved=B, at_window=int(((st[2] + 1) % gates.window == 0).sum()))
        for k in "DE":
            print(f"  time {k} at {t['shape']}: kernel {t[k] * 1e3:.2f} us (plain "
                  f"{t[k + '_plain'] * 1e3:.2f} us), bound {t[k + '_bound'] * 1e3:.3f} us "
                  f"({t[k + '_by']}), {t[k + '_bound'] / t[k]:.1%} of bound; the profiler "
                  f"reads {t[k + '_prof_us']:.2f} us a launch", flush=True)
        print(f"  time of the damped solve alone at {t['shape']}: torch.linalg.cholesky_ex + "
              f"cholesky_solve {t['D_solve_library'] * 1e3:.2f} us (eager calls)", flush=True)
    return worst_d


def rel_gap(a, b):
    return (a - b).abs() / b.abs().clamp_min(1e-30)


def device_profile(torch, fn, complete=bool, cpu=True):
    """Run fn once under torch.profiler -> (device-busy ms: the union of
    the card's kernel and copy intervals, {kernel: (launches, total ms)}).

    The profiler now and then loses device events (seen on an H100: the
    first kernel of a cycle, and once a whole cycle), so fn is profiled
    again, at most three times in all, until ``complete(per)`` holds; by
    default that some device event was seen.  ``cpu=False`` records the
    card's activity only (far less overhead on a run of many small
    launches)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if cpu else [ProfilerActivity.CUDA]
    for _ in range(3):
        with profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        busy, per = device_busy(prof)
        if complete(per):
            break
    return busy, per


def device_busy(prof):
    """(device-busy ms: the union of the card's kernel and copy intervals,
    {kernel: (launches, total ms)}) of a finished torch.profiler run, read
    from the profiler's raw events (building its event tree costs
    minutes for a run of 10^5-10^6 launches)."""
    from torch.autograd import DeviceType

    spans = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            lo = e.start_ns() / 1e3
            spans.append((lo, lo + e.duration_ns() / 1e3, e.name()))
    spans.sort()
    busy, reach, per = 0.0, float("-inf"), {}
    for lo, hi, name in spans:
        busy += max(0.0, hi - max(lo, reach))
        reach = max(reach, hi)
        n, tot = per.get(name, (0, 0.0))
        per[name] = (n + 1, tot + (hi - lo) / 1e3)
    return busy / 1e3, per


def saw(per, **counts) -> bool:
    """True if device_profile's table holds kernels A .. E exactly
    ``counts`` times, e.g. saw(per, A=2)."""
    kt = kernel_times(per)
    return all(kt.get(k, (0,))[0] == n for k, n in counts.items())


@contextlib.contextmanager
def eager_loop(engine, lm=None):
    """Inside, every LM of the port (the engine's and, given ``lm``, the
    generic ``lm.lm_solve``) runs its steps one by one from the host (their
    test-only ``_eager``) instead of replaying a CUDA graph: the loop the
    graph loop is held to, bit for bit, and timed against."""
    saved = [(engine, "fit_multiexp_engine")] + ([(lm, "lm_solve")] if lm else [])
    graph_fns = [getattr(m, name) for m, name in saved]
    for (m, name), fn in zip(saved, graph_fns):
        setattr(m, name, functools.partial(fn, _eager=True))
    try:
        yield
    finally:
        for (m, name), fn in zip(saved, graph_fns):
            setattr(m, name, fn)


def share_of(mask) -> float:
    """The share of True in a boolean tensor, exactly 1.0 when all are
    (a float mean of ones is 0.9999999999999999 at some lengths, 1433 for
    one)."""
    return int(mask.sum()) / mask.numel()


def same_bits(torch, a, b) -> bool:
    """Tensors equal bit for bit, NaN equal to NaN."""
    return a.dtype == b.dtype and torch.equal(torch.nan_to_num(a.double(), nan=-7.0),
                                              torch.nan_to_num(b.double(), nan=-7.0))


def kernel_of(name: str):
    """'A' .. 'E' or None for a profiled kernel name: acf_lag_sums_kernel
    and acf_lag_sums_slab_kernel are A; lm_kernel<K, s2_free, FULL> and
    lm_kernel_wide<FULL> are B with FULL true, else C;
    lm_step_solve_kernel<P, G> (a group of G threads a lane) is D,
    lm_step_gate_kernel<P> E."""
    if "acf_lag_sums" in name:
        return "A"
    if "lm_step_solve" in name:
        return "D"
    if "lm_step_gate" in name:
        return "E"
    m = re.search(r"lm_kernel(?:_wide)?<([^>]*)>", name)
    if m is None:
        return None
    return "B" if m.group(1).split(",")[-1].strip() == "true" else "C"


def kernel_times(per, kernel_of=kernel_of):
    """{'A' .. 'E': (launches, us per launch)} from device_profile's
    table."""
    out = {}
    for name, (n, ms) in per.items():
        key = kernel_of(name)
        if key:
            m, tot = out.get(key, (0, 0.0))
            out[key] = (m + n, tot + ms)
    return {k: (n, tot * 1e3 / n) for k, (n, tot) in out.items()}


def phase_forward(torch, tac, counters, engine, make_forward, fit_multiexp, vecs):
    print("phase 3: full-width forward (32 x 1000 x 1024, f32) on the card vs the "
          "port on the CPU in f64 and f32", flush=True)
    fwd = make_forward(tau_iso=4242.0, delta_t=1.0, n_components=2)
    for c in counters:
        c.launches = 0
    gpu, secs = wall_s(torch, lambda: fwd(vecs))
    launches = [c.launches for c in counters]
    print(f"  forward wall {secs:.3f} s (first call); launches A/B/C/D/E {launches}",
          flush=True)
    # The graph loop (one captured LM step, replayed) against the eager
    # loop (every step issued by the host), in turns in this process: the
    # median wall of 5 calls each, one profiled call each, outputs equal
    # bit for bit.
    def walls_of():
        w = sorted(wall_s(torch, lambda: fwd(vecs))[1] for _ in range(5))
        print(f"    wall median {w[2] * 1e3:.2f} ms over 5 calls (min {w[0] * 1e3:.2f}, "
              f"max {w[-1] * 1e3:.2f})", flush=True)
        return w[2]

    def profile_of(secs):
        def run():
            for c in counters:
                c.launches = 0
            fwd(vecs)

        busy, per = device_profile(torch, run, lambda per: saw(
            per, **{k: c.launches for c, k in zip(counters, "ABCDE")}))
        per_kernel = kernel_times(per)
        print(f"    profiled: {sum(n for n, _ in per.values())} device kernels and copies, "
              f"device busy {busy:.2f} ms, idle share {1 - busy / (secs * 1e3):.1%} of the "
              f"median wall; " + "; ".join(f"kernel {k} {n} launches, {us:.2f} us each"
                                           for k, (n, us) in sorted(per_kernel.items())),
              flush=True)
        return busy, per_kernel

    print("  graph loop:", flush=True)
    secs2 = walls_of()
    busy, per_kernel = profile_of(secs2)
    for c, k in zip(counters, "ABCDE"):
        check(per_kernel.get(k, (0,))[0] == c.launches,
              f"profiler saw kernel {k} {per_kernel.get(k, (0,))[0]} times = the wrapper's "
              f"count {c.launches} (the steps run)")
    print("  eager loop:", flush=True)
    with eager_loop(engine):
        eager = fwd(vecs)
        secs_e = walls_of()
        busy_e, _ = profile_of(secs_e)
    check(all(same_bits(torch, a, b) for a, b in zip(gpu, eager)),
          "forward outputs of the graph loop equal the eager loop's bit for bit")
    print(f"  forward: graph loop {secs2 * 1e3:.2f} ms wall, {busy:.2f} ms busy; eager loop "
          f"{secs_e * 1e3:.2f} ms wall, {busy_e:.2f} ms busy", flush=True)
    t0 = time.perf_counter()
    cpu = fwd(vecs.cpu().double())
    print(f"  CPU float64 forward {time.perf_counter() - t0:.1f} s", flush=True)
    for c, n in zip(counters, launches):
        check(n > 0, f"{c.__name__} launched {n} times on the main path")
    g = {k: v.double().cpu() for k, v in gpu._asdict().items()}
    for k, v in g.items():
        check(bool(torch.isfinite(v).all()), f"forward {k} {tuple(v.shape)} finite")
    err = float((g["Ct"] - cpu.Ct).abs().max())
    check(err <= 2e-6, f"Ct max abs vs CPU f64 {err:.3e} <= 2e-6")
    for k in ("R1", "R2", "NOE", "rho"):
        med = float(rel_gap(g[k], getattr(cpu, k)).median())
        check(med < 1e-4, f"{k} median relative gap {med:.3e} < 1e-4")

    # The forward's fit again, for its chisq and quality flags: on the card,
    # and on the CPU in float32 (same engine and gates, plain kernels) and
    # float64.  The float32 LM gates (ftol = 10 ulp, stall window) stop some
    # lanes of this input >1 % above the float64 optimum -- the JAX engine
    # does the same -- so test_engine's 95 %-within-1e-2 criterion is held
    # against the float32 run, and against float64 the card must reach the
    # optimum on as many lanes as the CPU float32 run does (within 2 %).
    def fit_of(Ct, dCt):
        dt = torch.arange(Ct.shape[0], dtype=Ct.dtype, device=Ct.device) + 1.0
        sigma = torch.where(dCt.T > 0, dCt.T, torch.ones_like(dCt.T))
        return fit_multiexp(dt, Ct.T.contiguous(), sigma, K=2, s2_free=True)

    fg = fit_of(gpu.Ct, gpu.dCt)
    t0 = time.perf_counter()
    c32 = fwd(vecs.cpu())
    f32, f64 = fit_of(c32.Ct, c32.dCt), fit_of(cpu.Ct, cpu.dCt)
    print(f"  CPU float32 forward + fit {time.perf_counter() - t0:.1f} s", flush=True)
    cg = fg.chisq.double().cpu()
    rel = rel_gap(cg, f32.chisq.double())
    check(float(rel.median()) < 1e-4,
          f"chisq median relative gap vs CPU f32 {float(rel.median()):.3e} < 1e-4")
    share = float((rel < 1e-2).double().mean())
    check(share >= 0.95, f"chisq within 1e-2 of CPU f32 on {share:.4f} of lanes (>= 0.95)")
    okg = (fg.ok_fit & fg.ok_err & fg.ok_sum).cpu()
    for name, ref in (("f32", f32), ("f64", f64)):
        agree = float((okg == (ref.ok_fit & ref.ok_err & ref.ok_sum)).double().mean())
        check(agree >= 0.95, f"quality flags agree with CPU {name} on {agree:.4f} (>= 0.95)")
    rel64 = rel_gap(cg, f64.chisq)
    check(float(rel64.median()) < 1e-4,
          f"chisq median relative gap vs CPU f64 {float(rel64.median()):.3e} < 1e-4")
    share64 = float((rel64 < 1e-2).double().mean())
    share32 = float((rel_gap(f32.chisq.double(), f64.chisq) < 1e-2).double().mean())
    check(share64 >= share32 - 0.02,
          f"chisq within 1e-2 of CPU f64 on {share64:.4f} of lanes (CPU f32 engine: "
          f"{share32:.4f}; card >1 % worse on "
          f"{float((cg > 1.01 * f64.chisq).double().mean()):.4f})")

    Ct_t = wall_s(torch, lambda: tac.ct_palmer(vecs))[1]
    fit_t = wall_s(torch, lambda: fit_of(gpu.Ct, gpu.dCt))[1]
    print(f"  breakdown: ct_palmer {Ct_t * 1e3:.2f} ms, fit {fit_t * 1e3:.2f} ms, "
          f"whole forward {secs2 * 1e3:.2f} ms", flush=True)
    return launches, secs2, busy, secs_e, busy_e


def phase_stream(torch, tac, cuda_acf, vecs, gen):
    print("phase 4: 10 streamed pretiled group steps + pooled finish vs a float64 "
          "plain route on the card", flush=True)
    n_groups = 10
    # Each residue's bond wobbles around its own axis (S2 > 0, as in a
    # folded protein): the forward's walk, rolled over residues per group.
    axis = unit(torch, (1, 1, N_RES), gen)
    acc = (torch.zeros((N_DELTAS, N_RES), device="cuda"),) * 2
    ref = (torch.zeros((N_DELTAS, N_RES), device="cuda", dtype=torch.float64),) * 2
    n_vals = N_FRAMES - torch.arange(1, N_DELTAS + 1, device="cuda", dtype=torch.float64)
    b = N_REP * N_RES
    cuda_acf.acf_lag_sums.launches = 0
    step_ms = []
    for g in range(n_groups):
        grp = torch.nn.functional.normalize(axis + 0.6 * vecs.roll(g, dims=2), dim=-1)
        vt = tac.tile_palmer_group(grp)
        del grp
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        acc = tac.palmer_group_update_pretiled(vt, *acc, N_REP, N_RES)
        end.record()
        v = vt.permute(0, 3, 2, 1).double().reshape(-1, N_FRAMES, 3)[:b]
        s = tac.acf_sums_plain(v, N_DELTAS).T  # (D, B)
        e = (-1.5 + 1.5 * s / n_vals[:, None]).reshape(N_DELTAS, N_REP, N_RES)
        ref = (ref[0] + e.sum(1), ref[1] + (e**2).sum(1))
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
    launches = cuda_acf.acf_lag_sums.launches
    check(launches == n_groups, f"streamed step launched kernel A {launches} times")
    mean, dct = tac.palmer_pooled_stats(*acc, n_groups * N_REP)
    rmean, rdct = tac.palmer_pooled_stats(*ref, n_groups * N_REP)
    err = float((mean.double() - rmean).abs().max())
    check(err <= 2e-6, f"pooled C(t) max abs err {err:.3e} <= 2e-6")
    # dC(t) from float32 shifted accumulators: at decorrelated lags the
    # per-chunk variance is ~1e-3 of E[e^2] ~ 1, so float32 rounding of the
    # running sums alone costs ~1e-3 relative (palmer_pooled_stats notes).
    rel = float(rel_gap(dct.double(), rdct).max())
    check(rel <= 5e-3, f"pooled dC(t) max relative err {rel:.3e} <= 5e-3")
    check(bool(torch.isfinite(mean).all() & torch.isfinite(dct).all()), "pooled stats finite")
    med = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
    print(f"  group step (kernel A + statistics) median {med:.4f} ms over "
          f"{n_groups - 1} steps; {N_REP * N_FRAMES * N_RES / (med * 1e-3):.4e} "
          f"frames*vectors/s", flush=True)
    return med, acc, n_groups * N_REP, axis, rmean


def step_counts(launches) -> dict:
    """saw()'s counts of kernels B, C, D and E from the counters' list."""
    return dict(zip("BCDE", launches[1:5]))


def lm_steps_ok(launches) -> bool:
    """Kernels B, C, D and E launched, equally often (one each a step of
    fit.engine)."""
    return launches[1] > 0 and len(set(launches[1:5])) == 1


def rung_of(cts):
    """Selected rung of each row as (number of components, S2 free)."""
    return cts.mask.sum(1).cpu() * 2 + cts.s2fast.cpu()


def phase_ladder(torch, counters, engine, hetero_cohort, fit_ct_ladder):
    print(f"phase 5: DoF ladder (B {LADDER_B} x T {LADDER_T}, f32, weighted, warm retry, "
          f"8-start escalation) on the card", flush=True)
    dt, y, dy = hetero_cohort(LADDER_B, LADDER_T)
    names = [str(i) for i in range(LADDER_B)]
    yc = torch.tensor(y, dtype=torch.float32, device="cuda")
    dyc = torch.tensor(dy, dtype=torch.float32, device="cuda")

    def run(n=LADDER_B, trace=None):
        return fit_ct_ladder(names[:n], dt, yc[:n], dyc[:n], trace=trace)

    run()  # warm-up (allocator, kernel library)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    walls = sorted(wall_s(torch, run)[1] for _ in range(3))
    torch.cuda.synchronize()
    print(f"  device memory allocated before / after 3 ladders {mem0 / 1e6:.1f} / "
          f"{torch.cuda.memory_allocated() / 1e6:.1f} MB, peak "
          f"{torch.cuda.max_memory_allocated() / 1e6:.1f} MB", flush=True)
    check(torch.cuda.memory_allocated() <= mem0,
          "the ladder's 10 LM calls keep no graph pool after they return")
    # One more call with its LM calls traced: rows, starts and the launches
    # of kernels B to E each made (their counters, read around it).
    calls = []
    for c in counters:
        c.launches = 0
    cts = run(trace=calls)
    torch.cuda.synchronize()
    launches = [c.launches for c in counters]
    for c in calls:
        print(f"  LM call {c['stage']} K={c['K']} S2 {'free' if c['s2_free'] else 'fixed'}, "
              f"{c['starts']} start(s): {c['rows']} rows, slowest lane {c['iterations']} "
              f"iterations, {c['steps']} steps run, kernels B/C/D/E "
              + "/".join(str(c["launches_" + k]) for k in "BCDE") + " launches", flush=True)
    check(lm_steps_ok(launches),
          f"ladder launched kernels B/C/D/E {launches[1:]} times, equally (A {launches[0]})")
    check(all(sum(c["launches_" + k] for c in calls) == n for k, n in zip("BCDE", launches[1:])),
          "every launch of B, C, D and E on the ladder came from a traced LM call")
    check(all(c["launches_B"] == c["launches_C"] == c["launches_D"] == c["launches_E"]
              == c["steps"] >= c["iterations"] and c["steps"] - c["iterations"] < 8
              for c in calls),
          "each LM call launched B, C, D and E once per step, and overshot its slowest lane "
          "by less than a stall window")
    ok = all(bool(torch.isfinite(getattr(cts, f)).all()) for f in ("S2", "C", "tau", "chisq"))
    check(ok and bool((cts.mask.sum(1) >= 1).all()), "ladder model finite, >= 1 component a row")
    busy, per = device_profile(torch, run, lambda per: saw(per, **step_counts(launches)))
    kt = kernel_times(per)
    seen = [kt.get(k, (0,))[0] for k in "BCDE"]
    check(seen == launches[1:], f"profiler saw kernels B/C/D/E {seen} times = the steps run")
    print(f"  graph loop: ladder wall median {walls[1]:.3f} s over 3 calls (min {walls[0]:.3f}, "
          f"max {walls[2]:.3f}); profiled call: device busy {busy:.2f} ms, idle share "
          f"{1 - busy / (walls[1] * 1e3):.1%} of the median wall; "
          + "; ".join(f"kernel {k} {n} launches, {us:.2f} us each"
                      for k, (n, us) in sorted(kt.items())), flush=True)
    with eager_loop(engine):
        eager, first = wall_s(torch, run)
        walls_e = sorted([first, wall_s(torch, run)[1], wall_s(torch, run)[1]])
        busy_e, per_e = device_profile(torch, run)
    check(all(same_bits(torch, getattr(cts, f), getattr(eager, f))
              for f in ("S2", "C", "tau", "chisq", "mask", "s2fast")),
          "the ladder's model from the graph loop equals the eager loop's bit for bit")
    print(f"  eager loop: ladder wall median {walls_e[1]:.3f} s over 3 calls (min "
          f"{walls_e[0]:.3f}, max {walls_e[2]:.3f}); profiled call: "
          f"{sum(n for n, _ in per_e.values())} device kernels and copies (graph loop: "
          f"{sum(n for n, _ in per.values())}), device busy {busy_e:.2f} ms, idle share "
          f"{1 - busy_e / (walls_e[1] * 1e3):.1%}", flush=True)
    # The rung selected on the card against the port's CPU ladders, on the
    # first SUBSET rows (all three run on the same subset).
    t0 = time.perf_counter()
    card = rung_of(run(SUBSET))
    cpu32 = rung_of(fit_ct_ladder(names[:SUBSET], dt,
                                  *(torch.tensor(a[:SUBSET], dtype=torch.float32)
                                    for a in (y, dy))))
    cpu64 = rung_of(fit_ct_ladder(names[:SUBSET], dt, y[:SUBSET], dy[:SUBSET], device="cpu"))
    share32 = float((card == cpu32).double().mean())
    share64 = float((card == cpu64).double().mean())
    check(share32 >= 0.98, f"rung equal to the CPU float32 ladder's on {share32:.4f} of "
                           f"{SUBSET} rows (>= 0.98)")
    print(f"  rung equal to the CPU float64 ladder's on {share64:.4f} of {SUBSET} rows "
          f"(CPU float32 vs float64: {float((cpu32 == cpu64).double().mean()):.4f}); "
          f"subset ladders {time.perf_counter() - t0:.1f} s", flush=True)
    return dict(wall=walls[1], launches=launches, busy=busy, kernels=kt,
                share32=share32, share64=share64, wall_eager=walls_e[1], busy_eager=busy_e)


def curve_gap(torch, a, b, dt) -> float:
    """Max abs gap between two CtModelSets' fitted C(t) on the lags dt."""
    return float((a.eval(dt).double().cpu() - b.eval(dt).double().cpu()).abs().max())


def phase_ladder_5b(torch, counters, engine, lm, hetero_cohort, fit_ct_ladder):
    """Phase 5b: the varpro ladder and the stacked ladder at phase 5's width
    (fit.lm.lm_solve; varpro's warm retries on kernels B and C), then
    spectral_density's seven models and a legacy fit, card against CPU."""
    print(f"phase 5b: varpro and stacked ladders (B {LADDER_B} x T {LADDER_T}, f32, weighted) "
          f"on the card", flush=True)
    import numpy as np

    dt, y, dy = hetero_cohort(LADDER_B, LADDER_T)
    names = [str(i) for i in range(LADDER_B)]
    yc = torch.tensor(y, dtype=torch.float32, device="cuda")
    dyc = torch.tensor(dy, dtype=torch.float32, device="cuda")
    out = {}
    for kind, kw in (("varpro", dict(optimiser="varpro")), ("stacked", dict(stacked=True))):
        def run(n=LADDER_B, trace=None, kw=kw):
            return fit_ct_ladder(names[:n], dt, yc[:n], dyc[:n], trace=trace, **kw)

        run()  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        walls = sorted(wall_s(torch, run)[1] for _ in range(3))
        peak = torch.cuda.max_memory_allocated()
        mem1 = torch.cuda.memory_allocated()
        check(mem1 <= mem0, f"{kind}: the ladder keeps no graph pool after it returns "
                            f"(allocated {mem0 / 1e6:.1f} MB before, {mem1 / 1e6:.1f} MB after)")
        calls = []
        for c in counters:
            c.launches = 0
        cts = run(trace=calls)
        torch.cuda.synchronize()
        launches = [c.launches for c in counters]
        for c in calls:
            print(f"  {kind} LM call {c['stage']} K={c['K']} S2 {c['s2_free']}: {c['rows']} rows, "
                  f"slowest lane {c['iterations']} iterations, {c['steps']} steps run, kernels "
                  f"B/C/D/E " + "/".join(str(c["launches_" + k]) for k in "BCDE")
                  + " launches", flush=True)
        warm = [c for c in calls if c["stage"] == "warm"]
        bc = [sum(c["launches_" + k] for c in warm) for k in "BCDE"]
        if kind == "varpro":
            check(len(warm) > 0 and bc == launches[1:] and lm_steps_ok(launches)
                  and bc[0] == sum(c["steps"] for c in warm),
                  f"varpro: kernels B/C/D/E launched {launches[1:]} times, all by its "
                  f"{len(warm)} warm retries (fit_multiexp_warm over fit.engine), once a step")
        else:
            check(launches == [0] * 5, f"stacked: no kernel launched ({launches})")
        check(all(c["launches_" + k] == 0 for c in calls if c["stage"] != "warm"
                  for k in "BCDE"),
              f"{kind}: the generic LM calls launched none of B, C, D, E")
        ok = all(bool(torch.isfinite(getattr(cts, f)).all()) for f in ("S2", "C", "tau", "chisq"))
        check(ok and bool((cts.mask.sum(1) >= 1).all()),
              f"{kind}: model finite, >= 1 component a row")
        busy, per = device_profile(torch, run, lambda per: saw(per, **step_counts(launches)))
        kt = kernel_times(per)
        seen = [kt.get(k, (0,))[0] for k in "BCDE"]
        check(seen == launches[1:], f"{kind}: profiler saw kernels B/C/D/E {seen} times = the "
                                    f"counters' {launches[1:]}")
        with eager_loop(engine, lm):
            eager, wall_e = wall_s(torch, run)
        check(all(same_bits(torch, getattr(cts, f), getattr(eager, f))
                  for f in ("S2", "C", "tau", "dC", "dtau", "chisq", "mask", "s2fast")),
              f"{kind}: the graph loop's model equals the eager loop's bit for bit")
        steps = sum(c["steps"] for c in calls)
        print(f"  {kind}: wall median {walls[1]:.3f} s over 3 calls (min {walls[0]:.3f}, max "
              f"{walls[2]:.3f}; eager loop {wall_e:.3f} s); {len(calls)} LM calls, {steps} steps; "
              f"profiled call: {sum(n for n, _ in per.values())} device kernels and copies, "
              f"device busy {busy:.2f} ms, idle share {1 - busy / (walls[1] * 1e3):.1%}; peak "
              f"device memory {peak / 1e6:.1f} MB (before {mem0 / 1e6:.1f} MB); kernels B/C/D/E "
              f"{launches[1:]} launches", flush=True)
        # the rung on the card against the CPU float32 ladder, and the card
        # in float64 against the CPU in float64, on the first SUBSET rows
        t0 = time.perf_counter()
        card = rung_of(run(SUBSET))
        cpu32 = fit_ct_ladder(names[:SUBSET], dt, *(torch.tensor(a[:SUBSET], dtype=torch.float32)
                                                  for a in (y, dy)), **kw)
        share32 = float((card == rung_of(cpu32)).double().mean())
        check(share32 >= 0.98, f"{kind}: rung equal to the CPU float32 ladder's on {share32:.4f} "
                               f"of {SUBSET} rows (>= 0.98)")
        t64 = [fit_ct_ladder(names[:SUBSET], dt,
                             *(torch.tensor(a[:SUBSET], dtype=torch.float64, device=d)
                               for a in (y, dy)), **kw) for d in ("cuda", "cpu")]
        same64 = bool((rung_of(t64[0]) == rung_of(t64[1])).all())
        gap = curve_gap(torch, *t64, dt)
        chi = float(((t64[0].chisq.cpu() - t64[1].chisq) / t64[1].chisq).abs().max())
        check(same64 and gap <= 1e-8 and chi <= 1e-8,
              f"{kind}: card float64 vs CPU float64 on {SUBSET} rows: rung equal on every row "
              f"({same64}), fitted C(t) within {gap:.2e} and chisq within {chi:.2e} relative "
              f"(<= 1e-8)")
        print(f"  {kind}: subset ladders {time.perf_counter() - t0:.1f} s", flush=True)
        out[kind] = dict(wall=walls[1], wall_eager=wall_e, busy=busy, peak_mb=peak / 1e6,
                         launches=launches, steps=steps, calls=len(calls), share32=share32,
                         gap64=gap, kernels=kt)

    # spectral_density's seven models and a batched legacy fit, card vs CPU
    from spinrelax_tpu_torch.fit.legacy_expfit import do_expstyle_fit, exp_decay
    from spinrelax_tpu_torch.ops import jomega as jw

    rng = np.random.default_rng(11)
    v = rng.normal(size=(N_RES, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    S2, ti = rng.uniform(0.5, 0.95, N_RES), rng.uniform(10, 500, N_RES)
    # no omega 0: there the ellipsoid's 6 Diso - 6 sqrt(Diso^2 - D2^2) cancels
    # (the reference's quirk) and J carries its rounding amplified ~1e4
    om = np.array([0.38, 3.4, 3.8, 4.2, 7.6])
    D3 = np.array([1e-4, 2e-4, 3.5e-4])
    worst = 0.0
    for model, *args in (("rigid_sphere_T", np.float64(4242.0)),
                         ("rigid_sphere_D", np.float64(4e-5)),
                         ("rigid_symmtop_D", (5e-5, 3.5e-5), v), ("rigid_ellipsoid_D", D3, v),
                         ("LS_classic_D", 4242.0, S2, ti), ("LS_symmtop_D", (3.5e-5, 5e-5), v, S2, ti),
                         ("LS_ellipsoid_D", D3, v, S2, ti)):
        on = [torch.tensor(a, device="cuda") if isinstance(a, (np.ndarray, np.float64)) else a
              for a in args]
        a = jw.spectral_density(model, torch.tensor(om, device="cuda"), *on)
        b = jw.spectral_density(model, om, *args)
        worst = max(worst, float(((a.cpu() - b) / b).abs().max()))
        check(a.is_cuda, f"spectral_density {model} ran on the card")
    check(worst <= 1e-12, f"spectral_density's seven models on the card vs the CPU, float64: "
                          f"max relative gap {worst:.2e} <= 1e-12")
    t = np.arange(1.0, 301.0)
    truth = np.stack([rng.uniform(0.5, 0.7, N_RES), rng.uniform(0.1, 0.2, N_RES),
                      rng.uniform(3, 10, N_RES), rng.uniform(0.05, 0.15, N_RES),
                      rng.uniform(60, 200, N_RES)], 1)
    yl = exp_decay(t, truth, 5).numpy() + 1e-4 * rng.normal(size=(N_RES, t.size))
    (card, wall_l), cpu = wall_s(torch, lambda: do_expstyle_fit(5, t, yl)), \
        do_expstyle_fit(5, t, yl, device="cpu")
    gaps = [float(np.max(np.abs(a - b) / (np.abs(b) + 1e-14))) for a, b in zip(card, cpu)]
    # chi and the fitted curve are flat at the optimum; the parameters and
    # their uncertainties move with where each LM stops
    check(max(gaps[0], gaps[3]) <= 1e-8 and max(gaps[1:3]) <= 1e-6,
          f"do_expstyle_fit(5) on {N_RES} curves, card vs CPU float64: relative gaps chi "
          f"{gaps[0]:.2e}, ymodel {gaps[3]:.2e} (<= 1e-8), params {gaps[1]:.2e}, perr "
          f"{gaps[2]:.2e} (<= 1e-6); {wall_l:.3f} s on the card")
    out["legacy_wall"] = wall_l
    return out


def phase_finish(torch, counters, engine, run_finish, Diffusion, paf_ensemble, acc, count):
    print("phase 6: streamed finish (ladder -> axisymmetric J -> 64 weighted PAF samples "
          "-> ensemble rates) on phase 4's accumulators vs the CPU in float64", flush=True)
    vecs, weights = paf_ensemble(N_RES, 64, seed=1)
    kw = dict(n_res=N_RES, delta_t=1.0, diffusion=Diffusion.axisymmetric(tau=4242.0, aniso=1.3),
              vecs=vecs, weights=weights)
    for c in counters:
        c.launches = 0
    out, secs = wall_s(torch, lambda: run_finish(*acc, count, **kw))
    launches = [c.launches for c in counters]
    check(lm_steps_ok(launches),
          f"finish launched kernels B/C/D/E {launches[1:]} times, equally")
    t0 = time.perf_counter()
    ref = run_finish(acc[0].double().cpu(), acc[1].double().cpu(), count, **kw)
    cpu_s = time.perf_counter() - t0
    for f in ("R1", "R2", "NOE", "rho", "dR1", "dR2", "dNOE", "drho"):
        a = getattr(out, f)
        check(bool(torch.isfinite(a).all()) and a.shape == (N_RES,), f"finish {f} finite, ({N_RES},)")
    for f in ("R1", "R2", "NOE", "rho"):
        med = float(rel_gap(getattr(out, f).cpu(), getattr(ref, f)).median())
        check(med < 1e-4, f"finish {f} median relative gap to CPU float64 {med:.3e} < 1e-4")
    share = float((rung_of(out.cts) == rung_of(ref.cts)).double().mean())
    busy, per = device_profile(torch, lambda: run_finish(*acc, count, **kw),
                               lambda per: saw(per, **step_counts(launches)))
    seen = [kernel_times(per).get(k, (0,))[0] for k in "BCDE"]
    check(seen == launches[1:], f"finish: profiler saw kernels B/C/D/E {seen} times = the "
                                f"counters' {launches[1:]}")
    secs = sorted([secs] + [wall_s(torch, lambda: run_finish(*acc, count, **kw))[1]
                            for _ in range(2)])[1]
    with eager_loop(engine):
        eager, first = wall_s(torch, lambda: run_finish(*acc, count, **kw))
        secs_e = sorted([first] + [wall_s(torch, lambda: run_finish(*acc, count, **kw))[1]
                                   for _ in range(2)])[1]
        busy_e, _ = device_profile(torch, lambda: run_finish(*acc, count, **kw))
    check(all(same_bits(torch, getattr(out, f), getattr(eager, f))
              for f in ("R1", "R2", "NOE", "rho", "dR1", "dR2", "dNOE", "drho")),
          "the finish's rates from the graph loop equal the eager loop's bit for bit")
    print(f"  finish wall median of 3 {secs:.3f} s on the card (CPU float64 {cpu_s:.1f} s); rung "
          f"equal to CPU float64 on {share:.4f} of {N_RES} residues; profiled call: device busy "
          f"{busy:.2f} ms, idle share {1 - busy / (secs * 1e3):.1%} of the wall; "
          + "; ".join(f"kernel {k} {n} launches, {us:.2f} us each"
                      for k, (n, us) in sorted(kernel_times(per).items()))
          + f"; eager loop: wall median of 3 {secs_e:.3f} s, device busy {busy_e:.2f} ms, "
            f"idle share {1 - busy_e / (secs_e * 1e3):.1%}", flush=True)
    return dict(wall=secs, launches=launches, busy=busy, wall_eager=secs_e, busy_eager=busy_e,
                kw=kw, out=out, ref=ref)


def moved_share(a, b) -> float:
    """Share of histogram samples that sit in another bin in ``a`` than in
    ``b`` (two histograms of the same samples)."""
    a, b = a.double(), b.double()
    return float((a - b).abs().sum() / 2 / b.sum())


def stage_observables(torch, gen, n_frames, n_bonds):
    """One group's host-reduced observables, made on the card: a body whose
    orientation random-walks (quaternion steps of ~0.01 rad a frame), with
    ``n_bonds`` bond directions wobbling around their own axes.  S is the
    Horn correlation C_ref R(t)^T of a reference with second moments
    diag(1, 0.6, 0.3); raw_diff is R(t) applied to the wobbling bonds, at
    the N-H length in nm -> (raw_diff (F, nB, 3), S (F, 3, 3)) float32."""
    from spinrelax_tpu_torch.core import quaternion as qt

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    q = qt.qnorm(rand(1, 4) + 0.005 * torch.cumsum(rand(n_frames, 4), dim=0))
    R = qt.quat_to_mat(q)  # (F, 3, 3)
    axis = torch.nn.functional.normalize(rand(1, n_bonds, 3), dim=-1)
    wob = torch.cumsum(rand(n_frames, n_bonds, 3), dim=0)
    wob = wob - wob.mean(dim=0, keepdim=True)
    body = torch.nn.functional.normalize(axis + 0.3 * wob / wob.std(), dim=-1)
    raw = 0.102 * torch.einsum("fij,fbj->fbi", R, body)
    S = torch.diag(torch.tensor([1.0, 0.6, 0.3], device="cuda")) @ R.transpose(1, 2)
    return raw.contiguous(), S.contiguous()


UBQ = dict(n_res=71, n_atoms=1231, n_frames=20_000, dt=2.0, tau=4000.0)  # phases 7a, 8a
DQ_FRAMES = 1_000_000  # phase 8b


def ubiquitin_system(work: Path) -> dict:
    """The synthetic .pdb + .xtc at ubiquitin's size of phases 7a and 8a
    (entry.synthetic_system, seed 7), written into ``work``."""
    from spinrelax_tpu_torch import _build
    from spinrelax_tpu_torch.entry import synthetic_system

    t0 = time.perf_counter()
    ref_fn, xtc_fn, _ = synthetic_system(work, n_res=UBQ["n_res"],
                                         n_extra=UBQ["n_atoms"] - 3 * UBQ["n_res"],
                                         n_frames=UBQ["n_frames"], dt=UBQ["dt"], seed=7)
    print(f"synthetic system: {UBQ['n_atoms']} atoms, {UBQ['n_res']} N-H bonds, "
          f"{UBQ['n_frames']} frames, dt {UBQ['dt']} ps, {Path(xtc_fn).stat().st_size / 1e6:.1f} "
          f"MB .xtc, made in {time.perf_counter() - t0:.1f} s (codec "
          f"{_build.host_library_path('xtc').name}, text I/O "
          f"{_build.host_library_path('fastio').name})", flush=True)
    return dict(dir=work, ref=ref_fn, xtc=xtc_fn)


def phase_stage(torch, tac, cuda_acf, counters, gen, ubq):
    print("phase 7: the streamed C(t) stage (.xtc -> Horn orientation -> bond vectors -> "
          "fused group update over kernel A) on the card", flush=True)
    import numpy as np

    from spinrelax_tpu_torch.core import geometry
    from spinrelax_tpu_torch.entry import ct_entry
    from spinrelax_tpu_torch.io import native, xvg
    from spinrelax_tpu_torch.io import pdb as pdbio
    from spinrelax_tpu_torch.ops import orient
    from spinrelax_tpu_torch.pipeline.stages import (
        _fit_weights, fused_group_update, init_accumulators, stage_ct_streamed)

    # (a) the file leg, at ubiquitin's size
    n_res, dt, tau = UBQ["n_res"], UBQ["dt"], UBQ["tau"]
    ref_fn, xtc_fn = ubq["ref"], ubq["xtc"]
    fpc, groups = int(tau / dt), 4
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        kw = dict(tau_memory=tau, chunk_groups=groups)
        stage_ct_streamed([xtc_fn], [ref_fn], str(Path(tmp) / "warm"), **kw)  # warm-up
        for c in counters:
            c.launches = 0
        card, secs = wall_s(torch, lambda: stage_ct_streamed(
            [xtc_fn], [ref_fn], str(Path(tmp) / "card"), **kw))
        res["launches"] = [c.launches for c in counters]
        n_groups = -(-card["n_chunks"] // groups)
        check(res["launches"][0] == 2 * n_groups,
              f"the stage launched kernel A {res['launches'][0]} times = 2 x {n_groups} groups "
              f"({card['n_chunks']} chunks of {fpc} frames, D {fpc // 2})")
        # the host's share: decode + reduce alone, all cores
        top, ref_xyz = pdbio.read_structure(ref_fn)
        idx_h, idx_x, _ = pdbio.bond_indices(top)
        A = orient.bond_obs_matrix(ref_xyz[0], _fit_weights(top, "occupancy > 0"))
        t0 = time.perf_counter()
        n_read = sum(r.shape[0] for r, _, _ in native.iter_xtc_obs(
            xtc_fn, fpc * groups, idx_h, idx_x, A, threads=0))
        t_host = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref = stage_ct_streamed([xtc_fn], [ref_fn], str(Path(tmp) / "cpu"), device="cpu",
                                dtype=torch.float64, **kw)
        t_cpu = time.perf_counter() - t0
        files = [f"card{s}" for s in ("_Ctext.dat", "_Ctint.dat", "_S2.dat", "_avgvec.dat",
                                      "_vecHistogram.npz")]
        check(all((Path(tmp) / f).stat().st_size > 0 for f in files),
              "the stage wrote _Ctext.dat, _Ctint.dat, _S2.dat, _avgvec.dat, _vecHistogram.npz")
        h_card, h_ref = (torch.from_numpy(np.load(str(Path(tmp) / f"{n}_vecHistogram.npz"),
                                                  allow_pickle=True)["data"])
                         for n in ("card", "cpu"))
        # The writer of _Ctext.dat / _Ctint.dat: libfastio's rows (the
        # stage's route) against numpy's row formatter (the route before libfastio) on
        # the same rows, the same bytes.
        rows = (card["res_ids"], tac.lag_times(dt, tau).numpy(),
                np.stack([card["Ct"].T, card["dCt"].T], axis=-1))
        t0 = time.perf_counter()
        xvg.print_sxylist(str(Path(tmp) / "native.dat"), *rows)
        t_write = 2 * (time.perf_counter() - t0)
        native_rows = xvg._native_rows
        xvg._native_rows = lambda x, y: False
        try:
            t0 = time.perf_counter()
            xvg.print_sxylist(str(Path(tmp) / "rows.dat"), *rows)
            t_rows = 2 * (time.perf_counter() - t0)
        finally:
            xvg._native_rows = native_rows
        check((Path(tmp) / "native.dat").read_bytes() == (Path(tmp) / "rows.dat").read_bytes(),
              "libfastio's C(t) rows are numpy's row formatter's bytes")
    print(f"  writing _Ctext.dat + _Ctint.dat ({2 * n_res * (fpc // 2)} rows) through libfastio "
          f"takes {t_write:.3f} s = {t_write / secs:.1%} of the stage wall; through numpy's row "
          f"formatter (the stage's route before libfastio) {t_rows:.3f} s", flush=True)
    print(f"  stage wall {secs:.3f} s on the card for {n_read} frames ({n_read / secs:.0f} "
          f"frames/s); decode + reduce alone {t_host:.3f} s = {t_host / secs:.1%} of it; "
          f"the same stage on the CPU in float64 {t_cpu:.1f} s", flush=True)
    for k, tol in (("Ct", 2e-6), ("S2", 1e-5), ("avgvec", 1e-5)):
        a = torch.from_numpy(card[k]).double()
        b = torch.from_numpy(ref[k])
        check(a.shape == b.shape and bool(torch.isfinite(a).all()), f"stage {k} {tuple(a.shape)} finite")
        err = float((a - b)[..., 0].abs().max()) if k == "S2" else float((a - b).abs().max())
        check(err <= tol, f"stage {k} max abs vs the CPU float64 stage {err:.3e} <= {tol}")
    for key in ("ct_ext_s", "ct_int_s"):
        mean = tac.palmer_pooled_stats(card["acc"][key], card["acc"][key + "2"], card["n_chunks"])[0]
        rmean = tac.palmer_pooled_stats(ref["acc"][key], ref["acc"][key + "2"], ref["n_chunks"])[0]
        err = float((mean.double().cpu() - rmean).abs().max())
        check(err <= 2e-6, f"stage pooled C(t) of {key} max abs err {err:.3e} <= 2e-6")
    # float32 vectors differ from float64 ones by ~1e-7, so a sample within
    # that of a bin edge lands in the neighbouring bin: a few in a million.
    moved = moved_share(h_card, h_ref)
    check(int(h_card.sum()) == int(h_ref.sum()) == n_res * card["n_chunks"] * fpc
          and moved <= 1e-3,
          f"stage histogram: {int(h_card.sum())} samples, {moved:.2e} of them in another bin "
          f"than in float64 (<= 1e-3; {int((h_card != h_ref).sum())} of {h_card.numel()} "
          f"counts differ)")
    res.update(wall=secs, host=t_host, cpu=t_cpu, frames=n_read, write=t_write, rows=t_rows)

    # (b) the device leg at the forward's width
    n_bonds, n_grp, F = N_RES, 10, fpc * groups
    print(f"  (b) device leg: {n_bonds} bonds x {n_grp} groups of {groups} chunks x {fpc} "
          f"frames, observables made on the card", flush=True)
    acc = init_accumulators(n_bonds, fpc, torch.float32, "cuda")
    racc = init_accumulators(n_bonds, fpc, torch.float64, "cuda")
    w_g = torch.ones(groups, device="cuda")
    n_vals = fpc - torch.arange(1, fpc // 2 + 1, device="cuda", dtype=torch.float64)
    cuda_acf.acf_lag_sums.launches = 0
    step_ms = []

    def group_step(raw, S, acc):
        bv = orient.bond_vectors_from_obs(raw, S)
        return fused_group_update(bv.raw.reshape(groups, fpc, n_bonds, 3),
                                  bv.fitted.reshape(groups, fpc, n_bonds, 3), w_g, None, acc)[0]

    for g in range(n_grp):
        raw, S = stage_observables(torch, gen, F, n_bonds)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        acc = group_step(raw, S, acc)
        ev[1].record()
        # the float64 plain route: the same observables, torch.fft lag sums
        bv = orient.bond_vectors_from_obs(raw.double(), S.double())
        for key, vv in (("ext", bv.raw), ("int", bv.fitted)):
            v = vv.reshape(groups, fpc, n_bonds, 3).transpose(1, 2)
            s = tac.acf_sums_plain(v, fpc // 2).reshape(-1, fpc // 2).T
            e = (-1.5 + 1.5 * s / n_vals[:, None]).reshape(fpc // 2, groups, n_bonds)
            racc[f"ct_{key}_s"] += e.sum(1)
            racc[f"ct_{key}_s2"] += (e**2).sum(1)
        e2b = tac.s2_block_values(bv.fitted.reshape(groups, fpc, n_bonds, 3)) - 1.0
        racc["s2_s"] += e2b.sum(0)
        racc["s2_s2"] += (e2b**2).sum(0)
        racc["vec_sum"] += bv.fitted.sum(0)
        racc["hist"] += geometry.lambert_histogram(bv.fitted.transpose(0, 1), 72, 36)[0]
        del bv, v, s, e
        ev[1].synchronize()
        step_ms.append(ev[0].elapsed_time(ev[1]))
    launches_b = cuda_acf.acf_lag_sums.launches
    check(launches_b == 2 * n_grp, f"device leg launched kernel A {launches_b} times = 2 x "
                                   f"{n_grp} groups")
    count = n_grp * groups
    for key in ("ct_ext_s", "ct_int_s"):
        mean, dct = tac.palmer_pooled_stats(acc[key], acc[key + "2"], count)
        rmean, _ = tac.palmer_pooled_stats(racc[key], racc[key + "2"], count)
        err = float((mean.double() - rmean).abs().max())
        check(err <= 2e-6 and bool(torch.isfinite(dct).all()),
              f"device leg pooled C(t) of {key} max abs err {err:.3e} <= 2e-6")
    s2 = tac.palmer_pooled_stats(acc["s2_s"], acc["s2_s2"], count)[0]
    rs2 = tac.palmer_pooled_stats(racc["s2_s"], racc["s2_s2"], count)[0]
    err = float((s2.double() - rs2).abs().max())
    check(err <= 1e-5, f"device leg S2 max abs err {err:.3e} <= 1e-5")
    err = float((acc["vec_sum"].double() - racc["vec_sum"]).abs().max() / (count * fpc))
    check(err <= 1e-6, f"device leg average vector max abs err {err:.3e} <= 1e-6")
    moved = moved_share(acc["hist"], racc["hist"])
    check(moved <= 1e-3, f"device leg histogram: {moved:.2e} of {int(racc['hist'].sum())} "
                         f"samples in another bin than in float64 (<= 1e-3)")
    med = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
    # where a group step's time goes: the copy, eigh, the whole step profiled
    raw, S = stage_observables(torch, gen, F, n_bonds)
    raw_h, S_h = raw.cpu().pin_memory(), S.cpu().pin_memory()
    copy_ms = cuda_ms(torch, lambda: (raw_h.cuda(non_blocking=True), S_h.cuda(non_blocking=True)))
    K = orient._horn_K(S)
    eigh_ms = cuda_ms(torch, lambda: torch.linalg.eigh(K))
    bv_ms = cuda_ms(torch, lambda: orient.bond_vectors_from_obs(raw, S))
    _, wall = wall_s(torch, lambda: group_step(raw, S, acc))
    busy, per = device_profile(torch, lambda: group_step(raw, S, acc),
                               lambda per: saw(per, A=2))
    kt = kernel_times(per)
    check(kt.get("A", (0,))[0] == 2, f"profiler saw kernel A {kt.get('A', (0,))[0]} times in one "
                                     f"group step (2: raw and superposed vectors)")
    a_ms = kt["A"][0] * kt["A"][1] / 1e3
    top = sorted(per.items(), key=lambda kv: -kv[1][1])[:6]
    print(f"  group step (bond_vectors_from_obs + fused update) median {med:.3f} ms over "
          f"{n_grp - 1} steps = {F * n_bonds / (med * 1e-3):.4e} frames*bonds/s; one step: wall "
          f"{wall * 1e3:.3f} ms, device busy {busy:.3f} ms, idle share {1 - busy / (wall * 1e3):.1%}; "
          f"kernel A 2 x {kt['A'][1] / 1e3:.3f} ms = {a_ms / busy:.1%} of busy; eigh on "
          f"({F}, 4, 4) {eigh_ms:.3f} ms = {eigh_ms / med:.1%} of the step; "
          f"bond_vectors_from_obs {bv_ms:.3f} ms; host -> card copy of one group's observables "
          f"({(raw.numel() + S.numel()) * 4 / 1e6:.1f} MB, pinned) {copy_ms:.3f} ms", flush=True)
    print("  longest device kernels of one step: "
          + "; ".join(f"{name[:60]} {n} x, {ms:.3f} ms" for name, (n, ms) in top), flush=True)
    res.update(step_ms=med, eigh_ms=eigh_ms, copy_ms=copy_ms, busy=busy, step_wall=wall * 1e3,
               a_ms=a_ms, launches_device_leg=launches_b)
    del acc, racc, raw, S, K

    # (c) file to rates
    for c in counters:
        c.launches = 0
    (out, rates), secs = wall_s(torch, ct_entry)
    res["launches_entry"] = [c.launches for c in counters]
    check(all(n > 0 for n in res["launches_entry"]),
          f"ct_entry launched kernels A/B/C/D/E {res['launches_entry']} times")
    _, cpu = ct_entry(device="cpu")
    for f in ("R1", "R2", "NOE", "rho"):
        a = getattr(rates, f)
        check(bool(torch.isfinite(a).all()) and a.shape == (len(out["res_ids"]),),
              f"ct_entry {f} finite, ({len(out['res_ids'])},)")
        med_gap = float(rel_gap(a.cpu(), getattr(cpu, f)).median())
        check(med_gap < 1e-3, f"ct_entry {f} median relative gap to the CPU run {med_gap:.3e} < 1e-3")
    print(f"  (c) ct_entry (8 residues, 6000 frames: .xtc -> stage -> finish) {secs:.3f} s",
          flush=True)
    res["entry_wall"] = secs
    return res

def dq_header(path) -> dict:
    """{label: value} of a -aniso2.dat's "# Converted <label> = <value>"
    lines (D_0..D_2 and Diso as %e, the anisotropies as %f)."""
    out = {}
    for line in Path(path).read_text().splitlines():
        parts = line.split()
        if line.startswith("# Converted"):
            out[parts[2]] = float(parts[4])
    return out


def phase_runall(torch, counters, ubq):
    """(a) The run-all workflow at ubiquitin's size on the card, held to the
    same workflow on the CPU in float64."""
    print("phase 8a: run-all on the card (orientation -> Delta-q -> in-memory C(t) -> DoF "
          "ladder -> R1/R2/NOE/rho + J(w) at 2 fields) vs the CPU in float64", flush=True)
    import contextlib
    import io
    import itertools

    from spinrelax_tpu_torch.constants import GYROMAGNETIC_RATIOS
    from spinrelax_tpu_torch.io import fittedct, xvg
    from spinrelax_tpu_torch.pipeline import runall

    argv = ["-sxtc", ubq["xtc"], "-refpdb", ubq["ref"], "-t_mem", str(UBQ["tau"]),
            "-num_chunks", "4", "-Bfields", "600.133", "850.13", "-Jw"]
    pref = f"rotdif-{UBQ['tau'] / 1000.0:g}ns"

    def run(name, device="cuda"):
        d = Path(ubq["dir"]) / name
        d.mkdir(exist_ok=True)
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            summary = runall.main(["-out", str(d / "rotdif"), "-qfile", str(d / "colvar-qorient"),
                                   *argv], device=device)
        return d, summary, log.getvalue()

    for c in counters:
        c.launches = 0
    (card_dir, card, _), wall = wall_s(torch, lambda: run("card"))
    launches = [c.launches for c in counters]
    check(launches[0] == 2 and lm_steps_ok(launches),
          f"run-all launched kernels A/B/C/D/E {launches} times (A: the raw and the superposed "
          f"vectors' C(t); B, C, D and E once a step of the ladder)")
    names = itertools.count()
    busy, per = device_profile(torch, lambda: run(f"profiled{next(names)}"),
                               lambda per: saw(per, A=launches[0], **step_counts(launches)))
    kt = kernel_times(per)
    check(all(kt.get(k, (0,))[0] == n for k, n in zip("ABCDE", launches)),
          f"profiler saw kernels A/B/C/D/E {[kt.get(k, (0,))[0] for k in 'ABCDE']} times = the "
          f"wrappers' counts")
    _, again, log = run("card")
    check(log.lower().count("skipping") == 4 + 2,
          "a second main() on the same directory skipped every stage (4 steps + 2 fields)")
    t0 = time.perf_counter()
    cpu_dir, cpu, _ = run("cpu", device="cpu")
    cpu_s = time.perf_counter() - t0
    # the host's part of the orient and ct steps: one decode of the file
    # (load_trajectory, as both steps read it) and the bond-observable
    # reduction of stage_ct
    from spinrelax_tpu_torch.io import pdb as pdbio
    from spinrelax_tpu_torch.io import trajectory
    from spinrelax_tpu_torch.ops import orient
    from spinrelax_tpu_torch.pipeline.stages import _fit_weights

    t0 = time.perf_counter()
    xyz, _ = trajectory.load_trajectory(ubq["xtc"])
    t_decode = time.perf_counter() - t0
    top, ref_xyz = pdbio.read_structure(ubq["ref"])
    idx_h, idx_x, _ = pdbio.bond_indices(top)
    t0 = time.perf_counter()
    orient.bond_obs_host(xyz, ref_xyz[0], idx_h, idx_x, _fit_weights(top, "occupancy > 0"))
    t_reduce = time.perf_counter() - t0
    del xyz
    steps = ", ".join(f"{k} {v:.3f} s" for k, v in card["walls"].items())
    print(f"  card: wall {wall:.3f} s ({steps}); device busy {busy:.2f} ms, idle share "
          f"{1 - busy / (wall * 1e3):.1%}; profiled: "
          + "; ".join(f"kernel {k} {n} launches, {us:.2f} us each"
                      for k, (n, us) in sorted(kt.items())), flush=True)
    print(f"  host parts: one decode of the .xtc (load_trajectory) {t_decode:.3f} s, the "
          f"bond-observable reduction of stage_ct {t_reduce:.3f} s", flush=True)
    print(f"  CPU float64: wall {cpu_s:.1f} s ("
          + ", ".join(f"{k} {v:.3f} s" for k, v in cpu["walls"].items()) + ")", flush=True)
    print(f"  Diso used {card['diso']:.6e} ps^-1 (CPU {cpu['diso']:.6e}), Daniso "
          f"{card['dani']:g} (CPU {cpu['dani']:g})", flush=True)
    hc, hf = dq_header(card_dir / f"{pref}-aniso2.dat"), dq_header(cpu_dir / f"{pref}-aniso2.dat")
    for k in ("D_0", "D_1", "D_2", "Diso"):
        gap = abs(hc[k] - hf[k]) / abs(hf[k])
        check(gap <= 1e-6, f"run-all {k} {hc[k]:.6e} s^-1, relative gap to CPU float64 "
                           f"{gap:.2e} <= 1e-6")
    for k in ("Dani_L", "Drho_L", "Dani_S", "Drho_S"):
        check(abs(hc[k] - hf[k]) <= 1e-6, f"run-all {k} {hc[k]:f} (CPU float64 {hf[k]:f}; "
                                          f"printed to 1e-6)")
    for f in ("_Ctint.dat", "_Ctext.dat"):
        a, b = (xvg.load_sxydylist(d / (pref + f)) for d in (card_dir, cpu_dir))
        err = float(abs(a[2] - b[2]).max())
        check(a[0] == b[0] and err <= 2e-6, f"run-all {f} C(t) max abs vs CPU float64 "
                                            f"{err:.3e} <= 2e-6")
    rung = [fittedct.read_fittedct(str(d / f"{pref}_fittedCt.dat"), device="cpu")
            for d in (card_dir, cpu_dir)]
    rung = [m.mask.sum(1) * 2 + m.s2fast for m in rung]
    same = rung[0] == rung[1]
    share = float(same.double().mean())
    check(share >= 0.98, f"run-all rung equal to the CPU float64 ladder's on {share:.4f} of "
                         f"{len(rung[0])} residues (>= 0.98)")
    # Rates and J(w) element by element, on the residues whose rung agrees
    # (another rung is another model): |a - b| <= 1e-5 |b| + atol.
    # - R1, R2, rho: atol = 1e-5 max|b| of the file.
    # - J(w) is printed with "%g": atol is one unit in b's sixth digit.
    # - NOE = 1 + k sigma/R1, k = gamma_H/gamma_N: sigma and R1 are sums of
    #   the same J values, |sigma| <= R1, so J values each within 1e-5 fix
    #   the NOE only to 1e-5 |k| (1 + |sigma|/R1) <= 2e-5 |k| (= 1.97e-4),
    #   the atol; an NOE near zero is a cancellation of 1 against k sigma/R1.
    kappa = abs(GYROMAGNETIC_RATIOS["1H"] / GYROMAGNETIC_RATIOS["15N"])
    gaps = []
    for bf in ("600", "850"):
        for f in ("R1", "R2", "NOE", "rho", "Jw"):
            if f == "Jw":
                a, b = (torch.from_numpy(xvg.load_sxydylist(d / f"{pref}-{bf}_Jw.dat")[2])
                        for d in (card_dir, cpu_dir))
                atol = 10.0 ** (torch.floor(torch.log10(b.abs())) - 5)
            else:
                a, b = (torch.from_numpy(xvg.load_matrix(d / f"{pref}-{bf}_{f}.dat")[:, 1:2])
                        for d in (card_dir, cpu_dir))
                atol = 2e-5 * kappa if f == "NOE" else 1e-5 * b.abs().max()
            a, b, atol = a[same], b[same], torch.broadcast_to(torch.as_tensor(atol), b.shape)[same]
            excess = (a - b).abs() / (1e-5 * b.abs() + atol)
            worst = divmod(int(excess.argmax()), excess.shape[1])
            gap = float(rel_gap(a, b).max())
            gaps.append(gap)
            check(bool(torch.isfinite(a).all()) and float(excess.max()) <= 1.0,
                  f"run-all {bf} MHz {f}: every value within 1e-5 |b| + atol of CPU float64 "
                  f"on the {int(same.sum())} residues of equal rung (worst at residue index "
                  f"{worst[0]}: {float(a[worst]):.9g} against {float(b[worst]):.9g}, "
                  f"{float(excess.max()):.3f} of the allowance; max relative gap {gap:.2e})")
    return dict(wall=wall, walls=card["walls"], busy=busy, launches=launches, kernels=kt,
                cpu=cpu_s, share=share, rate_gap_max=max(gaps), decode=t_decode,
                reduce=t_reduce, argv=argv, pref=pref, cpu_dir=cpu_dir, cpu_diso=cpu["diso"],
                cpu_dani=cpu["dani"])


def phase_dq_long(torch, work: Path):
    """(b) Delta-q at the length users give it: 10^6 frames."""
    n, dt = DQ_FRAMES, 1.0
    print(f"phase 8b: Delta-q on {n} frames (anisotropic Brownian tumbling made on the card), "
          f"100 lags of 10 ps, 4 sub-chunks: in memory, streamed, and on the CPU", flush=True)
    import numpy as np

    from spinrelax_tpu_torch.core import quaternion as qt
    from spinrelax_tpu_torch.io import colvar
    from spinrelax_tpu_torch.ops import dq as dqops
    from spinrelax_tpu_torch.pipeline.stages import stage_dq

    f64 = dict(dtype=torch.float64, device="cuda")
    D = torch.tensor([8e-4, 1.2e-3, 2.4e-3], **f64)  # body frame, ps^-1
    gen = torch.Generator(device="cuda").manual_seed(20261017)
    t0 = time.perf_counter()
    w = torch.randn((n, 3), generator=gen, **f64) * torch.sqrt(2.0 * D * dt)
    th = w.norm(dim=1, keepdim=True)
    q = torch.cat([torch.cos(th / 2), w / th * torch.sin(th / 2)], dim=1)
    q[0] = torch.tensor([1.0, 0.0, 0.0, 0.0], **f64)
    # q_t = q_{t-1} dq_t: an inclusive prefix product, by doubling (the
    # quaternion product is associative): 20 passes, no loop over frames
    k = 1
    while k < n:
        q = torch.cat([q[:k], qt.qmult(q[:-k], q[k:])])
        k *= 2
    q = qt.qnorm(q)
    torch.cuda.synchronize()
    t_make = time.perf_counter() - t0
    fn = str(work / "colvar-1M")
    t0 = time.perf_counter()
    times = torch.arange(n, **f64)[:, None] * dt
    colvar.write_colvar(fn, ["time", "q.w", "q.x", "q.y", "q.z"],
                        torch.cat([times, q], dim=1).T.cpu().numpy())
    t_write = time.perf_counter() - t0
    print(f"  q(t) made on the card in {t_make:.3f} s; colvar written ({Path(fn).stat().st_size / 1e6:.1f}"
          f" MB, io.colvar) in {t_write:.2f} s", flush=True)

    grid = (10.0, 1000.0, 10.0)
    lags = dqops._lag_grid(dt, *grid, n)
    t0 = time.perf_counter()
    _, data = colvar.read_colvar(fn)
    t_read = time.perf_counter() - t0
    qd = torch.as_tensor(data[1:5].T.copy(), device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    stats, t_stats = wall_s(torch, lambda: dqops.dq_statistics(qd, lags, n_chunks=4))
    peak_stats = torch.cuda.max_memory_allocated() - base
    _, t_fin = wall_s(torch, lambda: dqops._finalise_dq(stats, lags, dt))
    del stats, qd
    out = {}
    for key, kw in (("memory", {}), ("streamed", dict(stream_chunk=65536))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out[key], secs = wall_s(torch, lambda: stage_dq(fn, str(work / f"dq-{key}"), *grid,
                                                        n_chunks=4, **kw))
        out[key + "_s"] = secs
        out[key + "_peak"] = torch.cuda.max_memory_allocated() - base
    t0 = time.perf_counter()
    out["cpu"] = stage_dq(fn, str(work / "dq-cpu"), *grid, n_chunks=4, device="cpu")
    out["cpu_s"] = time.perf_counter() - t0
    print(f"  in memory: read {t_read:.3f} s (libfastio), statistics {t_stats:.3f} s = "
          f"{n / t_stats:.4e} frames/s ({len(lags)} lags, peak {peak_stats / 1e6:.1f} MB above the "
          f"input), finalise {t_fin:.3f} s; the whole stage {out['memory_s']:.3f} s (peak "
          f"{out['memory_peak'] / 1e6:.1f} MB); streamed (65536 frames a part) "
          f"{out['streamed_s']:.3f} s (peak {out['streamed_peak'] / 1e6:.1f} MB); CPU float64 "
          f"{out['cpu_s']:.1f} s", flush=True)
    ref = out["cpu"]
    print(f"  D recovered {np.sort(ref.D_axes) * 1e-12} ps^-1 (body frame {D.tolist()}), "
          f"Diso {ref.D_iso * 1e-12:.4e}", flush=True)
    for key in ("memory", "streamed"):
        r = out[key]
        gap = max(float(np.max(np.abs(r.D_axes - ref.D_axes) / np.abs(ref.D_axes))),
                  abs(r.D_iso - ref.D_iso) / abs(ref.D_iso))
        check(bool(np.isfinite(r.D_axes).all()) and gap <= 1e-10,
              f"Delta-q {key} D and Diso relative gap to CPU float64 {gap:.2e} <= 1e-10")
    gap = float(np.max(np.abs(out["memory"].D_axes - out["streamed"].D_axes)
                       / np.abs(out["memory"].D_axes)))
    check(gap <= 1e-10, f"Delta-q in memory vs streamed D relative gap {gap:.2e} <= 1e-10")
    return dict(frames=n, read=t_read, stats=t_stats, fin=t_fin, peak=peak_stats,
                memory=out["memory_s"], memory_peak=out["memory_peak"],
                streamed=out["streamed_s"], streamed_peak=out["streamed_peak"],
                cpu=out["cpu_s"], rate=n / t_stats)



FIT_FIELDS = (600.133, 850.13)  # phase 9a's experiments
# phase 9b: maltose-binding protein's length, stage_ct's 72 x 36 histogram
# bins a residue, tau_iso 18 ns
MBP = dict(n_res=370, n_samp=72 * 36, tau_ps=18_000.0, aniso=1.3,
           fields=(600.133, 700.13, 850.13))


def within(a: float, b: float, rtol: float) -> bool:
    """|a - b| <= rtol |b| + one unit of b's sixth significant digit (what
    "%g" prints)."""
    import numpy as np

    return abs(a - b) <= rtol * abs(b) + 10.0 ** (np.floor(np.log10(abs(b) or 1.0)) - 5)


def files_within(a: Path, b: Path, rtol: float):
    """(every number of text file a within(.., rtol) of b's and every word
    equal, the largest relative gap)."""
    ta, tb = a.read_text().split(), b.read_text().split()
    if len(ta) != len(tb):
        return False, float("inf")
    ok, worst = True, 0.0
    for x, y in zip(ta, tb):
        try:
            fx, fy = float(x), float(y)
        except ValueError:
            ok &= x == y
            continue
        ok &= within(fx, fy, rtol)
        worst = max(worst, abs(fx - fy) / max(abs(fy), 1e-300))
    return ok, worst


def header_value(path: Path, name: str) -> float:
    """The number of a "# <status> <name>: <value> <unit>" header line."""
    m = re.search(rf"^# \w+ {name}: (\S+)", path.read_text(), re.M)
    return float(m.group(1))


@contextlib.contextmanager
def fit_log(globalfit, profile: bool):
    """Record every GlobalFitter.run inside: its variables, wall, counts,
    host reads and (``profile``) device-busy ms from torch.profiler,
    recording the card's activity only.  A profiled run's wall is not a
    timing: idle shares take the wall of an unprofiled run."""
    from torch.profiler import ProfilerActivity, profile as prof_ctx

    log = []
    run = globalfit.GlobalFitter.run

    def logged(self, *a, **k):
        reads = globalfit.host_reads.count
        ctx = prof_ctx(activities=[ProfilerActivity.CUDA]) if profile else contextlib.nullcontext()
        t0 = time.perf_counter()
        with ctx as prof:  # run() ends in a read: the card is done
            out = run(self, *a, **k)
        wall = time.perf_counter() - t0
        log.append(dict(vars=",".join(self.global_vars + ["rsCSA"] * self.do_local), wall=wall,
                        counts=dict(self.counts), reads=globalfit.host_reads.count - reads,
                        busy=device_busy(prof)[0] if profile else None))
        return out

    globalfit.GlobalFitter.run = logged
    try:
        yield log
    finally:
        globalfit.GlobalFitter.run = run


@contextlib.contextmanager
def sync_count(torch):
    """Count the card's synchronising calls inside (torch's sync debug
    mode warns at each: a read to the host, a copy from pageable memory);
    after the block box["n"] holds the count and box["at"] the
    {file:line: count} of the Python lines that made them."""
    import warnings

    box = {"n": None, "at": {}}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield box
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    box["n"] = len(syncs)
    for w in syncs:
        key = f"{Path(w.filename).name}:{w.lineno}"
        box["at"][key] = box["at"].get(key, 0) + 1


def fit_line(entry, cpu_wall=None) -> str:
    """One fit's numbers; ``entry["busy"]`` comes from a profiled run of
    the same fit, the idle share against this (unprofiled) run's wall."""
    c = entry["counts"]
    busy = entry["busy"]
    idle = "" if busy is None else (f", device busy {busy:.2f} ms, idle share "
                                    f"{1 - busy / (entry['wall'] * 1e3):.1%}")
    return (f"wall {entry['wall']:.3f} s{idle}; {c['evaluations']} evaluations, "
            f"{c['lm_steps']} LM steps ({c['lm_iterations']} live), {c['golden_rounds']} golden "
            f"rounds; {entry['reads']} host reads, {c['uploads']} uploads"
            + ("" if cpu_wall is None else f"; CPU float64 {cpu_wall:.3f} s"))


def phase_fit(torch, counters, wf, dev="cuda", profile=True):
    """(a) run-all -fit and stage_relax's legacy fits at ubiquitin's size,
    on phase 8a's system, held to the truth and to the CPU in float64."""
    print("phase 9a: run-all -fit Diso / Diso,rsCSA (R1, R2, NOE at 600.133 and 850.13 MHz) "
          "and stage_relax's legacy fits Diso / DisoS2CSA / new, on phase 8a's system, vs "
          "the truth and the CPU in float64", flush=True)
    import io

    import numpy as np

    from spinrelax_tpu_torch.constants import DEFAULT_ZETA, NucleusPair, field_from_mhz
    from spinrelax_tpu_torch.fit import globalfit
    from spinrelax_tpu_torch.io import experiments, fittedct, vectors, xvg
    from spinrelax_tpu_torch.models.diffusion import Diffusion
    from spinrelax_tpu_torch.models.experiments import ExperimentSet
    from spinrelax_tpu_torch.ops import observables
    from spinrelax_tpu_torch.pipeline import runall, stages

    cpu_dir, pref = Path(wf["cpu_dir"]), wf["pref"]
    work = cpu_dir.parent
    fitted, vec = cpu_dir / f"{pref}_fittedCt.dat", cpu_dir / f"{pref}_vecHistogram.npz"
    cts = fittedct.read_fittedct(str(fitted), device="cpu").with_zeta(DEFAULT_ZETA)
    names, v, w = vectors.load_vector_distribution(str(vec))
    n = len(names)
    # the truth: 0.85 x the run's Diso, its Daniso, a CSA per residue;
    # every 7th residue unmeasured
    diso_true, dani = 0.85 * wf["cpu_diso"], wf["cpu_dani"]
    csa_true = np.random.default_rng(2026).uniform(-190e-6, -150e-6, n)
    covered = np.arange(n) % 7 != 0
    csa0 = NucleusPair().csa_value
    truth = Diffusion.axisymmetric(diso=diso_true, aniso=dani)
    files = []
    for f in FIT_FIELDS:
        r = observables.predict_rates_newapi(NucleusPair(B0=field_from_mhz(f), time_unit="ps"),
                                             truth, cts, vecs=v, weights=w, csa=csa_true)
        for t in ("R1", "R2", "NOE"):
            y = getattr(r, t).numpy()[covered]
            files.append(str(work / f"expt_{t}_{f}.dat"))
            experiments.write_experiment(files[-1], experiments.ExperimentData(
                t, "15N", "1H", f, "MHz", np.asarray(names)[covered], y, 0.02 * np.abs(y)))
    argv = wf["argv"] + ["-fit", "Diso", "Diso,rsCSA", "-expfiles", *files]

    def main_in(d: Path, device):
        d.mkdir(exist_ok=True)
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            runall.main(["-out", str(d / "rotdif"), "-qfile", str(d / "colvar-qorient"), *argv],
                        device=device)
        return log.getvalue()

    def opt_files(d: Path):
        return sorted(p.name for p in d.iterdir() if "-opt" in p.name)

    # (i) the whole path on the card from the .xtc: every stage, then the fits
    for c in counters:
        c.launches = 0
    fresh = work / "fit_card"
    with fit_log(globalfit, False) as log:
        _, wall_fresh = wall_s(torch, lambda: main_in(fresh, dev))
    launches = [c.launches for c in counters]
    check(launches[0] == 2 and lm_steps_ok(launches),
          f"run-all -fit from the .xtc launched kernels A/B/C/D/E {launches} times (A twice in "
          f"stage_ct, B, C, D and E once a ladder step)")
    rs = fresh / f"{pref}-optDiso_rsCSA"
    diso_fit = header_value(Path(f"{rs}_15N1H_600MHz_R1.xvg"), "Diso")
    _, csa_fit = xvg.load_xy(f"{rs}_CSA_opt.dat")
    print(f"  card, from the .xtc: wall {wall_fresh:.3f} s, the fits "
          + "; ".join(f"{e['vars']} {e['wall']:.3f} s" for e in log), flush=True)
    # run-all's fit alternates Powell on Diso with the rsCSA walk for at
    # most 10 cycles; Diso and the CSAs trade off, so each cycle shrinks
    # the error by a fixed share only (~0.88 in a CPU rehearsal).  Its
    # result is held to the truth within 1e-2; the same alternation
    # continued for 10 more cycles from run-all's result within 1e-3.
    gap = abs(diso_fit / diso_true - 1)
    cgap = float(np.max(np.abs(csa_fit[covered] / csa_true[covered] - 1)))
    check(max(gap, cgap) <= 1e-2, f"run-all Diso,rsCSA (10 cycles): Diso {diso_fit:g} ps^-1 "
                                  f"(truth {diso_true:.6g}, gap {gap:.2e}) and the covered "
                                  f"CSA (max gap {cgap:.2e}) within 1e-2 of the truth")
    check(bool(np.all(csa_fit[~covered] == csa0)),
          f"Diso,rsCSA: the {int((~covered).sum())} uncovered residues keep their CSA "
          f"({csa0 * 1e6:g} ppm)")
    es = ExperimentSet.build(
        [experiments.read_experiment(f) for f in files],
        fittedct.read_fittedct(str(fresh / f"{pref}_fittedCt.dat"), device=dev).with_zeta(
            DEFAULT_ZETA),
        Diffusion.axisymmetric(diso=diso_fit, aniso=dani),
        *vectors.load_vector_distribution(str(fresh / f"{pref}_vecHistogram.npz"))[1:],
        csa=csa_fit)
    cont = globalfit.GlobalFitter(es, ["Diso", "rsCSA"])
    st, wall_cont = wall_s(torch, lambda: cont.run(method="powell", max_cycles=10))
    gap = abs(st.diso / diso_true - 1)
    cgap = float(np.max(np.abs(st.csa[covered] / csa_true[covered] - 1)))
    check(gap <= 1e-3 and cgap <= 1e-3,
          f"10 more cycles ({cont.counts['golden_rounds']} golden rounds, {wall_cont:.3f} s): "
          f"Diso gap {gap:.2e}, covered CSA max gap {cgap:.2e}, both <= 1e-3")
    check(bool(np.all(st.csa[~covered] == csa0)), "the continuation keeps the uncovered CSA")

    # (ii) the same inputs on both devices: phase 8a's CPU directory, whose
    # earlier steps skip; the CPU's artefacts kept aside, then the card's
    with fit_log(globalfit, False) as cpu_log:
        t0 = time.perf_counter()
        out = main_in(cpu_dir, "cpu")
        cpu_wall = time.perf_counter() - t0
    check(out.lower().count("skipping") == 4 + 2, "run-all -fit on phase 8a's CPU directory "
                                                 "skipped every earlier stage")
    kept = cpu_dir / "fit_cpu"
    kept.mkdir()
    for f in opt_files(cpu_dir):
        (cpu_dir / f).rename(kept / f)
    with fit_log(globalfit, False) as card_log:
        _, card_wall = wall_s(torch, lambda: main_in(cpu_dir, dev))
    if profile:  # the same fits again, profiled: each one's device-busy time
        with fit_log(globalfit, True) as prof_log:
            main_in(cpu_dir, dev)
        for e, ep in zip(card_log, prof_log):
            e["busy"] = ep["busy"]
    made = opt_files(cpu_dir)
    check(made == opt_files(kept) and len(made) == 2 * 6 + 1,
          f"card and CPU wrote the same {len(made)} fit artefacts")
    worst = 0.0
    for f in made:
        ok, g = files_within(cpu_dir / f, kept / f, 1e-4)
        worst = max(worst, g)
        check(ok, f"{f}: every value within Powell's 1e-4 of the CPU's (+ a '%g' digit; "
                  f"largest gap {g:.2e})")
    print(f"  run-all -fit on the card {card_wall:.3f} s (CPU float64 {cpu_wall:.3f} s), "
          f"largest card/CPU gap {worst:.2e}", flush=True)
    for e, ec in zip(card_log, cpu_log):
        print(f"  {e['vars']} (powell): " + fit_line(e, ec["wall"]), flush=True)

    # (iii) stage_relax's legacy fits at 600.133 MHz on the run's average
    # vectors (-v, _avgvec.dat): 6-column tables of the rates at the
    # truth, with the per-residue CSA for 'new' and the default CSA for
    # the global modes
    pair = NucleusPair(B0=field_from_mhz(600.133), time_unit="ps")
    avg = cpu_dir / f"{pref}_avgvec.dat"
    av = xvg.load_xys(str(avg))[1][:, :3]
    av = av / np.linalg.norm(av, axis=-1, keepdims=True)
    tables = {}
    for key, csa in (("rs", csa_true), ("flat", None)):
        r = observables.predict_rates(pair, truth, cts, vecs=av, csa=csa)
        block = torch.stack([r.R1, 0.02 * r.R1.abs(), r.R2, 0.02 * r.R2.abs(), r.NOE,
                             0.02 * r.NOE.abs()], -1).numpy()[covered]
        tables[key] = work / f"legacy_{key}.dat"
        np.savetxt(tables[key], np.column_stack([np.asarray(names, dtype=float)[covered], block]),
                   fmt=["%d"] + ["%.12g"] * 6)
    legacy = {}
    for mode, key, tol in (("Diso", "flat", 1e-4), ("DisoS2CSA", "flat", 2e-3),
                           ("new", "rs", 2e-3)):
        def go(label, device, mode=mode, key=key):
            d = work / f"legacy_{mode}_{label}"
            d.mkdir(exist_ok=True)
            with contextlib.redirect_stdout(io.StringIO()):
                stages.stage_relax(str(fitted), str(d / "rl"),
                                   Diffusion.axisymmetric(diso=wf["cpu_diso"], aniso=dani),
                                   vec_avg_file=str(avg), freq_mhz=600.133,
                                   expt_file=str(tables[key]), opt_mode=mode, device=device)
            return d

        r0 = globalfit.host_reads.count
        dc, wall = wall_s(torch, lambda: go("card", dev))
        reads = globalfit.host_reads.count - r0
        t0 = time.perf_counter()
        dh = go("cpu", "cpu")
        cpu_s = time.perf_counter() - t0
        busy = device_profile(torch, lambda: go("card", dev), cpu=False)[0] if profile else None
        r1 = dc / "rl_R1.dat"
        got = header_value(r1, "Diso")
        gap = abs(got / diso_true - 1)
        check(gap <= tol, f"legacy {mode}: Diso {got:g} within {tol:g} of the truth (gap "
                          f"{gap:.2e})")
        if mode == "DisoS2CSA":
            zg = abs(header_value(r1, "zeta") / DEFAULT_ZETA - 1)
            cg = abs(header_value(r1, "CSA") / (csa0 * 1e6) - 1)
            check(max(zg, cg) <= tol, f"legacy {mode}: zeta and CSA within {tol:g} of the truth "
                                      f"(gaps {zg:.2e}, {cg:.2e})")
        if mode == "new":
            _, csa_l = xvg.load_xy(str(dc / "rl_CSA_values.dat"))
            cg = float(np.max(np.abs(csa_l[covered] / csa_true[covered] - 1)))
            check(cg <= 5e-3 and bool(np.all(csa_l[~covered] == csa0)),
                  f"legacy new: covered CSA within 5e-3 of the truth (max gap {cg:.2e}), the "
                  f"uncovered keep {csa0 * 1e6:g} ppm")
        lw = 0.0
        for f in sorted(p.name for p in dh.iterdir()):
            ok, g = files_within(dc / f, dh / f, 1e-4)
            lw = max(lw, g)
            check(ok, f"legacy {mode} {f}: card within 1e-4 of the CPU (largest gap {g:.2e})")
        idle = "" if busy is None else (f", device busy {busy:.2f} ms, idle share "
                                        f"{1 - busy / (wall * 1e3):.1%}")
        print(f"  legacy {mode}: card wall {wall:.3f} s{idle}, {reads} host reads; CPU "
              f"float64 {cpu_s:.3f} s", flush=True)
        legacy[mode] = dict(wall=wall, cpu=cpu_s, reads=reads, busy=busy, gap=lw)
    return dict(wall_fresh=wall_fresh, launches=launches, card_wall=card_wall, cpu_wall=cpu_wall,
                fits=card_log, cpu_fits=cpu_log, legacy=legacy, worst=worst)


def mbp_system(torch, dev="cuda", n_res=MBP["n_res"], n_samp=MBP["n_samp"]):
    """Phase 9b's inputs, made on ``dev`` from a seed: the C(t) models on
    ``dev`` and the CPU, experiments at the truth with one CSA ("flat") or
    a CSA per residue ("rs"), and ``make_set(device, key, start)``, the
    ExperimentSet of those (its device arrays and moments made)."""
    import numpy as np

    from spinrelax_tpu_torch.constants import DEFAULT_ZETA, NucleusPair, field_from_mhz
    from spinrelax_tpu_torch.io.experiments import ExperimentData
    from spinrelax_tpu_torch.models.ctmodel import CtModelSet
    from spinrelax_tpu_torch.models.diffusion import Diffusion
    from spinrelax_tpu_torch.models.experiments import ExperimentSet
    from spinrelax_tpu_torch.ops import observables

    f64 = torch.float64
    gen = torch.Generator(device=dev).manual_seed(370)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev, dtype=f64)

    t0 = time.perf_counter()
    v = torch.randn((n_res, n_samp, 3), generator=gen, device=dev, dtype=f64)
    v = v / v.norm(dim=-1, keepdim=True)
    w = rand(n_res, n_samp) + 0.5
    S2, C = 0.6 + 0.3 * rand(n_res), 0.02 + 0.08 * rand(n_res, 2)
    tau = torch.stack([5 + 25 * rand(n_res), 100 + 700 * rand(n_res)], -1)
    csa_true = (-190e-6 + 40e-6 * rand(n_res)).cpu().numpy()
    names = [str(i + 1) for i in range(n_res)]
    lists = (names, S2.cpu().numpy(), list(C.cpu().numpy()), list(tau.cpu().numpy()))
    cts = {d: CtModelSet.from_lists(*lists, s2fast=[True] * n_res, zeta=DEFAULT_ZETA,
                                    sort=False, device=d) for d in (dev, "cpu")}
    diso_true = 1.0 / (6.0 * MBP["tau_ps"])
    truth = Diffusion.axisymmetric(diso=diso_true, aniso=MBP["aniso"])
    expts = {"flat": [], "rs": []}
    for f in MBP["fields"]:
        pair = NucleusPair(B0=field_from_mhz(f), time_unit="ps")
        for key, csa in (("flat", None), ("rs", csa_true)):
            r = observables.predict_rates_newapi(pair, truth, cts[dev], vecs=v, weights=w, csa=csa)
            for t in ("R1", "R2", "NOE"):
                y = getattr(r, t).cpu().numpy()
                e = np.maximum(getattr(r, "d" + t).cpu().numpy(), 0.02 * np.abs(y))
                expts[key].append(ExperimentData(t, "15N", "1H", f, "MHz", np.asarray(names), y, e))
    v_np, w_np = v.cpu().numpy(), w.cpu().numpy()
    del v, w
    print(f"  inputs and experiments made in {time.perf_counter() - t0:.2f} s", flush=True)

    def make_set(device, key, start):
        es = ExperimentSet.build(expts[key], cts[device],
                                 Diffusion.axisymmetric(diso=start[0], aniso=start[1]),
                                 vecs=v_np, weights=w_np)
        es.device_arrays()
        es.symmtop_a_moments_device()
        return es

    starts = {"flat": (1.15 * diso_true, 1.1), "rs": (1.1 * diso_true, MBP["aniso"])}
    return dict(cts=cts, csa_true=csa_true, diso_true=diso_true, starts=starts,
                make_set=make_set)


def phase_fit_large(torch, dev="cuda", profile=True, n_res=MBP["n_res"], n_samp=MBP["n_samp"]):
    """(b) GlobalFitter at a large protein's size on the card, against the
    CPU in float64."""
    print(f"phase 9b: GlobalFitter on {n_res} residues x {n_samp} weighted samples, R1/R2/NOE "
          f"at {len(MBP['fields'])} fields, made on the card, vs the CPU in float64", flush=True)
    import numpy as np

    from spinrelax_tpu_torch.constants import NucleusPair
    from spinrelax_tpu_torch.fit import globalfit

    f64 = torch.float64
    mbp = mbp_system(torch, dev, n_res, n_samp)
    cts, csa_true, diso_true = mbp["cts"], mbp["csa_true"], mbp["diso_true"]
    starts, make_set = mbp["starts"], mbp["make_set"]
    # the collapsed chi-square against the per-sample one on the card
    for key in ("flat", "rs"):
        es = make_set(dev, key, starts[key])
        p = (torch.tensor(starts[key][0], dtype=f64, device=dev),
             torch.tensor(starts[key][1], dtype=f64, device=dev),
             cts[dev].zeta, torch.full((n_res,), NucleusPair().csa_value, dtype=f64, device=dev))
        a = float(globalfit.chisq_total(es, *p))
        globalfit.USE_MOMENT_COLLAPSE = False
        try:
            b = float(globalfit.chisq_total(es, *p))
        finally:
            globalfit.USE_MOMENT_COLLAPSE = True
        check(abs(a / b - 1) <= 1e-10, f"{key} CSA: collapsed chisq {a:.12g} = per-sample "
                                       f"{b:.12g} on the card (gap {abs(a / b - 1):.2e} <= 1e-10)")
    if dev != "cpu":  # the count's calibration: one known read (after a
        # first use of the debug mode, which counts one call of its own)
        with sync_count(torch):
            pass
        with sync_count(torch) as box:
            globalfit.host(torch.zeros(1, device=dev))
        check(box["n"] == 1, f"sync debug mode counts one read as {box['n']} ({box['at']})")
    out = []
    for method, opt, key in (("powell", ["Diso", "Daniso"], "flat"),
                             ("gradient", ["Diso", "Daniso"], "flat"),
                             ("device", ["Diso", "Daniso"], "flat"),
                             ("device", ["Diso", "rsCSA"], "rs")):
        # three fused cycles for rsCSA: each costs ~1 s of LM and golden
        # dispatch on the card at this size (PERF.md section 5)
        kw = dict(method=method, max_cycles=3)
        es = make_set(dev, key, starts[key])
        fit = globalfit.GlobalFitter(es, opt)
        r0 = globalfit.host_reads.count
        syncs = None
        ctx = sync_count(torch) if dev != "cpu" else contextlib.nullcontext({"n": None})
        with ctx as box:
            t0 = time.perf_counter()
            got = fit.run(**kw)
            wall = time.perf_counter() - t0
        syncs = box["n"]
        reads = globalfit.host_reads.count - r0
        t0 = time.perf_counter()
        want = globalfit.GlobalFitter(make_set("cpu", key, starts[key]), opt).run(**kw)
        cpu_wall = time.perf_counter() - t0
        busy = None
        if profile:
            busy = device_profile(torch, lambda: globalfit.GlobalFitter(es, opt).run(**kw),
                                  cpu=False)[0]
        entry = dict(vars=",".join(opt), wall=wall, counts=dict(fit.counts), reads=reads,
                     busy=busy)
        name = f"{method} {','.join(opt)}"
        if syncs is not None:
            check(syncs == reads + fit.counts["uploads"],
                  f"{name}: {syncs} synchronising calls = {reads} host reads + "
                  f"{fit.counts['uploads']} parameter uploads (no hidden sync; made at "
                  f"{box['at']})")
        rtol = 1e-4 if method == "powell" else 1e-6
        gaps = [abs(got.diso / want.diso - 1), abs(got.aniso / want.aniso - 1),
                float(np.max(np.abs(got.csa - want.csa)) / np.max(np.abs(want.csa)))]
        check(max(gaps) <= rtol, f"{name}: Diso, Daniso, CSA within {rtol:g} of the CPU float64 "
                                 f"fit (gaps {gaps[0]:.2e}, {gaps[1]:.2e}, {gaps[2]:.2e})")
        # the truth: tests/test_globalfit.py's tolerances; 1e-2 after the
        # three rsCSA cycles (each shrinks the error by a share only)
        tg = abs(got.diso / diso_true - 1)
        cg = (float(np.max(np.abs(got.csa / csa_true - 1))) if key == "rs"
              else abs(got.aniso / MBP["aniso"] - 1))
        tol = (1e-2, 1e-2) if key == "rs" else (1e-3, 1e-2)
        check(tg <= tol[0] and cg <= tol[1],
              f"{name}: the truth (Diso gap {tg:.2e} <= {tol[0]:g}, "
              f"{'CSA' if key == 'rs' else 'Daniso'} gap {cg:.2e} <= {tol[1]:g})")
        print(f"  {name}: " + fit_line(entry, cpu_wall)
              + ("" if syncs is None else f"; {syncs} synchronising calls"), flush=True)
        out.append(dict(entry, method=method, cpu=cpu_wall, syncs=syncs))
    return out


# phase 10: the README's quick start through the port's command line on a
# raw, solvated ubiquitin-sized system (phase 7a's solute, first 5000
# frames; a cubic 6.0 nm box of 6 900 three-site waters, ~21 900 atoms)
RAW = dict(n_frames=5000, box=6.0, n_waters=6900, batch=256, drift=0.05, water_step=0.096,
           tau="2000")
FIELDS_CLI = ("600.133", "850.13")


def nn_order(x, start):
    """A greedy nearest-neighbour path through the points x (n, 3) from
    the point nearest ``start``: consecutive points close, as a protein's
    atom order follows its bonds."""
    import numpy as np

    left = np.ones(len(x), bool)
    cur, order = start, []
    for _ in range(len(x)):
        d = np.where(left, ((x - cur) ** 2).sum(1), np.inf)
        i = int(np.argmin(d))
        order.append(i)
        left[i] = False
        cur = x[i]
    return np.array(order)


def raw_system(torch, ubq, work: Path, dev="cuda") -> dict:
    """Phase 10's raw trajectory: phase 7a's solute (its first 5000
    frames; its 1018 shell atoms put in nearest-neighbour order, so that
    consecutive atoms lie well inside half the box, the -pbc mol contract)
    carried across images by a random-walk drift, in a cubic 6.0 nm box of
    6900 rigid three-site waters (liquid density) that diffuse ~0.1 nm a
    frame; every atom wrapped into the primary cell.  Made on the card,
    written as raw.xtc (boxes, 1e-3 nm precision) + system.pdb, and the
    solute's reference.pdb."""
    import numpy as np

    from spinrelax_tpu_torch.core import quaternion as qt
    from spinrelax_tpu_torch.io import native
    from spinrelax_tpu_torch.io import pdb as pdbio

    t0 = time.perf_counter()
    n_f, L, n_w = RAW["n_frames"], RAW["box"], RAW["n_waters"]
    sol, _, times = next(native.iter_xtc(str(ubq["xtc"]), n_f, threads=0))
    top, ref_xyz = pdbio.read_pdb(str(ubq["ref"]))
    n_ring = 3 * UBQ["n_res"]
    ref0 = ref_xyz[0]
    perm = np.concatenate([np.arange(n_ring), n_ring + nn_order(ref0[n_ring:], ref0[n_ring - 1])])
    sol, ref0 = np.ascontiguousarray(sol[:, perm]), ref0[perm]
    step = float(np.linalg.norm(np.diff(ref0, axis=0), axis=1).max())
    ref_fn = str(work / "reference.pdb")
    pdbio.write_pdb(ref_fn, top, ref0[None])
    gen = torch.Generator(device=dev).manual_seed(10)
    cell = L / 20
    g = torch.arange(20, device=dev, dtype=torch.float32)
    grid = torch.stack(torch.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    pos = (grid[torch.randperm(8000, generator=gen, device=dev)[:n_w]] + 0.5) * cell
    ang = np.deg2rad(104.52)
    geom = 0.09572 * torch.tensor([[0, 0, 0], [1, 0, 0], [np.cos(ang), np.sin(ang), 0]],
                                  device=dev, dtype=torch.float32)
    R = qt.quat_to_mat(qt.qnorm(torch.randn(n_w, 4, generator=gen, device=dev)))
    geom = torch.einsum("wij,aj->wai", R, geom)  # (n_w, 3, 3) a random orientation each
    drift = torch.cumsum(RAW["drift"] * torch.randn(n_f, 1, 3, generator=gen, device=dev),
                         dim=0)
    truth = sol + drift.cpu().numpy() + L / 2
    raw_fn, chunk = str(work / "raw.xtc"), 500
    boxes = np.zeros((chunk, 3, 3), np.float32)
    boxes[:, [0, 1, 2], [0, 1, 2]] = L
    for lo in range(0, n_f, chunk):
        hi = min(lo + chunk, n_f)
        steps = RAW["water_step"] * torch.randn(hi - lo, n_w, 3, generator=gen, device=dev)
        walk = pos + torch.cumsum(steps, dim=0)
        pos = walk[-1]
        wat = (walk[:, :, None, :] + geom[None]).reshape(hi - lo, 3 * n_w, 3)
        solc = torch.from_numpy(truth[lo:hi]).to(dev)
        raw = torch.remainder(torch.cat([solc, wat], dim=1), L).cpu().numpy()
        native.write_xtc(raw_fn, raw, times=times[lo:hi], boxes=boxes[: hi - lo],
                         append=lo > 0, step0=lo)
        if lo == 0:
            first = raw[:1]
    sys_top = pdbio.Topology(
        atom_names=list(top.atom_names) + ["OW", "HW1", "HW2"] * n_w,
        res_seqs=np.concatenate([top.res_seqs, np.repeat(1300 + np.arange(n_w), 3)]),
        res_names=list(top.res_names) + ["SOL"] * (3 * n_w),
        chain_ids=list(top.chain_ids) + ["W"] * (3 * n_w),
        occupancies=np.concatenate([top.occupancies, np.zeros(3 * n_w)]),
        elements=list(top.elements) + ["O", "H", "H"] * n_w)
    sys_fn = str(work / "system.pdb")
    pdbio.write_pdb(sys_fn, sys_top, first)
    n_atoms = sys_top.n_atoms
    print(f"  raw system: {sol.shape[1]} solute atoms + {n_w} waters = {n_atoms} atoms, "
          f"{n_f} frames, box {L} nm, {Path(raw_fn).stat().st_size / 1e6:.1f} MB .xtc, made in "
          f"{time.perf_counter() - t0:.1f} s; longest step between consecutive solute atoms "
          f"{step:.3f} nm (half the box {L / 2} nm)", flush=True)
    want = truth - truth.mean(axis=1, keepdims=True) + L / 2
    return dict(raw=raw_fn, sys=sys_fn, ref=ref_fn, want=want, n_atoms=n_atoms,
                n_solute=sol.shape[1])


def quiet(fn):
    """fn() with its standard output kept -> (its value, the output)."""
    import io

    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        out = fn()
    return out, log.getvalue()


def d_arg(d: Path) -> str:
    """relax's -D "Diso,Daniso" [1/ps] from a dq run's -aniso2.dat, by
    run-all's rule (Diso in s^-1 -> ps^-1; the long or short axis whose
    rhombicity is below one)."""
    h = dq_header(d / "rotdif-aniso2.dat")
    dani = h["Dani_L"] if h["Drho_L"] < 1.0 else h["Dani_S"]
    return f"{h['Diso'] * 1e-12:.9e},{dani:.9f}"


def rates_file(d: Path) -> str:
    """rho's input: resid R1 R2 NOE at the first field, from relax's files."""
    import numpy as np

    from spinrelax_tpu_torch.io import xvg

    m = [xvg.load_matrix(d / f"rotdif-600_{f}.dat") for f in ("R1", "R2", "NOE")]
    fn = d / "rates-600.dat"
    np.savetxt(fn, np.column_stack([m[0][:, 0]] + [x[:, 1] for x in m]), fmt="%.10g")
    return str(fn)


def chain_steps(sol: str, ref: str):
    """The quick start after center, as (name, argv of a run directory d)."""
    tau = RAW["tau"]
    ct = ["ct", "-s", ref, "-f", sol, "-t", tau, "--S2"]

    def relax(f):
        return lambda d, pref: ["relax", "-f", pref + "_fittedCt.dat", "--distfn",
                                pref + "_vecHistogram.npz", "-D", d_arg(d), "-F", f + "e6",
                                "-o", f"{pref}-{f.split('.')[0]}"]

    return [
        ("orient", lambda d, pref: ["orient", "-f", sol, "-s", ref, "-o",
                                    str(d / "colvar-qorient")]),
        ("dq", lambda d, pref: ["dq", "-f", str(d / "colvar-qorient"), "-o", pref, "--mindt",
                                "20", "--maxdt", tau, "--skip", "20", "--num_chunk", "4"]),
        ("ct", lambda d, pref: ct + ["-o", pref, "--Ct", "--vecHist"]),
        ("ct ired", lambda d, pref: ct + ["-o", str(d / "ired"), "--S2mode", "ired"]),
        ("ct wired --split 2", lambda d, pref: ct + ["-o", str(d / "wired"), "--S2mode", "wired",
                                                     "--split", "2"]),
        ("fit-ct", lambda d, pref: ["fit-ct", "-f", pref + "_Ctint.dat", "-o", pref]),
        ("fit-ct varpro", lambda d, pref: ["fit-ct", "-f", pref + "_Ctint.dat", "-o",
                                           str(d / "varpro"), "--optimiser", "varpro"]),
        ("relax 600.133", relax(FIELDS_CLI[0])),
        ("relax 850.13", relax(FIELDS_CLI[1])),
        ("rho", lambda d, pref: ["rho", "-f", rates_file(d), "-o", str(d / "rho.dat")]),
    ]


def phase_cli(torch, counters, ubq, work: Path, dev="cuda"):
    """Phase 10: python -m spinrelax_tpu_torch on a raw solvated system
    (10a: check, info, center) and the quick-start chain through cli.main
    on the card (10b), held to the known truth and to the CPU in float64."""
    print("phase 10: the command line on a raw solvated ubiquitin-sized system: (a) check, "
          "info and center as python -m spinrelax_tpu_torch; (b) orient -> dq -> ct (outer, "
          "iRED, wiRED) -> fit-ct -> relax -> rho through cli.main, vs the CPU in float64",
          flush=True)
    import os

    import numpy as np

    from spinrelax_tpu_torch.io import fittedct, native, xvg
    from spinrelax_tpu_torch.ops.pbc import center_solute
    from spinrelax_tpu_torch.io import pdb as pdbio
    from spinrelax_tpu_torch.pipeline import cli

    rs = raw_system(torch, ubq, work, dev)
    L, n_sol, batch = RAW["box"], rs["n_solute"], RAW["batch"]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = {}

    def module(*args):
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-m", "spinrelax_tpu_torch", *args], cwd=work,
                             env=env, capture_output=True, text=True, timeout=600)
        secs = time.perf_counter() - t0
        check(out.returncode == 0, f"python -m spinrelax_tpu_torch {args[0]} exited "
                                   f"{out.returncode} in {secs:.1f} s"
              + ("" if out.returncode == 0 else ": " + out.stderr[-1500:]))
        return out.stdout, secs

    # (a) the entry point
    log, secs = module("check")
    check("check PASSED" in log and "device cuda" in log,
          f"check found the card, the host libraries and J(omega) on it ({secs:.1f} s)")
    print("  " + "\n  ".join(ln for ln in log.splitlines() if "device" in ln), flush=True)
    log, secs = module("info", rs["raw"])
    check(f"{RAW['n_frames']} frames x {rs['n_atoms']} atoms" in log, "info: " + log.split("\n")[0])
    print(f"  info ({secs:.1f} s): {log.splitlines()[0]}", flush=True)
    center = ["center", "-f", rs["raw"], "-s", rs["sys"], "--output-group", "solute",
              "--batch", str(batch), "-o"]
    _, res["sub_wall"] = module(*center, str(work / "solute_sub.xtc"))
    sol = str(work / "solute.xtc")
    torch.cuda.reset_peak_memory_stats()
    (rc, _), wall = wall_s(torch, lambda: quiet(lambda: cli.main(center + [sol], device=dev)))
    peak = torch.cuda.max_memory_allocated() / 1e6
    check(rc == 0, "center through cli.main")
    busy, per = device_profile(
        torch, lambda: quiet(lambda: cli.main(center + [str(work / "solute_prof.xtc")],
                                              device=dev)))
    outs = [Path(work / f).read_bytes() for f in ("solute.xtc", "solute_sub.xtc",
                                                   "solute_prof.xtc")]
    check(outs[0] == outs[1] == outs[2], "center's three runs (python -m, cli.main, profiled) "
                                         "wrote the same bytes")
    # the host's parts: the decode (as center reads, all cores) and the encode
    t0 = time.perf_counter()
    n_read = sum(x.shape[0] for x, _, _ in native.iter_xtc(rs["raw"], batch, threads=0))
    t_dec = time.perf_counter() - t0
    out_xyz, out_box, out_t = native.read_xtc(sol, threads=0)
    t0 = time.perf_counter()
    for lo in range(0, len(out_xyz), batch):
        native.write_xtc(str(work / "encode.xtc"), out_xyz[lo : lo + batch],
                         times=out_t[lo : lo + batch], boxes=out_box[lo : lo + batch],
                         append=lo > 0, step0=lo)
    t_enc = time.perf_counter() - t0
    n_f = RAW["n_frames"]
    check(n_read == n_f == len(out_xyz), f"center read {n_read} and wrote {len(out_xyz)} frames")
    print(f"  center (cli.main, {n_f} frames x {rs['n_atoms']} atoms, batch {batch}): wall "
          f"{wall:.3f} s = {n_f / wall:.1f} frames/s (python -m {res['sub_wall']:.1f} s with the "
          f"interpreter's start); decode alone {t_dec:.3f} s = {t_dec / wall:.1%}, encode of the "
          f"solute alone {t_enc:.3f} s = {t_enc / wall:.1%}, repair + copies + the rest "
          f"{1 - (t_dec + t_enc) / wall:.1%}; device busy {busy:.2f} ms, idle share "
          f"{1 - busy / (wall * 1e3):.1%}; peak device memory {peak:.1f} MB", flush=True)
    # (i) the known truth
    err = float(np.abs(out_xyz - rs["want"]).max())
    check(out_xyz.shape == rs["want"].shape and err <= 2e-3,
          f"center: every solute atom of every frame within {err:.2e} nm of the unwrapped "
          f"solute recentred on the box centre (<= 2e-3: two XTC roundings)")
    # (ii) the port's CPU float64 center_solute on one batch of decoded frames
    top, _ = pdbio.read_pdb(rs["sys"])
    x, boxes, _ = next(native.iter_xtc(rs["raw"], batch, threads=0))
    box = np.einsum("fii->fi", boxes)
    card = center_solute(x, box, top=top, batch=batch, device=dev)
    again = center_solute(x, box, top=top, batch=batch, device=dev)
    t0 = time.perf_counter()
    cpu = center_solute(x.astype(np.float64), box, top=top, batch=batch, device="cpu")
    t_cpu = time.perf_counter() - t0
    check(np.array_equal(card, again), "center_solute: two card runs equal bit for bit")
    e_sol = float(np.abs(card[:, :n_sol] - cpu[:, :n_sol]).max())
    check(e_sol <= 1e-4, f"center_solute solute atoms max |card f32 - CPU f64| {e_sol:.2e} nm "
                         f"<= 1e-4")
    dd = card - cpu
    k = np.round(dd / L)
    e_mod = float(np.abs(dd - k * L).max())
    moved = np.abs(k[:, n_sol:]).reshape(batch, -1, 3, 3).sum(axis=(2, 3)) > 0
    check(e_mod <= 1e-4, f"center_solute every atom within {e_mod:.2e} nm of the CPU's modulo "
                         f"whole boxes (<= 1e-4)")
    print(f"  {int(moved.sum())} of {moved.size} water molecule-frames imaged one box away "
          f"from the CPU float64 repair (ties at cell faces); the CPU float64 repair of "
          f"{batch} frames took {t_cpu:.2f} s", flush=True)
    res.update(wall=wall, frames_s=n_f / wall, decode=t_dec, encode=t_enc, busy=busy,
               peak_mb=peak, err_truth=err, err_cpu=e_sol, moved=int(moved.sum()),
               molecule_frames=int(moved.size), kernels_center=len(per))

    # (b) the quick-start chain on the card and on the CPU in float64
    steps = chain_steps(sol, rs["ref"])
    dirs = {k: work / f"chain-{k}" for k in ("card", "prof", "cpu")}
    walls, launches, prof, cpu_walls = {}, {}, {}, {}
    for name, argv in steps:  # the card: walls and the wrappers' counts
        d = dirs["card"]
        d.mkdir(exist_ok=True)
        for c in counters:
            c.launches = 0
        (rc, _), walls[name] = wall_s(torch, lambda: quiet(lambda: cli.main(
            argv(d, str(d / "rotdif")), device=dev)))
        launches[name] = [c.launches for c in counters]
        check(rc == 0, f"{name} on the card")
    for name, argv in steps:  # the card again, profiled
        d = dirs["prof"]
        d.mkdir(exist_ok=True)
        n = launches[name]
        prof[name] = device_profile(torch, lambda: quiet(lambda: cli.main(
            argv(d, str(d / "rotdif")), device=dev)), lambda per: saw(per, A=n[0], **step_counts(n)))
    for name, argv in steps:  # the CPU, float64
        d = dirs["cpu"]
        d.mkdir(exist_ok=True)
        t0 = time.perf_counter()
        quiet(lambda: cli.main(argv(d, str(d / "rotdif")), device="cpu"))
        cpu_walls[name] = time.perf_counter() - t0
    for name, _ in steps:
        busy, per = prof[name]
        kt = kernel_times(per)
        seen = [kt.get(k, (0,))[0] for k in "ABCDE"]
        check(seen == launches[name], f"{name}: profiler saw kernels A/B/C/D/E {seen} times = "
                                      f"the wrappers' counts {launches[name]}")
        print(f"  {name}: wall {walls[name]:.3f} s (CPU float64 {cpu_walls[name]:.3f} s); "
              f"kernels A/B/C/D/E {launches[name]}; device busy {busy:.2f} ms, idle share "
              f"{1 - busy / (walls[name] * 1e3):.1%}", flush=True)
    total = [sum(v[i] for v in launches.values()) for i in range(5)]
    check(launches["ct"][0] == 2 and total[0] == 2,
          f"kernel A launched by ct only, twice (raw and superposed vectors): {total[0]}")
    fits = [launches[k][1:] for k in ("fit-ct", "fit-ct varpro")]
    check(lm_steps_ok([0] + fits[0]) and len(set(fits[1])) == 1
          and fits[0][0] + fits[1][0] == total[1] == total[2] == total[3] == total[4],
          f"kernels B, C, D and E launched by fit-ct ({fits[0][0]}) and fit-ct varpro's warm "
          f"retries ({fits[1][0]}) only, once a LM step: {total[1:]}")
    card, cpu = dirs["card"], dirs["cpu"]
    hc, hf = dq_header(card / "rotdif-aniso2.dat"), dq_header(cpu / "rotdif-aniso2.dat")
    for k in ("D_0", "D_1", "D_2", "Diso"):
        gap = abs(hc[k] - hf[k]) / abs(hf[k])
        check(gap <= 1e-6, f"dq {k} {hc[k]:.6e} s^-1, relative gap to CPU float64 {gap:.2e} "
                           f"<= 1e-6")
    for f in ("rotdif_Ctint.dat", "rotdif_Ctext.dat"):
        a, b = (xvg.load_sxydylist(d / f) for d in (card, cpu))
        e = float(abs(a[2] - b[2]).max())
        check(a[0] == b[0] and e <= 2e-6, f"ct {f} C(t) max abs vs CPU float64 {e:.3e} <= 2e-6")
    for f in ("ired_S2.dat", "wired_S2.dat"):
        a, b = (xvg.load_matrix(d / f) for d in (card, cpu))
        e = float(np.abs(a[:, 1] - b[:, 1]).max())
        check(a.shape == b.shape and np.isfinite(a).all() and e <= 1e-4,
              f"{f.split('_')[0]} S2 max abs vs CPU float64 {e:.3e} <= 1e-4 (float32 eigh of "
              f"{a.shape[0]} x {a.shape[0]} block matrices)")
        res[f.split("_")[0] + "_err"] = e
    for f in ("varpro_fittedCt.dat", "rotdif_fittedCt.dat"):  # rotdif's last: relax reads it
        rung = [fittedct.read_fittedct(str(d / f), device="cpu") for d in (card, cpu)]
        rung = [m.mask.sum(1) * 2 + m.s2fast for m in rung]
        same = (rung[0] == rung[1]).numpy()
        share = float(same.mean())
        check(share >= 0.98, f"fit-ct ({f}) rung equal to the CPU float64 ladder's on "
                             f"{share:.4f} of {len(same)} residues (>= 0.98)")
        res["rung_share_" + f.split("_")[0]] = share
    # rates: phase 8a's rule, |a - b| <= 1e-5 |b| + atol on residues of equal rung
    from spinrelax_tpu_torch.constants import GYROMAGNETIC_RATIOS

    kappa = abs(GYROMAGNETIC_RATIOS["1H"] / GYROMAGNETIC_RATIOS["15N"])
    worst = 0.0
    for f in [f"rotdif-{b.split('.')[0]}_{r}.dat" for b in FIELDS_CLI
              for r in ("R1", "R2", "NOE", "rho")] + ["rho.dat"]:
        a, b = (xvg.load_matrix(d / f)[:, 1] for d in (card, cpu))
        a, b = a[same], b[same]
        atol = 2e-5 * kappa if "NOE" in f else 1e-5 * np.abs(b).max()
        excess = float((np.abs(a - b) / (1e-5 * np.abs(b) + atol)).max())
        worst = max(worst, float((np.abs(a - b) / np.abs(b)).max()))
        check(np.isfinite(a).all() and excess <= 1.0,
              f"{f}: every value within 1e-5 |b| + atol of CPU float64 on the "
              f"{int(same.sum())} residues of equal rung ({excess:.3f} of the allowance)")
    res.update(walls=walls, launches=launches, total=total, busy_chain={
        k: v[0] for k, v in prof.items()}, cpu_walls=cpu_walls, rung_share=share,
        rate_gap_max=worst)
    return res


def phase_acf_stage_shapes(torch, tac, cuda_acf, gen):
    """Kernel A against acf_sums_plain (torch.fft) at the stage's shapes:
    1024 bonds in the stage's (chunk, frame, bond, 3) layout."""
    print("kernel A at the stage's chunk lengths (1024 bonds) vs acf_sums_plain (torch.fft)",
          flush=True)
    out = {}
    for key, F in (("f2000", 2000), ("f10000", 10_000)):
        D = F // 2
        v = unit(torch, (1, F, N_RES), gen).transpose(1, 2)  # (1, 1024, F, 3) view
        s = cuda_acf.acf_lag_sums(v, D)
        err = c_err(torch, s, tac.acf_sums_plain(v.double(), D).reshape(-1, D).T, F)
        check(err <= ACF_BOUND, f"A at F {F}, D {D}, B {N_RES}: max C(t) err {err:.3e} <= "
                                f"{ACF_BOUND}")
        t = out[key] = {"F": F, "D": D, "err": err}
        t["bound"], t["by"] = acf_bound(N_RES, F, D)
        t["ms"], t["plain"] = paired_ms(torch, lambda: cuda_acf.acf_lag_sums(v, D),
                                        lambda: tac.acf_sums_plain(v, D), reps=3)
        print(f"  time A at ({N_RES} bonds, F {F}, D {D}): kernel {t['ms']:.4f} ms, plain f32 "
              f"FFT {t['plain']:.4f} ms (kernel / FFT {t['ms'] / t['plain']:.2f}), bound "
              f"{t['bound']:.4f} ms ({t['by']}), {t['bound'] / t['ms']:.1%} of bound", flush=True)
        del v, s
    return out


# phase 11: the sharded paths (parallel/) on the one card, a one-rank NCCL
# group, each against its unsharded twin in this process
MF_TRUTH = dict(tau=4300.0, aniso=1.2)  # phase 11e's experiments


def nccl_ms(per) -> float:
    """Device ms of the NCCL kernels in a device_profile table."""
    return sum(ms for name, (_, ms) in per.items() if "nccl" in name.lower())


def same_dirs(a: Path, b: Path):
    """(same file names, [names whose bytes differ]) of two run directories,
    leaving out the manifest (it records the directory's paths) and the
    plot."""
    def files(d):
        return sorted(p.name for p in d.iterdir()
                      if p.is_file() and not p.name.endswith((".manifest.json", ".pdf")))

    fa, fb = files(a), files(b)
    return fa == fb and bool(fa), [f for f in fa if f in fb
                                   and (a / f).read_bytes() != (b / f).read_bytes()]


def phase_sharded(torch, counters, engine, vecs, stream4, finish6, ubq):
    """Phase 11: ShardedCtStream, make_sharded_forward, run_sharded_finish,
    the residue-sharded multi-field fit and the --devices command lines on
    a one-rank NCCL group at full width, each held to its unsharded twin."""
    print("phase 11: the sharded paths on a one-rank NCCL group (launch.start_one_rank), held "
          "to their unsharded twins", flush=True)
    import io

    import numpy as np

    from spinrelax_tpu_torch.constants import NucleusPair, field_from_mhz
    from spinrelax_tpu_torch.convert import forward_kwargs_from_jax
    from spinrelax_tpu_torch.fit import globalfit
    from spinrelax_tpu_torch.io import experiments, fittedct, vectors
    from spinrelax_tpu_torch.models.diffusion import Diffusion
    from spinrelax_tpu_torch.ops import autocorr as tac, observables
    from spinrelax_tpu_torch.parallel import launch
    from spinrelax_tpu_torch.parallel.fit import shard_experiment_set
    from spinrelax_tpu_torch.parallel.mesh import dims, make_mesh
    from spinrelax_tpu_torch.parallel.pipeline import (
        fit_to_rates, make_forward, make_sharded_forward)
    from spinrelax_tpu_torch.parallel.streamed import (
        ShardedCtStream, run_finish, run_sharded_finish)
    from spinrelax_tpu_torch.pipeline import cli

    gpu = gpu_line()
    t0 = time.perf_counter()
    launch.start_one_rank("cuda")
    mesh = make_mesh(1, device="cuda")
    print(f"  one-rank NCCL group and mesh {dims(mesh)} in {time.perf_counter() - t0:.2f} s",
          flush=True)
    out = {}

    def reset():
        for c in counters:
            c.launches = 0

    def read():
        return [c.launches for c in counters]

    def sub_line(name, wall, launches, busy, extra=""):
        print(f"  {name}: wall {wall:.4f} s, launches A/B/C/D/E {launches}, device busy "
              f"{busy:.2f} ms, idle share {1 - busy / (wall * 1e3):.1%}{extra} on {gpu}",
              flush=True)

    # 11a: the stream over phase 4's ten groups
    axis, acc4, count4, rmean = stream4["axis"], stream4["acc"], stream4["count"], stream4["rmean"]

    def group(g):
        return torch.nn.functional.normalize(axis + 0.6 * vecs.roll(g, dims=2), dim=-1)

    stream = ShardedCtStream(mesh, N_FRAMES, N_RES, dtype=torch.float32)
    reset()
    walls = []
    for g in range(10):
        grp = group(g)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stream.update(grp)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        del grp
    launches = read()
    check(launches[0] == 10, f"11a: ShardedCtStream launched kernel A {launches[0]} times "
                             f"in 10 groups")
    acc_s, acc_s2, count = stream.accumulators()
    check(int(count) == count4, f"11a: {int(count)} chunks streamed = phase 4's {count4}")
    gaps = [float((a - b).abs().max() / b.abs().max()) for a, b in zip((acc_s, acc_s2), acc4)]
    check(max(gaps) <= 1e-6, f"11a: accumulators within {max(gaps):.2e} (<= 1e-6, relative to "
                             f"their largest) of phase 4's unsharded stream")
    Ct, dCt = stream.finalize()
    err = float((Ct.double() - rmean).abs().max())
    check(err <= 2e-6, f"11a: C(t) max abs err {err:.3e} <= 2e-6 against float64")
    grp = group(0)
    scratch = ShardedCtStream(mesh, N_FRAMES, N_RES, dtype=torch.float32)
    tick = torch.zeros((), device="cuda")

    def update():
        # a one-element kernel first: with kernel A the first device event
        # of the profile, the profiler lost it in each of three tries
        tick.add_(1.0)
        scratch.update(grp)

    busy, per = device_profile(torch, update, lambda per: saw(per, A=1))
    del grp, scratch
    a_prof = kernel_times(per).get("A", (0, 0.0))
    check(a_prof[0] == 1, f"11a: the profiler saw kernel A {a_prof[0]} times in one update")
    wall = sorted(walls[1:])[4]
    share = nccl_ms(per) / busy
    # one all-reduce's host-clock cost at one rank: 200 of a 0-d tensor
    x = torch.zeros((), device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        torch.distributed.all_reduce(x)
    torch.cuda.synchronize()
    ar_us = (time.perf_counter() - t0) / 200 * 1e6
    sub_line("11a ShardedCtStream.update (32 x 1000 x 1024)", wall, launches, busy,
             f" (profiled update); median of 9 groups; kernel A {a_prof[1]:.2f} us; the "
             f"three all-reduces {nccl_ms(per) * 1e3:.2f} us = {share:.2%} of the busy time; "
             f"an all-reduce of a 0-d tensor {ar_us:.1f} us on the host clock; "
             f"accumulators within {max(gaps):.2e} of phase 4's; C(t) {err:.2e} of float64")
    out["11a"] = dict(wall=wall, launches=launches, busy=busy, allreduce_share=share,
                      allreduce_us=ar_us)

    # 11b: the sharded forward against the forward of phase 3
    kw = dict(tau_iso=4242.0, delta_t=1.0, n_components=2)
    fwd, sfwd = make_forward(**kw), make_sharded_forward(mesh, **kw)
    ref = fwd(vecs)
    reset()
    got, _ = wall_s(torch, lambda: sfwd(vecs))
    launches = read()
    check(launches[0] == 1 and lm_steps_ok(launches),
          f"11b: sharded forward launched A/B/C/D/E {launches}")
    w_plain, w_shard = [], []
    for _ in range(3):  # in turns
        w_plain.append(wall_s(torch, lambda: fwd(vecs))[1])
        w_shard.append(wall_s(torch, lambda: sfwd(vecs))[1])
    busy, _ = device_profile(torch, lambda: sfwd(vecs))
    err = float((got.Ct.double() - ref.Ct.double()).abs().max())
    check(err <= 2e-6, f"11b: Ct max abs vs the unsharded forward {err:.3e} <= 2e-6")
    # At one rank the sharding is the identity: every output, on every
    # residue, equals bit for bit the one-card forward that pools the same
    # shifted sums (ops.autocorr.stream_accumulate, the streamed stage's).
    acc = tac.stream_accumulate([vecs], vecs.shape[1])
    one = fit_to_rates(*tac.palmer_pooled_stats(acc[0], acc[1], float(acc[2])),
                       **forward_kwargs_from_jax(**kw))
    for k in one._fields:
        check(torch.equal(getattr(got, k), getattr(one, k)),
              f"11b: {k} equal bit for bit to the one-card forward over pooled sums")
    # Phase 3's forward takes the chunks' mean and std instead, which round
    # apart (C(t) by up to 2.2e-7): a float32 fit that rounding moves to
    # another point of a flat valley moves its rates (on an H100, 11-16 %
    # of residues by more than 1e-4), so the rates are held to it at phase
    # 3's tolerance, the median.
    for k in ("R1", "R2", "NOE", "rho"):
        a, b = getattr(got, k).double(), getattr(ref, k).double()
        check(bool(torch.isfinite(a).all()), f"11b: {k} finite")
        gap = rel_gap(a, b)
        check(float(gap.median()) < 1e-4,
              f"11b: {k} median relative gap to phase 3's forward {float(gap.median()):.3e} "
              f"< 1e-4 (max {float(gap.max()):.3e})")
    wall = sorted(w_shard)[1]
    sub_line("11b make_sharded_forward (32 x 1000 x 1024, K 2)", wall, launches, busy,
             f"; unsharded twin {sorted(w_plain)[1]:.4f} s (medians of 3, in turns)")
    out["11b"] = dict(wall=wall, wall_plain=sorted(w_plain)[1], launches=launches, busy=busy)
    del ref, got

    # 11c: the sharded finish on 11a's accumulators against phase 6's finish
    fkw = finish6["kw"]
    reset()
    got, _ = wall_s(torch, lambda: run_sharded_finish(mesh, acc_s, acc_s2, count, **fkw))
    launches = read()
    check(lm_steps_ok(launches),
          f"11c: sharded finish launched B/C/D/E {launches[1:]}")
    w_plain, w_shard = [], []
    for _ in range(3):
        w_plain.append(wall_s(torch, lambda: run_finish(*acc4, count4, **fkw))[1])
        w_shard.append(wall_s(torch, lambda: run_sharded_finish(
            mesh, acc_s, acc_s2, count, **fkw))[1])
    busy, _ = device_profile(torch, lambda: run_sharded_finish(mesh, acc_s, acc_s2, count, **fkw))
    twin, cpu = finish6["out"], finish6["ref"]
    same = (rung_of(got.cts) == rung_of(twin.cts))
    share = float(same.double().mean())
    check(share >= 0.98, f"11c: rung equal to phase 6's on {share:.4f} of rows (>= 0.98)")
    for f in ("R1", "R2", "NOE", "rho", "dR1", "dR2", "dNOE", "drho"):
        a, b = getattr(got, f).double().cpu(), getattr(twin, f).double().cpu()
        gap = float(rel_gap(a[same], b[same]).max())
        check(gap <= 1e-5, f"11c: {f} within {gap:.2e} (<= 1e-5) of phase 6's on equal rungs")
    for f in ("R1", "R2", "NOE", "rho"):
        med = float(rel_gap(getattr(got, f).double().cpu(), getattr(cpu, f)).median())
        check(med < 1e-4, f"11c: {f} median relative gap to the CPU float64 finish {med:.3e}")
    wall = sorted(w_shard)[1]
    sub_line("11c run_sharded_finish (1024 residues, 64 samples)", wall, launches, busy,
             f"; unsharded twin {sorted(w_plain)[1]:.4f} s; rung equal on {share:.4f}")
    out["11c"] = dict(wall=wall, wall_plain=sorted(w_plain)[1], launches=launches, busy=busy)

    # 11d: the residue-sharded multi-field fit at phase 9b's size
    mbp = mbp_system(torch)
    make_set, start = mbp["make_set"], mbp["starts"]["flat"]
    es = make_set("cuda", "flat", start)
    p = (torch.tensor(start[0], dtype=torch.float64, device="cuda"),
         torch.tensor(start[1], dtype=torch.float64, device="cuda"), mbp["cts"]["cuda"].zeta,
         torch.full((es.n_residues,), NucleusPair().csa_value, dtype=torch.float64,
                    device="cuda"))
    es_sh = shard_experiment_set(es, mesh)
    a, b = float(globalfit.chisq_total(es_sh, *p)), float(globalfit.chisq_total(es, *p))
    check(abs(a / b - 1) <= 1e-10, f"11d: chisq_total sharded {a:.12g} = unsharded {b:.12g} "
                                   f"(gap {abs(a / b - 1):.2e} <= 1e-10)")
    out["11d"] = {}
    for method, rtol in (("device", 1e-6), ("powell", 1e-4)):
        es = make_set("cuda", "flat", start)  # each set made outside the timed fits
        sh = shard_experiment_set(make_set("cuda", "flat", start), mesh)
        sh.device_arrays()
        sh.symmtop_a_moments_device()

        def fit(s):
            return wall_s(torch, lambda: globalfit.GlobalFitter(s, ["Diso", "Daniso"]).run(
                method=method))

        # in turns: unsharded, sharded, sharded, unsharded; each wall the mean of two
        want, w0 = fit(es)
        reset()
        got, w1 = fit(sh)
        launches = read()
        (_, w2), (_, w3) = fit(sh), fit(es)
        wall, w_plain = (w1 + w2) / 2, (w0 + w3) / 2
        busy, _ = device_profile(torch, lambda: globalfit.GlobalFitter(
            sh, ["Diso", "Daniso"]).run(method=method), cpu=False)
        gaps = [abs(got.diso / want.diso - 1), abs(got.aniso / want.aniso - 1)]
        check(max(gaps) <= rtol, f"11d {method}: Diso, Daniso within {rtol:g} of the unsharded "
                                 f"card fit (gaps {gaps[0]:.2e}, {gaps[1]:.2e})")
        sub_line(f"11d GlobalFitter {method} Diso,Daniso, sharded 370 x 2592", wall, launches,
                 busy, f"; unsharded twin {w_plain:.4f} s")
        out["11d"][method] = dict(wall=wall, wall_plain=w_plain, busy=busy)

    # 11e: the command lines with and without --devices 1 write the same bytes
    root = Path(ubq["dir"]) / "sharded"
    root.mkdir(exist_ok=True)
    tau = str(UBQ["tau"])

    def ct(d):
        return ["ct", "-s", ubq["ref"], "-f", ubq["xtc"], "-t", tau, "--Ct", "--S2",
                "--vecHist", "--split", "2", "-o", str(d / "u")]

    def fit_ct(d):
        return ["fit-ct", "-f", str(d / "u_Ctint.dat"), "-o", str(d / "u")]

    def multifield(d):
        return ["multifield", *sorted(str(q) for q in root.glob("expt_*.dat")), "-f",
                str(d / "u_fittedCt.dat"), "--distfn", str(d / "u_vecHistogram.npz"), "--tau",
                str(MF_TRUTH["tau"] * 1.1), "--aniso", str(MF_TRUTH["aniso"]), "--opt", "Diso",
                "--method", "device", "-o", str(d / "mf")]

    def run_all(d):
        return ["run-all", "-sxtc", ubq["xtc"], "-refpdb", ubq["ref"], "-t_mem", tau,
                "-num_chunks", "4", "-Bfields", "600.133", "-stream", "2", "-out",
                str(d / "rotdif"), "-qfile", str(d / "colvar-qorient")]

    def experiments_at_truth(d):
        """R1, R2, NOE at 600.133 MHz from the plain run's fitted C(t) and
        vectors at a truth, 2 % errors, for multifield."""
        cts = fittedct.read_fittedct(str(d / "u_fittedCt.dat"), device="cpu")
        names, v, w = vectors.load_vector_distribution(str(d / "u_vecHistogram.npz"))
        r = observables.predict_rates_newapi(
            NucleusPair(B0=field_from_mhz(600.133), time_unit="ps"),
            Diffusion.axisymmetric(tau=MF_TRUTH["tau"], aniso=MF_TRUTH["aniso"]),
            cts.with_zeta(0.890023), vecs=v, weights=w)
        for t in ("R1", "R2", "NOE"):
            y = getattr(r, t).numpy()
            experiments.write_experiment(str(root / f"expt_{t}.dat"), experiments.ExperimentData(
                t, "15N", "1H", 600.133, "MHz", np.asarray(names), y, 0.02 * np.abs(y)))

    plain, sharded = root / "plain", root / "devices1"
    plain.mkdir(exist_ok=True)
    sharded.mkdir(exist_ok=True)
    out["11e"] = {}
    for name, argv, need in (("ct --split 2", ct, (0,)), ("fit-ct", fit_ct, (1, 2, 3, 4)),
                             ("multifield --opt Diso --method device", multifield, ()),
                             ("run-all -stream 2", run_all, (0, 1, 2, 3, 4))):
        flag = "-devices" if name.startswith("run-all") else "--devices"
        box = {}

        def run_sharded():
            reset()
            box["wall"] = wall_s(torch, lambda: cli.main(argv(sharded) + [flag, "1"],
                                                         device="cuda"))[1]
            box["launches"] = read()

        with contextlib.redirect_stdout(io.StringIO()):
            _, w_plain = wall_s(torch, lambda: cli.main(argv(plain), device="cuda"))
            # one profiled run (the card's activity only): its wall, launches, busy
            busy, _ = device_profile(torch, run_sharded, cpu=False)
        wall, launches = box["wall"], box["launches"]
        if name == "fit-ct":
            experiments_at_truth(plain)
        for k in need:
            check(launches[k] > 0, f"11e {name} {flag} 1: kernel {'ABCDE'[k]} launched "
                                   f"{launches[k]} times")
        names_ok, differ = same_dirs(plain, sharded)
        check(names_ok and not differ, f"11e {name}: with and without {flag} 1 the same files "
                                       f"and bytes (differ: {differ})")
        sub_line(f"11e {name} {flag} 1", wall, launches, busy,
                 f" (profiled run); without the flag {w_plain:.4f} s; same bytes "
                 f"{names_ok and not differ}")
        out["11e"][name] = dict(wall=wall, wall_plain=w_plain, launches=launches)
    return out


def sharded_launches(r, k: int) -> dict:
    """Kernel ``k``'s launches (0 A, 1 B, 2 C, 3 D, 4 E) on each of phase 11's paths."""
    out = {f"launches_sharded_{key}": r[sub]["launches"][k]
           for key, sub in (("stream", "11a"), ("forward", "11b"), ("finish", "11c"))}
    for name, v in r["11e"].items():
        out["launches_sharded_" + name.split()[0].replace("-", "_")] = v["launches"][k]
    return out


def sharded_line(r) -> str:
    """Phase 11's walls, sharded against unsharded, on one line."""
    return ("sharded (one-rank NCCL group): stream update "
            f"{r['11a']['wall'] * 1e3:.3f} ms (all-reduces {r['11a']['allreduce_share']:.2%} "
            f"of busy; {r['11a']['allreduce_us']:.1f} us each on the host), forward {r['11b']['wall']:.4f} s (unsharded {r['11b']['wall_plain']:.4f}), "
            f"finish {r['11c']['wall']:.4f} s (unsharded {r['11c']['wall_plain']:.4f}), "
            + ", ".join(f"fit {k} {v['wall']:.3f} s (unsharded {v['wall_plain']:.3f})"
                        for k, v in r["11d"].items())
            + ", " + ", ".join(f"{k} --devices 1 {v['wall']:.3f} s (without {v['wall_plain']:.3f})"
                               for k, v in r["11e"].items()))


def main() -> int:
    """All phases (no arguments), or phase 5b or phase 11 alone
    (``chip_smoke.py 5b``, ``chip_smoke.py 11``: no kernels line and no
    result line)."""
    if not (REPO / "spinrelax_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: spinrelax_tpu_torch/ is not beside this script; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU",
              file=sys.stderr)
        return 3
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from spinrelax_tpu_torch import _build
    from spinrelax_tpu_torch.entry import correlated_walk, hetero_cohort, paf_ensemble
    from spinrelax_tpu_torch.fit import engine, lm
    from spinrelax_tpu_torch.fit.expfit import fit_ct_ladder
    from spinrelax_tpu_torch.fit.lm import fit_multiexp
    from spinrelax_tpu_torch.models.diffusion import Diffusion
    from spinrelax_tpu_torch.ops import autocorr as tac
    from spinrelax_tpu_torch.ops import cuda_acf, cuda_lm
    from spinrelax_tpu_torch.parallel.pipeline import make_forward
    from spinrelax_tpu_torch.parallel.streamed import run_finish

    t_start = t0 = time.perf_counter()
    _build.load(verbose=True)  # ptxas: registers, shared memory, spills
    print(f"built {_build.library_path().name} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    print(sys.version.split()[0], torch.__version__, torch.version.cuda, flush=True)
    counters = (cuda_acf.acf_lag_sums, cuda_lm.hgc_cuda, cuda_lm.cost_cuda,
                cuda_lm.step_solve_cuda, cuda_lm.step_gate_cuda)  # A .. E
    if sys.argv[1:] == ["5b"]:  # phase 5b alone: no result lines
        phase_ladder_5b(torch, counters, engine, lm, hetero_cohort, fit_ct_ladder)
        print(f"phase 5b took {time.perf_counter() - t_start:.1f} s, build included on "
              f"{gpu_line()}", flush=True)
        if failures:
            print(f"chip_smoke 5b FAILED ({len(failures)}):", *failures, sep="\n  ",
                  file=sys.stderr)
        return 1 if failures else 0
    gen = torch.Generator(device="cuda").manual_seed(20261016)
    t0 = time.perf_counter()
    vecs = torch.from_numpy(correlated_walk(N_REP, N_FRAMES, N_RES, seed=0)).cuda()
    if sys.argv[1:] == ["11"]:  # phase 11 alone, on phases 4 and 6's data: no result lines
        _, acc, count, axis, rmean = phase_stream(torch, tac, cuda_acf, vecs, gen)
        finish = phase_finish(torch, counters, engine, run_finish, Diffusion, paf_ensemble,
                              acc, count)
        with tempfile.TemporaryDirectory() as work:
            sharded = phase_sharded(torch, counters, engine, vecs,
                                    dict(acc=acc, count=count, axis=axis, rmean=rmean), finish,
                                    ubiquitin_system(Path(work)))
        from spinrelax_tpu_torch.parallel import launch

        launch.stop()
        print(f"phase 11 took {time.perf_counter() - t_start:.1f} s, build and phases 4, 6 "
              f"included, on {gpu_line()}: {sharded_line(sharded)}", flush=True)
        if failures:
            print(f"chip_smoke 11 FAILED ({len(failures)}):", *failures, sep="\n  ",
                  file=sys.stderr)
        return 1 if failures else 0
    print(f"input: correlated walk {tuple(vecs.shape)} float32 "
          f"({vecs.numel() * 4 / 1e6:.0f} MB) in {time.perf_counter() - t0:.1f} s",
          flush=True)

    a_err, a_times = phase_acf(torch, tac, cuda_acf, vecs, gen)
    b_err, c_err_, lm_times = phase_lm(torch, cuda_lm, gen)
    d_err = phase_step(torch, cuda_lm, lm_times)
    launches, fwd_s, busy_ms, fwd_eager_s, busy_eager_ms = phase_forward(
        torch, tac, counters, engine, make_forward, fit_multiexp, vecs)
    step_ms, acc, count, axis, rmean = phase_stream(torch, tac, cuda_acf, vecs, gen)
    stream4 = dict(acc=acc, count=count, axis=axis, rmean=rmean)
    ladder = phase_ladder(torch, counters, engine, hetero_cohort, fit_ct_ladder)
    ladder5b = phase_ladder_5b(torch, counters, engine, lm, hetero_cohort, fit_ct_ladder)
    finish = phase_finish(torch, counters, engine, run_finish, Diffusion, paf_ensemble, acc, count)
    a_stage = phase_acf_stage_shapes(torch, tac, cuda_acf, gen)
    with tempfile.TemporaryDirectory() as work:
        ubq = ubiquitin_system(Path(work))
        stage = phase_stage(torch, tac, cuda_acf, counters, gen, ubq)
        wf = phase_runall(torch, counters, ubq)
        dq_long = phase_dq_long(torch, Path(work))
        fit = phase_fit(torch, counters, wf)
        # before phase 10, which writes its own solute.xtc and reference.pdb
        # over phase 7a's
        sharded = phase_sharded(torch, counters, engine, vecs, stream4, finish, ubq)
        del vecs, acc, stream4
        cli_run = phase_cli(torch, counters, ubq, Path(work))
    fit_large = phase_fit_large(torch)
    from spinrelax_tpu_torch.parallel import launch

    launch.stop()  # the one-rank NCCL group of phase 11

    print(f"chip_smoke phases took {time.perf_counter() - t_start:.1f} s, build included",
          flush=True)
    gpu = gpu_line()
    fwd_t, rung = lm_times["fwd"], lm_times["rung"]
    print(f"timings on {gpu}: A kernel {a_times['chunks']:.4f} ms (pretiled "
          f"{a_times['pretiled']:.4f}, contiguous {a_times['contiguous']:.4f}) vs plain "
          f"{a_times['plain']:.4f} ms; "
          f"B {fwd_t['B']:.5f} vs {fwd_t['B_plain']:.5f} ms; "
          f"C {fwd_t['C']:.5f} vs {fwd_t['C_plain']:.5f} ms ({fwd_t['shape']}); "
          f"B {rung['B']:.5f} ms, C {rung['C']:.5f} ms ({rung['shape']}); D/E "
          f"{fwd_t['D']:.5f}/{fwd_t['E']:.5f} ms (plain {fwd_t['D_plain']:.5f}/"
          f"{fwd_t['E_plain']:.5f}; {fwd_t['shape']}), {rung['D']:.5f}/{rung['E']:.5f} ms "
          f"({rung['shape']}), K 5 {lm_times['k5']['D']:.5f}/{lm_times['k5']['E']:.5f} ms, K 8 "
          f"{lm_times['k8']['D']:.5f}/{lm_times['k8']['E']:.5f} ms; forward "
          f"{fwd_s * 1e3:.2f} ms, device busy {busy_ms:.2f} ms (eager loop "
          f"{fwd_eager_s * 1e3:.2f} / {busy_eager_ms:.2f} ms); group step "
          f"{step_ms:.4f} ms; A slab plan {a_times['long']:.4f} ms; B/C at K 5 "
          f"{lm_times['k5']['B']:.5f}/{lm_times['k5']['C']:.5f} ms, K 8 "
          f"{lm_times['k8']['B']:.5f}/{lm_times['k8']['C']:.5f} ms; ladder "
          f"{ladder['wall']:.3f} s, device busy {ladder['busy']:.2f} ms (eager loop "
          f"{ladder['wall_eager']:.3f} s / {ladder['busy_eager']:.2f} ms); "
          + "; ".join(f"{k} ladder {v['wall']:.3f} s, device busy {v['busy']:.2f} ms (eager "
                      f"loop {v['wall_eager']:.3f} s)" for k, v in ladder5b.items()
                      if k != "legacy_wall")
          + f"; do_expstyle_fit(5) on {N_RES} curves {ladder5b['legacy_wall']:.3f} s; finish "
          f"{finish['wall']:.3f} s, device busy {finish['busy']:.2f} ms (eager loop "
          f"{finish['wall_eager']:.3f} s / {finish['busy_eager']:.2f} ms); A at the stage's "
          f"shapes F 2000 {a_stage['f2000']['ms']:.4f} ms (FFT {a_stage['f2000']['plain']:.4f}), "
          f"F 10000 {a_stage['f10000']['ms']:.4f} ms (FFT {a_stage['f10000']['plain']:.4f}); "
          f"stage on {stage['frames']} frames {stage['wall']:.3f} s (decode + reduce "
          f"{stage['host']:.3f} s); stage group step {stage['step_ms']:.3f} ms, eigh "
          f"{stage['eigh_ms']:.3f} ms; ct_entry {stage['entry_wall']:.3f} s; stage writer "
          f"{stage['write']:.3f} s (numpy rows {stage['rows']:.3f}); run-all {wf['wall']:.3f} s, "
          f"device busy {wf['busy']:.2f} ms; Delta-q on 10^6 frames: statistics "
          f"{dq_long['stats']:.3f} s ({dq_long['rate']:.4e} frames/s), stage in memory "
          f"{dq_long['memory']:.3f} s, streamed {dq_long['streamed']:.3f} s; run-all -fit from "
          f"the .xtc {fit['wall_fresh']:.3f} s, the fits on the card {fit['card_wall']:.3f} s "
          f"(CPU {fit['cpu_wall']:.3f} s), legacy "
          + ", ".join(f"{k} {v['wall']:.3f} s" for k, v in fit["legacy"].items())
          + f"; GlobalFitter at {MBP['n_res']} x {MBP['n_samp']}: "
          + ", ".join(f"{e['method']} {e['vars']} {e['wall']:.3f} s (CPU {e['cpu']:.3f})"
                      for e in fit_large)
          + f"; center on {RAW['n_frames']} frames {cli_run['wall']:.3f} s "
          f"({cli_run['frames_s']:.1f} frames/s), the quick-start chain "
          + ", ".join(f"{k} {v:.3f} s" for k, v in cli_run["walls"].items())
          + "; " + sharded_line(sharded), flush=True)
    if failures:
        print(f"chip_smoke FAILED ({len(failures)}):", *failures, sep="\n  ",
              file=sys.stderr)
        return 1
    src = "spinrelax_tpu_torch/csrc/"
    k5, k8 = lm_times["k5"], lm_times["k8"]
    kernels = [
        dict(name="acf_lag_sums", route="cuda", source=src + "acf_lag_sums.cu",
             replaces="spinrelax_tpu/ops/pallas_acf.py:454", launches=launches[0],
             launches_per_forward=launches[0], max_abs_err=a_err, tolerance=ACF_BOUND,
             ms=a_times["chunks"], plain_ms=a_times["plain"], bound_ms=a_times["bound"],
             bound_by=a_times["by"], library_ms=None, launches_ladder=ladder["launches"][0],
             launches_ladder_varpro=ladder5b["varpro"]["launches"][0],
             launches_ladder_stacked=ladder5b["stacked"]["launches"][0],
             launches_finish=finish["launches"][0], slab_plan_ms=a_times["long"],
             slab_plan_plain_ms=a_times["long_plain"], slab_plan_bound_ms=a_times["long_bound"],
             slab_plan_bound_by=a_times["long_by"],
             launches_stage=stage["launches"][0], launches_ct_entry=stage["launches_entry"][0],
             launches_runall=wf["launches"][0], launches_runall_fit=fit["launches"][0],
             launches_cli=cli_run["total"][0],
             **sharded_launches(sharded, 0),
             **{f"stage_{k}_{f}": t[x] for k, t in a_stage.items()
                for f, x in (("ms", "ms"), ("plain_ms", "plain"), ("bound_ms", "bound"),
                             ("bound_by", "by"), ("max_abs_err", "err"))}),
        dict(name="lm_hgc", route="cuda", source=src + "lm_hgc.cu",
             replaces="spinrelax_tpu/ops/pallas_lm.py:127", launches=launches[1],
             launches_per_forward=launches[1], max_abs_err=b_err,
             tolerance="rtol 3e-5 + atol 1e-4 (H), 1e-3 (g); rtol 1e-5 (cost)",
             ms=fwd_t["B"], plain_ms=fwd_t["B_plain"], bound_ms=fwd_t["B_bound"],
             bound_by=fwd_t["B_by"], library_ms=None, launches_ladder=ladder["launches"][1],
             launches_ladder_varpro=ladder5b["varpro"]["launches"][1],
             launches_ladder_stacked=ladder5b["stacked"]["launches"][1],
             launches_finish=finish["launches"][1],
             launches_ct_entry=stage["launches_entry"][1], launches_runall=wf["launches"][1],
             launches_runall_fit=fit["launches"][1], launches_cli=cli_run["total"][1],
             **sharded_launches(sharded, 1),
             **{f"{k}_{f}": t[x] for k, t in (("k5", k5), ("k8", k8))
                for f, x in (("ms", "B"), ("plain_ms", "B_plain"), ("bound_ms", "B_bound"))}),
        dict(name="lm_cost", route="cuda", source=src + "lm_hgc.cu",
             replaces="spinrelax_tpu/ops/pallas_lm.py:169", launches=launches[2],
             launches_per_forward=launches[2], max_abs_err=c_err_, tolerance="rtol 1e-5",
             ms=fwd_t["C"], plain_ms=fwd_t["C_plain"], bound_ms=fwd_t["C_bound"],
             bound_by=fwd_t["C_by"], library_ms=None, launches_ladder=ladder["launches"][2],
             launches_ladder_varpro=ladder5b["varpro"]["launches"][2],
             launches_ladder_stacked=ladder5b["stacked"]["launches"][2],
             launches_finish=finish["launches"][2],
             launches_ct_entry=stage["launches_entry"][2], launches_runall=wf["launches"][2],
             launches_runall_fit=fit["launches"][2], launches_cli=cli_run["total"][2],
             **sharded_launches(sharded, 2),
             **{f"{k}_{f}": t[x] for k, t in (("k5", k5), ("k8", k8))
                for f, x in (("ms", "C"), ("plain_ms", "C_plain"), ("bound_ms", "C_bound"))}),
    ]
    for k, name, err, tol in (
            ("D", "lm_step_solve", d_err,
             f"t_new, trial parameters, norms within rtol {STEP_TOL['rtol']} + atol "
             f"{STEP_TOL['atol']} of plain on >= {STEP_TOL['share']} of lanes, NaN on "
             f"the same lanes; error vs float64 <= 2 x plain's"),
            ("E", "lm_step_gate", 0.0, "bit for bit")):
        i = "ABCDE".index(k)
        kernels.append(dict(
            name=name, route="cuda", source=src + "lm_step.cu",
            replaces="spinrelax_tpu/fit/engine.py:181 (_engine_jit's loop body; XLA "
                     "fusions, no pallas_call)",
            launches=launches[i], launches_per_forward=launches[i], max_abs_err=err,
            tolerance=tol, ms=fwd_t[k], plain_ms=fwd_t[k + "_plain"],
            bound_ms=fwd_t[k + "_bound"], bound_by=fwd_t[k + "_by"], library_ms=None,
            launches_ladder=ladder["launches"][i],
            launches_ladder_varpro=ladder5b["varpro"]["launches"][i],
            launches_ladder_stacked=ladder5b["stacked"]["launches"][i],
            launches_finish=finish["launches"][i],
            launches_ct_entry=stage["launches_entry"][i], launches_runall=wf["launches"][i],
            launches_runall_fit=fit["launches"][i], launches_cli=cli_run["total"][i],
            **sharded_launches(sharded, i),
            **{f"{key}_{f}": t[x] for key, t in (("rung", rung), ("k5", k5), ("k8", k8))
               for f, x in (("ms", k), ("plain_ms", k + "_plain"), ("bound_ms", k + "_bound"))},
            # per launch as torch.profiler reads it (the in-situ times' measure)
            **{f"{key}_profiled_us": t[k + "_prof_us"]
               for key, t in (("fwd", fwd_t), ("rung", rung), ("k5", k5), ("k8", k8))},
            # D only: torch.linalg.cholesky_ex + cholesky_solve on D's damped
            # matrices, the solve alone (a yardstick; never on the path)
            **({f"{key}_solve_library_ms": t["D_solve_library"]
                for key, t in (("fwd", fwd_t), ("rung", rung), ("k5", k5), ("k8", k8))}
               if k == "D" else {})))
    print(gpu)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
