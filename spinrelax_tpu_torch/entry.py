"""The forward step's example input, a torch twin of
``__graft_entry__.entry()``; :func:`finish_entry`, which runs the
streamed finish (DoF ladder -> diffusion J(omega) -> ensemble rates); and
:func:`ct_entry`, which goes from a trajectory file to rates: a synthetic
.pdb + .xtc (:func:`synthetic_system`) through the streamed C(t) stage
into the finish.

:func:`correlated_walk` makes unit bond vectors by a small-step random
walk on the sphere: iid vectors would have a delta-function C(t) whose
multi-exponential fit is degenerate.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from . import checked_device


def correlated_walk(n_rep: int, n_frames: int, n_res: int,
                    seed: int = 0) -> np.ndarray:
    """(n_rep, n_frames, n_res, 3) float32 unit vectors; the generator of
    ``__graft_entry__.entry()`` (seed 0 and (4, 64, 16) give its input)."""
    rng = np.random.default_rng(seed)
    v = np.empty((n_rep, n_frames, n_res, 3), np.float32)
    cur = rng.normal(size=(n_rep, n_res, 3))
    cur /= np.linalg.norm(cur, axis=-1, keepdims=True)
    for t in range(n_frames):
        cur = cur + 0.15 * rng.normal(size=cur.shape)
        cur /= np.linalg.norm(cur, axis=-1, keepdims=True)
        v[:, t] = cur
    return v


def entry(device="cuda"):
    """-> (fwd, (vecs,)): the flagship forward step and its example input
    on ``device``, as ``__graft_entry__.entry()`` builds them in JAX.
    Runs on the card unless ``device="cpu"``; raises without one."""
    from .parallel.pipeline import make_forward

    dev = checked_device(device)
    vecs = torch.from_numpy(correlated_walk(4, 64, 16)).to(dev)
    fwd = make_forward(tau_iso=4242.0, delta_t=1.0, n_components=2)
    return fwd, (vecs,)


def paf_ensemble(n_res: int, n_samp: int, seed: int = 0):
    """(n_res, n_samp, 3) float64 unit vectors scattered around one
    direction per residue, and (n_res, n_samp) weights in [0.5, 2): a
    PAF vector ensemble and its weights, from a seed."""
    rng = np.random.default_rng(seed)
    axis = rng.normal(size=(n_res, 1, 3))
    v = axis / np.linalg.norm(axis, axis=-1, keepdims=True) \
        + 0.3 * rng.normal(size=(n_res, n_samp, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return v, rng.uniform(0.5, 2.0, (n_res, n_samp))


def hetero_cohort(B: int, T: int, rng=0, noise: float = 2e-3):
    """A heterogeneous cohort of C(t) decays for the DoF ladder: row b has
    b % 3 + 1 components (tau 3-600, amplitudes within 1 - S2, S2
    0.5-0.9) plus Gaussian noise.  ``rng`` is a seed or a numpy Generator
    (drawn from in place).  Returns float64 numpy (dt (T,), y (B, T),
    dy (B, T) = noise)."""
    rng = np.random.default_rng(rng)
    dt = np.arange(1, T + 1, dtype=float)
    y = np.empty((B, T))
    for b in range(B):
        k = b % 3 + 1
        S2 = rng.uniform(0.5, 0.9)
        C = rng.uniform(0.03, 0.15, k)
        C *= (1 - S2) / max(C.sum(), 1e-9) * rng.uniform(0.5, 1.0)
        tau = np.sort(rng.uniform(3, 600, k))
        y[b] = S2 + (C[:, None] * np.exp(-dt / tau[:, None])).sum(0)
    y += rng.normal(scale=noise, size=y.shape)
    return dt, y, np.full_like(y, noise)


def finish_entry(device="cuda"):
    """The streamed finish on ``device``: the Palmer accumulators of a
    seeded stream (8 chunks of 200 frames x 32 residues of
    ``correlated_walk``, one streamed group step), then
    ``parallel.streamed.run_finish`` with an axisymmetric diffusion tensor
    (tau_iso 4242 ps, Daniso 1.3) and 16 weighted PAF vectors a residue.
    Returns its FlagshipRates.  Runs on the card unless ``device="cpu"``;
    raises without one."""
    from .models.diffusion import Diffusion
    from .ops.autocorr import palmer_group_update_pretiled, tile_palmer_group
    from .parallel.streamed import run_finish

    n_chunks, n_frames, n_res = 8, 200, 32
    dev = checked_device(device)
    chunks = torch.from_numpy(correlated_walk(n_chunks, n_frames, n_res)).to(dev)
    zero = torch.zeros((n_frames // 2, n_res), dtype=chunks.dtype, device=dev)
    acc = palmer_group_update_pretiled(tile_palmer_group(chunks), zero, zero,
                                       n_chunks, n_res)
    vecs, weights = paf_ensemble(n_res, 16)
    return run_finish(*acc, n_chunks, n_res=n_res, delta_t=1.0,
                      diffusion=Diffusion.axisymmetric(tau=4242.0, aniso=1.3),
                      vecs=vecs, weights=weights)


def _quat_rotate(v, q):
    """Rotate (F, A, 3) vectors by (F, 4) unit quaternions (numpy)."""
    w, qv = q[:, None, :1], q[:, None, 1:]
    a = np.cross(qv, v) + w * v
    return v + 2.0 * np.cross(qv, a)


def synthetic_system(tmp_dir, n_res: int = 8, n_frames: int = 6000, dt: float = 1.0,
                     D_iso: float = 3.3e-4, wobble: float = 0.35, n_extra: int = 0,
                     seed: int = 0):
    """A rigid scaffold of ``n_res`` residues (N, H, CA atoms; ``n_extra``
    more rigid CA-like atoms on a shell, for a system of a real protein's
    atom count) undergoing isotropic rotational diffusion with
    tau_c = 1 / (6 D_iso), plus azimuthal wobble of each H on a cone about
    its N-H axis (an OU process, tau_int 30 ps), which plants S2 < 1: the
    system of tests/test_runall.py, drawn frame-parallel.

    Writes ``reference.pdb`` (occupancy 1 on the CA and extra atoms: the fit
    selection) and ``solute.xtc`` (1e-5 nm precision) into ``tmp_dir``.
    Returns (ref_fn, trj_fn, dict(D_iso, s2_planted))."""
    from .io import native, pdb as pdbio

    rng = np.random.default_rng(seed)
    n_atoms = n_res * 3 + n_extra
    i = np.arange(n_res)
    th = 2 * np.pi * i / n_res
    cen = np.stack([np.cos(th), np.sin(th), 0.2 * np.sin(3 * th)], axis=1)
    d = np.stack([np.cos(th) * 0.6, np.sin(th) * 0.6, 0.8 - 0.15 * i / n_res], axis=1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    base = np.zeros((n_atoms, 3))
    base[0 : 3 * n_res : 3] = cen  # N
    base[1 : 3 * n_res : 3] = cen + 0.102 * d  # H at 1.02 A
    base[2 : 3 * n_res : 3] = cen + np.array([0.05, -0.03, 0.08])  # CA
    if n_extra:
        shell = rng.normal(size=(n_extra, 3))
        base[3 * n_res :] = 1.5 * shell / np.linalg.norm(shell, axis=1, keepdims=True)
    top = pdbio.Topology(
        atom_names=["N", "H", "CA"] * n_res + ["CA"] * n_extra,
        res_seqs=np.concatenate([np.repeat(i + 2, 3), n_res + 2 + np.arange(n_extra)]),
        res_names=["ALA"] * (3 * n_res) + ["GLY"] * n_extra,
        chain_ids=["A"] * n_atoms,
        occupancies=np.array([0.0, 0.0, 1.0] * n_res + [1.0] * n_extra),
        elements=["N", "H", "C"] * n_res + ["C"] * n_extra,
    )
    ref_fn = os.path.join(str(tmp_dir), "reference.pdb")
    pdbio.write_pdb(ref_fn, top, base)

    # Global diffusion: a product of small random rotations (the only
    # sequential part; 4 numbers a frame).
    w = rng.normal(scale=np.sqrt(2.0 * D_iso * dt), size=(n_frames, 3))
    ang = np.linalg.norm(w, axis=1, keepdims=True)
    dq = np.concatenate([np.cos(ang / 2), w / np.where(ang > 0, ang, 1.0) * np.sin(ang / 2)],
                        axis=1)
    q = np.empty((n_frames, 4))
    q[0] = cur = np.array([1.0, 0.0, 0.0, 0.0])
    for t in range(1, n_frames):
        w1, v1, w2, v2 = cur[0], cur[1:], dq[t, 0], dq[t, 1:]
        cur = np.concatenate([[w1 * w2 - v1 @ v2], w1 * v2 + w2 * v1 + np.cross(v1, v2)])
        cur /= np.linalg.norm(cur)
        q[t] = cur
    # Internal wobble: OU-process azimuth of each H around its N-H axis.
    a = np.exp(-dt / 30.0)
    kicks = rng.normal(scale=0.8 * np.sqrt(1 - a * a), size=(n_frames, n_res))
    phi = np.zeros((n_frames, n_res))
    for t in range(1, n_frames):
        phi[t] = phi[t - 1] * a + kicks[t]
    e1 = np.cross(d, [0.0, 0.0, 1.0])
    e1 /= np.linalg.norm(e1, axis=1, keepdims=True)
    e2 = np.cross(d, e1)
    dir_t = np.cos(wobble) * d + np.sin(wobble) * (
        np.cos(phi)[..., None] * e1 + np.sin(phi)[..., None] * e2)
    xyz = np.empty((n_frames, n_atoms, 3), np.float32)
    for lo in range(0, n_frames, 2000):  # slabs bound the float64 temporaries
        sl = slice(lo, lo + 2000)
        body = np.broadcast_to(base, (len(q[sl]), n_atoms, 3)).copy()
        body[:, 1 : 3 * n_res : 3] = cen + 0.102 * dir_t[sl]
        xyz[sl] = _quat_rotate(body, q[sl])

    trj_fn = os.path.join(str(tmp_dir), "solute.xtc")
    native.write_xtc(trj_fn, xyz, times=np.arange(n_frames, dtype=np.float32) * dt,
                     precision=100000.0)
    s2_cone = (np.cos(wobble) * (1 + np.cos(wobble)) / 2) ** 2
    return ref_fn, trj_fn, dict(D_iso=D_iso, s2_planted=s2_cone)


def ct_entry(device="cuda", n_res: int = 8, n_frames: int = 6000,
             tau_memory: float = 1000.0):
    """File to rates on ``device``: a :func:`synthetic_system` written as
    .pdb + .xtc, read back by ``pipeline.stages.stage_ct_streamed`` (the
    native reader, Horn orientation, the fused group update over kernel A),
    whose C(t) accumulators go to ``parallel.streamed.run_finish`` with the
    planted isotropic tumbling.  Returns (stage dict, FlagshipRates).  Runs
    on the card unless ``device="cpu"``; raises without one.  The files go
    to a temporary directory that is removed after."""

    from .models.diffusion import Diffusion
    from .parallel.streamed import run_finish
    from .pipeline.stages import stage_ct_streamed

    checked_device(device)
    with tempfile.TemporaryDirectory() as tmp:
        ref_fn, trj_fn, truth = synthetic_system(tmp, n_res=n_res, n_frames=n_frames)
        out = stage_ct_streamed([trj_fn], [ref_fn], os.path.join(tmp, "ct"),
                                tau_memory=tau_memory, chunk_groups=2, device=device)
    rates = run_finish(out["acc"]["ct_int_s"], out["acc"]["ct_int_s2"], out["n_chunks"],
                       n_res=len(out["res_ids"]), delta_t=out["delta_t"],
                       diffusion=Diffusion.isotropic(diso=truth["D_iso"]),
                       names=[str(r) for r in out["res_ids"]])
    return out, rates


def workflow_entry(out_dir=None, device="cuda", n_res: int = 8, n_frames: int = 6000,
                   tau_memory: float = 1000.0):
    """The run-all workflow on ``device`` (the card unless
    ``device="cpu"``; raises without one), as examples/synthetic_workflow.py
    drives the JAX package's: a :func:`synthetic_system` (.pdb + .xtc)
    through ``pipeline.runall.main`` with ``-t_mem``, two ``-Bfields`` and
    ``-Jw`` -- orientation colvar, Delta-q -> D tensor, the in-memory C(t)
    stage, the DoF ladder, R1/R2/NOE/rho and J(omega) at 600.133 and
    850.13 MHz.

    The files go to ``out_dir`` (a new temporary directory, left to the
    caller, when None).  Returns dict(paths: the artefacts written, sorted;
    diso: the D_iso [ps^-1] the relaxations used; run: runall's summary)."""
    from .pipeline import runall

    checked_device(device)
    out_dir = tempfile.mkdtemp(prefix="spinrelax_workflow_") if out_dir is None else str(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    ref_fn, trj_fn, _ = synthetic_system(out_dir, n_res=n_res, n_frames=n_frames)
    run = runall.main(["-out", os.path.join(out_dir, "rotdif"), "-sxtc", trj_fn,
                       "-refpdb", ref_fn, "-qfile", os.path.join(out_dir, "colvar-qorient"),
                       "-t_mem", str(tau_memory), "-Bfields", "600.133", "850.13", "-Jw"],
                      device=device)
    paths = sorted(os.path.join(out_dir, f) for f in os.listdir(out_dir)
                   if f not in (os.path.basename(ref_fn), os.path.basename(trj_fn)))
    return dict(paths=paths, diso=run["diso"], run=run)
