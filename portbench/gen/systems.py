"""Input generators of the benchmark's configurations, all drawn from
``--seed``.  Copies of the port's sound generators
(``entry.synthetic_system``, ``chip_smoke.stage_observables`` and
``chip_smoke.mbp_system``), frozen here and vectorised: the sequential
host loops (the rotation walk, the wobble's OU process) are prefix scans
by doubling.  None of this imports the port.

- :func:`ubq_system`: a rigid ubiquitin-sized scaffold (N, H, CA a
  residue plus shell atoms) under isotropic rotational diffusion, each H
  wobbling on a cone about its N-H axis; written as ``reference.pdb`` and
  ``solute.xtc``.
- :func:`bond_observables`: the streamed C(t) stage's host-reduced
  observables of a tumbling protein, made on the device: the N-H
  difference vectors and Horn's correlation S = C_ref R(t)^T.
- :func:`vector_histogram`: per-residue Lambert-cylindrical histograms
  of N-H directions (the PAF vector ensemble), counts from a seed.
- :func:`ct_models`, :func:`write_fittedct`, :func:`write_experiment`:
  the multi-field fit's input files.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from . import pdbwrite, xtcwrite

C_REF = (1.0, 0.6, 0.3)  # second moments of the reference behind S


# ---------------------------------------------------------------------------
# quaternions (w, x, y, z), numpy or torch alike
# ---------------------------------------------------------------------------

def qmul(a, b):
    """Hamilton product of (..., 4) arrays."""
    w1, x1, y1, z1 = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    w2, x2, y2, z2 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    parts = (w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
             w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
             w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
             w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2)
    if torch.is_tensor(a):
        return torch.stack(parts, dim=-1)
    return np.stack(parts, axis=-1)


def prefix_qmul(q):
    """Running products q[0] q[1] ... q[t] along axis 0, by doubling."""
    q = q.clone() if torch.is_tensor(q) else q.copy()
    k = 1
    while k < q.shape[0]:
        q[k:] = qmul(q[:-k], q[k:])
        k *= 2
    return q


def prefix_ou(kicks, a):
    """x[t] = a x[t-1] + kicks[t] along axis 0 (x[-1] = 0), by doubling;
    ``a`` broadcasts against kicks[0]."""
    x = kicks.clone() if torch.is_tensor(kicks) else kicks.copy()
    k, ak = 1, a
    while k < x.shape[0]:
        x[k:] = x[k:] + ak * x[:-k]
        ak = ak * ak
        k *= 2
    return x


def rotation_walk_steps(w):
    """Small-rotation quaternions from (F, 3) rotation vectors."""
    if torch.is_tensor(w):
        ang = torch.linalg.vector_norm(w, dim=-1, keepdim=True)
        safe = torch.where(ang > 0, ang, torch.ones_like(ang))
        return torch.cat([torch.cos(ang / 2), w / safe * torch.sin(ang / 2)], -1)
    ang = np.linalg.norm(w, axis=-1, keepdims=True)
    safe = np.where(ang > 0, ang, 1.0)
    return np.concatenate([np.cos(ang / 2), w / safe * np.sin(ang / 2)], -1)


def quat_rotate(v, q):
    """Rotate (F, A, 3) vectors by (F, 4) unit quaternions (numpy)."""
    w, qv = q[:, None, :1], q[:, None, 1:]
    a = np.cross(qv, v) + w * v
    return v + 2.0 * np.cross(qv, a)


def quat_to_mat(q):
    """(..., 4) unit quaternions -> (..., 3, 3) rotation matrices (torch)."""
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


# ---------------------------------------------------------------------------
# ubiquitin-sized file system (run-all)
# ---------------------------------------------------------------------------

def ubq_system(work: str, cfg: dict, seed: int) -> dict:
    """Write ``reference.pdb`` and ``solute.xtc`` into ``work``.

    Returns the paths and what the reference needs: the quantised
    coordinates (F, A, 3) int32 with their precision, the reference
    coordinates as the PDB holds them, the fit weights, the N and H atom
    indices, residue numbers and the frame spacing."""
    rng = np.random.default_rng(seed)
    n_res, n_atoms, F, dt = cfg["n_res"], cfg["n_atoms"], cfg["n_frames"], cfg["dt_ps"]
    n_extra = n_atoms - 3 * n_res
    i = np.arange(n_res)
    th = 2 * np.pi * i / n_res
    cen = np.stack([np.cos(th), np.sin(th), 0.2 * np.sin(3 * th)], axis=1)
    d = np.stack([np.cos(th) * 0.6, np.sin(th) * 0.6, 0.8 - 0.15 * i / n_res], axis=1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    base = np.zeros((n_atoms, 3))
    base[0: 3 * n_res: 3] = cen
    base[1: 3 * n_res: 3] = cen + 0.102 * d
    base[2: 3 * n_res: 3] = cen + np.array([0.05, -0.03, 0.08])
    shell = rng.normal(size=(n_extra, 3))
    base[3 * n_res:] = 1.5 * shell / np.linalg.norm(shell, axis=1, keepdims=True)
    atom_names = ["N", "H", "CA"] * n_res + ["CA"] * n_extra
    res_seqs = np.concatenate([np.repeat(i + 2, 3), n_res + 2 + np.arange(n_extra)])
    occ = np.array([0.0, 0.0, 1.0] * n_res + [1.0] * n_extra)
    ref_fn = os.path.join(work, "reference.pdb")
    pdbwrite.write_pdb(ref_fn, atom_names, ["ALA"] * (3 * n_res) + ["GLY"] * n_extra,
                       res_seqs, ["A"] * n_atoms, occ,
                       ["N", "H", "C"] * n_res + ["C"] * n_extra, base)

    # isotropic rotational diffusion, tau_c = 1 / (6 D)
    D = 1.0 / (6.0 * cfg["tau_c_ps"])
    w = rng.normal(scale=math.sqrt(2.0 * D * dt), size=(F, 3))
    steps = rotation_walk_steps(w)
    steps[0] = (1.0, 0.0, 0.0, 0.0)
    q = prefix_qmul(steps)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    # the wobble: an OU azimuth of each H about its N-H axis
    a = math.exp(-dt / cfg["tau_int_ps"])
    kicks = rng.normal(scale=0.8 * math.sqrt(1 - a * a), size=(F, n_res))
    kicks[0] = 0.0
    phi = prefix_ou(kicks, a)
    e1 = np.cross(d, [0.0, 0.0, 1.0])
    e1 /= np.linalg.norm(e1, axis=1, keepdims=True)
    e2 = np.cross(d, e1)
    wob = cfg["wobble_rad"]
    xyz = np.empty((F, n_atoms, 3), np.float32)
    for lo in range(0, F, 2000):  # slabs bound the float64 temporaries
        sl = slice(lo, lo + 2000)
        dir_t = np.cos(wob) * d + np.sin(wob) * (
            np.cos(phi[sl])[..., None] * e1 + np.sin(phi[sl])[..., None] * e2)
        body = np.broadcast_to(base, (len(q[sl]), n_atoms, 3)).copy()
        body[:, 1: 3 * n_res: 3] = cen + 0.102 * dir_t
        xyz[sl] = quat_rotate(body, q[sl])
    prec = float(cfg["xtc_precision"])
    xtc_fn = os.path.join(work, "solute.xtc")
    xtcwrite.write_xtc(xtc_fn, xyz, np.arange(F, dtype=np.float32) * np.float32(dt), prec)
    ints = xtcwrite.quantise(xyz, prec)
    del xyz
    return dict(ref_pdb=ref_fn, xtc=xtc_fn, ints=ints, precision=prec,
                ref_xyz=pdbwrite.as_read(base), fit_weights=(occ > 0).astype(float),
                idx_n=np.arange(0, 3 * n_res, 3), idx_h=np.arange(1, 3 * n_res, 3),
                res_ids=[str(r) for r in i + 2], dt=float(dt))


# ---------------------------------------------------------------------------
# streamed C(t) observables (mbp)
# ---------------------------------------------------------------------------

def bond_observables(cfg: dict, seed: int, device, slab: int = 50_000):
    """(raw_diff (F, nB, 3), S (F, 3, 3)) float32 on ``device``: a body under
    isotropic rotational diffusion (tau_c of the configuration), each N-H
    direction on a cone of its own half-angle about its own axis with an
    OU azimuth of its own correlation time, plus a small fast libration.
    Made in frame slabs from one ``torch.Generator`` on the device."""
    F, nB, dt = cfg["n_frames"], cfg["n_res"], cfg["dt_ps"]
    gen = torch.Generator(device=device).manual_seed(seed)
    f64 = dict(dtype=torch.float64, device=device)

    def rand(*shape):
        return torch.rand(shape, generator=gen, **f64)

    def randn(*shape):
        return torch.randn(shape, generator=gen, **f64)

    axis = torch.nn.functional.normalize(randn(nB, 3), dim=-1)
    e1 = torch.nn.functional.normalize(torch.linalg.cross(axis, randn(nB, 3)), dim=-1)
    e2 = torch.linalg.cross(axis, e1)
    cone = 0.15 + 0.45 * rand(nB)  # half-angles, rad
    tau_int = torch.exp(math.log(20.0) + math.log(25.0) * rand(nB))  # 20-500 ps
    a = torch.exp(-dt / tau_int)
    libration = 0.05 + 0.1 * rand(nB)  # rad, fast
    D = 1.0 / (6.0 * cfg["tau_c_ps"])
    c_ref = torch.tensor(C_REF, **f64)
    raw = torch.empty((F, nB, 3), dtype=torch.float32, device=device)
    S = torch.empty((F, 3, 3), dtype=torch.float32, device=device)
    q_last = torch.tensor([1.0, 0.0, 0.0, 0.0], **f64)
    phi_last = torch.zeros(nB, **f64)
    for lo in range(0, F, slab):
        n = min(slab, F - lo)
        steps = rotation_walk_steps(randn(n, 3) * math.sqrt(2.0 * D * dt))
        if lo == 0:
            steps[0] = torch.tensor([1.0, 0.0, 0.0, 0.0], **f64)
        q = qmul(q_last, prefix_qmul(steps))
        q = q / q.norm(dim=-1, keepdim=True)
        kicks = randn(n, nB) * torch.sqrt(1 - a * a)
        if lo == 0:
            kicks[0] = 0.0
        powers = a[None, :] ** torch.arange(1, n + 1, **f64)[:, None]
        phi = prefix_ou(kicks, a) + powers * phi_last
        body = (torch.cos(cone)[:, None] * axis
                + torch.sin(cone)[:, None] * (torch.cos(phi)[..., None] * e1
                                              + torch.sin(phi)[..., None] * e2))
        jitter = randn(n, nB, 3) * libration[:, None]
        body = torch.nn.functional.normalize(body + jitter, dim=-1)
        R = quat_to_mat(q)
        raw[lo: lo + n] = (0.102 * torch.einsum("fij,fbj->fbi", R, body)).float()
        S[lo: lo + n] = (c_ref[:, None] * R.transpose(1, 2)).float()
        q_last, phi_last = q[-1], phi[-1]
        del steps, kicks, powers, phi, body, jitter, R
    return raw, S


# ---------------------------------------------------------------------------
# vector ensembles and the multi-field fit's files (mbp)
# ---------------------------------------------------------------------------

def lambert_edges(bins_phi: int, bins_cos: int):
    """float32 bin edges over (-pi, pi) and (-1, 1)."""
    return (np.linspace(-math.pi, math.pi, bins_phi + 1).astype(np.float32),
            np.linspace(-1.0, 1.0, bins_cos + 1).astype(np.float32))


def vector_histogram(cfg: dict, seed: int, device):
    """(counts (nRes, bins_phi, bins_cos) int64, edges_phi, edges_cos):
    each residue's N-H directions in the diffusion frame, ``samples``
    draws scattered about one axis, binned on the Lambert cylinder."""
    nR, bp, bc = cfg["n_res"], cfg["hist_bins"][0], cfg["hist_bins"][1]
    n = cfg["hist_samples"]
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    axis = torch.nn.functional.normalize(
        torch.randn((nR, 1, 3), generator=gen, device=device, dtype=torch.float64), dim=-1)
    spread = 0.1 + 0.3 * torch.rand((nR, 1, 1), generator=gen, device=device,
                                    dtype=torch.float64)
    v = torch.nn.functional.normalize(
        axis + spread * torch.randn((nR, n, 3), generator=gen, device=device,
                                    dtype=torch.float64), dim=-1)
    phi = torch.atan2(v[..., 1], v[..., 0])
    ix = torch.clamp(((phi + math.pi) / (2 * math.pi) * bp).long(), 0, bp - 1)
    iy = torch.clamp(((v[..., 2].clamp(-1, 1) + 1) / 2 * bc).long(), 0, bc - 1)
    flat = torch.arange(nR, device=device)[:, None] * (bp * bc) + ix * bc + iy
    counts = torch.bincount(flat.reshape(-1), minlength=nR * bp * bc).reshape(nR, bp, bc)
    ep, ec = lambert_edges(bp, bc)
    return counts.cpu().numpy(), ep, ec


def save_histogram(fn: str, names, counts, edges_phi, edges_cos) -> None:
    """The Lambert-cylindrical .npz of the reference format."""
    edges = np.empty(2, dtype=object)
    edges[0], edges[1] = np.asarray(edges_phi), np.asarray(edges_cos)
    np.savez_compressed(fn, names=np.asarray(names), dataType="LambertCylindrical",
                        bHistogram=True, edges=edges, axisLabels=["phi", "cos(theta)"],
                        data=np.asarray(counts))


def ct_models(cfg: dict, seed: int) -> dict:
    """Per-residue C(t) models with S2_fast: S2 (nRes,), C and tau (nRes, 2),
    each value as the fittedCt file prints it (``%g``)."""
    rng = np.random.default_rng(seed + 2)
    n = cfg["n_res"]

    def g(a):
        return np.array([float("%g" % v) for v in np.ravel(a)]).reshape(np.shape(a))

    S2 = g(0.6 + 0.3 * rng.random(n))
    C = g(0.02 + 0.08 * rng.random((n, 2)))
    tau = g(np.stack([5 + 25 * rng.random(n), 100 + 700 * rng.random(n)], -1))
    return dict(names=[str(i + 1) for i in range(n)], S2=S2, C=C, tau=tau)


def write_fittedct(fn: str, m: dict) -> None:
    """The fittedCt wire format, parameter blocks only (every model with
    S2_fast, two components)."""
    greek = "ab"
    with open(fn, "w") as fp:
        for i, name in enumerate(m["names"]):
            fast = 1.0 - m["S2"][i] - m["C"][i].sum()
            print("# Residue: %s " % name, file=fp)
            print("# Chi-Square: %g " % 1e-6, file=fp)
            print("# Param S2_fast: %g +- 0.0" % fast, file=fp)
            print("# Param S2_0: %g +- 0.0" % m["S2"][i], file=fp)
            for k in range(m["C"].shape[1]):
                print("# Param C_%s: %g +- 0.0" % (greek[k], m["C"][i, k]), file=fp)
                print("# Param tau_%s: %g +- 0.0" % (greek[k], m["tau"][i, k]), file=fp)


def write_experiment(fn: str, kind: str, mhz: float, names, values, errors) -> None:
    """One experiment file (R1 / R2 / NOE at one field), full precision."""
    with open(fn, "w") as fp:
        print("# Type %s" % kind, file=fp)
        print("# NucleiA 15N", file=fp)
        print("# NucleiB 1H", file=fp)
        print("# Frequency %s" % repr(float(mhz)), file=fp)
        print("# FrequencyUnit MHz", file=fp)
        for n, v, e in zip(names, values, errors):
            print(n, repr(float(v)), repr(float(e)), file=fp)
