"""The forward step's example input, a torch twin of
``__graft_entry__.entry()``, and :func:`finish_entry`, which runs the
streamed finish (DoF ladder -> diffusion J(omega) -> ensemble rates).

:func:`correlated_walk` makes unit bond vectors by a small-step random
walk on the sphere: iid vectors would have a delta-function C(t) whose
multi-exponential fit is degenerate.
"""

from __future__ import annotations

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
