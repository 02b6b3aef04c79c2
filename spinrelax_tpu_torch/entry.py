"""The forward step's example input and a torch twin of
``__graft_entry__.entry()``.

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
