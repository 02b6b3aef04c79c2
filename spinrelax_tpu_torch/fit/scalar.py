"""Batched scalar minimisation (port of ``spinrelax_tpu/fit/scalar.py``).

``golden_vec`` minimises a vector-valued objective elementwise -- every
batch element carries its own bracket -- with a fixed iteration count, so
the search is a fixed sequence of device operations with no host read.
Used for the residue-specific CSA, where the reference runs nResidues
sequential scalar Powell fits (spectral_densities.py:1371-1382); here all
residues descend together, one batched evaluation per iteration.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

_INVPHI = (math.sqrt(5.0) - 1.0) / 2.0
_INVPHI2 = (3.0 - math.sqrt(5.0)) / 2.0


def golden_vec(f: Callable, lo, hi, n_iter: int = 60):
    """Elementwise golden-section minimisation.

    f        : maps a (B,) candidate tensor -> (B,) objective values.
    lo, hi   : (B,) bracket bounds per element (tensors, one device).
    Returns the (B,) minimising points.

    The surviving interior point of each lane is exactly the next c or d
    (the golden-ratio invariant), so one batched f call runs per
    iteration.  60 iterations shrink the bracket by 0.618^60 ~ 3e-13,
    below float64 resolution for any physical CSA bracket.
    """
    a, b = lo, hi
    h0 = b - a
    c = a + _INVPHI2 * h0
    d = a + _INVPHI * h0
    fc, fd = f(c), f(d)
    for _ in range(n_iter):
        sr = fc < fd  # minimum in [a, d]
        a_new = torch.where(sr, a, c)
        b_new = torch.where(sr, d, b)
        h = b_new - a_new
        # The kept point: old c becomes the new d when shrinking right,
        # old d the new c otherwise; only the other point is fresh.
        c_new = torch.where(sr, a_new + _INVPHI2 * h, d)
        d_new = torch.where(sr, c, a_new + _INVPHI * h)
        fx = f(torch.where(sr, c_new, d_new))
        fc, fd = torch.where(sr, fx, fd), torch.where(sr, fc, fx)
        a, b, c, d = a_new, b_new, c_new, d_new
    return 0.5 * (a + b)
