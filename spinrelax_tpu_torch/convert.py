"""Carry state from the JAX package into the port.

This system has no weights.  What a run carries is (1) the physical
constants the forward step closes over and (2) the streamed Palmer
accumulators, so a stream started with ``spinrelax_tpu`` can continue in
the port and finish there.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import checked_device
from .constants import NucleusPair


def forward_kwargs_from_jax(pair: Optional[NucleusPair] = None,
                            tau_iso: float = 4242.0, delta_t: float = 1.0,
                            n_components: int = 2, zeta: float = 1.0) -> dict:
    """The keyword arguments of ``parallel.pipeline.spinrelax_forward``
    for the constants ``spinrelax_tpu.parallel.pipeline.make_forward``
    closes over (same defaults).  omega is a float64 CPU tensor."""
    pair = pair or NucleusPair(time_unit="ps")
    return dict(
        delta_t=delta_t,
        omega=torch.tensor(pair.omega5(), dtype=torch.float64),
        f_dd=pair.factor_dd(),
        f_csa=pair.factor_csa(),
        time_fact=pair.time_fact,
        gamma_ratio=pair.gamma_b / pair.gamma_a,
        tau_iso=tau_iso,
        n_components=n_components,
        zeta=zeta,
    )


def palmer_state_from_numpy(acc_s, acc_s2, count, device="cuda"):
    """A JAX stream's lag-leading (nDeltas, nRes) shifted accumulators and
    its chunk count -> (acc_s, acc_s2, count) for
    ``ops.autocorr.palmer_group_update_pretiled`` and
    ``palmer_pooled_stats`` (dtype kept, values copied).  On the card
    unless ``device="cpu"``; raises without one."""
    dev = checked_device(device)
    s = torch.tensor(acc_s, device=dev)
    s2 = torch.tensor(acc_s2, device=dev)
    if s.shape != s2.shape or s.ndim != 2:
        raise ValueError(
            f"accumulators must share one (nDeltas, nRes) shape, got "
            f"{tuple(s.shape)} and {tuple(s2.shape)}"
        )
    return s, s2, int(count)
