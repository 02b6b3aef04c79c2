"""Carry state from the JAX package into the port.

This system has no weights.  What a run carries is (1) the physical
constants the forward step closes over, (2) the streamed Palmer
accumulators, so a stream started with ``spinrelax_tpu`` can continue in
the port and finish there (and the streamed C(t) stage's returned
dictionary, so either package's finish can start from the other's stage),
and (3) fitted C(t) models and diffusion
tensors, so a model fitted in one package can be rated in the other.
"""

from __future__ import annotations

from typing import Optional

import torch

import numpy as np

from . import checked_device
from .constants import NucleusPair
from .models.ctmodel import CtModelSet
from .models.diffusion import Diffusion


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


def palmer_state_from_stage(stage_out: dict, n_chunks: int, device="cuda"):
    """The dictionary a ``stage_ct_streamed`` returns (either package's:
    ``Ct`` and ``dCt`` as (nDeltas, nRes) numpy arrays of the pooled Palmer
    statistics) and its chunk count -> the port's lag-leading shifted
    accumulators (acc_s, acc_s2, count) for ``parallel.streamed.run_finish``:
    the inverse of ``palmer_pooled_stats`` (dtype kept).  ``n_chunks`` must
    be at least 2: one chunk has no dCt to invert.  On the card unless
    ``device="cpu"``; raises without one."""
    dev = checked_device(device)
    if n_chunks < 2:
        raise ValueError("n_chunks must be >= 2: one chunk's dCt is NaN")
    ct = torch.tensor(np.asarray(stage_out["Ct"]), device=dev)
    dct = torch.tensor(np.asarray(stage_out["dCt"]), device=dev)
    e_mean = ct - 1.0
    var = (dct * (n_chunks**0.5 - 1.0)) ** 2
    return e_mean * n_chunks, (var + e_mean**2) * n_chunks, int(n_chunks)


def stage_from_palmer_state(acc_s, acc_s2, count, res_ids, delta_t: float) -> dict:
    """The way back: the port's lag-leading accumulators and chunk count ->
    the ``Ct``/``dCt``/``res_ids``/``delta_t`` entries of the dictionary the
    JAX package's ``stage_ct_streamed`` returns (numpy, (nDeltas, nRes)),
    from which its own finish (``stage_fit_ct``) can start."""
    from .ops.autocorr import palmer_pooled_stats

    mean, dct = palmer_pooled_stats(acc_s, acc_s2, count)
    return {"res_ids": list(res_ids), "delta_t": delta_t,
            "Ct": mean.cpu().numpy(), "dCt": dct.cpu().numpy()}


def ctmodel_from_numpy(S2, C, tau, mask, zeta=1.0, s2fast=None, dS2=None, dC=None,
                       dtau=None, chisq=None, names=(), device="cuda") -> CtModelSet:
    """A JAX ``CtModelSet``'s arrays (as numpy) -> the port's float64
    CtModelSet, values copied as they are (no sorting or padding).  On the
    card unless ``device="cpu"``; raises without one."""
    dev = checked_device(device)

    def t(a):
        return None if a is None else torch.tensor(np.asarray(a, dtype=float),
                                                    dtype=torch.float64, device=dev)

    if s2fast is None:
        s2fast = np.zeros(np.shape(S2))
    return CtModelSet(S2=t(S2), C=t(C), tau=t(tau), mask=t(mask), zeta=t(zeta),
                      s2fast=t(s2fast), dS2=t(dS2), dC=t(dC), dtau=t(dtau),
                      chisq=t(chisq), names=[str(x) for x in names])


def diffusion_from_numpy(kind: str, diso=None, aniso=1.0, dxyz=None) -> Diffusion:
    """A JAX ``Diffusion``'s kind and values (diso, aniso, dxyz) -> the
    port's Diffusion (float64 CPU scalars, moved where they are used)."""
    if kind == "isotropic":
        return Diffusion.isotropic(diso=float(diso))
    if kind == "axisymmetric":
        return Diffusion.axisymmetric(diso=float(diso), aniso=float(aniso))
    if kind == "ellipsoid":
        return Diffusion.ellipsoid(np.asarray(dxyz, dtype=float))
    if kind == "direct":
        return Diffusion.direct()
    raise ValueError(f"unknown diffusion kind {kind!r}")
