"""The end-to-end forward step: bond vectors -> C(t) -> multi-exp fit ->
J(omega) -> R1/R2/NOE/rho (port of ``spinrelax_tpu/parallel/pipeline.py``).

On a CUDA float32 input it runs kernel A (C(t) lag sums) and kernels B
and C (every LM iteration); on a CPU tensor the same code runs their
plain versions.  :func:`make_sharded_forward` runs the same step over a
("rep", "res") mesh, one rank per device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..constants import NucleusPair

from ..convert import forward_kwargs_from_jax
from ..fit.lm import fit_multiexp
from ..ops import autocorr, relaxation as rx
from ..ops.jomega import j_combine_isotropic


class PipelineOutput(NamedTuple):
    Ct: torch.Tensor  # (nDeltas, nRes)
    dCt: torch.Tensor  # (nDeltas, nRes)
    S2: torch.Tensor  # (nRes,)
    C: torch.Tensor  # (nRes, K)
    tau: torch.Tensor  # (nRes, K)
    R1: torch.Tensor  # (nRes,)
    R2: torch.Tensor  # (nRes,)
    NOE: torch.Tensor  # (nRes,)
    rho: torch.Tensor  # (nRes,)


def spinrelax_forward(
    vecs: torch.Tensor,
    delta_t: float,
    omega: torch.Tensor,
    f_dd: float,
    f_csa: float,
    time_fact: float,
    gamma_ratio: float,
    tau_iso: float,
    n_components: int = 2,
    zeta: float = 1.0,
) -> PipelineOutput:
    """Full forward pass on Palmer-chunked vectors
    (nReplicates, nFramesPerChunk, nResidues, 3)."""
    Ct, dCt = autocorr.ct_palmer(vecs)  # (nDeltas, nRes)
    return fit_to_rates(Ct, dCt, delta_t, omega, f_dd, f_csa, time_fact, gamma_ratio,
                        tau_iso, n_components, zeta)


def fit_to_rates(Ct, dCt, delta_t: float, omega, f_dd: float, f_csa: float,
                 time_fact: float, gamma_ratio: float, tau_iso: float,
                 n_components: int = 2, zeta: float = 1.0) -> PipelineOutput:
    """The forward after C(t): (nDeltas, nRes) Ct and dCt -> the SEM-weighted
    multi-exp fit (kernels B and C on the card) -> isotropic J -> rates."""
    f, dev = Ct.dtype, Ct.device
    dt = (torch.arange(Ct.shape[0], dtype=f, device=dev) + 1.0) * delta_t
    # SEM-weighted fit like the reference (calculate-fitted-Ct.py:171);
    # zero or invalid SEMs (e.g. one chunk) fall back to 1.
    sigma = torch.where(dCt.T > 0, dCt.T, torch.ones_like(dCt.T))
    fit = fit_multiexp(dt, Ct.T.contiguous(), sigma, K=n_components, s2_free=True)
    J = j_combine_isotropic(omega.to(dtype=f, device=dev), tau_iso, fit.S2, fit.C, fit.tau,
                            zeta=zeta)
    R1 = rx.r1_from_j(J, f_dd, f_csa, time_fact)
    R2 = rx.r2_from_j(J, f_dd, f_csa, time_fact)
    NOE = rx.noe_from_j(J, f_dd, time_fact, gamma_ratio, R1)
    rho = rx.rho_from_j(J)
    return PipelineOutput(Ct, dCt, fit.S2, fit.C, fit.tau, R1, R2, NOE, rho)


def make_forward(pair: Optional[NucleusPair] = None, tau_iso: float = 4242.0,
                 delta_t: float = 1.0, n_components: int = 2, zeta: float = 1.0):
    """Close over the physical constants -> a (vecs -> PipelineOutput)
    function; omega follows the input's dtype and device."""
    kw = forward_kwargs_from_jax(pair, tau_iso, delta_t, n_components, zeta)
    omega = kw.pop("omega")

    def fwd(vecs: torch.Tensor) -> PipelineOutput:
        return spinrelax_forward(
            vecs, omega=omega.to(dtype=vecs.dtype, device=vecs.device), **kw
        )

    return fwd


def make_sharded_forward(mesh, **kwargs):
    """The forward step over a ("rep", "res") mesh: every rank takes the
    same (nRep, F, nRes, 3) vectors and keeps its (nRep / rep, F,
    nRes / res, 3) block (``ShardedCtStream``: chunks padded with zero
    weights, residues with zero vectors); kernel A runs on the block, the
    shifted (sum, sum of squares, count) are all-reduced over "rep", and
    the pooled C(t) of the rank's residues is fitted (kernels B and C),
    turned into J and rates, and gathered over "res".  ``kwargs`` are
    :func:`make_forward`'s.  Returns the whole PipelineOutput on every
    rank."""
    from . import mesh as pm
    from .streamed import ShardedCtStream, _pack, _unpack

    kw = forward_kwargs_from_jax(**kwargs)

    def fwd(vecs: torch.Tensor) -> PipelineOutput:
        n_rep, n_frames, n_res, _ = vecs.shape
        stream = ShardedCtStream(mesh, n_frames, n_res, dtype=vecs.dtype)
        stream.update(vecs)
        mean, dct = autocorr.palmer_pooled_stats(*stream.accumulators())  # (nDeltas, local)
        out = fit_to_rates(mean, dct, **kw)
        cols = [mean.T, dct.T] + list(out[2:])
        full = _unpack(pm.all_gather(_pack(cols), pm.group(mesh, "res")), cols)
        full = [x[:n_res] for x in full]
        return PipelineOutput(full[0].T, full[1].T, *full[2:])

    return fwd
