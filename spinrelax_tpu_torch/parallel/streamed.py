"""The finish of a streamed C(t) run on one card: pooled Palmer statistics
-> DoF-ladder model selection -> J(omega) with vector ensembles ->
ensemble rates (the single-device counterpart of
``spinrelax_tpu/parallel/streamed.py:303 run_sharded_finish``, which is
what ``stage_fit_ct`` + ``stage_relax`` compute).

The mesh and its residue padding go with ROADMAP item 15.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..constants import NucleusPair
from ..ops import autocorr


class FlagshipRates(NamedTuple):
    """What ``stage_fit_ct`` + ``stage_relax`` produce for one stream."""

    Ct: torch.Tensor  # (nRes, nDeltas) pooled C(t)
    dCt: torch.Tensor  # (nRes, nDeltas) pooled SEM
    cts: object  # models.ctmodel.CtModelSet from the DoF-ladder selection
    R1: torch.Tensor  # (nRes,) ensemble-averaged rates (legacy semantics)
    R2: torch.Tensor
    NOE: torch.Tensor
    rho: torch.Tensor
    dR1: Optional[torch.Tensor] = None
    dR2: Optional[torch.Tensor] = None
    dNOE: Optional[torch.Tensor] = None
    drho: Optional[torch.Tensor] = None


def run_finish(
    acc_s,
    acc_s2,
    count,
    *,
    n_res: int,
    delta_t: float,
    diffusion,
    pair: Optional[NucleusPair] = None,
    vecs=None,
    weights=None,
    csa=None,
    zeta: float = 1.0,
    use_s2fast: bool = True,
    n_components: Optional[int] = None,
    chisq_threshold: float = 0.5,
    names=None,
) -> FlagshipRates:
    """pooled Palmer stats -> ``fit_ct_ladder`` (SEM-weighted) ->
    ``predict_rates``, on the accumulators' device.

    acc_s, acc_s2 : the port's lag-leading (nDeltas, >= n_res) shifted
        accumulators (``ops.autocorr.palmer_group_update_pretiled``;
        a JAX ``ShardedCtStream``'s are their transpose), and the chunk
        count.  The ladder runs in the accumulators' dtype (float32 on the
        card: kernels B and C); the rates in float64.
    diffusion : models.diffusion.Diffusion (anisotropic kinds need vecs).
    vecs : (nRes, nSamp, 3) PAF vector ensemble (or (nRes, 3));
    weights : (nRes, nSamp) or None; csa : None, scalar or (nRes,).
    """
    from ..fit.expfit import fit_ct_ladder
    from ..ops import observables as obs

    pair = pair or NucleusPair(time_unit="ps")
    mean, dct = autocorr.palmer_pooled_stats(acc_s, acc_s2, count)
    Ct = mean[:, :n_res].T.contiguous()  # (nRes, nDeltas)
    dCt = dct[:, :n_res].T.contiguous()
    dt = (torch.arange(Ct.shape[1], dtype=torch.float64) + 1.0) * delta_t
    if names is None:
        names = [str(i) for i in range(n_res)]
    # NaN dCt (one-chunk streams) become weight 1 inside fit_ct_ladder.
    cts = fit_ct_ladder(names, dt, Ct, ddecays=dCt, use_s2fast=use_s2fast,
                        n_components=n_components, chisq_threshold=chisq_threshold,
                        zeta=zeta)

    def on_card(a):
        return None if a is None else torch.as_tensor(a, dtype=torch.float64,
                                                      device=Ct.device)

    rates = obs.predict_rates(pair, diffusion, cts, vecs=on_card(vecs),
                              weights=on_card(weights), csa=on_card(csa))
    return FlagshipRates(Ct, dCt, cts, *rates)
