"""Multi-host ingest (port of ``spinrelax_tpu/parallel/ingest.py``).

Trajectories larger than one host's disk or memory bandwidth shard by
REPLICA (Palmer chunk group): chunk groups are statistically independent,
so hosts never exchange frame data.  Each host streams its own chunks into
running (sum, sum of squares, count) accumulators; the only traffic
between hosts is one reduction of those sums at the end.

:func:`reduce_partials` pools a list of partials on the host;
:func:`reduce_partials_collective` is the same reduction as the
collective a multi-process run makes: each rank brings its own partial
and one all-reduce over "rep" pools them (the JAX package lays the
partials out along "rep" in one process and runs one ``psum``).

Reference scope note: the reference has no distributed computing
(SURVEY section 2.5); its closest analogue is multi-replica file
aggregation (calculate-fitted-Ct.py:113-147).
"""

from __future__ import annotations

from typing import Iterable, NamedTuple, Sequence

import torch

from ..ops import autocorr
from . import mesh as pm


class CtPartial(NamedTuple):
    """One host's streamed contribution.

    acc_s, acc_s2 : (nDeltas, nRes) lag-leading sums of the SHIFTED
        per-chunk lag means (e = per - 1; ``palmer_pooled_stats``) and of
        their squares; count : 0-d tensor, the chunks ingested.
    """

    acc_s: torch.Tensor
    acc_s2: torch.Tensor
    count: torch.Tensor


def host_stream(chunk_iter: Iterable, n_frames_per_chunk: int) -> CtPartial:
    """One host's ingest loop: ``autocorr.stream_accumulate``, the loop
    ``ct_palmer_streamed`` runs, so the one-host and multi-host paths
    cannot drift apart."""
    try:
        acc_s, acc_s2, count = autocorr.stream_accumulate(chunk_iter, n_frames_per_chunk)
    except ValueError as e:
        if "empty chunk iterator" in str(e):
            raise ValueError("host ingested no chunks") from None
        raise
    return CtPartial(acc_s, acc_s2,
                     torch.tensor(float(count), dtype=acc_s.dtype, device=acc_s.device))


def reduce_partials(partials: Sequence[CtPartial]):
    """Host-side reduction of per-host partials -> (Ct, dCt), each
    (nDeltas, nRes).  (sum, sum of squares, count) addition is associative
    and weight-correct: a host that ingested fewer chunks contributes
    exactly its share."""
    acc_s = torch.stack([p.acc_s for p in partials]).sum(dim=0)
    acc_s2 = torch.stack([p.acc_s2 for p in partials]).sum(dim=0)
    count = float(sum(float(p.count) for p in partials))
    return autocorr.palmer_pooled_stats(acc_s, acc_s2, count)


def reduce_partials_collective(partial: CtPartial, mesh):
    """The same reduction as one all-reduce over "rep": each rank brings
    the partial of its "rep" row (one host per row; the ranks of a row,
    its "res" ranks, hold the same partial), and every rank returns the
    pooled (Ct, dCt).  A collective: every rank calls it."""
    acc_s = partial.acc_s.to(pm.device_of(mesh))
    n = acc_s.numel()
    flat = torch.cat([acc_s.reshape(-1), partial.acc_s2.to(acc_s).reshape(-1),
                      torch.as_tensor(partial.count).to(acc_s).reshape(1)])
    pm.all_reduce(flat, mesh, "rep")
    return autocorr.palmer_pooled_stats(flat[:n].reshape(acc_s.shape),
                                        flat[n : 2 * n].reshape(acc_s.shape), flat[-1])
