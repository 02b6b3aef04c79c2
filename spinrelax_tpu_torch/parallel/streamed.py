"""The streamed C(t) pipeline, on one card and sharded over a ("rep",
"res") mesh (port of ``spinrelax_tpu/parallel/streamed.py``).

- :class:`ShardedCtStream` accumulates Palmer C(t) over groups of chunks:
  each group's chunk axis shards over "rep" and its residues over "res";
  every rank runs kernel A on its local block and one all-reduce over
  "rep" per sum (the JAX package's ``shard_map`` step, written by hand).
- :func:`run_finish` is the finish: pooled Palmer statistics ->
  DoF-ladder model selection -> J(omega) with vector ensembles ->
  ensemble rates (what ``stage_fit_ct`` + ``stage_relax`` compute), on
  one card or, with ``mesh=`` (:func:`run_sharded_finish`), with the
  residues over every rank, so each rank's LMs (kernels B and C on the
  card) fit its slice, and the rates gathered;
  :func:`make_sharded_finish` does the same for the fixed-K forward.

Accumulators are lag-leading (nDeltas, nRes), kernel A's orientation; a
JAX ``ShardedCtStream``'s are their transpose.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..constants import NucleusPair
from ..ops import autocorr
from . import mesh as pm


def _pad_to(n: int, mult: int) -> int:
    return (-(-n // mult)) * mult


class ShardedCtStream:
    """Streaming Palmer C(t) accumulator over a ("rep", "res") mesh: the
    statistics of ``ops.autocorr.ct_palmer`` over the concatenated stream
    (shifted running sums, the reference's sqrt(n)-1 SEM).

    Every rank feeds :meth:`update` the same (g, nFrames, nRes, 3) groups
    and keeps its block.  A group's chunks pad to a multiple of the "rep"
    size with zero WEIGHTS (and, as in the JAX package, up to the first
    group's padded size), so padding never touches the statistics; the
    residues pad once to a multiple of the "res" size with zero vectors,
    sliced off at :meth:`finalize`.  A block that needs no padding (every
    block of a one-rank mesh) goes to kernel A as it lies in the group.
    """

    def __init__(self, mesh, n_frames_per_chunk: int, n_res: int,
                 dtype=torch.float32):
        self.mesh = mesh
        self.n_frames = int(n_frames_per_chunk)
        self.n_deltas = self.n_frames // 2
        self.n_res = int(n_res)
        self.rep_dim, self.res_dim = pm.dims(mesh)
        self.n_res_pad = _pad_to(self.n_res, self.res_dim)
        self.dtype = dtype
        self.device = pm.device_of(mesh)
        self._rep_i, res_j = pm.coordinate(mesh)
        self._n_loc = self.n_res_pad // self.res_dim  # residues a rank holds
        self._r0 = res_j * self._n_loc  # its first
        self._g_canon = None  # first-seen padded group size
        self.reset()

    def reset(self) -> None:
        """Zero the accumulators."""
        z = dict(dtype=self.dtype, device=self.device)
        self._acc_s = torch.zeros((self.n_deltas, self._n_loc), **z)
        self._acc_s2 = torch.zeros((self.n_deltas, self._n_loc), **z)
        self._count = torch.zeros((), **z)

    def update(self, group) -> None:
        """Add one (g, n_frames_per_chunk, n_res, 3) group (a tensor on any
        device, or numpy): this rank's block of it goes to its device,
        kernel A runs on the block, and the three sums are all-reduced
        over "rep"."""
        g, F, N = group.shape[0], group.shape[1], group.shape[2]
        if F != self.n_frames:
            raise ValueError(f"group has {F} frames/chunk, expected {self.n_frames}")
        if N not in (self.n_res, self.n_res_pad):
            raise ValueError(f"group has {N} residues, expected {self.n_res}")
        g_pad = _pad_to(g, self.rep_dim)
        if self._g_canon is not None:
            g_pad = max(g_pad, self._g_canon)
        self._g_canon = g_pad
        g_loc = g_pad // self.rep_dim
        c0 = self._rep_i * g_loc
        nc = max(0, min(g_loc, g - c0))
        r0, n_loc = self._r0, self._n_loc
        nr = max(0, min(r0 + n_loc, N) - r0)
        block = torch.as_tensor(group[c0 : c0 + nc, :, r0 : r0 + nr])
        block = block.to(self.device, self.dtype)
        w = None
        if nc < g_loc or nr < n_loc:  # pad this rank's block
            full = torch.zeros((g_loc, F, n_loc, 3), dtype=self.dtype, device=self.device)
            full[:nc, :, :nr] = block
            block = full
            w = torch.zeros(g_loc, dtype=self.dtype, device=self.device)
            w[:nc] = 1.0
        ps, ps2 = autocorr.palmer_group_sums(block, w)
        cnt = torch.full((), float(nc), dtype=self.dtype, device=self.device)
        for t in (ps, ps2, cnt):
            pm.all_reduce(t, self.mesh, "rep")
        self._acc_s = self._acc_s + ps
        self._acc_s2 = self._acc_s2 + ps2
        self._count = self._count + cnt

    @property
    def n_chunks(self) -> int:
        return int(self._count)

    def accumulators(self):
        """(acc_s, acc_s2, count): this rank's "res" block of the
        lag-leading shifted sums, (nDeltas, n_res_pad / res), and the chunk
        count (0-d tensor, equal on every rank)."""
        return self._acc_s, self._acc_s2, self._count

    def finalize(self):
        """-> (Ct, dCt), each (nDeltas, nRes), on every rank."""
        acc_s, acc_s2 = gather_accumulators(self.mesh, self._acc_s, self._acc_s2)
        return autocorr.palmer_pooled_stats(acc_s[:, : self.n_res],
                                            acc_s2[:, : self.n_res], self._count)


def gather_accumulators(mesh, acc_s, acc_s2):
    """The whole (nDeltas, n_res_pad) accumulators from every rank's "res"
    block (a collective over "res")."""
    grp = pm.group(mesh, "res")
    return pm.all_gather(acc_s, grp, dim=1), pm.all_gather(acc_s2, grp, dim=1)


class StreamedRates(NamedTuple):
    Ct: torch.Tensor  # (nRes, nDeltas)
    dCt: torch.Tensor
    S2: torch.Tensor  # (nRes,)
    C: torch.Tensor
    tau: torch.Tensor
    R1: torch.Tensor
    R2: torch.Tensor
    NOE: torch.Tensor
    rho: torch.Tensor


def _pack(cols):
    """(B, ...) tensors -> one (B, X) tensor (for one gather)."""
    return torch.cat([c.reshape(c.shape[0], -1).to(cols[0].dtype) for c in cols], dim=1)


def _unpack(packed, like):
    """Inverse of :func:`_pack`, shapes after the first axis from ``like``."""
    out, i = [], 0
    for c in like:
        w = int(np.prod(c.shape[1:], dtype=int))
        out.append(packed[:, i : i + w].reshape((packed.shape[0],) + tuple(c.shape[1:])))
        i += w
    return out


def make_sharded_finish(mesh, delta_t: float = 1.0, tau_iso: float = 4242.0,
                        n_components: int = 2, pair: Optional[NucleusPair] = None,
                        zeta: float = 1.0):
    """The post-stream stage with residues over every rank: multi-exp LM
    fit (kernels B and C on the card) -> isotropic J(omega) ->
    R1/R2/NOE/rho.  The returned ``finish(acc_s, acc_s2, count)`` takes
    :meth:`ShardedCtStream.accumulators` as they are and returns
    :class:`StreamedRates` over the padded residues, on every rank."""
    from ..convert import forward_kwargs_from_jax
    from .pipeline import fit_to_rates

    kw = forward_kwargs_from_jax(pair, tau_iso, delta_t, n_components, zeta)

    def finish(acc_s, acc_s2, count):
        acc_s, acc_s2 = gather_accumulators(mesh, acc_s, acc_s2)
        mean, dct = autocorr.palmer_pooled_stats(acc_s, acc_s2, count)
        mean, dct = mean.T.contiguous(), dct.T.contiguous()  # (nResPad, nDeltas)
        (m_loc, d_loc), n = pm.pad_and_shard(mesh, [mean, dct])
        cols = list(fit_to_rates(m_loc.T, d_loc.T, **kw)[2:])
        full = _unpack(pm.fetch(_pack(cols), mesh, n), cols)
        return StreamedRates(mean, dct, *full)

    return finish


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
    mesh=None,
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
    mesh : optional ("rep", "res") mesh, for :func:`run_sharded_finish`:
        the accumulators are this rank's "res" block
        (:meth:`ShardedCtStream.accumulators`), gathered first; each rung's
        LMs fit the rank's residue slice (``fit_ct_ladder(mesh=)``: the
        selection walk runs on every rank over the gathered rung results);
        the rates are computed on the rank's slice (``vecs``, ``weights``
        and ``csa`` pad with row 0 as ``pad_and_shard`` does; a scalar
        ``csa`` first takes the residue axis) and gathered.  Every rank
        returns the whole result.
    """
    from ..fit.expfit import fit_ct_ladder

    pair = pair or NucleusPair(time_unit="ps")
    if mesh is not None:
        acc_s, acc_s2 = gather_accumulators(mesh, acc_s, acc_s2)
    mean, dct = autocorr.palmer_pooled_stats(acc_s, acc_s2, count)
    Ct = mean[:, :n_res].T.contiguous()  # (nRes, nDeltas)
    dCt = dct[:, :n_res].T.contiguous()
    dt = (torch.arange(Ct.shape[1], dtype=torch.float64) + 1.0) * delta_t
    if names is None:
        names = [str(i) for i in range(n_res)]
    # NaN dCt (one-chunk streams) become weight 1 inside fit_ct_ladder.
    cts = fit_ct_ladder(names, dt, Ct, ddecays=dCt, use_s2fast=use_s2fast,
                        n_components=n_components, chisq_threshold=chisq_threshold,
                        zeta=zeta, mesh=mesh)
    if mesh is None:
        return FlagshipRates(Ct, dCt, cts,
                             *_predict(pair, diffusion, cts, vecs, weights, csa, Ct.device))

    def put(a):
        if a is None:
            return None
        a = torch.as_tensor(a if torch.is_tensor(a) else np.asarray(a), dtype=torch.float64)
        if a.ndim == 0:
            a = a.expand(n_res)
        return pm.pad_and_shard(mesh, [a])[0][0]

    idx = pm.pad_and_shard(mesh, [torch.arange(n_res)])[0][0]
    rates = _predict(pair, diffusion, cts.select(idx), put(vecs), put(weights), put(csa),
                     Ct.device)
    have = [r for r in rates if r is not None]
    full = iter(_unpack(pm.fetch(_pack(have), mesh, n_res), have))
    return FlagshipRates(Ct, dCt, cts, *(None if r is None else next(full) for r in rates))


def _predict(pair, diffusion, cts, vecs, weights, csa, device):
    """``predict_rates`` in float64 on ``device``."""
    from ..ops import observables as obs

    def on(a):
        return None if a is None else torch.as_tensor(a, dtype=torch.float64, device=device)

    return obs.predict_rates(pair, diffusion, cts, vecs=on(vecs), weights=on(weights),
                             csa=on(csa))


def run_sharded_finish(mesh, acc_s, acc_s2, count, **kwargs) -> FlagshipRates:
    """:func:`run_finish` with residues over the mesh (its ``mesh=``):
    every rank's :meth:`ShardedCtStream.accumulators` in, the whole
    result out on every rank."""
    return run_finish(acc_s, acc_s2, count, mesh=mesh, **kwargs)


def run_streamed_pipeline(chunk_iter, mesh, n_frames_per_chunk: int, n_res: int,
                          delta_t: float = 1.0, tau_iso: float = 4242.0,
                          n_components: int = 2, dtype=None) -> StreamedRates:
    """End-to-end sharded streaming run: every rank consumes the same
    iterator of (g, F, nRes, 3) Palmer-chunk groups (:class:`ShardedCtStream`),
    then :func:`make_sharded_finish`; dtype defaults to the first group's.
    Returns StreamedRates sliced to the true n_res, on every rank."""
    stream = None
    for group in chunk_iter:
        if stream is None:
            stream = ShardedCtStream(mesh, n_frames_per_chunk, n_res,
                                     dtype=dtype or torch.as_tensor(group[:0]).dtype)
        stream.update(group)
    if stream is None:
        raise ValueError("empty chunk iterator")
    finish = make_sharded_finish(mesh, delta_t=delta_t, tau_iso=tau_iso,
                                 n_components=n_components)
    out = finish(*stream.accumulators())
    return StreamedRates(*(x[:n_res] for x in out))
