"""Residue-sharded multi-field fitting (port of
``spinrelax_tpu/parallel/fit.py``).

Everything downstream of C(t) is embarrassingly parallel per residue.
:func:`shard_experiment_set` pads the residue axis of an
:class:`ExperimentSet` to a multiple of the rank count and keeps this
rank's block of every residue-leading array.  The set records its mesh,
and ``fit/globalfit`` sends every sum over residues through
``ExperimentSet.residue_sum`` (one all-reduce over the mesh) and gathers
the per-residue values the host reads, so every rank runs Powell, L-BFGS,
the device LM and the rsCSA walk on the same numbers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..models.experiments import ExperimentSet
from . import mesh as pm


def _pad(a, pad: int, fill=0.0):
    """Pad the leading axis of ``a`` (numpy or tensor) by ``pad`` rows of
    ``fill``, or copies of its last row for ``fill="edge"``."""
    if a is None or pad == 0:
        return a
    if torch.is_tensor(a):
        tail = a[-1:] if fill == "edge" else torch.full_like(a[:1], fill)
        return torch.cat([a, tail.expand((pad,) + tuple(a.shape[1:]))], dim=0)
    a = np.asarray(a)
    widths = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
    if fill == "edge":
        return np.pad(a, widths, mode="edge")
    return np.pad(a, widths, constant_values=fill)


def shard_experiment_set(es: ExperimentSet, mesh) -> ExperimentSet:
    """This rank's residue block of ``es``, padded over every rank to a
    multiple of the rank count, recording ``mesh``.

    Padded residues carry mask 0 everywhere (uncovered), tau 1, S2 1 and
    error 1, the other fields 0, and edge copies of the vector ensemble
    and its weights, so every statistic (masked means, coverage counts) is
    unchanged; chisq_total / chisq_per_residue / GlobalFitter work on the
    result as they are, each rank holding only its slice."""
    n = es.n_residues
    n_total = n + (-n) % dist.get_world_size()
    pad = n_total - n
    sl = pm.residue_sharding(mesh, n_total)

    def put(a, fill=0.0):
        return None if a is None else _pad(a, pad, fill)[sl]

    cts = es.cts
    cts_local = dataclasses.replace(
        cts,
        # fill 1: a padded residue must behave like a rigid rotor so its J
        # and R1 stay non-zero -- NOE divides by R1 (0/0 -> NaN would
        # poison even masked sums).
        S2=put(cts.S2, fill=1.0),
        C=put(cts.C),
        tau=put(cts.tau, fill=1.0),
        mask=put(cts.mask),
        s2fast=put(cts.s2fast),
        dS2=put(cts.dS2),
        dC=put(cts.dC),
        dtau=put(cts.dtau),
        chisq=put(cts.chisq),
        names=(list(cts.names) + [f"_pad{i}" for i in range(pad)])[sl],
    )
    expts = [
        dataclasses.replace(e, target=put(e.target), error=put(e.error, fill=1.0),
                            mask=put(e.mask))
        for e in es.experiments
    ]
    return dataclasses.replace(
        es,
        experiments=expts,
        cts=cts_local,
        # edge copies: padded residues need a REAL vector ensemble -- an
        # all-zero row gives 0/0 ensemble means and a zero variance whose
        # d(sqrt)/dp is NaN in forward mode, poisoning the LM Jacobian
        # through masked entries.
        vecs=put(es.vecs, fill="edge"),
        weights=put(es.weights, fill="edge"),
        csa=put(es.csa),
        mesh=mesh,
        n_total=n_total,
    )
