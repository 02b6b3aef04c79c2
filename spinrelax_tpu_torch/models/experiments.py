"""Multi-experiment manager: dense-mask alignment of experimental peaks to
the simulated residues (port of ``spinrelax_tpu/models/experiments.py``).

Replaces ``spinRelaxationExperiments`` (spectral_densities.py:909-1447).
The reference keeps ragged per-experiment index lists
(``mapModelNames``/``mapExptCoverage``, :1051-1091); here each experiment
is aligned to the model residue axis once on the host, giving dense
(nRes,) target/error/mask arrays, and those go to the device of the C(t)
models once per set (:meth:`ExperimentSet.device_arrays`), so every
chi-square evaluation is a fixed-shape computation with no copy.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..constants import NucleusPair, field_from_hz, field_from_mhz
from ..io.experiments import ExperimentData
from ..ops import jomega as jw
from .ctmodel import CtModelSet
from .diffusion import Diffusion


@dataclasses.dataclass
class AlignedExperiment:
    """One experiment aligned onto the simulated residue axis."""

    expt_type: str  # 'R1' | 'R2' | 'NOE'
    pair: NucleusPair
    target: np.ndarray  # (nRes,) experimental values (0 where uncovered)
    error: Optional[np.ndarray]  # (nRes,) or None
    mask: np.ndarray  # (nRes,) 1.0 where the experiment covers the residue
    raw: ExperimentData = None


@dataclasses.dataclass
class DeviceArrays:
    """An ExperimentSet's fixed inputs on the device of its C(t) models,
    float64: per experiment (target, error or None, mask) and the index of
    its pair in ``pairs`` (the unique NucleusPairs, in first-seen order);
    ``omega`` the pairs' omega5 grids concatenated (5 * nPairs,); the
    vector ensemble and its weights; ``covered`` (nRes,) bool; ``counts``
    each experiment's covered residues, over every rank of a sharded set."""

    targets: list
    pair_of: List[int]
    pairs: List[NucleusPair]
    omega: torch.Tensor
    vecs: Optional[torch.Tensor]
    weights: Optional[torch.Tensor]
    covered: torch.Tensor
    counts: List[torch.Tensor]  # per experiment: residues covered (all ranks)


@dataclasses.dataclass
class ExperimentSet:
    """All experiments + shared physical model, ready for fitting."""

    experiments: List[AlignedExperiment]
    cts: CtModelSet
    diffusion: Diffusion
    vecs: Optional[np.ndarray] = None  # (nRes, nSamp, 3)
    weights: Optional[np.ndarray] = None  # (nRes, nSamp)
    csa: Optional[np.ndarray] = None  # (nRes,) residue-specific CSA or None
    # Residue-sharded sets (parallel.fit.shard_experiment_set): the mesh,
    # and the residue count over every rank (padding included).
    mesh: object = None
    n_total: Optional[int] = None

    @property
    def n_experiments(self) -> int:
        return len(self.experiments)

    @property
    def n_residues(self) -> int:
        return self.cts.n_models

    @property
    def device(self) -> torch.device:
        return self.cts.S2.device

    @property
    def n_global(self) -> int:
        """Residues over every rank (the set's own count when unsharded)."""
        return self.n_residues if self.n_total is None else self.n_total

    def residue_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x``, this rank's sums over its residues, summed over every rank
        of a sharded set's mesh (one all-reduce; a new tensor, outside
        autograd); ``x`` itself when the set is not sharded.  Every sum over
        residues of the fit goes through here."""
        if self.mesh is None:
            return x
        from ..parallel import mesh as pm

        return pm.all_reduce(x.detach().clone(), self.mesh)

    def gather_residues(self, x: torch.Tensor) -> torch.Tensor:
        """A per-residue (nRes, ...) tensor of a sharded set from every
        rank (``parallel.mesh.fetch``); ``x`` itself when not sharded."""
        if self.mesh is None:
            return x
        from ..parallel import mesh as pm

        return pm.fetch(x, self.mesh)

    def symmtop_a_moments(self):
        """Cached numpy (mu_p, cov_p, mu_o, cov_o) A-coefficient moments of
        the vector ensemble (``ops.jomega.a_moments_symmtop``): geometry
        only, so computed once per set.  Needs ``vecs`` with a sample
        axis."""
        cached = getattr(self, "_a_moments", None)
        if cached is None:
            cached = jw.a_moments_symmtop(self.vecs, self.weights)
            object.__setattr__(self, "_a_moments", cached)
        return cached

    def symmtop_a_moments_device(self):
        """:meth:`symmtop_a_moments` as float64 tensors on the set's device,
        moved there once."""
        cached = getattr(self, "_a_moments_dev", None)
        if cached is None:
            cached = tuple(torch.as_tensor(m, dtype=torch.float64, device=self.device)
                           for m in self.symmtop_a_moments())
            object.__setattr__(self, "_a_moments_dev", cached)
        return cached

    def device_arrays(self) -> DeviceArrays:
        """The set's fixed inputs on its device (:class:`DeviceArrays`),
        built once per set."""
        cached = getattr(self, "_device_arrays", None)
        if cached is not None:
            return cached
        dev = self.device

        def t(a):
            return None if a is None else torch.as_tensor(
                np.asarray(a, dtype=np.float64), device=dev)

        pairs: List[NucleusPair] = []
        pair_of = []
        for e in self.experiments:
            if e.pair not in pairs:
                pairs.append(e.pair)
            pair_of.append(pairs.index(e.pair))
        cached = DeviceArrays(
            targets=[(t(e.target), t(e.error), t(e.mask)) for e in self.experiments],
            pair_of=pair_of,
            pairs=pairs,
            omega=t(np.concatenate([np.asarray(p.omega5()) for p in pairs])),
            vecs=t(self.vecs),
            weights=t(self.weights),
            covered=torch.as_tensor(self.coverage_counts() > 0, device=dev),
            counts=[self.residue_sum(torch.sum(t(e.mask))) for e in self.experiments],
        )
        object.__setattr__(self, "_device_arrays", cached)
        return cached

    def coverage_counts(self) -> np.ndarray:
        """Experiments covering each residue (report_maps analogue)."""
        if not self.experiments:
            return np.zeros(self.n_residues)
        return np.sum([e.mask for e in self.experiments], axis=0)

    @staticmethod
    def build(
        expt_list: Sequence[ExperimentData],
        cts: CtModelSet,
        diffusion: Diffusion,
        vecs=None,
        weights=None,
        vec_names=None,
        csa=None,
        time_unit: str = "ps",
    ) -> "ExperimentSet":
        """Align every experiment's peaks to the CtModelSet residue names
        (map_experiment_peaknames_to_models semantics,
        spectral_densities.py:1051-1091).  The set lives on the device of
        ``cts``."""
        model_names = [str(n) for n in cts.names]
        if vec_names is not None:
            vn = [str(n) for n in vec_names]
            if vn != model_names:
                raise ValueError(
                    "local C(t) and vector-distribution residue names differ: "
                    f"{model_names[:5]}... vs {vn[:5]}..."
                )
        n_res = len(model_names)
        name_to_idx = {n: i for i, n in enumerate(model_names)}
        aligned = []
        for e in expt_list:
            target = np.zeros(n_res)
            error = np.zeros(n_res)
            mask = np.zeros(n_res)
            has_err = e.errors is not None
            n_unmatched = 0
            for p, name in enumerate(e.names):
                i = name_to_idx.get(str(name))
                if i is None:
                    n_unmatched += 1
                    continue
                if mask[i]:
                    # Duplicate peak row: the first occurrence wins, as the
                    # reference's np.where(...)[0][0] lookup
                    # (spectral_densities.py:1088-1091); conflicting
                    # duplicates usually mean a mangled file.
                    warnings.warn(
                        f"experiment {e.expt_type}: duplicate peak "
                        f"{name!r} ignored (first value kept)"
                    )
                    continue
                target[i] = e.values[p]
                if has_err:
                    error[i] = e.errors[p]
                mask[i] = 1.0
            if n_unmatched:
                warnings.warn(
                    f"experiment {e.expt_type}: {n_unmatched}/"
                    f"{len(e.names)} peaks match no simulated residue"
                )
            freq = e.frequency
            if e.freq_unit == "MHz":
                B0 = field_from_mhz(freq)
            elif e.freq_unit == "Hz":
                B0 = field_from_hz(freq)
            elif e.freq_unit == "T":
                B0 = freq
            else:
                raise ValueError(f"unknown frequency unit {e.freq_unit!r}")
            pair = NucleusPair(
                isotope_a=e.nuclei_a, isotope_b=e.nuclei_b, B0=B0, time_unit=time_unit
            )
            aligned.append(
                AlignedExperiment(
                    expt_type=e.expt_type,
                    pair=pair,
                    target=target,
                    error=error if has_err else None,
                    mask=mask,
                    raw=e,
                )
            )
        return ExperimentSet(
            experiments=aligned,
            cts=cts,
            diffusion=diffusion,
            vecs=None if vecs is None else np.asarray(vecs),
            weights=None if weights is None else np.asarray(weights),
            csa=None if csa is None else np.asarray(csa),
        )
