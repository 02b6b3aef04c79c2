"""Dense batched multi-exponential autocorrelation models (port of
``spinrelax_tpu/models/ctmodel.py:23 CtModelSet``).

Every residue's C(t) = zeta (S2 + sum_i C_i exp(-t / tau_i)) lives in
fixed-shape (nRes, K) tensors with a validity mask
(fitting_Ct_functions.py:12-427 keeps one object per residue).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import checked_device


@dataclasses.dataclass
class CtModelSet:
    """Struct-of-tensors set of per-residue multi-exponential C(t) models.

    S2    : (nRes,) the slow-limit order parameter S2_0.
    C     : (nRes, K) transient amplitudes (padded with 0).
    tau   : (nRes, K) transient time constants (padded with 1).
    mask  : (nRes, K) 1.0 for real components, 0.0 for padding.
    zeta  : () global zero-point-vibration scaling
            (fitting_Ct_functions.py:211-222).
    s2fast: (nRes,) 0/1: whether the model carries an implicit fast
            component S2_fast = 1 - S2 - sum(C) (fitting_Ct_functions.py:
            197-201).

    The optional fit metadata (uncertainties, chi-square) mirror the
    reference's report headers.  All tensors share one device and dtype.
    """

    S2: torch.Tensor
    C: torch.Tensor
    tau: torch.Tensor
    mask: torch.Tensor
    zeta: torch.Tensor
    s2fast: torch.Tensor
    dS2: Optional[torch.Tensor] = None
    dC: Optional[torch.Tensor] = None
    dtau: Optional[torch.Tensor] = None
    chisq: Optional[torch.Tensor] = None
    names: List[str] = dataclasses.field(default_factory=list)

    # -- construction ---------------------------------------------------
    @staticmethod
    def from_lists(
        names: Sequence[str],
        S2: Sequence[float],
        C_list: Sequence[Sequence[float]],
        tau_list: Sequence[Sequence[float]],
        s2fast: Optional[Sequence[bool]] = None,
        zeta: float = 1.0,
        max_comps: Optional[int] = None,
        dS2=None,
        dC_list=None,
        dtau_list=None,
        chisq=None,
        sort: bool = True,
        device="cuda",
    ) -> "CtModelSet":
        """Build from ragged per-residue lists (as parsed from a
        ``*_fittedCt.dat`` file), padded to a common K, components sorted
        fast-to-slow like the reference (fitting_Ct_functions.py:203-209).
        Float64, on the card unless ``device="cpu"``."""
        dev = checked_device(device)
        n = len(names)
        K = max(max_comps or max((len(c) for c in C_list), default=1), 1)
        C = np.zeros((n, K))
        tau = np.ones((n, K))
        mask = np.zeros((n, K))
        dC = np.zeros((n, K))
        dtau = np.zeros((n, K))
        for i, (cs, ts) in enumerate(zip(C_list, tau_list)):
            cs = np.asarray(cs, dtype=float)
            ts = np.asarray(ts, dtype=float)
            # dC and dtau are independent: either may come without the other.
            dc = np.asarray(dC_list[i], dtype=float) if dC_list is not None else None
            dtv = np.asarray(dtau_list[i], dtype=float) if dtau_list is not None else None
            if sort and len(ts) > 1:
                order = np.argsort(ts)
                cs, ts = cs[order], ts[order]
                if dc is not None:
                    dc = dc[order]
                if dtv is not None:
                    dtv = dtv[order]
            k = len(cs)
            C[i, :k] = cs
            tau[i, :k] = ts
            mask[i, :k] = 1.0
            if dc is not None:
                dC[i, :k] = dc
            if dtv is not None:
                dtau[i, :k] = dtv
        if s2fast is None:
            s2fast = [False] * n

        def t(a):
            return None if a is None else torch.tensor(np.asarray(a, dtype=float),
                                                        dtype=torch.float64, device=dev)

        return CtModelSet(
            S2=t(S2), C=t(C), tau=t(tau), mask=t(mask), zeta=t(float(zeta)),
            s2fast=t(s2fast), dS2=t(dS2),
            dC=None if dC_list is None else t(dC),
            dtau=None if dtau_list is None else t(dtau),
            chisq=t(chisq), names=[str(x) for x in names],
        )

    # -- properties -----------------------------------------------------
    @property
    def n_models(self) -> int:
        return self.S2.shape[0]

    @property
    def max_comps(self) -> int:
        return self.C.shape[1]

    def n_comps(self):
        return torch.sum(self.mask, dim=-1).to(torch.int32)

    def s2_fast(self):
        """S2_fast = 1 - S2 - sum(C) where enabled, else 0
        (fitting_Ct_functions.py:197-201)."""
        val = 1.0 - self.S2 - torch.sum(self.C * self.mask, dim=-1)
        return torch.where(self.s2fast > 0, val, torch.zeros_like(val))

    # -- evaluation -----------------------------------------------------
    def eval(self, dt):
        """C(t) curves (nRes, nT) = zeta (S2 + sum_i C_i e^(-t/tau_i))
        (fitting_Ct_functions.py:266-270)."""
        dt = torch.as_tensor(dt, dtype=self.S2.dtype, device=self.S2.device)
        decay = torch.exp(-dt[None, None, :] / self.tau[:, :, None])
        s = torch.sum(self.C[:, :, None] * self.mask[:, :, None] * decay, dim=1)
        return self.zeta * (self.S2[:, None] + s)

    def select(self, idx) -> "CtModelSet":
        """Subset of residues, names kept aligned.  Integer indices or a
        boolean mask."""
        idx = np.asarray(idx.cpu() if torch.is_tensor(idx) else idx)
        if idx.dtype == bool:
            idx = np.nonzero(idx)[0]
        sel = torch.as_tensor(idx, dtype=torch.long, device=self.S2.device)

        def take(a):
            return None if a is None else a[sel]

        return CtModelSet(
            S2=take(self.S2), C=take(self.C), tau=take(self.tau),
            mask=take(self.mask), zeta=self.zeta, s2fast=take(self.s2fast),
            dS2=take(self.dS2), dC=take(self.dC), dtau=take(self.dtau),
            chisq=take(self.chisq), names=[self.names[int(i)] for i in idx],
        )

    def with_zeta(self, zeta: float) -> "CtModelSet":
        return dataclasses.replace(
            self, zeta=torch.tensor(float(zeta), dtype=self.S2.dtype,
                                    device=self.S2.device))
