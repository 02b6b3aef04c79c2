"""Global rotational-diffusion models (port of
``spinrelax_tpu/models/diffusion.py:31 Diffusion``).

Storage follows the reference's (Diso, Daniso) convention; Dx <= Dy <= Dz,
so the unique axis is z when Daniso > 1 (prolate) and x when Daniso < 1
(oblate) (spectral_densities.py:503-526).  Parameters are float64 CPU
scalars; :meth:`Diffusion.j_combined` moves them to the dtype and device
of the C(t) parameters it combines them with.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..ops import jomega as jw

ISOTROPIC = "isotropic"
AXISYMMETRIC = "axisymmetric"
ELLIPSOID = "ellipsoid"
DIRECT = "direct"


def _f64(x):
    if torch.is_tensor(x):
        return x.to("cpu", torch.float64)
    return torch.tensor(x, dtype=torch.float64)  # a copy: numpy input may be read-only


@dataclasses.dataclass
class Diffusion:
    """Global rotational diffusion tensor.

    kind  : isotropic / axisymmetric / ellipsoid / direct.
    diso  : isotropic rate 1 / (6 tau_iso), in 1/<time_unit>.
    aniso : Daniso = Dpar / Dperp (axisymmetric; 1.0 otherwise).
    dxyz  : (3,) Dx <= Dy <= Dz for the fully anisotropic kind.
    """

    kind: str
    diso: torch.Tensor = dataclasses.field(default_factory=lambda: _f64(0.0))
    aniso: torch.Tensor = dataclasses.field(default_factory=lambda: _f64(1.0))
    dxyz: Optional[torch.Tensor] = None

    # -- constructors ---------------------------------------------------
    @staticmethod
    def isotropic(diso=None, tau=None) -> "Diffusion":
        if diso is None:
            diso = 1.0 / (6.0 * tau)
        return Diffusion(kind=ISOTROPIC, diso=_f64(diso), aniso=_f64(1.0))

    @staticmethod
    def axisymmetric(diso=None, aniso=None, tau=None, dpar=None, dperp=None) -> "Diffusion":
        if dpar is not None:
            # (Dpar, Dperp) -> (Diso, Daniso) (spectral_densities.py:475-482)
            diso = (2.0 * dperp + dpar) / 3.0
            aniso = dpar / dperp
        elif diso is None:
            diso = 1.0 / (6.0 * tau)
        return Diffusion(kind=AXISYMMETRIC, diso=_f64(diso), aniso=_f64(aniso))

    @staticmethod
    def ellipsoid(dxyz) -> "Diffusion":
        dxyz = torch.sort(_f64(dxyz)).values
        return Diffusion(kind=ELLIPSOID, diso=torch.mean(dxyz),
                         aniso=2.0 * dxyz[2] / (dxyz[0] + dxyz[1]), dxyz=dxyz)

    @staticmethod
    def direct() -> "Diffusion":
        """No global tumbling: J is the direct transform of the local C(t)
        (spectral_densities.py:1464-1467)."""
        return Diffusion(kind=DIRECT, diso=_f64(float("nan")))

    # -- derived --------------------------------------------------------
    @property
    def tau_iso(self):
        return 1.0 / (6.0 * self.diso)

    def dpar_dperp(self):
        """(Dpar, Dperp) from (Diso, Daniso) (spectral_densities.py:535-540)."""
        return jw.symmtop_from_diso_aniso(self.diso, self.aniso)

    @property
    def prolate(self):
        return self.aniso > 1.0

    def with_diso(self, diso) -> "Diffusion":
        """Replace Diso.  The ellipsoid kind rescales its three principal
        values by diso / Diso_old (shape kept), so a Diso fit moves its J
        (the reference exits here, spectral_densities.py:1545-1547)."""
        diso = _f64(diso)
        if self.kind == ELLIPSOID:
            return dataclasses.replace(self, diso=diso, dxyz=self.dxyz * (diso / self.diso))
        return dataclasses.replace(self, diso=diso)

    def with_aniso(self, aniso) -> "Diffusion":
        if self.kind == ELLIPSOID:
            # One anisotropy ratio does not determine three principal values.
            raise ValueError(
                "with_aniso is undefined for the ellipsoid kind "
                "(set the principal values via Diffusion.ellipsoid)"
            )
        return dataclasses.replace(self, aniso=_f64(aniso))

    # -- J(omega) -------------------------------------------------------
    def j_combined(self, omega, S2, C, tau, mask=None, vecs=None, zeta=1.0):
        """J(omega) of this tumbling model combined with local C(t)
        parameters.  S2 (nRes,), C/tau/mask (nRes, K); ``vecs`` (nRes,
        [nSamp,] 3) diffusion-frame vectors, needed by the anisotropic
        kinds.  Returns (nRes, [nSamp,] nOm)."""
        def on(x):
            return x.to(dtype=S2.dtype, device=S2.device)

        omega = torch.as_tensor(omega, dtype=S2.dtype, device=S2.device)
        if self.kind == ISOTROPIC:
            return jw.j_combine_isotropic(omega, on(self.tau_iso), S2, C, tau,
                                          comp_mask=mask, zeta=zeta)
        if self.kind in (AXISYMMETRIC, ELLIPSOID):
            if vecs is None:
                raise ValueError(f"{self.kind} diffusion requires PAF vectors")
            vecs = torch.as_tensor(vecs, dtype=S2.dtype, device=S2.device)
            extra = vecs.ndim - S2.ndim - 1  # residue parameters over samples
            S2b = S2.reshape(S2.shape + (1,) * extra)
            Cb = C.reshape(C.shape[:-1] + (1,) * extra + C.shape[-1:])
            taub = tau.reshape(tau.shape[:-1] + (1,) * extra + tau.shape[-1:])
            maskb = None if mask is None else mask.reshape(
                mask.shape[:-1] + (1,) * extra + mask.shape[-1:])
            if self.kind == AXISYMMETRIC:
                dpar, dperp = self.dpar_dperp()
                return jw.j_combine_symmtop(omega, vecs, on(dpar), on(dperp), S2b, Cb,
                                            taub, comp_mask=maskb, zeta=zeta)
            return jw.j_combine_ellipsoid(omega, vecs, on(self.dxyz), S2b, Cb, taub,
                                          comp_mask=maskb, zeta=zeta)
        if self.kind == DIRECT:
            C_eff = C * (mask if mask is not None else 1.0)
            return zeta * jw.j_direct_transform(omega, C_eff, tau)
        raise ValueError(f"unknown diffusion kind {self.kind!r}")

    def j_rigid(self, omega, vecs=None):
        """Rigid-body J of this tumbling model (spectral_densities.py:
        460-461, 600-603), in float64 on the device of ``vecs`` (the CPU
        for the isotropic kind)."""
        if self.kind == ISOTROPIC:
            return jw.j_rigid_sphere_D(omega, self.diso)
        vecs = torch.as_tensor(vecs, dtype=torch.float64)
        if self.kind == AXISYMMETRIC:
            dpar, dperp = self.dpar_dperp()
            return jw.j_rigid_symmtop(omega, vecs, dpar, dperp)
        if self.kind == ELLIPSOID:
            return jw.j_rigid_ellipsoid(omega, vecs, self.dxyz)
        raise ValueError(f"no rigid J for kind {self.kind!r}")
