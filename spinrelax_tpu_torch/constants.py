"""Physical constants and unit handling for NMR spin relaxation.

The subset of ``spinrelax_tpu/constants.py`` the port uses, copied (plain
Python, no torch) so the port imports nothing of the JAX package:
gyromagnetic ratios, default CSA values, time/distance unit factors and
the dipole-dipole / CSA prefactors of the reference SpinRelax
(``spectral_densities.py:23-249``).  A JAX ``NucleusPair`` and this one
are interchangeable wherever the port takes a pair.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

# = = Gyromagnetic ratios, rad s^-1 T^-1 (reference: spectral_densities.py:50-67)
GYROMAGNETIC_RATIOS = {
    "1H": 267.513e6,
    "13C": 67.262e6,
    "15N": -27.116e6,
    "17O": -36.264e6,
    "19F": 251.662e6,
    "31P": 108.291e6,
}

# = = Default chemical-shift anisotropy per isotope (spectral_densities.py:39-48)
DEFAULT_CSA = {
    "15N": -170e-6,
    "13C": -130e-6,
}

# = = (mu_0 * hbar / 4 pi)^2 in SI; see derivation in the reference docstring
#     (spectral_densities.py:225-239).
MU0_HBAR_OVER_4PI_SQ = 1.1121216813552401e-82

# = = Default X-H effective bond length in nm (spectral_densities.py:164)
DEFAULT_R_XH_NM = 1.02e-1

# = = Default zeta: QM zero-point-vibration scaling (1.02/1.04)^6
#     (calculate-relaxations-from-Ct.py:512-515)
DEFAULT_ZETA = (1.02 / 1.04) ** 6

TIME_FACTORS = {
    "ps": 1.0e-12,
    "ns": 1.0e-9,
    "us": 1.0e-6,
    "ms": 1.0e-3,
    "s": 1.0,
}

DIST_FACTORS = {
    "pm": 1.0e-12,
    "A": 1.0e-10,
    "nm": 1.0e-9,
    "um": 1.0e-6,
    "mm": 1.0e-3,
    "m": 1.0,
}


def time_factor(unit: str) -> float:
    """Seconds per unit of ``unit`` (reference ``_return_time_fact``)."""
    try:
        return TIME_FACTORS[unit]
    except KeyError:
        raise ValueError(f"invalid time unit: {unit!r}") from None


def dist_factor(unit: str) -> float:
    """Metres per unit of ``unit`` (reference ``_return_dist_fact``)."""
    try:
        return DIST_FACTORS[unit]
    except KeyError:
        raise ValueError(f"invalid distance unit: {unit!r}") from None


# Bond-type -> heavy-nucleus isotope label (the reference's NH/CH bond
# naming, spectral_densities.py:1630-1645).
BOND_ISOTOPES = {"NH": "15N", "CH": "13C"}


def gamma(isotope: str) -> float:
    """Gyromagnetic ratio in rad s^-1 T^-1."""
    try:
        return GYROMAGNETIC_RATIOS[isotope]
    except KeyError:
        raise ValueError(f"unknown isotope: {isotope!r}") from None


def default_csa(isotope: str) -> float:
    return DEFAULT_CSA.get(isotope, 0.0)


def field_from_mhz(freq_mhz: float) -> float:
    """Magnetic field B0 [T] from a 1H frequency in MHz
    (spectral_densities.py:187-195)."""
    return 2.0 * math.pi * freq_mhz / 267.513


def field_to_mhz(B0: float) -> float:
    """1H frequency in MHz at a magnetic field B0 [T] (the inverse of
    :func:`field_from_mhz`)."""
    return B0 * 267.513 / (2.0 * math.pi)


def field_from_hz(freq_hz: float) -> float:
    return 2.0 * math.pi * freq_hz / 267.513e6


@dataclasses.dataclass(frozen=True)
class NucleusPair:
    """Static description of an X-H spin pair at a given field.

    Mirrors the roles of ``gyromag`` + ``angularFrequencies``
    (spectral_densities.py:23-249) but as an immutable dataclass whose
    derived quantities are plain floats — safe to close over under jit.

    Attributes
    ----------
    isotope_a : the heavy nucleus, e.g. "15N".
    isotope_b : the proton partner, "1H".
    B0        : magnetic field in Tesla.
    time_unit : internal time unit for frequencies / rate outputs.
    csa       : isotropic default CSA for nucleus A (dimensionless).
    r_ab_nm   : effective bond length in nm.
    """

    isotope_a: str = "15N"
    isotope_b: str = "1H"
    B0: float = field_from_mhz(600.0)
    time_unit: str = "ps"
    csa: Optional[float] = None
    r_ab_nm: float = DEFAULT_R_XH_NM

    @property
    def gamma_a(self) -> float:
        return gamma(self.isotope_a)

    @property
    def gamma_b(self) -> float:
        return gamma(self.isotope_b)

    @property
    def csa_value(self) -> float:
        return self.csa if self.csa is not None else default_csa(self.isotope_a)

    @property
    def time_fact(self) -> float:
        return time_factor(self.time_unit)

    def omega5(self):
        """The five NMR angular frequencies, in rad / <time_unit>:
        [0, wA, wB-wA, wB, wB+wA]  (spectral_densities.py:169-175).
        Returned as a plain tuple of floats to keep them static under jit.
        """
        tf = self.time_fact
        wA = -1.0 * self.gamma_a * self.B0 * tf
        wB = -1.0 * self.gamma_b * self.B0 * tf
        return (0.0, wA, wB - wA, wB, wB + wA)

    def factor_dd(self) -> float:
        """Dipole-dipole prefactor f_DD in s^-2
        (spectral_densities.py:225-239)."""
        r_m = self.r_ab_nm * dist_factor("nm")
        return (
            0.10
            * MU0_HBAR_OVER_4PI_SQ
            * self.gamma_a**2
            * self.gamma_b**2
            * r_m**-6.0
        )

    def factor_csa(self, csa_value=None):
        """CSA prefactor f_CSA in s^-2 (spectral_densities.py:241-243).

        ``csa_value`` may be a scalar or an array of per-residue CSAs; the
        return type follows the input (array in → array out).
        """
        c = self.csa_value if csa_value is None else csa_value
        return (2.0 / 15.0) * c**2 * (self.gamma_a * self.B0) ** 2


def omega_names(nuclei_a: str, nuclei_b: str):
    """Labels of the five frequencies, in order (spectral_densities.py:127-134)."""
    return ["0", nuclei_a, f"{nuclei_b}-{nuclei_a}", nuclei_b, f"{nuclei_b}+{nuclei_a}"]
