"""Physical corrections applied by the workflow orchestrator.

Replaces the awk embedded in run-all.bash:15-28: scaling of a simulated
D_iso to experimental conditions via the Garcia-2000 water-viscosity
polynomial and the 1.23x D2O factor (Wong & Case 2008).  (Port of
``spinrelax_tpu/pipeline/corrections.py``.)
"""

from __future__ import annotations


def water_viscosity(T_kelvin: float) -> float:
    """Supercooled-to-warm water viscosity polynomial (relative units),
    eta(T) with T in Celsius inside (run-all.bash:18-21)."""
    T = T_kelvin - 273.0
    return 1.7753 - 5.65e-2 * T + 1.0751e-3 * T**2 - 9.222e-6 * T**3


def d2o_factor(ratio: float) -> float:
    """Linear mix of the 1.23x D2O viscosity factor
    (run-all.bash:22-24)."""
    return 1.23 * ratio + (1.0 - ratio)


def convert_diso(
    diso: float, T_md: float, T_exp: float, c_d2o: float = 0.0
) -> float:
    """D_iso(simulation @ T_md) -> D_iso(experiment @ T_exp, c_D2O)
    (run-all.bash:25-27):

        D2 = D1 * (T2/T1) * (eta(T1)/eta(T2)) * D2Omod(c_D2O)
    """
    return (
        diso
        * (T_exp / T_md)
        * (water_viscosity(T_md) / water_viscosity(T_exp))
        * d2o_factor(c_d2o)
    )
