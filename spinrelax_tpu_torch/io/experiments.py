"""Experiment-file I/O: header-annotated spin-relaxation measurements
(a copy of ``spinrelax_tpu/io/experiments.py``; numpy only, the same
bytes).

Format (spectral_densities.py:935-1010 reader;
parse-relaxations-from-BMRB-entry.py writer):

    # Type R1
    # NucleiA 15N
    # NucleiB 1H
    # Frequency 600.133
    # FrequencyUnit MHz
    4 1.42 0.05
    ...
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from .zopen import topen


@dataclasses.dataclass
class ExperimentData:
    """One experimental dataset (R1 / R2 / NOE at one field)."""

    expt_type: str  # 'R1' | 'R2' | 'NOE'
    nuclei_a: str
    nuclei_b: str
    frequency: float  # in freq_unit
    freq_unit: str
    names: np.ndarray  # (nPeaks,) str
    values: np.ndarray  # (nPeaks,)
    errors: Optional[np.ndarray]  # (nPeaks,) or None


def read_experiment(fn: str) -> ExperimentData:
    expt_type = nuclei_a = nuclei_b = None
    freq = None
    freq_unit = "MHz"
    names: List[str] = []
    values: List[float] = []
    errors: List[Optional[float]] = []
    with topen(fn) as fp:
        for line in fp:
            parts = line.split()
            if not parts:
                continue
            if line[0] in "#@":
                if len(parts) < 3:
                    continue
                key = parts[1]
                if key == "Type":
                    expt_type = parts[2]
                elif key == "NucleiA":
                    nuclei_a = parts[2]
                elif key == "NucleiB":
                    nuclei_b = parts[2]
                elif key == "Frequency":
                    freq = float(parts[2])
                elif key == "FrequencyUnit":
                    freq_unit = parts[2]
                continue
            if len(parts) == 1 or len(parts) > 3:
                raise ValueError(
                    f"{fn}: data line must have 2 or 3 columns: {line!r}"
                )
            names.append(parts[0])
            values.append(float(parts[1]))
            errors.append(float(parts[2]) if len(parts) > 2 else None)

    if nuclei_b is None and expt_type in ("R1", "R2"):
        nuclei_b = "1H"
    if expt_type is None or nuclei_a is None or nuclei_b is None or freq is None:
        raise ValueError(
            f"{fn}: missing metadata; need Type, NucleiA, NucleiB, Frequency"
        )
    n_missing = sum(e is None for e in errors)
    if n_missing == len(errors):
        err_arr = None
    elif n_missing > 0:
        raise ValueError(f"{fn}: either all entries have uncertainties or none")
    else:
        err_arr = np.array(errors, dtype=float)
    return ExperimentData(
        expt_type=expt_type,
        nuclei_a=nuclei_a,
        nuclei_b=nuclei_b,
        frequency=freq,
        freq_unit=freq_unit,
        names=np.array(names),
        values=np.array(values, dtype=float),
        errors=err_arr,
    )


def write_experiment(fn: str, expt: ExperimentData):
    with topen(fn, "w") as fp:
        print("# Type %s" % expt.expt_type, file=fp)
        print("# NucleiA %s" % expt.nuclei_a, file=fp)
        print("# NucleiB %s" % expt.nuclei_b, file=fp)
        print("# Frequency %s" % expt.frequency, file=fp)
        print("# FrequencyUnit %s" % expt.freq_unit, file=fp)
        print("", file=fp)
        if expt.errors is None:
            for n, v in zip(expt.names, expt.values):
                print("%s %.12g" % (n, v), file=fp)
        else:
            for n, v, e in zip(expt.names, expt.values, expt.errors):
                print("%s %.12g %.12g" % (n, v, e), file=fp)
