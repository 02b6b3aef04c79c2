"""The frozen bounds in portbench/roofline.py give chip_smoke's at the
kernel table's shapes (PERF.md section 6)."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (stdlib-only at import)
from portbench import roofline  # noqa: E402

ACF = [(32 * 1024, 1000, 500), (1024, 2000, 1000), (1024, 10_000, 5000), (64, 20_000, 10_000),
       (1480, 5000, 2500)]
LM = [(K, s2f, B, 500, full) for K, B in ((2, 1024), (4, 10_000), (5, 10_000), (8, 10_000))
      for s2f in (False, True) for full in (False, True)]
STEP = [(P, B, gate, imp, win) for P, B in ((5, 1024), (9, 10_000), (11, 10_000), (17, 10_000),
                                            (2, 10_000), (7, 10_000), (33, 7))
        for gate in (False, True) for imp, win in ((0, 0), (B // 2, B // 3))]


def test_peaks():
    assert (roofline.HBM_BYTES_S, roofline.FP32_FLOP_S) == (chip_smoke.HBM_BYTES_S,
                                                            chip_smoke.FP32_FLOP_S)


@pytest.mark.parametrize("shape", ACF)
def test_acf_bound(shape):
    assert roofline.acf_bound(*shape) == chip_smoke.acf_bound(*shape)


@pytest.mark.parametrize("args", LM)
def test_lm_bound(args):
    assert roofline.lm_bound(*args) == chip_smoke.lm_bound(*args)


@pytest.mark.parametrize("args", STEP)
def test_step_bound(args):
    assert roofline.step_bound(*args) == chip_smoke.step_bound(*args)


def test_kernel_table_values():
    """The table's bounds: 0.3454 ms (A, forward chunks), 0.0235 and
    0.1093 ms (A at the stage's chunks), 1.27 / 1.23 us (B / C at 1024)."""
    assert round(roofline.acf_bound(32 * 1024, 1000, 500)[0], 4) == 0.3454
    assert round(roofline.acf_bound(1024, 2000, 1000)[0], 4) == 0.0235
    assert round(roofline.acf_bound(1024, 10_000, 5000)[0], 4) == 0.1093
    assert round(roofline.lm_bound(2, True, 1024, 500, True)[0] * 1e3, 2) == 1.27
    assert round(roofline.lm_bound(2, True, 1024, 500, False)[0] * 1e3, 2) == 1.23
