"""On the card (marker ``cuda``; skipped without one): the control of
``"mbp-ct-stream-4"`` -- the reference in the program's place one
precision down, over all four replicas as one stream, in one process on
one card -- does not come out correct.

    python -m pytest --noconftest -m cuda portbench/tests/test_control_mbp_ct_stream_4.py
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

CELL = "mbp-ct-stream-4"


@pytest.mark.cuda
def test_control_not_correct():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark runs on the card")
    from portbench.bench import spec
    from portbench.calibrate import readings
    from portbench.reference import judge

    r = readings(CELL, 2**31 + 98, program=False, control=True, device="cuda")
    verdict = judge.judged(r["control"], spec.workload(CELL)["params"]["limits"])
    assert not all(v["ok"] for v in verdict), verdict
