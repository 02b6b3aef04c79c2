"""On the card (marker ``cuda``; skipped without one): each cell at its own
size, a short run comes out correct (a cell on N chips as N ranks, where
the machine has N cards) and, for each one-chip cell, the control -- the
reference in the program's place one precision down -- does not.  A
cell on several chips keeps its control in ``test_control_<cell>.py``,
which ``test_portbench_spec`` requires.

    python -m pytest --noconftest -m cuda portbench/tests/test_portbench_card.py
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

WORKLOADS = json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]
CELLS = [w["name"] for w in WORKLOADS]
ONE_CHIP = [w["name"] for w in WORKLOADS if w["chips"] == 1]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark runs on the card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_short_run_correct(card, cell):
    import torch

    from portbench import run as R

    chips = R.chips_of(cell)
    if torch.cuda.device_count() < chips:
        pytest.skip(f"{cell} needs {chips} cards")
    args = R.parse(["--workload", cell, "--seed", str(2**31 + 99), "--seconds", "3",
                    "--trace", "0"])
    res = R.run(args, device=card, emit=False)
    assert res is not None and res["correct"], res and res["compared"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ONE_CHIP)
def test_control_not_correct(card, cell):
    from portbench.bench import spec
    from portbench.calibrate import readings
    from portbench.reference import judge

    r = readings(cell, 2**31 + 98, program=False, control=True, device=card)
    verdict = judge.judged(r["control"], spec.workload(cell)["params"]["limits"])
    assert not all(v["ok"] for v in verdict), verdict
