"""Nothing under portbench/ imports the JAX side, the reference imports
nothing of the port, and the run's own guard compares whole top-level
names."""

from __future__ import annotations

import ast
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE.parent))

from portbench.bench import guard  # noqa: E402

SOURCES = sorted(HERE.rglob("*.py"))


def imported(path: Path):
    """Top-level names of every module a file imports."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_side(path):
    assert not set(imported(path)) & {"jax", "jaxlib", "flax", "spinrelax_tpu"}


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_independent_of_port(path):
    assert "spinrelax_tpu_torch" not in set(imported(path))


def test_guard_compares_whole_names():
    mods = ["spinrelax_tpu_torch", "spinrelax_tpu_torch.ops", "jaxtyping", "numpy"]
    assert guard.forbidden(mods) == []
    assert guard.forbidden(mods + ["spinrelax_tpu.ops"]) == ["spinrelax_tpu.ops"]
    assert guard.forbidden(["jax", "jaxlib.xla_client", "flax"]) == ["flax", "jax",
                                                                    "jaxlib.xla_client"]
