"""The benchmark measures the PyTorch port only.  :func:`forbidden`
names every loaded module whose top-level name is, whole, one of the JAX
side's (the port's own name begins with the JAX package's, so a prefix
test would be wrong)."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "spinrelax_tpu"})


def top_level(module_name: str) -> str:
    return module_name.split(".", 1)[0]


def forbidden(modules=None) -> list:
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if top_level(m) in FORBIDDEN})
