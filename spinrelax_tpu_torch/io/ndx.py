"""GROMACS index (.ndx) file I/O (host-side, clean-room).

The reference's centring pipeline communicates atom selections to
trjconv through an index file it auto-generates
(center-solute-gromacs.bash:51-68: ``gmx select`` writes ``solute.ndx``,
every ``trjconv`` stage takes ``-n solute.ndx``).  This module lets the
native ``spinrelax center`` consume the same files users already have —
and emit one for interop with real GROMACS tooling.

Format: ``[ GroupName ]`` section headers followed by whitespace-
separated 1-based atom numbers; ``;`` starts a comment.  Group names may
repeat in files written by ``gmx make_ndx``; like GROMACS's name lookup,
the FIRST occurrence wins (later duplicates are kept under
``name#2``-style keys so nothing is silently dropped).

The port's copy of ``spinrelax_tpu/io/ndx.py`` (host-side numpy; the same bytes).
"""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import Dict, Mapping, Sequence

import numpy as np

from .zopen import topen


class NdxError(ValueError):
    pass


_HEADER_RE = re.compile(r"^\[\s*(.*?)\s*\]$")


def read_ndx(fn: str) -> "OrderedDict[str, np.ndarray]":
    """Read a .ndx file -> OrderedDict {group name: 0-based atom indices}.

    Indices are converted from the file's 1-based numbering.  Duplicate
    group names get ``#2``, ``#3`` … suffixes (first occurrence keeps
    the plain name, matching GROMACS's first-match lookup)."""
    groups: "OrderedDict[str, list]" = OrderedDict()
    counts: Dict[str, int] = {}
    current = None
    with topen(fn) as fp:
        for lineno, raw in enumerate(fp, 1):
            line = raw.split(";", 1)[0].strip()
            if not line:
                continue
            m = _HEADER_RE.match(line)
            if m:
                name = m.group(1)
                if not name:
                    raise NdxError(f"{fn}:{lineno}: empty group name")
                counts[name] = counts.get(name, 0) + 1
                if counts[name] > 1:
                    name = f"{name}#{counts[name]}"
                current = name
                groups[current] = []
                continue
            if current is None:
                raise NdxError(
                    f"{fn}:{lineno}: atom numbers before any [ group ]"
                )
            for tok in line.split():
                try:
                    idx = int(tok)
                except ValueError:
                    raise NdxError(
                        f"{fn}:{lineno}: non-integer atom number {tok!r}"
                    )
                if idx < 1:
                    raise NdxError(
                        f"{fn}:{lineno}: atom numbers are 1-based, got {idx}"
                    )
                groups[current].append(idx - 1)
    if not groups:
        raise NdxError(f"{fn}: no [ group ] sections")
    return OrderedDict(
        (k, np.array(v, dtype=int)) for k, v in groups.items()
    )


def write_ndx(fn: str, groups: Mapping[str, Sequence[int]]):
    """Write {group name: 0-based atom indices} as a .ndx file
    (1-based, 15 numbers per line like GROMACS)."""
    with topen(fn, "w") as fp:
        for name, idx in groups.items():
            idx = np.asarray(idx, dtype=int)
            if idx.size and idx.min() < 0:
                raise NdxError(f"group {name!r}: negative atom index")
            print(f"[ {name} ]", file=fp)
            nums = [str(i + 1) for i in idx]
            for off in range(0, len(nums), 15):
                print(" ".join(nums[off : off + 15]), file=fp)


def group_mask(
    groups: Mapping[str, np.ndarray], name: str, n_atoms: int
) -> np.ndarray:
    """Boolean atom mask for one group, validated against the topology
    size (a group indexing past n_atoms means the ndx belongs to a
    different system — fail loudly like trjconv does)."""
    if name not in groups:
        raise NdxError(
            f"group {name!r} not in index file (available: "
            + ", ".join(groups) + ")"
        )
    idx = groups[name]
    if idx.size and idx.max() >= n_atoms:
        raise NdxError(
            f"group {name!r} indexes atom {int(idx.max()) + 1} but the "
            f"topology has only {n_atoms} atoms"
        )
    mask = np.zeros(n_atoms, dtype=bool)
    mask[idx] = True
    return mask
