"""Transparent gzip support for the text formats.

PLUMED colvars and GROMACS text outputs compress extremely well (the
>10^7-row colvars the streamed dq path exists for shrink ~10x), and the
reference's mdtraj ingest reads ``.pdb.gz`` transparently — so every
TEXT reader in this package accepts a ``.gz``-suffixed path via
:func:`topen`, and extension dispatch looks through the suffix via
:func:`fmt_name`.

Binary trajectory formats (xtc/trr/dcd/nc/npz/npy) are NOT wrapped:
xtc is already compressed, and the binary readers need mmap/seek which
a gzip stream cannot provide — those paths raise a clear error instead
(io.trajectory).
"""

from __future__ import annotations

import gzip


def topen(fn: str, mode: str = "r"):
    """``open()`` that transparently gzips when ``fn`` ends in ``.gz``.

    Text mode either way: ``"r"``/``"w"``/``"a"`` map to gzip ``"rt"``/
    ``"wt"``/``"at"``.  Appended writes produce multi-member gzip files,
    which ``gzip.open`` reads back transparently.
    """
    if str(fn).endswith(".gz"):
        if mode and mode[-1] not in "tb":
            mode = mode + "t"
        return gzip.open(fn, mode)
    return open(fn, mode)


def fmt_name(fn: str) -> str:
    """Filename with a trailing ``.gz`` stripped — the name extension
    dispatch should inspect (``traj.pdb.gz`` -> dispatch as ``.pdb``)."""
    s = str(fn)
    return s[:-3] if s.endswith(".gz") else s


def is_gz(fn: str) -> bool:
    return str(fn).endswith(".gz")
