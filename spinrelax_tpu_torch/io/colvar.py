"""PLUMED colvar (PRINT) file I/O.

Replaces ``plumedcolvario.py``: files of the form

    #! FIELDS time q.w q.x q.y q.z
    0.000000 0.312824 0.361795 -0.802215 -0.357347

The reader returns (field_names, data) with data shaped
(nFields, nEntries) like the reference (F-ordered reshape semantics,
plumedcolvario.py:24-81); the multi-replica variant splits at each
repeated FIELDS header (plumedcolvario.py:83-144).

Plain files parse through the port's native library (``io.native``,
``csrc/fastio.cpp``), gzip-compressed ones through numpy; the streamed
readers use numpy.loadtxt per block.  (Port of
``spinrelax_tpu/io/colvar.py``.)
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .zopen import is_gz, topen


def _read_field_names(fn: str) -> List[str]:
    """FIELDS header from the file top.  Stops at the first data row: a
    full-file scan cost ~0.8 s per 10^6-line colvar and could not catch
    the real aggregate-file misuse anyway (repeated IDENTICAL headers
    pass silently) — aggregate handling lives in read_colvar_multi."""
    field_names: List[str] = []
    with topen(fn) as fp:
        for line in fp:
            if line.startswith("#"):
                parts = line.split()
                if len(parts) > 1 and parts[1] == "FIELDS":
                    names = parts[2:]
                    if field_names and names != field_names:
                        raise ValueError(
                            f"{fn}: repeated FIELDS headers disagree: "
                            f"{field_names} vs {names}"
                        )
                    field_names = names
            elif line.strip() and line[0] not in "@&" and field_names:
                break
    return field_names


def read_colvar(fn: str) -> Tuple[List[str], np.ndarray]:
    field_names = _read_field_names(fn)
    if not field_names:
        raise ValueError(f"{fn}: no FIELDS header found")

    if is_gz(fn):
        rows: List[str] = []
        with topen(fn) as fp:
            for line in fp:
                # The native parser's skip rules ('#@&' and blank lines).
                if not line.strip() or line[0] in "#@&":
                    continue
                rows.append(line)
        table = np.loadtxt(rows, ndmin=2)
    else:
        from . import native

        table = native.load_table(fn, skip_chars="#@&")
    # float64, deliberately diverging from the reference's float32 load
    # (plumedcolvario.py:60): a continuation colvar starting at
    # t0 >= 2^24 ps would get delta_t == 0 in f32, and the multi-replica
    # / streamed paths of the same stage already parse at f64.
    data = table.astype(np.float64)
    if data.shape[1] != len(field_names):
        raise ValueError(
            f"{fn}: {data.shape[1]} columns but {len(field_names)} fields"
        )
    return field_names, data.T


def read_colvar_multi(fn: str) -> Tuple[List[List[str]], np.ndarray]:
    """Concatenated per-replica colvars -> (field_names_per_chunk,
    data (nReplicas, nTime, nFields)).  All chunks must be rectangular."""
    field_names: List[List[str]] = []
    chunks: List[List[str]] = []
    cur: List[str] = []
    with topen(fn) as fp:
        for line in fp:
            if not line.strip() or line[0] in "@&":
                continue  # '#@&' skip rules, matching read_colvar
            if line.startswith("#"):
                parts = line.split()
                if len(parts) > 1 and parts[1] == "FIELDS":
                    if cur:
                        chunks.append(cur)
                        cur = []
                    field_names.append(parts[2:])
                continue
            if not field_names:
                raise ValueError(f"{fn}: data before any FIELDS header")
            cur.append(line)
    if cur:
        chunks.append(cur)
    arrays = [np.loadtxt(c, ndmin=2) for c in chunks]
    if len({a.shape for a in arrays}) <= 1:
        return field_names, np.array(arrays)
    # Ragged replica lengths: return a list; downstream (stage_dq,
    # analyse_dq_multi) handles per-replica arrays of unequal length.
    return field_names, arrays


def write_colvar(fn: str, field_names: List[str], data: np.ndarray):
    """data: (nFields, nEntries) (plumedcolvario.py:150-168): "%8f" values
    joined by one space, a row per entry (np.savetxt formats a whole row
    at a time; the bytes are the per-value loop's)."""
    data = np.asarray(data)
    if data.shape[0] != len(field_names):
        raise ValueError("field count mismatch")
    with topen(fn, "w") as fp:
        print("#! FIELDS " + " ".join(field_names), file=fp)
        np.savetxt(fp, data.T, fmt="%8f", delimiter=" ")


def count_colvar_rows(fn: str) -> int:
    """Count data rows of a colvar file at I/O speed (no float parsing;
    same skip rules as the readers: '#'/'@'/'&' and blank lines) — the
    cheap pre-pass the streamed Delta-q error path needs, since the
    reference's sub-chunk blocking is defined on the TOTAL length
    (calculate-dq-distribution.py:128-144)."""
    n = 0
    with topen(fn) as fp:
        for line in fp:
            # '#@&' skip rules, matching read_colvar's both paths.
            if not line.strip() or line[0] in "#@&":
                continue
            n += 1
    return n


def iter_colvar_chunks(fn: str, chunk_frames: int = 65536):
    """Lazily yield (field_names, (n, nFields) array) blocks of a colvar
    file, never holding more than chunk_frames rows in memory.  Feeds the
    streaming Delta-q path (ops.dq.analyse_dq_streamed).

    A repeated IDENTICAL ``FIELDS`` header is accepted as a continuation
    (a restarted PLUMED run re-prints it; the in-memory read_colvar path
    ignores all # lines, so streaming must match) with a warning that a
    multi-replica concatenation looks the same and needs ``--multi``.  A
    repeated DIFFERING header is an error: streaming across it would
    silently correlate columns with different meanings."""
    field_names: List[str] = []
    seen_header = False
    rows: List[str] = []
    with topen(fn) as fp:
        for line in fp:
            if line.startswith("#"):
                parts = line.split()
                if len(parts) > 1 and parts[1] == "FIELDS":
                    if seen_header:
                        if parts[2:] != field_names:
                            raise ValueError(
                                f"{fn!r}: FIELDS header changed mid-file "
                                f"({field_names} -> {parts[2:]}); cannot "
                                "stream across incompatible blocks (a "
                                "multi-replica colvar needs --multi)"
                            )
                        import warnings

                        warnings.warn(
                            f"{fn!r}: repeated FIELDS header — treating "
                            "as a restart continuation (matching the "
                            "non-streamed reader); if this file is a "
                            "multi-replica concatenation use --multi"
                        )
                        continue
                    field_names = parts[2:]
                    seen_header = True
                continue
            if not line.strip() or line[0] in "@&":
                continue  # '#@&' skip rules, matching read_colvar
            if not seen_header:
                # read_colvar errors on headerless files; the streamed
                # reader must not silently guess column meanings instead.
                raise ValueError(f"{fn}: data before any FIELDS header")
            rows.append(line)
            if len(rows) == chunk_frames:
                yield field_names, np.loadtxt(rows, ndmin=2)
                rows = []
    if rows:
        yield field_names, np.loadtxt(rows, ndmin=2)


def iter_colvar_chunks_multi(fn: str, chunk_frames: int = 65536):
    """Lazily yield (replica_index, field_names, (n, nFields) array)
    blocks of a CONCATENATED multi-replica colvar (the aggregate file the
    reference's run-all builds by appending per-replica colvars,
    run-all.bash:312-367), never holding more than chunk_frames rows.

    Replica boundaries follow :func:`read_colvar_multi` exactly: EVERY
    ``FIELDS`` header starts a new replica (identical or not — the
    in-memory multi reader keeps per-chunk field names), so a yielded
    block always belongs to one replica.  Feeds the streaming
    multi-replica Delta-q path (ops.dq.analyse_dq_multi_streamed)."""
    field_names: List[str] = []
    rep = -1
    rows: List[str] = []
    with topen(fn) as fp:
        for line in fp:
            if line.startswith("#"):
                parts = line.split()
                if len(parts) > 1 and parts[1] == "FIELDS":
                    if rows:
                        yield rep, field_names, np.loadtxt(rows, ndmin=2)
                        rows = []
                    field_names = parts[2:]
                    rep += 1
                continue
            if not line.strip() or line[0] in "@&":
                continue  # '#@&' skip rules, matching read_colvar_multi
            if rep < 0:
                raise ValueError(f"{fn}: data before any FIELDS header")
            rows.append(line)
            if len(rows) == chunk_frames:
                yield rep, field_names, np.loadtxt(rows, ndmin=2)
                rows = []
    if rows:
        yield rep, field_names, np.loadtxt(rows, ndmin=2)
