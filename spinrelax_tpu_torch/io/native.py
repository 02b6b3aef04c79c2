"""ctypes bindings to the port's native host libraries: the text reader and
writers (``csrc/fastio.cpp``; the fastio half of
``spinrelax_tpu/io/native.py``) and the XTC codec (``csrc/xtc.cpp``; its
XTC half).

Each library is compiled with the host C++ compiler at first use into
``spinrelax_tpu_torch/build/`` (``_build.load_host``), keyed on the
source's hash.  A build or load that fails raises: no numpy route stands
in for either library.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from .. import _build
from .zopen import is_gz

_F = ctypes.POINTER(ctypes.c_float)
_D = ctypes.POINTER(ctypes.c_double)
_LP = ctypes.POINTER(ctypes.c_long)
_IP = ctypes.POINTER(ctypes.c_int)
_V, _S, _L, _I = ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long, ctypes.c_int
_LL = ctypes.c_longlong
# (argtypes, restype) of each library's C entry points
_SIGNATURES = {
    "fastio": {
        "fastio_table_dims": ((_S, _S, _LP, _LP), _I),
        "fastio_parse_table": ((_S, _S, _D, _L, _L), _L),
        "fastio_count_fields_headers": ((_S, _LP), _I),
        "fastio_write_table": ((_S, _I, _D, _L, _L), _I),
        "fastio_format_sxy": ((_D, _V, _I, _LL, _I, _S, _LL), _LL),
    },
    "xtc": {
        "xtc_info": ((_S, _LP, _IP), _I),
        "xtc_write": ((_S, _F, _F, _F, _L, _I, ctypes.c_float), _I),
        "xtc_append": ((_S, _F, _F, _F, _L, _I, ctypes.c_float, _L), _I),
        "xtc_open": ((_S, _IP), _V),
        "xtc_next_mt": ((_V, _F, _F, _F, _L, _I), _L),
        "xtc_close": ((_V,), None),
        "xtc_next_obs": ((_V, _LP, _LP, _L, _D, _F, _D, _F, _L, _I), _L),
        "xtc_reduce_obs": ((_F, _L, _I, _LP, _LP, _L, _D, _F, _D, _I), None),
    },
}
_READ_ERRORS = {-3: "frame natoms mismatch", -4: "corrupt/truncated frame mid-file"}
_typed: set = set()


def _load(name: str):
    """The host library ``csrc/<name>.cpp``, built on first use, its entry
    points typed."""
    lib = _build.load_host(name)
    if name not in _typed:
        for fn_name, (argtypes, restype) in _SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes, fn.restype = list(argtypes), restype
        _typed.add(name)
    return lib


def _load_xtc():
    return _load("xtc")


# ---------------------------------------------------------------------------
# Text tables (csrc/fastio.cpp)
# ---------------------------------------------------------------------------


def available() -> bool:
    """True once the text library is built and loaded; a build that fails
    raises (kept so callers written for the JAX module read the same)."""
    _load("fastio")
    return True


def _plain_path(fn: str, what: str) -> bytes:
    if is_gz(str(fn)):
        raise ValueError(f"{what}: {fn!r} is gzip-compressed; the native library "
                         "reads and writes plain files only")
    return str(fn).encode()


def load_table(fn: str, skip_chars: str = "#@&") -> np.ndarray:
    """Parse a numeric text table -> (nRows, nCols) float64.  Lines whose
    first non-blank character is in ``skip_chars`` are skipped; a row wider
    than the first raises.  Plain files only (a .gz path raises: the
    readers of ``io.colvar`` take numpy's route for those)."""
    lib = _load("fastio")
    path = _plain_path(fn, "load_table")
    rows, cols = ctypes.c_long(), ctypes.c_long()
    rc = lib.fastio_table_dims(path, skip_chars.encode(), ctypes.byref(rows),
                               ctypes.byref(cols))
    if rc != 0:
        raise OSError(f"fastio_table_dims failed on {fn!r} (code {rc})")
    out = np.empty((rows.value, cols.value), dtype=np.float64)
    n = lib.fastio_parse_table(path, skip_chars.encode(), _ptr(out, _D),
                               rows.value, cols.value)
    if n < 0:
        raise OSError(f"fastio_parse_table failed on {fn!r} (code {n})")
    if n != rows.value * cols.value:
        raise OSError(f"fastio_parse_table short read on {fn!r}")
    return out


def format_sxy(x, y) -> bytes:
    """Render ``n`` lines ``str(np.float64(x[i])) + " " + str(y[i]).strip('[]')``
    -- the exact per-row bytes of ``io.xvg.print_sxylist``'s row formatter
    under numpy's default printoptions -- in one native call.

    x must be float64 (its str is Python's float repr); y a (n, k) float32
    or float64 block with k <= 3: wider rows can pass numpy's 75-character
    line width, which wraps str(row), and the renderer does not wrap.
    Other input raises ValueError."""
    lib = _load("fastio")
    x = np.ascontiguousarray(x)
    y = np.asarray(y)
    if (x.dtype != np.float64 or y.ndim != 2 or y.dtype not in (np.float32, np.float64)
            or y.shape[1] > 3 or y.shape[0] != x.shape[0]):
        raise ValueError(f"format_sxy renders float64 x (n,) beside float32/float64 y "
                         f"(n, <= 3); got x {x.dtype} {x.shape}, y {y.dtype} {y.shape}")
    y = np.ascontiguousarray(y)
    n, k = y.shape
    cap = 64 + n * (40 + 40 * k)
    out = ctypes.create_string_buffer(cap)
    nb = lib.fastio_format_sxy(_ptr(x, _D), y.ctypes.data_as(_V),
                               1 if y.dtype == np.float32 else 0, n, k, out, cap)
    if nb < 0:
        raise RuntimeError(f"fastio_format_sxy failed (code {nb})")
    return out.raw[:nb]


def write_table(fn: str, data, append: bool = False) -> None:
    """Bulk-write a 2D array as "%16g"-joined rows (the PLUMED colvar row
    format), or append them.  Plain files only (a .gz path raises)."""
    lib = _load("fastio")
    path = _plain_path(fn, "write_table")
    arr = np.ascontiguousarray(data, dtype=np.float64)
    if arr.ndim != 2:
        raise ValueError(f"write_table needs a 2D array, got {arr.shape}")
    rc = lib.fastio_write_table(path, 1 if append else 0, _ptr(arr, _D), arr.shape[0],
                                arr.shape[1])
    if rc != 0:
        raise OSError(f"fastio_write_table failed on {fn!r}")


def count_fields_headers(fn: str) -> int:
    """Number of ``#! FIELDS`` headers of a PLUMED colvar (its replica
    blocks)."""
    lib = _load("fastio")
    n = ctypes.c_long()
    rc = lib.fastio_count_fields_headers(_plain_path(fn, "count_fields_headers"),
                                         ctypes.byref(n))
    if rc != 0:
        raise OSError(f"fastio_count_fields_headers failed on {fn!r}")
    return n.value


# ---------------------------------------------------------------------------
# The XTC codec (csrc/xtc.cpp)
# ---------------------------------------------------------------------------


def _ptr(a, kind):
    return a.ctypes.data_as(kind)


def _xtc_threads(threads: int) -> int:
    """0 = auto (all cores); 1 = sequential; N = exactly N workers."""
    return (os.cpu_count() or 1) if threads == 0 else max(1, threads)


def _open(lib, fn: str):
    natoms = ctypes.c_int()
    handle = lib.xtc_open(fn.encode(), ctypes.byref(natoms))
    if not handle:
        raise OSError(f"xtc_open failed on {fn!r}")
    return handle, natoms.value


def info_xtc(fn: str) -> tuple:
    """Header-scan inspection (payloads seeked past, no decode) ->
    (n frames, natoms)."""
    lib = _load_xtc()
    n_frames, natoms = ctypes.c_long(), ctypes.c_int()
    rc = lib.xtc_info(fn.encode(), ctypes.byref(n_frames), ctypes.byref(natoms))
    if rc != 0:
        raise OSError(f"xtc_info failed on {fn!r} (code {rc})")
    return n_frames.value, natoms.value


def _chunk_buffers(n_frames: int, n_atoms: int):
    return (np.empty((n_frames, n_atoms, 3), dtype=np.float32),
            np.empty((n_frames, 3, 3), dtype=np.float32),
            np.empty(n_frames, dtype=np.float32))


def _next(lib, handle, xyz, boxes, times, max_frames, n_threads, fn):
    got = lib.xtc_next_mt(handle, _ptr(xyz, _F), _ptr(times, _F), _ptr(boxes, _F),
                          max_frames, n_threads)
    if got < 0:
        raise OSError(f"xtc_next failed on {fn!r}: {_READ_ERRORS.get(got, f'code {got}')}")
    return got


def read_xtc(fn: str, threads: int = 1):
    """-> (xyz (nFrames, nAtoms, 3) [nm] float32, boxes (nFrames, 3, 3),
    times (nFrames,)).

    ``threads``: decode with this many worker threads (0 = one per
    core, 1 = sequential).  Output is identical regardless."""
    lib = _load_xtc()
    nf, na = info_xtc(fn)
    xyz, boxes, times = _chunk_buffers(nf, na)
    if nf == 0:
        # xtc_open peeks the first frame header, so it cannot open an
        # empty (e.g. aborted-writer) file.
        return xyz, boxes, times
    handle, _ = _open(lib, fn)
    try:
        got = _next(lib, handle, xyz, boxes, times, nf, _xtc_threads(threads), fn)
    finally:
        lib.xtc_close(handle)
    if got != nf:
        raise OSError(f"xtc_read returned {got} of {nf} frames for {fn!r}")
    return xyz, boxes, times


def iter_xtc(fn: str, chunk_frames: int, threads: int = 1):
    """Stream an .xtc in fixed-size frame chunks without loading the file
    (the larger-than-memory ingest path; run-all.bash:359 feeds multi-GB
    solute.xtc).

    Yields (xyz (c, nAtoms, 3) [nm] f32, boxes (c, 3, 3), times (c,)).

    ``threads``: decode each chunk with this many worker threads (frames
    decode independently after a cheap offset scan); 0 = one per core,
    1 (default) = sequential.  Output is identical regardless.
    """
    lib = _load_xtc()
    n_threads = _xtc_threads(threads)
    handle, na = _open(lib, fn)
    try:
        while True:
            xyz, boxes, times = _chunk_buffers(chunk_frames, na)
            got = _next(lib, handle, xyz, boxes, times, chunk_frames, n_threads, fn)
            if got == 0:
                return
            yield xyz[:got], boxes[:got], times[:got]
            if got < chunk_frames:
                return
    finally:
        lib.xtc_close(handle)


def write_xtc(fn: str, xyz, times=None, boxes=None, precision: float = 1000.0,
              append: bool = False, step0: int = 0):
    """Write (or, with ``append=True``, extend) an .xtc file.  XTC frames
    are self-delimiting, so appending produces a valid trajectory
    (``step0`` numbers the appended frames and is the default time stamp
    when ``times`` is omitted)."""
    lib = _load_xtc()
    xyz = np.ascontiguousarray(xyz, dtype=np.float32)
    nf, na, _ = xyz.shape
    if times is None:
        times = np.arange(step0, step0 + nf, dtype=np.float32)
    times = np.ascontiguousarray(times, dtype=np.float32)
    boxes_ptr = None
    if boxes is not None:
        boxes = np.ascontiguousarray(boxes, dtype=np.float32)
        boxes_ptr = _ptr(boxes, _F)
    if append:
        rc = lib.xtc_append(fn.encode(), _ptr(xyz, _F), _ptr(times, _F), boxes_ptr,
                            nf, na, precision, step0)
    else:
        rc = lib.xtc_write(fn.encode(), _ptr(xyz, _F), _ptr(times, _F), boxes_ptr,
                           nf, na, precision)
    if rc != 0:
        raise OSError(f"xtc_write failed on {fn!r} (code {rc})")


def xtc_obs_available() -> bool:
    """True: the port's codec always has the fused decode -> bond-observable
    reader (kept so callers written for the JAX module read the same)."""
    _load_xtc()
    return True


def _obs_operands(idx_h, idx_x, A, n_atoms: int):
    """The bond indices as int64 and A as float64, contiguous, checked
    against the atom count: the C loops index the coordinates with them
    unchecked."""
    idx_h = np.ascontiguousarray(idx_h, dtype=np.int64)
    idx_x = np.ascontiguousarray(idx_x, dtype=np.int64)
    A = np.ascontiguousarray(A, dtype=np.float64)
    if A.shape != (3, n_atoms):
        raise ValueError(f"A shape {A.shape} != (3, {n_atoms})")
    if idx_h.shape != idx_x.shape or idx_h.ndim != 1:
        raise ValueError(f"idx_h {idx_h.shape} and idx_x {idx_x.shape} must be one "
                         "(nBonds,) shape")
    if idx_h.size and (max(idx_h.max(), idx_x.max()) >= n_atoms
                       or min(idx_h.min(), idx_x.min()) < 0):
        raise ValueError(f"bond indices out of range for {n_atoms} atoms")
    return idx_h, idx_x, A


def iter_xtc_obs(fn: str, chunk_frames: int, idx_h, idx_x, A,
                 threads: int = 1, out_dtype=np.float32):
    """Stream an .xtc reduced to bond observables -- the fused ingest of
    stage_ct_streamed (ops/orient.bond_obs_host computed IN the decoder;
    the full (frames, natoms, 3) coordinate block never materialises).

    idx_h, idx_x : (nBonds,) atom indices of each bond's H and X ends.
    A            : (3, natoms) f64 weighted-centred reference correlation
                   matrix (ops/orient.bond_obs_matrix).
    threads      : worker threads per chunk (0 = one per core); output
                   is bit-identical for any value.

    Yields (raw_diff (c, nBonds, 3) out_dtype, S (c, 3, 3) out_dtype,
    times (c,)) -- exactly bond_obs_host's contract on an f32 chunk (S is
    accumulated in f64 and cast, like the host slab reduction).
    """
    lib = _load_xtc()
    n_threads = _xtc_threads(threads)
    handle, na = _open(lib, fn)
    try:
        idx_h, idx_x, A = _obs_operands(idx_h, idx_x, A, na)
        nb = idx_h.size
        while True:
            raw = np.empty((chunk_frames, nb, 3), dtype=np.float32)
            S = np.empty((chunk_frames, 3, 3), dtype=np.float64)
            times = np.empty(chunk_frames, dtype=np.float32)
            got = lib.xtc_next_obs(handle, _ptr(idx_h, _LP), _ptr(idx_x, _LP), nb,
                                   _ptr(A, _D), _ptr(raw, _F), _ptr(S, _D),
                                   _ptr(times, _F), chunk_frames, n_threads)
            if got < 0:
                raise OSError(f"xtc_next_obs failed on {fn!r}: "
                              f"{_READ_ERRORS.get(got, f'code {got}')}")
            if got == 0:
                break
            yield (raw[:got].astype(out_dtype, copy=False),
                   S[:got].astype(out_dtype, copy=False), times[:got])
            if got < chunk_frames:
                break
    finally:
        lib.xtc_close(handle)


def reduce_obs_mem(xyz, idx_h, idx_x, A, threads: int = 1):
    """Native in-memory bond-observable reduction over a decoded float32
    (F, natoms, 3) chunk -- the same per-frame loop as the fused .xtc
    reader, so both produce bit-identical observables
    (ops/orient.bond_obs_host routes its float32 path here).  Returns
    (raw_diff f32, S f64); any other input raises."""
    lib = _load_xtc()
    xyz = np.asarray(xyz)
    if xyz.dtype != np.float32 or xyz.ndim != 3 or xyz.shape[2] != 3:
        raise ValueError(f"reduce_obs_mem takes a float32 (F, natoms, 3) block, got "
                         f"{xyz.dtype} {xyz.shape}")
    xyz = np.ascontiguousarray(xyz)
    nf, na, _ = xyz.shape
    idx_h, idx_x, A = _obs_operands(idx_h, idx_x, A, na)
    nb = idx_h.size
    raw = np.empty((nf, nb, 3), dtype=np.float32)
    S = np.empty((nf, 3, 3), dtype=np.float64)
    lib.xtc_reduce_obs(_ptr(xyz, _F), nf, na, _ptr(idx_h, _LP), _ptr(idx_x, _LP), nb,
                       _ptr(A, _D), _ptr(raw, _F), _ptr(S, _D), _xtc_threads(threads))
    return raw, S
