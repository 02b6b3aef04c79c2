"""The benchmark's own .xtc encoder: a frozen copy of the encoder half of
the port's codec (``xtc.cpp`` beside this file: its bit coder, frame
writer and ``xtc_write``, unchanged), built with the host C++ compiler
into ``portbench/build/`` at first use and called through ctypes.  The
trajectory files the cells read are written with it, so a change to the
port's codec cannot change the benchmark's inputs.

:func:`quantise` is the encoder's rounding, in numpy: the reference works
from those integers, never from the decoded file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "xtc.cpp"
BUILD = Path(__file__).resolve().parents[1] / "build"
FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD / f"libxtcgen_{h.hexdigest()[:16]}.so"


def _load():
    global _lib
    with _lock:
        if _lib is None:
            out = library_path()
            if not out.exists():
                cxx = next((c for c in (os.environ.get("CXX"), "g++", "c++", "clang++")
                            if c and shutil.which(c)), None)
                if cxx is None:
                    raise RuntimeError("no host C++ compiler for the benchmark's .xtc encoder")
                BUILD.mkdir(parents=True, exist_ok=True)
                tmp = BUILD / f"{out.stem}.{os.getpid()}.tmp"
                res = subprocess.run([cxx, *FLAGS, str(SRC), "-o", str(tmp)],
                                     stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                if res.returncode != 0:
                    tmp.unlink(missing_ok=True)
                    raise RuntimeError(f"building the .xtc encoder failed:\n{res.stdout}")
                os.replace(tmp, out)
            lib = ctypes.CDLL(str(out))
            lib.xtc_write.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_void_p, ctypes.c_long, ctypes.c_int,
                                      ctypes.c_float]
            lib.xtc_write.restype = ctypes.c_int
            _lib = lib
        return _lib


def write_xtc(fn: str, xyz: np.ndarray, times: np.ndarray, precision: float) -> None:
    """Write (F, A, 3) float32 nm coordinates and (F,) times as an .xtc."""
    lib = _load()
    xyz = np.ascontiguousarray(xyz, dtype=np.float32)
    times = np.ascontiguousarray(times, dtype=np.float32)
    rc = lib.xtc_write(str(fn).encode(), xyz.ctypes.data, times.ctypes.data, None,
                       xyz.shape[0], xyz.shape[1], precision)
    if rc != 0:
        raise OSError(f"xtc_write failed on {fn!r} (code {rc})")


def quantise(xyz: np.ndarray, precision: float) -> np.ndarray:
    """The integers the encoder stores: float32 x * precision, rounded half
    away from zero in float32, truncated (xtc.cpp's write_frame)."""
    f = np.asarray(xyz, dtype=np.float32) * np.float32(precision)
    half = np.float32(0.5)
    return np.where(f >= 0, f + half, f - half).astype(np.int32)
