"""Build and load the port's native code: the CUDA kernels, and the host
C++ libraries, the XTC codec (``csrc/xtc.cpp``), the text reader and
writers (``csrc/fastio.cpp``) and the C(t) files' renderer
(``csrc/sxyfmt.cpp``; :func:`load_host`).

Every ``csrc/*.cu`` source compiles to an object in its own ``nvcc``
process, all started together, and the objects link into one shared
library with a plain C interface, loaded through ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -c -o <src>.o csrc/<src>.cu        (each source)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \
         -o build/libspinrelax_kernels_<hash>.so *.o

The library name carries a hash of the sources and flags, so an edited
source rebuilds and a stale library is never loaded.  The build runs at
the first kernel launch of a process (or at an explicit :func:`load`),
never at import.  Every C entry point returns ``cudaGetLastError()``
after its launch; :func:`check` raises on a non-zero code.

A host source (``csrc/<name>.cpp``) builds on its own with the host C++
compiler, needs no CUDA toolkit, and lands beside the kernel library as
``build/lib<name>_<hash>.so``:

    g++ -O3 -pthread -shared -fPIC csrc/<name>.cpp -o build/lib<name>_<hash>.so
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# argtypes of every C entry point (pointers and the stream as void*,
# sizes as int, element strides as long long, thresholds as float).
_SIGNATURES = {
    # v, out, B, F, D, n_inner, s_outer, s_inner, s_t, s_c, nb, threads,
    # smem, stream
    "acf_lag_sums_f32": (_P, _P, _I, _I, _I, _I, _L, _L, _L, _L, _I, _I, _I, _P),
    # ... slab plan: threads, slab, smem in place of nb, threads, smem
    "acf_lag_sums_slab_f32": (_P, _P, _I, _I, _I, _I, _L, _L, _L, _L, _I, _I, _I, _P),
    # p, y, isg, dt, out, T, B, K, s2_free, stream
    "lm_hgc_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "lm_cost_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # Hp, gp, t, lam, lo, span, t_new, pt, stats, live, B, P, stream
    "lm_step_solve_f32": (_P,) * 10 + (_I, _I, _P),
    # c_new, c_old, t_new, pt_trial, stats, t, lam, it, c_best, c_mark,
    # done, live, pt, B, P, max_iter, window, xtol, ftol, ftol_window,
    # xtol_rel, lam0, lam_mark, lam_stuck, stream
    "lm_step_gate_f32": (_P,) * 13 + (_I,) * 4 + (_F,) * 7 + (_P,),
}

HOST_FLAGS = ("-O3", "-pthread", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None
_host_libs: dict = {}


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    cand = shutil.which("nvcc")
    if cand is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        cand = "/usr/local/cuda/bin/nvcc"
    if cand is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of spinrelax_tpu_torch are "
            "built from csrc/ at first use and need the CUDA toolkit"
        )
    return cand


def library_path() -> Path:
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(COMPILE_FLAGS).encode())
    return BUILD_DIR / f"libspinrelax_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/*.cu`` into the hashed library unless it exists.
    ``verbose`` prints ptxas' register and shared-memory report."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs, procs = [], []
    try:
        for src in sorted(CSRC.glob("*.cu")):
            obj = BUILD_DIR / f"{src.stem}.{tag}.o"
            cmd = [nvcc, *COMPILE_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
                   "-c", "-o", str(obj), str(src)]
            objs.append(obj)
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        for cmd, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
            if verbose:
                print(log, end="")
        tmp = BUILD_DIR / f"{tag}.so.tmp"
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        res = subprocess.run(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({res.returncode}):\n{' '.join(cmd)}\n{res.stdout}")
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for obj in objs:
            obj.unlink(missing_ok=True)
    return out


def load(verbose: bool = False):
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build(verbose=verbose)))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(code: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")


def _host_compiler() -> str:
    for cand in (os.environ.get("CXX"), "g++", "c++", "clang++"):
        if cand and shutil.which(cand):
            return cand
    raise RuntimeError(
        "no host C++ compiler found (tried $CXX, g++, c++, clang++): "
        "spinrelax_tpu_torch builds its host libraries (the XTC codec, the text "
        "reader and writers, the C(t) files' renderer) from csrc/*.cpp at first use"
    )


def host_library_path(name: str) -> Path:
    src = CSRC / f"{name}.cpp"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(HOST_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def load_host(name: str):
    """The loaded host library of ``csrc/<name>.cpp``, compiled on the first
    call unless its hashed file exists.  A failed build raises."""
    with _lock:
        if name not in _host_libs:
            out = host_library_path(name)
            if not out.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = BUILD_DIR / f"{out.stem}.{os.getpid()}.so.tmp"
                cmd = [_host_compiler(), *HOST_FLAGS, str(CSRC / f"{name}.cpp"),
                       "-o", str(tmp)]
                try:
                    res = subprocess.run(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True)
                    if res.returncode != 0:
                        raise RuntimeError(
                            f"host build failed ({res.returncode}):\n{' '.join(cmd)}\n"
                            f"{res.stdout}")
                    os.replace(tmp, out)  # atomic, as for the kernel library
                finally:
                    tmp.unlink(missing_ok=True)
            _host_libs[name] = ctypes.CDLL(str(out))
        return _host_libs[name]
