"""The port imports without JAX, nvcc or triton, and its kernel build
fails loudly where the CUDA toolkit is missing."""

import os
import subprocess
import sys

import pytest
import torch

from spinrelax_tpu_torch import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = [
    "spinrelax_tpu_torch", "spinrelax_tpu_torch._build",
    "spinrelax_tpu_torch.constants",
    "spinrelax_tpu_torch.convert", "spinrelax_tpu_torch.entry",
    "spinrelax_tpu_torch.ops.autocorr", "spinrelax_tpu_torch.ops.cuda_acf",
    "spinrelax_tpu_torch.ops.cuda_lm", "spinrelax_tpu_torch.ops.jomega",
    "spinrelax_tpu_torch.ops.relaxation", "spinrelax_tpu_torch.fit.lm",
    "spinrelax_tpu_torch.fit.engine", "spinrelax_tpu_torch.parallel.pipeline",
    "spinrelax_tpu_torch.core.stats", "spinrelax_tpu_torch.models.ctmodel",
    "spinrelax_tpu_torch.models.diffusion", "spinrelax_tpu_torch.ops.observables",
    "spinrelax_tpu_torch.fit.walk", "spinrelax_tpu_torch.fit.expfit",
    "spinrelax_tpu_torch.parallel.streamed", "spinrelax_tpu_torch.parallel.launch",
    "spinrelax_tpu_torch.parallel.mesh", "spinrelax_tpu_torch.parallel.ingest",
    "spinrelax_tpu_torch.parallel.fit", "spinrelax_tpu_torch.parallel.dryrun",
    "spinrelax_tpu_torch.core.quaternion", "spinrelax_tpu_torch.core.geometry",
    "spinrelax_tpu_torch.ops.orient", "spinrelax_tpu_torch.io.native",
    "spinrelax_tpu_torch.io.zopen", "spinrelax_tpu_torch.io.pdb",
    "spinrelax_tpu_torch.io.xvg", "spinrelax_tpu_torch.io.vectors",
    "spinrelax_tpu_torch.io.trajectory", "spinrelax_tpu_torch.pipeline.stages",
    "spinrelax_tpu_torch.io.colvar", "spinrelax_tpu_torch.io.fittedct",
    "spinrelax_tpu_torch.io.dx", "spinrelax_tpu_torch.ops.dq",
    "spinrelax_tpu_torch.pipeline.corrections", "spinrelax_tpu_torch.pipeline.manifest",
    "spinrelax_tpu_torch.pipeline.config", "spinrelax_tpu_torch.pipeline.cli",
    "spinrelax_tpu_torch.pipeline.runall", "spinrelax_tpu_torch.io.experiments",
    "spinrelax_tpu_torch.models.experiments", "spinrelax_tpu_torch.fit.scalar",
    "spinrelax_tpu_torch.fit.globalfit", "spinrelax_tpu_torch.fit.legacyfit",
    "spinrelax_tpu_torch.fit.legacy_expfit",
    "spinrelax_tpu_torch.__main__", "spinrelax_tpu_torch.ops.pbc", "spinrelax_tpu_torch.ops.ired",
    "spinrelax_tpu_torch.utils.profiling", "spinrelax_tpu_torch.pipeline.plotting",
    "spinrelax_tpu_torch.pipeline.h2d",
    "spinrelax_tpu_torch.io.gro", "spinrelax_tpu_torch.io.gmx", "spinrelax_tpu_torch.io.dcd",
    "spinrelax_tpu_torch.io.amber", "spinrelax_tpu_torch.io.xyz", "spinrelax_tpu_torch.io.psf",
    "spinrelax_tpu_torch.io.prmtop", "spinrelax_tpu_torch.io.ndx",
    "spinrelax_tpu_torch.io.nmrstar", "spinrelax_tpu_torch.io.bmrb",
    "spinrelax_tpu_torch.io.hydronmr",
]


def test_every_module_is_listed():
    pkg = os.path.join(REPO, "spinrelax_tpu_torch")
    found = set()
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3]
                name = rel.replace(os.sep, ".").removesuffix(".__init__")
                found.add(name)
    assert found - {"spinrelax_tpu_torch.ops", "spinrelax_tpu_torch.fit",
                    "spinrelax_tpu_torch.parallel", "spinrelax_tpu_torch.core",
                    "spinrelax_tpu_torch.models", "spinrelax_tpu_torch.io",
                    "spinrelax_tpu_torch.pipeline", "spinrelax_tpu_torch.utils"} == set(MODULES)


def test_import_leaves_out_jax_and_toolchain():
    """In a fresh interpreter whose PATH holds no nvcc, importing every
    module loads neither jax, the JAX package nor triton, and builds
    nothing."""
    code = (
        "import sys\n"
        f"for m in {MODULES!r}:\n"
        "    __import__(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'triton', 'spinrelax_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {"PATH": os.path.dirname(sys.executable), "PYTHONPATH": REPO,
           "HOME": os.environ.get("HOME", "/tmp")}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_build_raises_without_nvcc(monkeypatch):
    """A kernel build with no CUDA toolkit raises a clear error."""
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    monkeypatch.setattr(_build, "library_path",
                        lambda: _build.BUILD_DIR / "libspinrelax_kernels_absent.so")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_library_name_tracks_sources():
    """The library is keyed by a hash of csrc/ and the flags: one name per
    source state, and every .cu source has a C entry point bound."""
    p = _build.library_path()
    assert p == _build.library_path()
    assert p.parent == _build.BUILD_DIR and p.name.startswith("libspinrelax_kernels_")
    srcs = {s.name for s in _build._sources()}
    assert {"acf_lag_sums.cu", "lm_hgc.cu"} <= srcs
    text = "".join(s.read_text() for s in _build._sources())
    for name in _build._SIGNATURES:
        assert f"int {name}(" in text


def test_check_raises_on_cuda_error():
    _build.check(0, "x")
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        _build.check(9, "lm_hgc_f32")


def test_acf_dispatch_refuses_other_devices():
    """The ACF dispatcher has two routes, CUDA float32 and the CPU; a
    tensor elsewhere raises instead of taking either."""
    from spinrelax_tpu_torch.ops import autocorr

    with pytest.raises(ValueError, match="unsupported device"):
        autocorr.acf_sums(torch.empty((2, 10, 3), device="meta"), 5)
