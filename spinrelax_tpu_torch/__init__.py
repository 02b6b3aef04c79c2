"""spinrelax_tpu_torch — the PyTorch/CUDA port of ``spinrelax_tpu``.

Module paths and function names mirror the JAX package, so each function
here has its counterpart under the same name in ``spinrelax_tpu``.  The
port imports ``torch`` (and numpy) and never ``jax`` or the JAX package.

Every Pallas kernel of the JAX package has a hand-written CUDA C++
counterpart for Hopper (``csrc/``), compiled with ``nvcc`` on first use
(``_build``).  Each kernel's wrapper runs the kernel for a CUDA float32
tensor, its plain PyTorch version for a CPU tensor, and raises for
anything else.  Importing the package needs neither ``nvcc`` nor a GPU.
The entry points that place data (``entry.entry``,
``convert.palmer_state_from_numpy``) run on the card unless the caller
passes ``device="cpu"``.
"""

import torch

__version__ = "0.1.0"


def checked_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device with no card present
    raises instead of running quietly on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"spinrelax_tpu_torch: device {str(device)!r} requested but no CUDA "
            f"device is available; pass device='cpu' to run on the CPU"
        )
    return dev
