"""spinrelax_tpu_torch — the PyTorch/CUDA port of ``spinrelax_tpu``.

Module paths and function names mirror the JAX package, so each function
here has its counterpart under the same name in ``spinrelax_tpu``.  The
port imports ``torch`` (and numpy) and never ``jax`` or the JAX package.

Every Pallas kernel of the JAX package has a hand-written CUDA C++
counterpart for Hopper (``csrc/``), compiled with ``nvcc`` on first use
(``_build``).  Each kernel's wrapper runs the kernel for a CUDA float32
tensor, its plain PyTorch version for a CPU tensor, and raises for
anything else.  Importing the package needs neither ``nvcc`` nor a GPU.
"""

__version__ = "0.1.0"
