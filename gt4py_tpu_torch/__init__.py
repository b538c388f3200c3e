"""gt4py_tpu_torch: the Cartesian stencil framework on PyTorch and CUDA.

The port of ``gt4py_tpu`` to NVIDIA GPUs.  It keeps the JAX package's
module names, language and numerics, and imports neither ``jax`` nor
``gt4py_tpu``:

    user API    gt4py_tpu_torch.cartesian.gtscript  (@stencil, Field, ...)
    frontend    Python AST -> StencilIR  (cartesian/frontend/)
    middle-end  validation + dtype inference + extent analysis
    executors   "torch" (plain PyTorch) | "cuda" (generated CUDA C++ kernels)
    runtime     StencilObject call machinery, storage over torch tensors
"""

__version__ = "0.1.0"

from . import config  # noqa: F401
from . import storage  # noqa: F401

__all__ = ["__version__", "config", "storage"]
