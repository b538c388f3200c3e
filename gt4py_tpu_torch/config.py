"""Environment-driven configuration of the PyTorch port.

Holds the default device for storage and models, the directory that
generated CUDA kernels are built into, and the literal precisions the
analysis reads (the same defaults as ``gt4py_tpu.config``).
"""

from __future__ import annotations

import os


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return int(v) if v is not None else default


#: Device that storage allocators and models use when none is given.
DEFAULT_DEVICE: str = os.environ.get("GT4PY_TPU_TORCH_DEVICE", "cpu")

#: Default backend used by ``@stencil`` when none is given.
DEFAULT_BACKEND: str = os.environ.get("GT4PY_TPU_TORCH_DEFAULT_BACKEND", "torch")

#: Where ``backend="cuda"`` writes generated sources and the shared
#: libraries nvcc builds from them (one sub-directory per content hash).
#: Defaults to a directory beside the package, inside the checkout.
BUILD_DIR: str = os.environ.get(
    "GT4PY_TPU_TORCH_BUILD_DIR",
    os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".gt4py_tpu_torch_build",
    ),
)

#: Literal precision defaults (reference: cartesian/definitions.py:30-43).
LITERAL_FLOAT_PRECISION: int = _env_int("GT4PY_TPU_TORCH_LITERAL_FLOAT_PRECISION", 64)
LITERAL_INT_PRECISION: int = _env_int("GT4PY_TPU_TORCH_LITERAL_INT_PRECISION", 64)
