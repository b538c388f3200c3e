"""Backend registry (reference: src/gt4py/cartesian/backend/base.py:35-152).

- ``"torch"``: the plain PyTorch executor, the counterpart of the JAX
  package's ``"numpy"``/``"jax"`` executors.
- ``"cuda"``: generated CUDA C++ kernels, the counterpart of ``"pallas"``.
  On CPU tensors it runs the ``"torch"`` executor.
- ``"numpy"`` and ``"debug"``: copies of the JAX package's numpy oracle and ``"debug"``
  point-loop executor, on the host only (CPU tensors and numpy arrays).
"""

from __future__ import annotations

from typing import Callable, Dict

REGISTRY: Dict[str, Callable] = {}


def register(name: str):
    def _reg(cls):
        REGISTRY[name] = cls
        cls.name = name
        return cls

    return _reg


def from_name(name: str):
    if name not in REGISTRY:
        raise ValueError(f"Unknown backend '{name}'. Available: {sorted(REGISTRY)}")
    return REGISTRY[name]


from . import numpy_backend  # noqa: E402,F401
from . import debug_backend  # noqa: E402,F401
from . import torch_backend  # noqa: E402,F401
from . import cuda_backend  # noqa: E402,F401
