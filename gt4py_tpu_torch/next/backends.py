"""Execution backends for the next field-view DSL.

The counterpart of ``gt4py_tpu.next.backends``.  The reference dispatches
operators and programs to program processors (roundtrip's generated-Python
oracle, gtfn C++ CPU/GPU, dace SDFGs -- src/gt4py/next/program_processors/
runners/).  Here every executor runs the same typed-IR interpreter
(interpreter.py) or lowers to the CUDA kernels:

- ``numpy_oracle`` (reference: roundtrip) -- eager numpy execution, the
  independent reference semantics;
- ``torch`` (the counterpart of ``jax_eager``/``jax_jit``; reference:
  gtfn_cpu / gtfn_gpu) -- eager torch execution on the fields' device;
- ``cuda`` (the counterpart of ``pallas``) -- eligible cartesian operators,
  scans and program segments lower to the generated CUDA kernels
  (cuda_bridge.py); the rest run as ``torch``.  On CPU tensors the
  kernels' plain executor runs in their place.

``with_backend(None)`` keeps the default embedded mode: execution follows
whatever namespace the argument Fields already use.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .common import Field


@dataclasses.dataclass(frozen=True)
class Backend:
    name: str
    namespace: str  # "numpy" | "torch"
    #: "cuda": lower eligible cartesian operators to the generated CUDA
    #: kernels (cuda_bridge.py); ineligible ones run embedded
    compiled: str = ""

    def convert(self, value):
        """Move a Field's storage into this backend's namespace (numpy
        data becomes a tensor on ``config.DEFAULT_DEVICE`` in the
        constructors' layout; tensors keep their device)."""
        if not isinstance(value, Field):
            return value
        if self.namespace == "numpy":
            data = value.data
            if isinstance(data, torch.Tensor):
                data = data.detach().cpu().numpy()
            elif not isinstance(data, np.ndarray):
                data = np.asarray(data)
            return Field(value.domain, data)
        if isinstance(value.data, torch.Tensor):
            return value
        from .constructors import _from_numpy

        return Field(value.domain, _from_numpy(value.dims, value.data, None))

    def __str__(self):
        return self.name


#: independent oracle semantics (reference: runners/roundtrip.py:45-237)
numpy_oracle = Backend("numpy_oracle", "numpy")
#: eager execution on the fields' device (reference: runners/gtfn.py)
torch_eager = Backend("torch", "torch")
#: the generated CUDA kernels (reference: the dace/gtfn compiled runners)
cuda = Backend("cuda_cartesian", "torch", compiled="cuda")

#: reference-name aliases so ported code keeps working
roundtrip = numpy_oracle
gtfn_cpu = torch_eager
gtfn_gpu = torch_eager
run_gtfn = torch_eager
run_gtfn_gpu = torch_eager

_BY_NAME = {
    "numpy": numpy_oracle,
    "numpy_oracle": numpy_oracle,
    "roundtrip": numpy_oracle,
    "torch": torch_eager,
    "gtfn_cpu": torch_eager,
    "gtfn_gpu": torch_eager,
    "cuda": cuda,
    "cuda_cartesian": cuda,
}


def resolve(backend) -> "Backend | None":
    """None, a Backend, or a name string -> Backend (or None = embedded)."""
    if backend is None or isinstance(backend, Backend):
        return backend
    if isinstance(backend, str):
        try:
            return _BY_NAME[backend]
        except KeyError:
            raise ValueError(
                f"unknown backend '{backend}' "
                f"(available: {sorted(_BY_NAME)})"
            ) from None
    raise TypeError(f"not a backend: {backend!r}")
