"""Environment-driven configuration of the PyTorch port.

Holds the default device for storage and models (the card: a CPU run
asks for ``device="cpu"`` or sets ``GT4PY_TPU_TORCH_DEVICE=cpu``), the
directory that generated CUDA kernels are built into, the persistent
cache's root, the literal
precisions the analysis reads, and the next DSL's switches (the same
defaults as ``gt4py_tpu.config``).  Every setting is a module attribute that the code
reads where it is used, on every call: assigning one (``config.
PROGRAM_FUSION = False``) takes effect on the next call.
"""

from __future__ import annotations

import os
import warnings
from typing import Optional


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return int(v) if v is not None else default


def _env_bool(name: str, default: bool) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.strip().lower() in ("1", "true", "yes", "on")


#: Device that storage allocators, constructors and models use when none
#: is given.  On a machine without a GPU an entry point called without a
#: device raises (``resolve_device``); it never falls back to the CPU.
DEFAULT_DEVICE: str = os.environ.get("GT4PY_TPU_TORCH_DEVICE", "cuda")

#: Default backend used by ``@stencil`` when none is given: the generated
#: CUDA kernels (on CPU tensors, which a caller passes only after asking
#: for the CPU, the same backend runs its plain executor).
DEFAULT_BACKEND: str = os.environ.get("GT4PY_TPU_TORCH_DEFAULT_BACKEND", "cuda")


def resolve_device(device=None):
    """The ``torch.device`` an entry point allocates on: ``device``, or
    ``DEFAULT_DEVICE`` when it is None.  A CUDA device where torch sees
    none raises ``RuntimeError``."""
    import torch

    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch sees no CUDA device; "
            "pass device='cpu' or set GT4PY_TPU_TORCH_DEVICE=cpu to run on "
            "the CPU"
        )
    return dev

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

#: Where the persistent caches live (``cartesian.artifact_cache``'s parsed
#: stencil IR under ``artifacts/``); ``python -m gt4py_tpu_torch.cache_manager``
#: reports and removes it with ``BUILD_DIR``.  Defaults to a directory
#: beside the package, inside the checkout.
CACHE_ROOT: str = os.environ.get(
    "GT4PY_TPU_TORCH_CACHE_ROOT",
    os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".gt4py_tpu_torch_cache",
    ),
)

#: Persist each built stencil's parsed IR under ``CACHE_ROOT`` so that a
#: later process skips the frontend (``cartesian.artifact_cache``).
ARTIFACT_CACHE: bool = _env_bool("GT4PY_TPU_TORCH_ARTIFACT_CACHE", True)

#: Literal precision defaults (reference: cartesian/definitions.py:30-43).
LITERAL_FLOAT_PRECISION: int = _env_int("GT4PY_TPU_TORCH_LITERAL_FLOAT_PRECISION", 64)
LITERAL_INT_PRECISION: int = _env_int("GT4PY_TPU_TORCH_LITERAL_INT_PRECISION", 64)

#: Metrics level (``instrumentation.metrics.MetricLevel``); 0 disables.
COLLECT_METRICS_LEVEL: int = _env_int("GT4PY_TPU_TORCH_COLLECT_METRICS_LEVEL", 0)

#: Dump collected metrics as JSON at interpreter exit (path or empty).
DUMP_METRICS_AT_EXIT: Optional[str] = os.environ.get("GT4PY_TPU_TORCH_DUMP_METRICS_AT_EXIT")

#: Fuse runs of eligible next-DSL program statements into one stencil
#: (``next.cuda_bridge.lower_program``).  Off: every statement launches
#: its own operator's kernels.
PROGRAM_FUSION: bool = _env_bool("GT4PY_TPU_TORCH_PROGRAM_FUSION", True)

#: Surface next-DSL operators that run embedded instead of on the kernels
#: (``next.cuda_bridge.FALLBACK_EVENTS`` records every one): ``once``
#: (default) warns one time per (name, reason), ``always`` on every event,
#: ``never`` keeps the log silent.
WARN_ON_FALLBACK: str = os.environ.get("GT4PY_TPU_TORCH_WARN_ON_FALLBACK", "once")

#: Gather quasi-structured neighbor tables as strided windows
#: (``next.affine_remap``), the JAX package's ``GT4PY_TPU_AFFINE_GATHER``.
AFFINE_GATHER: bool = _env_bool("GT4PY_TPU_TORCH_AFFINE_GATHER", True)

#: Gather irregular neighbor tables by sort-routing through static
#: permutations (``next.sort_route``, K9 ``next.benes`` on the card), the
#: JAX package's ``GT4PY_TPU_SORT_GATHER``.  Off (with ``AFFINE_GATHER``):
#: every gather is one clipped ``index_select``.
SORT_GATHER: bool = _env_bool("GT4PY_TPU_TORCH_SORT_GATHER", True)


class PerformanceFallbackWarning(UserWarning):
    """A next operator ran on the embedded path instead of the kernels
    (same values, slower)."""


_warned_fallbacks: set = set()


def warn_fallback(what: str, reason: str) -> None:
    """Emit a :class:`PerformanceFallbackWarning` per ``WARN_ON_FALLBACK``."""
    mode = WARN_ON_FALLBACK
    if mode not in ("once", "always"):
        return
    if mode == "once":
        key = (what, reason)
        if key in _warned_fallbacks:
            return
        _warned_fallbacks.add(key)
    warnings.warn(f"{what}: runs embedded, not on the kernels ({reason})",
                  PerformanceFallbackWarning, stacklevel=3)
