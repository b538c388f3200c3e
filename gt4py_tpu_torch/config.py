"""Environment-driven configuration of the PyTorch port.

Holds the default device for storage and models, the directory that
generated CUDA kernels are built into, the literal precisions the
analysis reads, and the next DSL's switches (the same defaults as
``gt4py_tpu.config``).  Every setting is a module attribute that the code
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
