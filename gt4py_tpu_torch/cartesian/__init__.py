"""Cartesian GTScript DSL on PyTorch (counterpart of gt4py_tpu.cartesian)."""

from . import (  # noqa: F401
    analysis,
    artifact_cache,
    backend,
    frontend,
    gtscript,
    ir,
    passes,
    pretty,
    stencil_builder,
    stencil_object,
    validation,
)
from .stencil_object import StencilObject  # noqa: F401

# reference-name aliases
from . import artifact_cache as caching  # noqa: F401
from gt4py_tpu_torch import cache_manager as gt_cache_manager  # noqa: F401
from gt4py_tpu_torch import config  # noqa: F401
