"""Cartesian GTScript DSL on PyTorch (counterpart of gt4py_tpu.cartesian)."""

from . import (  # noqa: F401
    analysis,
    backend,
    frontend,
    gtscript,
    ir,
    passes,
    stencil_builder,
    stencil_object,
    validation,
)
from .stencil_object import StencilObject  # noqa: F401
from gt4py_tpu_torch import config  # noqa: F401
