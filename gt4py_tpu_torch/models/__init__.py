"""Models built on the stencil DSL (counterpart of gt4py_tpu.models)."""

from .dycore import MiniDycore  # noqa: F401
from .fv_advection import FvAdvection  # noqa: F401
from .full_dycore import FullDycore  # noqa: F401
