"""Models built on the stencil DSL (counterpart of gt4py_tpu.models)."""

from .dycore import MiniDycore  # noqa: F401
from .fv_advection import FvAdvection  # noqa: F401
from .full_dycore import FullDycore  # noqa: F401
from .shallow_water import ShallowWater, make_sw_step  # noqa: F401
from .spectral import (  # noqa: F401
    poisson_solve,
    poisson_solve_numpy,
    spectral_filter,
    spectral_filter_numpy,
)
