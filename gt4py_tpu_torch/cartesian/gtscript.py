"""GTScript DSL surface: decorators, axes, field descriptors, math builtins.

API-parity module with the reference's ``gt4py.cartesian.gtscript``
(reference: src/gt4py/cartesian/gtscript.py:171-1004).  The symbols here are
*syntax*: inside a ``@stencil`` definition they are recognized by the AST
frontend; most are also directly executable on NumPy arrays so validation
functions can share code with stencil definitions.
"""

from __future__ import annotations

import numbers
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np

from gt4py_tpu_torch.core.definitions import BFLOAT16 as _BFLOAT16

#: bfloat16, usable as ``Field[bfloat16]``, a scalar annotation or a cast
#: (``bfloat16(x)`` inside a stencil).  It is the port's dtype token
#: (``core.definitions.BFLOAT16``), not a numpy scalar type: scalar
#: arguments are Python numbers or tensors, rounded to bfloat16 on entry.
bfloat16 = _BFLOAT16


# --------------------------------------------------------------------------- #
# Iteration order sentinels
# --------------------------------------------------------------------------- #

PARALLEL = 0
FORWARD = 1
BACKWARD = -1


# --------------------------------------------------------------------------- #
# Axes (reference: gtscript.py:509-654)
# --------------------------------------------------------------------------- #


class AxisIndex:
    """A point on an axis relative to its start (index>=0) or end (index<0)."""

    def __init__(self, axis: str, index: int, offset: int = 0):
        self.axis = axis
        self.index = index
        self.offset = offset

    def __repr__(self):
        return f"AxisIndex(axis={self.axis}, index={self.index}, offset={self.offset})"

    def __eq__(self, other):
        return repr(self) == repr(other)

    def __add__(self, offset: int):
        if not isinstance(offset, numbers.Integral):
            raise TypeError("Offset should be an integer type")
        return AxisIndex(self.axis, self.index, self.offset + int(offset)) if offset else self

    __radd__ = __add__

    def __sub__(self, offset: int):
        return self.__add__(-offset)


class ShiftedAxis:
    def __init__(self, name: str, shift: int):
        self.name = name
        self.shift = shift

    def __repr__(self):
        return f"ShiftedAxis(name={self.name}, shift={self.shift})"

    def __add__(self, shift: int):
        return ShiftedAxis(self.name, self.shift + shift)

    def __sub__(self, shift: int):
        return ShiftedAxis(self.name, self.shift - shift)


class Axis:
    def __init__(self, name: str):
        self.name = name

    def __repr__(self):
        return f"Axis({self.name})"

    def __str__(self):
        return self.name

    def __getitem__(self, index):
        if isinstance(index, slice):
            return AxisInterval(self.name, index.start, index.stop)
        return AxisIndex(self.name, int(index))

    def __add__(self, shift: int):
        return ShiftedAxis(self.name, shift)

    def __sub__(self, shift: int):
        return ShiftedAxis(self.name, -shift)


class AxisInterval:
    def __init__(self, axis: str, start, end):
        self.axis = axis
        self.start = start
        self.end = end


I = Axis("I")
J = Axis("J")
K = Axis("K")

#: Axis-set shorthands for Field annotations (reference: gtscript.py:657-680)
IJ = (I, J)
IK = (I, K)
JK = (J, K)
IJK = (I, J, K)


# --------------------------------------------------------------------------- #
# Syntactic context managers: computation / interval / horizontal / region
# --------------------------------------------------------------------------- #


class _SyntaxOnly:
    """Marker callables that must only appear inside stencil definitions."""

    def __init__(self, name: str):
        self._name = name

    def __call__(self, *args, **kwargs):
        raise RuntimeError(
            f"'{self._name}' can only be used inside a stencil definition"
        )

    def __enter__(self):
        raise RuntimeError(
            f"'{self._name}' can only be used inside a stencil definition"
        )

    def __exit__(self, *a):
        return False


computation = _SyntaxOnly("computation")
interval = _SyntaxOnly("interval")
horizontal = _SyntaxOnly("horizontal")


class _Region:
    def __getitem__(self, item):
        raise RuntimeError("'region' can only be used inside a stencil definition")


region = _Region()


def __INLINED(expr):  # noqa: N802 -- reference-parity name
    """Compile-time conditional marker (resolved by the frontend)."""
    return expr


def compile_assert(expr):
    """Compile-time assertion (evaluated by the frontend)."""
    if not expr:
        raise AssertionError("compile_assert failed")


def externals(*args):
    """Syntactic helper mirroring the reference's ``externals()``."""
    return args


# --------------------------------------------------------------------------- #
# Field type descriptors  (reference: gtscript.py:657-749)
# --------------------------------------------------------------------------- #


class _FieldDescriptor:
    """Result of ``Field[...]`` subscription: carries axes/dtype/data_dims."""

    def __init__(self, dtype, axes=IJK, data_dims: Tuple[int, ...] = ()):
        self.dtype = dtype
        self.axes = axes
        self.data_dims = tuple(int(d) for d in data_dims)

    @property
    def axes_names(self) -> Tuple[str, ...]:
        axes = self.axes if isinstance(self.axes, (tuple, list)) else (self.axes,)
        return tuple(a.name for a in axes)

    def __repr__(self):
        return f"Field[{self.axes_names}, {self.dtype}, {self.data_dims}]"


class _FieldMeta(type):
    def __getitem__(cls, item):
        # Accepted forms:
        #   Field[dtype]
        #   Field[axes, dtype]
        #   Field[(dtype, (n, ...))]          -- data dimensions
        #   Field[axes, (dtype, (n, ...))]
        axes = IJK
        spec = item
        if isinstance(item, tuple) and len(item) == 2 and _is_axes(item[0]):
            axes, spec = item
        if isinstance(spec, tuple):
            dtype, data_dims = spec
            return _FieldDescriptor(dtype, axes, tuple(data_dims))
        return _FieldDescriptor(spec, axes)


def _is_axes(obj) -> bool:
    if isinstance(obj, Axis):
        return True
    return isinstance(obj, (tuple, list)) and all(isinstance(a, Axis) for a in obj)


class Field(metaclass=_FieldMeta):
    """Field type annotation: ``Field[np.float64]``, ``Field[IJ, float]``,
    ``Field[(np.float32, (3,))]`` (data dimensions)."""


class _GlobalTableMeta(type):
    def __getitem__(cls, item):
        # GlobalTable[(dtype, (sizes...))]
        dtype, data_dims = item
        return _FieldDescriptor(dtype, axes=(), data_dims=tuple(data_dims))


class GlobalTable(metaclass=_GlobalTableMeta):
    """A lookup table: a field with data dimensions only (no I/J/K)."""


# --------------------------------------------------------------------------- #
# Math builtins -- callable on numpy arrays (for validation fns) and
# recognized by name in the frontend (reference: gtscript.py:826-1004).
# --------------------------------------------------------------------------- #

import scipy.special as _sps  # noqa: E402

sin = np.sin
cos = np.cos
tan = np.tan
asin = np.arcsin
acos = np.arccos
atan = np.arctan
atan2 = np.arctan2
sinh = np.sinh
cosh = np.cosh
tanh = np.tanh
asinh = np.arcsinh
acosh = np.arccosh
atanh = np.arctanh
sqrt = np.sqrt
exp = np.exp
log = np.log
log10 = np.log10
log2 = np.log2
cbrt = np.cbrt
floor = np.floor
ceil = np.ceil
trunc = np.trunc
isfinite = np.isfinite
isinf = np.isinf
isnan = np.isnan
mod = np.mod
erf = _sps.erf
erfc = _sps.erfc
gamma = _sps.gamma


def round(x):  # noqa: A001 -- reference-parity name (banker's rounding)
    return np.round(x)


def round_away_from_zero(x):
    """Round halves away from zero (reference: gtc/ufuncs.py custom ufunc)."""
    return np.trunc(x + np.copysign(np.asarray(0.5, dtype=np.asarray(x).dtype), x))


MATH_BUILTINS = {
    "abs",
    "min",
    "max",
    "mod",
    "sin",
    "cos",
    "tan",
    "asin",
    "acos",
    "atan",
    "atan2",
    "sinh",
    "cosh",
    "tanh",
    "asinh",
    "acosh",
    "atanh",
    "sqrt",
    "exp",
    "log",
    "log10",
    "log2",
    "gamma",
    "cbrt",
    "isfinite",
    "isinf",
    "isnan",
    "floor",
    "ceil",
    "trunc",
    "round",
    "round_away_from_zero",
    "erf",
    "erfc",
    "pow",
}


# --------------------------------------------------------------------------- #
# Decorators
# --------------------------------------------------------------------------- #


class GTScriptFunction:
    """A subroutine inlinable into stencils (reference: gtscript.function)."""

    def __init__(self, definition):
        self.definition = definition
        self.__name__ = definition.__name__
        self.__doc__ = definition.__doc__

    def __call__(self, *args, **kwargs):
        # Directly executable on numpy arrays for validation purposes
        # (offsets inside will not shift; only valid for offset-free bodies).
        return self.definition(*args, **kwargs)


def function(func):
    """Mark ``func`` as a GTScript subroutine for inlining into stencils."""
    return GTScriptFunction(func)


def stencil(
    backend: Optional[str] = None,
    definition=None,
    *,
    build_info: Optional[Dict[str, Any]] = None,
    dtypes: Optional[Dict[Any, Any]] = None,
    externals: Optional[Dict[str, Any]] = None,
    name: Optional[str] = None,
    rebuild: bool = False,
    raise_if_not_cached: bool = False,
    **kwargs,
):
    """Build a stencil object from a GTScript definition function.

    Reference-parity decorator (reference: gtscript.py:171-352).
    ``backend`` is one of ``gt4py_tpu_torch.cartesian.backend.REGISTRY`` --
    ``"torch"`` (plain PyTorch executor), ``"cuda"`` (generated kernels).
    """
    from gt4py_tpu_torch.cartesian.stencil_builder import StencilBuilder

    def _decorator(func):
        builder = StencilBuilder(
            definition=func,
            backend=backend,
            externals=externals or {},
            dtypes=dtypes or {},
            name=name or func.__name__,
            rebuild=rebuild,
            build_info=build_info,
            options=kwargs,
        )
        return builder.build()

    if definition is None:
        return _decorator
    return _decorator(definition)


def lazy_stencil(
    backend: Optional[str] = None,
    definition=None,
    *,
    eager: bool = False,
    check_syntax: bool = True,
    **kwargs,
):
    """Deferred-build variant (reference: gtscript.py:355-506)."""
    from gt4py_tpu_torch.cartesian.stencil_builder import LazyStencil, StencilBuilder

    def _decorator(func):
        builder = StencilBuilder(
            definition=func,
            backend=backend,
            externals=kwargs.pop("externals", None) or {},
            dtypes=kwargs.pop("dtypes", None) or {},
            name=kwargs.pop("name", None) or func.__name__,
            rebuild=kwargs.pop("rebuild", False),
            build_info=kwargs.pop("build_info", None),
            options=kwargs,
        )
        lazy = LazyStencil(builder)
        if check_syntax:
            lazy.check_syntax()
        if eager:
            return lazy.implementation
        return lazy

    if definition is None:
        return _decorator
    return _decorator(definition)
