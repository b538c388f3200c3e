"""Field-view type system: TypeSpec hierarchy, translation, inference rules.

Reference: src/gt4py/next/type_system/type_specifications.py:21-229
(TypeSpec/DataType/CallableType/ScalarType/FieldType/TupleType/
FunctionType/OffsetType/DimensionType/DomainType), type_translation.py
(python values & annotations -> TypeSpec) and type_info.py (promote :561,
is_arithmetic/is_logical, extract_dims/extract_dtype).

TPU-first compaction: plain frozen dataclasses instead of the eve
datamodel framework; the semantic rules (no implicit scalar promotion,
canonical dimension ordering) are identical.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from gt4py_tpu_torch.core import dtypes
#: bfloat16's numpy ``kind`` is 'V' (void), so kind-string arithmetic
#: checks must special-case it (shared vocabulary: core.definitions)
from gt4py_tpu_torch.core.definitions import BFLOAT16 as _BFLOAT16

from .common import (
    Connectivity,
    Dimension,
    Domain,
    Field,
    FieldOffset,
    promote_dims,
)


# --------------------------------------------------------------------- #
# TypeSpec hierarchy
# --------------------------------------------------------------------- #


class TypeSpec:
    """Base of all field-view types."""

    __slots__ = ()


@dataclasses.dataclass(frozen=True)
class VoidType(TypeSpec):
    """Type of statements / program operator calls (no value)."""

    def __str__(self):
        return "void"


@dataclasses.dataclass(frozen=True)
class DeferredType(TypeSpec):
    """A type not yet known (bare ``Field`` annotations, untyped params);
    resolved against the concrete arguments at first call."""

    constraint: Optional[str] = None  # "field", "scalar", ...

    def __str__(self):
        return f"deferred({self.constraint or 'any'})"


@dataclasses.dataclass(frozen=True)
class ScalarType(TypeSpec):
    kind: np.dtype  # numpy dtype carries all we need (reference ScalarKind)
    #: weak scalars come from literals/closure constants and adapt to the
    #: other operand's dtype (jax weak-type analog); named parameters are
    #: strong and never implicitly convert (reference type_info.promote)
    weak: bool = False

    def __str__(self):
        return str(np.dtype(self.kind))


@dataclasses.dataclass(frozen=True)
class FieldType(TypeSpec):
    dims: Tuple[Dimension, ...]
    dtype: ScalarType

    def __str__(self):
        dims = ", ".join(d.value for d in self.dims)
        return f"Field[[{dims}], {self.dtype}]"


@dataclasses.dataclass(frozen=True)
class TupleType(TypeSpec):
    """Tuple of types; optionally a NAMED collection (reference: NamedTuple
    / dataclass parameters, tests/next_tests/.../test_named_collections.py).
    ``names``/``origin`` don't participate in equality: named collections
    are structurally compatible with plain tuples of the same types."""

    types: Tuple[TypeSpec, ...]
    names: Optional[Tuple[str, ...]] = dataclasses.field(default=None, compare=False)
    origin: Any = dataclasses.field(default=None, compare=False)

    def __str__(self):
        if self.names:
            inner = ", ".join(f"{n}: {t}" for n, t in zip(self.names, self.types))
            cls = getattr(self.origin, "__name__", "namedtuple")
            return f"{cls}[{inner}]"
        return f"tuple[{', '.join(map(str, self.types))}]"

    def __iter__(self):
        return iter(self.types)

    def __len__(self):
        return len(self.types)


@dataclasses.dataclass(frozen=True)
class DimensionType(TypeSpec):
    dim: Dimension

    def __str__(self):
        return f"Dimension[{self.dim.value}]"


@dataclasses.dataclass(frozen=True)
class OffsetType(TypeSpec):
    source: Dimension
    target: Tuple[Dimension, ...]

    def __str__(self):
        return f"Offset[{self.source.value}]"


@dataclasses.dataclass(frozen=True)
class OffsetIndexType(TypeSpec):
    """The type of ``Ioff[1]`` -- a concrete shift."""

    source: Dimension
    target: Tuple[Dimension, ...]

    def __str__(self):
        return f"OffsetIndex[{self.source.value}]"


@dataclasses.dataclass(frozen=True)
class ConnectivityType(TypeSpec):
    source: Dimension
    codomain: Dimension
    local_dim: Optional[Dimension]
    has_skip_values: bool = False

    def __str__(self):
        return f"Connectivity[{self.source.value} -> {self.codomain.value}]"


@dataclasses.dataclass(frozen=True)
class DomainType(TypeSpec):
    dims: Tuple[Dimension, ...]

    def __str__(self):
        return f"Domain[{', '.join(d.value for d in self.dims)}]"


@dataclasses.dataclass(frozen=True)
class FunctionType(TypeSpec):
    params: Tuple[Tuple[str, TypeSpec], ...]
    returns: TypeSpec

    def __str__(self):
        ps = ", ".join(f"{n}: {t}" for n, t in self.params)
        return f"({ps}) -> {self.returns}"


@dataclasses.dataclass(frozen=True, eq=False)
class OperatorType(TypeSpec):
    """The type of a referenced field/scan operator (callable)."""

    op: Any

    def __str__(self):
        return f"operator[{getattr(self.op, '__name__', '?')}]"


@dataclasses.dataclass(frozen=True)
class CastType(TypeSpec):
    """A scalar type alias used as astype() target (e.g. float32)."""

    dtype: np.dtype

    def __str__(self):
        return f"type[{np.dtype(self.dtype)}]"


@dataclasses.dataclass(frozen=True, eq=False)
class BuiltinType(TypeSpec):
    """A field-view builtin function reference."""

    fn: Any

    def __str__(self):
        return f"builtin[{getattr(self.fn, '__name__', '?')}]"


@dataclasses.dataclass(frozen=True, eq=False)
class CollectionCtorType(TypeSpec):
    """A NamedTuple/dataclass class used as a constructor inside an
    operator (``Vel(u=..., v=...)``)."""

    tuple_type: TupleType

    def __str__(self):
        return f"constructor[{self.tuple_type}]"


# --------------------------------------------------------------------- #
# annotation surface:  Field[Dims[I, J], float64]
# --------------------------------------------------------------------- #


class Dims:
    """``Dims[I, J]`` in annotations (reference: gt4py.next.Dims)."""

    def __class_getitem__(cls, item):
        dims = item if isinstance(item, tuple) else (item,)
        if not all(isinstance(d, Dimension) for d in dims):
            raise TypeError("Dims[...] takes Dimension instances")
        return _DimsSpec(dims)


@dataclasses.dataclass(frozen=True)
class _DimsSpec:
    dims: Tuple[Dimension, ...]


def field_annotation(item) -> TypeSpec:
    """Translate the subscript of ``Field[...]`` into a FieldType.

    Accepted forms (reference: type_translation.from_type_hint):
      ``Field[Dims[I, J], float64]``
      ``Field[[I, J], float64]``
      ``Field[I, float64]``
    """
    if not isinstance(item, tuple):
        raise TypeError("Field[...] needs dims and a dtype: Field[Dims[I, J], float64]")
    *dims_part, dtype = item
    if len(dims_part) == 1 and isinstance(dims_part[0], _DimsSpec):
        dims = dims_part[0].dims
    elif len(dims_part) == 1 and isinstance(dims_part[0], (list, tuple)):
        dims = tuple(dims_part[0])
    else:
        dims = tuple(dims_part)
    if not all(isinstance(d, Dimension) for d in dims):
        raise TypeError(f"Field[...]: dims must be Dimension instances, got {dims}")
    return FieldType(dims=dims, dtype=ScalarType(np.dtype(dtype)))


# scalar aliases exported at package level (reference: gt4py.next exports
# the core_defs scalar types)
bool_ = np.bool_
int8 = np.int8
int16 = np.int16
int32 = np.int32
int64 = np.int64
uint8 = np.uint8
uint16 = np.uint16
uint32 = np.uint32
uint64 = np.uint64
float32 = np.float32
float64 = np.float64
#: the port's bfloat16 token (``core.definitions.BFLOAT16``, a dtype
#: rather than a scalar type: a bfloat16 scalar is a 0-d tensor)
bfloat16 = _BFLOAT16
IndexType = np.int32  # (reference: fbuiltins.IndexType :116)

_SCALAR_ALIASES: Dict[Any, np.dtype] = {
    t: np.dtype(t)
    for t in (
        bool, int, float,
        bool_, int8, int16, int32, int64,
        uint8, uint16, uint32, uint64, float32, float64, bfloat16,
    )
}


def collection_fields(obj) -> Optional[Tuple[Tuple[str, ...], Tuple[Any, ...]]]:
    """(member names, member annotations) for a NamedTuple class or a
    dataclass (class or instance); None for anything else."""
    cls = obj if isinstance(obj, type) else type(obj)
    if issubclass(cls, tuple) and hasattr(cls, "_fields"):
        ann = _resolved_annotations(cls)
        return tuple(cls._fields), tuple(ann.get(n) for n in cls._fields)
    if dataclasses.is_dataclass(cls):
        ann = _resolved_annotations(cls)
        names = tuple(f.name for f in dataclasses.fields(cls))
        return names, tuple(ann.get(n, f.type) for n, f in zip(
            names, dataclasses.fields(cls)
        ))
    return None


def _resolved_annotations(cls) -> Dict[str, Any]:
    """__annotations__ with string entries (PEP 563) evaluated against the
    class's module globals; unresolvable entries stay as strings (they fail
    later in from_annotation with a clear error)."""
    import sys

    ann = dict(getattr(cls, "__annotations__", {}))
    mod = sys.modules.get(getattr(cls, "__module__", ""), None)
    g = getattr(mod, "__dict__", {})
    for k, v in ann.items():
        if isinstance(v, str):
            try:
                ann[k] = eval(v, g)  # noqa: S307 -- annotation strings
            except Exception:
                pass
    return ann


def from_annotation(hint) -> TypeSpec:
    """Translate a parameter annotation into a TypeSpec."""
    if hint is None or hint is dataclasses.MISSING:
        return DeferredType()
    if isinstance(hint, TypeSpec):
        return hint
    if hint is Field:
        return DeferredType(constraint="field")
    fields = collection_fields(hint) if isinstance(hint, type) else None
    if fields is not None:
        names, anns = fields
        return TupleType(
            tuple(from_annotation(a) for a in anns), names=names, origin=hint
        )
    if hint in _SCALAR_ALIASES:
        return ScalarType(_SCALAR_ALIASES[hint])
    if isinstance(hint, tuple):
        return TupleType(tuple(from_annotation(h) for h in hint))
    # typing.Tuple[...] / tuple[...]
    origin = getattr(hint, "__origin__", None)
    if origin is tuple:
        return TupleType(tuple(from_annotation(a) for a in hint.__args__))
    try:
        return ScalarType(np.dtype(hint))
    except TypeError:
        raise TypeError(f"Unsupported annotation in field operator: {hint!r}")


def from_value(value) -> TypeSpec:
    """Type of a concrete runtime value."""
    if isinstance(value, Field):
        return FieldType(dims=value.dims, dtype=ScalarType(value.dtype))
    if isinstance(value, tuple) and hasattr(value, "_fields"):  # NamedTuple
        return TupleType(
            tuple(from_value(v) for v in value),
            names=tuple(value._fields),
            origin=type(value),
        )
    if isinstance(value, tuple):
        return TupleType(tuple(from_value(v) for v in value))
    if isinstance(value, Dimension):
        return DimensionType(value)
    if isinstance(value, FieldOffset):
        return OffsetType(value.source, value.target)
    if isinstance(value, Connectivity):
        return ConnectivityType(
            value.source,
            value.codomain,
            value.local_dim,
            value.skip_value is not None,
        )
    if isinstance(value, Domain):
        return DomainType(value.dims)
    if isinstance(value, (bool, np.bool_)):
        return ScalarType(np.dtype(bool))
    if isinstance(value, (int, np.integer)):
        return ScalarType(np.dtype(type(value)) if isinstance(value, np.integer) else np.dtype(np.int64))
    if isinstance(value, (float, np.floating)):
        return ScalarType(np.dtype(type(value)) if isinstance(value, np.floating) else np.dtype(np.float64))
    if isinstance(value, torch.Tensor) and value.ndim == 0:
        return ScalarType(dtypes.to_numpy(value.dtype))
    if hasattr(value, "dtype") and np.ndim(value) == 0:
        return ScalarType(np.dtype(value.dtype))
    # user named collections LAST: framework types (FieldOffset, Domain,
    # ...) are dataclasses themselves and must hit their branches above
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        fs = dataclasses.fields(value)
        return TupleType(
            tuple(from_value(getattr(value, f.name)) for f in fs),
            names=tuple(f.name for f in fs),
            origin=type(value),
        )
    raise TypeError(f"Cannot type value of kind {type(value).__name__}")


# --------------------------------------------------------------------- #
# type algebra (reference: type_info.py)
# --------------------------------------------------------------------- #


def is_deferred(t: TypeSpec) -> bool:
    if isinstance(t, DeferredType):
        return True
    if isinstance(t, TupleType):
        return any(is_deferred(x) for x in t.types)
    return False


def is_arithmetic(t: TypeSpec) -> bool:
    dt = extract_dtype(t)
    if dt is None:
        return False
    ndt = np.dtype(dt.kind)
    return ndt.kind in "iuf" or ndt == _BFLOAT16


def is_logical(t: TypeSpec) -> bool:
    dt = extract_dtype(t)
    return dt is not None and np.dtype(dt.kind).kind == "b"


def is_integral(t: TypeSpec) -> bool:
    dt = extract_dtype(t)
    return dt is not None and np.dtype(dt.kind).kind in "iu"


def extract_dtype(t: TypeSpec) -> Optional[ScalarType]:
    if isinstance(t, ScalarType):
        return t
    if isinstance(t, FieldType):
        return t.dtype
    return None


def extract_dims(t: TypeSpec) -> Tuple[Dimension, ...]:
    if isinstance(t, FieldType):
        return t.dims
    return ()


def promote(*types: TypeSpec, always_field: bool = False) -> TypeSpec:
    """Common type of field/scalar operands.  NO implicit dtype promotion:
    mixed dtypes are an error, matching the reference (type_info.promote
    :561-599 -- 'Could not promote scalars of different dtype')."""
    dtypes = []
    for t in types:
        dt = extract_dtype(t)
        if dt is None:
            raise TypeError(f"expected a field or scalar type, got '{t}'")
        dtypes.append(np.dtype(dt.kind))
    if any(dt != dtypes[0] for dt in dtypes):
        pretty = " and ".join(f"'{t}'" for t in types)
        raise TypeError(f"Could not promote {pretty} to common type (use astype)")
    if not always_field and all(isinstance(t, ScalarType) for t in types):
        return types[0]
    dims = promote_dims(*(extract_dims(t) for t in types))
    return FieldType(dims=dims, dtype=ScalarType(dtypes[0]))


def accepts(param: TypeSpec, arg: TypeSpec) -> bool:
    """Whether a concrete ``arg`` type satisfies a declared ``param``."""
    if isinstance(param, DeferredType):
        if param.constraint == "field":
            return isinstance(arg, FieldType)
        return True
    if isinstance(param, TupleType) and isinstance(arg, TupleType):
        return len(param) == len(arg) and all(
            accepts(p, a) for p, a in zip(param.types, arg.types)
        )
    if isinstance(param, FieldType) and isinstance(arg, FieldType):
        # dims must be a subset in matching order; dtype must match
        return (
            param.dtype == arg.dtype
            and all(d in param.dims for d in arg.dims)
        )
    if isinstance(param, ScalarType) and isinstance(arg, ScalarType):
        return np.dtype(param.kind) == np.dtype(arg.kind)
    return type(param) is type(arg) and param == arg
