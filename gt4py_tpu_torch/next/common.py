"""Core field-view vocabulary: dimensions, ranges, domains, fields.

The counterpart of ``gt4py_tpu.next.common`` (reference:
src/gt4py/next/common.py: Dimension :66-112 with the comparison operators
producing Domains, UnitRange :197 with Infinity, Domain :433, the Field
protocol :749, Connectivity :964-1122, promote_dims :1349).

There is one ``Field`` implementation, generic over the array namespace:
torch-backed fields are the product path (embedded on the tensors' device,
or lowered to the CUDA kernels by ``cuda_bridge``); numpy-backed fields
are the embedded oracle.  Both run the same domain/broadcast/offset logic.
Operations on tensors go through ``tnp``, a namespace with numpy's names
and numpy's result dtypes (derived from numpy itself), so the torch path
and the numpy oracle agree on every promotion.

``Field.remap`` on a tensor with a numpy neighbor table dispatches as the
JAX package does: a strided-window replay for quasi-structured tables
(``affine_remap``), else a sort-routed gather whose static permutations
run on the K9 kernel (``sort_route``, ``benes``), else one clipped
``index_select``; all three give the same values.  Chains of concrete
hops fold into one composite connectivity first (``_maybe_compose``).
Fields are plain objects (no pytree registration).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import enum
import warnings
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from gt4py_tpu_torch.cartesian.backend.torch_backend import _cbrt, _gamma
from gt4py_tpu_torch.core import dtypes
from gt4py_tpu_torch.core.definitions import BFLOAT16


#: Sentinel magnitude for unbounded ranges (reference: common.Infinity).
#: Large enough that no real grid index reaches it, small enough that
#: shifting it by any offset cannot overflow an int64.
INFINITY: int = 1 << 60


def _xp(data):
    """Array namespace of ``data``: numpy for numpy arrays (the embedded
    oracle), ``tnp`` for torch tensors."""
    return tnp if isinstance(data, torch.Tensor) else np


def _np_dtype(data) -> np.dtype:
    """numpy dtype of an array, tensor or scalar."""
    if isinstance(data, torch.Tensor):
        return dtypes.to_numpy(data.dtype)
    return np.dtype(data.dtype)


def _astype(data, dt):
    """``data`` converted to the numpy dtype ``dt``."""
    if isinstance(data, torch.Tensor):
        return dtypes.cast(data, dt)
    return data.astype(dt)


# --------------------------------------------------------------------------- #
# tnp: numpy's names and result dtypes over torch tensors
# --------------------------------------------------------------------------- #


_F16 = np.dtype(np.float16)


def _probe(v):
    """A one-element stand-in with ``v``'s numpy typing: arrays and numpy
    scalars are strong (their dtype decides), Python scalars are weak.
    bfloat16, which numpy cannot compute with, is typed by a float16
    stand-in (the same rank; ``_numpy_types`` maps the results back)."""
    if isinstance(v, torch.Tensor):
        dt = dtypes.to_numpy(v.dtype)
        return np.zeros(1, _F16 if dt == BFLOAT16 else dt)
    if isinstance(v, np.ndarray):
        return np.zeros(1, v.dtype)
    if isinstance(v, np.generic):
        return v.dtype.type(0)
    return type(v)(0)


_RESULT_CACHE: Dict[Any, Tuple[np.dtype, np.dtype]] = {}


def _numpy_types(name: str, operands) -> Tuple[np.dtype, np.dtype]:
    """(dtype the operands are cast to, dtype of the result) of numpy's
    ``name`` on operands typed like ``operands``."""
    key = (name,) + tuple(
        ("t", o.dtype) if isinstance(o, torch.Tensor)
        else ("a", o.dtype) if isinstance(o, (np.ndarray, np.generic))
        else ("s", type(o))
        for o in operands
    )
    hit = _RESULT_CACHE.get(key)
    if hit is None:
        probes = [_probe(o) for o in operands]
        with np.errstate(all="ignore"), warnings.catch_warnings():
            warnings.simplefilter("ignore")
            out = np.dtype(getattr(np, name)(*probes).dtype)
        common = np.result_type(*probes)
        if out.kind == "f" and common.kind != "f":
            common = out  # numpy computes integer inputs of float ufuncs in float
        common, out = (_from_standin(dt, operands) for dt in (common, out))
        hit = _RESULT_CACHE[key] = (common, out)
    return hit


def _from_standin(dt: np.dtype, operands) -> np.dtype:
    """A result dtype typed with bfloat16's float16 stand-in, mapped back:
    float16 means bfloat16 where an operand is bfloat16, and float32 where
    float16 and bfloat16 meet (neither holds the other)."""
    if dt != _F16:
        return dt
    kinds = {dtypes.to_numpy(o.dtype) for o in operands if isinstance(o, torch.Tensor)}
    if BFLOAT16 not in kinds:
        return dt
    return np.dtype(np.float32) if _F16 in kinds else BFLOAT16


def _device_of(operands) -> torch.device:
    for o in operands:
        if isinstance(o, torch.Tensor):
            return o.device
    return torch.device("cpu")


def _operand(v, dt: np.dtype, device):
    if isinstance(v, torch.Tensor):
        return v.to(dtypes.to_torch(dt))
    if isinstance(v, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(v, dtype=dt)).to(device)
    if isinstance(v, np.generic):
        v = v.item()
    if dt == BFLOAT16:
        # numpy (ml_dtypes) rounds a weak scalar to bfloat16 first; torch
        # would compute with it unrounded
        return torch.tensor(v, dtype=torch.bfloat16, device=device)
    return v


#: numpy ufunc name -> torch function
_TORCH_FN = {
    "add": torch.add, "subtract": torch.sub, "multiply": torch.mul,
    "true_divide": torch.true_divide,
    "floor_divide": lambda a, b: torch.div(a, b, rounding_mode="floor"),
    "power": torch.pow, "mod": torch.remainder, "fmod": torch.fmod,
    "maximum": torch.maximum, "minimum": torch.minimum,
    "greater": torch.gt, "greater_equal": torch.ge, "less": torch.lt,
    "less_equal": torch.le, "equal": torch.eq, "not_equal": torch.ne,
    "logical_and": torch.logical_and, "logical_or": torch.logical_or,
    "logical_xor": torch.logical_xor, "logical_not": torch.logical_not,
    "abs": torch.abs, "sqrt": torch.sqrt, "exp": torch.exp, "log": torch.log,
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan, "arcsin": torch.asin,
    "arccos": torch.acos, "arctan": torch.atan, "sinh": torch.sinh,
    "cosh": torch.cosh, "tanh": torch.tanh, "arcsinh": torch.asinh,
    "arccosh": torch.acosh, "arctanh": torch.atanh, "log10": torch.log10,
    "log2": torch.log2, "floor": torch.floor, "ceil": torch.ceil,
    "trunc": torch.trunc, "isfinite": torch.isfinite, "isinf": torch.isinf,
    "isnan": torch.isnan, "cbrt": _cbrt,
}


#: torch functions that take no Python scalar operand: a scalar joins them
#: as a 0-d tensor of the operation's dtype (numpy rounds a weak scalar to
#: that dtype too)
_TENSOR_OPERANDS = {"maximum", "minimum", "logical_and", "logical_or", "logical_xor"}


def _ufunc(name: str):
    fn = _TORCH_FN[name]

    def apply(*operands):
        if not any(isinstance(o, torch.Tensor) for o in operands):
            return getattr(np, name)(*operands)
        common, out = _numpy_types(name, operands)
        device = _device_of(operands)
        args = [_operand(o, common, device) for o in operands]
        if name in _TENSOR_OPERANDS:
            args = [a if isinstance(a, torch.Tensor) else
                    torch.tensor(a, dtype=dtypes.to_torch(common), device=device) for a in args]
        res = fn(*args)
        if not isinstance(res, torch.Tensor):  # pragma: no cover
            res = torch.as_tensor(res, device=device)
        return res.to(dtypes.to_torch(out))

    apply.__name__ = name
    return apply


class _TorchNumpy:
    """numpy's array functions that the field machinery uses, on tensors,
    with numpy's result dtypes."""

    def __getattr__(self, name):
        if name in _TORCH_FN:
            fn = _ufunc(name)
            setattr(self, name, fn)
            return fn
        raise AttributeError(name)

    @staticmethod
    def where(cond, a, b):
        device = _device_of((cond, a, b))
        dt = _from_standin(np.result_type(_probe(a), _probe(b)), (a, b))
        c = _operand(cond, np.dtype(bool), device)
        if not isinstance(c, torch.Tensor):
            c = torch.tensor(bool(c), device=device)
        tdt = dtypes.to_torch(dt)
        av = _operand(a, dt, device)
        bv = _operand(b, dt, device)
        av = av if isinstance(av, torch.Tensor) else torch.tensor(av, dtype=tdt, device=device)
        bv = bv if isinstance(bv, torch.Tensor) else torch.tensor(bv, dtype=tdt, device=device)
        return torch.where(c.to(torch.bool), av, bv)

    @staticmethod
    def transpose(data, perm):
        return data.permute(*perm)

    @staticmethod
    def broadcast_to(data, shape):
        return data.expand(*shape)

    @staticmethod
    def concatenate(datas, axis=0):
        return torch.cat(list(datas), dim=axis)

    @staticmethod
    def moveaxis(data, src, dst):
        return torch.movedim(data, src, dst)

    @staticmethod
    def sum(data, axis):
        return torch.sum(data, dim=axis)

    @staticmethod
    def max(data, axis):
        return torch.amax(data, dim=axis)

    @staticmethod
    def min(data, axis):
        return torch.amin(data, dim=axis)

    @staticmethod
    def gamma(data):
        x = data if data.dtype.is_floating_point else data.to(torch.float64)
        return _gamma(x)


#: the torch namespace (see ``_TorchNumpy``)
tnp = _TorchNumpy()


class DimensionKind(enum.Enum):
    HORIZONTAL = "horizontal"
    VERTICAL = "vertical"
    LOCAL = "local"


#: promote_dims sorts by kind first (reference: common.order_dimensions)
_KIND_ORDER = {
    DimensionKind.HORIZONTAL: 0,
    DimensionKind.LOCAL: 1,
    DimensionKind.VERTICAL: 2,
}


@dataclasses.dataclass(frozen=True, eq=False)
class Dimension:
    value: str
    kind: DimensionKind = DimensionKind.HORIZONTAL

    def __str__(self):
        return self.value

    def __hash__(self):
        return hash((self.value, self.kind))

    # -- comparisons with integers build 1D Domains (reference:
    # common.py:95-118; used as the concat_where condition, e.g. ``K < 5``)

    def __eq__(self, other):
        if isinstance(other, Dimension):
            return self.value == other.value and self.kind == other.kind
        if isinstance(other, (int, np.integer)):
            return Domain((self,), (UnitRange(int(other), int(other) + 1),))
        return NotImplemented

    def __ne__(self, other):
        if isinstance(other, Dimension):
            return not self.__eq__(other)
        raise TypeError(
            "'dim != value' produces two disjoint domains; use "
            "concat_where(dim < value, ...) / concat_where(dim > value, ...)"
        )

    def __lt__(self, value: int) -> "Domain":
        return Domain((self,), (UnitRange(-INFINITY, int(value)),))

    def __le__(self, value: int) -> "Domain":
        return Domain((self,), (UnitRange(-INFINITY, int(value) + 1),))

    def __gt__(self, value: int) -> "Domain":
        return Domain((self,), (UnitRange(int(value) + 1, INFINITY),))

    def __ge__(self, value: int) -> "Domain":
        return Domain((self,), (UnitRange(int(value), INFINITY),))


def promote_dims(*dims_list: Sequence[Dimension]) -> Tuple[Dimension, ...]:
    """Canonical ordering of the union of dimensions: by kind
    (HORIZONTAL < LOCAL < VERTICAL), then lexicographically by name
    (reference: common.promote_dims :1349-1384)."""
    seen: Dict[Dimension, None] = {}
    for dims in dims_list:
        for d in dims:
            seen.setdefault(d, None)
    out = sorted(seen, key=lambda d: (_KIND_ORDER[d.kind], d.value))
    n_local = sum(1 for d in out if d.kind == DimensionKind.LOCAL)
    if n_local > 1:
        raise ValueError(
            "There are more than one dimension with DimensionKind 'LOCAL'."
        )
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class UnitRange:
    """Half-open integer range [start, stop); +-INFINITY marks unbounded."""

    start: int
    stop: int

    @classmethod
    def infinite(cls) -> "UnitRange":
        return cls(-INFINITY, INFINITY)

    @property
    def is_finite(self) -> bool:
        return self.start > -INFINITY and self.stop < INFINITY

    def is_empty(self) -> bool:
        return self.stop <= self.start

    def __len__(self):
        return max(self.stop - self.start, 0)

    def intersect(self, other: "UnitRange") -> "UnitRange":
        return UnitRange(max(self.start, other.start), min(self.stop, other.stop))

    def shift(self, offset: int) -> "UnitRange":
        lo = self.start if self.start <= -INFINITY else self.start + offset
        hi = self.stop if self.stop >= INFINITY else self.stop + offset
        return UnitRange(lo, hi)

    def __contains__(self, v: int) -> bool:
        return self.start <= v < self.stop

    def __str__(self):
        lo = "-inf" if self.start <= -INFINITY else str(self.start)
        hi = "inf" if self.stop >= INFINITY else str(self.stop)
        return f"[{lo}:{hi})"


@dataclasses.dataclass(frozen=True)
class Domain:
    """An ordered product of named ranges."""

    dims: Tuple[Dimension, ...]
    ranges: Tuple[UnitRange, ...]

    @classmethod
    def from_sizes(cls, **sizes: int) -> "Domain":
        dims = tuple(Dimension(k) for k in sizes)
        return cls(dims, tuple(UnitRange(0, v) for v in sizes.values()))

    def __getitem__(self, dim: Dimension) -> UnitRange:
        return self.ranges[self.dims.index(dim)]

    @property
    def ndim(self) -> int:
        return len(self.dims)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(len(r) for r in self.ranges)

    def is_empty(self) -> bool:
        return any(r.is_empty() for r in self.ranges)

    def dim_index(self, dim: Dimension) -> int:
        return self.dims.index(dim)

    def replace(self, dim: Dimension, rng: UnitRange) -> "Domain":
        i = self.dims.index(dim)
        return Domain(self.dims, self.ranges[:i] + (rng,) + self.ranges[i + 1 :])

    def intersect(self, other: "Domain") -> "Domain":
        """Intersection over shared dims; dims of ``self`` not in ``other``
        keep their range (and vice versa, appended in other's order)."""
        dims = list(self.dims) + [d for d in other.dims if d not in self.dims]
        ranges = []
        for d in dims:
            if d in self.dims and d in other.dims:
                ranges.append(self[d].intersect(other[d]))
            elif d in self.dims:
                ranges.append(self[d])
            else:
                ranges.append(other[d])
        return Domain(tuple(dims), tuple(ranges))

    def __iter__(self):
        return iter(zip(self.dims, self.ranges))

    def __contains__(self, dim: Dimension) -> bool:
        return dim in self.dims

    def __str__(self):
        return "Domain(" + ", ".join(
            f"{d.value}{r}" for d, r in zip(self.dims, self.ranges)
        ) + ")"


def _slice_range(input_range: UnitRange, s: slice) -> UnitRange:
    """Relative slice of a range: start/stop count from the range start
    when >= 0, from the stop when negative; out-of-range raises (no
    clipping, per the array API standard) — reference:
    embedded/common.py:163-178 _slice_range."""
    if s == slice(None):
        return input_range
    start = (
        input_range.start if s.start is None or s.start >= 0 else input_range.stop
    ) + (s.start or 0)
    stop = (
        input_range.start if s.stop is None or s.stop >= 0 else input_range.stop
    ) + (s.stop if s.stop is not None else len(input_range))
    if start < input_range.start or stop > input_range.stop:
        raise IndexError(
            f"slice {s} out of range {input_range} (no clipping)"
        )
    # canonical empty range: never store stop < start in a Domain
    return UnitRange(start, max(start, stop))


def _buffer_slice(own: UnitRange, r: UnitRange) -> slice:
    """Buffer index of sub-range ``r`` inside the axis spanning ``own``."""
    lo = r.start - own.start
    return slice(lo, lo + len(r))


def unit_range(r) -> UnitRange:
    """Coerce an int / (start, stop) / range / UnitRange into a UnitRange
    (reference: common.unit_range :335)."""
    if isinstance(r, UnitRange):
        return r
    if isinstance(r, (int, np.integer)):
        return UnitRange(0, int(r))
    if isinstance(r, range):
        if r.step != 1:
            raise ValueError(f"unit_range requires step 1, got {r.step}")
        return UnitRange(r.start, r.stop)
    a, b = r
    return UnitRange(int(a), int(b))


class GridType(enum.Enum):
    """(reference: common.GridType :1330)"""

    CARTESIAN = "cartesian"
    UNSTRUCTURED = "unstructured"


def is_scalar_type(value) -> bool:
    """True for python/numpy scalar values and scalar *types*
    (reference: _core.definitions.is_scalar_type)."""
    if isinstance(value, type):
        return issubclass(value, (int, float, bool, np.generic))
    return isinstance(value, (int, float, bool, complex, np.generic))


def domain_like(value) -> Domain:
    """Coerce a Domain / dict / (dim, size) sequence into a Domain."""
    if isinstance(value, Domain):
        return value
    if isinstance(value, dict):
        dims = tuple(value.keys())
        ranges = tuple(
            r
            if isinstance(r, UnitRange)
            else UnitRange(int(r[0]), int(r[1]))
            if isinstance(r, tuple)
            else UnitRange(0, int(r))
            for r in value.values()
        )
        return Domain(dims, ranges)
    dims, sizes = zip(*value)
    return Domain(
        tuple(dims),
        tuple(s if isinstance(s, UnitRange) else UnitRange(0, int(s)) for s in sizes),
    )


@dataclasses.dataclass(frozen=True)
class FieldOffset:
    """A named shift along a dimension: ``f(Ioff[1])`` evaluates f at i+1.

    For unstructured meshes the offset names a Connectivity in the
    offset-provider mapping instead (reference: common.py offset-provider
    utilities :1181-1216).
    """

    value: str
    source: Dimension
    target: Tuple[Dimension, ...]

    def __getitem__(self, offset: int) -> "OffsetIndex":
        return OffsetIndex(self, offset)


@dataclasses.dataclass(frozen=True)
class OffsetIndex:
    offset: FieldOffset
    index: int


def CartesianConnectivity(domain_dim: Dimension, offset: int = 0, *,
                          codomain: Optional[Dimension] = None) -> OffsetIndex:
    """A fixed shift along a dimension, usable wherever a connectivity is
    (``f(CartesianConnectivity(I, 1))``, ``premap``); reference:
    common.CartesianConnectivity :1242."""
    if codomain is not None and codomain.value != domain_dim.value:
        raise NotImplementedError(
            "CartesianConnectivity with a relabeling codomain is not "
            "supported; use a 1D Connectivity table instead"
        )
    return OffsetIndex(
        FieldOffset(domain_dim.value, source=domain_dim, target=(domain_dim,)),
        int(offset),
    )


def domain(value) -> Domain:
    """Coerce a Domain / dict / (dim, size) sequence (reference:
    common.domain :671)."""
    return domain_like(value)


@dataclasses.dataclass
class Connectivity:
    """Neighbor table: maps ``source`` elements to ``codomain`` element ids.

    ``table`` has shape (n_source, max_neighbors); ``skip_value`` marks
    missing neighbors (reference: common.py:964-1122).  1D tables
    (shape (n_source,)) represent plain index mappings as produced by
    ``as_offset`` (reference: embedded/nd_array_field.py:944-961).

    Treat tables as immutable once used in a call (the JAX package's
    gather plans freeze them); replace ``table`` with a new array to
    change connectivity.
    """

    table: Any  # (n_source[, max_neighbors]) int array
    source: Dimension
    codomain: Dimension
    local_dim: Optional[Dimension] = None
    skip_value: Optional[int] = -1

    @property
    def max_neighbors(self) -> int:
        return self.table.shape[1]

    @property
    def has_local_dim(self) -> bool:
        return self.table.ndim == 2 and self.local_dim is not None


#: call-time offset provider (reference: embedded/context.py + the
#: ``offset_provider=`` argument threaded through every runner): maps an
#: offset NAME to the Connectivity (neighbor table) or Dimension
#: (cartesian shift axis) it stands for during the current operator call
_OFFSET_PROVIDER: contextvars.ContextVar = contextvars.ContextVar(
    "offset_provider", default=None
)


@contextlib.contextmanager
def offset_provider_context(provider):
    """Install ``provider`` (name -> Connectivity | Dimension) for the
    duration of an operator/program call; :class:`FieldOffset`
    applications resolve through it (reference:
    fbuiltins.FieldOffset.__getitem__ :481-496)."""
    if not provider:
        yield
        return
    token = _OFFSET_PROVIDER.set(dict(provider))
    try:
        yield
    finally:
        _OFFSET_PROVIDER.reset(token)


def current_offset_provider() -> Optional[Dict[str, Any]]:
    return _OFFSET_PROVIDER.get()


def provider_fingerprint(provider) -> Optional[tuple]:
    """Hashable identity of an offset provider: a program keeps one
    ahead-of-time pool per provider (``Program.compile``)."""
    if not provider:
        return None
    items = []
    for k in sorted(provider):
        v = provider[k]
        if isinstance(v, Connectivity):
            items.append((
                k, "conn", v.source.value, v.codomain.value,
                getattr(v.local_dim, "value", None), v.skip_value,
                tuple(v.table.shape), str(_np_dtype(v.table)),
                id(v.table),
            ))
        elif isinstance(v, Dimension):
            items.append((k, "dim", v.value, v.kind.value))
        else:
            items.append((k, type(v).__name__, id(v)))
    return tuple(items)


def _provider_lookup(name: str):
    prov = _OFFSET_PROVIDER.get()
    return None if prov is None else prov.get(name)


def _check_offset_connectivity(off: "FieldOffset", conn: Connectivity) -> None:
    """The provider entry must agree with the offset's declared dims:
    the field carries ``off.source`` (= the table's codomain) and the
    result carries ``off.target`` (= table source [, local dim])."""
    expected = (conn.source,) + (
        (conn.local_dim,) if conn.has_local_dim else ()
    )
    ok = (
        off.source.value == conn.codomain.value
        and len(off.target) == len(expected)
        and all(a.value == b.value for a, b in zip(off.target, expected))
    )
    if not ok:
        decl = ", ".join(d.value for d in off.target)
        got = ", ".join(d.value for d in expected)
        raise TypeError(
            f"offset_provider['{off.value}'] maps {conn.codomain.value} -> "
            f"({got}) but the offset declares source={off.source.value}, "
            f"target=({decl})"
        )


def _column_conn(prov: Connectivity, k: int) -> Connectivity:
    """Cached k-th-neighbor column view of a 2D connectivity.  Column
    gathers are hot (every ``f(V2E[k])``) and a persistent instance lets
    the gather plans cached on it survive calls.  Keyed on the parent
    table's identity token, so a replaced table drops the stale column
    views (tables are otherwise immutable once used; see
    ``affine_remap.plan_for``)."""
    from . import affine_remap

    columns = prov.__dict__.setdefault("_column_conns", {})
    token = affine_remap.table_token(prov.table)
    key = (token, k)
    column = columns.get(key)
    if column is None:
        for stale in [kk for kk in columns if kk[0] != token]:
            del columns[stale]
        column = Connectivity(
            prov.table[:, k],
            source=prov.source,
            codomain=prov.codomain,
            local_dim=None,
            skip_value=prov.skip_value,
        )
        columns[key] = column
    return column


def _peek_conn(off) -> Optional[Connectivity]:
    """Resolve an offset application to its concrete Connectivity without
    side effects, for multi-hop chain folding; None when the offset is a
    cartesian shift, unresolvable or malformed (the sequential path then
    raises the proper error)."""
    if isinstance(off, Connectivity):
        return off
    if isinstance(off, FieldOffset):
        prov = _provider_lookup(off.value)
        if isinstance(prov, Connectivity):
            try:
                _check_offset_connectivity(off, prov)
            except TypeError:
                return None
            return prov
        return None
    if isinstance(off, OffsetIndex) and isinstance(off.offset, FieldOffset):
        prov = _provider_lookup(off.offset.value)
        if isinstance(prov, Connectivity) and getattr(prov.table, "ndim", 0) == 2:
            try:
                _check_offset_connectivity(off.offset, prov)
            except TypeError:
                return None
            nb = prov.table.shape[1]
            if -nb <= off.index < nb:
                return _column_conn(prov, off.index % nb)
    return None


#: composites kept per second hop (``_maybe_compose``); the oldest entry
#: goes first.  The JAX package's cache evicts only stale second-hop
#: entries and can grow without bound.
_COMPOSE_CACHE_MAX = 8


def _maybe_compose(c1: Connectivity, c2: Connectivity):
    """The composite connectivity for the hop pair ``remap(c1)`` then
    ``remap(c2)``, or None when ineligible or unprofitable.

    Exactness: the intermediate field of the two-hop base path always
    lives on range ``[0, len(t1))`` with clip-to-range gather semantics,
    so ``comp[x, ...] = t1[clip(t2[x], 0, len(t1)-1), ...]`` gathered once
    reproduces the chain bit for bit -- skip entries included (both paths
    read the same clipped positions).  Reference behavior: sequential
    premap composition, src/gt4py/next/embedded/nd_array_field.py:240-376.

    Cost policy (the JAX package's): the composite is used when it fits an
    affine plan, or when at least one original hop did not (one irregular
    gather beats two gathers of which one is irregular); two affine hops
    whose composite loses the structure stay sequential.  The composites
    are cached on ``c2``, at most ``_COMPOSE_CACHE_MAX`` of them."""
    t1, t2 = c1.table, c2.table
    if not (isinstance(t1, np.ndarray) and isinstance(t2, np.ndarray)):
        return None
    if t2.ndim != 1 or c2.codomain.value != c1.source.value:
        return None
    from . import affine_remap

    key = (affine_remap.table_token(t1), affine_remap.table_token(t2))
    cache = c2.__dict__.setdefault("_compose_cache", {})
    if key in cache:
        return cache[key]
    for stale in [kk for kk in cache if kk[1] != key[1]]:
        del cache[stale]
    while len(cache) >= _COMPOSE_CACHE_MAX:
        del cache[next(iter(cache))]
    safe2 = np.clip(t2, 0, t1.shape[0] - 1)
    comp = Connectivity(
        np.ascontiguousarray(t1[safe2]),
        source=c2.source,
        codomain=c1.codomain,
        local_dim=c1.local_dim if t1.ndim == 2 else None,
        skip_value=c1.skip_value,
    )
    profitable = affine_remap.plan_for(comp) is not None or (
        affine_remap.plan_for(c1) is None or affine_remap.plan_for(c2) is None
    )
    result = comp if profitable else None
    cache[key] = result
    return result


def _fold_offset_chain(offs):
    """Fold adjacent concrete connectivity hops of a multi-offset
    application into composite Connectivities (see ``_maybe_compose``);
    items that do not fold pass through for sequential application."""
    out = []
    cur = None  # (resolved Connectivity | None, item to apply)
    for o in offs:
        c = _peek_conn(o)
        if cur is None:
            cur = (c, o)
            continue
        pc, po = cur
        comp = _maybe_compose(pc, c) if pc is not None and c is not None else None
        if comp is not None:
            cur = (comp, comp)
        else:
            out.append(po)
            cur = (c, o)
    if cur is not None:
        out.append(cur[1])
    return out


#: types accepted anywhere a "field or scalar" is expected
Scalar = (int, float, bool, np.generic)


class Field:
    """A dimensioned array with a domain; operations intersect domains.

    ``data`` is a torch tensor (the product path) or a numpy array (the
    embedded oracle); both flow through identical code.
    """

    def __init__(self, domain: Domain, data):
        self.domain = domain
        self.data = data

    # ---- annotation syntax: Field[Dims[I, J], float64] ---- #

    def __class_getitem__(cls, item):
        from . import type_system as ts

        return ts.field_annotation(item)

    # ---- construction helpers ---- #

    @property
    def dims(self) -> Tuple[Dimension, ...]:
        return self.domain.dims

    @property
    def dtype(self):
        return _np_dtype(self.data)

    @property
    def shape(self):
        return tuple(self.data.shape)

    @property
    def ndarray(self):
        return self.data

    @property
    def xp(self):
        return _xp(self.data)

    def asnumpy(self) -> np.ndarray:
        """The values as a numpy array; bfloat16, which numpy lacks,
        widens (exactly) to float32."""
        if isinstance(self.data, torch.Tensor):
            t = self.data.detach().cpu()
            return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        return np.asarray(self.data)

    # NOTE: deliberately NO __array__ (matching the reference Field):
    # a Field with __array__ gets silently consumed by numpy-scalar
    # binary ops (np_scalar + field coerces instead of deferring to
    # Field.__radd__), losing the domain.  Use .asnumpy()/.ndarray.

    def as_scalar(self):
        """The single value of a 0-dimensional field (reference:
        nd_array_field.py:232-237)."""
        if self.domain.ndim != 0:
            raise ValueError(
                "'as_scalar' is only valid on 0-dimensional 'Field's, got a "
                f"{self.domain.ndim}-dimensional 'Field'."
            )
        return dtypes.make_scalar(self.asnumpy()[()], self.dtype)

    def __repr__(self):
        dims = ", ".join(f"{d.value}{r}" for d, r in self.domain)
        return f"Field<{dims}, {self.dtype}>"

    # ---- domain restriction ---- #

    def restrict(self, domain: Domain) -> "Field":
        """Slice out ``domain`` (must be contained in own domain; dims of
        ``domain`` not in the field are ignored)."""
        idx = []
        ranges = []
        for ax, d in enumerate(self.dims):
            own = self.domain[d]
            if d in domain:
                r = own.intersect(domain[d])
                if self.data.shape[ax] == 1 and len(own) > 1:
                    # unbounded broadcast axis: keep size-1 data, narrow range
                    idx.append(slice(None))
                else:
                    lo = r.start - own.start
                    idx.append(slice(lo, lo + len(r)))
                ranges.append(r)
            else:
                idx.append(slice(None))
                ranges.append(own)
        return Field(Domain(self.dims, tuple(ranges)), self.data[tuple(idx)])

    # ---- reference-style index specs (relative / absolute) ---- #
    # (reference: embedded/common.py:33-116 _relative_sub_domain /
    #  _absolute_sub_domain, nd_array_field.py:465-478 _slice)

    def _slice_spec(self, index, *, for_write: bool = False) -> Tuple[Domain, tuple]:
        """Normalize an index spec into ``(new_domain, buffer_index)``.

        Accepted forms (mirroring the reference's AnyIndexSpec):
        - ``Domain`` — absolute restriction by named ranges;
        - ``(dim, i)`` pairs (or a sequence of them) with ``i`` an int
          (drops the dimension), a ``UnitRange``/``range``/``(lo, hi)``
          (absolute restriction);
        - relative ints / slices / ``...`` in dimension order: slices are
          relative to the domain start (negative values to the stop), no
          clipping; an int selects one point and drops the dimension.

        ``for_write`` rejects specs that restrict a broadcast axis (size-1
        buffer spanning a wider range): the single stored element cannot
        represent a sub-range write.
        """
        if isinstance(index, Domain):
            index = tuple(zip(index.dims, index.ranges))
        if isinstance(index, tuple) and len(index) == 2 and isinstance(index[0], Dimension):
            index = (index,)
        if isinstance(index, Sequence) and not isinstance(index, str) and index and all(
            isinstance(e, tuple) and len(e) == 2 and isinstance(e[0], Dimension)
            for e in index
        ):
            dom, idx = self._absolute_slice(tuple(index))
        else:
            if not isinstance(index, tuple):
                index = (index,)
            dom, idx = self._relative_slice(index)
        if for_write:
            self._check_writable(dom)
        return dom, idx

    def _check_writable(self, dom: Domain) -> None:
        for ax, d in enumerate(self.dims):
            if self.data.shape[ax] != 1 or len(self.domain[d]) <= 1:
                continue
            # broadcast axis: the write must cover the whole range (or
            # the dim was untouched) — a sub-range write would silently
            # hit every logical point
            r = dom[d] if d in dom else None
            if r is None or r != self.domain[d]:
                raise ValueError(
                    f"cannot write a sub-range of broadcast dimension "
                    f"{d.value} (size-1 buffer spans {self.domain[d]}); "
                    "materialize the field first (e.g. broadcast + copy)"
                )

    def _absolute_slice(self, pairs) -> Tuple[Domain, tuple]:
        by_dim = {}
        for d, v in pairs:
            if d not in self.dims:
                raise IndexError(
                    f"field with dims ({', '.join(x.value for x in self.dims)}) "
                    f"has no dimension {d.value}"
                )
            by_dim[d] = v
        idx, dims, ranges = [], [], []
        for ax, d in enumerate(self.dims):
            own = self.domain[d]
            broadcast_ax = self.data.shape[ax] == 1 and len(own) > 1
            if d not in by_dim:
                idx.append(slice(None))
                dims.append(d)
                ranges.append(own)
                continue
            v = by_dim[d]
            if isinstance(v, (int, np.integer)):
                if int(v) not in own:
                    raise IndexError(
                        f"index {d.value}={int(v)} out of range {own} (no clipping)"
                    )
                idx.append(0 if broadcast_ax else int(v) - own.start)
            else:
                r = unit_range(v)
                # an unbounded request bound means "to the field's edge"
                # (e.g. f[K < 5] from a Dimension comparison)
                if r.start <= -INFINITY:
                    r = UnitRange(own.start, r.stop)
                if r.stop >= INFINITY:
                    r = UnitRange(r.start, own.stop)
                if r.start < own.start or r.stop > own.stop:
                    raise IndexError(
                        f"range {d.value}{r} not contained in {own} (no clipping)"
                    )
                idx.append(slice(None) if broadcast_ax else _buffer_slice(own, r))
                dims.append(d)
                ranges.append(r)
        return Domain(tuple(dims), tuple(ranges)), tuple(idx)

    def _relative_slice(self, index) -> Tuple[Domain, tuple]:
        if Ellipsis in index:
            pos = index.index(Ellipsis)
            fill = (slice(None),) * (len(self.dims) - (len(index) - 1))
            index = index[:pos] + fill + index[pos + 1 :]
        if len(index) > len(self.dims):
            raise IndexError(
                f"cannot index {len(self.dims)}-dimensional field with "
                f"{len(index)} indices"
            )
        index = index + (slice(None),) * (len(self.dims) - len(index))
        idx, dims, ranges = [], [], []
        for ax, (d, e) in enumerate(zip(self.dims, index)):
            own = self.domain[d]
            broadcast_ax = self.data.shape[ax] == 1 and len(own) > 1
            if isinstance(e, slice):
                if e.step not in (None, 1):
                    raise IndexError("field slicing requires step 1")
                r = _slice_range(own, e)
                idx.append(slice(None) if broadcast_ax else _buffer_slice(own, r))
                dims.append(d)
                ranges.append(r)
            elif isinstance(e, (int, np.integer)):
                if not own.is_finite:
                    raise IndexError(f"cannot index unbounded range {d.value}{own}")
                p = (own.start if e >= 0 else own.stop) + int(e)
                if p not in own:
                    raise IndexError(
                        f"index {int(e)} out of range for {d.value}{own} "
                        "(no clipping)"
                    )
                idx.append(0 if broadcast_ax else p - own.start)
            else:
                raise TypeError(
                    f"unsupported field index {e!r}; use ints, slices, a "
                    "Domain, or (dim, index) pairs"
                )
        return Domain(tuple(dims), tuple(ranges)), tuple(idx)

    def __getitem__(self, index) -> "Field":
        """Restrict to a sub-domain (reference: nd_array_field.restrict
        :378-384).  Accepts a Domain, (dim, index) pairs, or relative
        ints/slices/``...`` — all strict (no clipping), and symmetric
        with ``__setitem__``; ``.restrict(domain)`` keeps the clipping
        (intersecting) semantics for internal composition.  Results share
        the buffer (numpy and torch views), so writing into a restricted
        out= target reaches the caller."""
        dom, idx = self._slice_spec(index)
        return Field(dom, self.data[idx])

    def __setitem__(self, index, value) -> None:
        """Write a sub-domain in place (reference: nd_array_field.py
        :386-401)."""
        dom, idx = self._slice_spec(index, for_write=True)
        if isinstance(value, Field):
            if not (value.dims == dom.dims and value.domain.ranges == dom.ranges):
                raise ValueError(
                    f"incompatible Domain in assignment: source {value.domain}, "
                    f"target {dom}"
                )
            value = value.data
        if isinstance(self.data, torch.Tensor) and isinstance(value, np.ndarray):
            value = torch.from_numpy(value)
        self.data[idx] = value

    # ---- remap / premap (gather through connectivities) ---- #

    def remap(self, conn: Connectivity) -> "Field":
        """Gather through a neighbor table: result dims replace the
        codomain dim with (source[, local]).  Indices are clipped to the
        field's range (skip entries read an edge value, as in the JAX
        package)."""
        try:
            ax = self.dims.index(conn.codomain)
        except ValueError:
            raise ValueError(
                f"cannot remap: field dims "
                f"({', '.join(d.value for d in self.dims)}) do not include "
                f"the connectivity codomain {conn.codomain.value}"
            ) from None
        own = self.domain[conn.codomain]
        tshape = tuple(conn.table.shape)
        new_shape = self.data.shape[:ax] + tshape + self.data.shape[ax + 1 :]
        gathered = None
        if isinstance(self.data, torch.Tensor) and isinstance(conn.table, np.ndarray):
            gathered = _planned_gather(self.data, conn, own.start, ax)
        if gathered is None and isinstance(self.data, torch.Tensor):
            safe = _clipped_index(conn, own.start, self.data.shape[ax], self.data.device)
            gathered = torch.index_select(self.data, ax, safe)
        elif gathered is None:
            table = conn.table
            if isinstance(table, torch.Tensor):
                table = table.cpu().numpy()
            safe = np.clip(np.asarray(table) - own.start, 0, self.data.shape[ax] - 1)
            gathered = np.take(self.data, safe.reshape(-1), axis=ax)
        gathered = gathered.reshape(new_shape)
        if len(tshape) == 2:
            new_dims = (conn.source, conn.local_dim)
            new_ranges = (
                UnitRange(0, tshape[0]),
                UnitRange(0, tshape[1]),
            )
        else:  # 1D mapping (as_offset): codomain dim replaced by source dim
            new_dims = (conn.source,)
            new_ranges = (UnitRange(0, tshape[0]),)
        dims = self.dims[:ax] + new_dims + self.dims[ax + 1 :]
        ranges = self.domain.ranges[:ax] + new_ranges + self.domain.ranges[ax + 1 :]
        return Field(Domain(dims, ranges), gathered)

    def premap(self, *conns: Connectivity) -> "Field":
        """Compose the field with index mappings, ``(f∘c)(x) = f(c(x))``
        (reference: embedded/nd_array_field.py:240-…).  Each connectivity's
        codomain must be a dim of the field; gathers are applied one at a
        time (codomains pairwise distinct); adjacent concrete hops fold
        into one composite gather (``_maybe_compose``)."""
        seen = set()
        for c in conns:
            if isinstance(c, OffsetIndex):
                continue
            if c.codomain in seen:
                raise ValueError(f"duplicate codomain {c.codomain} in premap")
            seen.add(c.codomain)
        out = self
        for c in _fold_offset_chain(conns):
            if isinstance(c, OffsetIndex):  # cartesian shift: domain translation
                out = out(c)
                continue
            if c.codomain not in out.dims:
                raise ValueError(
                    f"premap codomain {c.codomain.value} not in field dims "
                    f"{[d.value for d in out.dims]}"
                )
            out = out.remap(c)
        return out

    def __call__(
        self, off: Union[OffsetIndex, Connectivity, FieldOffset], *more
    ) -> "Field":
        if more:
            # reference: NdArrayField.__call__ reduces over premap
            # (nd_array_field.py:367-376).  Adjacent concrete hops fold
            # into one composite gather first (``_maybe_compose``).
            out = self
            for o in _fold_offset_chain((off,) + more):
                out = out.remap(o) if isinstance(o, Connectivity) else out(o)
            return out
        if isinstance(off, Connectivity):
            return self.remap(off)
        if isinstance(off, FieldOffset):
            # reference-style named offsets: the table arrives at call
            # time via offset_provider (fbuiltins.py:481-496)
            prov = _provider_lookup(off.value)
            if isinstance(prov, Connectivity):
                _check_offset_connectivity(off, prov)
                return self.remap(prov)
            if len(off.target) == 2:
                raise TypeError(
                    f"offset '{off.value}' names a neighbor connectivity; "
                    f"pass offset_provider={{'{off.value}': <Connectivity>}} "
                    "at the call"
                )
            raise TypeError(
                f"Offset '{off.value}' needs an index (e.g. {off.value}[1]) "
                "or pass a Connectivity"
            )
        prov = _provider_lookup(off.offset.value)
        if isinstance(prov, Connectivity):
            # V2E[k]: select the k-th neighbor column (reference:
            # offset_definition[NamedIndex(target[-1], k)])
            _check_offset_connectivity(off.offset, prov)
            if prov.table.ndim != 2:
                raise TypeError(
                    f"offset_provider['{off.offset.value}'] is a 1D "
                    "mapping; apply the offset without an index"
                )
            nb = prov.table.shape[1]
            if not (-nb <= off.index < nb):
                raise IndexError(
                    f"neighbor index {off.index} out of range for "
                    f"'{off.offset.value}' with {nb} neighbors"
                )
            return self.remap(_column_conn(prov, off.index % nb))
        dim = prov if isinstance(prov, Dimension) else off.offset.source
        try:
            ax = [d.value for d in self.dims].index(dim.value)
        except ValueError:
            raise TypeError(
                f"field with dims ({', '.join(d.value for d in self.dims)}) "
                f"has no dimension {dim.value} to shift along"
            ) from None
        ranges = list(self.domain.ranges)
        ranges[ax] = ranges[ax].shift(-off.index)
        return Field(Domain(self.dims, tuple(ranges)), self.data)

    # ---- arithmetic with broadcasting + domain intersection ---- #

    def _binary(self, other, opname):
        if not isinstance(other, Field):
            return Field(self.domain, getattr(self.xp, opname)(self.data, other))
        dims = list(self.dims)
        for d in other.dims:
            if d not in dims:
                dims.append(d)
        ranges = []
        for d in dims:
            if d in self.dims and d in other.dims:
                ranges.append(self.domain[d].intersect(other.domain[d]))
            elif d in self.dims:
                ranges.append(self.domain[d])
            else:
                ranges.append(other.domain[d])
        dom = Domain(tuple(dims), tuple(ranges))
        a = _expand(self, dom)
        b = _expand(other, dom)
        xp = tnp if (self.xp is tnp or other.xp is tnp) else np
        return Field(dom, getattr(xp, opname)(a, b))

    def _rbinary(self, other, opname):
        return Field(self.domain, getattr(self.xp, opname)(other, self.data))

    def __add__(self, o): return self._binary(o, "add")
    def __radd__(self, o): return self._rbinary(o, "add")
    def __sub__(self, o): return self._binary(o, "subtract")
    def __rsub__(self, o): return self._rbinary(o, "subtract")
    def __mul__(self, o): return self._binary(o, "multiply")
    def __rmul__(self, o): return self._rbinary(o, "multiply")
    def __truediv__(self, o): return self._binary(o, "true_divide")
    def __rtruediv__(self, o): return self._rbinary(o, "true_divide")
    def __floordiv__(self, o): return self._binary(o, "floor_divide")
    def __rfloordiv__(self, o): return self._rbinary(o, "floor_divide")
    def __pow__(self, o): return self._binary(o, "power")
    def __mod__(self, o): return self._binary(o, "mod")
    def __neg__(self): return Field(self.domain, -self.data)
    def __pos__(self): return self
    def __abs__(self): return Field(self.domain, self.xp.abs(self.data))
    def __gt__(self, o): return self._binary(o, "greater")
    def __ge__(self, o): return self._binary(o, "greater_equal")
    def __lt__(self, o): return self._binary(o, "less")
    def __le__(self, o): return self._binary(o, "less_equal")
    def __eq__(self, o): return self._binary(o, "equal")  # type: ignore[override]
    def __ne__(self, o): return self._binary(o, "not_equal")  # type: ignore[override]
    def __and__(self, o): return self._binary(o, "logical_and")
    def __or__(self, o): return self._binary(o, "logical_or")
    def __xor__(self, o): return self._binary(o, "logical_xor")
    def __invert__(self): return Field(self.domain, self.xp.logical_not(self.data))

    __hash__ = None  # type: ignore[assignment]


def _clipped_index(conn: Connectivity, start: int, n: int, device) -> torch.Tensor:
    """The base path's flat index ``clip(table - start, 0, n - 1)`` as an
    int64 tensor on ``device``; for a numpy table, cached on the
    connectivity (one entry, keyed on the table's token)."""
    if not isinstance(conn.table, np.ndarray):
        table = torch.as_tensor(conn.table, device=device).to(torch.int64)
        return torch.clamp(table - start, 0, n - 1).reshape(-1)
    from . import affine_remap

    key = (affine_remap.table_token(conn.table), start, n, device)
    cached = conn.__dict__.get("_clipped_index")
    if cached is None or cached[0] != key:
        safe = np.clip(conn.table.reshape(-1).astype(np.int64) - start, 0, n - 1)
        cached = (key, torch.from_numpy(safe).to(device))
        conn.__dict__["_clipped_index"] = cached
    return cached[1]


def skip_mask(conn: Connectivity, device) -> torch.Tensor:
    """``table != skip_value`` as a bool tensor on ``device``; for a numpy
    table, cached on the connectivity (one entry, keyed on the table's
    token), so a reduction does not copy the table to the card per call."""
    if not isinstance(conn.table, np.ndarray):
        return torch.as_tensor(conn.table, device=device) != conn.skip_value
    from . import affine_remap

    key = (affine_remap.table_token(conn.table), conn.skip_value, device)
    cached = conn.__dict__.get("_skip_mask")
    if cached is None or cached[0] != key:
        cached = (key, torch.from_numpy(conn.table != conn.skip_value).to(device))
        conn.__dict__["_skip_mask"] = cached
    return cached[1]


def _planned_gather(data: torch.Tensor, conn: Connectivity, start: int, ax: int):
    """The gather of ``remap`` through a planned numpy table, shaped like
    the base path's, or None when no plan applies: an affine window
    (``affine_remap``), else a sort-routed gather (``sort_route``)."""
    from . import affine_remap, sort_route

    plan = affine_remap.plan_for(conn)
    if plan is not None:
        gathered = affine_remap.apply_table_plan(plan, data, start, ax)
        if gathered is not None:
            if conn.table.ndim == 1:  # drop the local axis the plan added
                gathered = gathered.reshape(gathered.shape[: ax + 1] + gathered.shape[ax + 2 :])
            return gathered
    splan = sort_route.plan_for(conn)
    if splan is not None:
        flat = sort_route.apply_gather_plan(splan, data, start, ax)
        if flat is not None:
            return flat.reshape(data.shape[:ax] + tuple(conn.table.shape) + data.shape[ax + 1 :])
    return None


def _expand(f: Field, dom: Domain):
    """Broadcast/restrict a field's data onto ``dom``."""
    data = f.data
    # restrict own dims to the intersected ranges (unbounded broadcast
    # axes -- size-1 data with huge ranges -- pass through untouched)
    idx = []
    for ax, d in enumerate(f.dims):
        r = dom[d]
        own = f.domain[d]
        if data.shape[ax] == 1 and len(own) > 1:
            idx.append(slice(None))
            continue
        lo = r.start - own.start
        idx.append(slice(lo, lo + len(r)))
    data = data[tuple(idx)]
    # insert broadcast axes for missing dims (in dom order)
    shape = []
    src_ax = {d: i for i, d in enumerate(f.dims)}
    perm = [src_ax[d] for d in dom.dims if d in src_ax]
    data = _xp(data).transpose(data, perm) if perm != sorted(perm) else data
    it = iter(range(len(perm)))
    for d in dom.dims:
        if d in src_ax:
            shape.append(data.shape[next(it)])
        else:
            shape.append(1)
    return data.reshape(shape)


