"""Field-view builtins: where/broadcast/astype, neighbor reductions, math,
and the experimental domain-concatenation / index-mapping builtins.

Reference: src/gt4py/next/ffront/fbuiltins.py (broadcast :270, where :281,
astype :291-303, neighbor_sum/max_over/min_over, math functions) and
ffront/experimental.py (as_offset :17, concat_where :22) with the embedded
semantics of nd_array_field.py (_concat_where :905, premap :240,
_as_offset :944).

The counterpart of ``gt4py_tpu.next.builtins``.  All functions are
namespace-generic: numpy-backed fields stay numpy (the embedded oracle),
torch-backed fields stay torch on their device (``common.tnp``).
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from gt4py_tpu_torch.core import dtypes

from .common import (
    INFINITY,
    Connectivity,
    Dimension,
    Domain,
    Field,
    FieldOffset,
    UnitRange,
    _astype,
    skip_mask,
    _expand,
    _xp,
    current_offset_provider,
    tnp,
)


def _merge_domains(*operands) -> Domain:
    """Union of dims (first-seen order), intersection of shared ranges."""
    fields = [f for f in operands if isinstance(f, Field)]
    dims = []
    for f in fields:
        for d in f.dims:
            if d not in dims:
                dims.append(d)
    ranges = []
    for d in dims:
        r = None
        for f in fields:
            if d in f.dims:
                r = f.domain[d] if r is None else r.intersect(f.domain[d])
        ranges.append(r)
    return Domain(tuple(dims), tuple(ranges))


def _common_xp(*operands):
    for f in operands:
        if isinstance(f, Field) and f.xp is tnp:
            return tnp
    return np


def where(cond, a, b) -> Field:
    """Pointwise select.  Any operand (including the condition) may be a
    scalar (reference: fbuiltins.where over scalar/field mixes); tuple
    branches are mapped elementwise (reference WhereBuiltinFunction,
    fbuiltins.py:219-252)."""
    if isinstance(a, tuple) or isinstance(b, tuple):
        if not (isinstance(a, tuple) and isinstance(b, tuple)):
            raise TypeError("where: both or neither branch must be tuples")
        if len(a) != len(b):
            raise TypeError(
                f"where: tuple branches of different lengths ({len(a)} vs {len(b)})"
            )
        return tuple(where(cond, x, y) for x, y in zip(a, b))
    if not any(isinstance(x, Field) for x in (cond, a, b)):
        if any(isinstance(x, torch.Tensor) for x in (cond, a, b)):
            # scan planes and 0-d tensors
            return tnp.where(cond, a, b)
        return np.where(cond, a, b)[()]
    dom = _merge_domains(cond, a, b)
    xp = _common_xp(cond, a, b)
    c = _expand(cond, dom) if isinstance(cond, Field) else cond
    av = _expand(a, dom) if isinstance(a, Field) else a
    bv = _expand(b, dom) if isinstance(b, Field) else b
    return Field(dom, xp.where(c, av, bv))


def broadcast(field: Union[Field, float, int], dims) -> Field:
    """Declare the broadcast dimensions of a field/scalar."""
    dims = tuple(dims)
    if not isinstance(field, Field):
        data = field.reshape((1,) * len(dims)) if isinstance(field, torch.Tensor) \
            else np.asarray(field).reshape((1,) * len(dims))
        return Field(Domain(dims, tuple(UnitRange.infinite() for _ in dims)), data)
    # existing dims keep ranges, new dims get unbounded broadcast ranges
    ranges = tuple(
        field.domain[d] if d in field.dims else UnitRange.infinite() for d in dims
    )
    dom = Domain(dims, ranges)
    shape = tuple(len(field.domain[d]) if d in field.dims else 1 for d in dims)
    src = {d: i for i, d in enumerate(field.dims)}
    perm = [src[d] for d in dims if d in src]
    data = field.xp.transpose(field.data, perm)
    return Field(dom, data.reshape(shape))


def astype(field, dtype):
    if isinstance(field, Field):
        return Field(field.domain, _astype(field.data, np.dtype(dtype)))
    if isinstance(field, tuple):
        return tuple(astype(f, dtype) for f in field)
    if isinstance(field, torch.Tensor):
        return _astype(field, np.dtype(dtype))
    return dtypes.make_scalar(field, dtype)


# --------------------------------------------------------------------- #
# concat_where: region-based selection (reference: experimental.py:22,
# embedded semantics nd_array_field.py:846-941)
# --------------------------------------------------------------------- #


def _invert_1d(domain: Domain):
    """Complement of a 1D domain as up to two (possibly unbounded) domains."""
    (dim,), (rng,) = domain.dims, domain.ranges
    if rng.is_empty():
        return (Domain((dim,), (UnitRange.infinite(),)),)
    out = []
    if rng.start > -INFINITY:
        out.append(Domain((dim,), (UnitRange(-INFINITY, rng.start),)))
    if rng.stop < INFINITY:
        out.append(Domain((dim,), (UnitRange(rng.stop, INFINITY),)))
    return tuple(out)


def concat_where(domain: Domain, true_field, false_field) -> Field:
    """Assemble a field from ``true_field`` where the 1D ``domain``
    applies and ``false_field`` elsewhere, concatenating along the
    domain's dimension (NOT an elementwise mask -- see ``where``).

    Tuples are mapped elementwise (reference WhereBuiltinFunction).
    """
    if isinstance(true_field, tuple) or isinstance(false_field, tuple):
        if not (isinstance(true_field, tuple) and isinstance(false_field, tuple)):
            raise TypeError("concat_where: both or neither branch must be tuples")
        return tuple(
            concat_where(domain, t, f) for t, f in zip(true_field, false_field)
        )
    if domain.ndim != 1:
        raise NotImplementedError(
            "'concat_where': the condition must be a 1D domain (e.g. K < 5)"
        )
    dim = domain.dims[0]
    xp = _common_xp(true_field, false_field)

    # promote scalars to unbounded fields along dim
    def as_f(v):
        if isinstance(v, Field):
            return v
        return broadcast(v, (dim,))

    t, f = as_f(true_field), as_f(false_field)
    if xp is tnp:  # scalar branches join the tensor branch's device
        dev = next(x.data.device for x in (t, f) if isinstance(x.data, torch.Tensor))
        t, f = (x if isinstance(x.data, torch.Tensor)
                else Field(x.domain, torch.as_tensor(x.data, device=dev)) for x in (t, f))
    if dim not in t.dims:
        t = broadcast(t, t.dims + (dim,))
    if dim not in f.dims:
        f = broadcast(f, f.dims + (dim,))

    # intersect orthogonally so every slice shares the off-dim domain
    merged = _merge_domains(t, f)
    ortho_dom = Domain(
        tuple(d for d in merged.dims if d != dim),
        tuple(r for d, r in merged if d != dim),
    )
    t = t.restrict(ortho_dom)
    f = f.restrict(ortho_dom)

    # scalar (unbounded) branches are clipped to the union of the finite
    # extents available along dim, so the result domain stays concrete
    lo = min(
        (r.start for r in (t.domain[dim], f.domain[dim]) if r.start > -INFINITY),
        default=-INFINITY,
    )
    hi = max(
        (r.stop for r in (t.domain[dim], f.domain[dim]) if r.stop < INFINITY),
        default=INFINITY,
    )
    if lo <= -INFINITY or hi >= INFINITY:
        raise ValueError(
            "concat_where: cannot determine the result extent along "
            f"{dim.value} (both branches unbounded)"
        )
    bound = UnitRange(lo, hi)

    pieces = []
    true_rng = t.domain[dim].intersect(domain[dim]).intersect(bound)
    if not true_rng.is_empty():
        pieces.append(t.restrict(Domain((dim,), (true_rng,))))
    for inv in _invert_1d(domain):
        rng = f.domain[dim].intersect(inv[dim]).intersect(bound)
        if not rng.is_empty():
            pieces.append(f.restrict(Domain((dim,), (rng,))))
    if not pieces:
        raise ValueError("concat_where: no data in either region")

    pieces.sort(key=lambda p: p.domain[dim].start)
    for prev, curr in zip(pieces, pieces[1:]):
        left, right = prev.domain[dim].stop, curr.domain[dim].start
        if left > right:
            raise ValueError(
                f"concat_where: overlapping contributions along {dim.value}"
            )
        if left < right:
            raise ValueError(
                f"concat_where: non-contiguous result domain along {dim.value} "
                f"(gap [{left}:{right}))"
            )
    # unify dim orders (canonical: promote_dims) and broadcast each piece
    from .common import promote_dims

    ref_dims = promote_dims(merged.dims, (dim,))
    out_rng = UnitRange(
        pieces[0].domain[dim].start, pieces[-1].domain[dim].stop
    )
    ax = ref_dims.index(dim)
    datas = []
    for p in pieces:
        dom_p = Domain(
            ref_dims,
            tuple(p.domain[d] if d in p.dims else ortho_dom[d] for d in ref_dims),
        )
        datas.append(xp.broadcast_to(_expand(p, dom_p), dom_p.shape))
    out_ranges = tuple(
        out_rng if d == dim else (ortho_dom[d] if d in ortho_dom else pieces[0].domain[d])
        for d in ref_dims
    )
    return Field(
        Domain(ref_dims, out_ranges), xp.concatenate(datas, axis=ax)
    )


# --------------------------------------------------------------------- #
# premap / as_offset
# --------------------------------------------------------------------- #


def premap(field: Field, *conns) -> Field:
    """Compose a field with index mappings (reference:
    nd_array_field.py:240)."""
    return field.premap(*conns)


def as_offset(offset: FieldOffset, field: Field) -> Connectivity:
    """Turn an integer field into a dynamic offset along ``offset``'s
    source dimension: ``f(as_offset(Koff, k_index_field))`` gathers f at
    K = k_index_field[...] + own position (reference: experimental.py:17,
    embedded nd_array_field.py:944-961).

    The returned Connectivity has a 1D table mapping each position of
    ``field``'s (1D) domain to an absolute index along the offset's
    target dimension.
    """
    if len(field.dims) != 1:
        raise NotImplementedError(
            "as_offset currently supports 1D index fields "
            f"(got dims {[d.value for d in field.dims]})"
        )
    if not np.issubdtype(field.dtype, np.integer):
        raise TypeError("as_offset needs an integer-valued field")
    src = field.dims[0]
    rng = field.domain[src]
    if isinstance(field.data, torch.Tensor):
        positions = torch.arange(rng.start, rng.stop, device=field.data.device)
    else:
        positions = np.arange(rng.start, rng.stop)
    table = positions + field.data  # relative offsets -> absolute indices
    return Connectivity(
        table=table,
        source=src,
        codomain=offset.source,
        local_dim=None,
        skip_value=None,
    )


# --------------------------------------------------------------------- #
# neighbor reductions
# --------------------------------------------------------------------- #


def _reduce(field: Field, conn_or_dim, opname, init):
    xp = field.xp
    if isinstance(conn_or_dim, Connectivity):
        dim = conn_or_dim.local_dim
        skip_table = conn_or_dim.table
    else:
        dim = conn_or_dim
        skip_table = None
        # reference semantics: reducing over a LOCAL dim is skip-aware
        # when the call-time offset_provider holds the connectivity that
        # produced it (ITIR reduce knows the neighbor table of the shift)
        prov = current_offset_provider()
        if prov:
            for v in prov.values():
                if (
                    isinstance(v, Connectivity)
                    and v.has_local_dim
                    and v.local_dim == dim
                    and v.skip_value is not None
                    and v.source in field.dims
                ):
                    conn_or_dim = v
                    skip_table = v.table
                    break
    ax = field.dims.index(dim)
    data = field.data
    if skip_table is not None and conn_or_dim.skip_value is not None:
        src_ax = field.dims.index(conn_or_dim.source)
        if xp is tnp:
            mask = skip_mask(conn_or_dim, data.device)
        else:
            mask = np.asarray(skip_table) != conn_or_dim.skip_value
        # restrict the (n_source, max_neighbors) mask to the field's actual
        # (possibly domain-intersected) source/local ranges
        src_r = field.domain[conn_or_dim.source]
        loc_r = field.domain[dim]
        mask = mask[src_r.start : src_r.stop, loc_r.start : loc_r.stop]
        full_mask_shape = [1] * data.ndim
        full_mask_shape[src_ax] = mask.shape[0]
        full_mask_shape[ax] = mask.shape[1]
        mask = mask.reshape(full_mask_shape)
        data = xp.where(mask, data, init)
    reduced = getattr(xp, opname)(data, axis=ax)
    dims = field.dims[:ax] + field.dims[ax + 1 :]
    ranges = field.domain.ranges[:ax] + field.domain.ranges[ax + 1 :]
    return Field(Domain(dims, ranges), reduced)


def neighbor_sum(field: Field, axis) -> Field:
    return _reduce(field, axis, "sum", 0)


def max_over(field: Field, axis) -> Field:
    return _reduce(field, axis, "max", -np.inf)


def min_over(field: Field, axis) -> Field:
    return _reduce(field, axis, "min", np.inf)


def _unary(name):
    def wrapped(x):
        if isinstance(x, Field):
            return Field(x.domain, getattr(x.xp, name)(x.data))
        return getattr(_xp(x) if isinstance(x, torch.Tensor) else np, name)(x)

    wrapped.__name__ = name
    return wrapped


def neg(x):
    """Unary negation builtin (reference: fbuiltins.neg :378)."""
    if isinstance(x, Field):
        return Field(x.domain, -x.data)
    return -x


sqrt = _unary("sqrt")
exp = _unary("exp")
log = _unary("log")
sin = _unary("sin")
cos = _unary("cos")
tan = _unary("tan")
arcsin = _unary("arcsin")
arccos = _unary("arccos")
arctan = _unary("arctan")
sinh = _unary("sinh")
cosh = _unary("cosh")
tanh = _unary("tanh")
arcsinh = _unary("arcsinh")
arccosh = _unary("arccosh")
arctanh = _unary("arctanh")
log10 = _unary("log10")
log2 = _unary("log2")
floor = _unary("floor")
ceil = _unary("ceil")
trunc = _unary("trunc")
abs = _unary("abs")  # noqa: A001  -- reference exports `abs` too
isfinite = _unary("isfinite")
isinf = _unary("isinf")
isnan = _unary("isnan")


def maximum(a, b):
    if isinstance(a, Field):
        return a._binary(b, "maximum")
    if isinstance(b, Field):
        return b._rbinary(a, "maximum")
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return getattr(tnp, "maximum")(a, b)
    return np.maximum(a, b)


def minimum(a, b):
    if isinstance(a, Field):
        return a._binary(b, "minimum")
    if isinstance(b, Field):
        return b._rbinary(a, "minimum")
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return getattr(tnp, "minimum")(a, b)
    return np.minimum(a, b)


def fmod(a, b):
    if isinstance(a, Field):
        return a._binary(b, "fmod")
    if isinstance(b, Field):
        return b._rbinary(a, "fmod")
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return getattr(tnp, "fmod")(a, b)
    return np.fmod(a, b)


def power(a, b):
    if isinstance(a, Field):
        return a._binary(b, "power")
    if isinstance(b, Field):
        return b._rbinary(a, "power")
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return getattr(tnp, "power")(a, b)
    return np.power(a, b)


#: names callable inside the typed frontend (frontend.py) -- everything
#: here evaluates field-wise with domain intersection
cbrt = _unary("cbrt")


def gamma(x):
    """Gamma function (reference fbuiltins math set): exp(lgamma) with the
    reflection formula on tensors; the numpy oracle uses scipy."""
    if isinstance(x, Field):
        return Field(x.domain, _gamma_impl(x.data))
    return _gamma_impl(x)


def _gamma_impl(v):
    if isinstance(v, torch.Tensor):
        return tnp.gamma(v)
    import scipy.special as sps

    return sps.gamma(v)


MATH_BUILTINS = {
    name: globals()[name]
    for name in (
        "sqrt exp log sin cos tan arcsin arccos arctan sinh cosh tanh "
        "arcsinh arccosh arctanh log10 log2 floor ceil trunc abs "
        "isfinite isinf isnan maximum minimum fmod power gamma cbrt neg"
    ).split()
}

FIELD_BUILTINS = {
    **MATH_BUILTINS,
    "where": where,
    "concat_where": concat_where,
    "broadcast": broadcast,
    "astype": astype,
    "premap": premap,
    "as_offset": as_offset,
    "neighbor_sum": neighbor_sum,
    "max_over": max_over,
    "min_over": min_over,
}
