"""Static analyses over the stencil IR.

- C-style dtype promotion + expression dtype inference (reference:
  gtc/passes/gtir_dtype_resolver.py and gtir_upcaster.py -- the numpy-ufunc
  "minimal signature" rule collapses to max-rank promotion with integer
  ranks below float32).
- Temporary dtype resolution (first definitive assignment wins).
- Extent (halo) analysis: a backward sweep accumulating read offsets into
  per-field extents and per-statement compute extents (reference:
  gtc/passes/oir_optimizations/utils.py:250-330 StencilExtentComputer).
- K-boundary computation for API fields (reference:
  gtc/passes/gtir_k_boundary.py:73-78).
- Access-info metadata for the call-time machinery (reference:
  backend/module_generator.py:56-107 make_args_data_from_gtir).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Optional, Tuple

import numpy as np

from gt4py_tpu_torch import config
from gt4py_tpu_torch.core.definitions import (  # noqa: F401  (re-exported)
    Boundary,
    Extent,
    is_float_dtype,
    promote_dtypes,
)
from gt4py_tpu_torch.cartesian import ir

# --------------------------------------------------------------------------- #
# dtype defaults (policy: config + per-stencil overrides; the promotion
# VOCABULARY lives in core.definitions, shared with next/ and testing/)
# --------------------------------------------------------------------------- #


def default_float_dtype(stencil: Optional[ir.Stencil] = None) -> np.dtype:
    if stencil is not None and stencil.literal_float_dtype is not None:
        return stencil.literal_float_dtype
    return np.dtype(f"f{config.LITERAL_FLOAT_PRECISION // 8}")


def default_int_dtype(stencil: Optional[ir.Stencil] = None) -> np.dtype:
    if stencil is not None and stencil.literal_int_dtype is not None:
        return stencil.literal_int_dtype
    return np.dtype(f"i{config.LITERAL_INT_PRECISION // 8}")


_BOOL = np.dtype(np.bool_)
_FLOAT_FUNCS = {
    ir.NativeFunction.SIN, ir.NativeFunction.COS, ir.NativeFunction.TAN,
    ir.NativeFunction.ARCSIN, ir.NativeFunction.ARCCOS, ir.NativeFunction.ARCTAN,
    ir.NativeFunction.ARCTAN2, ir.NativeFunction.SINH, ir.NativeFunction.COSH,
    ir.NativeFunction.TANH, ir.NativeFunction.ARCSINH, ir.NativeFunction.ARCCOSH,
    ir.NativeFunction.ARCTANH, ir.NativeFunction.SQRT, ir.NativeFunction.EXP,
    ir.NativeFunction.LOG, ir.NativeFunction.LOG10, ir.NativeFunction.LOG2,
    ir.NativeFunction.GAMMA,
    ir.NativeFunction.CBRT, ir.NativeFunction.ERF, ir.NativeFunction.ERFC,
    ir.NativeFunction.FLOOR, ir.NativeFunction.CEIL, ir.NativeFunction.TRUNC,
    ir.NativeFunction.ROUND, ir.NativeFunction.ROUND_AWAY_FROM_ZERO,
}
_BOOL_FUNCS = {ir.NativeFunction.ISFINITE, ir.NativeFunction.ISINF, ir.NativeFunction.ISNAN}


class DtypeEnv:
    """Name -> dtype environment for inference."""

    def __init__(self, stencil: ir.Stencil, scalar_dtypes: Optional[Dict[str, np.dtype]] = None):
        self.stencil = stencil
        self.scalar_dtypes = scalar_dtypes or {}

    def dtype_of(self, name: str) -> Optional[np.dtype]:
        d = self.stencil.decl(name)
        if d is not None:
            return d.dtype
        s = self.stencil.scalar_decls.get(name)
        if s is not None:
            return self.scalar_dtypes.get(name, s.dtype)
        return None


def infer_expr_dtype(expr: ir.Expr, env: DtypeEnv) -> np.dtype:
    if isinstance(expr, ir.Literal):
        if expr.dtype is not None:
            return np.dtype(expr.dtype)
        if isinstance(expr.value, bool):
            return _BOOL
        if isinstance(expr.value, int):
            return default_int_dtype(env.stencil)
        return default_float_dtype(env.stencil)
    if isinstance(expr, ir.ScalarAccess):
        dt = env.dtype_of(expr.name)
        if dt is None:
            raise ValueError(f"Cannot infer dtype of scalar '{expr.name}'")
        return dt
    if isinstance(expr, ir.FieldAccess):
        dt = env.dtype_of(expr.name)
        if dt is None:
            raise ValueError(f"Cannot infer dtype of field '{expr.name}'")
        return dt
    if isinstance(expr, ir.AxisPosition) or isinstance(expr, ir.AxisSize):
        return default_int_dtype(env.stencil)
    if isinstance(expr, ir.Cast):
        return np.dtype(expr.dtype)
    if isinstance(expr, ir.UnaryOp):
        if expr.op == ir.UnaryOperator.NOT:
            return _BOOL
        return infer_expr_dtype(expr.expr, env)
    if isinstance(expr, ir.BinaryOp):
        if expr.op.is_comparison or expr.op.is_logical:
            return _BOOL
        ldt = infer_expr_dtype(expr.left, env)
        rdt = infer_expr_dtype(expr.right, env)
        target = promote_dtypes(ldt, rdt)
        if expr.op == ir.BinaryOperator.DIV and target.kind in "bi":
            return default_float_dtype(env.stencil)
        return target
    if isinstance(expr, ir.TernaryOp):
        return promote_dtypes(
            infer_expr_dtype(expr.true_expr, env), infer_expr_dtype(expr.false_expr, env)
        )
    if isinstance(expr, ir.NativeFuncCall):
        if expr.func in _BOOL_FUNCS:
            return _BOOL
        arg_dt = promote_dtypes(*[infer_expr_dtype(a, env) for a in expr.args])
        if expr.func in _FLOAT_FUNCS and arg_dt.kind in "bi":
            return default_float_dtype(env.stencil)
        return arg_dt
    raise TypeError(f"Cannot infer dtype of {type(expr).__name__}")


def try_static_int(expr: ir.Expr) -> Optional[int]:
    """Evaluate an expression to a compile-time integer if possible."""
    if isinstance(expr, ir.Literal) and isinstance(expr.value, (int, np.integer)):
        return int(expr.value)
    if isinstance(expr, ir.UnaryOp):
        v = try_static_int(expr.expr)
        if v is None:
            return None
        return -v if expr.op == ir.UnaryOperator.NEG else v
    if isinstance(expr, ir.BinaryOp):
        lo, hi = try_static_int(expr.left), try_static_int(expr.right)
        if lo is None or hi is None:
            return None
        ops = {
            ir.BinaryOperator.ADD: lambda a, b: a + b,
            ir.BinaryOperator.SUB: lambda a, b: a - b,
            ir.BinaryOperator.MUL: lambda a, b: a * b,
            ir.BinaryOperator.FLOOR_DIV: lambda a, b: a // b,
            ir.BinaryOperator.MOD: lambda a, b: a % b,
        }
        fn = ops.get(expr.op)
        return fn(lo, hi) if fn else None
    if isinstance(expr, ir.Cast):
        return try_static_int(expr.expr)
    return None


def resolve_temp_dtypes(stencil: ir.Stencil) -> None:
    """Fill in temporary field dtypes from their first assignment, in
    program order (reference: gtc/passes/gtir_dtype_resolver.py:97)."""
    env = DtypeEnv(stencil)
    for loop in stencil.vertical_loops:
        for section in loop.sections:
            for node in ir.walk_values(section.body):
                if isinstance(node, ir.Assign):
                    name = node.target.name
                    decl = stencil.temp_decls.get(name)
                    if decl is not None and decl.dtype is None:
                        decl.dtype = infer_expr_dtype(node.value, env)
    missing = [n for n, d in stencil.temp_decls.items() if d.dtype is None]
    if missing:
        raise ValueError(f"Could not infer dtype of temporaries: {missing}")


# --------------------------------------------------------------------------- #
# Extent (halo) analysis
# --------------------------------------------------------------------------- #


def _stmt_reads(stmt: ir.Stmt) -> List[ir.FieldAccess]:
    """All field reads in a statement (excluding assignment targets)."""
    reads: List[ir.FieldAccess] = []

    def visit(node):
        if isinstance(node, ir.Assign):
            collect(node.value)
            for d in node.target.data_index:
                collect(d)
            if isinstance(node.target.offset, (ir.VariableKOffset, ir.AbsoluteKIndex)):
                collect(node.target.offset.k)
        elif isinstance(node, ir.If):
            collect(node.cond)
            for s in node.body + node.orelse:
                visit(s)
        elif isinstance(node, ir.While):
            collect(node.cond)
            for s in node.body:
                visit(s)
        elif isinstance(node, ir.HorizontalRestriction):
            for s in node.body:
                visit(s)

    def collect(expr):
        for n in ir.walk_values(expr):
            if isinstance(n, ir.FieldAccess):
                reads.append(n)

    visit(stmt)
    return reads


def _stmt_writes(stmt: ir.Stmt) -> List[ir.FieldAccess]:
    return [n.target for n in ir.walk_values(stmt) if isinstance(n, ir.Assign)]


@dataclass
class ExtentAnalysis:
    """Result of the backward extent sweep."""

    #: horizontal+K extent of every field's *reads* relative to the domain
    field_extents: Dict[str, Extent]
    #: horizontal compute extent of each top-level statement unit (by id)
    stmt_extents: Dict[int, Extent]
    #: per-field union of the extents of units WRITING it: a statement
    #: grouped with larger-extent siblings (inside an if) writes its
    #: targets over the whole unit extent
    write_extents: Dict[str, Extent]

    def stmt_extent(self, stmt: ir.Stmt) -> Extent:
        return self.stmt_extents.get(id(stmt), Extent.zeros())

    def field_extent(self, name: str) -> Extent:
        return self.field_extents.get(name, Extent.zeros()).union_zero()

    def write_extent(self, name: str) -> Extent:
        return self.write_extents.get(name, Extent.zeros()).union_zero()

    def alloc_extent(self, name: str) -> Extent:
        """Extent a buffer must cover: reads plus extended unit writes."""
        return self.field_extent(name) | self.write_extent(name)

    def boundary(self, name: str) -> Boundary:
        return self.alloc_extent(name).to_boundary()


def compute_extents(stencil: ir.Stencil, min_extents=None) -> ExtentAnalysis:
    """Backward sweep: each statement unit's compute extent is the union of
    the extents required of the fields it writes; its reads then extend the
    read fields' extents by (unit extent + offset).

    Statement units are the top-level statements of each vertical section
    (an If/While/HorizontalRestriction counts as one unit, matching the
    reference's per-HorizontalExecution granularity).  ``min_extents``
    (``id`` of a unit -> Extent): units computed over at least that extent
    (the pieces of a split compound statement keep the statement's).
    """
    field_extents: Dict[str, Extent] = {}
    stmt_extents: Dict[int, Extent] = {}
    write_extents: Dict[str, Extent] = {}

    for loop in reversed(stencil.vertical_loops):
        for section in reversed(loop.sections):
            for stmt in reversed(section.body):
                writes = _stmt_writes(stmt)
                ext = Extent.zeros()
                for w in writes:
                    ext = ext | field_extents.get(w.name, Extent.zeros()).horizontal
                ext = ext.union_zero()
                if min_extents and id(stmt) in min_extents:
                    ext = ext | min_extents[id(stmt)]
                stmt_extents[id(stmt)] = Extent(i=ext.i, j=ext.j)
                for w in writes:
                    write_extents[w.name] = write_extents.get(
                        w.name, Extent.zeros()
                    ) | Extent(i=ext.i, j=ext.j)
                for r in _stmt_reads(stmt):
                    if isinstance(r.offset, ir.CartesianOffset):
                        off = Extent.from_offset(r.offset.i, r.offset.j, r.offset.k)
                    else:
                        off = Extent.zeros()  # variable/absolute K: clipped reads
                    acc = Extent(i=ext.i, j=ext.j) + off
                    field_extents[r.name] = field_extents.get(r.name, Extent.zeros()) | acc
                # writes at non-zero k offsets also grow the field's extent
                for w in writes:
                    if isinstance(w.offset, ir.CartesianOffset) and w.offset.k:
                        off = Extent.from_offset(0, 0, w.offset.k)
                        field_extents[w.name] = (
                            field_extents.get(w.name, Extent.zeros()) | off
                        )

    return ExtentAnalysis(
        field_extents=field_extents,
        stmt_extents=stmt_extents,
        write_extents=write_extents,
    )


def compute_k_boundary(
    stencil: ir.Stencil, names=None, extents=None
) -> Dict[str, Tuple[int, int]]:
    """Per-field K halo requirement: how far reads reach below the
    domain start / above the domain end, accounting for section intervals
    (reference: gtc/passes/gtir_k_boundary.py:73).  Defaults to the API
    fields; pass ``names`` to analyze other fields (e.g. the program
    splicer's cross-statement temporaries, where the interval-blind
    extent hull would overstate demands of K-sectioned reads).

    ``extents`` (a StencilExtents, normally the one analyze() computed):
    statements evaluated over an EXTENDED region -- temporaries consumed
    at offsets -- reach further than their reads' own K offsets say; the
    per-statement evaluation extent composes into the demand.  Without
    it, K windows sized by this function are silently overrun by
    temp-composed reads (found by fuzz seed 4076: a concat_where
    operator whose temporary is consumed at Ioff/Joff offsets built
    mismatched per-field K windows)."""
    k_boundary: Dict[str, Tuple[int, int]] = {
        name: (0, 0)
        for name in (stencil.field_decls if names is None else names)
    }
    for loop in stencil.vertical_loops:
        for section in loop.sections:
            if section.interval.is_runtime:
                continue  # conservative: no static K-halo contribution
            start, end = section.interval.start, section.interval.end
            for stmt in section.body:
                se_lo = se_hi = 0
                if extents is not None:
                    se = extents.stmt_extent(stmt)
                    se_lo, se_hi = se.k
                for r in _stmt_reads(stmt):
                    if r.name not in k_boundary:
                        continue
                    if not isinstance(r.offset, ir.CartesianOffset):
                        continue
                    dk = r.offset.k
                    lower, upper = k_boundary[r.name]
                    if start.level == ir.LevelMarker.START:
                        lower = max(lower, -(start.offset + dk + se_lo))
                    if end.level == ir.LevelMarker.END:
                        upper = max(upper, end.offset + dk + se_hi)
                    k_boundary[r.name] = (lower, upper)
    return k_boundary


def compute_k_boundary_resolved(
    stencil: ir.Stencil, dK: int, names=None, extents=None
) -> Dict[str, Tuple[int, int]]:
    """K halo requirement with the section intervals RESOLVED against a
    concrete domain size.  The static :func:`compute_k_boundary` can
    only account for START-anchored starts / END-anchored ends; a
    section ending at a fixed offset from the START (concat_where cut
    sections) reaches ``end + dk`` ABSOLUTE planes -- whether that
    exceeds the domain depends on dK (fuzz seed 4076: a +2 read in a
    [0, 4) section on a dK=5 domain reaches one plane past the end,
    which the static form cannot express, silently truncating the
    per-field K windows)."""
    k_boundary: Dict[str, Tuple[int, int]] = {
        name: (0, 0)
        for name in (stencil.field_decls if names is None else names)
    }
    for loop in stencil.vertical_loops:
        for section in loop.sections:
            if section.interval.is_runtime:
                continue
            a, b = section.interval.resolve(dK, {})
            a, b = max(a, 0), min(b, dK)
            if b <= a:
                continue
            for stmt in section.body:
                se_lo = se_hi = 0
                if extents is not None:
                    se = extents.stmt_extent(stmt)
                    se_lo, se_hi = se.k
                for r in _stmt_reads(stmt):
                    if r.name not in k_boundary:
                        continue
                    if not isinstance(r.offset, ir.CartesianOffset):
                        continue
                    dk = r.offset.k
                    lower, upper = k_boundary[r.name]
                    lower = max(lower, -(a + dk + se_lo))
                    upper = max(upper, (b + dk + se_hi) - dK)
                    k_boundary[r.name] = (lower, upper)
    return k_boundary


#: VPU-cycle weights per IR operation for the speed-of-light model
#: (docs/performance.md).  ADD/SUB/MUL/select/compare pipeline at one
#: lane-op; division and transcendentals run multi-pass on the v5e VPU.
_FLOP_WEIGHTS = {
    ir.BinaryOperator.ADD: 1,
    ir.BinaryOperator.SUB: 1,
    ir.BinaryOperator.MUL: 1,
    ir.BinaryOperator.DIV: 4,
    ir.BinaryOperator.FLOOR_DIV: 5,
    ir.BinaryOperator.MOD: 5,
    ir.BinaryOperator.POW: 8,
}
_NATIVE_WEIGHTS = {
    "sqrt": 4, "rsqrt": 4, "cbrt": 12, "exp": 8, "log": 8, "log10": 9,
    "sin": 10, "cos": 10, "tan": 14, "asin": 12, "acos": 12, "atan": 12,
    "sinh": 12, "cosh": 12, "tanh": 12, "asinh": 14, "acosh": 14,
    "atanh": 14, "gamma": 24, "erf": 10, "erfc": 10, "pow": 8,
    "mod": 5, "atan2": 14,
}


def estimate_flops_bytes(stencil: ir.Stencil, dK: int):
    """First-order per-GRID-POINT cost model from the IR: VPU lane-op
    count (weighted; see _FLOP_WEIGHTS) and HBM bytes (each API field
    read or written once at its declared dtype; K-less fields amortize
    over the column).  Statements in partial K sections count only
    their K fraction.  Halo recompute amplification (O(halo/N)) and
    DMA granularity are deliberately ignored -- this is the MODEL FLOOR
    numerator, not a simulator.  Returns (flops_per_point, bytes_per_point).
    """
    flops = 0.0
    analysis_reads: set = set()
    analysis_writes: set = set()
    for loop in stencil.vertical_loops:
        for section in loop.sections:
            if section.interval.is_runtime:
                frac = 1.0
            else:
                a, b = section.interval.resolve(dK, {})
                frac = max(0, min(b, dK) - max(a, 0)) / max(1, dK)
            w = 0
            for node in ir.walk_values(section.body):
                if isinstance(node, ir.BinaryOp):
                    w += _FLOP_WEIGHTS.get(node.op, 1)
                elif isinstance(node, ir.UnaryOp):
                    w += 1
                elif isinstance(node, ir.TernaryOp):
                    w += 1
                elif isinstance(node, ir.NativeFuncCall):
                    w += _NATIVE_WEIGHTS.get(
                        getattr(node.func, "value", str(node.func)), 6
                    )
            flops += w * frac
            for stmt in section.body:
                for r in _stmt_reads(stmt):
                    if r.name in stencil.field_decls:
                        analysis_reads.add(r.name)
                for wr in _stmt_writes(stmt):
                    if wr.name in stencil.field_decls:
                        analysis_writes.add(wr.name)
    bytes_pp = 0.0
    for name in analysis_reads | analysis_writes:
        decl = stencil.field_decls[name]
        item = np.dtype(decl.dtype).itemsize if decl.dtype is not None else 4
        col = 1.0 if decl.dimensions[2] else 1.0 / max(1, dK)
        n_dd = 1
        for d in decl.data_dims or ():
            n_dd *= d
        if name in analysis_reads:
            bytes_pp += item * col * n_dd
        if name in analysis_writes:
            bytes_pp += item * col * n_dd
    return flops, bytes_pp


def compute_min_k_size(stencil: ir.Stencil) -> int:
    """Minimum domain K size so all static section intervals are non-empty
    (reference: gtc/passes/gtir_k_boundary.py:78 compute_min_k_size)."""
    min_k = 0
    for loop in stencil.vertical_loops:
        for section in loop.sections:
            if section.interval.is_runtime:
                continue
            s, e = section.interval.start, section.interval.end
            if s.level == ir.LevelMarker.START and e.level == ir.LevelMarker.END:
                min_k = max(min_k, s.offset - e.offset + 1, s.offset + 1)
            elif s.level == e.level:
                bound = max(abs(s.offset), abs(e.offset))
                min_k = max(min_k, bound)
            else:  # END..START is invalid; handled by validation
                pass
    return min_k


# --------------------------------------------------------------------------- #
# Access info (FieldInfo / ParameterInfo)
# --------------------------------------------------------------------------- #


class AccessKind(enum.Flag):
    NONE = 0
    READ = 1
    WRITE = 2
    READ_WRITE = 3


@dataclass
class FieldInfo:
    access: AccessKind
    boundary: Boundary
    dimensions: Tuple[bool, bool, bool]
    data_dims: Tuple[int, ...]
    dtype: np.dtype

    @property
    def domain_ndim(self) -> int:
        return sum(self.dimensions)


@dataclass
class ParameterInfo:
    access: AccessKind
    dtype: np.dtype


@dataclass
class StencilAnalysis:
    """Everything the runtime needs about one parsed stencil."""

    stencil: ir.Stencil
    extents: ExtentAnalysis
    field_info: Dict[str, FieldInfo]
    parameter_info: Dict[str, ParameterInfo]
    k_boundary: Dict[str, Tuple[int, int]]
    min_k_size: int


def analyze(stencil: ir.Stencil, min_extents=None) -> StencilAnalysis:
    """``min_extents``: see ``compute_extents``."""
    from gt4py_tpu_torch.cartesian import validation

    resolve_temp_dtypes(stencil)
    validation.validate(stencil)
    extents = compute_extents(stencil, min_extents)
    k_bounds = compute_k_boundary(stencil, extents=extents)

    read_fields: Dict[str, bool] = {}
    written_fields: Dict[str, bool] = {}
    read_scalars: Dict[str, bool] = {}
    for loop in stencil.vertical_loops:
        for section in loop.sections:
            for stmt in section.body:
                for r in _stmt_reads(stmt):
                    read_fields[r.name] = True
                for w in _stmt_writes(stmt):
                    written_fields[w.name] = True
                for n in ir.walk_values(stmt):
                    if isinstance(n, ir.ScalarAccess):
                        read_scalars[n.name] = True

    field_info: Dict[str, FieldInfo] = {}
    for name, decl in stencil.field_decls.items():
        access = AccessKind.NONE
        if name in read_fields:
            access |= AccessKind.READ
        if name in written_fields:
            access |= AccessKind.WRITE
        ext = extents.alloc_extent(name)
        kb = k_bounds.get(name, (0, 0))
        boundary = Boundary(
            i=(-min(ext.i[0], 0), max(ext.i[1], 0)),
            j=(-min(ext.j[0], 0), max(ext.j[1], 0)),
            k=kb,
        )
        field_info[name] = FieldInfo(
            access=access,
            boundary=boundary,
            dimensions=decl.dimensions,
            data_dims=decl.data_dims,
            dtype=decl.dtype,
        )

    parameter_info = {
        name: ParameterInfo(
            access=AccessKind.READ if name in read_scalars else AccessKind.NONE,
            dtype=decl.dtype,
        )
        for name, decl in stencil.scalar_decls.items()
    }

    return StencilAnalysis(
        stencil=stencil,
        extents=extents,
        field_info=field_info,
        parameter_info=parameter_info,
        k_boundary=k_bounds,
        min_k_size=compute_min_k_size(stencil),
    )
