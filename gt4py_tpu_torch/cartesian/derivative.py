"""K8's derivative stencils: the tangent and the adjoint of a stencil,
generated from its analysed IR as stencils of their own.

The JAX package differentiates a Pallas kernel call through a
``jax.custom_jvp`` whose tangent is its own executor's, transposed by
``jax.grad`` and compiled by XLA (``PallasBackend._trace_env``,
gt4py_tpu/cartesian/backend/pallas_backend.py:178).  Here the derivative is
itself a stencil, which the ``"cuda"`` backend builds like any other: its
kernels get the tile form, the fused column kernel, the periodic wrap and
the rest.  One table of derivative rules (``_rules``) serves both
transforms.

**Tangent** (forward mode, ``tangent_stencil``).  The same loops,
intervals and order: before each assignment ``x = e(r_1 .. r_m)`` whose
value depends on a wanted input, ``x__d = sum_i de/dr_i * r_i__d`` with
each read at its own offset, inside the same ``if``, region or ``while``.
A point a mask leaves unwritten keeps its old tangent.  The API fields are
the forward's (a written one recomputed into a clone of its buffer), one
tangent field ``F__d`` per field that carries one, and one tangent scalar
per tensor scalar.

**Adjoint** (reverse mode, ``adjoint_stencil``), in gather form: no
atomics, every value written once.

- The forward is first put in predicated single-assignment form: ``if``
  and region bodies become ternaries (``x = m ? e : x``, the mask a bool
  temporary), and every assignment writes a version of its field of its
  own -- except that the last assignment of a field in each section of a
  serial loop writes the loop's version, which its reads at K offsets of
  already swept levels see.  A read binds to the newest version whose
  levels hold it; a section is cut into pieces wherever its K-offset reads
  would cross a section bound, so no read spans two versions.  A written
  API field's versions are temporaries: the adjoint reads the field's
  value from before the call.  A variable- or absolute-K read of a field
  whose gradient is not wanted becomes a temporary of its own, so the
  partial that holds it can be shifted.  A compound statement's write read
  at an offset beyond the statement's extent (where the forward reads the
  earlier version) carries the extent in its mask (``cover_reads``).
- The adjoint stencil recomputes those versions (the forward's loops,
  statements the adjoint never reads pruned), then runs the adjoint loops:
  the forward's loops in reverse order, FORWARD as BACKWARD and BACKWARD as
  FORWARD, sections and statements reversed.  A version ``v`` read at
  offset ``a`` by an assignment ``w = f(...)`` gets, in its bar
  ``v__b``, the term ``df/dv[a](q - a) * w__b(q - a)``: the partial shifted
  by ``-a`` and guarded by "``q - a`` lies in the forward's region of that
  assignment" (its section's levels, its statement extent on each axis
  that is not periodic).  A bar is written once, after all its readers:
  in a reversed serial loop a read of the bar at the level already swept
  (the forward's read at K offset -1 becomes a read at +1).
- A final PARALLEL loop gathers the gradient ``F__g`` of every wanted API
  field (its value before the call), over the forward's read extent of the
  field (its K halo too: the adjoint runs on the call's levels grown by
  the wanted fields' K halos, ``Derivative.k_grow``), and a per-point
  contribution field ``w__g`` for every wanted
  tensor scalar, which the caller sums.  A written field's cotangent
  ``F__c`` passes straight through wherever no assignment wrote the point
  (its halo, unwritten levels).
- Periodic axes carry no guards: the forward's values beyond the domain on
  a periodic axis are copies of those inside, so the adjoint runs on the
  torus, and a gradient is computed over the domain there.  Where they are
  not (regions, I/J positions, writes or compound statements' reads beyond
  the domain), the periodic forward is the bounded one on fields whose
  halos are filled from the inside: the adjoint runs bounded on such
  filled copies and the caller folds the filled fields' gradients back
  (``Derivative.fill``).

Domain edges: a guarded term may read a buffer beyond the forward's reads
where its guard is false.  The caller pads such buffers
(``read_boundary``); temporaries are allocated to cover their reads.

The other constructs:

- A write at a K offset ``f[0, 0, c] = e`` writes a version whose level
  ``k`` holds the field's level ``k + c`` (``_Adjoint.shift``): its reads
  bind at the offset less ``c``, the levels it covers (which cut the
  pieces) are its section's moved by ``c``.  A serial loop has a version
  of the field for each offset it writes at: a read binds to the newest
  write of its levels -- at its own offset earlier at the same level, else
  at the offset nearest its own among those whose level the sweep has
  passed -- and a write hands its cotangent on only where no write later
  in the sweep covers the level (``_Adjoint.later``).
- A data-dimension component written at a static index is a field of its
  own (``_Adjoint.components``); a write at a per-point index is a scatter
  (``DYNAMIC_INDEX``).
- A lower-dimensional field whose gradient is wanted gets a per-point
  contribution on every axis, which the caller sums over the axes it
  lacks (``Derivative.sums``).  A written field with K that lacks I or J
  is versioned as a 3-D field: every point of the axes it lacks computes
  the same value, its cotangent enters at their first point, and the
  caller sums its gradient.  A written field that lacks K (I-J, I or J, a
  data-dimension one component by component) keeps its forward
  semantics: a state the recomputed forward updates in place, read
  through snapshots taken where the forward reads it, and a bar the
  adjoint accumulates in place -- in serial loops, a PARALLEL section's
  contributions in a FORWARD loop of their own -- and hands on at each
  write; both are I-J fields, one copy an I or J point where the field
  lacks the axis (``Derivative.planes``).
- Run-time interval bounds are fixed at the call's values before the
  transform (``resolve_bounds``): an adjoint a set of values.
- A variable- or absolute-K read of a field the stencil writes, whose
  value no wanted input changes, reads a temporary that follows the field
  in place (``_Adjoint.mirrors``; a write at a K offset updates the level
  it writes); where the value depends on a wanted input its bar is the
  scatter or reduction of ``VARIABLE_K`` / ``ABSOLUTE_K``.

Constructs without a gather-form adjoint decline with a named reason
(``Declined``).  Those in ``PLAIN_RERUN`` keep the plain executor's re-run
on the card: ``while`` (its trip count needs a tape), a variable-K,
absolute-K or dynamic data-index read of a field whose gradient is wanted
or whose value depends on one, a write at a per-point data index, and
``gamma``.  The other declines (``Declined.reruns`` false) are periodic
calls the torus does not hold for, which ``adjoint_stencil`` runs bounded
on filled copies instead.  The tangent declines only for ``gamma``.  The
derivative's own names never clash with the stencil's (``_Names``).
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from gt4py_tpu_torch.cartesian import ir
from gt4py_tpu_torch.cartesian.analysis import (
    DtypeEnv,
    StencilAnalysis,
    analyze,
    compute_k_boundary_resolved,
    infer_expr_dtype,
    try_static_int,
)
from gt4py_tpu_torch.core.definitions import Extent, is_float_dtype

_BOOL = np.dtype(np.bool_)
_I64 = np.dtype(np.int64)

WHILE = "a while loop: its trip count needs a tape"
VARIABLE_K = "a variable-K read of a field whose gradient is wanted or whose value depends " \
             "on one (a scatter to a data-dependent level)"
ABSOLUTE_K = "an absolute-K read of a field whose gradient is wanted or whose value " \
             "depends on one (a reduction over K)"
DYNAMIC_INDEX = "a dynamic data-dimension index into a field whose gradient is wanted, or " \
                "into a field written at a component"
GAMMA = "gamma: its derivative needs a digamma the IR lacks"
PERIODIC_POSITION = "a periodic call of a stencil that reads I/J positions or has horizontal " \
                    "regions"
PERIODIC_WIDE_WRITE = "a periodic call writing a field beyond the domain"
PERIODIC_UNCOVERED = "a periodic call reading, beyond a compound statement's extent, a field " \
                     "the statement writes"


#: the constructs without a gather-form adjoint: a stencil with one keeps
#: the plain executor's re-run for its derivative on the card; every other
#: decline is work still open, and raises there
PLAIN_RERUN = frozenset({WHILE, VARIABLE_K, ABSOLUTE_K, DYNAMIC_INDEX, GAMMA})


class Declined(NotImplementedError):
    """The stencil has no derivative stencil of this kind; the message is
    one of the module's named reasons."""

    @property
    def reruns(self) -> bool:
        """Whether the reason is one that keeps the plain re-run."""
        return str(self) in PLAIN_RERUN


@dataclasses.dataclass
class Derivative:
    """A derivative stencil and how its fields map to the forward's.

    ``kind``: ``"tangent"`` or ``"adjoint"``.  Tangent: ``dots`` maps every
    forward field or tensor scalar that carries a tangent to its tangent
    field or scalar.  Adjoint: ``cots`` maps each written field to its
    cotangent field, ``grads`` each wanted field to its gradient field,
    ``contribs`` each wanted tensor scalar to its per-point contribution
    field (``contrib_extent``: its I and J extents beyond the domain; the
    caller sums it), ``passthrough`` the written fields whose gradient
    starts as their cotangent (the points no assignment writes keep it)."""

    kind: str
    analysis: StencilAnalysis
    dots: Dict[str, str] = dataclasses.field(default_factory=dict)
    cots: Dict[str, str] = dataclasses.field(default_factory=dict)
    grads: Dict[str, str] = dataclasses.field(default_factory=dict)
    contribs: Dict[str, str] = dataclasses.field(default_factory=dict)
    contrib_extent: Dict[str, Extent] = dataclasses.field(default_factory=dict)
    passthrough: Tuple[str, ...] = ()
    #: the adjoint runs on the call's levels grown by (below, above): the
    #: wanted fields' K halos the forward reads
    k_grow: Tuple[int, int] = (0, 0)
    #: ``read_boundary`` of the adjoint on its levels
    reach: Dict[str, Tuple[Tuple[int, int], ...]] = dataclasses.field(default_factory=dict)
    #: a wanted lower-dimensional field -> the axes it lacks, over which
    #: the caller sums its gradient field (a per-point contribution on
    #: every axis), the gradient's I and J extents beyond the domain and
    #: its levels in the adjoint's
    sums: Dict[str, Tuple[Tuple[str, ...], Extent, Tuple[int, int]]] = \
        dataclasses.field(default_factory=dict)
    #: a written field that lacks K -> its component index (``()`` for
    #: none) -> (its state, its bar): I-J API fields the caller starts as
    #: the component's value at every point and its cotangent at the first
    #: I or J point where the field lacks the axis (zeros at the others);
    #: the bar, summed over the axes the field lacks, ends as the
    #: component's gradient (``grads``: the field's, which the caller makes)
    planes: Dict[str, Dict[Tuple[int, ...], Tuple[str, str]]] = \
        dataclasses.field(default_factory=dict)
    #: periodic axes the adjoint does not run on as a torus: it runs
    #: bounded on copies of the fields filled as the forward fills them,
    #: and the filled fields' gradients are folded back (the fill's
    #: transpose); empty: the torus (or a bounded call)
    fill: Tuple[str, ...] = ()

    @property
    def stencil(self) -> ir.Stencil:
        return self.analysis.stencil


# --------------------------------------------------------------------------- #
# expressions
# --------------------------------------------------------------------------- #


def _lit(value, dt) -> ir.Literal:
    return ir.Literal(value, np.dtype(dt))


def _bin(op, a, b) -> ir.BinaryOp:
    return ir.BinaryOp(op, a, b)


def _add(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return _bin(ir.BinaryOperator.ADD, a, b)


def _mul(a, b):
    return _bin(ir.BinaryOperator.MUL, a, b)


def _div(a, b):
    return _bin(ir.BinaryOperator.DIV, a, b)


def _sub(a, b):
    return _bin(ir.BinaryOperator.SUB, a, b)


def _neg(a):
    return ir.UnaryOp(ir.UnaryOperator.NEG, a)


def _sel(c, t, f):
    return ir.TernaryOp(c, t, f)


def _and(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return _bin(ir.BinaryOperator.AND, a, b)


def _not(a):
    return ir.UnaryOp(ir.UnaryOperator.NOT, a)


def _fn(func, *args):
    return ir.NativeFuncCall(func, list(args))


def _pos_shift(axis: str, d: int) -> ir.Expr:
    pos = ir.AxisPosition(axis)
    return pos if d == 0 else _bin(ir.BinaryOperator.ADD, pos, _lit(d, _I64))


def shift(expr: ir.Expr, off: Tuple[int, int, int]) -> ir.Expr:
    """A copy of ``expr`` evaluated at the point shifted by ``off``: every
    read moves by it (the adjoint's partials hold Cartesian reads only:
    ``_Adjoint.hoist``), I/J/K positions grow by it."""
    di, dj, dk = off
    if not (di or dj or dk):
        return copy.deepcopy(expr)
    out = copy.deepcopy(expr)
    seen: set = set()

    def visit(node):
        if id(node) in seen:
            return node
        seen.add(id(node))
        if isinstance(node, ir.AxisPosition):
            return _pos_shift(node.axis, {"I": di, "J": dj, "K": dk}[node.axis])
        if isinstance(node, ir.FieldAccess):
            o = node.offset
            node.offset = ir.CartesianOffset(o.i + di, o.j + dj, o.k + dk)
            node.data_index = tuple(visit(e) for e in node.data_index)
            return node
        for f in dataclasses.fields(node):
            v = getattr(node, f.name)
            if isinstance(v, ir.Expr):
                setattr(node, f.name, visit(v))
            elif isinstance(v, list) and v and isinstance(v[0], ir.Expr):
                setattr(node, f.name, [visit(x) for x in v])
        return node

    return visit(out)


def _rename(expr: ir.Expr, resolve: Callable[[ir.FieldAccess], ir.Expr],
            leaf: Callable[[ir.Expr], ir.Expr] = copy.deepcopy) -> ir.Expr:
    """A copy of ``expr`` with every field read replaced by
    ``resolve(read)`` (reads inside offsets and data indices first) and
    every other leaf by ``leaf(leaf)``."""
    def go(e):
        return _rename(e, resolve, leaf)

    if isinstance(expr, ir.FieldAccess):
        acc = ir.FieldAccess(expr.name, copy.deepcopy(expr.offset),
                             tuple(go(e) for e in expr.data_index))
        if not isinstance(acc.offset, ir.CartesianOffset):
            acc.offset.k = go(acc.offset.k)
        return resolve(acc)
    if isinstance(expr, (ir.Literal, ir.ScalarAccess, ir.AxisPosition, ir.AxisSize)):
        return leaf(expr)
    if isinstance(expr, ir.Cast):
        return ir.Cast(expr.dtype, go(expr.expr))
    if isinstance(expr, ir.UnaryOp):
        return ir.UnaryOp(expr.op, go(expr.expr))
    if isinstance(expr, ir.BinaryOp):
        return ir.BinaryOp(expr.op, go(expr.left), go(expr.right))
    if isinstance(expr, ir.TernaryOp):
        return ir.TernaryOp(go(expr.cond), go(expr.true_expr), go(expr.false_expr))
    if isinstance(expr, ir.NativeFuncCall):
        return ir.NativeFuncCall(expr.func, [go(a) for a in expr.args])
    raise TypeError(f"cannot rename {type(expr).__name__}")


# --------------------------------------------------------------------------- #
# the derivative rules
# --------------------------------------------------------------------------- #

_NF = ir.NativeFunction
_BO = ir.BinaryOperator
_ZERO_DERIVATIVE = {_NF.FLOOR, _NF.CEIL, _NF.TRUNC, _NF.ROUND, _NF.ROUND_AWAY_FROM_ZERO,
                    _NF.ISFINITE, _NF.ISINF, _NF.ISNAN}


class _Rules:
    """The derivative of each IR operation, as the plain executor's
    autograd gives it (ties of ``min``/``max`` split the derivative in two,
    ``abs`` has none at 0).  ``rules(e)`` lists ``(child, dtype, fn)``:
    the child's contribution to ``e``'s derivative is ``fn(s)`` for a seed
    ``s`` of ``dtype`` (the operation's), linear in ``s``."""

    def __init__(self, stencil: ir.Stencil):
        self.env = DtypeEnv(stencil)

    def dtype(self, e: ir.Expr) -> np.dtype:
        return np.dtype(infer_expr_dtype(e, self.env))

    def cast(self, e: ir.Expr, src, dst) -> ir.Expr:
        return e if np.dtype(src) == np.dtype(dst) else ir.Cast(np.dtype(dst), e)

    def rules(self, e: ir.Expr):
        dt = self.dtype(e)
        if not is_float_dtype(dt):
            return []
        if isinstance(e, ir.Cast):
            sdt = self.dtype(e.expr)
            return [(e.expr, dt, lambda s: s)] if is_float_dtype(sdt) else []
        if isinstance(e, ir.UnaryOp):
            if e.op == ir.UnaryOperator.NEG:
                return [(e.expr, dt, _neg)]
            if e.op == ir.UnaryOperator.POS:
                return [(e.expr, dt, lambda s: s)]
            return []
        if isinstance(e, ir.BinaryOp):
            return self._binary(e, dt)
        if isinstance(e, ir.TernaryOp):
            z = _lit(0, dt)
            return [(e.true_expr, dt, lambda s: _sel(e.cond, s, z)),
                    (e.false_expr, dt, lambda s: _sel(e.cond, z, s))]
        if isinstance(e, ir.NativeFuncCall):
            return self._native(e, dt)
        return []

    def _binary(self, e: ir.BinaryOp, dt):
        op = e.op
        L = self.cast(e.left, self.dtype(e.left), dt)
        R = self.cast(e.right, self.dtype(e.right), dt)
        one = _lit(1, dt)
        if op == _BO.ADD:
            return [(e.left, dt, lambda s: s), (e.right, dt, lambda s: s)]
        if op == _BO.SUB:
            return [(e.left, dt, lambda s: s), (e.right, dt, _neg)]
        if op == _BO.MUL:
            return [(e.left, dt, lambda s: _mul(s, R)), (e.right, dt, lambda s: _mul(s, L))]
        if op == _BO.DIV:
            return [(e.left, dt, lambda s: _div(s, R)),
                    (e.right, dt, lambda s: _neg(_div(_mul(s, L), _mul(R, R))))]
        if op == _BO.MOD:
            return [(e.left, dt, lambda s: s),
                    (e.right, dt, lambda s: _neg(_mul(s, _fn(_NF.FLOOR, _div(L, R)))))]
        if op == _BO.POW:
            return self._pow(e.left, e.right, L, R, dt, one)
        return []

    def _pow(self, left, right, L, R, dt, one):
        z = _lit(0, dt)
        # torch: no derivative along the base where the exponent is 0, none
        # along the exponent where the base is 0 and the exponent >= 0
        base = lambda s: _sel(_bin(_BO.EQ, R, z), z,  # noqa: E731
                              _mul(_mul(s, R), _fn(_NF.POW, L, _sub(R, one))))
        expo = lambda s: _sel(_and(_bin(_BO.EQ, L, z), _bin(_BO.GE, R, z)), z,  # noqa: E731
                              _mul(_mul(s, _fn(_NF.POW, L, R)), _fn(_NF.LOG, L)))
        return [(left, dt, base), (right, dt, expo)]

    def _native(self, e: ir.NativeFuncCall, dt):
        fn = e.func
        if fn == _NF.GAMMA:
            raise Declined(GAMMA)
        if fn in _ZERO_DERIVATIVE:
            return []
        args = [self.cast(a, self.dtype(a), dt) for a in e.args]
        x = args[0]
        z, one, two = _lit(0, dt), _lit(1, dt), _lit(2, dt)
        unary = {
            _NF.SIN: lambda s: _mul(s, _fn(_NF.COS, x)),
            _NF.COS: lambda s: _neg(_mul(s, _fn(_NF.SIN, x))),
            _NF.TAN: lambda s: _mul(s, _add(one, _mul(_fn(_NF.TAN, x), _fn(_NF.TAN, x)))),
            _NF.ARCSIN: lambda s: _div(s, _fn(_NF.SQRT, _sub(one, _mul(x, x)))),
            _NF.ARCCOS: lambda s: _neg(_div(s, _fn(_NF.SQRT, _sub(one, _mul(x, x))))),
            _NF.ARCTAN: lambda s: _div(s, _add(one, _mul(x, x))),
            _NF.SINH: lambda s: _mul(s, _fn(_NF.COSH, x)),
            _NF.COSH: lambda s: _mul(s, _fn(_NF.SINH, x)),
            _NF.TANH: lambda s: _mul(s, _sub(one, _mul(_fn(_NF.TANH, x), _fn(_NF.TANH, x)))),
            _NF.ARCSINH: lambda s: _div(s, _fn(_NF.SQRT, _add(_mul(x, x), one))),
            _NF.ARCCOSH: lambda s: _div(s, _fn(_NF.SQRT, _sub(_mul(x, x), one))),
            _NF.ARCTANH: lambda s: _div(s, _sub(one, _mul(x, x))),
            _NF.SQRT: lambda s: _div(s, _mul(two, _fn(_NF.SQRT, x))),
            _NF.EXP: lambda s: _mul(s, _fn(_NF.EXP, x)),
            _NF.LOG: lambda s: _div(s, x),
            _NF.LOG10: lambda s: _div(s, _mul(x, _lit(math.log(10.0), dt))),
            _NF.LOG2: lambda s: _div(s, _mul(x, _lit(math.log(2.0), dt))),
            _NF.CBRT: lambda s: _div(s, _mul(_lit(3, dt), _mul(_fn(_NF.CBRT, x),
                                                                _fn(_NF.CBRT, x)))),
            _NF.ERF: lambda s: _mul(_mul(s, _lit(2.0 / math.sqrt(math.pi), dt)),
                                    _fn(_NF.EXP, _neg(_mul(x, x)))),
            _NF.ERFC: lambda s: _neg(_mul(_mul(s, _lit(2.0 / math.sqrt(math.pi), dt)),
                                          _fn(_NF.EXP, _neg(_mul(x, x))))),
            _NF.ABS: lambda s: _sel(_bin(_BO.GT, x, z), s, _sel(_bin(_BO.LT, x, z), _neg(s), z)),
        }
        if fn in unary:
            return [(e.args[0], dt, unary[fn])]
        y = args[1]
        half = _lit(0.5, dt)
        if fn in (_NF.MIN, _NF.MAX):
            first = _BO.LT if fn == _NF.MIN else _BO.GT

            def part(a, b):
                return lambda s: _sel(_bin(first, a, b), s,
                                      _sel(_bin(_BO.EQ, a, b), _mul(s, half), z))

            return [(e.args[0], dt, part(x, y)), (e.args[1], dt, part(y, x))]
        if fn == _NF.MOD:
            return [(e.args[0], dt, lambda s: s),
                    (e.args[1], dt, lambda s: _neg(_mul(s, _fn(_NF.FLOOR, _div(x, y)))))]
        if fn == _NF.ARCTAN2:
            d = _add(_mul(y, y), _mul(x, x))
            return [(e.args[0], dt, lambda s: _div(_mul(s, y), d)),
                    (e.args[1], dt, lambda s: _neg(_div(_mul(s, x), d)))]
        if fn == _NF.POW:
            return self._pow(e.args[0], e.args[1], x, y, dt, one)
        raise TypeError(f"no derivative rule for {fn.value}")

    def adjoint(self, e: ir.Expr, s: ir.Expr, out: list) -> None:
        """Append ``(read, contribution)`` for every float field or scalar
        read of ``e`` given the seed ``s`` (of ``e``'s dtype)."""
        if isinstance(e, (ir.FieldAccess, ir.ScalarAccess)):
            if is_float_dtype(self.dtype(e)):
                out.append((e, s))
            return
        for child, dt, fn in self.rules(e):
            cdt = self.dtype(child)
            if is_float_dtype(cdt):
                self.adjoint(child, self.cast(fn(s), dt, cdt), out)

    def tangent(self, e: ir.Expr, dot: Callable[[ir.Expr], Optional[ir.Expr]]):
        """``e``'s tangent (None: zero), ``dot(read)`` the tangent of a read
        (None: zero)."""
        if isinstance(e, (ir.FieldAccess, ir.ScalarAccess)):
            return dot(e) if is_float_dtype(self.dtype(e)) else None
        total = None
        for child, dt, fn in self.rules(e):
            t = self.tangent(child, dot)
            if t is not None:
                total = _add(total, fn(self.cast(t, self.dtype(child), dt)))
        return total


def _gamma_free(stencil: ir.Stencil) -> None:
    for n in ir.walk_values(stencil.vertical_loops):
        if isinstance(n, ir.NativeFuncCall) and n.func == _NF.GAMMA:
            raise Declined(GAMMA)


def _active(st: ir.Stencil, wanted) -> set:
    """The names whose value depends on a ``wanted`` input: a target is
    active when its value reads an active name (a fixpoint over the
    loops, which read earlier levels' writes)."""
    assigns = [n for n in ir.walk_values(st.vertical_loops) if isinstance(n, ir.Assign)]
    active = set(wanted)
    changed = True
    while changed:
        changed = False
        for a in assigns:
            if a.target.name in active:
                continue
            reads = {n.name for n in ir.walk_values(a.value)
                     if isinstance(n, (ir.FieldAccess, ir.ScalarAccess))}
            if reads & active:
                active.add(a.target.name)
                changed = True
    return active


def runtime_bounds(st: ir.Stencil) -> Tuple[str, ...]:
    """The scalars that give interval bounds at run time."""
    return tuple(sorted({b.name for loop in st.vertical_loops for sec in loop.sections
                         for b in (sec.interval.start, sec.interval.end)
                         if isinstance(b, ir.RuntimeAxisBound)}))


def resolve_bounds(analysis: StencilAnalysis, bounds: Dict[str, int]) -> StencilAnalysis:
    """``analysis``' stencil with its run-time interval bounds fixed at the
    values ``bounds`` (scalar -> int) of a call, analysed anew."""
    if not bounds:
        return analysis
    st = copy.deepcopy(analysis.stencil)

    def fix(b):
        if isinstance(b, ir.RuntimeAxisBound):
            return ir.AxisBound.start(int(bounds[b.name]) + b.offset)
        return b

    for loop in st.vertical_loops:
        for sec in loop.sections:
            sec.interval = ir.Interval(fix(sec.interval.start), fix(sec.interval.end))
    return analyze(st, validate=False)


def _new_stencil(fwd: ir.Stencil, name: str) -> ir.Stencil:
    return ir.Stencil(name=name, api_params=[], field_decls={}, scalar_decls=dict(fwd.scalar_decls),
                      temp_decls={}, vertical_loops=[], externals=dict(fwd.externals),
                      sources=fwd.sources, literal_float_dtype=fwd.literal_float_dtype,
                      literal_int_dtype=fwd.literal_int_dtype)


def _decl(name: str, like: ir.FieldDecl, api: bool, dtype=None) -> ir.FieldDecl:
    """A field like ``like``; a temporary (``api`` false) has every axis."""
    return ir.FieldDecl(name=name, dtype=np.dtype(dtype if dtype is not None else like.dtype),
                        dimensions=tuple(like.dimensions) if api else (True, True, True),
                        data_dims=tuple(like.data_dims), is_api=api)


class _Names:
    """The derivative stencil's new names: ``want``, or ``want`` with a
    number appended where the forward (or an earlier new name) takes it."""

    def __init__(self, st: ir.Stencil):
        self.taken = set(st.field_decls) | set(st.temp_decls) | set(st.scalar_decls)

    def __call__(self, want: str) -> str:
        name, n = want, 0
        while name in self.taken:
            n += 1
            name = f"{want}_{n}"
        self.taken.add(name)
        return name

    def numbered(self, prefix: str) -> str:
        """``prefix`` and the least number from 1 that makes a new name."""
        n = 1
        while f"{prefix}{n}" in self.taken:
            n += 1
        return self(f"{prefix}{n}")


# --------------------------------------------------------------------------- #
# tangent
# --------------------------------------------------------------------------- #


def tangent_stencil(analysis: StencilAnalysis, wanted: Sequence[str]) -> Derivative:
    """The tangent stencil of ``analysis``' stencil for the fields and
    tensor scalars ``wanted`` (those whose tangent is given)."""
    fwd = analysis.stencil
    _gamma_free(fwd)
    active = _active(fwd, set(wanted))
    st = _new_stencil(fwd, f"{fwd.name}__tan")
    new_name = _Names(fwd)
    st.field_decls = {n: copy.deepcopy(d) for n, d in fwd.field_decls.items()}
    st.temp_decls = {n: copy.deepcopy(d) for n, d in fwd.temp_decls.items()}
    st.api_params = [copy.deepcopy(p) for p in fwd.api_params]
    dots: Dict[str, str] = {}
    for name in sorted(active):
        if name in fwd.scalar_decls:
            if not is_float_dtype(fwd.scalar_decls[name].dtype or np.float64):
                continue
            dots[name] = new_name(f"{name}__d")
            st.scalar_decls[dots[name]] = ir.ScalarDecl(dots[name], fwd.scalar_decls[name].dtype)
            st.api_params.append(ir.ApiParam(dots[name], is_field=False))
            continue
        decl = fwd.decl(name)
        if decl is None or not is_float_dtype(decl.dtype):
            continue
        dots[name] = new_name(f"{name}__d")
        if name in fwd.field_decls:
            st.field_decls[dots[name]] = _decl(dots[name], decl, True)
            st.api_params.append(ir.ApiParam(dots[name], is_field=True))
        else:
            st.temp_decls[dots[name]] = _decl(dots[name], decl, False)
    rules = _Rules(st)

    def dot(read):
        d = dots.get(read.name)
        if d is None:
            return None
        if isinstance(read, ir.ScalarAccess):
            return ir.ScalarAccess(d)
        return ir.FieldAccess(d, copy.deepcopy(read.offset), copy.deepcopy(read.data_index))

    def body(stmts):
        out = []
        for s in stmts:
            s = copy.copy(s)
            if isinstance(s, ir.Assign):
                d = dots.get(s.target.name)
                if d is not None:
                    tdt = np.dtype(st.decl(s.target.name).dtype)
                    t = rules.tangent(s.value, dot)
                    out.append(ir.Assign(ir.FieldAccess(d, copy.deepcopy(s.target.offset),
                                                        copy.deepcopy(s.target.data_index)),
                                         copy.deepcopy(t) if t is not None else _lit(0, tdt)))
                out.append(copy.deepcopy(s))
                continue
            if isinstance(s, (ir.If, ir.While)):
                s.cond = copy.deepcopy(s.cond)
            if isinstance(s, ir.If):
                s.body, s.orelse = body(s.body), body(s.orelse)
            elif isinstance(s, (ir.While, ir.HorizontalRestriction)):
                s.body = body(s.body)
            out.append(s)
        return out

    st.vertical_loops = [
        ir.VerticalLoop(loop.loop_order, [ir.VerticalSection(sec.interval, body(sec.body))
                                          for sec in loop.sections])
        for loop in fwd.vertical_loops]
    return Derivative("tangent", analyze(st, validate=False), dots=dots)


# --------------------------------------------------------------------------- #
# adjoint
# --------------------------------------------------------------------------- #


@dataclasses.dataclass
class _Asg:
    """One assignment of the predicated single-assignment forward.
    ``open``: computed wherever needed, its mask holding its statement's
    extent ``ext`` (``_Adjoint.cover_reads``); ``masked``: its value is
    ``mask ? e : prev``; ``prev``: otherwise, the version it overwrites at
    the point (None where none binds)."""

    target: str
    field: str
    value: ir.Expr
    levels: Tuple[int, int]
    ext: Extent
    mask: bool = False
    open: bool = False
    masked: bool = False
    prev: Optional[ir.Expr] = None
    #: the write's K offset: level k of the version holds the field's k + shift
    shift: int = 0
    #: a write of a lower-dimensional field (``_Adjoint.planes``)
    plane: bool = False
    #: the forward loop (its index) and its order: which of two writes of
    #: one level comes later (``_Adjoint.later``)
    loop: int = 0
    order: ir.LoopOrder = ir.LoopOrder.PARALLEL
    #: the K offset the recomputed forward writes at (a mirror that follows
    #: a write at a K offset)
    at: int = 0


#: the pieces are cut at every bound of a section and of the levels a write
#: covers, less every K offset the piece's section reads at
#: (``build_forward``): the levels a read covers lie in one version's or
#: outside all
_UNCUT = "a read spans levels one version covers and another does not"

#: a region no guard is trivially true over
_EVERYWHERE = Extent(i=(-(1 << 20), 1 << 20), j=(-(1 << 20), 1 << 20))


def _relation(r: Tuple[int, int], cover: Sequence[Tuple[int, int]]) -> str:
    """Whether the levels ``[r0, r1)`` lie ``"in"`` the union of ``cover``,
    ``"out"`` of it, or in part (``"partial"``)."""
    inside = 0
    for lo, hi in cover:
        inside += max(0, min(hi, r[1]) - max(lo, r[0]))
    if inside == r[1] - r[0]:
        return "in"
    return "out" if inside == 0 else "partial"


def _region_expr(masks: Sequence[ir.HorizontalMask]) -> ir.Expr:
    """The horizontal regions' test at the point, against the region frame
    (global I/J positions and sizes), as ``torch_backend`` resolves them."""
    def bound(b: Optional[ir.AxisBound], axis: str):
        if b is None:
            return None
        if b.level == ir.LevelMarker.START:
            return _lit(b.offset, _I64)
        return _bin(_BO.ADD, ir.AxisSize(axis), _lit(b.offset, _I64))

    total = None
    for m in masks:
        conj = None
        for axis, itv in (("I", m.i), ("J", m.j)):
            lo, hi = bound(itv.start, axis), bound(itv.end, axis)
            if lo is not None:
                conj = _and(conj, _bin(_BO.GE, ir.AxisPosition(axis), lo))
            if hi is not None:
                conj = _and(conj, _bin(_BO.LT, ir.AxisPosition(axis), hi))
        conj = conj if conj is not None else _lit(True, _BOOL)
        total = conj if total is None else _bin(_BO.OR, total, conj)
    return total if total is not None else _lit(False, _BOOL)


class _Adjoint:
    def __init__(self, analysis: StencilAnalysis, wanted: Sequence[str], dK: int,
                 periodic: Sequence[str]):
        self.fwd = analysis
        self.st = analysis.stencil
        self.dK = int(dK)
        self.periodic = tuple(periodic)
        self.wanted = set(wanted)
        # the levels run grow by the wanted fields' K halos: level k of the
        # call is level k + kl of the adjoint
        kb = compute_k_boundary_resolved(self.st, self.dK, names=[
            n for n in self.st.field_decls if n in self.wanted], extents=analysis.extents)
        self.kl = max([lo for lo, _ in kb.values()] + [0])
        self.kh = max([hi for _, hi in kb.values()] + [0])
        self.out = _new_stencil(self.st, f"{self.st.name}__adj")
        self.new_name = _Names(self.st)
        #: the bool temporaries holding masks and the temporaries holding
        #: variable- or absolute-K reads (``hoist``)
        self.own: set = set()
        #: an assignment's target -> its bar
        self.bars: Dict[str, str] = {}
        self.asgs: List[_Asg] = []
        #: field -> versions finished loops wrote: (name, covered levels)
        self.done: Dict[str, List[Tuple[str, List[Tuple[int, int]]]]] = {}
        #: a data-dimension field's component written at a static index is
        #: a field of its own: its key -> (field, index)
        self.components: Dict[str, Tuple[str, Tuple[int, ...]]] = {}
        #: a version -> the K offset of the write it holds: its level k
        #: holds the field's level k + shift
        self.shift: Dict[str, int] = {}
        #: written fields read at a variable or absolute K, whose value no
        #: wanted input changes: key -> the temporary that follows the
        #: field's value in place, as the forward's buffer does
        self.mirrors: Dict[str, str] = {}
        self.active = _active(self.st, self.wanted)
        #: a written field that lacks K (I-J, I or J; a data-dimension
        #: one component by component) -> its state, which the recomputed
        #: forward updates in place as the forward's buffer, and its bar,
        #: accumulated in place by the adjoint: both I-J API fields, one
        #: copy an I or J point where the field lacks the axis (the caller
        #: starts the state from the field's value at every point, the bar
        #: from its cotangent at the axis' first point, and sums the bar
        #: over the axis); its reads are snapshots of the state: temporary
        #: -> (key, I/J offset), whose contributions the bar accumulates.
        #: A written field with K that lacks I or J is versioned as a 3-D
        #: one, every point of the axes it lacks computing the same value
        #: (its cotangent enters at their first point: ``passthrough``)
        self.planes: Dict[str, Tuple[str, str]] = {}
        self.state: Dict[str, str] = {}
        self.snaps: Dict[str, Tuple[str, Tuple[int, int]]] = {}
        for n, d in self.st.field_decls.items():
            if d.dimensions[2] or not any(
                    isinstance(x, ir.Assign) and x.target.name == n
                    for x in ir.walk_values(self.st.vertical_loops)):
                continue
            if self.periodic:
                # the state read beyond the domain is no copy of one inside
                raise Declined(PERIODIC_WIDE_WRITE)
            for idx in np.ndindex(*d.data_dims):
                key = self.component(n, tuple(idx)) if idx else n
                self.planes[key] = (self.new_name(f"{n}__s"), self.new_name(f"{n}__b"))
                self.state[self.planes[key][0]] = key
        self.plane_fields = {self.base(k) for k in self.planes}

    def component(self, name: str, idx: Tuple[int, ...]) -> str:
        """The key of ``name``'s component ``idx`` (negative indices
        wrapped)."""
        dims = self.st.decl(name).data_dims
        idx = tuple(i % d for i, d in zip(idx, dims))
        key = f"{name}[{','.join(map(str, idx))}]"
        self.components[key] = (name, idx)
        return key

    def base(self, key: str) -> str:
        """The field of a key (itself, or a component's field)."""
        return self.components[key][0] if key in self.components else key

    def decl(self, key: str) -> ir.FieldDecl:
        """The declaration of a field or a component (no data dimensions)."""
        if key in self.components:
            d = self.st.decl(self.components[key][0])
            return ir.FieldDecl(key, d.dtype, d.dimensions, (), d.is_api)
        return self.st.decl(key) or self.out.decl(key)

    # ---------------- predicated single assignment ---------------- #

    def fresh(self, base: str) -> str:
        return self.new_name.numbered(f"{base}__v")

    def mask_temp(self) -> str:
        name = self.new_name.numbered("_dm")
        self.own.add(name)
        self.out.temp_decls[name] = ir.FieldDecl(name, _BOOL, is_api=False)
        return name

    def bar(self, target: str) -> str:
        if target not in self.bars:
            self.bars[target] = self.new_name(f"{target}__b")
        return self.bars[target]

    def flatten(self, stmts, mask: Optional[str], unit, out: list) -> None:
        """``out`` += ``(kind, name, value, mask, unit)``: ``"mask"`` a bool
        temporary's definition, ``"assign"`` a field's (under ``mask``)."""
        for s in stmts:
            u = unit if unit is not None else s
            if isinstance(s, ir.Assign):
                t = s.target
                # validation.py refuses horizontal and absolute-K targets
                # (_validate_lhs_offsets); a variable-K target, which the
                # frontend never makes, would be a scatter
                assert isinstance(t.offset, ir.CartesianOffset) and not (t.offset.i or t.offset.j)
                key = self.write_key(t)
                if key is None:
                    # a whole-vector write (the cuda backend refuses it) or
                    # a component at a per-point index: a scatter
                    raise Declined(DYNAMIC_INDEX)
                out.append(("assign", key, s.value, mask, u, t.offset.k))
            elif isinstance(s, ir.While):
                raise Declined(WHILE)
            elif isinstance(s, (ir.If, ir.HorizontalRestriction)):
                # the condition is evaluated once, before the body writes
                cond = s.cond if isinstance(s, ir.If) else _region_expr(s.masks)
                raw = self.mask_temp()
                out.append(("mask", raw, cond, None, u, 0))
                inner = raw
                if mask is not None:
                    inner = self.mask_temp()
                    out.append(("mask", inner, _and(ir.FieldAccess(mask), ir.FieldAccess(raw)),
                                None, u, 0))
                self.flatten(s.body, inner, u, out)
                if isinstance(s, ir.If) and s.orelse:
                    other = self.mask_temp()
                    out.append(("mask", other, _and(ir.FieldAccess(mask) if mask else None,
                                                    _not(ir.FieldAccess(raw))), None, u, 0))
                    self.flatten(s.orelse, other, u, out)
            else:
                raise TypeError(f"no adjoint for {type(s).__name__}")

    def levels(self, itv: ir.Interval) -> Tuple[int, int]:
        """A section's levels, in the adjoint's (grown) levels (run-time
        bounds are resolved before: ``resolve_bounds``)."""
        lo, hi = itv.resolve(self.dK)
        return max(lo, 0) + self.kl, min(hi, self.dK) + self.kl

    def leaf(self, e: ir.Expr) -> ir.Expr:
        """A leaf of the forward in the adjoint's levels: the K position
        less the growth below, the K size the call's."""
        if isinstance(e, ir.AxisPosition) and e.axis == "K" and self.kl:
            return _bin(_BO.SUB, ir.AxisPosition("K"), _lit(self.kl, _I64))
        if isinstance(e, ir.AxisSize) and e.axis == "K":
            return _lit(self.dK, _I64)
        return copy.deepcopy(e)

    def write_key(self, t: ir.FieldAccess) -> Optional[str]:
        """The key a write versions: the field, or its component at a
        static index (None: a whole vector or a per-point component)."""
        decl = self.st.decl(t.name)
        if not decl.data_dims:
            return t.name
        idx = tuple(try_static_int(e) for e in t.data_index)
        return None if not idx or None in idx else self.component(t.name, idx)

    def read_key(self, acc: ir.FieldAccess) -> Optional[str]:
        """The key a read binds by: the field, or its component at a static
        index (None: a per-point index into a field a component of which
        is written)."""
        decl = self.st.decl(acc.name)
        if decl is None or not decl.data_dims or not acc.data_index:
            return acc.name
        idx = tuple(try_static_int(e) for e in acc.data_index)
        if None not in idx:
            return self.component(acc.name, idx)
        if any(f == acc.name for f, _ in self.components.values()):
            raise Declined(DYNAMIC_INDEX)
        return acc.name

    def build_forward(self) -> None:
        st = self.st
        if self.periodic:
            if any(isinstance(n, ir.HorizontalRestriction) or
                   (isinstance(n, ir.AxisPosition) and n.axis in self.periodic)
                   for n in ir.walk_values(st.vertical_loops)):
                raise Declined(PERIODIC_POSITION)
        self.loops: List[Tuple[ir.LoopOrder, List[Tuple[Tuple[int, int], List[_Asg]]]]] = []
        # every section bound, and every bound of the levels a write at a K
        # offset covers: a read at K offset c in a section is cut at each
        # bound - c inside it, so no piece reads across a bound (in a
        # PARALLEL section no read at a K offset sees the section's writes,
        # so its pieces run as the section does)
        bounds = {self.kl, self.dK + self.kl}
        written = set()
        for loop in st.vertical_loops:
            for sec in loop.sections:
                lv = self.levels(sec.interval)
                bounds.update(lv)
                for n in ir.walk_values(sec.body):
                    if isinstance(n, ir.Assign):
                        bounds.update(b + n.target.offset.k for b in lv)
                        key = self.write_key(n.target)
                        if key is not None and key not in self.planes:
                            written.add(key)
        # a written field read at a variable or absolute K whose value no
        # wanted input changes is followed in place by a temporary (its
        # reads there are hoisted: ``hoist``); its value from before the
        # call first
        every = (0, self.dK + self.kl + self.kh)
        init = []
        for acc in ir.field_accesses(st.vertical_loops):
            if isinstance(acc.offset, ir.CartesianOffset):
                continue
            key = self.read_key(acc)
            if key not in written or key in self.mirrors or self.base(key) in self.active:
                continue
            m = self.mirrors[key] = self.new_name.numbered(f"{self.base(key)}__m")
            self.own.add(m)
            self.out.temp_decls[m] = _decl(m, self.decl(key), False)
            if self.base(key) in st.field_decls:
                idx = self.components.get(key, (None, ()))[1]
                a = _Asg(m, m, ir.FieldAccess(self.base(key), data_index=tuple(
                    _lit(i, _I64) for i in idx)), every, Extent(), mask=True)
                init.append(a)
                self.asgs.append(a)
        if init:
            self.loops.append((ir.LoopOrder.PARALLEL, [(every, init)]))
        for loop in st.vertical_loops:
            serial = loop.loop_order != ir.LoopOrder.PARALLEL
            secs = []
            for si, sec in enumerate(loop.sections):
                lv = self.levels(sec.interval)
                if lv[1] <= lv[0]:
                    continue
                offs = {a.offset.k for a in ir.field_accesses(sec.body)
                        if isinstance(a.offset, ir.CartesianOffset)}
                cuts = sorted({b - c for b in bounds for c in offs if lv[0] < b - c < lv[1]})
                pieces = list(zip([lv[0]] + cuts, cuts + [lv[1]]))
                if loop.loop_order == ir.LoopOrder.BACKWARD:
                    pieces.reverse()
                for piece in pieces:
                    flat: list = []
                    self.flatten(sec.body, None, None, flat)
                    secs.append((si, piece, flat))
            # a serial loop's versions of each field, one a K offset written
            # at: the last assignment of the field at that offset in each
            # section writes it; its levels are those the writes cover (a
            # piece's levels moved by the offset)
            loop_version: Dict[Tuple[str, int], str] = {}
            cover: Dict[Tuple[str, int], List[Tuple[int, int]]] = {}
            if serial:
                for si, lv, flat in secs:
                    for kind, name, _, _, _, c in flat:
                        if kind != "assign" or name in self.planes:
                            continue
                        if (name, c) not in loop_version:
                            loop_version[(name, c)] = self.fresh(self.base(name))
                            self.shift[loop_version[(name, c)]] = c
                        w = (lv[0] + c, lv[1] + c)
                        if w not in cover.setdefault((name, c), []):
                            cover[(name, c)].append(w)
            # a PARALLEL loop's versions: one an assignment, its pieces' levels
            par: Dict[str, List[str]] = {}
            stmt_version: Dict[Tuple[int, int], str] = {}
            out_secs = []
            for si, lv, flat in secs:
                last = {}
                for n, (kind, name, *_, c) in enumerate(flat):
                    if kind == "assign":
                        last[(name, c)] = n
                #: (key, K offset) -> the version written at this level
                cur: Dict[Tuple[str, int], str] = {}
                asgs: List[_Asg] = []
                for n, (kind, name, value, mask, unit, c) in enumerate(flat):
                    ext = self.fwd.extents.stmt_extent(unit)
                    ext = Extent(i=ext.i, j=ext.j)

                    def resolve(acc, lv=lv, cur=cur, serial=serial, order=loop.loop_order):
                        return self.resolve(acc, lv, cur, par, loop_version, cover, serial,
                                            order)

                    new = self.hoist(_rename(value, resolve, self.leaf), (lv, ext), asgs)
                    if kind == "mask":
                        a = _Asg(name, name, new, lv, ext, mask=True)
                    elif name in self.planes:
                        # a version of its own (read by nothing but the
                        # state's update), the state updated in place
                        target = self.fresh(self.base(name))
                        self.out.temp_decls[target] = _decl(target, self.decl(name), False)
                        if mask is not None:
                            prev = self.hoist(ir.FieldAccess(self.planes[name][0]), (lv, ext),
                                              asgs)
                            new = _sel(ir.FieldAccess(mask), new, prev)
                        a = _Asg(target, name, new, lv, ext, masked=mask is not None,
                                 plane=True, loop=len(self.loops), order=loop.loop_order)
                        asgs.append(a)
                        self.asgs.append(a)
                        st_name = self.planes[name][0]
                        a = _Asg(st_name, st_name, ir.FieldAccess(target), lv, ext, mask=True)
                    else:
                        decl = self.decl(name)
                        if serial and last[(name, c)] == n:
                            target = loop_version[(name, c)]
                        elif serial:
                            target = self.fresh(self.base(name))
                        else:
                            if (si, n) not in stmt_version:
                                stmt_version[(si, n)] = self.fresh(self.base(name))
                            target = stmt_version[(si, n)]
                        self.shift[target] = c
                        # the value the write keeps where its mask is false:
                        # the field's at the level written
                        base, idx = self.components.get(name, (name, ()))
                        prev = self.resolve(
                            ir.FieldAccess(base, ir.CartesianOffset(0, 0, c),
                                           tuple(_lit(i, _I64) for i in idx)),
                            lv, cur, par, loop_version, cover, serial, loop.loop_order)
                        if mask is not None:
                            new = _sel(ir.FieldAccess(mask), new, prev)
                        if target not in self.out.temp_decls:
                            self.out.temp_decls[target] = _decl(target, decl, False)
                        a = _Asg(target, name, new, lv, ext, masked=mask is not None,
                                 prev=None if mask is not None else prev, shift=c,
                                 loop=len(self.loops), order=loop.loop_order)
                        cur[(name, c)] = target
                        if not serial:
                            if target not in par.setdefault(name, []):
                                par[name].append(target)
                            cover.setdefault(target, []).append((lv[0] + c, lv[1] + c))
                        if (self.periodic and base in st.field_decls and any(
                                ext_ax != (0, 0) for ax, ext_ax in (("I", ext.i), ("J", ext.j))
                                if ax in self.periodic)):
                            raise Declined(PERIODIC_WIDE_WRITE)
                    asgs.append(a)
                    self.asgs.append(a)
                    if kind != "mask" and name in self.mirrors:
                        # the mirror's level k + c follows the version's k
                        m = self.mirrors[name]
                        a = _Asg(m, m, ir.FieldAccess(target), lv, ext, mask=True, at=c)
                        asgs.append(a)
                        self.asgs.append(a)
                out_secs.append((lv, asgs))
            self.loops.append((loop.loop_order, out_secs))
            if serial:
                # oldest first: a level is written later at a lower offset
                # in a FORWARD loop, at a higher one in a BACKWARD loop
                up = loop.loop_order == ir.LoopOrder.BACKWARD
                for name, c in sorted(loop_version, key=lambda nc: nc[1] if up else -nc[1]):
                    self.done.setdefault(name, []).append((loop_version[(name, c)],
                                                           cover[(name, c)]))
            else:
                for name, vs in par.items():
                    for v in vs:
                        self.done.setdefault(name, []).append((v, cover[v]))
        self.cover_reads()

    def cover_reads(self) -> None:
        """A compound statement (``if``, region) runs over its own extent,
        which its later statements' offset reads do not grow, and its masked
        writes read the version they overwrite over that extent: such a read
        beyond a write's extent sees the version from before the write (in a
        serial loop, at the level the read reaches).  Every assignment of a
        version so read then carries its extent in its mask (the ternary
        passes the earlier version through), with no extent of its own, and
        so in turn does the version it passes through; on a periodic axis
        that value is no copy of one inside the domain, and the call
        declines."""
        writes: Dict[str, List[_Asg]] = {}
        for a in self.asgs:
            if not a.mask:
                writes.setdefault(a.target, []).append(a)
        todo = set()
        for r in self.asgs:
            for acc in ir.field_accesses(r.value):
                if acc.name not in writes or not isinstance(acc.offset, ir.CartesianOffset):
                    continue
                o = acc.offset
                lo, hi = r.levels[0] + o.k, r.levels[1] + o.k
                for w in writes[acc.name]:
                    if w is r or hi <= w.levels[0] or lo >= w.levels[1]:
                        continue
                    out = {ax for ax, d, (r0, r1), (w0, w1) in (
                        ("I", o.i, r.ext.i, w.ext.i), ("J", o.j, r.ext.j, w.ext.j))
                        if r0 + d < w0 or r1 + d > w1}
                    if out & set(self.periodic):
                        raise Declined(PERIODIC_UNCOVERED)
                    if out:
                        todo.add(w.target)
        while todo:
            for w in writes[todo.pop()]:
                if w.open:
                    continue
                inside = None
                for axis, (e0, e1) in (("I", w.ext.i), ("J", w.ext.j)):
                    inside = _and(inside, _and(
                        _bin(_BO.GE, ir.AxisPosition(axis), _lit(e0, _I64)),
                        _bin(_BO.LT, ir.AxisPosition(axis),
                             _bin(_BO.ADD, ir.AxisSize(axis), _lit(e1, _I64)))))
                if w.masked:
                    w.value.cond = _and(w.value.cond, inside)
                    prev = w.value.false_expr
                else:
                    w.value = _sel(inside, w.value, w.prev)
                    prev = w.prev
                w.open = True
                if isinstance(prev, ir.FieldAccess) and prev.name in writes:
                    todo.add(prev.name)

    def hoist(self, value: ir.Expr, at, asgs: List[_Asg]) -> ir.Expr:
        """``value`` with each variable- or absolute-K read moved into a
        temporary of its own computed at the point (``asgs`` += its
        assignment, which carries no derivative), so that a partial holding
        the read can be shifted; the read field's gradient must not be
        wanted (a scatter or a reduction over K)."""
        def move(acc):
            if acc.name in self.state:
                # a written lower-dimensional field's value at the time
                t = self.new_name.numbered("_dr")
                self.own.add(t)
                self.out.temp_decls[t] = ir.FieldDecl(t, np.dtype(self.decl(acc.name).dtype),
                                                      is_api=False)
                self.snaps[t] = (self.state[acc.name], (acc.offset.i, acc.offset.j))
                a = _Asg(t, t, acc, *at, mask=True)
                asgs.append(a)
                self.asgs.append(a)
                return ir.FieldAccess(t)
            if isinstance(acc.offset, ir.CartesianOffset):
                return acc
            if acc.name in self.wanted:
                raise Declined(VARIABLE_K if isinstance(acc.offset, ir.VariableKOffset)
                               else ABSOLUTE_K)
            t = self.new_name.numbered("_dr")
            self.own.add(t)
            self.out.temp_decls[t] = ir.FieldDecl(t, np.dtype(self.decl(acc.name).dtype),
                                                  is_api=False)
            a = _Asg(t, t, acc, *at, mask=True)
            asgs.append(a)
            self.asgs.append(a)
            return ir.FieldAccess(t)

        return _rename(value, move, lambda e: e)

    def resolve(self, acc: ir.FieldAccess, lv, cur, par, loop_version, cover, serial, order):
        """The version (a FieldAccess, or a zero literal for a temporary
        never written) a read binds to."""
        name = acc.name
        if name in self.own:
            return acc
        key = self.read_key(acc)
        if name in self.plane_fields:
            if key not in self.planes:
                # the whole vector of a field written a component at a time
                raise Declined(DYNAMIC_INDEX)
            return ir.FieldAccess(self.planes[key][0], ir.CartesianOffset(
                acc.offset.i, acc.offset.j, 0))
        written = key in self.done or key in cur or key in loop_version or key in par
        off = acc.offset
        if not isinstance(off, ir.CartesianOffset):
            if key in self.mirrors:
                acc = ir.FieldAccess(self.mirrors[key], off)
            elif written:
                # the field's value depends on a wanted input: the read's bar
                # is a scatter (variable K) or a reduction over K
                raise Declined(VARIABLE_K if isinstance(off, ir.VariableKOffset)
                               else ABSOLUTE_K)
            if isinstance(off, ir.AbsoluteKIndex) and self.kl:
                off.k = _bin(_BO.ADD, off.k, _lit(self.kl, _I64))
            return acc
        c = off.k
        # the levels of the field the read covers
        r = (lv[0] + c, lv[1] + c)

        def bind(version):
            s = self.shift.get(version, 0)
            return ir.FieldAccess(version, ir.CartesianOffset(off.i, off.j, c - s),
                                  () if key in self.components else acc.data_index)

        if serial:
            # level k of the loop's version at offset s holds the field's
            # level k + s: the read sees the newest write of its levels, at
            # its own offset earlier at this level, else at the offset
            # nearest its own among those whose level the sweep has passed
            if (key, c) in cur:
                return bind(cur[(key, c)])
            fwd = order == ir.LoopOrder.FORWARD
            for s in sorted((s for k, s in loop_version if k == key and (s > c if fwd else s < c)),
                            key=lambda s: abs(s - c)):
                rel = _relation(r, cover[(key, s)])
                if rel == "in":
                    return bind(loop_version[(key, s)])
                assert rel == "out", _UNCUT
        else:
            for v in reversed(par.get(key, [])):
                rel = _relation(r, cover[v])
                if rel == "in":
                    return bind(v)
                assert rel == "out", _UNCUT
        for v, cov in reversed(self.done.get(key, [])):
            rel = _relation(r, cov)
            if rel == "in":
                return bind(v)
            assert rel == "out", _UNCUT
        if name in self.st.field_decls:
            return acc
        return _lit(0, self.st.decl(name).dtype)

    # ---------------- guards ---------------- #

    def in_box(self, a: Tuple[int, int, int], box: _Asg, levels: Tuple[int, int],
               region: Extent):
        """Conjuncts of "the point minus ``a`` lies in ``box``' region"
        over the statement's ``levels`` and horizontal ``region``: ``[]``
        when always true there, None when never."""
        conj = []
        lo, hi = box.levels
        k0, k1 = levels[0] - a[2], levels[1] - a[2]
        if k1 <= lo or k0 >= hi:
            return None
        kpos = _pos_shift("K", -a[2])
        if k0 < lo:
            conj.append(_bin(_BO.GE, kpos, _lit(lo, _I64)))
        if k1 > hi:
            conj.append(_bin(_BO.LT, kpos, _lit(hi, _I64)))
        if box.open:
            return conj
        for axis, d, (e0, e1), (n0, n1) in (("I", a[0], box.ext.i, region.i),
                                            ("J", a[1], box.ext.j, region.j)):
            if axis in self.periodic:
                continue
            pos = _pos_shift(axis, -d)
            if n0 - d < e0:
                conj.append(_bin(_BO.GE, pos, _lit(e0, _I64)))
            if n1 - d > e1:
                conj.append(_bin(_BO.LT, pos, _bin(_BO.ADD, ir.AxisSize(axis), _lit(e1, _I64))))
        return conj

    def guarded(self, conj, term, dt):
        if not conj:
            return term
        cond = conj[0]
        for c in conj[1:]:
            cond = _and(cond, c)
        return _sel(cond, term, _lit(0, dt))

    def later(self, b: _Asg, a: _Asg) -> bool:
        """Whether ``b`` writes a level of their field after ``a`` writes
        it: in a later loop, or in one serial loop at an offset the sweep
        reaches the level with later (a lower one in a FORWARD loop, a
        higher one in a BACKWARD loop), else later in the statements'
        order."""
        if b.loop != a.loop:
            return b.loop > a.loop
        if b.shift != a.shift and b.order != ir.LoopOrder.PARALLEL:
            return (b.shift < a.shift) == (b.order == ir.LoopOrder.FORWARD)
        return self.position[id(b)] > self.position[id(a)]

    def passthrough(self, key: str, after: Optional[_Asg], levels, region, dt, s: int = 0):
        """The cotangent of field (or component) ``key`` at its levels
        moved by ``s`` where no assignment that writes after ``after``
        (None: any) wrote the point; None: nowhere.  A field that lacks I
        or J has its cotangent at the domain's first point of the axis
        alone: every point of the axis computes the same value, which the
        caller sums (``Derivative.sums``)."""
        cond = None
        for a in self.asgs:
            if a.mask or a.field != key or (after is not None and not self.later(a, after)):
                continue
            conj = self.in_box((0, 0, a.shift - s), a, levels, region)
            if conj is None:
                continue
            if not conj:
                return None
            inside = conj[0]
            for c in conj[1:]:
                inside = _and(inside, c)
            cond = _and(cond, _not(inside))
        base, idx = self.components.get(key, (key, ()))
        for axis, has in zip("IJ", self.st.decl(base).dimensions):
            if not has:
                cond = _and(cond, _bin(_BO.EQ, ir.AxisPosition(axis), _lit(0, _I64)))
        cot = ir.FieldAccess(self.cots[base], ir.CartesianOffset(0, 0, s),
                             tuple(_lit(i, _I64) for i in idx))
        return cot if cond is None else _sel(cond, cot, _lit(0, dt))

    # ---------------- the adjoint ---------------- #

    def contributions(self, a: _Asg):
        """``(read, contribution)`` of ``a``'s value, seeded by its bar."""
        got = self._contrib.get(id(a))
        if got is None:
            got = []
            if not a.mask and is_float_dtype(self.decl(a.field).dtype):
                seed = ir.FieldAccess(self.bar(a.target))
                self.rules.adjoint(a.value, seed, got)
            self._contrib[id(a)] = got
        return got

    def readers(self) -> Dict[str, list]:
        """Name -> ``(assignment, read, contribution)`` of every read."""
        if self._readers is None:
            self._readers = {}
            for a in self.asgs:
                for read, contrib in self.contributions(a):
                    self._readers.setdefault(read.name, []).append((a, read, contrib))
        return self._readers

    def terms(self, name: str, component, levels, region, dt):
        """The gathered terms of the bar of version (or API field) ``name``
        (data index ``component``) over ``levels`` and ``region``."""
        total = None
        for a, read, contrib in self.readers().get(name, ()):
            if not isinstance(read, ir.FieldAccess):
                continue
            if isinstance(read.offset, ir.VariableKOffset):
                raise Declined(VARIABLE_K)
            if isinstance(read.offset, ir.AbsoluteKIndex):
                raise Declined(ABSOLUTE_K)
            idx = tuple(try_static_int(e) for e in read.data_index)
            if None in idx:
                raise Declined(DYNAMIC_INDEX)
            idx = tuple(i % n for i, n in zip(idx, self.decl(name).data_dims))
            if idx != component:
                continue
            # a lower-dimensional field's read is the same on the axes it
            # lacks: its per-point contribution lies at the reading point
            dims = self.decl(name).dimensions
            o = tuple(d if has else 0 for d, has in zip(
                (read.offset.i, read.offset.j, read.offset.k), dims))
            conj = self.in_box(o, a, levels, region)
            if conj is None:
                continue
            term = shift(contrib, (-o[0], -o[1], -o[2]))
            tdt = self.rules.dtype(contrib)
            total = _add(total, self.rules.cast(self.guarded(conj, term, tdt), tdt, dt))
        return total

    def plane_bar(self, a: _Asg, bar: ir.FieldAccess, dt, min_ext) -> List[ir.Assign]:
        """The bar of a lower-dimensional field's write: its bar's value
        where the write writes, which the bar then gives up there."""
        conj = self.in_box((0, 0, 0), a, a.levels, _EVERYWHERE)
        fb = self.planes[a.field][1]
        take = ir.Assign(bar, self.guarded(conj, ir.FieldAccess(fb), dt))
        zero = _lit(0, dt)
        reset = ir.Assign(ir.FieldAccess(fb), zero if not conj else
                          _sel(self.guarded(conj, _lit(True, _BOOL), _BOOL),
                               zero, ir.FieldAccess(fb)))
        min_ext[id(reset)] = a.ext
        return [take, reset]

    def accumulate(self, a: _Asg, min_ext) -> List[ir.Assign]:
        """``a``'s contributions to the lower-dimensional fields its value
        reads, added into their bars in place (over each field's extent)."""
        by: Dict[str, ir.Expr] = {}
        for read, contrib in self.contributions(a):
            if read.name not in self.snaps:
                continue
            field, (oi, oj) = self.snaps[read.name]
            # the bar's statements run as far as its readers reach
            conj = self.in_box((oi, oj, 0), a, a.levels, _EVERYWHERE)
            if conj is None:
                continue
            dt = np.dtype(self.decl(field).dtype)
            tdt = self.rules.dtype(contrib)
            term = self.guarded(conj, shift(contrib, (-oi, -oj, 0)), tdt)
            by[field] = _add(by.get(field), self.rules.cast(term, tdt, dt))
        out = []
        for field, total in by.items():
            fb = self.planes[field][1]
            s = ir.Assign(ir.FieldAccess(fb), _add(ir.FieldAccess(fb), total))
            min_ext[id(s)] = self.fwd.extents.field_extent(self.base(field))
            out.append(s)
        return out

    def build(self) -> Derivative:
        st, out = self.st, self.out
        written = [n for n, i in self.fwd.field_info.items() if i.access.value & 2]
        self.cots = {n: self.new_name(f"{n}__c") for n in written
                     if is_float_dtype(st.field_decls[n].dtype)}
        fields = [n for n in st.field_decls if n in self.wanted]
        scalars = [n for n in st.scalar_decls if n in self.wanted]
        grads = {n: self.new_name(f"{n}__g") for n in fields if n not in self.plane_fields}
        contribs = {n: self.new_name(f"{n}__g") for n in scalars}
        out.field_decls = {n: copy.deepcopy(d) for n, d in st.field_decls.items()}
        for n in st.field_decls:
            out.field_decls[n].is_api = True
        for n, c in self.cots.items():
            if n not in self.plane_fields:
                out.field_decls[c] = _decl(c, st.field_decls[n], True)
        for key, names in self.planes.items():
            for x in names:
                out.field_decls[x] = _decl(x, self.decl(key), True)
                out.field_decls[x].dimensions = (True, True, False)
        for n, g in grads.items():
            out.field_decls[g] = _decl(g, st.field_decls[n], True)
            # a lower-dimensional field's gradient: a per-point contribution
            # on every axis, which the caller sums over the axes it lacks
            out.field_decls[g].dimensions = (True, True, True)
        for n, g in contribs.items():
            out.field_decls[g] = ir.FieldDecl(g, np.dtype(st.scalar_decls[n].dtype or np.float64))
        out.api_params = [ir.ApiParam(n, is_field=True) for n in out.field_decls] + \
            [ir.ApiParam(n, is_field=False) for n in st.scalar_decls]
        self.build_forward()
        self.rules = _Rules(out)
        self._contrib: Dict[int, list] = {}
        self._readers: Optional[Dict[str, list]] = None
        for a in self.asgs:
            if not a.mask and is_float_dtype(self.decl(a.field).dtype):
                bar = self.bar(a.target)
                out.temp_decls.setdefault(bar, _decl(bar, self.decl(a.field), False))
        loops: List[ir.VerticalLoop] = []
        # the recomputed forward
        for order, secs in self.loops:
            loops.append(ir.VerticalLoop(order, [
                ir.VerticalSection(ir.Interval(ir.AxisBound.start(lv[0]), ir.AxisBound.start(lv[1])),
                                   [ir.Assign(ir.FieldAccess(a.target,
                                                             ir.CartesianOffset(0, 0, a.at)),
                                              a.value) for a in asgs])
                for lv, asgs in secs]))
        # the adjoint loops
        self.position = {id(a): n for n, a in enumerate(self.asgs)}
        flip = {ir.LoopOrder.FORWARD: ir.LoopOrder.BACKWARD,
                ir.LoopOrder.BACKWARD: ir.LoopOrder.FORWARD,
                ir.LoopOrder.PARALLEL: ir.LoopOrder.PARALLEL}
        min_ext = {}
        for order, secs in reversed(self.loops):
            new_secs = []
            for lv, asgs in reversed(secs):
                itv = ir.Interval(ir.AxisBound.start(lv[0]), ir.AxisBound.start(lv[1]))
                body = []
                for a in reversed(asgs):
                    if a.mask or not is_float_dtype(self.decl(a.field).dtype):
                        continue
                    dt = np.dtype(self.decl(a.field).dtype)
                    bar = ir.FieldAccess(self.bar(a.target))
                    if a.plane:
                        body.extend(self.plane_bar(a, bar, dt, min_ext))
                    else:
                        # an open assignment's bar is read beyond its extent
                        region = _EVERYWHERE if a.open else a.ext
                        value = self.terms(a.target, (), a.levels, region, dt)
                        if self.base(a.field) in self.cots:
                            value = _add(value, self.passthrough(
                                a.field, a, a.levels, region, dt, a.shift))
                        body.append(ir.Assign(bar, value if value is not None else _lit(0, dt)))
                    acc = self.accumulate(a, min_ext)
                    if not acc:
                        continue
                    if order != ir.LoopOrder.PARALLEL or lv[1] - lv[0] == 1:
                        body.extend(acc)
                        continue
                    # a bar accumulated over the levels of a PARALLEL
                    # section: a FORWARD loop of its own between the
                    # section's statements before and after
                    new_secs.append(ir.VerticalSection(itv, body))
                    loops.append(ir.VerticalLoop(ir.LoopOrder.PARALLEL, new_secs))
                    loops.append(ir.VerticalLoop(ir.LoopOrder.FORWARD,
                                                 [ir.VerticalSection(itv, acc)]))
                    new_secs, body = [], []
                if body:
                    new_secs.append(ir.VerticalSection(itv, body))
            if new_secs:
                loops.append(ir.VerticalLoop(flip[order], new_secs))
        # the gradients (each over its field's levels, its K halo included)
        # and the scalars' contributions (over every level), a PARALLEL loop
        # a range of levels
        final: Dict[Tuple[int, int], list] = {}
        every = (0, self.dK + self.kl + self.kh)
        kb = compute_k_boundary_resolved(st, self.dK, names=list(grads), extents=self.fwd.extents)
        sums = {}
        for n, g in grads.items():
            decl = st.field_decls[n]
            lv = (self.kl - kb[n][0], self.kl + self.dK + kb[n][1])
            for a in self.asgs:  # the levels written at a K offset
                if not a.mask and self.base(a.field) == n:
                    lv = (min(lv[0], a.levels[0] + a.shift), max(lv[1], a.levels[1] + a.shift))
            fe = self.fwd.extents.field_extent(n) | self.fwd.extents.write_extent(n)
            if not all(decl.dimensions):
                # summed over the axes the field lacks: there, over every
                # level and the extents of the statements reading it
                lacks = tuple(ax for ax, has in zip("IJK", decl.dimensions) if not has)
                for a, _, _ in self.readers().get(n, ()):
                    fe = fe | Extent(i=a.ext.i if "I" in lacks else (0, 0),
                                     j=a.ext.j if "J" in lacks else (0, 0))
                if "K" in lacks:
                    lv = every
            region = Extent(i=(0, 0) if "I" in self.periodic else fe.i,
                            j=(0, 0) if "J" in self.periodic else fe.j)
            if not all(decl.dimensions):
                sums[n] = (lacks, region, lv)
            dt = np.dtype(decl.dtype)
            comps = [()] if not decl.data_dims else \
                [tuple(c) for c in np.ndindex(*decl.data_dims)]
            for comp in comps:
                value = self.terms(n, comp, lv, region, dt)
                if n in self.cots:
                    key = self.component(n, comp) if comp else n
                    value = _add(value, self.passthrough(key, None, lv, region, dt))
                target = ir.FieldAccess(g, data_index=tuple(_lit(c, _I64) for c in comp))
                s = ir.Assign(target, value if value is not None else _lit(0, dt))
                final.setdefault(lv, []).append(s)
                min_ext[id(s)] = region
        contrib_extent = {}
        for n, g in contribs.items():
            dt = np.dtype(out.field_decls[g].dtype)
            total, region = None, Extent()
            uses = [(a, c) for a, read, c in self.readers().get(n, ())
                    if isinstance(read, ir.ScalarAccess)]
            for a, _ in uses:
                region = region | Extent(i=a.ext.i, j=a.ext.j)
            region = Extent(i=(0, 0) if "I" in self.periodic else region.i,
                            j=(0, 0) if "J" in self.periodic else region.j)
            for a, contrib in uses:
                conj = self.in_box((0, 0, 0), a, every, region)
                if conj is None:
                    continue
                tdt = self.rules.dtype(contrib)
                total = _add(total, self.rules.cast(self.guarded(conj, contrib, tdt), tdt, dt))
            s = ir.Assign(ir.FieldAccess(g), total if total is not None else _lit(0, dt))
            final.setdefault(every, []).append(s)
            min_ext[id(s)] = region
            contrib_extent[n] = region
        for lv, body in final.items():
            loops.append(ir.VerticalLoop(ir.LoopOrder.PARALLEL, [ir.VerticalSection(
                ir.Interval(ir.AxisBound.start(lv[0]), ir.AxisBound.start(lv[1])), body)]))
        out.vertical_loops = _merge_parallel(_prune(loops, set(out.field_decls)))
        for loop in out.vertical_loops:  # no node shared between statements
            for sec in loop.sections:
                for stmt in sec.body:
                    stmt.value = copy.deepcopy(stmt.value)
        out.temp_decls = {n: d for n, d in out.temp_decls.items()
                          if any(isinstance(x, ir.FieldAccess) and x.name == n
                                 for x in ir.walk_values(out.vertical_loops))}
        analysis = analyze(out, min_extents=min_ext, validate=False)
        planes: Dict[str, Dict[Tuple[int, ...], Tuple[str, str]]] = {}
        for key, names in self.planes.items():
            base, idx = self.components.get(key, (key, ()))
            planes.setdefault(base, {})[idx] = names
        # a written field that lacks K: its gradient, which the caller
        # makes from the bars
        grads.update({n: self.new_name(f"{n}__g") for n in fields if n in planes})
        d = Derivative("adjoint", analysis, cots=self.cots, grads=grads, contribs=contribs,
                       contrib_extent=contrib_extent,
                       passthrough=tuple(n for n in grads if n in self.cots
                                         and n not in planes),
                       k_grow=(self.kl, self.kh), sums=sums, planes=planes)
        d.reach = read_boundary(d, every[1])
        for names in self.planes.values():
            for x in names:
                e = analysis.extents.field_extent(x)
                d.reach[x] = ((-e.i[0], e.i[1]), (-e.j[0], e.j[1]), (0, 0))
        return d


def _prune(loops: List[ir.VerticalLoop], api: set) -> List[ir.VerticalLoop]:
    """Drop assignments to temporaries nothing kept reads (fixpoint), then
    empty sections and loops."""
    stmts = [s for loop in loops for sec in loop.sections for s in sec.body]
    needed = set()
    keep = {id(s) for s in stmts if s.target.name in api}
    changed = True
    while changed:
        changed = False
        for s in stmts:
            if id(s) in keep or s.target.name in needed:
                if id(s) not in keep:
                    keep.add(id(s))
                    changed = True
                for n in ir.walk_values(s.value):
                    if isinstance(n, ir.FieldAccess) and n.name not in needed:
                        needed.add(n.name)
                        changed = True
    out = []
    for loop in loops:
        secs = [ir.VerticalSection(sec.interval, [s for s in sec.body if id(s) in keep])
                for sec in loop.sections]
        secs = [s for s in secs if s.body]
        if secs:
            out.append(ir.VerticalLoop(loop.loop_order, secs))
    return out


def _merge_parallel(loops: List[ir.VerticalLoop]) -> List[ir.VerticalLoop]:
    """Adjacent PARALLEL loops over the same intervals as one loop (its
    sections' statements in order), so one kernel runs them."""
    out: List[ir.VerticalLoop] = []
    for loop in loops:
        prev = out[-1] if out else None
        if prev is not None and prev.loop_order == loop.loop_order == ir.LoopOrder.PARALLEL and \
                [s.interval for s in prev.sections] == [s.interval for s in loop.sections]:
            out[-1] = ir.VerticalLoop(ir.LoopOrder.PARALLEL, [
                ir.VerticalSection(a.interval, a.body + b.body)
                for a, b in zip(prev.sections, loop.sections)])
        else:
            out.append(loop)
    return out


#: the torus does not hold: the values beyond the domain are no copies
_NOT_A_TORUS = (PERIODIC_POSITION, PERIODIC_WIDE_WRITE, PERIODIC_UNCOVERED)


def adjoint_stencil(analysis: StencilAnalysis, wanted: Sequence[str], dK: int,
                    periodic: Sequence[str] = (), bounds: Optional[Dict[str, int]] = None
                    ) -> Derivative:
    """The adjoint stencil of ``analysis``' stencil for the fields and
    tensor scalars ``wanted``, for a call on ``dK`` levels (it runs on
    ``dK + sum(k_grow)`` levels, every field's origin ``k_grow[0]`` lower),
    periodic on ``periodic``: on the torus, or where that does not hold
    (regions, I/J positions, writes or compound statements' reads beyond
    the domain) bounded, on filled copies (``Derivative.fill``).
    ``bounds``: the call's values of the scalars that give interval bounds
    at run time (``runtime_bounds``); the adjoint is built for them."""
    analysis = resolve_bounds(analysis, bounds or {})
    try:
        return _Adjoint(analysis, wanted, dK, periodic).build()
    except Declined as e:
        if not periodic or str(e) not in _NOT_A_TORUS:
            raise
    d = _Adjoint(analysis, wanted, dK, ()).build()
    d.fill = tuple(periodic)
    return d


def read_boundary(d: Derivative, dK: int) -> Dict[str, Tuple[Tuple[int, int], ...]]:
    """Per API field the derivative stencil only reads: how far its reads
    reach beyond its domain of ``dK`` levels, ``((i_lo, i_hi), (j_lo, j_hi),
    (k_lo, k_hi))`` (non-negative)."""
    an = d.analysis
    kb = compute_k_boundary_resolved(an.stencil, dK, names=list(an.stencil.field_decls),
                                     extents=an.extents)
    out = {}
    for n, info in an.field_info.items():
        if info.access.value & 2:
            continue
        e = an.extents.field_extent(n)
        out[n] = ((-e.i[0], e.i[1]), (-e.j[0], e.j[1]), kb.get(n, (0, 0)))
    return out
