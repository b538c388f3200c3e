"""Lower next field operators, scans and programs onto the CUDA kernels.

The counterpart of ``gt4py_tpu.next.pallas_bridge`` (K10 in the kernel
table: ``lower_field_operator`` pallas_bridge.py:906 with ``run_plan``
:1275, ``lower_scan_operator`` :1516 with ``run_scan_plan`` :1673,
``lower_program`` :1987 with ``prepare_program_plan`` :2577 and
``execute_program_instance`` :2600).  The reference dispatches field
operators to compiled program processors (gtfn C++ codegen, dace SDFGs --
src/gt4py/next/program_processors/); here the typed field-view IR (fvir)
is LOWERED to the cartesian stencil IR and run by the cartesian
``"cuda"`` backend (``cartesian/backend/cuda_backend.py``): the row-form
kernels for PARALLEL bodies, the column-form kernels for scans, generated
as CUDA C++, built with nvcc for sm_90a and loaded with ctypes.  On CPU
tensors that backend runs its plain executor instead.

The lowering half is the JAX package's, unchanged: eligible subset,
inlining of operator calls, ``concat_where`` as K-sectioned vertical
loops, scans as FORWARD/BACKWARD loops whose carry at level k is the out
field at k-+1, programs as one fused stencil per run of eligible
statements with thin restricted runs ("strips") completing each
intermediate's halo.  Anything outside the subset raises
:class:`Ineligible` and the caller runs the operator embedded (recorded in
``FALLBACK_EVENTS``).  Nothing else falls back: a build, launch or
generator error raises.

Domain semantics replicate the embedded executor exactly: the result
domain is the intersection of every argument's domain shrunk by that
argument's read extents, and weak-literal operands are cast to the typing
rule's deduced operand kind at the same places the interpreter casts.

The run half hands each kernel logical (I, J, K) views of the fields'
tensors -- the dims permuted into I, J, K order and a size-1 axis for each
missing one, never a copy -- with per-axis origins; outputs are fresh
tensors with K outermost in memory and J contiguous.  The domain
arithmetic of a call is cached per argument domains (and ``domain=``
restriction), so a repeated call does no planning on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from gt4py_tpu_torch import config
from gt4py_tpu_torch.cartesian import ir
from gt4py_tpu_torch.cartesian.analysis import analyze, compute_k_boundary_resolved
from gt4py_tpu_torch.cartesian.backend.cuda_backend import CudaBackend
from gt4py_tpu_torch.core import dtypes
from gt4py_tpu_torch.core.events import EventLog

from . import fvir
from . import type_system as ts
from .builtins import FIELD_BUILTINS
from .common import Dimension, DimensionKind, Domain, Field, UnitRange

#: the TPU kernel front end this module replaces (file:line in the JAX package)
REPLACES = (
    "gt4py_tpu/next/pallas_bridge.py:906 lower_field_operator + :1275 run_plan, "
    ":1516 lower_scan_operator + :1673 run_scan_plan, :1987 lower_program + "
    ":2600 execute_program_instance (K10, onto the K1/K2 kernels)"
)


class Ineligible(Exception):
    """The operator uses features outside the cartesian-kernel subset."""


#: observable record of operators that ran embedded instead of on the
#: kernels: (operator name, reason).  Bounded; diff with
#: FALLBACK_EVENTS.cursor()/.since() (trim-stable), and
#: FALLBACK_EVENTS.total counts every fallback ever recorded.
FALLBACK_EVENTS: EventLog = EventLog()


def _record_fallback(name: str, reason: str, warn: bool = True) -> None:
    FALLBACK_EVENTS.record((name, reason))
    if warn:
        config.warn_fallback(f"next operator '{name}'", reason)


#: next math-builtin name -> cartesian NativeFunction
_MATH_MAP = {
    "abs": ir.NativeFunction.ABS,
    "minimum": ir.NativeFunction.MIN,
    "maximum": ir.NativeFunction.MAX,
    "fmod": ir.NativeFunction.MOD,
    "power": ir.NativeFunction.POW,
    "sin": ir.NativeFunction.SIN,
    "cos": ir.NativeFunction.COS,
    "tan": ir.NativeFunction.TAN,
    "arcsin": ir.NativeFunction.ARCSIN,
    "arccos": ir.NativeFunction.ARCCOS,
    "arctan": ir.NativeFunction.ARCTAN,
    "sinh": ir.NativeFunction.SINH,
    "cosh": ir.NativeFunction.COSH,
    "tanh": ir.NativeFunction.TANH,
    "arcsinh": ir.NativeFunction.ARCSINH,
    "arccosh": ir.NativeFunction.ARCCOSH,
    "arctanh": ir.NativeFunction.ARCTANH,
    "sqrt": ir.NativeFunction.SQRT,
    "exp": ir.NativeFunction.EXP,
    "log": ir.NativeFunction.LOG,
    "log10": ir.NativeFunction.LOG10,
    "log2": ir.NativeFunction.LOG2,
    "gamma": ir.NativeFunction.GAMMA,
    "cbrt": ir.NativeFunction.CBRT,
    "isfinite": ir.NativeFunction.ISFINITE,
    "isinf": ir.NativeFunction.ISINF,
    "isnan": ir.NativeFunction.ISNAN,
    "floor": ir.NativeFunction.FLOOR,
    "ceil": ir.NativeFunction.CEIL,
    "trunc": ir.NativeFunction.TRUNC,
}

_BINOPS = {
    "add": ir.BinaryOperator.ADD,
    "sub": ir.BinaryOperator.SUB,
    "mult": ir.BinaryOperator.MUL,
    "div": ir.BinaryOperator.DIV,
    "floordiv": ir.BinaryOperator.FLOOR_DIV,
    "mod": ir.BinaryOperator.MOD,
    "pow": ir.BinaryOperator.POW,
}
_CMPOPS = {
    "lt": ir.BinaryOperator.LT,
    "le": ir.BinaryOperator.LE,
    "gt": ir.BinaryOperator.GT,
    "ge": ir.BinaryOperator.GE,
    "eq": ir.BinaryOperator.EQ,
    "ne": ir.BinaryOperator.NE,
}

_AXES = ("I", "J", "K")


@dataclasses.dataclass
class CwSlot:
    """A ``concat_where`` occurrence hoisted to a temporary: per vertical
    region the temp is assigned the true or false branch (the lowering
    becomes K-partitioned vertical sections at instantiation time --
    reference: iterator/transforms/concat_where/ lowers to
    domain-partitioned SetAts)."""

    target: str
    #: condition range [lo, hi) along the vertical dim, absolute next
    #: coordinates; None = unbounded on that side
    lo: Optional[int]
    hi: Optional[int]
    t_expr: ir.Expr = None
    f_expr: ir.Expr = None


@dataclasses.dataclass
class BridgePlan:
    """A lowered operator plus everything the runner needs."""

    stencil: ir.Stencil
    analysis: Any
    backend: Any  # CudaBackend
    #: Dimension.value -> axis index 0/1/2 (I/J/K)
    axis_of: Dict[str, int]
    #: per field param: (name, dims tuple as declared, (has_i, has_j, has_k))
    field_params: List[Tuple[str, Tuple[Dimension, ...], Tuple[bool, bool, bool]]]
    scalar_params: List[str]
    #: one entry per returned field (several for tuple returns):
    #: (out name, dims in declared order, axis mask, dtype)
    outs: List[Tuple[str, Tuple[Dimension, ...], Tuple[bool, bool, bool], np.dtype]]
    is_tuple: bool
    #: parameter names in the operator's declared signature order
    signature_order: List[str] = dataclasses.field(default_factory=list)
    #: concat_where plans: the mixed statement/CwSlot body (None for
    #: plain operators -- then ``stencil``/``backend`` are final), the
    #: per-temp/per-out K-domain recipes replicating the embedded domain
    #: algebra, and the per-K-partition instantiation cache
    cw_body: Optional[List[Any]] = None
    recipes: Optional[Dict[str, Any]] = None
    out_recipes: Optional[List[Any]] = None
    cw_cache: Dict[Any, Any] = dataclasses.field(default_factory=dict)
    #: run_plan's domain arithmetic per (argument domains, restriction)
    run_cache: Dict[Any, Any] = dataclasses.field(default_factory=dict)


def _np_dtype(t) -> np.dtype:
    if isinstance(t, ts.ScalarType):
        return np.dtype(t.kind)
    if isinstance(t, ts.FieldType):
        return np.dtype(t.dtype.kind)
    raise Ineligible(f"no dtype for {t}")


class _Lowerer:
    """Lowers one operator scope; operator CALLS inline through child
    lowerers that share the root's declarations/axis map but keep their
    own name scope (param substitutions, renamed temps, callee closure)."""

    def __init__(self, typed: fvir.OperatorIR, parent: "_Lowerer" = None):
        self.typed = typed
        #: scan mode: the carry parameter's name, and the per-element
        #: substitution (element index -> ir.Expr; scalar carries use 0)
        self.carry_name: Optional[str] = None
        self.carry_subst: Dict[int, ir.Expr] = {}
        # per-scope name environment
        self.field_names: set = set()
        self.scalar_names: set = set()
        #: callee temps renamed to collision-free stencil temp names
        self.rename: Dict[str, str] = {}
        #: callee params bound to caller-side lowered expressions
        self.param_subst: Dict[str, ir.Expr] = {}
        #: runtime dims ORDER per field-valued name (the embedded executor
        #: merges dims in first-seen operand order, which the type
        #: deduction canonicalizes away -- results must match the
        #: embedded backend's order exactly)
        self.dims_env: Dict[str, Tuple[Dimension, ...]] = {}
        if parent is None:
            self.axis_of: Dict[str, int] = {}
            self.temp_decls: Dict[str, ir.FieldDecl] = {}
            self.field_decls: Dict[str, ir.FieldDecl] = {}
            self.scalar_decls: Dict[str, ir.ScalarDecl] = {}
            #: hoisted temp assignments (inlined callee bodies,
            #: materialized shift bases) flushed before the statement
            #: whose expression produced them
            self.pending: List[ir.Stmt] = []
            #: embedded dims order per inlined Call node (by identity)
            self.call_dims: Dict[int, Optional[Tuple[Dimension, ...]]] = {}
            self._uid = [0]
            self._depth = 0
        else:
            self.axis_of = parent.axis_of
            self.temp_decls = parent.temp_decls
            self.field_decls = parent.field_decls
            self.scalar_decls = parent.scalar_decls
            self.pending = parent.pending
            self.call_dims = parent.call_dims
            self._uid = parent._uid
            self._depth = parent._depth + 1

    # ---- dimension bookkeeping ---- #

    def _register_dims(self, dims: Tuple[Dimension, ...]) -> None:
        for d in dims:
            if d.kind == DimensionKind.LOCAL:
                raise Ineligible("local (sparse) dimension")
            if d.value in self.axis_of:
                continue
            if d.kind == DimensionKind.VERTICAL:
                if 2 in self.axis_of.values():
                    raise Ineligible("more than one vertical dimension")
                self.axis_of[d.value] = 2
            else:
                horiz = sorted(a for a in self.axis_of.values() if a < 2)
                if len(horiz) >= 2:
                    raise Ineligible("more than two horizontal dimensions")
                self.axis_of[d.value] = 0 if 0 not in self.axis_of.values() else 1
        # reject duplicate dims
        if len({d.value for d in dims}) != len(dims):
            raise Ineligible("repeated dimension")

    def _mask(self, dims: Tuple[Dimension, ...]) -> Tuple[bool, bool, bool]:
        axes = {self.axis_of[d.value] for d in dims}
        return (0 in axes, 1 in axes, 2 in axes)

    # ---- expression lowering ---- #

    def _resolve_name(self, node: fvir.Name):
        if node.id in self.rename:  # this scope's (possibly renamed) temps
            return ("field", self.rename[node.id])
        if node.id in self.field_names:
            return ("field", node.id)
        if node.id in self.scalar_names:
            return ("scalar", node.id)
        if node.id in self.typed.closure:
            return ("closure", self.typed.closure[node.id])
        raise Ineligible(f"unresolved name '{node.id}'")

    def _expr(self, node: fvir.Expr) -> ir.Expr:
        if self.carry_name is not None:
            # scan mode: the carry (or its tuple elements) resolves to the
            # section's substitution -- the init literal in the first
            # written level, the out field at K-offset -/+1 elsewhere
            if isinstance(node, fvir.Name) and node.id == self.carry_name:
                if len(self.carry_subst) != 1:
                    raise Ineligible("whole-tuple carry use")
                return self.carry_subst[0]
            if (
                isinstance(node, fvir.Subscript)
                and isinstance(node.value, fvir.Name)
                and node.value.id == self.carry_name
            ):
                idx = node.index
                if isinstance(idx, int) and idx < 0:
                    idx += len(self.carry_subst)
                if not isinstance(idx, int) or idx not in self.carry_subst:
                    raise Ineligible(f"carry subscript {idx!r}")
                return self.carry_subst[idx]
        if isinstance(node, fvir.Name):
            if node.id in self.param_subst:
                return self.param_subst[node.id]
            kind, v = self._resolve_name(node)
            if kind == "field":
                return ir.FieldAccess(name=v)
            if kind == "scalar":
                return ir.ScalarAccess(name=v)
            # closure constant
            if isinstance(v, (bool, int, float, np.generic)):
                dt = None
                if isinstance(node.type, ts.ScalarType):
                    dt = np.dtype(node.type.kind)
                return ir.Literal(value=v, dtype=dt)
            raise Ineligible(f"closure value of type {type(v).__name__}")
        if isinstance(node, fvir.Literal):
            if node.value is None:
                raise Ineligible("None literal")
            dt = None
            if isinstance(node.type, ts.ScalarType):
                dt = np.dtype(node.type.kind)
            return ir.Literal(value=node.value, dtype=dt)
        if isinstance(node, fvir.UnaryOp):
            opmap = {
                "neg": ir.UnaryOperator.NEG,
                "pos": ir.UnaryOperator.POS,
                "not": ir.UnaryOperator.NOT,
            }
            if node.op not in opmap:
                raise Ineligible(f"unary '{node.op}'")
            return ir.UnaryOp(op=opmap[node.op], expr=self._expr(node.operand))
        if isinstance(node, fvir.BinOp):
            if node.op not in _BINOPS:
                raise Ineligible(f"binop '{node.op}'")
            okind = getattr(node, "operand_kind", None)
            return ir.BinaryOp(
                op=_BINOPS[node.op],
                left=self._operand(node.left, okind),
                right=self._operand(node.right, okind),
            )
        if isinstance(node, fvir.Compare):
            if isinstance(node.left.type, ts.DimensionType):
                raise Ineligible("dimension comparison (domain literal)")
            if node.op not in _CMPOPS:
                raise Ineligible(f"compare '{node.op}'")
            okind = getattr(node, "operand_kind", None)
            return ir.BinaryOp(
                op=_CMPOPS[node.op],
                left=self._operand(node.left, okind),
                right=self._operand(node.right, okind),
            )
        if isinstance(node, fvir.BoolOp):
            op = (
                ir.BinaryOperator.AND
                if node.op == "and"
                else ir.BinaryOperator.OR
            )
            out = self._expr(node.values[0])
            for v in node.values[1:]:
                out = ir.BinaryOp(op=op, left=out, right=self._expr(v))
            return out
        if isinstance(node, fvir.Call):
            return self._call(node)
        raise Ineligible(f"expression {type(node).__name__}")

    # ---- runtime dims-order replica (embedded merge semantics) ---- #

    @staticmethod
    def _merge_dims(*dims_list):
        out: List[Dimension] = []
        for dims in dims_list:
            if dims is None:
                continue
            for d in dims:
                if d not in out:
                    out.append(d)
        return tuple(out) if out else None

    def dims_of(self, node: fvir.Expr):
        """The dims ORDER the embedded executor would produce for this
        expression (None for scalars) -- Field._binary / _merge_domains
        append right-operand extras to the left operand's order."""
        if isinstance(node, fvir.Name):
            if node.id in self.dims_env:
                return self.dims_env[node.id]
            return None
        if isinstance(node, fvir.Literal):
            return None
        if isinstance(node, fvir.UnaryOp):
            return self.dims_of(node.operand)
        if isinstance(node, (fvir.BinOp, fvir.Compare)):
            return self._merge_dims(
                self.dims_of(node.left), self.dims_of(node.right)
            )
        if isinstance(node, fvir.BoolOp):
            return self._merge_dims(*(self.dims_of(v) for v in node.values))
        if isinstance(node, fvir.Call):
            if id(node) in self.call_dims:  # inlined operator call
                return self.call_dims[id(node)]
            ftype = node.func.type
            if isinstance(ftype, ts.FieldType):  # shift keeps dims
                return self.dims_of(node.func)
            if isinstance(node.func, fvir.Name):
                fn = self.typed.closure.get(node.func.id)
                name = None
                for bname, bval in FIELD_BUILTINS.items():
                    if fn is bval:
                        name = bname
                        break
                if name is None and node.kwargs:
                    raise Ineligible("call with keyword arguments")
                cargs = (
                    self._canon_args(node, fn)
                    if name is not None
                    else list(node.args)
                )
                if name == "where":
                    return self._merge_dims(*(self.dims_of(a) for a in cargs))
                if name == "concat_where":
                    from .common import promote_dims

                    d = self._cw_dim(cargs[0])
                    merged = self._merge_dims(
                        *(self.dims_of(a) for a in cargs[1:])
                    )
                    return promote_dims(merged or (), (d,))
                if name == "broadcast":
                    dims = []
                    arg = cargs[1]
                    if not isinstance(arg, fvir.TupleExpr):
                        raise Ineligible("broadcast dims must be a tuple literal")
                    for e in arg.elts:
                        if not isinstance(e, fvir.Name):
                            raise Ineligible("broadcast dim is not a name")
                        d = self.typed.closure.get(e.id)
                        if not isinstance(d, Dimension):
                            raise Ineligible("broadcast dim is not a Dimension")
                        dims.append(d)
                    return tuple(dims)
                if name in ("astype", "neg") or (
                    name in _MATH_MAP and _MATH_MAP[name].arity == 1
                ):
                    return self.dims_of(cargs[0])
                if name in _MATH_MAP:  # binary math: left-order merge
                    return self._merge_dims(*(self.dims_of(a) for a in cargs))
        raise Ineligible(f"dims of {type(node).__name__}")

    def _operand(self, node: fvir.Expr, okind) -> ir.Expr:
        """Lower an operand with the interpreter's weak-operand cast
        (interpreter._cast_operand): weak scalars/fields convert to the
        op's deduced kind so results match the oracle bitwise."""
        e = self._expr(node)
        if okind is None or isinstance(okind, tuple):
            return e
        t = node.type
        weak = (
            (isinstance(t, ts.ScalarType) and t.weak)
            or (isinstance(t, ts.FieldType) and t.dtype.weak)
        )
        if not weak:
            return e
        target = np.dtype(okind)
        cur = _np_dtype(t)
        if cur == target:
            return e
        if isinstance(e, ir.Literal):
            return ir.Literal(value=e.value, dtype=target)
        return ir.Cast(dtype=target, expr=e)

    def _offset_of_args(self, node: fvir.Call) -> Tuple[int, int, int]:
        """Cartesian shift arguments ``(Ioff[1], ...)`` -> (di, dj, dk)."""
        off = [0, 0, 0]
        for a in node.args:
            t = a.type
            if isinstance(t, ts.OffsetIndexType):
                if len(t.target) != 1 or t.target[0].value != t.source.value:
                    raise Ineligible("non-cartesian offset")
                if not isinstance(a, fvir.Subscript):
                    raise Ineligible("offset index is not a literal subscript")
                if t.source.value not in self.axis_of:
                    raise Ineligible(
                        f"shift along unknown dimension {t.source.value}"
                    )
                off[self.axis_of[t.source.value]] += int(a.index)
            else:
                raise Ineligible(f"call argument of type {t}")
        return tuple(off)

    def _canon_args(self, node: fvir.Call, fn) -> List[fvir.Expr]:
        """Canonicalize keyword arguments into positional order through
        the callee's Python signature (the reference canonicalizes in
        func_to_foast; same effect here at lowering time)."""
        if not node.kwargs:
            return list(node.args)
        import inspect

        target = getattr(fn, "definition", fn)
        try:
            bound = inspect.signature(target).bind(*node.args, **node.kwargs)
        except TypeError as ex:
            raise Ineligible(f"cannot bind call arguments: {ex}") from ex
        if bound.kwargs:
            raise Ineligible("**kwargs call")
        return list(bound.args)

    def _call(self, node: fvir.Call) -> ir.Expr:
        ftype = node.func.type
        # field shift: f(Ioff[1]) / chained
        if isinstance(ftype, ts.FieldType):
            if node.kwargs:
                raise Ineligible("shift with keyword arguments")
            di, dj, dk = self._offset_of_args(node)
            base = self._expr(node.func)
            if not isinstance(base, ir.FieldAccess):
                # shifted inlined-call results / computed fields read at
                # offsets through a materialized temporary (the cartesian
                # on-the-fly form -- same extent math as the embedded
                # executor's field-then-shift)
                base = self._materialize(
                    base, _np_dtype(ftype), self.dims_of(node.func)
                )
            o = base.offset
            if not isinstance(o, ir.CartesianOffset):
                raise Ineligible("chained non-cartesian offset")
            return ir.FieldAccess(
                name=base.name,
                offset=ir.CartesianOffset(i=o.i + di, j=o.j + dj, k=o.k + dk),
                data_index=base.data_index,
            )
        # builtins resolved through the closure
        if isinstance(node.func, fvir.Name):
            fn = self.typed.closure.get(node.func.id)
            name = None
            for bname, bval in FIELD_BUILTINS.items():
                if fn is bval:
                    name = bname
                    break
            if name is None:
                from .ffront import FieldOperator, ScanOperator

                if isinstance(fn, FieldOperator) and not isinstance(
                    fn, ScanOperator
                ):
                    return self._inline_call(fn, node)
                raise Ineligible(f"call of '{node.func.id}'")
            okind = getattr(node, "operand_kind", None)
            cargs = self._canon_args(node, fn)
            if name == "where":
                c, a, b = cargs
                return ir.TernaryOp(
                    cond=self._operand(c, okind),
                    true_expr=self._operand(a, okind),
                    false_expr=self._operand(b, okind),
                )
            if name == "concat_where":
                return self._concat_where(node, cargs, okind)
            if name == "broadcast":
                # pointwise semantics: dimension masks make the broadcast
                # implicit; just check the dims are representable
                if isinstance(node.type, ts.FieldType):
                    self._register_dims(node.type.dims)
                return self._expr(cargs[0])
            if name == "astype":
                target = _np_dtype(node.type)
                return ir.Cast(dtype=target, expr=self._expr(cargs[0]))
            if name == "neg":
                return ir.UnaryOp(
                    op=ir.UnaryOperator.NEG, expr=self._expr(cargs[0])
                )
            if name in _MATH_MAP:
                nf = _MATH_MAP[name]
                args = [self._operand(a, okind) for a in cargs]
                if len(args) != nf.arity:
                    raise Ineligible(f"{name} arity")
                return ir.NativeFuncCall(func=nf, args=args)
            raise Ineligible(f"builtin '{name}'")
        raise Ineligible(f"call of {ftype}")

    # ---- concat_where -> vertical-section slots ---- #

    def _cw_dim(self, cond: fvir.Expr) -> Dimension:
        """The (vertical) dimension a concat_where condition splits."""
        if not isinstance(cond, fvir.Compare) or not isinstance(
            getattr(cond.left, "type", None), ts.DimensionType
        ):
            raise Ineligible("concat_where condition is not 'Dim <op> bound'")
        if not isinstance(cond.left, fvir.Name):
            raise Ineligible("concat_where dimension is not a name")
        d = self.typed.closure.get(cond.left.id)
        if not isinstance(d, Dimension):
            raise Ineligible("concat_where dimension unresolved")
        return d

    def _cw_bound(self, cond: fvir.Compare) -> int:
        """The static split value (literal or closure int constant)."""
        r = cond.right
        if isinstance(r, fvir.Literal) and isinstance(
            r.value, (int, np.integer)
        ) and not isinstance(r.value, bool):
            return int(r.value)
        if isinstance(r, fvir.Name):
            v = self.typed.closure.get(r.id)
            if isinstance(v, (int, np.integer)) and not isinstance(v, bool):
                return int(v)
        raise Ineligible("concat_where bound is not a static integer")

    def _concat_where(self, node: fvir.Call, cargs, okind) -> ir.Expr:
        """Hoist ``concat_where(K < c, t, f)`` into a per-vertical-region
        temporary (a CwSlot in the pending stream): the stencil is later
        instantiated with one PARALLEL section per K region, each
        assigning the branch active there.  Reference analog:
        iterator/transforms/concat_where/ (domain-partitioned lowering)."""
        if self.carry_name is not None:
            raise Ineligible("concat_where inside a scan body")
        cond, tb, fb = cargs
        d = self._cw_dim(cond)
        if d.kind != DimensionKind.VERTICAL:
            raise Ineligible("concat_where along a horizontal dimension")
        self._register_dims((d,))
        if self.axis_of[d.value] != 2:
            raise Ineligible("concat_where dim is not the vertical axis")
        if isinstance(tb.type, ts.TupleType) or isinstance(fb.type, ts.TupleType):
            raise Ineligible("tuple-branch concat_where")
        c = self._cw_bound(cond)
        rel = cond.op
        if rel == "lt":
            lo, hi = None, c
        elif rel == "le":
            lo, hi = None, c + 1
        elif rel == "ge":
            lo, hi = c, None
        elif rel == "gt":
            lo, hi = c + 1, None
        else:
            raise Ineligible(f"concat_where comparison '{rel}'")
        t_e = self._operand(tb, okind)
        f_e = self._operand(fb, okind)
        dt = _np_dtype(node.type)
        tname = self._fresh("cw")
        self.temp_decls[tname] = ir.FieldDecl(
            name=tname, dtype=dt, dimensions=(True, True, True), is_api=False
        )
        self.pending.append(
            CwSlot(target=tname, lo=lo, hi=hi, t_expr=t_e, f_expr=f_e)
        )
        self.dims_env[tname] = self.dims_of(node)
        return ir.FieldAccess(name=tname)

    # ---- operator-call inlining ---- #

    def _fresh(self, base: str) -> str:
        self._uid[0] += 1
        return f"__inl{self._uid[0]}_{base}"

    def _materialize(
        self,
        expr: ir.Expr,
        dtype: np.dtype,
        dims: Optional[Tuple[Dimension, ...]],
    ) -> ir.FieldAccess:
        """Hoist a computed field expression into a stencil temporary
        (assignment flushed before the consuming statement) so it can be
        read at offsets or bound to a callee parameter."""
        tname = self._fresh("val")
        self.temp_decls[tname] = ir.FieldDecl(
            name=tname, dtype=dtype, dimensions=(True, True, True), is_api=False
        )
        self.pending.append(
            ir.Assign(target=ir.FieldAccess(name=tname), value=expr)
        )
        if dims is not None:
            self.dims_env[tname] = dims
        return ir.FieldAccess(name=tname)

    def _inline_call(self, fn, node: fvir.Call) -> ir.Expr:
        """Inline a called field operator's body: its params bind to the
        caller-side lowered argument expressions (complex field args
        materialize to temporaries so offsets compose), its temporaries
        get collision-free names, and the call's value is the callee's
        lowered return expression.  The embedded executor computes the
        callee on its own shrunk domain; the cartesian extent analysis
        over the inlined form yields the same domain math."""
        if self._depth >= 8:
            raise Ineligible("operator call inlining too deep")
        cargs = self._canon_args(node, fn)
        try:
            callee, _ = fn._typed_for(tuple(a.type for a in cargs))
        except Ineligible:
            raise
        except Exception as ex:
            raise Ineligible(f"callee typing failed: {ex}") from ex
        if callee.kind != "field_operator":
            raise Ineligible(callee.kind)
        if len(callee.params) != len(cargs):
            raise Ineligible("operator call arity mismatch")

        child = _Lowerer(callee, parent=self)
        for p, a in zip(callee.params, cargs):
            at = a.type
            e = self._expr(a)
            if isinstance(at, ts.FieldType):
                if not isinstance(e, ir.FieldAccess):
                    e = self._materialize(e, _np_dtype(at), self.dims_of(a))
                child.param_subst[p.name] = e
                child.dims_env[p.name] = self.dims_of(a)
            elif isinstance(at, ts.ScalarType):
                child.param_subst[p.name] = e
            else:
                raise Ineligible(f"operator call argument of type {at}")

        stmts = list(callee.body)
        if not stmts or not isinstance(stmts[-1], fvir.Return):
            raise Ineligible("callee body must end in a return")
        for st in stmts[:-1]:
            if (
                not isinstance(st, fvir.Assign)
                or st.unpack
                or len(st.targets) != 1
            ):
                raise Ineligible(f"callee statement {type(st).__name__}")
            if not isinstance(st.value.type, ts.FieldType):
                raise Ineligible("non-field callee temporary")
            expr = child._expr(st.value)
            dims = child.dims_of(st.value)
            tname = st.targets[0]
            new = self._fresh(tname)
            self.temp_decls[new] = ir.FieldDecl(
                name=new,
                dtype=_np_dtype(st.value.type),
                dimensions=(True, True, True),
                is_api=False,
            )
            self.pending.append(
                ir.Assign(target=ir.FieldAccess(name=new), value=expr)
            )
            child.rename[tname] = new
            child.dims_env[tname] = dims or ()
        ret = stmts[-1]
        if not isinstance(ret.value.type, ts.FieldType):
            raise Ineligible("non-field callee return")
        out = child._expr(ret.value)
        self.call_dims[id(node)] = child.dims_of(ret.value)
        return out


def _hull_stmt(entry) -> ir.Stmt:
    """A CwSlot as a single-section statement for the I/J analyses: the
    embedded executor evaluates BOTH branches over the orthogonal
    intersection, so a both-branch select has exactly its read set."""
    if isinstance(entry, CwSlot):
        return ir.Assign(
            target=ir.FieldAccess(name=entry.target),
            value=ir.TernaryOp(
                cond=ir.Literal(value=True, dtype=np.dtype(np.bool_)),
                true_expr=entry.t_expr,
                false_expr=entry.f_expr,
            ),
        )
    return entry


def _k_atoms(expr: ir.Expr, temp_names) -> Tuple:
    """K-domain atoms of a lowered expression: the embedded executor
    intersects every operand's domain, so the expression's K range is the
    intersection over field reads of (source K range shifted by -koff)."""
    atoms = []
    for acc in ir.field_accesses(expr):
        off = acc.offset
        if not isinstance(off, ir.CartesianOffset):
            raise Ineligible("variable/absolute K inside a concat_where operator")
        kind = "temp" if acc.name in temp_names else "field"
        atoms.append((kind, acc.name, off.k))
    return tuple(atoms)


def _build_recipes(body, out_exprs, temp_names):
    """Ordered per-statement K-domain recipes for the runtime algebra
    (a list, not a dict: reassigned temps must see their previous
    version's range in their own right-hand side)."""
    recipes: List[Tuple[str, Any]] = []
    for entry in body:
        if isinstance(entry, CwSlot):
            recipes.append(
                (
                    entry.target,
                    (
                        "cw",
                        entry.lo,
                        entry.hi,
                        _k_atoms(entry.t_expr, temp_names),
                        _k_atoms(entry.f_expr, temp_names),
                    ),
                )
            )
        else:
            recipes.append(
                (entry.target.name, ("isect", _k_atoms(entry.value, temp_names)))
            )
    outs = [("isect", _k_atoms(ex, temp_names)) for ex in out_exprs]
    return recipes, outs


def _eval_recipes(recipes, out_recipes, kranges: Dict[str, Tuple[int, int]]):
    """Run the embedded K-domain algebra on concrete field K ranges.

    ``kranges``: api field -> (start, stop) (absent = the field has no
    vertical axis).  Returns the per-out (start, stop); raises
    :class:`Ineligible` exactly where the embedded executor would raise
    (gaps, overlaps, both-branches-unbounded, no data) -- the fallback
    then reproduces the located error."""
    INF = 1 << 60
    env: Dict[str, Tuple[int, int]] = {}

    def atom_range(kind, name, koff):
        if kind == "temp":
            r = env.get(name)
            if r is None:  # assigned later / not K-constrained
                return None
        else:
            r = kranges.get(name)
            if r is None:
                return None
        return (r[0] - koff, r[1] - koff)

    def isect(atoms):
        lo, hi = -INF, INF
        for a in atoms:
            r = atom_range(*a)
            if r is None:
                continue
            lo, hi = max(lo, r[0]), min(hi, r[1])
        return (lo, hi)

    def eval_one(recipe):
        if recipe[0] == "isect":
            return isect(recipe[1])
        _, clo, chi, t_atoms, f_atoms = recipe
        t_rng = isect(t_atoms)
        f_rng = isect(f_atoms)
        starts = [r[0] for r in (t_rng, f_rng) if r[0] > -INF]
        stops = [r[1] for r in (t_rng, f_rng) if r[1] < INF]
        if not starts or not stops:
            raise Ineligible("concat_where: both branches unbounded")
        b_lo, b_hi = min(starts), max(stops)
        cond = (clo if clo is not None else -INF, chi if chi is not None else INF)
        pieces = []
        t_piece = (max(t_rng[0], cond[0], b_lo), min(t_rng[1], cond[1], b_hi))
        if t_piece[1] > t_piece[0]:
            pieces.append(t_piece)
        for comp in ((-INF, cond[0]), (cond[1], INF)):
            p = (max(f_rng[0], comp[0], b_lo), min(f_rng[1], comp[1], b_hi))
            if p[1] > p[0]:
                pieces.append(p)
        if not pieces:
            raise Ineligible("concat_where: no data in either region")
        pieces.sort()
        for (s0, e0), (s1, e1) in zip(pieces, pieces[1:]):
            if e0 != s1:
                raise Ineligible(
                    "concat_where: non-contiguous or overlapping pieces"
                )
        return (pieces[0][0], pieces[-1][1])

    for name, recipe in recipes:
        env[name] = eval_one(recipe)
    return [eval_one(r) for r in out_recipes]


def _exact_extents(
    stmts: List[ir.Stmt], out_names: set, temp_names: set
) -> Dict[str, Any]:
    """The embedded executor's demand-EXACT read extents over a lowered
    straight-line body: the backward sweep of analysis.compute_extents
    without the union-zero widening of temporaries and without dead
    statements.  The cartesian executors compute every temporary at least
    over the domain (union_zero) -- correct but WIDER than the embedded
    domain algebra when a temp is read only at nonzero offsets; the
    lowering gates on equality (see lower_field_operator)."""
    from gt4py_tpu_torch.core.definitions import Extent

    need: Dict[str, Extent] = {}
    api_ext: Dict[str, Extent] = {}
    for st in reversed(stmts):
        t = st.target.name
        if t in out_names:
            ext = Extent.zeros()
        elif t in need:
            req = need.pop(t)
            ext = Extent(i=req.i, j=req.j)  # horizontal, like the analysis
        else:
            continue  # dead in the embedded dag
        for r in ir.field_accesses(st.value):
            off = r.offset
            if isinstance(off, ir.CartesianOffset):
                box = ext + Extent.from_offset(off.i, off.j, off.k)
            else:
                box = ext
            target = need if r.name in temp_names else api_ext
            prev = target.get(r.name)
            target[r.name] = box if prev is None else prev | box
    return api_ext


def _demand_slice(
    stmts: List[ir.Stmt], root: ir.Expr, temp_decls: Dict[str, ir.FieldDecl]
) -> List[ir.Stmt]:
    """The backward demand slice of a straight-line assignment list: only
    statements (transitively) feeding the temporaries read by ``root``.
    Respects reassignment order (a kept statement re-demands its own
    target when it reads it, e.g. ``flx = where(c, 0.0, flx)``)."""
    need = {
        a.name for a in ir.field_accesses(root) if a.name in temp_decls
    }
    keep: List[ir.Stmt] = []
    for st in reversed(stmts):
        t = getattr(getattr(st, "target", None), "name", None)
        if t in need:
            need.discard(t)
            keep.append(st)
            need |= {
                a.name
                for a in ir.field_accesses(st.value)
                if a.name in temp_decls
            }
    keep.reverse()
    return keep


def lower_field_operator(typed: fvir.OperatorIR) -> BridgePlan:
    """Lower a TYPED field operator to a cartesian stencil + backend.

    Raises :class:`Ineligible` for anything outside the subset; the
    generator's ``NotImplementedError`` propagates.
    """
    if typed.kind != "field_operator":
        raise Ineligible(typed.kind)

    lw = _Lowerer(typed)

    # parameters
    field_params: List[Tuple[str, Tuple[Dimension, ...], Tuple[bool, bool, bool]]] = []
    scalar_params: List[str] = []
    for p in typed.params:
        if isinstance(p.type, ts.FieldType):
            lw._register_dims(p.type.dims)
            lw.field_names.add(p.name)
        elif isinstance(p.type, ts.ScalarType):
            lw.scalar_names.add(p.name)
            scalar_params.append(p.name)
        else:
            raise Ineligible(f"parameter of type {p.type}")

    for p in typed.params:
        if isinstance(p.type, ts.FieldType):
            mask = lw._mask(p.type.dims)
            lw.field_decls[p.name] = ir.FieldDecl(
                name=p.name, dtype=_np_dtype(p.type), dimensions=mask
            )
            lw.dims_env[p.name] = tuple(p.type.dims)
            field_params.append((p.name, p.type.dims, mask))
        else:
            lw.scalar_decls[p.name] = ir.ScalarDecl(
                name=p.name, dtype=_np_dtype(p.type)
            )

    # body
    body: List[ir.Stmt] = []
    ret_type: Optional[ts.TypeSpec] = None
    stmts = list(typed.body)
    if not stmts or not isinstance(stmts[-1], fvir.Return):
        raise Ineligible("operator body must end in a return")
    for st in stmts[:-1]:
        if not isinstance(st, fvir.Assign) or st.unpack or len(st.targets) != 1:
            raise Ineligible(f"statement {type(st).__name__}")
        if not isinstance(st.value.type, ts.FieldType):
            raise Ineligible("non-field temporary")
        lw._register_dims(st.value.type.dims)
        tname = st.targets[0]
        if tname in lw.field_names or tname in lw.scalar_names:
            raise Ineligible("parameter reassignment")
        expr = lw._expr(st.value)
        lw.dims_env[tname] = lw.dims_of(st.value) or ()
        lw.temp_decls[tname] = ir.FieldDecl(
            name=tname,
            dtype=_np_dtype(st.value.type),
            dimensions=(True, True, True),
            is_api=False,
        )
        lw.rename[tname] = tname
        body.extend(lw.pending)  # hoisted inlined-callee statements
        lw.pending.clear()
        body.append(ir.Assign(target=ir.FieldAccess(name=tname), value=expr))
    ret = stmts[-1]
    rv = ret.value
    if isinstance(rv, fvir.TupleExpr):
        members = list(rv.elts)
        is_tuple = True
        if not members:
            raise Ineligible("empty tuple return")
    elif isinstance(rv.type, ts.TupleType):
        raise Ineligible("tuple return is not a tuple literal")
    else:
        members = [rv]
        is_tuple = False

    outs: List[Tuple[str, Tuple[Dimension, ...], Tuple[bool, bool, bool], np.dtype]] = []
    out_exprs: List[ir.Expr] = []
    for i, m in enumerate(members):
        mt = m.type
        if not isinstance(mt, ts.FieldType):
            raise Ineligible("non-field return")
        lw._register_dims(mt.dims)
        ex = lw._expr(m)  # before dims_of: inlined calls cache their dims
        m_dims = lw.dims_of(m)
        if m_dims is None or set(d.value for d in m_dims) != set(
            d.value for d in mt.dims
        ):
            raise Ineligible("cannot replicate the result dims order")
        nm = f"__out_{i}" if is_tuple else "__out"
        mask = lw._mask(mt.dims)
        dt = _np_dtype(mt)
        lw.field_decls[nm] = ir.FieldDecl(name=nm, dtype=dt, dimensions=mask)
        outs.append((nm, m_dims, mask, dt))
        out_exprs.append(ex)
    body.extend(lw.pending)  # hoisted statements from the return exprs
    lw.pending.clear()

    def _build(body_stmts, out_names):
        api = (
            [ir.ApiParam(name=n, is_field=True) for n, _, _ in field_params]
            + [ir.ApiParam(name=nm, is_field=True) for nm in out_names]
            + [ir.ApiParam(name=n, is_field=False) for n in scalar_params]
        )
        decls = {
            k: v
            for k, v in lw.field_decls.items()
            if not k.startswith("__out") or k in out_names
        }
        return ir.Stencil(
            name=f"next_{typed.name or 'op'}",
            api_params=api,
            field_decls=decls,
            scalar_decls=dict(lw.scalar_decls),
            temp_decls=dict(lw.temp_decls),
            vertical_loops=[
                ir.VerticalLoop(
                    ir.LoopOrder.PARALLEL,
                    [
                        ir.VerticalSection(
                            interval=ir.Interval(
                                ir.AxisBound.start(0), ir.AxisBound.end(0)
                            ),
                            body=body_stmts,
                        )
                    ],
                )
            ],
        )

    full_body = body + [
        ir.Assign(target=ir.FieldAccess(name=nm), value=ex)
        for (nm, _, _, _), ex in zip(outs, out_exprs)
    ]
    has_cw = any(isinstance(e, CwSlot) for e in full_body)
    hull_body = [_hull_stmt(e) for e in full_body]
    stencil = _build(hull_body, [nm for nm, _, _, _ in outs])

    try:
        analysis = analyze(stencil)
    except Exception as ex:  # validation errors -> embedded fallback
        raise Ineligible(f"cartesian analysis rejected: {ex}") from ex

    # gate: the kernel's extents must equal the embedded executor's exact
    # demand (fuzz seed 19: a temp read ONLY at nonzero offsets is widened
    # by union_zero, shrinking the result domain vs the embedded path).
    # For concat_where plans the K axis is handled by the runtime domain
    # algebra (recipes) instead -- compare the horizontal components only.
    exact = _exact_extents(
        hull_body, {nm for nm, _, _, _ in outs}, set(lw.temp_decls)
    )
    for n, _, _ in field_params:
        a_e = analysis.extents.field_extents.get(n)
        e_e = exact.get(n)
        a_t = None if a_e is None else (
            (a_e.i, a_e.j) if has_cw else (a_e.i, a_e.j, a_e.k)
        )
        e_t = None if e_e is None else (
            (e_e.i, e_e.j) if has_cw else (e_e.i, e_e.j, e_e.k)
        )
        if a_t != e_t:
            raise Ineligible(
                "temporary read only at nonzero offsets: kernel extents "
                "would differ from the embedded domain"
            )

    if is_tuple:
        # the fused kernel has ONE compute domain, but the embedded
        # executor gives each tuple member its OWN domain (shrunk by that
        # member's reads only) -- fuse only when every member provably
        # yields the same domain for any argument domains: identical
        # per-member EXACT demand maps.  The zero-widened analysis extents
        # are NOT a sound gate here: members reading the same input at
        # asymmetric nonzero offsets (a(I+1)+a(I+2) vs a+a(I+2)) widen to
        # the same hull while their embedded domains differ.
        param_names = {fp[0] for fp in field_params}
        temp_names = set(lw.temp_decls)
        hull_pre = [_hull_stmt(e) for e in body]
        ref_ext = None
        for (nm, _, _, _), ex in zip(outs, out_exprs):
            # demand-slice the body to THIS member's dag: the extent sweep
            # is not demand-driven, so statements dead for this member
            # would pollute its extents with their reads
            member_stmts = _demand_slice(hull_pre, ex, lw.temp_decls) + [
                ir.Assign(target=ir.FieldAccess(name=nm), value=ex)
            ]
            m_ext = {
                n: (
                    (e.i, e.j) if has_cw else (e.i, e.j, e.k)
                )
                for n, e in _exact_extents(
                    member_stmts, {nm}, temp_names
                ).items()
                if n in param_names
            }
            if ref_ext is None:
                ref_ext = m_ext
            elif m_ext != ref_ext:
                raise Ineligible("tuple members with differing read extents")

    # the runner maps read extents to domain shrink exactly like the
    # embedded executor; an extent not containing 0 would need negative
    # origins, which the executors don't support (K exempt for
    # concat_where plans: sections + the recipe algebra handle it)
    for name, _, _ in field_params:
        e = analysis.extents.field_extents.get(name)
        if e is None:
            continue
        spans = (e.i, e.j) if has_cw else (e.i, e.j, e.k)
        for lo, hi in spans:
            if lo > 0 or hi < 0:
                raise Ineligible("read extent excludes the zero offset")

    cw_body = recipes = out_recipes = None
    if has_cw:
        recipes, out_recipes = _build_recipes(
            body, out_exprs, set(lw.temp_decls)
        )
        cw_body = full_body
    backend = CudaBackend(analysis)
    return BridgePlan(
        stencil=stencil,
        analysis=analysis,
        backend=backend,
        axis_of=dict(lw.axis_of),
        field_params=field_params,
        scalar_params=scalar_params,
        outs=outs,
        is_tuple=is_tuple,
        signature_order=[p.name for p in typed.params],
        cw_body=cw_body,
        recipes=recipes,
        out_recipes=out_recipes,
    )


def _cw_dce(stmts: List[ir.Stmt], out_names: set) -> List[ir.Stmt]:
    """Per-section dead-code elimination: a statement only feeding the
    INACTIVE branches of this section's concat_wheres must not execute
    here -- the embedded executor never evaluates it on this K range,
    and its reads may be out of bounds there (e.g. the interior branch
    reading K-1 dropped from the surface section)."""
    need: set = set()
    keep: List[ir.Stmt] = []
    for st in reversed(stmts):
        t = st.target.name
        if t in out_names or t in need:
            need.discard(t)
            keep.append(st)
            need |= {a.name for a in ir.field_accesses(st.value)}
    keep.reverse()
    return keep


def _instantiate_cw(plan: BridgePlan, k0: int, k1: int):
    """Build (and cache) the K-sectioned stencil for a concat_where plan
    over the kernel K window [k0, k1): one PARALLEL section per region
    between the split bounds, each assigning every CwSlot its active
    branch."""
    import copy

    key = (k0, k1)
    hit = plan.cw_cache.get(key)
    if hit is not None:
        if isinstance(hit, Ineligible):
            raise Ineligible(str(hit))
        return hit
    cuts = set()
    for entry in plan.cw_body:
        if isinstance(entry, CwSlot):
            for b in (entry.lo, entry.hi):
                if b is not None and k0 < b < k1:
                    cuts.add(b)
    out_names = {nm for nm, _, _, _ in plan.outs}

    def _dce(stmts: List[ir.Stmt]) -> List[ir.Stmt]:
        return _cw_dce(stmts, out_names)

    edges = [k0] + sorted(cuts) + [k1]
    sections = []
    for a, b in zip(edges, edges[1:]):
        body_r: List[ir.Stmt] = []
        for entry in plan.cw_body:
            if isinstance(entry, CwSlot):
                active = (entry.lo is None or entry.lo <= a) and (
                    entry.hi is None or b <= entry.hi
                )
                body_r.append(
                    ir.Assign(
                        target=ir.FieldAccess(name=entry.target),
                        value=copy.deepcopy(
                            entry.t_expr if active else entry.f_expr
                        ),
                    )
                )
            else:
                body_r.append(copy.deepcopy(entry))
        body_r = _dce(body_r)
        sections.append(
            ir.VerticalSection(
                interval=ir.Interval(
                    ir.AxisBound.start(a - k0),
                    ir.AxisBound.start(b - k0)
                    if b < k1
                    else ir.AxisBound.end(0),
                ),
                body=body_r,
            )
        )
    base = plan.stencil
    stencil = ir.Stencil(
        name=base.name,
        api_params=list(base.api_params),
        field_decls=dict(base.field_decls),
        scalar_decls=dict(base.scalar_decls),
        temp_decls=dict(base.temp_decls),
        vertical_loops=[ir.VerticalLoop(ir.LoopOrder.PARALLEL, sections)],
    )
    try:
        analysis = analyze(stencil)
    except Exception as ex:
        inst = Ineligible(f"cartesian analysis rejected the sections: {ex}")
        plan.cw_cache[key] = inst
        raise Ineligible(str(inst)) from ex
    inst = (analysis, type(plan.backend)(analysis))
    plan.cw_cache[key] = inst
    return inst


def _cw_k_window(plan: BridgePlan, fields: Dict[str, "Field"]):
    """The concat_where result K window from the runtime domain algebra
    (the embedded piece semantics) given the op's field arguments."""
    INF = 1 << 60
    kranges = {}
    unplaceable = None
    for n, dims, mask in plan.field_params:
        f = fields[n]
        for d, r in zip(f.domain.dims, f.domain.ranges):
            if plan.axis_of[d.value] == 2:
                lim = 1 << 40  # UnitRange.infinite() sentinels
                # clamp each side independently: a range infinite on
                # one side only still contributes its finite bound,
                # so half-open field domains can plan a finite result
                kranges[n] = (
                    -INF if r.start < -lim else int(r.start),
                    INF if r.stop > lim else int(r.stop),
                )
                if r.start < -lim:
                    # data windows are placed from the range START;
                    # an unbounded-below field cannot be windowed
                    unplaceable = n
    out_ks = _eval_recipes(plan.recipes, plan.out_recipes, kranges)
    if unplaceable is not None:
        raise Ineligible(
            f"field '{unplaceable}' K range is unbounded below; its"
            " data window cannot be placed"
        )
    if any(k != out_ks[0] for k in out_ks[1:]):
        raise Ineligible("tuple members with differing concat_where domains")
    k0, k1 = out_ks[0]
    if k0 <= -(1 << 40) or k1 >= (1 << 40):
        raise Ineligible("unbounded concat_where result domain")
    return k0, k1


def _kernel_view(data: torch.Tensor, axes: List[int]) -> torch.Tensor:
    """A field's tensor as the logical (I, J, K) view the stencil backends
    take: its axes permuted into I, J, K order and a size-1 axis for each
    missing one (a view, never a copy)."""
    perm = sorted(range(len(axes)), key=lambda i: axes[i])
    t = data.permute(*perm) if perm != list(range(len(axes))) else data
    for ax in range(3):
        if ax not in axes:
            t = t.unsqueeze(ax)
    return t


def _origin3(starts, f: Field, axes: List[int]) -> Tuple[int, int, int]:
    """Per-axis origin of ``f``'s buffer at the kernel domain start (0 on
    axes the field lacks)."""
    return tuple(
        ((starts[ax] if starts[ax] is not None else 0)
         - f.domain.ranges[axes.index(ax)].start) if ax in axes else 0
        for ax in range(3)
    )


def _out_buffer(axes: List[int], domain, dtype, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """A zeroed output over the kernel domain on the axes ``axes``: the
    tensor in sorted-axis order (K outermost in memory, J contiguous) and
    its logical (I, J, K) view."""
    present = sorted(axes)
    order = sorted(range(len(present)), key=lambda i: (present[i] != 2, present[i]))
    storage = torch.zeros(tuple(domain[present[i]] for i in order),
                          dtype=dtypes.to_torch(dtype), device=device)
    t = storage.permute(*np.argsort(order).tolist())
    return t, _kernel_view(t, present)


def _from_kernel_view(view: torch.Tensor, axes: List[int]) -> torch.Tensor:
    """The inverse of ``_out_buffer``'s logical view: the (I, J, K) tensor
    ``view`` on the axes ``axes`` only, in sorted-axis order."""
    return view[tuple(slice(None) if ax in axes else 0 for ax in range(3))]


def _apply(backend, env, scalars, domain, origins) -> Dict[str, torch.Tensor]:
    """``backend.apply``; returns the written fields that a call under K8
    handed back as new tensors (``CudaBackend.apply``'s ``outputs``), the
    others filled in place."""
    got: Dict[str, torch.Tensor] = {}
    backend.apply(env, scalars, domain, origins, outputs=got)
    return got


def _to_declared(t: torch.Tensor, axes: List[int]) -> torch.Tensor:
    """A sorted-axis output back in the declared dims order ``axes``."""
    srt = sorted(axes)
    perm = [srt.index(ax) for ax in axes]
    return t.permute(*perm) if perm != list(range(len(axes))) else t


def _device(fields) -> torch.device:
    devices = {f.data.device for f in fields if isinstance(f.data, torch.Tensor)}
    if len(devices) != 1:
        raise ValueError(f"fields on devices {sorted(map(str, devices))}")
    return devices.pop()


@dataclasses.dataclass
class _RunLayout:
    """A call's domain arithmetic for one set of argument domains."""

    domain: Tuple[int, int, int]
    starts: List[Optional[int]]
    stops: List[Optional[int]]
    origins: Dict[str, Tuple[int, int, int]]
    axes: Dict[str, List[int]]
    out_axes: List[List[int]]
    backend: Any


def _plan_run(plan: BridgePlan, fields: Dict[str, Field], restrict) -> _RunLayout:
    ext = plan.analysis.extents

    # output domain: intersect every field's domain shrunk by its read
    # extent (embedded-executor semantics)
    starts = [None, None, None]
    stops = [None, None, None]
    for n, dims, mask in plan.field_params:
        f = fields[n]
        e = ext.field_extents.get(n)
        if e is None:
            continue  # never read
        spans = (e.i, e.j, e.k)
        for d, r in zip(f.domain.dims, f.domain.ranges):
            ax = plan.axis_of[d.value]
            lo, hi = spans[ax]
            s, t = r.start - lo, r.stop - hi
            starts[ax] = s if starts[ax] is None else max(starts[ax], s)
            stops[ax] = t if stops[ax] is None else min(stops[ax], t)

    if plan.cw_body is not None:
        # concat_where plans: the K window comes from the runtime domain
        # algebra (the embedded piece semantics), not the extent hull
        starts[2], stops[2] = _cw_k_window(plan, fields)

    if restrict:
        # explicit out=+domain= restriction: intersect before planning
        for dval, rs, rt in restrict:
            if dval not in plan.axis_of:
                raise Ineligible(f"restriction along unknown dim {dval}")
            ax = plan.axis_of[dval]
            starts[ax] = rs if starts[ax] is None else max(starts[ax], rs)
            stops[ax] = rt if stops[ax] is None else min(stops[ax], rt)

    axes_per_out = [
        [plan.axis_of[d.value] for d in dims] for _, dims, _, _ in plan.outs
    ]
    for out_axes in axes_per_out:
        for ax in out_axes:
            if starts[ax] is None:
                raise Ineligible("output dimension unconstrained by any input")
            if stops[ax] <= starts[ax]:
                raise Ineligible("empty output domain")

    domain = tuple(
        (stops[ax] - starts[ax]) if starts[ax] is not None else 1
        for ax in range(3)
    )
    axes = {n: [plan.axis_of[d.value] for d in fields[n].domain.dims]
            for n, _, _ in plan.field_params}
    origins = {n: _origin3(starts, fields[n], axes[n]) for n, _, _ in plan.field_params}

    backend = plan.backend
    if plan.cw_body is not None:
        analysis2, backend = _instantiate_cw(plan, starts[2], stops[2])
        kb_resolved = compute_k_boundary_resolved(
            analysis2.stencil, domain[2], extents=analysis2.extents
        )
        # per-section K reads must stay inside each argument's buffer
        # (interval-aware compute_k_boundary over the STATIC sections)
        for n, dims, mask in plan.field_params:
            f = fields[n]
            if 2 not in axes[n]:
                continue
            r = f.domain.ranges[axes[n].index(2)]
            kb0, kb1 = kb_resolved.get(n, (0, 0))
            org_k = starts[2] - r.start
            if org_k < kb0 or org_k + domain[2] + kb1 > len(r):
                raise Ineligible(
                    f"'{n}' does not cover the sectioned K reads"
                )
    return _RunLayout(domain, starts, stops, origins, axes, axes_per_out, backend)


def run_plan(plan: BridgePlan, args: Tuple[Any, ...], restrict=None) -> Field:
    """Execute a lowered operator on canonical (torch-converted) arguments:
    one call of the generated kernels (the plain executor on CPU
    tensors).  Raises :class:`Ineligible` where the embedded executor
    would produce a domain the kernel cannot (the caller runs embedded)."""
    by_name = dict(zip(plan.signature_order, args))
    fields: Dict[str, Field] = {n: by_name[n] for n, _, _ in plan.field_params}
    scalars: Dict[str, Any] = {n: by_name[n] for n in plan.scalar_params}

    key = (tuple(fields[n].domain for n, _, _ in plan.field_params), restrict)
    lay = plan.run_cache.get(key)
    if lay is None:
        lay = plan.run_cache[key] = _plan_run(plan, fields, restrict)
    device = _device(fields.values())
    env = {n: _kernel_view(fields[n].data, lay.axes[n]) for n, _, _ in plan.field_params}
    origins = dict(lay.origins)
    outs = []
    for (nm, _, _, dt), out_axes in zip(plan.outs, lay.out_axes):
        out, env[nm] = _out_buffer(out_axes, lay.domain, dt, device)
        origins[nm] = (0, 0, 0)
        outs.append(out)

    got = _apply(lay.backend, env, scalars, lay.domain, origins)
    outs = [_from_kernel_view(got[nm], out_axes) if nm in got else out
            for (nm, _, _, _), out_axes, out in zip(plan.outs, lay.out_axes, outs)]

    results = []
    for (nm, dims, _, _), out_axes, out in zip(plan.outs, lay.out_axes, outs):
        ranges = tuple(UnitRange(lay.starts[ax], lay.stops[ax]) for ax in out_axes)
        results.append(Field(Domain(tuple(dims), ranges), _to_declared(out, out_axes)))
    return tuple(results) if plan.is_tuple else results[0]


# --------------------------------------------------------------------------- #
# Scan operators -> serial-K cartesian kernels
# --------------------------------------------------------------------------- #
#
# A column scan IS the cartesian serial-K pattern: the carry at level k is
# the out field at k-1 (FORWARD) / k+1 (BACKWARD), seeded by the init
# literal in the first written level.  Lowering a next scan_operator to a
# FORWARD/BACKWARD vertical loop hands it to the column-form kernel (one
# thread per (i, j) column, the carry read back from the level the thread
# just wrote) -- the analog of the reference's scan handling in the
# compiled program processors (gtfn: scan_executor; embedded spec:
# embedded/operators.py:40-90).


@dataclasses.dataclass
class ScanBridgePlan:
    """A lowered scan operator plus everything the runner needs."""

    stencil: ir.Stencil
    analysis: Any
    backend: Any  # CudaBackend
    axis_of: Dict[str, int]
    field_params: List[Tuple[str, Tuple[Dimension, ...], Tuple[bool, bool, bool]]]
    scalar_params: List[str]
    #: result dims: union of field-arg dims in first-seen order
    out_dims: Tuple[Dimension, ...]
    out_names: List[str]
    out_dtypes: List[np.dtype]
    is_tuple: bool
    #: parameter names bound to the call args (carry excluded)
    signature_order: List[str] = dataclasses.field(default_factory=list)
    #: run_scan_plan's domain arithmetic per argument domains
    run_cache: Dict[Any, Any] = dataclasses.field(default_factory=dict)

    #: concat_where compatibility with BridgePlan consumers
    cw_body = None

    @property
    def outs(self):
        """BridgePlan-compatible out descriptors: (name, dims, mask, dtype)
        per carry member (used by the program-fusion splicer)."""
        mask = [False, False, False]
        for d in self.out_dims:
            mask[self.axis_of[d.value]] = True
        mask = tuple(mask)
        return [
            (nm, tuple(self.out_dims), mask, dt)
            for nm, dt in zip(self.out_names, self.out_dtypes)
        ]


def _lower_scan_body(
    lw: _Lowerer,
    typed: fvir.OperatorIR,
    out_names: List[str],
    out_dtypes: List[np.dtype],
    subst: Dict[int, ir.Expr],
) -> List[ir.Stmt]:
    """Lower the scalarized scan body once under a carry substitution."""
    lw.carry_subst = subst
    body: List[ir.Stmt] = []
    stmts = list(typed.body)
    if not stmts or not isinstance(stmts[-1], fvir.Return):
        raise Ineligible("scan body must end in a return")
    for st in stmts[:-1]:
        if not isinstance(st, fvir.Assign) or st.unpack or len(st.targets) != 1:
            raise Ineligible(f"statement {type(st).__name__}")
        t = st.value.type
        if not isinstance(t, ts.ScalarType):
            raise Ineligible("non-scalar scan temporary")
        tname = st.targets[0]
        if tname in lw.field_names or tname in lw.scalar_names:
            raise Ineligible("parameter reassignment")
        expr = lw._expr(st.value)
        body.extend(lw.pending)
        lw.pending.clear()
        body.append(ir.Assign(target=ir.FieldAccess(name=tname), value=expr))
        lw.temp_decls[tname] = ir.FieldDecl(
            name=tname,
            dtype=np.dtype(t.kind),
            dimensions=(True, True, True),
            is_api=False,
        )
        lw.rename[tname] = tname
    rv = stmts[-1].value
    if len(out_names) == 1:
        elts = [rv]
    elif isinstance(rv, fvir.TupleExpr) and len(rv.elts) == len(out_names):
        elts = list(rv.elts)
    elif (
        isinstance(rv, fvir.Name)
        and rv.id == lw.carry_name
        and isinstance(rv.type, ts.TupleType)
        and len(rv.type.types) == len(out_names)
    ):
        # whole-tuple carry return (`return carry`): expand to synthetic
        # per-element subscripts so the carry substitution applies
        elts = [
            fvir.Subscript(loc=rv.loc, type=t, value=rv, index=i)
            for i, t in enumerate(rv.type.types)
        ]
    else:
        raise Ineligible("scan return is not a tuple literal")
    for name, e, dt in zip(out_names, elts, out_dtypes):
        et = e.type
        if not isinstance(et, ts.ScalarType):
            raise Ineligible("non-scalar scan return element")
        ex = lw._expr(e)
        body.extend(lw.pending)
        lw.pending.clear()
        if np.dtype(et.kind) != dt:
            ex = ir.Cast(dtype=dt, expr=ex)
        body.append(ir.Assign(target=ir.FieldAccess(name=name), value=ex))
    return body


def lower_scan_operator(
    typed: fvir.OperatorIR,
    *,
    axis: Dimension,
    forward: bool,
    init: Any,
    arg_info: List[Tuple[str, Any, Any]],
) -> ScanBridgePlan:
    """Lower a TYPED scan operator to a serial-K cartesian stencil.

    ``arg_info`` describes the RUNTIME call args aligned with
    ``typed.params[1:]``: ``("field", dims, dtype)`` or ``("scalar", dtype)``
    -- the typed signature scalarizes fields, so the lowering needs the
    call-site field structure.  Raises :class:`Ineligible` outside the
    subset (tuple inits with non-scalar elements, non-vertical scan axes,
    unstructured dims, ...).
    """
    if typed.kind != "scan_operator":
        raise Ineligible(typed.kind)
    if axis.kind != DimensionKind.VERTICAL:
        raise Ineligible("scan axis is not a vertical dimension")
    if not typed.params:
        raise Ineligible("scan without a carry parameter")

    lw = _Lowerer(typed)
    carry = typed.params[0]
    lw.carry_name = carry.name

    # carry structure -> out fields
    if isinstance(carry.type, ts.TupleType):
        if not isinstance(init, tuple) or len(init) != len(carry.type.types):
            raise Ineligible("init does not match the tuple carry")
        elem_types = list(carry.type.types)
        init_vals = list(init)
        is_tuple = True
    else:
        elem_types = [carry.type]
        init_vals = [init]
        is_tuple = False
    out_names = (
        [f"__out_{i}" for i in range(len(elem_types))] if is_tuple else ["__out"]
    )
    out_dtypes: List[np.dtype] = []
    init_exprs: List[ir.Expr] = []
    for t, v in zip(elem_types, init_vals):
        if not isinstance(t, ts.ScalarType):
            raise Ineligible(f"carry element of type {t}")
        dt = np.dtype(t.kind)
        if isinstance(v, torch.Tensor) and v.ndim == 0:
            v = v.item()
        if not isinstance(v, (bool, int, float, np.generic)):
            raise Ineligible(f"init of type {type(v).__name__}")
        out_dtypes.append(dt)
        init_exprs.append(ir.Literal(value=dtypes.scalar_value(v, dt), dtype=dt))

    # parameters: fields keep their call-site dims, the rest are scalars
    field_params: List[Tuple[str, Tuple[Dimension, ...], Tuple[bool, bool, bool]]] = []
    scalar_params: List[str] = []
    params = typed.params[1:]
    if len(params) != len(arg_info):
        raise Ineligible("argument/parameter arity mismatch")
    out_dims: List[Dimension] = []
    for p, info in zip(params, arg_info):
        if info[0] == "field":
            _, dims, dtype = info
            lw._register_dims(tuple(dims))
            lw.field_names.add(p.name)
            for d in dims:
                if d not in out_dims:
                    out_dims.append(d)
        else:
            lw.scalar_names.add(p.name)
            scalar_params.append(p.name)
    if axis.value not in lw.axis_of or lw.axis_of[axis.value] != 2:
        raise Ineligible("no field argument spans the scan axis")
    for p, info in zip(params, arg_info):
        if info[0] == "field":
            _, dims, dtype = info
            mask = lw._mask(tuple(dims))
            lw.field_decls[p.name] = ir.FieldDecl(
                name=p.name, dtype=np.dtype(dtype), dimensions=mask
            )
            field_params.append((p.name, tuple(dims), mask))
        else:
            if not isinstance(p.type, ts.ScalarType):
                raise Ineligible(f"scalar parameter of type {p.type}")
            lw.scalar_decls[p.name] = ir.ScalarDecl(
                name=p.name, dtype=np.dtype(p.type.kind)
            )

    out_mask = lw._mask(tuple(out_dims))
    for nm, dt in zip(out_names, out_dtypes):
        lw.field_decls[nm] = ir.FieldDecl(name=nm, dtype=dt, dimensions=out_mask)

    # two sections: the first written level seeds the carry with the init
    # literal; the rest read the out field at the serial K offset
    if forward:
        order = ir.LoopOrder.FORWARD
        init_iv = ir.Interval(ir.AxisBound.start(0), ir.AxisBound.start(1))
        rest_iv = ir.Interval(ir.AxisBound.start(1), ir.AxisBound.end(0))
        koff = -1
    else:
        order = ir.LoopOrder.BACKWARD
        init_iv = ir.Interval(ir.AxisBound.end(-1), ir.AxisBound.end(0))
        rest_iv = ir.Interval(ir.AxisBound.start(0), ir.AxisBound.end(-1))
        koff = 1
    subst_init = dict(enumerate(init_exprs))
    subst_rest = {
        i: ir.FieldAccess(name=nm, offset=ir.CartesianOffset(i=0, j=0, k=koff))
        for i, nm in enumerate(out_names)
    }
    body_init = _lower_scan_body(lw, typed, out_names, out_dtypes, subst_init)
    body_rest = _lower_scan_body(lw, typed, out_names, out_dtypes, subst_rest)

    api_params = (
        [ir.ApiParam(name=n, is_field=True) for n, _, _ in field_params]
        + [ir.ApiParam(name=nm, is_field=True) for nm in out_names]
        + [ir.ApiParam(name=n, is_field=False) for n in scalar_params]
    )
    stencil = ir.Stencil(
        name=f"next_scan_{typed.name or 'op'}",
        api_params=api_params,
        field_decls=dict(lw.field_decls),
        scalar_decls=dict(lw.scalar_decls),
        temp_decls=dict(lw.temp_decls),
        vertical_loops=[
            ir.VerticalLoop(
                order,
                [
                    ir.VerticalSection(interval=init_iv, body=body_init),
                    ir.VerticalSection(interval=rest_iv, body=body_rest),
                ],
            )
        ],
    )

    try:
        analysis = analyze(stencil)
    except Exception as ex:  # validation errors -> embedded fallback
        raise Ineligible(f"cartesian analysis rejected: {ex}") from ex

    backend = CudaBackend(analysis)
    return ScanBridgePlan(
        stencil=stencil,
        analysis=analysis,
        backend=backend,
        axis_of=dict(lw.axis_of),
        field_params=field_params,
        scalar_params=scalar_params,
        out_dims=tuple(out_dims),
        out_names=out_names,
        out_dtypes=out_dtypes,
        is_tuple=is_tuple,
        signature_order=[p.name for p in params],
    )


def _plan_scan_run(plan: ScanBridgePlan, fields: Dict[str, Field]) -> _RunLayout:
    starts = [None, None, None]
    stops = [None, None, None]
    for n, dims, mask in plan.field_params:
        f = fields[n]
        for d, r in zip(f.domain.dims, f.domain.ranges):
            ax = plan.axis_of[d.value]
            starts[ax] = r.start if starts[ax] is None else max(starts[ax], r.start)
            stops[ax] = r.stop if stops[ax] is None else min(stops[ax], r.stop)

    out_axes = [plan.axis_of[d.value] for d in plan.out_dims]
    limit = 1 << 40  # UnitRange.infinite() sentinels are +-1<<60
    for ax in out_axes:
        if starts[ax] is None or starts[ax] < -limit or stops[ax] > limit:
            raise Ineligible("unbounded scan domain")
        if stops[ax] <= starts[ax]:
            raise Ineligible("empty scan domain")

    domain = tuple(
        (stops[ax] - starts[ax]) if starts[ax] is not None else 1
        for ax in range(3)
    )
    axes = {n: [plan.axis_of[d.value] for d in fields[n].domain.dims]
            for n, _, _ in plan.field_params}
    origins = {n: _origin3(starts, fields[n], axes[n]) for n, _, _ in plan.field_params}
    return _RunLayout(domain, starts, stops, origins, axes,
                      [out_axes] * len(plan.out_names), plan.backend)


def run_scan_plan(plan: ScanBridgePlan, args: Tuple[Any, ...]):
    """Execute a lowered scan on canonical (torch-converted) arguments:
    one call of the column kernel.

    The result domain replicates the embedded executor's merge: union of
    field-arg dims in first-seen order, intersection of shared ranges
    (builtins._merge_domains); inputs are read at zero extent, so there is
    no extent shrink.  Returns a Field or a tuple of Fields (tuple carry).
    """
    by_name = dict(zip(plan.signature_order, args))
    fields: Dict[str, Field] = {n: by_name[n] for n, _, _ in plan.field_params}
    scalars: Dict[str, Any] = {n: by_name[n] for n in plan.scalar_params}

    key = tuple(fields[n].domain for n, _, _ in plan.field_params)
    lay = plan.run_cache.get(key)
    if lay is None:
        lay = plan.run_cache[key] = _plan_scan_run(plan, fields)
    device = _device(fields.values())
    env = {n: _kernel_view(fields[n].data, lay.axes[n]) for n, _, _ in plan.field_params}
    origins = dict(lay.origins)
    out_axes = lay.out_axes[0]
    outs = []
    for nm, dt in zip(plan.out_names, plan.out_dtypes):
        out, env[nm] = _out_buffer(out_axes, lay.domain, dt, device)
        origins[nm] = (0, 0, 0)
        outs.append(out)

    got = _apply(lay.backend, env, scalars, lay.domain, origins)
    outs = [_from_kernel_view(got[nm], out_axes) if nm in got else out
            for nm, out in zip(plan.out_names, outs)]

    dom = Domain(
        tuple(plan.out_dims),
        tuple(UnitRange(lay.starts[ax], lay.stops[ax]) for ax in out_axes),
    )
    results = [Field(dom, _to_declared(o, out_axes)) for o in outs]
    return tuple(results) if plan.is_tuple else results[0]


# --------------------------------------------------------------------------- #
# Programs -> one fused multi-output kernel + boundary strips
# --------------------------------------------------------------------------- #
#
# A multi-statement ``@program`` dispatched per operator pays one
# device-memory round trip per statement for every intermediate Field.
# The reference fuses across statements with global-temporaries
# extraction + as_fieldop fusion (reference:
# src/gt4py/next/iterator/transforms/global_tmps.py:312,
# fuse_as_fieldop.py:245).  The equivalent here: splice every statement's
# already-lowered cartesian kernel body into ONE stencil -- intermediates
# become kernel temporaries (registers or scratch, as the generator
# decides) -- over the INTERSECTION of the statements' write domains, and
# complete each intermediate's halo region (its write domain minus the
# intersection) with thin restricted runs of the statement's own kernels
# (O(n*halo) work vs the fused kernel's O(n^2)).
#
# Semantics replicated exactly (the embedded executor is the spec):
# each statement writes ``out_i`` over TD_i = explicit domain= or
# intersect(result domain, out buffer domain); a later statement reading
# a written parameter sees new values inside TD_i and the ORIGINAL
# buffer content outside.  The fused kernel binds later reads to the
# producing temporary, which holds formula values everywhere computed --
# so fusion gates on every cross-statement read landing inside the
# producer's TD_i (checked per call on the static Field domains); any
# violation falls back to the per-statement path, same numerics.


@dataclasses.dataclass
class ProgramStmt:
    """One lowered ``op(args..., out=..., domain=...)`` statement."""

    op_name: str
    plan: BridgePlan
    #: per op positional parameter (signature order):
    #: ("field", prog_param) | ("scalar", prog_param) | ("literal", value)
    bindings: List[Tuple[str, Any]]
    #: per returned member: (prog out param, relative slices or None)
    targets: List[Tuple[str, Optional[Tuple]]]
    domain_expr: Optional[Any]  # fvir node for domain=, or None
    #: the originating fvir statement (interpreted-path fallback)
    src: Optional[Any] = None
    #: scan statements splice as their own serial vertical loop
    is_scan: bool = False
    #: concat_where statements splice as their own K-sectioned loop
    is_cw: bool = False


@dataclasses.dataclass
class ProgramBridgePlan:
    typed: Any  # the program's typed OperatorIR
    stmts: List[ProgramStmt]
    axis_of: Dict[str, int]
    #: runtime instances (or cached Ineligible) keyed by domain signature
    instances: Dict[Any, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ProgramSchedule:
    """Execution schedule of a program under fusion: maximal runs of
    eligible operator statements become fused segments (one kernel +
    strips each); everything else (scan statements, collection targets,
    concat_where operators, expression args) stays an interpreted
    statement executed in order between them."""

    #: ("fused", ProgramBridgePlan) | ("interp", fvir.Stmt)
    items: List[Tuple[str, Any]]


def _lower_program_stmt(typed, st, axis_of, fuse_serial=True) -> ProgramStmt:
    """Lower one ``op(args..., out=...)`` statement against (and
    extending) ``axis_of``; raises :class:`Ineligible` outside the
    fusible subset.  ``fuse_serial=False`` declines scan/concat_where
    statements (the conservative r4-style schedule used when a
    full-fusion instance fails its per-call gates)."""
    from .ffront import FieldOperator, ScanOperator

    param_types = {p.name: p.type for p in typed.params}
    if not (
        isinstance(st, fvir.Assign)
        and not st.targets
        and isinstance(st.value, fvir.Call)
    ):
        raise Ineligible(f"program statement {type(st).__name__}")
    call = st.value
    if not isinstance(call.func, fvir.Name):
        raise Ineligible("computed operator reference")
    fn = typed.closure.get(call.func.id)
    is_scan = isinstance(fn, ScanOperator)
    if not isinstance(fn, FieldOperator):
        raise Ineligible(
            f"statement calls {type(fn).__name__} (only field/scan "
            "operators fuse)"
        )
    extra = set(call.kwargs) - {"out", "domain"}
    if extra:
        raise Ineligible(f"call kwargs {sorted(extra)}")
    out_expr = call.kwargs.get("out")
    if out_expr is None:
        raise Ineligible("operator statement without out=")
    bindings: List[Tuple[str, Any]] = []
    for a in call.args:
        if isinstance(a, fvir.Name) and a.id in param_types:
            t = a.type
            if isinstance(t, ts.FieldType):
                bindings.append(("field", a.id))
            elif isinstance(t, ts.ScalarType):
                bindings.append(("scalar", a.id))
            else:
                raise Ineligible(f"argument of type {t}")
        elif isinstance(a, fvir.Literal) and isinstance(a.type, ts.ScalarType):
            bindings.append(("literal", dtypes.make_scalar(a.value, a.type.kind)))
        else:
            raise Ineligible(f"argument {type(a).__name__}")
    try:
        if is_scan:
            # scan statements lower through the serial-K scan path (the
            # r4 gap: a FORWARD/BACKWARD statement now JOINS the fused
            # segment as its own vertical loop -- VERDICT r4 #3)
            scalar_ts = []
            arg_info = []
            for a in call.args:
                if isinstance(a.type, ts.FieldType):
                    dt = np.dtype(a.type.dtype.kind)
                    scalar_ts.append(ts.ScalarType(dt))
                    arg_info.append(("field", tuple(a.type.dims), dt))
                else:
                    scalar_ts.append(a.type)
                    arg_info.append(
                        (
                            "scalar",
                            np.dtype(a.type.kind)
                            if isinstance(a.type, ts.ScalarType)
                            else None,
                        )
                    )
            op_typed = fn._scan_typed(scalar_ts)
            plan = lower_scan_operator(
                op_typed,
                axis=fn.axis,
                forward=fn.forward,
                init=fn.init,
                arg_info=arg_info,
            )
        else:
            op_typed, _ = fn._typed_for(tuple(a.type for a in call.args))
            plan = lower_field_operator(op_typed)
    except Ineligible:
        raise
    except Exception as ex:
        raise Ineligible(f"operator typing failed: {ex}") from ex
    is_cw = getattr(plan, "cw_body", None) is not None
    if (is_scan or is_cw) and not fuse_serial:
        raise Ineligible("serial/sectioned statement (conservative schedule)")
    # spliced bodies reuse each op's i/j/k offset meaning: the
    # dimension->axis maps must agree within a segment
    trial = dict(axis_of)
    for dval, ax in plan.axis_of.items():
        if trial.setdefault(dval, ax) != ax:
            raise Ineligible("inconsistent dimension->axis maps")

    def target_spec(e):
        if isinstance(e, fvir.Name):
            if e.id not in param_types:
                raise Ineligible("out target is not a program parameter")
            return (e.id, None)
        if isinstance(e, fvir.FieldSlice) and isinstance(e.value, fvir.Name):
            if e.value.id not in param_types:
                raise Ineligible("out target is not a program parameter")
            return (e.value.id, tuple(e.slices))
        raise Ineligible(f"out target {type(e).__name__}")

    if isinstance(out_expr, fvir.TupleExpr):
        targets = [target_spec(x) for x in out_expr.elts]
    else:
        targets = [target_spec(out_expr)]
    if len(targets) != len(plan.outs):
        raise Ineligible("out arity mismatch")
    axis_of.clear()
    axis_of.update(trial)
    return ProgramStmt(
        call.func.id,
        plan,
        bindings,
        targets,
        call.kwargs.get("domain"),
        is_scan=is_scan,
        is_cw=is_cw,
    )


def _interp_assigned_names(stmt) -> set:
    """Names an interpreted schedule item may (re)bind in the
    interpreter's environment: Assign targets anywhere in the statement
    (IfStmt branches included)."""
    names = set()
    for n in stmt.walk():
        if isinstance(n, fvir.Assign):
            names.update(n.targets)
    return names


def _plan_env_refs(pplan: "ProgramBridgePlan") -> set:
    """Program-env names a fused segment binds at run time: field/scalar
    argument bindings, out-target parameters, and names inside domain=
    expressions."""
    refs = set()
    for ps in pplan.stmts:
        for kind, q in ps.bindings:
            if kind in ("field", "scalar"):
                refs.add(q)
        for name, _slices in ps.targets:
            refs.add(name)
        if ps.domain_expr is not None:
            for n in ps.domain_expr.walk():
                if isinstance(n, fvir.Name):
                    refs.add(n.id)
    return refs


def _demote_shadowed_segments(items) -> None:
    """Fused segments bind program parameters from the ORIGINAL env, but
    interpreted items run in a forked copy where local assignments can
    shadow parameters.  A fused segment scheduled after such an
    assignment would silently keep reading/writing the original
    parameter while interpreted statements see the local -- diverging
    from the embedded single-env semantics.  Demote any such segment to
    per-statement interpretation (same numerics, no fusion)."""
    shadowed: set = set()
    out = []
    for kind, payload in items:
        if kind == "fused" and shadowed and (_plan_env_refs(payload) & shadowed):
            out.extend(("interp", ps.src) for ps in payload.stmts)
            continue
        if kind == "interp":
            shadowed |= _interp_assigned_names(payload)
        out.append((kind, payload))
    items[:] = out


def lower_program(typed: fvir.OperatorIR, fuse_serial: bool = True) -> ProgramSchedule:
    """Structurally schedule a TYPED program for fusion: consecutive
    eligible operator statements group into fused segments (each ONE
    kernel + strips at run time); ineligible statements (scans,
    collection targets, expression args, concat_where operators) become
    interpreted items between segments -- a mixed dycore-style program
    keeps every fusible run fused instead of losing fusion wholesale.
    Domain math happens per call, on the Fields' domains, in
    :func:`_build_instance`."""
    if typed.kind != "program":
        raise Ineligible(typed.kind)
    items: List[Tuple[str, Any]] = []
    cur: List[ProgramStmt] = []
    cur_axis: Dict[str, int] = {}

    def flush():
        nonlocal cur, cur_axis
        if len(cur) >= 2:
            items.append(("fused", ProgramBridgePlan(typed, cur, dict(cur_axis))))
        else:
            for ps in cur:
                items.append(("interp", ps.src))
        cur, cur_axis = [], {}

    for st in typed.body:
        if (
            isinstance(st, fvir.Assign)
            and not st.targets
            and isinstance(st.value, fvir.Literal)
        ):
            continue  # docstring no-op
        try:
            ps = _lower_program_stmt(typed, st, cur_axis, fuse_serial)
        except Ineligible:
            # maybe the statement only conflicts with THIS segment's
            # axis map: retry against a fresh one
            flush()
            try:
                ps = _lower_program_stmt(typed, st, cur_axis, fuse_serial)
            except Ineligible:
                flush()
                items.append(("interp", st))
                continue
        ps.src = st
        cur.append(ps)
    flush()
    _demote_shadowed_segments(items)
    if not any(k == "fused" for k, _ in items):
        ex = Ineligible(
            "no fusible run of operator statements (the per-operator "
            "kernel path already handles single statements)"
        )
        ex.quiet = True  # not a perf cliff: no user-facing warning
        raise ex
    return ProgramSchedule(items)


@dataclasses.dataclass
class _MemberWrite:
    out_name: str  # fused API out field
    temp_name: str  # the producing in-kernel temporary
    prog_param: str
    member_idx: int
    dims: Tuple  # member dims in declared (== buffer) order
    axes: List[int]
    dtype: np.dtype
    #: absolute write region per axis of the member
    td: Dict[int, Tuple[int, int]]
    #: halo completion boxes: each a restrict list [(dval, lo, hi), ...]
    strips: List[List[Tuple[str, int, int]]]


@dataclasses.dataclass
class _FusedInstance:
    backend: Any  # CudaBackend over the fused stencil
    analysis: Any
    domain: Tuple[int, int, int]
    starts: List[Optional[int]]  # absolute D start per axis (None: unused)
    in_fields: List[str]  # program params fed as kernel inputs
    #: fused scalar name -> ("scalar", prog name) | ("literal", value)
    scalar_feeds: List[Tuple[str, Tuple[str, Any]]]
    stmt_writes: List[List[_MemberWrite]]
    #: per statement: the op plan whose kernels run the thin strips
    #: (None: the statement has no strips)
    strip_plans: List[Optional[BridgePlan]]


def _rename_accesses(nodes, fmap: Dict[str, str], smap: Dict[str, str]) -> None:
    # alias-safe: a node reused at several expression positions must be
    # renamed ONCE (a second visit could chain through a colliding map
    # key; hazard class of jax_backend._rewrite_section_for_planes)
    seen: set = set()
    for n in ir.walk_values(nodes):
        if id(n) in seen:
            continue
        seen.add(id(n))
        if isinstance(n, ir.FieldAccess) and n.name in fmap:
            n.name = fmap[n.name]
        elif isinstance(n, ir.ScalarAccess) and n.name in smap:
            n.name = smap[n.name]


def _stmt_windows(pstmt: ProgramStmt, env: Dict[str, Any]):
    """The statement's result window per axis (run_plan's domain math)."""
    ext = pstmt.plan.analysis.extents
    starts: List[Optional[int]] = [None, None, None]
    stops: List[Optional[int]] = [None, None, None]
    by_name = dict(zip(pstmt.plan.signature_order, pstmt.bindings))
    for n, dims, mask in pstmt.plan.field_params:
        kind, q = by_name[n]
        f = env[q]
        e = ext.field_extents.get(n)
        if e is None:
            continue
        spans = (e.i, e.j, e.k)
        for d, r in zip(f.domain.dims, f.domain.ranges):
            ax = pstmt.plan.axis_of[d.value]
            lo, hi = spans[ax]
            s, t = r.start - lo, r.stop - hi
            starts[ax] = s if starts[ax] is None else max(starts[ax], s)
            stops[ax] = t if stops[ax] is None else min(stops[ax], t)
    return starts, stops


def _instance_key(pplan: ProgramBridgePlan, env: Dict[str, Any], dom_vals):
    parts = []
    for p in pplan.typed.params:
        v = env.get(p.name)
        if isinstance(v, Field):
            parts.append(
                (
                    p.name,
                    tuple(d.value for d in v.domain.dims),
                    tuple((int(r.start), int(r.stop)) for r in v.domain.ranges),
                    str(np.dtype(v.dtype)),
                    tuple(v.data.shape),
                )
            )
    return (tuple(parts), tuple(dom_vals))


def _eval_stmt_domains(pplan: ProgramBridgePlan, env: Dict[str, Any]):
    """Evaluate each statement's domain= expression to a static tuple
    ((dval, start, stop), ...) or None.  Values that do not evaluate to a
    domain -> Ineligible."""
    from .common import domain_like
    from .interpreter import Interpreter

    out = []
    full_env = dict(pplan.typed.closure)
    full_env.update(env)
    for st in pplan.stmts:
        if st.domain_expr is None:
            out.append(None)
            continue
        try:
            d = domain_like(Interpreter(pplan.typed, full_env).eval(st.domain_expr))
            out.append(
                tuple(
                    (dd.value, int(r.start), int(r.stop))
                    for dd, r in zip(d.dims, d.ranges)
                )
            )
        except Exception as ex:
            raise Ineligible(f"domain= not statically evaluable: {ex}") from ex
    return out


def _build_instance(
    pplan: ProgramBridgePlan, env: Dict[str, Any], dom_vals
) -> _FusedInstance:
    import copy

    axis_of = pplan.axis_of
    axis_dim: Dict[int, str] = {}

    # ---- per-statement write regions (embedded _write_out math) ---- #
    all_writes: List[List[dict]] = []
    for pstmt, dval in zip(pplan.stmts, dom_vals):
        starts, stops = _stmt_windows(pstmt, env)
        if pstmt.is_cw:
            # concat_where: the K window comes from the runtime piece
            # algebra on the ARG domains, not the extent hull
            by_name_cw = dict(zip(pstmt.plan.signature_order, pstmt.bindings))
            cw_fields = {
                n: env[by_name_cw[n][1]]
                for n, _dims, _mask in pstmt.plan.field_params
            }
            starts[2], stops[2] = _cw_k_window(pstmt.plan, cw_fields)
        writes = []
        for mi, ((nm, dims, mask, dt), (prog_param, slices)) in enumerate(
            zip(pstmt.plan.outs, pstmt.targets)
        ):
            parent = env[prog_param]
            if not isinstance(parent, Field):
                raise Ineligible(f"out parameter '{prog_param}' is not a Field")
            if tuple(parent.domain.dims) != tuple(dims):
                raise Ineligible("out buffer dims order differs from the result")
            for ax_i, d in enumerate(parent.domain.dims):
                if parent.data.shape[ax_i] != len(parent.domain.ranges[ax_i]):
                    raise Ineligible("broadcast-backed out buffer")
            if slices is not None:
                try:
                    outdom, _ = parent._slice_spec(
                        tuple(slice(lo, hi) for lo, hi in slices)
                    )
                except Exception as ex:
                    raise Ineligible(f"out slice: {ex}") from ex
            else:
                outdom = parent.domain
            axes = [axis_of[d.value] for d in dims]
            for d in dims:
                axis_dim[axis_of[d.value]] = d.value
            td: Dict[int, Tuple[int, int]] = {}
            if dval is not None:
                dmap = {v: (s, t) for v, s, t in dval}
                if set(dmap) != {d.value for d in dims}:
                    raise Ineligible("domain= dims mismatch")
                for d in dims:
                    ax = axis_of[d.value]
                    s, t = dmap[d.value]
                    rs, rt = starts[ax], stops[ax]
                    od = outdom[d]
                    if rs is None or s < rs or t > rt or s < od.start or t > od.stop:
                        # the embedded path raises the located error
                        raise Ineligible("domain= outside result/out coverage")
                    td[ax] = (s, t)
            else:
                for d in dims:
                    ax = axis_of[d.value]
                    rs, rt = starts[ax], stops[ax]
                    if rs is None:
                        raise Ineligible("output dimension unconstrained by any input")
                    od = outdom[d]
                    s, t = max(rs, od.start), min(rt, od.stop)
                    if t <= s:
                        raise Ineligible("empty statement write domain")
                    td[ax] = (s, t)
            writes.append(
                dict(
                    member_idx=mi,
                    prog_param=prog_param,
                    dims=tuple(dims),
                    axes=axes,
                    dtype=dt,
                    td=td,
                )
            )
        all_writes.append(writes)

    # ---- fused compute domain D = intersection of write regions ---- #
    D: Dict[int, Tuple[int, int]] = {}
    for writes in all_writes:
        for w in writes:
            for ax, (s, t) in w["td"].items():
                if ax in D:
                    D[ax] = (max(D[ax][0], s), min(D[ax][1], t))
                else:
                    D[ax] = (s, t)
    for ax, (s, t) in D.items():
        if t <= s:
            raise Ineligible("empty fused domain (disjoint statement domains)")
    starts3: List[Optional[int]] = [None, None, None]
    domain = [1, 1, 1]
    for ax, (s, t) in D.items():
        starts3[ax] = s
        domain[ax] = t - s

    # ---- splice the per-op kernels into one stencil ---- #
    # Statements splice IN ORDER: consecutive PARALLEL operator bodies
    # share one section; a scan statement contributes its own
    # FORWARD/BACKWARD vertical loop (vertical_loops execute
    # sequentially, so cross-statement dataflow through temps is
    # preserved).  Scan writes must cover the fused K domain EXACTLY:
    # truncating a scan changes its semantics (unlike pointwise
    # statements, which complete halo regions with strips).
    current: Dict[str, str] = {}  # prog out param -> producing temp
    loops: List[ir.VerticalLoop] = []
    fused_body: List[ir.Stmt] = []

    def flush_parallel():
        nonlocal fused_body
        if fused_body:
            loops.append(
                ir.VerticalLoop(
                    ir.LoopOrder.PARALLEL,
                    [
                        ir.VerticalSection(
                            interval=ir.Interval(
                                ir.AxisBound.start(0), ir.AxisBound.end(0)
                            ),
                            body=fused_body,
                        )
                    ],
                )
            )
            fused_body = []
    temp_decls: Dict[str, ir.FieldDecl] = {}
    field_decls: Dict[str, ir.FieldDecl] = {}
    scalar_decls: Dict[str, ir.ScalarDecl] = {}
    in_fields: List[str] = []
    out_names: List[str] = []
    scalar_feeds: List[Tuple[str, Tuple[str, Any]]] = []
    stmt_writes: List[List[_MemberWrite]] = []
    strip_plans: List[Optional[BridgePlan]] = []

    for si, (pstmt, writes) in enumerate(zip(pplan.stmts, all_writes)):
        plan = pstmt.plan
        sten = copy.deepcopy(plan.stencil)
        by_name = dict(zip(plan.signature_order, pstmt.bindings))
        fmap: Dict[str, str] = {}
        smap: Dict[str, str] = {}
        for pname, dims, mask in plan.field_params:
            kind, q = by_name[pname]
            if q in current:
                fmap[pname] = current[q]
            else:
                fmap[pname] = q
                if q not in field_decls:
                    decl = sten.field_decls[pname]
                    field_decls[q] = ir.FieldDecl(
                        name=q,
                        dtype=decl.dtype,
                        dimensions=decl.dimensions,
                        data_dims=decl.data_dims,
                    )
                    in_fields.append(q)
        for sname in plan.scalar_params:
            kind, qv = by_name[sname]
            new = f"__sc{si}_{sname}"
            smap[sname] = new
            scalar_decls[new] = ir.ScalarDecl(
                name=new, dtype=sten.scalar_decls[sname].dtype
            )
            scalar_feeds.append((new, (kind, qv)))
        for tname, decl in sten.temp_decls.items():
            new = f"__p{si}_{tname}"
            fmap[tname] = new
            temp_decls[new] = ir.FieldDecl(
                name=new,
                dtype=decl.dtype,
                dimensions=decl.dimensions,
                data_dims=decl.data_dims,
                is_api=False,
            )
        mwrites: List[_MemberWrite] = []
        for w, (nm, dims, mask, dt) in zip(writes, plan.outs):
            tnew = f"__t{si}_{w['member_idx']}"
            fmap[nm] = tnew
            temp_decls[tnew] = ir.FieldDecl(
                name=tnew, dtype=dt, dimensions=(True, True, True), is_api=False
            )
        if pstmt.is_scan:
            # truncated scans are a different computation: the statement
            # write region must equal the fused domain on EVERY axis
            for w in writes:
                for ax, (s, t) in w["td"].items():
                    if (s, t) != D[ax]:
                        raise Ineligible(
                            "scan statement write region differs from the "
                            "fused domain (cannot truncate a scan)"
                        )
            # ...and the embedded spec COMPUTES the scan over the full
            # vertical intersection of its ARGS, then restricts only the
            # write (ffront._scan_impl -> _write_out).  A fused domain
            # narrower than the args' vertical range would re-seed the
            # carry mid-column (caught by fuzz seeds 3127/3147).
            vlo = vhi = None
            for kind, q in pstmt.bindings:
                if kind != "field":
                    continue
                f = env[q]
                for d, r in zip(f.domain.dims, f.domain.ranges):
                    if pstmt.plan.axis_of.get(d.value) == 2:
                        vlo = r.start if vlo is None else max(vlo, r.start)
                        vhi = r.stop if vhi is None else min(vhi, r.stop)
            if vlo is not None and (2 not in D or (vlo, vhi) != D[2]):
                raise Ineligible(
                    "scan statement computes over a wider vertical range "
                    "than the fused domain (carry would re-seed)"
                )
            flush_parallel()
            # the scan's K-carry self-read (k-+1 inside the serial
            # sections) does NOT trip the stale-halo gate: G2's K demand
            # is interval-aware (compute_k_boundary), and the carry
            # offsets cancel against their sections' interval anchors
            for loop in sten.vertical_loops:
                secs = []
                for sec in loop.sections:
                    body = copy.deepcopy(sec.body)
                    _rename_accesses(body, fmap, smap)
                    secs.append(
                        ir.VerticalSection(interval=sec.interval, body=body)
                    )
                loops.append(ir.VerticalLoop(loop.loop_order, secs))
        elif pstmt.is_cw:
            # concat_where statements splice as their own K-sectioned
            # PARALLEL loop (the r4 per-operator section machinery over
            # the fused K domain) -- boundary-condition programs keep
            # fusion (VERDICT r4 #5).  Sections are relative to the
            # kernel K domain, so the statement's K window must equal it
            # (I/J halo regions still complete via strips).
            for w in writes:
                if w["td"].get(2) != D.get(2):
                    raise Ineligible(
                        "concat_where statement K window differs from the "
                        "fused domain"
                    )
            flush_parallel()
            k0, k1 = D[2]
            cuts = set()
            for entry in plan.cw_body:
                if isinstance(entry, CwSlot):
                    for bnd in (entry.lo, entry.hi):
                        if bnd is not None and k0 < bnd < k1:
                            cuts.add(bnd)
            out_nm = {nm for nm, _d, _m, _t in plan.outs}
            edges = [k0] + sorted(cuts) + [k1]
            secs = []
            for a, b in zip(edges, edges[1:]):
                body_r: List[ir.Stmt] = []
                for entry in plan.cw_body:
                    if isinstance(entry, CwSlot):
                        active = (entry.lo is None or entry.lo <= a) and (
                            entry.hi is None or b <= entry.hi
                        )
                        body_r.append(
                            ir.Assign(
                                target=ir.FieldAccess(name=entry.target),
                                value=copy.deepcopy(
                                    entry.t_expr if active else entry.f_expr
                                ),
                            )
                        )
                    else:
                        body_r.append(copy.deepcopy(entry))
                body_r = _cw_dce(body_r, out_nm)
                _rename_accesses(body_r, fmap, smap)
                secs.append(
                    ir.VerticalSection(
                        interval=ir.Interval(
                            ir.AxisBound.start(a - k0),
                            ir.AxisBound.start(b - k0)
                            if b < k1
                            else ir.AxisBound.end(0),
                        ),
                        body=body_r,
                    )
                )
            loops.append(ir.VerticalLoop(ir.LoopOrder.PARALLEL, secs))
        else:
            body = [
                s
                for loop in sten.vertical_loops
                for sec in loop.sections
                for s in sec.body
            ]
            _rename_accesses(body, fmap, smap)
            fused_body.extend(body)
        for w, (nm, dims, mask, dt) in zip(writes, plan.outs):
            tnew = fmap[nm]
            po = f"__po{si}_{w['member_idx']}"
            field_decls[po] = ir.FieldDecl(name=po, dtype=dt, dimensions=mask)
            out_names.append(po)
            fused_body.append(
                ir.Assign(target=ir.FieldAccess(name=po), value=ir.FieldAccess(name=tnew))
            )
            # halo completion boxes: td \ D, peeled per axis
            strips: List[List[Tuple[str, int, int]]] = []
            cur = dict(w["td"])
            for ax in sorted(cur):
                lo, hi = cur[ax]
                dlo, dhi = D[ax]
                if lo < dlo:
                    strips.append(
                        [
                            (axis_dim[a], (lo, dlo) if a == ax else cur[a])
                            for a in sorted(cur)
                        ]
                    )
                if hi > dhi:
                    strips.append(
                        [
                            (axis_dim[a], (dhi, hi) if a == ax else cur[a])
                            for a in sorted(cur)
                        ]
                    )
                cur[ax] = (max(lo, dlo), min(hi, dhi))
            strips = [
                [(dv, r[0], r[1]) for dv, r in box] for box in strips
            ]
            mwrites.append(
                _MemberWrite(
                    out_name=po,
                    temp_name=fmap[nm],
                    prog_param=w["prog_param"],
                    member_idx=w["member_idx"],
                    dims=w["dims"],
                    axes=w["axes"],
                    dtype=dt,
                    td=w["td"],
                    strips=strips,
                )
            )
            current[w["prog_param"]] = tnew
        stmt_writes.append(mwrites)
        strip_plans.append(plan if any(m.strips for m in mwrites) else None)

    api = (
        [ir.ApiParam(name=n, is_field=True) for n in in_fields]
        + [ir.ApiParam(name=n, is_field=True) for n in out_names]
        + [ir.ApiParam(name=n, is_field=False) for n, _ in scalar_feeds]
    )
    flush_parallel()
    stencil = ir.Stencil(
        name=f"next_prog_{pplan.typed.name or 'program'}",
        api_params=api,
        field_decls=field_decls,
        scalar_decls=scalar_decls,
        temp_decls=temp_decls,
        vertical_loops=loops,
    )
    try:
        analysis = analyze(stencil)
    except Exception as ex:
        raise Ineligible(f"cartesian analysis rejected the fusion: {ex}") from ex

    # ---- gates on the static domains ---- #
    ext = analysis.extents
    # (G2) every cross-statement read of an intermediate must land inside
    # the producer's written region: demand(temp) within td - D.  The K
    # demand uses the INTERVAL-AWARE k_boundary (K-sectioned reads --
    # concat_where interior branches, scan seeds -- demand less than the
    # extent hull says).
    kb = compute_k_boundary_resolved(
        stencil,
        domain[2],
        names=[m.temp_name for writes in stmt_writes for m in writes],
        extents=ext,
    )
    for writes in stmt_writes:
        for m in writes:
            fe = ext.field_extents.get(m.temp_name)
            if fe is None:
                continue
            kb0, kb1 = kb.get(m.temp_name, (0, 0))
            spans = (fe.i, fe.j, (-kb0, kb1))
            for ax in m.td:
                lo, hi = spans[ax]
                e_lo = m.td[ax][0] - D[ax][0]
                e_hi = m.td[ax][1] - D[ax][1]
                if lo < e_lo or hi > e_hi:
                    raise Ineligible(
                        f"statement reads '{m.prog_param}' outside the region "
                        "written by its producer (stale halo content)"
                    )
    # input halo coverage (guaranteed by the domain math; safety net)
    for q in in_fields:
        f = env[q]
        b = ext.boundary(q)
        blo = b.lower_indices
        bhi = b.upper_indices
        for d, r in zip(f.domain.dims, f.domain.ranges):
            ax = axis_of[d.value]
            if starts3[ax] is None:
                continue
            org = starts3[ax] - r.start
            if org < blo[ax] or org + domain[ax] + bhi[ax] > len(r):
                raise Ineligible(f"input '{q}' does not cover the fused halo")

    return _FusedInstance(
        backend=CudaBackend(analysis),
        analysis=analysis,
        domain=tuple(domain),
        starts=starts3,
        in_fields=in_fields,
        scalar_feeds=scalar_feeds,
        stmt_writes=stmt_writes,
        strip_plans=strip_plans,
    )


def prepare_program_plan(pplan: ProgramBridgePlan, env: Dict[str, Any]):
    """Per-call planning (domain algebra + gates + instance build) WITHOUT
    executing: lets a mixed schedule validate every fused segment before
    any holder is mutated, so a per-call fallback stays atomic."""
    dom_vals = _eval_stmt_domains(pplan, env)
    key = _instance_key(pplan, env, dom_vals)
    inst = pplan.instances.get(key)
    if inst is None:
        try:
            inst = _build_instance(pplan, env, dom_vals)
        except Ineligible as ex:
            pplan.instances[key] = ex
            raise
        pplan.instances[key] = inst
    if isinstance(inst, Ineligible):
        raise Ineligible(str(inst))
    return inst


def run_program_plan(pplan: ProgramBridgePlan, env: Dict[str, Any]) -> None:
    execute_program_instance(pplan, prepare_program_plan(pplan, env), env)


def execute_program_instance(
    pplan: ProgramBridgePlan, inst: "_FusedInstance", env: Dict[str, Any]
) -> None:
    """Execute a fused program segment on the current parameter values:
    one call of the fused stencil's kernels, then the strips, writing the
    out-parameter Fields' tensors in place (like the embedded
    interpreter).  The instance (fused stencil + kernels) is cached per
    domain signature."""
    device = _device([env[q] for q in inst.in_fields])
    # ---- kernel inputs ---- #
    views: Dict[str, Any] = {}
    origins: Dict[str, Tuple[int, int, int]] = {}
    for q in inst.in_fields:
        f = env[q]
        axes = [pplan.axis_of[d.value] for d in f.domain.dims]
        views[q] = _kernel_view(f.data, axes)
        origins[q] = tuple(
            ((inst.starts[ax] if inst.starts[ax] is not None
              else f.domain.ranges[axes.index(ax)].start)
             - f.domain.ranges[axes.index(ax)].start) if ax in axes else 0
            for ax in range(3)
        )
    outs: Dict[str, torch.Tensor] = {}
    for writes in inst.stmt_writes:
        for m in writes:
            outs[m.out_name], views[m.out_name] = _out_buffer(
                m.axes, inst.domain, m.dtype, device)
            origins[m.out_name] = (0, 0, 0)
    scalars = {
        new: (env[qv] if kind == "scalar" else qv)
        for new, (kind, qv) in inst.scalar_feeds
    }

    for nm, new in _apply(inst.backend, views, scalars, inst.domain, origins).items():
        m = next(m for writes in inst.stmt_writes for m in writes if m.out_name == nm)
        outs[nm] = _from_kernel_view(new, m.axes)

    # ---- assemble the out buffers in statement order ---- #
    def write_region(parent: Field, dims, region: Dict[int, Tuple[int, int]], value):
        idx = []
        for d in dims:
            ax = pplan.axis_of[d.value]
            own = parent.domain[d]
            s, t = region[ax]
            idx.append(slice(s - own.start, t - own.start))
        parent.data[tuple(idx)] = value

    for pstmt, writes, xplan in zip(pplan.stmts, inst.stmt_writes, inst.strip_plans):
        # strips read the PRE-statement buffers (embedded order)
        strip_vals = []
        if xplan is not None:
            args = tuple(
                env[qv] if kind != "literal" else qv
                for kind, qv in pstmt.bindings
            )
            for m in writes:
                for box in m.strips:
                    r = run_plan(xplan, args, restrict=tuple(box))
                    rm = r[m.member_idx] if xplan.is_tuple else r
                    region = {
                        pplan.axis_of[dv]: (s, t) for dv, s, t in box
                    }
                    strip_vals.append((m, region, rm.data))
        for m in writes:
            out = _to_declared(outs[m.out_name], m.axes)
            region = {ax: (inst.starts[ax], inst.starts[ax] + inst.domain[ax]) for ax in m.axes}
            write_region(env[m.prog_param], m.dims, region, out)
        for m, region, data in strip_vals:
            write_region(env[m.prog_param], m.dims, region, data)


def kernels_of(obj) -> List[CudaBackend]:
    """The kernel wrappers (``CudaBackend``s, each counting its launches in
    ``launches``) that a ``cuda``-backed field operator, scan operator or
    program has planned so far: its operators' plans, concat_where
    sections, fused program segments with the operators that run their
    strips, and the operators a program's interpreted statements call."""
    found: List[CudaBackend] = []

    def add(b):
        if isinstance(b, CudaBackend) and all(b is not x for x in found):
            found.append(b)

    def add_plan(plan):
        if plan is None:
            return
        add(plan.backend)
        for inst in getattr(plan, "cw_cache", {}).values():
            if isinstance(inst, tuple):
                add(inst[1])

    d = obj.__dict__
    for plan in list(d.get("_bridge_plans", {}).values()) + list(
            d.get("_scan_bridge_plans", {}).values()):
        add_plan(plan)
    for sched in d.get("_prog_bridge_plans", {}).values():
        for kind, payload in (sched.items if sched is not None else ()):
            if kind != "fused":
                continue
            for inst in payload.instances.values():
                if isinstance(inst, _FusedInstance):
                    add(inst.backend)
                    for plan in inst.strip_plans:
                        add_plan(plan)
    for op in d.get("_rebound_ops", {}).values():
        for b in kernels_of(op):
            add(b)
    return found
