"""``backend="cuda"``: CUDA C++ kernels generated from the analysed IR.

The counterpart of the JAX package's Pallas kernel generator,
``PallasBackend._pallas_trace`` (gt4py_tpu/cartesian/backend/
pallas_backend.py:1428), re-thought for Hopper (sm_90a).  Two hand-written
emitters turn each vertical loop into ``__global__`` kernels:

- **Row form** (K1, all-PARALLEL loops; Pallas ``_plan_rows``).  A loop
  section is split into *stages*: a new stage starts at each read, at a
  nonzero offset, of a field written earlier in the stage (and at each
  write of a field the stage already read at an offset).  Each stage is one
  kernel over its extended (I, J) rectangle from the extent analysis;
  ``threadIdx.x`` runs along J so loads coalesce, and K is a loop inside
  the thread.  Temporaries needed by a later stage live in scratch tensors
  the wrapper allocates; stage-local ones are registers.
- **Column form** (K2, FORWARD/BACKWARD loops; Pallas ``_plan_columns``).
  One kernel per loop, one thread per (i, j) column, the interval sections
  run in order, ascending or descending.  Recurrence reads such as
  ``dcol[0, 0, -1]`` read the level the same thread just wrote (scratch).
- **Periodic wrap** (K1a; Pallas ``_plan_segments``/``_circular_ok``).
  Reads of read-only API fields on a periodic axis wrap by index arithmetic
  in the load address; there is no fill pass.  A written field read at a
  horizontal offset is filled in its fresh output buffer before the kernels
  (the oracle's pre-run fill).

Types follow the oracle's C-style promotion: every operand is cast to the
promoted dtype and every literal is emitted exactly, in the dtype the
analysis gave it (hex floats with an ``f`` suffix in float32), so no float32
chain silently computes in double.

This backend does not inline temporaries (``passes.inline_parallel_
temporaries``, which the ``"jax"`` backend applies): the horizontal
diffusion is three row-form kernels.  IR outside the emitters' subset --
``while``, horizontal regions, variable or absolute K offsets, data
dimensions, 16-bit floats -- raises ``NotImplementedError`` when the
stencil is built.  Nothing falls back to the plain executor on the GPU: CPU
tensors run the plain executor (``torch_backend``), CUDA tensors run the
kernels or raise.
"""

from __future__ import annotations

import ctypes
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gt4py_tpu_torch.cartesian import ir
from gt4py_tpu_torch.cartesian.analysis import (
    StencilAnalysis,
    _stmt_reads,
    _stmt_writes,
    default_float_dtype,
    default_int_dtype,
    promote_dtypes,
)
from gt4py_tpu_torch.cartesian.backend import _build, register
from gt4py_tpu_torch.cartesian.backend.torch_backend import (
    TorchExecutor,
    check_periodic,
    has_horizontal_reads,
    periodic_fill,
    run_plain,
)
from gt4py_tpu_torch.core import dtypes
from gt4py_tpu_torch.core.definitions import Extent, is_float_dtype

#: the TPU kernels this backend replaces (file:line in the JAX package)
REPLACES = {
    "rows": "gt4py_tpu/cartesian/backend/pallas_backend.py:1428 "
            "PallasBackend._pallas_trace, row-tile form (_plan_rows :985)",
    "columns": "gt4py_tpu/cartesian/backend/pallas_backend.py:1428 "
               "PallasBackend._pallas_trace, column form (_plan_columns :1187)",
    "wrap": "gt4py_tpu/cartesian/backend/pallas_backend.py:1702 _plan_segments, "
            ":897 _circular_ok (periodic wrap inside the tile loads)",
}

#: threads per block along J (coalesced) and I
BLOCK_J, BLOCK_I = 64, 4

_CTYPE = {
    np.dtype(np.bool_): "bool",
    np.dtype(np.int8): "signed char",
    np.dtype(np.int16): "short",
    np.dtype(np.int32): "int",
    np.dtype(np.int64): "long long",
    np.dtype(np.uint8): "unsigned char",
    np.dtype(np.float32): "float",
    np.dtype(np.float64): "double",
}
_F32 = np.dtype(np.float32)
_F64 = np.dtype(np.float64)
_BOOL = np.dtype(np.bool_)

_BINOP_SYM = {
    ir.BinaryOperator.ADD: "+",
    ir.BinaryOperator.SUB: "-",
    ir.BinaryOperator.MUL: "*",
    ir.BinaryOperator.EQ: "==",
    ir.BinaryOperator.NE: "!=",
    ir.BinaryOperator.LT: "<",
    ir.BinaryOperator.LE: "<=",
    ir.BinaryOperator.GT: ">",
    ir.BinaryOperator.GE: ">=",
    ir.BinaryOperator.BIT_AND: "&",
    ir.BinaryOperator.BIT_OR: "|",
    ir.BinaryOperator.BIT_XOR: "^",
}

#: math builtin -> (float32 name, float64 name); integer arguments of
#: these compute in float64, as numpy's ufuncs do
_FLOAT_FUNCS = {
    ir.NativeFunction.SIN: ("sinf", "sin"),
    ir.NativeFunction.COS: ("cosf", "cos"),
    ir.NativeFunction.TAN: ("tanf", "tan"),
    ir.NativeFunction.ARCSIN: ("asinf", "asin"),
    ir.NativeFunction.ARCCOS: ("acosf", "acos"),
    ir.NativeFunction.ARCTAN: ("atanf", "atan"),
    ir.NativeFunction.ARCTAN2: ("atan2f", "atan2"),
    ir.NativeFunction.SINH: ("sinhf", "sinh"),
    ir.NativeFunction.COSH: ("coshf", "cosh"),
    ir.NativeFunction.TANH: ("tanhf", "tanh"),
    ir.NativeFunction.ARCSINH: ("asinhf", "asinh"),
    ir.NativeFunction.ARCCOSH: ("acoshf", "acosh"),
    ir.NativeFunction.ARCTANH: ("atanhf", "atanh"),
    ir.NativeFunction.SQRT: ("sqrtf", "sqrt"),
    ir.NativeFunction.EXP: ("expf", "exp"),
    ir.NativeFunction.LOG: ("logf", "log"),
    ir.NativeFunction.LOG10: ("log10f", "log10"),
    ir.NativeFunction.LOG2: ("log2f", "log2"),
    ir.NativeFunction.GAMMA: ("tgammaf", "tgamma"),
    ir.NativeFunction.CBRT: ("cbrtf", "cbrt"),
    ir.NativeFunction.FLOOR: ("floorf", "floor"),
    ir.NativeFunction.CEIL: ("ceilf", "ceil"),
    ir.NativeFunction.TRUNC: ("truncf", "trunc"),
    ir.NativeFunction.ROUND: ("rintf", "rint"),  # half to even, as np.round
    ir.NativeFunction.ROUND_AWAY_FROM_ZERO: ("roundf", "round"),
    ir.NativeFunction.ERF: ("erff", "erf"),
    ir.NativeFunction.ERFC: ("erfcf", "erfc"),
}
_BOOL_FUNCS = {
    ir.NativeFunction.ISFINITE: "isfinite",
    ir.NativeFunction.ISINF: "isinf",
    ir.NativeFunction.ISNAN: "isnan",
}


def _ctype(dt) -> str:
    return _CTYPE[np.dtype(dt)]


def _cast(code: str, src, dst) -> str:
    return code if np.dtype(src) == np.dtype(dst) else f"(({_ctype(dst)})({code}))"


def _literal(value, dt) -> str:
    dt = np.dtype(dt)
    if dt == _BOOL:
        return "true" if value else "false"
    if is_float_dtype(dt):
        v = float(np.asarray(value, dtype=dt))
        ct = _ctype(dt)
        if v != v:
            return f"(({ct})NAN)"
        if v in (float("inf"), float("-inf")):
            return f"(({ct})({'-' if v < 0 else ''}INFINITY))"
        # hex floats are exact; the f suffix keeps float32 chains in float32
        return f"({v.hex()}{'f' if dt == _F32 else ''})"
    return f"(({_ctype(dt)}){int(np.asarray(value, dtype=dt))}LL)"


def _nonzero(off) -> bool:
    return bool(off.i or off.j or off.k)


def _check_supported(analysis: StencilAnalysis) -> None:
    """Raise ``NotImplementedError`` naming the first IR node outside the
    emitters' subset."""
    st = analysis.stencil
    for name, decl in {**st.field_decls, **st.temp_decls}.items():
        if decl.data_dims:
            raise NotImplementedError(
                f"cuda backend: field '{name}' has data dimensions {decl.data_dims}"
            )
        if np.dtype(decl.dtype) not in _CTYPE:
            raise NotImplementedError(
                f"cuda backend: field '{name}' has dtype {np.dtype(decl.dtype)}"
            )
    for name, decl in st.scalar_decls.items():
        if decl.dtype is None or np.dtype(decl.dtype) not in _CTYPE:
            raise NotImplementedError(
                f"cuda backend: scalar '{name}' has dtype {decl.dtype}"
            )
    for node in ir.walk_values(st.vertical_loops):
        if isinstance(node, (ir.While, ir.HorizontalRestriction)):
            raise NotImplementedError(f"cuda backend: no emitter for {type(node).__name__}")
        if isinstance(node, ir.FieldAccess):
            if not isinstance(node.offset, ir.CartesianOffset):
                raise NotImplementedError(
                    f"cuda backend: no emitter for {type(node.offset).__name__} "
                    f"(field '{node.name}')"
                )
            if node.data_index:
                raise NotImplementedError(
                    f"cuda backend: no emitter for data-dimension index (field '{node.name}')"
                )
        if isinstance(node, ir.NativeFuncCall) and node.func not in _FLOAT_FUNCS and \
                node.func not in _BOOL_FUNCS and node.func not in (
                    ir.NativeFunction.ABS, ir.NativeFunction.MIN, ir.NativeFunction.MAX,
                    ir.NativeFunction.MOD, ir.NativeFunction.POW):
            raise NotImplementedError(f"cuda backend: no emitter for builtin {node.func.value}")


# --------------------------------------------------------------------------- #
# kernel planning
# --------------------------------------------------------------------------- #


@dataclass
class KernelPlan:
    """One ``__global__`` kernel: a row-form stage or a column-form loop."""

    name: str
    form: str  # "rows" | "columns"
    order: ir.LoopOrder
    #: (global section index, statements) in execution order
    sections: List[Tuple[int, List[ir.Stmt]]]
    rect: Extent = field(default_factory=Extent)
    reads: List[str] = field(default_factory=list)
    writes: List[str] = field(default_factory=list)


def _split_stages(stmts: List[ir.Stmt]) -> List[List[ir.Stmt]]:
    """Row-form stages of one PARALLEL section (see module docstring)."""
    stages: List[List[ir.Stmt]] = []
    cur: List[ir.Stmt] = []
    written: set = set()
    offset_read: set = set()
    for stmt in stmts:
        reads = _stmt_reads(stmt)
        writes = {w.name for w in _stmt_writes(stmt)}
        if not isinstance(stmt, ir.Assign) and any(
            r.name in writes and _nonzero(r.offset) for r in reads
        ):
            raise NotImplementedError(
                "cuda backend: a compound statement reads a field it writes at an offset"
            )
        hazard = any(r.name in written and _nonzero(r.offset) for r in reads) or (
            writes & offset_read
        )
        if hazard and cur:
            stages.append(cur)
            cur, written, offset_read = [], set(), set()
        cur.append(stmt)
        written |= writes
        offset_read |= {r.name for r in reads if _nonzero(r.offset)}
    if cur:
        stages.append(cur)
    return stages


def plan_kernels(analysis: StencilAnalysis) -> List[KernelPlan]:
    st = analysis.stencil
    plans: List[KernelPlan] = []
    sec_id = 0
    for loop in st.vertical_loops:
        if loop.loop_order == ir.LoopOrder.PARALLEL:
            for section in loop.sections:
                for stage in _split_stages(section.body):
                    plans.append(KernelPlan(name="", form="rows", order=loop.loop_order,
                                            sections=[(sec_id, stage)]))
                sec_id += 1
        else:
            written = {w.name for s in loop.sections for st_ in s.body for w in _stmt_writes(st_)}
            for s in loop.sections:
                for st_ in s.body:
                    for r in _stmt_reads(st_):
                        if r.name in written and (r.offset.i or r.offset.j):
                            raise NotImplementedError(
                                f"cuda backend: field '{r.name}' is read at a horizontal "
                                f"offset in the {loop.loop_order.name} loop that writes it"
                            )
            secs = []
            for s in loop.sections:
                secs.append((sec_id, s.body))
                sec_id += 1
            plans.append(KernelPlan(name="", form="columns", order=loop.loop_order,
                                    sections=secs))
    for n, p in enumerate(plans):
        p.name = f"{st.name}_k{n}"
        rect = Extent.zeros()
        for _, stmts in p.sections:
            for s in stmts:
                rect = rect | analysis.extents.stmt_extent(s)
        p.rect = Extent(i=rect.i, j=rect.j)
        reads, writes = [], []
        for _, stmts in p.sections:
            for s in stmts:
                for r in _stmt_reads(s):
                    if r.name not in reads:
                        reads.append(r.name)
                for w in _stmt_writes(s):
                    if w.name not in writes:
                        writes.append(w.name)
        p.reads, p.writes = reads, writes
    return plans


def _local_temps(analysis: StencilAnalysis, plans: List[KernelPlan]) -> List[str]:
    """Temporaries that can live in registers: every access at offset
    (0, 0, 0) inside one kernel, and either one section or, in each section
    that touches it, an unconditional top-level write before any read.  A
    register declared per K iteration and zeroed then gives exactly the
    oracle's values (its temporaries start at zero)."""
    st = analysis.stencil
    where: Dict[str, set] = {n: set() for n in st.temp_decls}
    sections: Dict[str, set] = {n: set() for n in st.temp_decls}
    ok = {n: True for n in st.temp_decls}
    for kn, p in enumerate(plans):
        for sid, stmts in p.sections:
            for s in stmts:
                for node in ir.walk_values(s):
                    if isinstance(node, ir.FieldAccess) and node.name in where:
                        where[node.name].add(kn)
                        sections[node.name].add(sid)
                        if _nonzero(node.offset):
                            ok[node.name] = False
    for p in plans:
        for sid, stmts in p.sections:
            first: Dict[str, str] = {}
            for s in stmts:
                for r in _stmt_reads(s):
                    first.setdefault(r.name, "read")
                if isinstance(s, ir.Assign):
                    first.setdefault(s.target.name, "write")
                else:
                    for w in _stmt_writes(s):
                        first.setdefault(w.name, "cond")
            for name, kind in first.items():
                if name in ok and kind != "write" and len(sections[name]) > 1:
                    ok[name] = False
    return [n for n in st.temp_decls if ok[n] and len(where[n]) == 1]


def _temp_events(analysis: StencilAnalysis, plans: List[KernelPlan], names):
    """Per section (in execution order): the reads ``(name, "r", dk)`` and
    unconditional writes ``(name, "w", 0)`` of the temporaries ``names``,
    in statement order; and the temporaries written in any other way
    (under a condition, or at a K offset)."""
    events: Dict[int, List[Tuple[str, str, int]]] = {}
    irregular = set()
    for p in plans:
        for sid, stmts in p.sections:
            evs = events.setdefault(sid, [])
            for s in stmts:
                evs += [(r.name, "r", r.offset.k) for r in _stmt_reads(s) if r.name in names]
                if isinstance(s, ir.Assign) and s.target.name in names:
                    if s.target.offset.k:
                        irregular.add(s.target.name)
                    evs.append((s.target.name, "w", 0))
                elif not isinstance(s, ir.Assign):
                    irregular |= {w.name for w in _stmt_writes(s) if w.name in names}
    return events, irregular


def _covered(need: Tuple[int, int], ranges: List[Tuple[int, int]]) -> bool:
    lo, hi = need
    if hi <= lo:
        return True
    for a, b in sorted(ranges):
        if a <= lo < b:
            lo = b
            if lo >= hi:
                return True
    return False


def zero_init_temps(program: "CudaProgram", kb: Sequence[Tuple[int, int]]) -> List[str]:
    """Scratch temporaries that some read may see before a write.

    The oracle's temporaries start at zero.  A scratch buffer from
    ``torch.empty`` gives the same values only if every level a read
    reaches was written earlier (horizontally, the extent analysis makes
    an unconditional writer cover its readers).  ``kb``: the resolved K
    range of each section.  The rest are zero-filled before the kernels.
    """
    out = []
    for t in program.scratch:
        if t in program.irregular_writes:
            out.append(t)
            continue
        before: List[Tuple[int, int]] = []
        safe = True
        for sid in sorted(program.temp_events):
            a, b = kb[sid]
            if b <= a:
                continue
            evs = [(kind, dk) for n, kind, dk in program.temp_events[sid] if n == t]
            writes_here = any(kind == "w" for kind, _ in evs)
            wrote = False
            order = program.section_order[sid]
            for kind, dk in evs:
                if kind == "w":
                    wrote = True
                    continue
                if order == ir.LoopOrder.PARALLEL:
                    same = wrote
                elif order == ir.LoopOrder.FORWARD:
                    same = writes_here and (dk < 0 or (dk == 0 and wrote))
                else:
                    same = writes_here and (dk > 0 or (dk == 0 and wrote))
                if not _covered((a + dk, b + dk), before + ([(a, b)] if same else [])):
                    safe = False
            if writes_here:
                before.append((a, b))
        if not safe:
            out.append(t)
    return out


# --------------------------------------------------------------------------- #
# source emission
# --------------------------------------------------------------------------- #


class _Emitter:
    def __init__(self, analysis: StencilAnalysis, locals_: Sequence[str]):
        self.analysis = analysis
        self.stencil = analysis.stencil
        self.locals = set(locals_)
        self.written = {
            n for n, info in analysis.field_info.items() if info.access.value & 2
        }

    # ---------------- expressions ---------------- #

    def access(self, acc: ir.FieldAccess) -> str:
        name, off = acc.name, acc.offset
        if name in self.locals:
            return f"l_{name}"
        if name in self.stencil.temp_decls:
            return f"t_{name}.at(i + {off.i}, j + {off.j}, k + {off.k})"
        decl = self.stencil.field_decls[name]
        ext = self.analysis.extents.field_extent(name)
        wrap = name not in self.written
        idx = []
        for ax, (var, o, dom, flag, e) in enumerate((
            ("i", off.i, "dI", "pI", ext.i),
            ("j", off.j, "dJ", "pJ", ext.j),
            ("k", off.k, None, None, ext.k),
        )):
            if not decl.dimensions[ax]:
                idx.append("0")
            elif flag and wrap and (e[0] or e[1]):
                idx.append(f"gt::wrap({var} + {o}, {dom}, {flag})")
            else:
                idx.append(f"{var} + {o}")
        return f"f_{name}.at({', '.join(idx)})"

    def expr(self, e: ir.Expr) -> Tuple[str, np.dtype]:
        st = self.stencil
        if isinstance(e, ir.Literal):
            if e.dtype is not None:
                dt = np.dtype(e.dtype)
            elif isinstance(e.value, bool):
                dt = _BOOL
            elif isinstance(e.value, (int, np.integer)):
                dt = default_int_dtype(st)
            else:
                dt = default_float_dtype(st)
            return _literal(e.value, dt), dt
        if isinstance(e, ir.ScalarAccess):
            return f"s_{e.name}", np.dtype(st.scalar_decls[e.name].dtype)
        if isinstance(e, ir.FieldAccess):
            return self.access(e), np.dtype(st.decl(e.name).dtype)
        if isinstance(e, ir.AxisPosition):
            dt = default_int_dtype(st)
            return _cast(e.axis.lower(), np.dtype(np.int32), dt), dt
        if isinstance(e, ir.AxisSize):
            dt = default_int_dtype(st)
            return _cast(f"d{e.axis}", np.dtype(np.int32), dt), dt
        if isinstance(e, ir.Cast):
            code, dt = self.expr(e.expr)
            return _cast(code, dt, e.dtype), np.dtype(e.dtype)
        if isinstance(e, ir.UnaryOp):
            code, dt = self.expr(e.expr)
            if e.op == ir.UnaryOperator.NOT:
                return f"(!({code}))", _BOOL
            if e.op == ir.UnaryOperator.NEG:
                return f"(({_ctype(dt)})(-({code})))", dt
            return code, dt
        if isinstance(e, ir.BinaryOp):
            return self.binop(e)
        if isinstance(e, ir.TernaryOp):
            c, _ = self.expr(e.cond)
            t, tdt = self.expr(e.true_expr)
            f, fdt = self.expr(e.false_expr)
            target = promote_dtypes(tdt, fdt)
            return f"(({c}) ? {_cast(t, tdt, target)} : {_cast(f, fdt, target)})", target
        if isinstance(e, ir.NativeFuncCall):
            return self.native(e)
        raise NotImplementedError(f"cuda backend: no emitter for {type(e).__name__}")

    def binop(self, e: ir.BinaryOp) -> Tuple[str, np.dtype]:
        l, ldt = self.expr(e.left)
        r, rdt = self.expr(e.right)
        op = e.op
        if op == ir.BinaryOperator.AND:
            return f"(({l}) && ({r}))", _BOOL
        if op == ir.BinaryOperator.OR:
            return f"(({l}) || ({r}))", _BOOL
        target = promote_dtypes(ldt, rdt)
        lc, rc = _cast(l, ldt, target), _cast(r, rdt, target)
        if op.is_comparison:
            return f"({lc} {_BINOP_SYM[op]} {rc})", _BOOL
        if op == ir.BinaryOperator.DIV:
            if not is_float_dtype(target):  # numpy: int / int -> float64
                return f"({_cast(l, ldt, _F64)} / {_cast(r, rdt, _F64)})", _F64
            return f"({lc} / {rc})", target
        if op == ir.BinaryOperator.FLOOR_DIV:
            fn = "gt::ffloordiv" if is_float_dtype(target) else "gt::ifloordiv"
            return f"{fn}<{_ctype(target)}>({lc}, {rc})", target
        if op == ir.BinaryOperator.MOD:
            fn = "gt::fmod_py" if is_float_dtype(target) else "gt::imod"
            return f"{fn}<{_ctype(target)}>({lc}, {rc})", target
        if op == ir.BinaryOperator.POW:
            if is_float_dtype(target):
                fn = "powf" if target == _F32 else "pow"
                return f"{fn}({lc}, {rc})", target
            return f"gt::ipow<{_ctype(target)}>({lc}, {rc})", target
        code = f"({lc} {_BINOP_SYM[op]} {rc})"
        if not is_float_dtype(target):  # undo C's integer promotion
            code = f"(({_ctype(target)}){code})"
        return code, target

    def native(self, e: ir.NativeFuncCall) -> Tuple[str, np.dtype]:
        args = [self.expr(a) for a in e.args]
        target = promote_dtypes(*[dt for _, dt in args])
        if len(args) > 1:
            codes = [_cast(c, dt, target) for c, dt in args]
            adt = target
        else:
            codes, adt = [args[0][0]], args[0][1]
        fn = e.func
        if fn in _BOOL_FUNCS:
            x = _cast(codes[0], adt, _F64) if not is_float_dtype(adt) else codes[0]
            return f"((bool){_BOOL_FUNCS[fn]}({x}))", _BOOL
        if fn in _FLOAT_FUNCS:
            if not is_float_dtype(adt):
                codes = [_cast(c, adt, _F64) for c in codes]
                adt = _F64
            name = _FLOAT_FUNCS[fn][0 if adt == _F32 else 1]
            return f"{name}({', '.join(codes)})", adt
        ct = _ctype(adt)
        if fn == ir.NativeFunction.ABS:
            if is_float_dtype(adt):
                return f"{'fabsf' if adt == _F32 else 'fabs'}({codes[0]})", adt
            return f"gt::iabs<{ct}>({codes[0]})", adt
        if fn in (ir.NativeFunction.MIN, ir.NativeFunction.MAX):
            which = "minimum" if fn == ir.NativeFunction.MIN else "maximum"
            return f"gt::{which}<{ct}>({codes[0]}, {codes[1]})", adt
        if fn == ir.NativeFunction.MOD:
            helper = "gt::fmod_py" if is_float_dtype(adt) else "gt::imod"
            return f"{helper}<{ct}>({codes[0]}, {codes[1]})", adt
        if fn == ir.NativeFunction.POW:
            if is_float_dtype(adt):
                return f"{'powf' if adt == _F32 else 'pow'}({codes[0]}, {codes[1]})", adt
            return f"gt::ipow<{ct}>({codes[0]}, {codes[1]})", adt
        raise NotImplementedError(f"cuda backend: no emitter for builtin {fn.value}")

    # ---------------- statements ---------------- #

    def stmt(self, s: ir.Stmt, ind: str) -> List[str]:
        if isinstance(s, ir.Assign):
            code, dt = self.expr(s.value)
            tdt = np.dtype(self.stencil.decl(s.target.name).dtype)
            return [f"{ind}{self.access(s.target)} = {_cast(code, dt, tdt)};"]
        if isinstance(s, ir.If):
            cond, _ = self.expr(s.cond)
            out = [f"{ind}if ({cond}) {{"]
            for b in s.body:
                out += self.stmt(b, ind + "  ")
            if s.orelse:
                out.append(f"{ind}}} else {{")
                for b in s.orelse:
                    out += self.stmt(b, ind + "  ")
            out.append(f"{ind}}}")
            return out
        raise NotImplementedError(f"cuda backend: no emitter for {type(s).__name__}")

    def guarded(self, s: ir.Stmt, rect: Extent, ind: str) -> List[str]:
        e = self.analysis.extents.stmt_extent(s)
        if (e.i, e.j) == (rect.i, rect.j):
            return self.stmt(s, ind)
        cond = (f"i >= {e.i[0]} && i < dI + {e.i[1]} && "
                f"j >= {e.j[0]} && j < dJ + {e.j[1]}")
        return [f"{ind}if ({cond}) {{", *self.stmt(s, ind + "  "), f"{ind}}}"]


def _bytes_per_point(analysis: StencilAnalysis, plan: KernelPlan, locals_) -> int:
    st = analysis.stencil
    n = 0
    for names in (plan.reads, plan.writes):
        for name in names:
            if name not in locals_:
                n += np.dtype(st.decl(name).dtype).itemsize
    return n


@dataclass
class CudaProgram:
    """The generated source and what the wrapper needs to call it."""

    source: str
    kernels: List[KernelPlan]
    fields: List[str]
    scratch: List[str]
    locals: List[str]
    float_scalars: List[str]
    int_scalars: List[str]
    intervals: List[ir.Interval]
    bytes_per_point: Dict[str, int]
    #: what ``zero_init_temps`` reads: temporary accesses per section,
    #: temporaries written conditionally or at K offsets, loop orders
    temp_events: Dict[int, List[Tuple[str, str, int]]]
    irregular_writes: set
    section_order: Dict[int, ir.LoopOrder]


def generate(analysis: StencilAnalysis) -> CudaProgram:
    """Emit the CUDA C++ source of one stencil (deterministic)."""
    _check_supported(analysis)
    st = analysis.stencil
    plans = plan_kernels(analysis)
    locals_ = _local_temps(analysis, plans)
    scratch = [n for n in st.temp_decls if n not in locals_]
    fields = list(st.field_decls)
    scalars = [n for n, p in analysis.parameter_info.items() if p.access.value & 1]
    float_scalars = [n for n in scalars if is_float_dtype(st.scalar_decls[n].dtype)]
    int_scalars = [n for n in scalars if n not in float_scalars]
    intervals = [s.interval for loop in st.vertical_loops for s in loop.sections]
    nsec = len(intervals)
    em = _Emitter(analysis, locals_)

    params = (
        [f"gt::Field<{_ctype(st.field_decls[n].dtype)}> f_{n}" for n in fields]
        + [f"gt::Field<{_ctype(st.temp_decls[n].dtype)}> t_{n}" for n in scratch]
        + ["int dI", "int dJ", "int dK", "int pI", "int pJ", f"gt::KBounds<{nsec}> kb"]
        + [f"{_ctype(st.scalar_decls[n].dtype)} s_{n}" for n in scalars]
    )
    args = [f"f_{n}" for n in fields] + [f"t_{n}" for n in scratch] + [
        "dI", "dJ", "dK", "pI", "pJ", "kb"] + [f"s_{n}" for n in scalars]

    bpp = {p.name: _bytes_per_point(analysis, p, locals_) for p in plans}
    out = [
        f"// Stencil '{st.name}': generated by gt4py_tpu_torch.cartesian.backend."
        "cuda_backend.",
        "// Replaces the TPU kernels of the JAX package:",
        f"//   {REPLACES['rows']}",
        f"//   {REPLACES['columns']}",
        f"//   {REPLACES['wrap']}",
        "// Bound on the H100: device-memory bandwidth (3.35 TB/s).  Each kernel",
        "// does a few flops per byte it moves; its bytes per grid point are noted",
        "// at the kernel.  Design: one thread per (i, j) point or column, J along",
        "// threadIdx.x for coalesced loads, K looped inside the thread, periodic",
        "// reads wrapped in the load address.",
        '#include "stencil_runtime.cuh"',
        "",
        "namespace {",
    ]
    for p in plans:
        ind = "    "
        out += [
            "",
            f"// {p.name}: {p.form} form ({p.order.name}), rect I{p.rect.i} J{p.rect.j}; "
            f"~{bpp[p.name]} bytes per grid point",
            f"__global__ void __launch_bounds__({BLOCK_J * BLOCK_I}) {p.name}(",
            "    " + ",\n    ".join(params) + ") {",
            f"  const int j = {p.rect.j[0]} + (int)(blockIdx.x * blockDim.x + threadIdx.x);",
            f"  const int i = {p.rect.i[0]} + (int)(blockIdx.y * blockDim.y + threadIdx.y);",
            f"  if (i >= dI + {p.rect.i[1]} || j >= dJ + {p.rect.j[1]}) return;",
        ]
        for sid, stmts in p.sections:
            if p.order == ir.LoopOrder.BACKWARD:
                out.append(f"  for (int k = kb.hi[{sid}] - 1; k >= kb.lo[{sid}]; --k) {{")
            else:
                out.append(f"  for (int k = kb.lo[{sid}]; k < kb.hi[{sid}]; ++k) {{")
            used = []
            for s in stmts:
                for node in ir.walk_values(s):
                    if isinstance(node, ir.FieldAccess) and node.name in em.locals \
                            and node.name not in used:
                        used.append(node.name)
            for n in used:
                ct = _ctype(st.temp_decls[n].dtype)
                out.append(f"{ind}{ct} l_{n} = ({ct})0;")
            for s in stmts:
                out += em.guarded(s, p.rect, ind)
            out.append("  }")
        out.append("}")
    out += ["", "}  // namespace", ""]

    # the launcher: one plain C entry point for ctypes
    out += [
        'extern "C" int gt_run(void* const* ptrs, const long long* strides, '
        "const int* dom, const int* kbv,",
        "                      const double* fsc, const long long* isc, int pI, int pJ, "
        "void* stream) {",
    ]
    for b, n in enumerate(fields + scratch):
        ct = _ctype(st.decl(n).dtype)
        var = ("f_" if n in st.field_decls else "t_") + n
        out.append(f"  const gt::Field<{ct}> {var}{{({ct}*)ptrs[{b}], strides[{3 * b}], "
                   f"strides[{3 * b + 1}], strides[{3 * b + 2}]}};")
    out += [
        "  const int dI = dom[0], dJ = dom[1], dK = dom[2];",
        f"  gt::KBounds<{nsec}> kb;",
        f"  for (int s = 0; s < {nsec}; ++s) {{ kb.lo[s] = kbv[2 * s]; kb.hi[s] = kbv[2 * s + 1]; }}",
    ]
    for n in scalars:
        ct = _ctype(st.scalar_decls[n].dtype)
        src = f"fsc[{float_scalars.index(n)}]" if n in float_scalars else \
            f"isc[{int_scalars.index(n)}]"
        out.append(f"  const {ct} s_{n} = ({ct}){src};")
    out += [
        "  cudaStream_t st = (cudaStream_t)stream;",
        f"  const dim3 block({BLOCK_J}, {BLOCK_I});",
    ]
    for p in plans:
        ni = f"dI + {p.rect.i[1] - p.rect.i[0]}"
        nj = f"dJ + {p.rect.j[1] - p.rect.j[0]}"
        out += [
            "  {",
            f"    const int ni = {ni}, nj = {nj};",
            "    if (ni > 0 && nj > 0) {",
            f"      const dim3 grid((nj + {BLOCK_J - 1}) / {BLOCK_J}, "
            f"(ni + {BLOCK_I - 1}) / {BLOCK_I});",
            f"      {p.name}<<<grid, block, 0, st>>>({', '.join(args)});",
            "      const cudaError_t e = cudaGetLastError();",
            "      if (e != cudaSuccess) return (int)e;",
            "    }",
            "  }",
        ]
    out += ["  return 0;", "}", "",
            'extern "C" const char* gt_error_string(int e) '
            "{ return cudaGetErrorString((cudaError_t)e); }", ""]
    temp_events, irregular = _temp_events(analysis, plans, set(scratch))
    return CudaProgram(
        source="\n".join(out),
        kernels=plans,
        fields=fields,
        scratch=scratch,
        locals=list(locals_),
        float_scalars=float_scalars,
        int_scalars=int_scalars,
        intervals=intervals,
        bytes_per_point=bpp,
        temp_events=temp_events,
        irregular_writes=irregular,
        section_order={sid: p.order for p in plans for sid, _ in p.sections},
    )


# --------------------------------------------------------------------------- #
# the wrapper
# --------------------------------------------------------------------------- #


def _is_dense(t: torch.Tensor) -> bool:
    """True when the view's elements do not overlap and fill a block of
    memory (any axis order; size-1 axes ignored)."""
    dims = sorted((s, n) for s, n in zip(t.stride(), t.shape) if n != 1)
    expect = 1
    for s, n in dims:
        if s != expect:
            return False
        expect *= n
    return True


def _field_arg(view: torch.Tensor, origin) -> Tuple[int, List[int]]:
    """Base pointer at the domain origin and element strides of a
    logical (I, J, K) view; size-1 axes broadcast with stride 0."""
    strides = [0 if n == 1 else s for s, n in zip(view.stride()[:3], view.shape[:3])]
    org = [0 if n == 1 else o for o, n in zip(origin, view.shape[:3])]
    offset = sum(o * s for o, s in zip(org, strides))
    return view.data_ptr() + offset * view.element_size(), strides


@register("cuda")
class CudaBackend:
    """Generated CUDA kernels for CUDA tensors, the plain executor for CPU
    tensors.  ``launches`` counts the calls that launched the kernels."""

    def __init__(self, analysis: StencilAnalysis, options: Optional[dict] = None):
        self.analysis = analysis
        self.program = generate(analysis)
        self.plain = TorchExecutor(analysis)
        self.launches = 0
        self.build_seconds: Optional[float] = None
        self.build_dir: Optional[str] = None
        self._lib = None
        self._written = [
            n for n, info in analysis.field_info.items() if info.access.value & 2
        ]

    @property
    def source(self) -> str:
        return self.program.source

    def build(self):
        """Compile (or load) the kernels; returns the ctypes library."""
        if self._lib is None:
            t0 = time.perf_counter()
            lib, self.build_dir = _build.build(self.program.source, self.analysis.stencil.name)
            lib.gt_run.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int,
                                                           ctypes.c_void_p]
            lib.gt_run.restype = ctypes.c_int
            lib.gt_error_string.argtypes = [ctypes.c_int]
            lib.gt_error_string.restype = ctypes.c_char_p
            self._lib = lib
            self.build_seconds = time.perf_counter() - t0
        return self._lib

    def apply(self, env, scalars, domain, origins, periodic=()) -> None:
        """Execute on ``env`` (logical views; written fields are fresh
        output buffers, see ``StencilObject._execute``)."""
        kinds = {v.device.type for v in env.values()}
        if kinds == {"cpu"}:
            run_plain(self.plain, env, scalars, domain, origins, periodic)
            return
        if kinds != {"cuda"}:
            raise ValueError(f"backend 'cuda' takes CPU or CUDA tensors, got {sorted(kinds)}")
        self._launch(env, scalars, domain, origins, periodic)

    def _check(self, env) -> torch.device:
        st = self.analysis.stencil
        devices = {v.device for v in env.values()}
        if len(devices) != 1:
            raise ValueError(f"fields on several devices: {sorted(map(str, devices))}")
        for name, v in env.items():
            want = dtypes.to_torch(st.field_decls[name].dtype)
            if v.dtype != want:
                raise TypeError(f"field '{name}' has dtype {v.dtype}, expected {want}")
            if v.ndim != 3:
                raise ValueError(f"field '{name}' must be a 3-axis view, got shape {tuple(v.shape)}")
            if not _is_dense(v):
                raise ValueError(f"field '{name}' is not contiguous")
        return devices.pop()

    def _launch(self, env, scalars, domain, origins, periodic) -> None:
        prog = self.program
        st = self.analysis.stencil
        device = self._check(env)
        dI, dJ, dK = (int(d) for d in domain)
        if periodic:
            check_periodic(self.analysis, list(env), domain, periodic)
            # written fields read at offsets: the oracle's pre-run fill, in
            # the fresh output buffer (reads of them then need no wrap)
            fill = [n for n in self._written
                    if n in env and has_horizontal_reads(self.analysis, n)]
            if fill:
                periodic_fill(self.analysis, env, domain, origins, periodic, fill)
        lib = self.build()

        ptrs: List[int] = []
        strides: List[int] = []
        keep = []
        for name in prog.fields:
            if name in env:
                p, s = _field_arg(env[name], origins[name])
            else:
                p, s = 0, [0, 0, 0]
            ptrs.append(p)
            strides += s
        kb = [(max(k0, 0), min(k1, dK))
              for k0, k1 in (itv.resolve(dK, scalars) for itv in prog.intervals)]
        zeroed = zero_init_temps(prog, kb)
        for name in prog.scratch:
            ext = self.analysis.extents.alloc_extent(name)
            shape = (dK - ext.k[0] + ext.k[1], dI - ext.i[0] + ext.i[1],
                     dJ - ext.j[0] + ext.j[1])
            dt = dtypes.to_torch(st.temp_decls[name].dtype)
            alloc = torch.zeros if name in zeroed else torch.empty
            t = alloc(shape, dtype=dt, device=device)
            keep.append(t)
            p, s = _field_arg(t.permute(1, 2, 0), (-ext.i[0], -ext.j[0], -ext.k[0]))
            ptrs.append(p)
            strides += s
        kb = [k for bounds in kb for k in bounds]
        fsc = [float(_scalar_value(scalars[n])) for n in prog.float_scalars]
        isc = [int(_scalar_value(scalars[n])) for n in prog.int_scalars]

        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = lib.gt_run(
                (ctypes.c_void_p * len(ptrs))(*ptrs),
                (ctypes.c_longlong * len(strides))(*strides),
                (ctypes.c_int * 3)(dI, dJ, dK),
                (ctypes.c_int * len(kb))(*kb),
                (ctypes.c_double * max(1, len(fsc)))(*fsc),
                (ctypes.c_longlong * max(1, len(isc)))(*isc),
                int("I" in periodic), int("J" in periodic),
                ctypes.c_void_p(stream),
            )
        if rc != 0:
            raise RuntimeError(
                f"CUDA launch failed in stencil '{st.name}': "
                f"{lib.gt_error_string(rc).decode()} (error {rc})"
            )
        # scratch buffers go back to the caching allocator tied to the
        # stream, so reuse by later work on the same stream is ordered
        del keep
        self.launches += 1


def _scalar_value(v):
    if isinstance(v, torch.Tensor):
        return v.item()
    return np.asarray(v).item()
