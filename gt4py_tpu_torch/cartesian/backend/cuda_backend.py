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
- **Variable and absolute K** (K3; ``JaxTracer._read_nonuniform_k``).  A
  direct indexed load at the level clipped to the buffer's K range, as the
  oracle clips.  In the row form such a read of a field written earlier
  in the stage starts a new stage, like a nonzero offset; in the column
  form it reads what the sweep has written so far.
- **Data dimensions** (K7; Pallas ``_trace_split_data_dims``).  A field
  ``(K, I, J, *D)`` is passed whole with its data strides; a component is
  one more term in the load or store address.  Constant indices fold,
  per-point indices wrap modulo the dimension as the oracle's do.

``while`` loops run as loops in the thread, and horizontal regions as a
test of the thread's position against the regions, resolved against the
true domain (``dI``, ``dJ``), not the kernel's extended rectangle.

Types follow the oracle's C-style promotion: every operand is cast to the
promoted dtype and every literal is emitted exactly, in the dtype the
analysis gave it (hex floats with an ``f`` suffix in float32), so no float32
chain silently computes in double.

float16 and bfloat16 are storage types (Pallas ``_f16_reads_all_widened``):
a field, scratch temporary or scalar of float16 is stored as ``__half``,
loaded with ``__half2float`` and stored with ``__float2half_rn`` (round to
nearest even, as torch's ``.half()``); bfloat16 likewise as
``__nv_bfloat16`` with ``__bfloat162float`` and ``__float2bfloat16_rn``.
Every 16-bit value in a kernel is a ``float`` that holds a 16-bit number:
an operation whose promoted dtype is float16 or bfloat16 computes in float
and rounds (``gt::round_half``, ``gt::round_bf16``), which is the correctly
rounded result, as numpy (and ml_dtypes) give it.  The builder's
``passes.widen_f16_compute`` leaves only casts and stores at 16 bits, so a
cartesian stencil's body computes in float32 (or float64 where its
literals are float64; a float64 value is rounded to float16 once, with
``__double2half``, and to bfloat16 through float32, as torch and the JAX
package's oracle round it).

This backend does not inline temporaries (``passes.inline_parallel_
temporaries``, which the ``"jax"`` backend applies): the horizontal
diffusion is three row-form kernels.  IR outside the emitters' subset --
a data-dimension field read without all its indices, a write at a
variable K -- raises ``NotImplementedError`` when the stencil is built.  Nothing falls back to the plain executor on the GPU: CPU tensors
run the plain executor (``torch_backend``), CUDA tensors run the kernels or
raise.
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
    try_static_int,
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
from gt4py_tpu_torch.core.definitions import BFLOAT16, Extent, is_float_dtype

#: the TPU kernels this backend replaces (file:line in the JAX package)
REPLACES = {
    "rows": "gt4py_tpu/cartesian/backend/pallas_backend.py:1428 "
            "PallasBackend._pallas_trace, row-tile form (_plan_rows :985)",
    "columns": "gt4py_tpu/cartesian/backend/pallas_backend.py:1428 "
               "PallasBackend._pallas_trace, column form (_plan_columns :1187)",
    "wrap": "gt4py_tpu/cartesian/backend/pallas_backend.py:1702 _plan_segments, "
            ":897 _circular_ok (periodic wrap inside the tile loads)",
    "vark": "gt4py_tpu/cartesian/backend/jax_backend.py:1139 "
            "JaxTracer._read_nonuniform_k (kernel branch :1187-1207), inside K1/K2",
    "data_dims": "gt4py_tpu/cartesian/backend/pallas_backend.py:312 "
                 "PallasBackend._trace_split_data_dims",
}

#: threads per block along J (coalesced) and I
BLOCK_J, BLOCK_I = 64, 4
#: data dimensions a field may have (``gt::kMaxDataDims``)
MAX_DATA_DIMS = 4
#: per-field record the wrapper passes: I, J, K strides, the data strides,
#: the buffer's K range [klo, khi] in domain-relative levels
_REC = 3 + MAX_DATA_DIMS + 2

#: storage C type of each dtype (``_ctype`` gives the type of a value)
_CTYPE = {
    np.dtype(np.bool_): "bool",
    np.dtype(np.int8): "signed char",
    np.dtype(np.int16): "short",
    np.dtype(np.int32): "int",
    np.dtype(np.int64): "long long",
    np.dtype(np.uint8): "unsigned char",
    np.dtype(np.float16): "__half",
    BFLOAT16: "__nv_bfloat16",
    np.dtype(np.float32): "float",
    np.dtype(np.float64): "double",
}
_F16 = np.dtype(np.float16)
#: 16-bit storage dtype -> (load, store, round) of its values
_HALF = {
    _F16: ("__half2float", "__float2half_rn", "gt::round_half"),
    BFLOAT16: ("__bfloat162float", "__float2bfloat16_rn", "gt::round_bf16"),
}
_F32 = np.dtype(np.float32)
_F64 = np.dtype(np.float64)
_I64 = np.dtype(np.int64)
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
    """C type of a value: a float16 or bfloat16 value is a ``float``."""
    return "float" if np.dtype(dt) in _HALF else _CTYPE[np.dtype(dt)]


def _stype(dt) -> str:
    """C type of a stored element (``__half`` for float16,
    ``__nv_bfloat16`` for bfloat16)."""
    return _CTYPE[np.dtype(dt)]


def _cast(code: str, src, dst) -> str:
    if np.dtype(src) == np.dtype(dst):
        return code
    if np.dtype(dst) in _HALF:
        return f"{_HALF[np.dtype(dst)][2]}({code})"
    return f"(({_ctype(dst)})({code}))"


def _rounded(code: str, dt) -> str:
    """The result of an operation computed in float, rounded to its
    16-bit dtype when it has one."""
    half = _HALF.get(np.dtype(dt))
    return f"{half[2]}({code})" if half else code


def _literal(value, dt) -> str:
    dt = np.dtype(dt)
    if dt == _BOOL:
        return "true" if value else "false"
    if is_float_dtype(dt):
        v = float(dtypes.scalar_value(value, dt))
        ct = _ctype(dt)
        if v != v:
            return f"(({ct})NAN)"
        if v in (float("inf"), float("-inf")):
            return f"(({ct})({'-' if v < 0 else ''}INFINITY))"
        # hex floats are exact; the f suffix keeps float32 (and float16)
        # chains in float
        return f"({v.hex()}{'f' if dt in _HALF or dt == _F32 else ''})"
    return f"(({_ctype(dt)}){int(np.asarray(value, dtype=dt))}LL)"


def _nonzero(off) -> bool:
    """True for a read that may reach another point or level: a nonzero
    offset, or a variable or absolute K."""
    if not isinstance(off, ir.CartesianOffset):
        return True
    return bool(off.i or off.j or off.k)


def _static_component(value: int, size: int, name: str) -> int:
    """A constant data index, with Python's negative indexing (the oracle
    indexes the array with it)."""
    if not -size <= value < size:
        raise IndexError(f"data index {value} out of range for field '{name}' ({size})")
    return value % size


def _region_test(masks: Sequence[ir.HorizontalMask]) -> str:
    """The thread's (i, j) lies in one of the regions.  START and END
    anchors resolve against the true domain sizes ``dI`` and ``dJ``, as the
    oracle's ``HorizontalInterval.resolve`` does; an open side tests
    nothing."""
    tests = []
    for m in masks:
        parts = []
        for var, itv, dom in (("i", m.i, "dI"), ("j", m.j, "dJ")):
            for bound, op in ((itv.start, ">="), (itv.end, "<")):
                if bound is None:
                    continue
                at = str(bound.offset) if bound.level == ir.LevelMarker.START \
                    else f"({dom} + {bound.offset})"
                parts.append(f"{var} {op} {at}")
        tests.append(f"({' && '.join(parts)})" if parts else "true")
    return " || ".join(tests) if tests else "false"


def _check_supported(analysis: StencilAnalysis) -> None:
    """Raise ``NotImplementedError`` naming the first IR node outside the
    emitters' subset."""
    st = analysis.stencil
    for name, decl in {**st.field_decls, **st.temp_decls}.items():
        if len(decl.data_dims) > MAX_DATA_DIMS:
            raise NotImplementedError(
                f"cuda backend: field '{name}' has more than {MAX_DATA_DIMS} data dimensions"
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
        if isinstance(node, ir.Assign) and not isinstance(node.target.offset, ir.CartesianOffset):
            raise NotImplementedError(
                f"cuda backend: write to '{node.target.name}' at a "
                f"{type(node.target.offset).__name__}"
            )
        if isinstance(node, ir.FieldAccess):
            dims = st.decl(node.name).data_dims
            if len(node.data_index) != len(dims):
                raise NotImplementedError(
                    f"cuda backend: field '{node.name}' with data dimensions {dims} is "
                    f"accessed with {len(node.data_index)} indices"
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
    """Row-form stages of one PARALLEL section (see module docstring).
    A compound statement (``if``, ``while``, a region) is one unit."""
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
                        if r.name in written and isinstance(r.offset, ir.CartesianOffset) \
                                and (r.offset.i or r.offset.j):
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
    ok = {n: not d.data_dims for n, d in st.temp_decls.items()}
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
    in statement order; and the temporaries written or read in any other
    way (under a condition, at a K offset, at a variable or absolute K, or
    per data-dimension component)."""
    events: Dict[int, List[Tuple[str, str, int]]] = {}
    irregular = {n for n in names if analysis.stencil.temp_decls[n].data_dims}
    for p in plans:
        for sid, stmts in p.sections:
            evs = events.setdefault(sid, [])
            for s in stmts:
                for r in _stmt_reads(s):
                    if r.name not in names:
                        continue
                    if isinstance(r.offset, ir.CartesianOffset):
                        evs.append((r.name, "r", r.offset.k))
                    else:
                        irregular.add(r.name)
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
        is_temp = name in self.stencil.temp_decls
        var = ("t_" if is_temp else "f_") + name
        decl = self.stencil.decl(name)
        cart = off if isinstance(off, ir.CartesianOffset) else ir.CartesianOffset()
        ext = self.analysis.extents.field_extent(name)
        wrap = not is_temp and name not in self.written
        idx = []
        for ax, (v, o, dom, flag, e) in enumerate((
            ("i", cart.i, "dI", "pI", ext.i),
            ("j", cart.j, "dJ", "pJ", ext.j),
        )):
            if not decl.dimensions[ax]:
                idx.append("0")
            elif wrap and (e[0] or e[1]):
                idx.append(f"gt::wrap({v} + {o}, {dom}, {flag})")
            else:
                idx.append(f"{v} + {o}")
        if not decl.dimensions[2]:
            idx.append("0")
        elif isinstance(off, ir.VariableKOffset):
            code, dt = self.expr(off.k)
            idx.append(f"{var}.kclamp(k + {_cast(code, dt, _I64)})")
        elif isinstance(off, ir.AbsoluteKIndex):
            code, dt = self.expr(off.k)
            idx.append(f"{var}.kclamp({_cast(code, dt, _I64)})")
        else:
            idx.append(f"k + {cart.k}")
        if acc.data_index:
            idx.append(" + ".join(
                f"{self.component(e, size, name)} * {var}.sd[{n}]"
                for n, (e, size) in enumerate(zip(acc.data_index, decl.data_dims))
            ))
        return f"{var}.at({', '.join(idx)})"

    def component(self, e: ir.Expr, size: int, name: str) -> str:
        """One data index: a folded constant, or a per-point index wrapped
        modulo the dimension (the oracle's ``remainder``)."""
        static = try_static_int(e)
        if static is not None:
            return str(_static_component(static, size, name))
        code, dt = self.expr(e)
        return f"gt::imod<long long>({_cast(code, dt, _I64)}, {size}LL)"

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
            dt = np.dtype(st.decl(e.name).dtype)
            if dt in _HALF and e.name not in self.locals:
                return f"{_HALF[dt][0]}({self.access(e)})", dt
            return self.access(e), dt
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
            return _rounded(f"({lc} / {rc})", target), target
        if op == ir.BinaryOperator.FLOOR_DIV:
            fn = "gt::ffloordiv" if is_float_dtype(target) else "gt::ifloordiv"
            return _rounded(f"{fn}<{_ctype(target)}>({lc}, {rc})", target), target
        if op == ir.BinaryOperator.MOD:
            fn = "gt::fmod_py" if is_float_dtype(target) else "gt::imod"
            return _rounded(f"{fn}<{_ctype(target)}>({lc}, {rc})", target), target
        if op == ir.BinaryOperator.POW:
            if is_float_dtype(target):
                fn = "pow" if target == _F64 else "powf"
                return _rounded(f"{fn}({lc}, {rc})", target), target
            return f"gt::ipow<{_ctype(target)}>({lc}, {rc})", target
        code = f"({lc} {_BINOP_SYM[op]} {rc})"
        if not is_float_dtype(target):  # undo C's integer promotion
            code = f"(({_ctype(target)}){code})"
        return _rounded(code, target), target

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
            name = _FLOAT_FUNCS[fn][1 if adt == _F64 else 0]
            return _rounded(f"{name}({', '.join(codes)})", adt), adt
        ct = _ctype(adt)
        if fn == ir.NativeFunction.ABS:
            if is_float_dtype(adt):
                return f"{'fabs' if adt == _F64 else 'fabsf'}({codes[0]})", adt
            return f"gt::iabs<{ct}>({codes[0]})", adt
        if fn in (ir.NativeFunction.MIN, ir.NativeFunction.MAX):
            which = "minimum" if fn == ir.NativeFunction.MIN else "maximum"
            return f"gt::{which}<{ct}>({codes[0]}, {codes[1]})", adt
        if fn == ir.NativeFunction.MOD:
            helper = "gt::fmod_py" if is_float_dtype(adt) else "gt::imod"
            return _rounded(f"{helper}<{ct}>({codes[0]}, {codes[1]})", adt), adt
        if fn == ir.NativeFunction.POW:
            if is_float_dtype(adt):
                fname = "pow" if adt == _F64 else "powf"
                return _rounded(f"{fname}({codes[0]}, {codes[1]})", adt), adt
            return f"gt::ipow<{ct}>({codes[0]}, {codes[1]})", adt
        raise NotImplementedError(f"cuda backend: no emitter for builtin {fn.value}")

    # ---------------- statements ---------------- #

    def stmt(self, s: ir.Stmt, ind: str) -> List[str]:
        if isinstance(s, ir.Assign):
            code, dt = self.expr(s.value)
            tdt = np.dtype(self.stencil.decl(s.target.name).dtype)
            value = _cast(code, dt, tdt)
            if tdt in _HALF and s.target.name not in self.locals:
                value = f"{_HALF[tdt][1]}({value})"  # exact: value is a 16-bit float
            return [f"{ind}{self.access(s.target)} = {value};"]
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
        if isinstance(s, ir.While):
            cond, _ = self.expr(s.cond)
            out = [f"{ind}while ({cond}) {{"]
            for b in s.body:
                out += self.stmt(b, ind + "  ")
            return out + [f"{ind}}}"]
        if isinstance(s, ir.HorizontalRestriction):
            out = [f"{ind}if ({_region_test(s.masks)}) {{"]
            for b in s.body:
                out += self.stmt(b, ind + "  ")
            return out + [f"{ind}}}"]
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
                decl = st.decl(name)
                n += np.dtype(decl.dtype).itemsize * int(np.prod(decl.data_dims, dtype=int))
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
        [f"gt::Field<{_stype(st.field_decls[n].dtype)}> f_{n}" for n in fields]
        + [f"gt::Field<{_stype(st.temp_decls[n].dtype)}> t_{n}" for n in scratch]
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
        ct = _stype(st.decl(n).dtype)
        var = ("f_" if n in st.field_decls else "t_") + n
        s = [f"strides[{_REC * b + x}]" for x in range(_REC)]
        sd = ", ".join(s[3:3 + MAX_DATA_DIMS])
        out.append(f"  const gt::Field<{ct}> {var}{{({ct}*)ptrs[{b}], {s[0]}, {s[1]}, {s[2]}, "
                   f"{{{sd}}}, (int){s[-2]}, (int){s[-1]}}};")
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


def _no_overlap(t: torch.Tensor) -> bool:
    """True when no two elements of the view share memory: in the order of
    increasing stride, each stride passes the span of the axes before it
    (any axis order, gaps allowed, size-1 axes ignored; an expanded view
    fails)."""
    span = 0
    for s, n in sorted((s, n) for s, n in zip(t.stride(), t.shape) if n != 1):
        if s <= span:
            return False
        span += s * (n - 1)
    return True


def _field_arg(view: torch.Tensor, origin) -> Tuple[int, List[int]]:
    """Base pointer at the domain origin and the per-field record of a
    logical (I, J, K, *data_dims) view: element strides (size-1 spatial
    axes broadcast with stride 0), data strides, and the buffer's K range
    in domain-relative levels."""
    strides = [0 if n == 1 else s for s, n in zip(view.stride()[:3], view.shape[:3])]
    org = [0 if n == 1 else o for o, n in zip(origin, view.shape[:3])]
    offset = sum(o * s for o, s in zip(org, strides))
    data = list(view.stride()[3:])
    data += [0] * (MAX_DATA_DIMS - len(data))
    klo, khi = -org[2], view.shape[2] - 1 - org[2]
    return view.data_ptr() + offset * view.element_size(), strides + data + [klo, khi]


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
            decl = st.field_decls[name]
            want = dtypes.to_torch(decl.dtype)
            if v.dtype != want:
                raise TypeError(f"field '{name}' has dtype {v.dtype}, expected {want}")
            if tuple(v.shape[3:]) != tuple(decl.data_dims) or v.ndim != 3 + len(decl.data_dims):
                raise ValueError(
                    f"field '{name}' must be an (I, J, K, *{decl.data_dims}) view, "
                    f"got shape {tuple(v.shape)}"
                )
            if not _no_overlap(v):
                raise ValueError(f"field '{name}' is a view whose elements overlap")
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
                p, s = 0, [0] * _REC
            ptrs.append(p)
            strides += s
        kb = [(max(k0, 0), min(k1, dK))
              for k0, k1 in (itv.resolve(dK, scalars) for itv in prog.intervals)]
        zeroed = zero_init_temps(prog, kb)
        for name in prog.scratch:
            ext = self.analysis.extents.alloc_extent(name)
            decl = st.temp_decls[name]
            shape = (dK - ext.k[0] + ext.k[1], dI - ext.i[0] + ext.i[1],
                     dJ - ext.j[0] + ext.j[1]) + tuple(decl.data_dims)
            alloc = torch.zeros if name in zeroed else torch.empty
            t = alloc(shape, dtype=dtypes.to_torch(decl.dtype), device=device)
            keep.append(t)
            p, s = _field_arg(t.permute(1, 2, 0, *range(3, t.ndim)),
                              (-ext.i[0], -ext.j[0], -ext.k[0]))
            ptrs.append(p)
            strides += s
        kb = [k for bounds in kb for k in bounds]
        # rounded to the scalar's dtype here, so the kernel's conversion
        # from double is exact
        fsc = [float(dtypes.scalar_value(_scalar_value(scalars[n]), st.scalar_decls[n].dtype))
               for n in prog.float_scalars]
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
