"""The plain PyTorch executor: the numpy oracle's semantics on tensors.

Port of ``gt4py_tpu.cartesian.backend.numpy_backend.NumpyExecutor``
(numpy_backend.py:150-566): the analysed IR is interpreted with
origin-shifted whole-domain slices and serial K loops, on tensors of any
device.  Operands of every operation are cast to the C-style promoted dtype
first (the reference's upcasting pass), so torch's own promotion rules never
decide a result type.

This is the plain version beside the generated CUDA kernels
(``cuda_backend``): the ``"cuda"`` backend runs it for CPU tensors, and the
chip check compares the kernels against it on the card.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gt4py_tpu_torch.cartesian import ir
from gt4py_tpu_torch.cartesian.analysis import (
    StencilAnalysis,
    default_float_dtype,
    default_int_dtype,
    promote_dtypes,
    try_static_int,
)
from gt4py_tpu_torch.cartesian.backend import register
from gt4py_tpu_torch.core import dtypes
from gt4py_tpu_torch.core.definitions import Extent

_BOOL = np.dtype(np.bool_)


def _np_dtype(t: torch.Tensor) -> np.dtype:
    return dtypes.to_numpy(t.dtype)


def _cast(t: torch.Tensor, dt) -> torch.Tensor:
    return dtypes.cast(t, dt)


def _is_intlike(t: torch.Tensor) -> bool:
    return not (t.dtype.is_floating_point or t.dtype.is_complex)


def _as_float_arg(t: torch.Tensor) -> torch.Tensor:
    """numpy's float ufuncs compute integer/bool inputs in float64."""
    return t.to(torch.float64) if _is_intlike(t) else t


def _round_away_from_zero(x):
    return torch.trunc(x + torch.copysign(torch.full_like(x, 0.5), x))


def _gamma(x):
    """Gamma function (torch has only ``lgamma``): exp(lgamma) for
    x >= 0.5, the reflection formula below."""
    pos = torch.exp(torch.lgamma(x))
    refl = math.pi / (torch.sin(math.pi * x) * torch.exp(torch.lgamma(1.0 - x)))
    return torch.where(x >= 0.5, pos, refl)


def _cbrt(x):
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


#: name -> (implementation, computes integer inputs in float64 like numpy)
_NATIVE_IMPL = {
    ir.NativeFunction.ABS: (torch.abs, False),
    ir.NativeFunction.MIN: (torch.minimum, False),
    ir.NativeFunction.MAX: (torch.maximum, False),
    ir.NativeFunction.MOD: (torch.remainder, False),
    ir.NativeFunction.SIN: (torch.sin, True),
    ir.NativeFunction.COS: (torch.cos, True),
    ir.NativeFunction.TAN: (torch.tan, True),
    ir.NativeFunction.ARCSIN: (torch.asin, True),
    ir.NativeFunction.ARCCOS: (torch.acos, True),
    ir.NativeFunction.ARCTAN: (torch.atan, True),
    ir.NativeFunction.ARCTAN2: (torch.atan2, True),
    ir.NativeFunction.SINH: (torch.sinh, True),
    ir.NativeFunction.COSH: (torch.cosh, True),
    ir.NativeFunction.TANH: (torch.tanh, True),
    ir.NativeFunction.ARCSINH: (torch.asinh, True),
    ir.NativeFunction.ARCCOSH: (torch.acosh, True),
    ir.NativeFunction.ARCTANH: (torch.atanh, True),
    ir.NativeFunction.SQRT: (torch.sqrt, True),
    ir.NativeFunction.EXP: (torch.exp, True),
    ir.NativeFunction.LOG: (torch.log, True),
    ir.NativeFunction.LOG10: (torch.log10, True),
    ir.NativeFunction.LOG2: (torch.log2, True),
    ir.NativeFunction.GAMMA: (_gamma, True),
    ir.NativeFunction.CBRT: (_cbrt, True),
    ir.NativeFunction.ISFINITE: (torch.isfinite, False),
    ir.NativeFunction.ISINF: (torch.isinf, False),
    ir.NativeFunction.ISNAN: (torch.isnan, False),
    ir.NativeFunction.FLOOR: (torch.floor, True),
    ir.NativeFunction.CEIL: (torch.ceil, True),
    ir.NativeFunction.TRUNC: (torch.trunc, True),
    ir.NativeFunction.ROUND: (torch.round, True),
    ir.NativeFunction.ROUND_AWAY_FROM_ZERO: (_round_away_from_zero, True),
    ir.NativeFunction.ERF: (torch.erf, True),
    ir.NativeFunction.ERFC: (torch.erfc, True),
    ir.NativeFunction.POW: (torch.pow, False),
}


def _floor_divide(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _true_divide(a, b):
    if _is_intlike(a):  # numpy: int / int -> float64
        a, b = a.to(torch.float64), b.to(torch.float64)
    return torch.true_divide(a, b)


_BINOPS = {
    ir.BinaryOperator.ADD: torch.add,
    ir.BinaryOperator.SUB: torch.sub,
    ir.BinaryOperator.MUL: torch.mul,
    ir.BinaryOperator.DIV: _true_divide,
    ir.BinaryOperator.FLOOR_DIV: _floor_divide,
    ir.BinaryOperator.MOD: torch.remainder,
    ir.BinaryOperator.POW: torch.pow,
    ir.BinaryOperator.EQ: torch.eq,
    ir.BinaryOperator.NE: torch.ne,
    ir.BinaryOperator.LT: torch.lt,
    ir.BinaryOperator.LE: torch.le,
    ir.BinaryOperator.GT: torch.gt,
    ir.BinaryOperator.GE: torch.ge,
    ir.BinaryOperator.BIT_AND: torch.bitwise_and,
    ir.BinaryOperator.BIT_OR: torch.bitwise_or,
    ir.BinaryOperator.BIT_XOR: torch.bitwise_xor,
}


class _View:
    """A field as a logical (I, J, K, *data_dims) tensor view + origin."""

    def __init__(self, data: torch.Tensor, origin: Tuple[int, int, int]):
        self.data = data
        self.origin = tuple(origin)
        self.dtype = _np_dtype(data)


class _Ctx:
    """Evaluation context for one statement unit."""

    def __init__(self, exe: "TorchExecutor", ext: Extent,
                 kslice: Optional[Tuple[int, int]], klevel: Optional[int]):
        self.exe = exe
        self.ext = ext
        self.kslice = kslice  # parallel: (k0, k1) domain-relative
        self.klevel = klevel  # serial: single domain-relative level
        self.masks: List[torch.Tensor] = []

    @property
    def ni(self) -> int:
        return self.exe.domain[0] - self.ext.i[0] + self.ext.i[1]

    @property
    def nj(self) -> int:
        return self.exe.domain[1] - self.ext.j[0] + self.ext.j[1]

    @property
    def nk(self) -> int:
        return 1 if self.klevel is not None else self.kslice[1] - self.kslice[0]

    def shape(self) -> Tuple[int, int, int]:
        return (self.ni, self.nj, self.nk)


class TorchExecutor:
    """Reference-semantics interpreter over torch tensors."""

    def __init__(self, analysis: StencilAnalysis):
        self.analysis = analysis
        self.stencil = analysis.stencil
        #: (value, dtype, device) -> 0-d tensor; literals are made once
        self._consts: Dict[Any, torch.Tensor] = {}

    def run(self, views: Dict[str, torch.Tensor], scalars: Dict[str, Any],
            domain: Tuple[int, int, int], origins: Dict[str, Tuple[int, int, int]]) -> None:
        """Execute in place on ``views``: logical (I, J, K, *dd) tensors."""
        self.domain = tuple(domain)
        self.scalars = scalars
        self._scalar_tensors: Dict[str, torch.Tensor] = {}
        self.device = next(iter(views.values())).device
        self.views: Dict[str, _View] = {
            name: _View(t, origins[name]) for name, t in views.items()
        }
        # temporaries on the extended domain (including the K halo, so
        # reads at K offsets crossing the domain edge stay in bounds)
        for name, decl in self.stencil.temp_decls.items():
            ext = self.analysis.extents.alloc_extent(name)
            shape = (
                domain[0] - ext.i[0] + ext.i[1],
                domain[1] - ext.j[0] + ext.j[1],
                domain[2] - ext.k[0] + ext.k[1],
            ) + tuple(decl.data_dims)
            arr = torch.zeros(shape, dtype=dtypes.to_torch(decl.dtype), device=self.device)
            self.views[name] = _View(arr, (-ext.i[0], -ext.j[0], -ext.k[0]))
        for loop in self.stencil.vertical_loops:
            self._run_loop(loop)

    # ------------------------------------------------------------------ #

    def _run_loop(self, loop: ir.VerticalLoop) -> None:
        dK = self.domain[2]
        for section in loop.sections:
            k0, k1 = section.interval.resolve(dK, self.scalars)
            k0, k1 = max(k0, 0), min(k1, dK)
            if k1 <= k0:
                continue
            if loop.loop_order == ir.LoopOrder.PARALLEL:
                for stmt in section.body:
                    ctx = _Ctx(self, self.analysis.extents.stmt_extent(stmt), (k0, k1), None)
                    self._exec_stmt(stmt, ctx)
            else:
                krange = range(k0, k1)
                if loop.loop_order == ir.LoopOrder.BACKWARD:
                    krange = reversed(krange)
                for k in krange:
                    for stmt in section.body:
                        ctx = _Ctx(self, self.analysis.extents.stmt_extent(stmt), None, k)
                        self._exec_stmt(stmt, ctx)

    # ------------------- statements ------------------- #

    def _exec_stmt(self, stmt: ir.Stmt, ctx: _Ctx) -> None:
        if isinstance(stmt, ir.Assign):
            self._exec_assign(stmt, ctx)
        elif isinstance(stmt, ir.If):
            self._exec_if(stmt, ctx)
        elif isinstance(stmt, ir.While):
            self._exec_while(stmt, ctx)
        elif isinstance(stmt, ir.HorizontalRestriction):
            self._exec_horizontal(stmt, ctx)
        else:
            raise TypeError(f"Unknown statement {type(stmt).__name__}")

    def _mask(self, ctx: _Ctx) -> Optional[torch.Tensor]:
        if not ctx.masks:
            return None
        mask = ctx.masks[0]
        for m in ctx.masks[1:]:
            mask = torch.logical_and(mask, m)
        return mask

    def _exec_assign(self, stmt: ir.Assign, ctx: _Ctx) -> None:
        value = self._eval(stmt.value, ctx)
        view = self.views[stmt.target.name]
        if stmt.target.data_index and self._has_dynamic_index(stmt.target, ctx):
            self._assign_dynamic_component(stmt, value, ctx)
            return
        idx = self._target_index(stmt.target, ctx)
        rhs = _cast(value, view.dtype)
        region = view.data[idx]
        mask = self._mask(ctx)
        if mask is not None:
            if mask.ndim and mask.ndim < region.ndim:
                mask = mask.reshape(tuple(mask.shape) + (1,) * (region.ndim - mask.ndim))
            rhs = torch.where(mask, rhs, region)
        region.copy_(torch.broadcast_to(rhs, region.shape))

    def _has_dynamic_index(self, target: ir.FieldAccess, ctx: _Ctx) -> bool:
        return any(self._eval(e, ctx).ndim != 0 for e in target.data_index)

    def _assign_dynamic_component(self, stmt: ir.Assign, value, ctx: _Ctx) -> None:
        """Write to a per-point (dynamic) data-dimension component: a
        read-modify-write with a one-hot select over the data axes
        (dynamic indices wrap modulo the dimension size)."""
        target = stmt.target
        view = self.views[target.name]
        off = target.offset
        if not isinstance(off, ir.CartesianOffset):
            raise NotImplementedError("Non-Cartesian write offsets")
        si, sj, sk = self._spatial_slices(view, off, ctx)
        region = view.data[si, sj, sk]  # (ni, nj, nk, *dd)
        dd = tuple(region.shape[3:])
        n = len(dd)
        sel = torch.ones((1, 1, 1) + (1,) * n, dtype=torch.bool, device=self.device)
        for ax, expr in enumerate(target.data_index):
            iota = torch.arange(dd[ax], device=self.device).reshape(
                (1, 1, 1) + (1,) * ax + (dd[ax],) + (1,) * (n - ax - 1)
            )
            iv = self._eval(expr, ctx).to(torch.int64)
            if iv.ndim == 3:
                iv = iv.reshape(tuple(iv.shape) + (1,) * n)
            elif iv.ndim < 3:
                iv = iv.reshape((1, 1, 1) + (1,) * n)
            sel = sel & (iota == torch.remainder(iv, dd[ax]))
        mask = self._mask(ctx)
        if mask is not None:
            mask = mask.reshape(tuple(mask.shape) + (1,) * (region.ndim - mask.ndim))
            sel = sel & mask
        rhs = _cast(value, view.dtype)
        rhs = rhs.reshape(tuple(rhs.shape) + (1,) * (region.ndim - rhs.ndim))
        region.copy_(torch.where(sel, rhs, region))

    def _exec_if(self, stmt: ir.If, ctx: _Ctx) -> None:
        cond = self._eval(stmt.cond, ctx)
        if cond.ndim == 0:
            for s in (stmt.body if bool(cond) else stmt.orelse):
                self._exec_stmt(s, ctx)
            return
        mask = cond.to(torch.bool)
        ctx.masks.append(mask)
        for s in stmt.body:
            self._exec_stmt(s, ctx)
        ctx.masks.pop()
        if stmt.orelse:
            ctx.masks.append(torch.logical_not(mask))
            for s in stmt.orelse:
                self._exec_stmt(s, ctx)
            ctx.masks.pop()

    def _exec_while(self, stmt: ir.While, ctx: _Ctx) -> None:
        shape = ctx.shape()
        mask = torch.broadcast_to(self._eval(stmt.cond, ctx).to(torch.bool), shape).clone()
        # points excluded by enclosing if/region masks must not keep the
        # loop alive (their condition can never change)
        for m in ctx.masks:
            mask &= torch.broadcast_to(m.to(torch.bool), shape)
        while bool(mask.any()):
            ctx.masks.append(mask)
            for s in stmt.body:
                self._exec_stmt(s, ctx)
            ctx.masks.pop()
            mask = torch.logical_and(
                mask, torch.broadcast_to(self._eval(stmt.cond, ctx).to(torch.bool), shape)
            )

    def _exec_horizontal(self, stmt: ir.HorizontalRestriction, ctx: _Ctx) -> None:
        dI, dJ, _ = self.domain
        i_glob = torch.arange(ctx.ext.i[0], dI + ctx.ext.i[1], device=self.device).reshape(-1, 1, 1)
        j_glob = torch.arange(ctx.ext.j[0], dJ + ctx.ext.j[1], device=self.device).reshape(1, -1, 1)
        mask = torch.zeros((ctx.ni, ctx.nj, 1), dtype=torch.bool, device=self.device)
        for m in stmt.masks:
            ilo, ihi = m.i.resolve(dI)
            jlo, jhi = m.j.resolve(dJ)
            mask |= (i_glob >= ilo) & (i_glob < ihi) & (j_glob >= jlo) & (j_glob < jhi)
        ctx.masks.append(torch.broadcast_to(mask, ctx.shape()))
        for s in stmt.body:
            self._exec_stmt(s, ctx)
        ctx.masks.pop()

    # ------------------- indexing ------------------- #

    def _spatial_slices(self, view: _View, off: ir.CartesianOffset, ctx: _Ctx):
        dI, dJ, _ = self.domain
        oi, oj, ok = view.origin
        shape = view.data.shape
        si = (slice(0, 1) if shape[0] == 1
              else slice(oi + ctx.ext.i[0] + off.i, oi + dI + ctx.ext.i[1] + off.i))
        sj = (slice(0, 1) if shape[1] == 1
              else slice(oj + ctx.ext.j[0] + off.j, oj + dJ + ctx.ext.j[1] + off.j))
        if shape[2] == 1:
            sk = slice(0, 1)
        elif ctx.klevel is not None:
            k = ok + ctx.klevel + off.k
            sk = slice(k, k + 1)
        else:
            k0, k1 = ctx.kslice
            sk = slice(ok + k0 + off.k, ok + k1 + off.k)
        return si, sj, sk

    def _target_index(self, target: ir.FieldAccess, ctx: _Ctx):
        view = self.views[target.name]
        off = target.offset
        if not isinstance(off, ir.CartesianOffset):
            raise NotImplementedError("Non-Cartesian write offsets")
        idx: Tuple[Any, ...] = self._spatial_slices(view, off, ctx)
        if target.data_index:
            idx = idx + tuple(self._data_index_value(d, ctx) for d in target.data_index)
        return idx

    def _data_index_value(self, expr: ir.Expr, ctx: _Ctx):
        v = self._eval(expr, ctx)
        if v.ndim == 0:
            return int(v)
        raise NotImplementedError("Non-scalar data-dimension write indices")

    def _apply_data_index(self, out: torch.Tensor, acc: ir.FieldAccess, ctx: _Ctx):
        """Consume the trailing data axes of ``out`` (ni, nj, nk, *dd) one
        index expression at a time; per-point (dynamic) indices gather
        along the data axis and wrap modulo its size."""
        for expr in acc.data_index:
            static = try_static_int(expr)
            if static is not None:
                out = out[:, :, :, static]
                continue
            idx = self._eval(expr, ctx)
            if idx.ndim == 0:
                out = out[:, :, :, int(idx) % out.shape[3]]
                continue
            if idx.ndim != 3:
                raise NotImplementedError("Data index must be scalar or per-point")
            rem = out.ndim - 4
            idx = torch.remainder(idx.to(torch.int64), out.shape[3])
            idx_exp = idx.reshape(tuple(idx.shape) + (1,) * (rem + 1))
            shape = torch.broadcast_shapes(
                tuple(idx_exp.shape), tuple(out.shape[:3]) + (1,) + tuple(out.shape[4:])
            )
            src = torch.broadcast_to(out, tuple(shape[:3]) + tuple(out.shape[3:]))
            g = torch.gather(src, 3, torch.broadcast_to(idx_exp, shape))
            out = g.reshape(tuple(g.shape[:3]) + tuple(g.shape[4:]))
        return out

    # ------------------- expressions ------------------- #

    def _const(self, value, dt) -> torch.Tensor:
        key = (value, str(dt), self.device)
        t = self._consts.get(key)
        if t is None:
            t = torch.tensor(value, dtype=dtypes.to_torch(dt), device=self.device)
            self._consts[key] = t
        return t

    def _scalar(self, name: str) -> torch.Tensor:
        decl = self.stencil.scalar_decls[name]
        v = self.scalars[name]
        if isinstance(v, torch.Tensor):
            dt = dtypes.to_torch(decl.dtype) if decl.dtype is not None else v.dtype
            return v.to(device=self.device, dtype=dt)
        dt = np.asarray(v).dtype if decl.dtype is None else np.dtype(decl.dtype)
        return torch.tensor(dtypes.scalar_value(v, dt), dtype=dtypes.to_torch(dt),
                            device=self.device)

    def _eval(self, expr: ir.Expr, ctx: _Ctx) -> torch.Tensor:
        if isinstance(expr, ir.Literal):
            if expr.dtype is not None:
                return self._const(expr.value, np.dtype(expr.dtype))
            if isinstance(expr.value, bool):
                return self._const(expr.value, _BOOL)
            if isinstance(expr.value, int):
                return self._const(expr.value, default_int_dtype(self.stencil))
            return self._const(expr.value, default_float_dtype(self.stencil))

        if isinstance(expr, ir.ScalarAccess):
            t = self._scalar_tensors.get(expr.name)
            if t is None:
                t = self._scalar_tensors[expr.name] = self._scalar(expr.name)
            return t

        if isinstance(expr, ir.FieldAccess):
            return self._eval_field_access(expr, ctx)

        if isinstance(expr, ir.AxisPosition):
            dI, dJ, _ = self.domain
            idt = dtypes.to_torch(default_int_dtype(self.stencil))
            if expr.axis == "I":
                return torch.arange(ctx.ext.i[0], dI + ctx.ext.i[1], dtype=idt,
                                    device=self.device).reshape(-1, 1, 1)
            if expr.axis == "J":
                return torch.arange(ctx.ext.j[0], dJ + ctx.ext.j[1], dtype=idt,
                                    device=self.device).reshape(1, -1, 1)
            if ctx.klevel is not None:
                return torch.tensor(ctx.klevel, dtype=idt, device=self.device)
            return torch.arange(ctx.kslice[0], ctx.kslice[1], dtype=idt,
                                device=self.device).reshape(1, 1, -1)

        if isinstance(expr, ir.AxisSize):
            size = {"I": self.domain[0], "J": self.domain[1], "K": self.domain[2]}[expr.axis]
            return self._const(size, default_int_dtype(self.stencil))

        if isinstance(expr, ir.Cast):
            return _cast(self._eval(expr.expr, ctx), expr.dtype)

        if isinstance(expr, ir.UnaryOp):
            v = self._eval(expr.expr, ctx)
            if expr.op == ir.UnaryOperator.NOT:
                return torch.logical_not(v)
            if expr.op == ir.UnaryOperator.NEG:
                return torch.neg(v)
            return v

        if isinstance(expr, ir.BinaryOp):
            left = self._eval(expr.left, ctx)
            right = self._eval(expr.right, ctx)
            if expr.op == ir.BinaryOperator.AND:
                return torch.logical_and(left, right)
            if expr.op == ir.BinaryOperator.OR:
                return torch.logical_or(left, right)
            target = promote_dtypes(_np_dtype(left), _np_dtype(right))
            return _BINOPS[expr.op](_cast(left, target), _cast(right, target))

        if isinstance(expr, ir.TernaryOp):
            cond = self._eval(expr.cond, ctx)
            t = self._eval(expr.true_expr, ctx)
            f = self._eval(expr.false_expr, ctx)
            target = promote_dtypes(_np_dtype(t), _np_dtype(f))
            return torch.where(cond.to(torch.bool), _cast(t, target), _cast(f, target))

        if isinstance(expr, ir.NativeFuncCall):
            args = [self._eval(a, ctx) for a in expr.args]
            target = promote_dtypes(*[_np_dtype(a) for a in args])
            if len(args) > 1:
                args = [_cast(a, target) for a in args]
            fn, float_args = _NATIVE_IMPL[expr.func]
            if float_args:
                args = [_as_float_arg(a) for a in args]
            return fn(*args)

        raise TypeError(f"Cannot evaluate {type(expr).__name__}")

    def _eval_field_access(self, acc: ir.FieldAccess, ctx: _Ctx):
        view = self.views[acc.name]
        off = acc.offset
        if isinstance(off, ir.CartesianOffset):
            si, sj, sk = self._spatial_slices(view, off, ctx)
            out = view.data[si, sj, sk]
        elif isinstance(off, ir.VariableKOffset):
            out = self._eval_variable_k(view, off, ctx)
        elif isinstance(off, ir.AbsoluteKIndex):
            out = self._eval_absolute_k(view, off, ctx)
        else:
            raise TypeError(f"Unknown offset {type(off).__name__}")
        if acc.data_index:
            out = self._apply_data_index(out, acc, ctx)
        return out

    def _gather_k(self, view: _View, kidx: torch.Tensor, ctx: _Ctx):
        si, sj, _ = self._spatial_slices(view, ir.CartesianOffset(), ctx)
        block = view.data[si, sj, :]
        # broadcast against the EVALUATION shape (ni, nj, nk), not the
        # buffer's K extent
        eval_shape = (block.shape[0], block.shape[1], ctx.nk)
        kidx_b = torch.broadcast_to(kidx, eval_shape)
        if block.ndim > 3:
            kidx_b = kidx_b.reshape(eval_shape + (1,) * (block.ndim - 3)).expand(
                eval_shape + tuple(block.shape[3:])
            )
        return torch.gather(block, 2, kidx_b)

    def _eval_variable_k(self, view: _View, off: ir.VariableKOffset, ctx: _Ctx):
        dk = self._eval(off.k, ctx).to(torch.int64)
        ok = view.origin[2]
        SK = view.data.shape[2]
        if ctx.klevel is not None:
            base = torch.tensor(ok + ctx.klevel, dtype=torch.int64, device=self.device)
        else:
            k0, k1 = ctx.kslice
            base = (ok + torch.arange(k0, k1, dtype=torch.int64, device=self.device)).reshape(1, 1, -1)
        return self._gather_k(view, torch.clamp(base + dk, 0, SK - 1), ctx)

    def _eval_absolute_k(self, view: _View, off: ir.AbsoluteKIndex, ctx: _Ctx):
        kval = self._eval(off.k, ctx).to(torch.int64)
        ok = view.origin[2]
        SK = view.data.shape[2]
        if kval.ndim == 0:
            si, sj, _ = self._spatial_slices(view, ir.CartesianOffset(), ctx)
            k = int(min(max(int(kval) + ok, 0), SK - 1))
            return view.data[si, sj, k: k + 1]
        return self._gather_k(view, torch.clamp(kval + ok, 0, SK - 1), ctx)


# --------------------------------------------------------------------------- #
# periodic boundaries
# --------------------------------------------------------------------------- #


def check_periodic(analysis: StencilAnalysis, names: Sequence[str], domain, periodic) -> None:
    """A periodic axis must be at least as long as every read halo on it."""
    ext = analysis.extents
    for name in names:
        e = ext.field_extent(name)
        for ax, (lo, hi) in (("I", e.i), ("J", e.j)):
            halo = max(-lo, hi)
            d = domain[0] if ax == "I" else domain[1]
            if ax in periodic and halo and d < halo:
                raise ValueError(
                    f"periodic {ax} domain ({d}) smaller than the read "
                    f"halo of field '{name}' ({halo})"
                )


def periodic_fill(analysis: StencilAnalysis, views: Dict[str, torch.Tensor],
                  domain, origins, periodic, names: Sequence[str]) -> None:
    """Fill, in place, the I then J halos of the logical views ``names``
    from the opposite interior edge, each to its field's read extent --
    the oracle's ``NumpyBackend._periodic_fill`` (numpy_backend.py:605).
    Filling I before J wraps the corners on both axes."""
    check_periodic(analysis, names, domain, periodic)
    dI, dJ, _ = domain
    ext = analysis.extents
    for name in names:
        a = views[name]
        e = ext.field_extent(name)
        hi0, hi1 = -e.i[0], e.i[1]
        hj0, hj1 = -e.j[0], e.j[1]
        oi, oj, _ = origins[name]
        if "I" in periodic and a.shape[0] != 1:
            if hi0:
                a[oi - hi0: oi] = a[oi + dI - hi0: oi + dI].clone()
            if hi1:
                a[oi + dI: oi + dI + hi1] = a[oi: oi + hi1].clone()
        if "J" in periodic and a.shape[1] != 1:
            if hj0:
                a[:, oj - hj0: oj] = a[:, oj + dJ - hj0: oj + dJ].clone()
            if hj1:
                a[:, oj + dJ: oj + dJ + hj1] = a[:, oj: oj + hj1].clone()


def has_horizontal_reads(analysis: StencilAnalysis, name: str) -> bool:
    e = analysis.extents.field_extent(name)
    return bool(e.i[0] or e.i[1] or e.j[0] or e.j[1])


def run_plain(executor: TorchExecutor, env, scalars, domain, origins, periodic) -> None:
    """Periodic fill + interpretation.  Written fields in ``env`` are
    output buffers and are filled in place; read-only fields are filled in
    a copy, so the caller's arguments stay unchanged."""
    analysis = executor.analysis
    env = dict(env)
    if periodic:
        names = [n for n in env if has_horizontal_reads(analysis, n)]
        for n in names:
            if not analysis.field_info[n].access.value & 2:
                env[n] = env[n].clone()
        periodic_fill(analysis, env, domain, origins, periodic, names)
    executor.run(env, scalars, domain, origins)


@register("torch")
class TorchBackend:
    """The plain executor backend (runs on any device)."""

    def __init__(self, analysis: StencilAnalysis, options: Optional[dict] = None):
        self.analysis = analysis
        self.executor = TorchExecutor(analysis)

    def apply(self, env, scalars, domain, origins, periodic=()) -> None:
        """Execute on ``env`` (logical views; written fields are output
        buffers), see ``StencilObject._execute``."""
        run_plain(self.executor, env, scalars, domain, origins, periodic)
