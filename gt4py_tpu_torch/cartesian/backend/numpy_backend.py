"""NumPy oracle executor: the reference numerics.

Interprets the analyzed stencil IR with origin-shifted whole-domain slice
operations and serial K loops, reproducing the reference numpy backend's
computation semantics (reference: src/gt4py/cartesian/gtc/numpy/npir_codegen.py
slice construction :35-75 and the Field shim src/gt4py/cartesian/utils/field.py).

Dtype discipline: operands of every operation are cast to the C-style
promoted dtype before applying the numpy ufunc, matching the reference's
upcasting pass (gtc/passes/gtir_upcaster.py) instead of NEP-50 semantics.

A copy of ``gt4py_tpu.cartesian.backend.numpy_backend``, registered as the
port's ``"numpy"`` backend: an oracle independent of the port's torch and
CUDA executors, on machines without JAX.  ``NumpyBackend.apply`` takes the
port's call environment (CPU tensors, as ``.numpy()`` views that the
executor writes in place); a CUDA tensor raises ``ArgumentError`` rather
than being copied to the host, and bfloat16, which numpy lacks here,
raises ``TypeError``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import scipy.special as sps

from gt4py_tpu_torch.cartesian import ir
from gt4py_tpu_torch.cartesian.analysis import (
    StencilAnalysis,
    default_float_dtype,
    default_int_dtype,
    is_float_dtype,
    promote_dtypes,
)
from gt4py_tpu_torch.cartesian.backend import register
from gt4py_tpu_torch.core.definitions import Extent


def _round_away_from_zero(x):
    x = np.asarray(x)
    half = np.asarray(0.5, dtype=x.dtype if is_float_dtype(x.dtype) else np.float64)
    return np.trunc(x + np.copysign(half, x))


_NATIVE_IMPL = {
    ir.NativeFunction.ABS: np.abs,
    ir.NativeFunction.MIN: np.minimum,
    ir.NativeFunction.MAX: np.maximum,
    ir.NativeFunction.MOD: np.mod,
    ir.NativeFunction.SIN: np.sin,
    ir.NativeFunction.COS: np.cos,
    ir.NativeFunction.TAN: np.tan,
    ir.NativeFunction.ARCSIN: np.arcsin,
    ir.NativeFunction.ARCCOS: np.arccos,
    ir.NativeFunction.ARCTAN: np.arctan,
    ir.NativeFunction.ARCTAN2: np.arctan2,
    ir.NativeFunction.SINH: np.sinh,
    ir.NativeFunction.COSH: np.cosh,
    ir.NativeFunction.TANH: np.tanh,
    ir.NativeFunction.ARCSINH: np.arcsinh,
    ir.NativeFunction.ARCCOSH: np.arccosh,
    ir.NativeFunction.ARCTANH: np.arctanh,
    ir.NativeFunction.SQRT: np.sqrt,
    ir.NativeFunction.EXP: np.exp,
    ir.NativeFunction.LOG: np.log,
    ir.NativeFunction.LOG10: np.log10,
    ir.NativeFunction.LOG2: np.log2,
    ir.NativeFunction.GAMMA: sps.gamma,
    ir.NativeFunction.CBRT: np.cbrt,
    ir.NativeFunction.ISFINITE: np.isfinite,
    ir.NativeFunction.ISINF: np.isinf,
    ir.NativeFunction.ISNAN: np.isnan,
    ir.NativeFunction.FLOOR: np.floor,
    ir.NativeFunction.CEIL: np.ceil,
    ir.NativeFunction.TRUNC: np.trunc,
    ir.NativeFunction.ROUND: np.round,
    ir.NativeFunction.ROUND_AWAY_FROM_ZERO: _round_away_from_zero,
    ir.NativeFunction.ERF: sps.erf,
    ir.NativeFunction.ERFC: sps.erfc,
    ir.NativeFunction.POW: np.power,
}

_BOOL = np.dtype(np.bool_)


@dataclass
class _View:
    """3D(+data) broadcast view of a possibly lower-dimensional array.

    Missing spatial axes become size-1 broadcast dimensions, as in the
    reference Field shim (cartesian/utils/field.py:15-33).
    """

    data: np.ndarray  # shape (SI|1, SJ|1, SK|1, *data_dims)
    origin: Tuple[int, int, int]
    dtype: np.dtype

    @classmethod
    def wrap(
        cls,
        array: np.ndarray,
        dimensions: Tuple[bool, bool, bool],
        origin: Sequence[int],
        data_ndim: int,
    ) -> "_View":
        shape = list(array.shape)
        spatial_ndim = len(shape) - data_ndim
        full_shape: List[int] = []
        full_origin: List[int] = []
        it = iter(range(spatial_ndim))
        for present in dimensions:
            if present:
                ax = next(it)
                full_shape.append(shape[ax])
                full_origin.append(int(origin[ax]) if ax < len(origin) else 0)
            else:
                full_shape.append(1)
                full_origin.append(0)
        full_shape.extend(shape[spatial_ndim:])
        view = array.reshape(full_shape)
        return cls(data=view, origin=tuple(full_origin), dtype=array.dtype)


class _Ctx:
    """Evaluation context for one statement unit."""

    def __init__(
        self,
        exe: "NumpyExecutor",
        ext: Extent,
        kslice: Optional[Tuple[int, int]],
        klevel: Optional[int],
    ):
        self.exe = exe
        self.ext = ext
        self.kslice = kslice  # parallel: (k0, k1) domain-relative
        self.klevel = klevel  # serial: single domain-relative level
        self.masks: List[np.ndarray] = []

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


class NumpyExecutor:
    """Reference-semantics interpreter over numpy arrays (the oracle)."""

    def __init__(self, analysis: StencilAnalysis):
        self.analysis = analysis
        self.stencil = analysis.stencil

    # ------------------------------------------------------------------ #

    def run(
        self,
        arrays: Dict[str, np.ndarray],
        scalars: Dict[str, Any],
        domain: Tuple[int, int, int],
        origins: Dict[str, Tuple[int, ...]],
    ) -> None:
        self.domain = domain
        self.scalars = scalars
        self.views: Dict[str, _View] = {}

        for name, decl in self.stencil.field_decls.items():
            if name not in arrays or arrays[name] is None:
                continue
            self.views[name] = _View.wrap(
                arrays[name], decl.dimensions, origins[name], len(decl.data_dims)
            )

        # allocate temporaries on the extended domain (including K halo so
        # reads at K offsets crossing the domain edge stay in bounds)
        for name, decl in self.stencil.temp_decls.items():
            ext = self.analysis.extents.alloc_extent(name)
            shape = (
                domain[0] - ext.i[0] + ext.i[1],
                domain[1] - ext.j[0] + ext.j[1],
                domain[2] - ext.k[0] + ext.k[1],
            ) + tuple(decl.data_dims)
            arr = np.zeros(shape, dtype=decl.dtype)
            self.views[name] = _View(
                data=arr.reshape(shape),
                origin=(-ext.i[0], -ext.j[0], -ext.k[0]),
                dtype=decl.dtype,
            )

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

    def _exec_assign(self, stmt: ir.Assign, ctx: _Ctx) -> None:
        value = self._eval(stmt.value, ctx)
        view = self.views[stmt.target.name]
        if stmt.target.data_index and self._has_dynamic_index(stmt.target, ctx):
            self._assign_dynamic_component(stmt, value, ctx)
            return
        idx = self._target_index(stmt.target, ctx)
        target_dtype = view.dtype

        rhs = np.asarray(value)
        if rhs.dtype != target_dtype:
            rhs = rhs.astype(target_dtype)

        if ctx.masks:
            mask = ctx.masks[0]
            for m in ctx.masks[1:]:
                mask = np.logical_and(mask, m)
            old = view.data[idx]
            if mask.ndim and mask.ndim < old.ndim:
                mask = mask.reshape(mask.shape + (1,) * (old.ndim - mask.ndim))
            view.data[idx] = np.where(mask, rhs, old)
        else:
            view.data[idx] = np.broadcast_to(rhs, view.data[idx].shape)

    def _has_dynamic_index(self, target: ir.FieldAccess, ctx: _Ctx) -> bool:
        return any(
            np.asarray(self._eval(e, ctx)).ndim != 0 for e in target.data_index
        )

    def _assign_dynamic_component(self, stmt: ir.Assign, value, ctx: _Ctx) -> None:
        """Write to a per-point (dynamic) data-dimension component:
        read-modify-write with a one-hot select over the data axes
        (dynamic indices use modulo wrap, mirroring the read path)."""
        target = stmt.target
        view = self.views[target.name]
        off = target.offset
        if not isinstance(off, ir.CartesianOffset):
            raise NotImplementedError("Non-Cartesian write offsets")
        si, sj, sk = self._spatial_slices(view, off, ctx)
        region = view.data[si, sj, sk]  # (ni, nj, nk, *dd)
        dd = region.shape[3:]
        n = len(dd)
        sel = np.ones((1, 1, 1) + (1,) * n, dtype=bool)
        for ax, expr in enumerate(target.data_index):
            iota = np.arange(dd[ax]).reshape(
                (1, 1, 1) + (1,) * ax + (dd[ax],) + (1,) * (n - ax - 1)
            )
            iv = np.asarray(self._eval(expr, ctx)).astype(np.int64)
            iv = iv.reshape(iv.shape + (1,) * (n - iv.ndim + 3)) if iv.ndim > 3 else (
                iv.reshape(iv.shape + (1,) * n) if iv.ndim == 3
                else iv.reshape((1, 1, 1) + (1,) * n)
            )
            sel = sel & (iota == (iv % dd[ax]))
        if ctx.masks:
            mask = ctx.masks[0]
            for m in ctx.masks[1:]:
                mask = np.logical_and(mask, m)
            mask = np.asarray(mask)
            mask = mask.reshape(mask.shape + (1,) * (region.ndim - mask.ndim))
            sel = sel & mask
        rhs = np.asarray(value).astype(view.dtype)
        rhs = rhs.reshape(rhs.shape + (1,) * (region.ndim - rhs.ndim))
        view.data[si, sj, sk] = np.where(sel, rhs, region)

    def _exec_if(self, stmt: ir.If, ctx: _Ctx) -> None:
        cond = self._eval(stmt.cond, ctx)
        cond_arr = np.asarray(cond)
        if cond_arr.ndim == 0:
            if bool(cond_arr):
                for s in stmt.body:
                    self._exec_stmt(s, ctx)
            else:
                for s in stmt.orelse:
                    self._exec_stmt(s, ctx)
            return
        mask = cond_arr.astype(_BOOL)
        ctx.masks.append(mask)
        for s in stmt.body:
            self._exec_stmt(s, ctx)
        ctx.masks.pop()
        if stmt.orelse:
            ctx.masks.append(np.logical_not(mask))
            for s in stmt.orelse:
                self._exec_stmt(s, ctx)
            ctx.masks.pop()

    def _exec_while(self, stmt: ir.While, ctx: _Ctx) -> None:
        mask = np.broadcast_to(
            np.asarray(self._eval(stmt.cond, ctx)).astype(_BOOL), ctx.shape()
        ).copy()
        # points excluded by enclosing if/region masks must not keep the
        # loop alive (their condition can never change)
        for m in ctx.masks:
            mask &= np.broadcast_to(np.asarray(m, dtype=_BOOL), ctx.shape())
        while mask.any():
            ctx.masks.append(mask)
            for s in stmt.body:
                self._exec_stmt(s, ctx)
            ctx.masks.pop()
            mask = np.logical_and(
                mask, np.broadcast_to(np.asarray(self._eval(stmt.cond, ctx)), ctx.shape())
            )

    def _exec_horizontal(self, stmt: ir.HorizontalRestriction, ctx: _Ctx) -> None:
        dI, dJ, _ = self.domain
        i_glob = np.arange(ctx.ext.i[0], dI + ctx.ext.i[1]).reshape(-1, 1, 1)
        j_glob = np.arange(ctx.ext.j[0], dJ + ctx.ext.j[1]).reshape(1, -1, 1)
        mask = np.zeros((ctx.ni, ctx.nj, 1), dtype=bool)
        for m in stmt.masks:
            ilo, ihi = m.i.resolve(dI)
            jlo, jhi = m.j.resolve(dJ)
            mask |= (i_glob >= ilo) & (i_glob < ihi) & (j_glob >= jlo) & (j_glob < jhi)
        mask = np.broadcast_to(mask, ctx.shape())
        ctx.masks.append(mask)
        for s in stmt.body:
            self._exec_stmt(s, ctx)
        ctx.masks.pop()

    # ------------------- indexing ------------------- #

    def _spatial_slices(
        self, view: _View, off: ir.CartesianOffset, ctx: _Ctx
    ) -> Tuple[slice, slice, Any]:
        dI, dJ, _ = self.domain
        oi, oj, ok = view.origin
        si = (
            slice(0, 1)
            if view.data.shape[0] == 1
            else slice(oi + ctx.ext.i[0] + off.i, oi + dI + ctx.ext.i[1] + off.i)
        )
        sj = (
            slice(0, 1)
            if view.data.shape[1] == 1
            else slice(oj + ctx.ext.j[0] + off.j, oj + dJ + ctx.ext.j[1] + off.j)
        )
        if view.data.shape[2] == 1:
            sk: Any = slice(0, 1)
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
        si, sj, sk = self._spatial_slices(view, off, ctx)
        idx: Tuple[Any, ...] = (si, sj, sk)
        if target.data_index:
            idx = idx + tuple(self._data_index_value(d, ctx) for d in target.data_index)
        return idx

    def _data_index_value(self, expr: ir.Expr, ctx: _Ctx):
        v = self._eval(expr, ctx)
        arr = np.asarray(v)
        if arr.ndim == 0:
            return int(arr)
        raise NotImplementedError("Non-scalar data-dimension write indices")

    def _apply_data_index(self, out: np.ndarray, acc: ir.FieldAccess, ctx: _Ctx):
        """Consume the trailing data axes of ``out`` (shape (ni, nj, nk,
        *data_dims)) one index expression at a time; per-point (dynamic)
        int indices gather along the data axis (reference counterpart:
        gtc/common.py:390-398 -- data_index is any int expression)."""
        from gt4py_tpu_torch.cartesian.analysis import try_static_int

        for expr in acc.data_index:
            if try_static_int(expr) is not None:
                # static literal: python negative-index semantics
                # (validated in range at build time)
                out = out[:, :, :, try_static_int(expr)]
                continue
            idx = np.asarray(self._eval(expr, ctx))
            if idx.ndim == 0:
                out = out[:, :, :, int(idx) % out.shape[3]]
                continue
            # idx varies per grid point: broadcast over (ni, nj, nk) and
            # gather along the first remaining data axis
            if idx.ndim != 3:
                raise NotImplementedError("Data index must be scalar or per-point")
            rem = out.ndim - 4
            # dynamic indices wrap modulo the dimension size on EVERY
            # backend (writes already did; unwrapped reads diverged:
            # numpy raised, jax NaN-filled, pallas wrapped)
            idx = idx.astype(np.int64) % out.shape[3]
            idx_exp = idx.reshape(idx.shape + (1,) * (rem + 1))
            shape = np.broadcast_shapes(idx_exp.shape, out.shape[:3] + (1,) + out.shape[4:])
            g = np.take_along_axis(np.broadcast_to(out, shape[:3] + out.shape[3:]),
                                   np.broadcast_to(idx_exp, shape), axis=3)
            out = g.reshape(g.shape[:3] + g.shape[4:])
        return out

    # ------------------- expressions ------------------- #

    def _eval(self, expr: ir.Expr, ctx: _Ctx):
        if isinstance(expr, ir.Literal):
            if expr.dtype is not None:
                return np.asarray(expr.value, dtype=expr.dtype)[()]
            if isinstance(expr.value, bool):
                return np.bool_(expr.value)
            if isinstance(expr.value, int):
                return np.asarray(expr.value, dtype=default_int_dtype(self.stencil))[()]
            return np.asarray(expr.value, dtype=default_float_dtype(self.stencil))[()]

        if isinstance(expr, ir.ScalarAccess):
            decl = self.stencil.scalar_decls[expr.name]
            return np.asarray(self.scalars[expr.name], dtype=decl.dtype)[()]

        if isinstance(expr, ir.FieldAccess):
            return self._eval_field_access(expr, ctx)

        if isinstance(expr, ir.AxisPosition):
            dI, dJ, _ = self.domain
            if expr.axis == "I":
                return np.arange(ctx.ext.i[0], dI + ctx.ext.i[1], dtype=default_int_dtype(self.stencil)).reshape(-1, 1, 1)
            if expr.axis == "J":
                return np.arange(ctx.ext.j[0], dJ + ctx.ext.j[1], dtype=default_int_dtype(self.stencil)).reshape(1, -1, 1)
            if ctx.klevel is not None:
                return np.asarray(ctx.klevel, dtype=default_int_dtype(self.stencil))[()]
            return np.arange(ctx.kslice[0], ctx.kslice[1], dtype=default_int_dtype(self.stencil)).reshape(1, 1, -1)

        if isinstance(expr, ir.AxisSize):
            return np.asarray(
                {"I": self.domain[0], "J": self.domain[1], "K": self.domain[2]}[expr.axis],
                dtype=default_int_dtype(self.stencil),
            )[()]

        if isinstance(expr, ir.Cast):
            return np.asarray(self._eval(expr.expr, ctx)).astype(expr.dtype)

        if isinstance(expr, ir.UnaryOp):
            v = self._eval(expr.expr, ctx)
            if expr.op == ir.UnaryOperator.NOT:
                return np.logical_not(v)
            if expr.op == ir.UnaryOperator.NEG:
                return np.negative(v)
            return v

        if isinstance(expr, ir.BinaryOp):
            left = np.asarray(self._eval(expr.left, ctx))
            right = np.asarray(self._eval(expr.right, ctx))
            if expr.op == ir.BinaryOperator.AND:
                return np.logical_and(left, right)
            if expr.op == ir.BinaryOperator.OR:
                return np.logical_or(left, right)
            target = promote_dtypes(left.dtype, right.dtype)
            if left.dtype != target:
                left = left.astype(target)
            if right.dtype != target:
                right = right.astype(target)
            return _apply_binop(expr.op, left, right)

        if isinstance(expr, ir.TernaryOp):
            cond = np.asarray(self._eval(expr.cond, ctx))
            t = np.asarray(self._eval(expr.true_expr, ctx))
            f = np.asarray(self._eval(expr.false_expr, ctx))
            target = promote_dtypes(t.dtype, f.dtype)
            return np.where(cond, t.astype(target), f.astype(target))

        if isinstance(expr, ir.NativeFuncCall):
            args = [np.asarray(self._eval(a, ctx)) for a in expr.args]
            target = promote_dtypes(*[a.dtype for a in args])
            if len(args) > 1:
                args = [a.astype(target) if a.dtype != target else a for a in args]
            res = np.asarray(_NATIVE_IMPL[expr.func](*args))
            # sub-f32 float dtype discipline: numpy/scipy upcast some ufuncs
            # on bfloat16/float16 (mod -> f32, erf/gamma -> f64); compute at
            # the higher precision (a correctly-rounded oracle) but keep the
            # promoted operand dtype, matching the jax executor's result dtype
            if (
                res.dtype != target
                and res.dtype != _BOOL
                and is_float_dtype(target)
                and target.itemsize < 4
            ):
                res = res.astype(target)
            return res

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
            # out has shape (ni, nj, nk, *data_dims): index the trailing axes
            out = self._apply_data_index(out, acc, ctx)
        return out

    def _eval_variable_k(self, view: _View, off: ir.VariableKOffset, ctx: _Ctx):
        dk = np.asarray(self._eval(off.k, ctx)).astype(np.int64)
        ok = view.origin[2]
        SK = view.data.shape[2]
        if ctx.klevel is not None:
            base = np.asarray(ok + ctx.klevel, dtype=np.int64)
        else:
            k0, k1 = ctx.kslice
            base = (ok + np.arange(k0, k1, dtype=np.int64)).reshape(1, 1, -1)
        kidx = np.clip(base + dk, 0, SK - 1)
        si, sj, _ = self._spatial_slices(view, ir.CartesianOffset(), ctx)
        block = view.data[si, sj, :]
        # broadcast against the EVALUATION shape (ni, nj, nk), not the
        # buffer's K extent: nk differs from SK in serial loops and on
        # sub-intervals
        eval_shape = (block.shape[0], block.shape[1], ctx.nk)
        kidx_b = np.broadcast_to(kidx, eval_shape).astype(np.intp)
        return np.take_along_axis(block, kidx_b, axis=2)

    def _eval_absolute_k(self, view: _View, off: ir.AbsoluteKIndex, ctx: _Ctx):
        kval = np.asarray(self._eval(off.k, ctx)).astype(np.int64)
        ok = view.origin[2]
        SK = view.data.shape[2]
        si, sj, _ = self._spatial_slices(view, ir.CartesianOffset(), ctx)
        if kval.ndim == 0:
            k = int(np.clip(int(kval) + ok, 0, SK - 1))  # same clipping as jax
            return view.data[si, sj, k : k + 1]
        block = view.data[si, sj, :]
        kidx = np.clip(kval + ok, 0, SK - 1)
        eval_shape = (block.shape[0], block.shape[1], ctx.nk)
        kidx_b = np.broadcast_to(kidx, eval_shape).astype(np.intp)
        return np.take_along_axis(block, kidx_b, axis=2)


def _apply_binop(op: ir.BinaryOperator, left, right):
    table = {
        ir.BinaryOperator.ADD: np.add,
        ir.BinaryOperator.SUB: np.subtract,
        ir.BinaryOperator.MUL: np.multiply,
        ir.BinaryOperator.DIV: np.true_divide,
        ir.BinaryOperator.FLOOR_DIV: np.floor_divide,
        ir.BinaryOperator.MOD: np.mod,
        ir.BinaryOperator.POW: np.power,
        ir.BinaryOperator.EQ: np.equal,
        ir.BinaryOperator.NE: np.not_equal,
        ir.BinaryOperator.LT: np.less,
        ir.BinaryOperator.LE: np.less_equal,
        ir.BinaryOperator.GT: np.greater,
        ir.BinaryOperator.GE: np.greater_equal,
        ir.BinaryOperator.BIT_AND: np.bitwise_and,
        ir.BinaryOperator.BIT_OR: np.bitwise_or,
        ir.BinaryOperator.BIT_XOR: np.bitwise_xor,
    }
    return table[op](left, right)


@register("numpy")
class NumpyBackend:
    """The oracle backend: reference numpy-backend numerics.

    Also registered as ``debug``: the interpreter IS the readable
    reference-semantics executor (the reference's debug backend is plain
    Python loops with the same role, debug_backend.py:29)."""

    storage_device = "cpu"

    def __init__(self, analysis: StencilAnalysis, options: Optional[dict] = None):
        self.analysis = analysis
        self.executor = NumpyExecutor(analysis)

    def _periodic_fill(self, arrays, domain, origins, periodic) -> None:
        """Periodic execution semantics (the oracle's definition): before
        the stencil runs, the I/J halos of every field read with nonzero
        horizontal extent are filled in place from the opposite interior
        edge, width = the field's read extent.  The jax/pallas backends
        reproduce this bitwise (pre-fill under jit / wrapped-window DMA)."""
        dI, dJ, _ = domain
        ext = self.analysis.extents
        for name, arr in arrays.items():
            decl = self.analysis.stencil.field_decls[name]
            e = ext.field_extent(name)
            hi0, hi1 = -e.i[0], e.i[1]
            hj0, hj1 = -e.j[0], e.j[1]
            o = origins[name]
            ax = 0
            if decl.dimensions[0]:
                oi = o[ax]
                if "I" in periodic and (hi0 or hi1):
                    if dI < max(hi0, hi1):
                        raise ValueError(
                            f"periodic I domain ({dI}) smaller than the "
                            f"read halo of field '{name}' ({max(hi0, hi1)})"
                        )
                    sl = [slice(None)] * arr.ndim
                    src = [slice(None)] * arr.ndim
                    if hi0:
                        sl[ax] = slice(oi - hi0, oi)
                        src[ax] = slice(oi + dI - hi0, oi + dI)
                        arr[tuple(sl)] = arr[tuple(src)]
                    if hi1:
                        sl[ax] = slice(oi + dI, oi + dI + hi1)
                        src[ax] = slice(oi, oi + hi1)
                        arr[tuple(sl)] = arr[tuple(src)]
                ax += 1
            if decl.dimensions[1]:
                oj = o[ax]
                if "J" in periodic and (hj0 or hj1):
                    if dJ < max(hj0, hj1):
                        raise ValueError(
                            f"periodic J domain ({dJ}) smaller than the "
                            f"read halo of field '{name}' ({max(hj0, hj1)})"
                        )
                    sl = [slice(None)] * arr.ndim
                    src = [slice(None)] * arr.ndim
                    if hj0:
                        sl[ax] = slice(oj - hj0, oj)
                        src[ax] = slice(oj + dJ - hj0, oj + dJ)
                        arr[tuple(sl)] = arr[tuple(src)]
                    if hj1:
                        sl[ax] = slice(oj + dJ, oj + dJ + hj1)
                        src[ax] = slice(oj, oj + hj1)
                        arr[tuple(sl)] = arr[tuple(src)]

    def run(self, arrays, scalars, domain, origins, exec_info=None,
            periodic=()) -> None:
        import time

        if exec_info is not None:
            exec_info["run_start_time"] = time.perf_counter()
        if periodic:
            self._periodic_fill(arrays, domain, origins, periodic)
        self.executor.run(arrays, scalars, domain, origins)
        if exec_info is not None:
            exec_info["run_end_time"] = time.perf_counter()

    def apply(self, env, scalars, domain, origins, periodic=()) -> None:
        """Execute on the port's ``env`` (logical (I, J, K, *data_dims)
        views, written fields fresh output buffers; see
        ``StencilObject._execute``) through numpy views of the tensors."""
        import torch

        from gt4py_tpu_torch.cartesian.stencil_object import ArgumentError
        from gt4py_tpu_torch.core.definitions import BFLOAT16

        st = self.analysis.stencil
        decls = [*st.field_decls.values(), *st.temp_decls.values(), *st.scalar_decls.values()]
        if any(np.dtype(d.dtype) == BFLOAT16 for d in decls):
            raise TypeError(f"backend '{self.name}': stencil '{st.name}' has bfloat16 "
                            "declarations, which numpy cannot hold (no ml_dtypes)")
        arrays, origins_d = {}, {}
        for name, view in env.items():
            if view.device.type != "cpu":
                raise ArgumentError(
                    f"backend '{self.name}' runs on the host: field '{name}' is on "
                    f"{view.device}; pass CPU tensors or numpy arrays")
            dims = st.field_decls[name].dimensions
            # the declared layout: the view's size-1 stand-ins for absent axes dropped
            arrays[name] = view.detach().numpy()[tuple(slice(None) if m else 0 for m in dims)]
            origins_d[name] = tuple(o for o, m in zip(origins[name], dims) if m)
        scalars = {n: v.item() if isinstance(v, torch.Tensor) else v for n, v in scalars.items()}
        self.run(arrays, scalars, tuple(int(d) for d in domain), origins_d, periodic=periodic)
