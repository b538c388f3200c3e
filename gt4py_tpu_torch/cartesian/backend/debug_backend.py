"""Debug executor: plain Python point-loops over the analyzed IR.

A third, independent semantics witness (reference counterpart:
src/gt4py/cartesian/backend/debug_backend.py:29, whose generated code is
plain Python ``for`` loops).  Where the numpy oracle evaluates whole-domain
slice expressions, this backend walks every grid point with Python
``for``/``if``/``while`` control flow and evaluates expressions to numpy
*scalars* -- so a broadcasting or slice-arithmetic bug in the oracle cannot
hide here, and vice versa.

Shares only the operator/dtype vocabulary with the oracle
(``promote_dtypes``, the native-function table); the evaluation structure
is deliberately disjoint.  Tests gate it against the oracle bitwise on
small domains (it is O(points x statements) slow by design).

A copy of ``gt4py_tpu.cartesian.backend.debug_backend``, registered as the
port's ``"debug"`` backend; it takes the port's call environment through
``NumpyBackend.apply`` (CPU tensors only).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from gt4py_tpu_torch.cartesian import ir
from gt4py_tpu_torch.cartesian.analysis import (
    StencilAnalysis,
    default_float_dtype,
    default_int_dtype,
    promote_dtypes,
    try_static_int,
)
from gt4py_tpu_torch.cartesian.backend import register
from gt4py_tpu_torch.cartesian.backend.numpy_backend import (
    _NATIVE_IMPL,
    _View,
    _apply_binop,
    NumpyBackend,
)


class _Point:
    """Evaluation state at one grid point (domain-relative i, j, k)."""

    __slots__ = ("i", "j", "k")

    def __init__(self, i: int, j: int, k: int):
        self.i = i
        self.j = j
        self.k = k


class DebugExecutor:
    """Point-loop interpreter: same numerics, no vectorization."""

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
        for name, decl in self.stencil.temp_decls.items():
            ext = self.analysis.extents.alloc_extent(name)
            shape = (
                domain[0] - ext.i[0] + ext.i[1],
                domain[1] - ext.j[0] + ext.j[1],
                domain[2] - ext.k[0] + ext.k[1],
            ) + tuple(decl.data_dims)
            self.views[name] = _View(
                data=np.zeros(shape, dtype=decl.dtype),
                origin=(-ext.i[0], -ext.j[0], -ext.k[0]),
                dtype=np.dtype(decl.dtype),
            )

        dK = self.domain[2]
        for loop in self.stencil.vertical_loops:
            for section in loop.sections:
                k0, k1 = section.interval.resolve(dK, self.scalars)
                k0, k1 = max(k0, 0), min(k1, dK)
                if k1 <= k0:
                    continue
                if loop.loop_order == ir.LoopOrder.PARALLEL:
                    for stmt in section.body:
                        self._sweep(stmt, range(k0, k1))
                else:
                    krange = range(k0, k1)
                    if loop.loop_order == ir.LoopOrder.BACKWARD:
                        krange = reversed(krange)
                    for k in krange:
                        for stmt in section.body:
                            self._sweep(stmt, (k,))

    def _sweep(self, stmt: ir.Stmt, krange) -> None:
        """Execute one top-level statement at every point of its extended
        domain (the oracle's per-statement extents drive halo coverage)."""
        ext = self.analysis.extents.stmt_extent(stmt)
        dI, dJ, _ = self.domain
        for k in krange:
            for i in range(ext.i[0], dI + ext.i[1]):
                for j in range(ext.j[0], dJ + ext.j[1]):
                    self._exec(stmt, _Point(i, j, k))

    # ------------------- statements (per point) ------------------- #

    def _exec(self, stmt: ir.Stmt, pt: _Point) -> None:
        if isinstance(stmt, ir.Assign):
            self._assign(stmt, pt)
        elif isinstance(stmt, ir.If):
            cond = self._eval(stmt.cond, pt)
            body = stmt.body if bool(cond) else stmt.orelse
            for s in body:
                self._exec(s, pt)
        elif isinstance(stmt, ir.While):
            while bool(self._eval(stmt.cond, pt)):
                for s in stmt.body:
                    self._exec(s, pt)
        elif isinstance(stmt, ir.HorizontalRestriction):
            dI, dJ, _ = self.domain
            for m in stmt.masks:
                ilo, ihi = m.i.resolve(dI)
                jlo, jhi = m.j.resolve(dJ)
                if ilo <= pt.i < ihi and jlo <= pt.j < jhi:
                    for s in stmt.body:
                        self._exec(s, pt)
                    break
        else:
            raise TypeError(f"Unknown statement {type(stmt).__name__}")

    def _assign(self, stmt: ir.Assign, pt: _Point) -> None:
        value = self._eval(stmt.value, pt)
        target = stmt.target
        view = self.views[target.name]
        off = target.offset
        if not isinstance(off, ir.CartesianOffset):
            raise NotImplementedError("Non-Cartesian write offsets")
        idx = self._spatial_index(view, pt, off.i, off.j, off.k)
        if target.data_index:
            for ax, expr in enumerate(target.data_index):
                static = try_static_int(expr)
                if static is not None:
                    idx = idx + (static,)  # python negative-index semantics
                else:
                    dd = view.data.shape[3 + ax]
                    idx = idx + (int(self._eval(expr, pt)) % dd,)
        cell = np.asarray(value)
        if cell.dtype != view.dtype:
            cell = cell.astype(view.dtype)
        view.data[idx] = cell

    # ------------------- indexing (per point) ------------------- #

    def _spatial_index(
        self, view: _View, pt: _Point, oi: int, oj: int, ok: int
    ) -> Tuple[int, int, int]:
        vi, vj, vk = view.origin
        return (
            0 if view.data.shape[0] == 1 else vi + pt.i + oi,
            0 if view.data.shape[1] == 1 else vj + pt.j + oj,
            0 if view.data.shape[2] == 1 else vk + pt.k + ok,
        )

    # ------------------- expressions (per point) ------------------- #

    def _eval(self, expr: ir.Expr, pt: _Point):
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
            return self._field_value(expr, pt)

        if isinstance(expr, ir.AxisPosition):
            dt = default_int_dtype(self.stencil)
            v = {"I": pt.i, "J": pt.j, "K": pt.k}[expr.axis]
            return np.asarray(v, dtype=dt)[()]

        if isinstance(expr, ir.AxisSize):
            v = {"I": self.domain[0], "J": self.domain[1], "K": self.domain[2]}[expr.axis]
            return np.asarray(v, dtype=default_int_dtype(self.stencil))[()]

        if isinstance(expr, ir.Cast):
            return np.asarray(self._eval(expr.expr, pt)).astype(expr.dtype)[()]

        if isinstance(expr, ir.UnaryOp):
            v = self._eval(expr.expr, pt)
            if expr.op == ir.UnaryOperator.NOT:
                return np.logical_not(v)
            if expr.op == ir.UnaryOperator.NEG:
                return np.negative(v)
            return v

        if isinstance(expr, ir.BinaryOp):
            left = np.asarray(self._eval(expr.left, pt))
            right = np.asarray(self._eval(expr.right, pt))
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
            cond = self._eval(expr.cond, pt)
            t = np.asarray(self._eval(expr.true_expr, pt))
            f = np.asarray(self._eval(expr.false_expr, pt))
            target = promote_dtypes(t.dtype, f.dtype)
            return (t if bool(cond) else f).astype(target)

        if isinstance(expr, ir.NativeFuncCall):
            from gt4py_tpu_torch.cartesian.analysis import is_float_dtype

            args = [np.asarray(self._eval(a, pt)) for a in expr.args]
            target = promote_dtypes(*[a.dtype for a in args])
            if len(args) > 1:
                args = [a.astype(target) if a.dtype != target else a for a in args]
            res = np.asarray(_NATIVE_IMPL[expr.func](*args))
            if (
                res.dtype != target
                and res.dtype != np.dtype(np.bool_)
                and is_float_dtype(target)
                and target.itemsize < 4
            ):
                res = res.astype(target)
            return res[()] if res.ndim == 0 else res

        raise TypeError(f"Cannot evaluate {type(expr).__name__}")

    def _field_value(self, acc: ir.FieldAccess, pt: _Point):
        view = self.views[acc.name]
        off = acc.offset

        if isinstance(off, ir.CartesianOffset):
            idx = self._spatial_index(view, pt, off.i, off.j, off.k)
        elif isinstance(off, ir.VariableKOffset):
            dk = int(self._eval(off.k, pt))
            vk = view.origin[2]
            SK = view.data.shape[2]
            k = 0 if SK == 1 else int(np.clip(vk + pt.k + dk, 0, SK - 1))
            base = self._spatial_index(view, pt, 0, 0, 0)
            idx = (base[0], base[1], k)
        elif isinstance(off, ir.AbsoluteKIndex):
            kval = int(self._eval(off.k, pt))
            vk = view.origin[2]
            SK = view.data.shape[2]
            k = 0 if SK == 1 else int(np.clip(kval + vk, 0, SK - 1))
            base = self._spatial_index(view, pt, 0, 0, 0)
            idx = (base[0], base[1], k)
        else:
            raise TypeError(f"Unknown offset {type(off).__name__}")

        out = view.data[idx]  # scalar, or data-dims vector
        for ax, expr in enumerate(acc.data_index or ()):
            static = try_static_int(expr)
            if static is not None:
                out = out[static]
            else:
                out = out[int(self._eval(expr, pt)) % out.shape[0]]
        return out if getattr(out, "ndim", 0) else np.asarray(out)[()]


@register("debug")
class DebugBackend(NumpyBackend):
    """Registered debug backend: the point-loop executor with the numpy
    backend's call protocol (validation, periodic fill, exec_info)."""

    def __init__(self, analysis: StencilAnalysis, options: Optional[dict] = None):
        self.analysis = analysis
        self.executor = DebugExecutor(analysis)
