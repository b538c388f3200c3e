"""FVIR evaluator: executes typed field-view IR over Fields and scalars.

The counterpart of ``gt4py_tpu.next.interpreter`` (reference analog: the
embedded execution path, src/gt4py/next/embedded/operators.py + the
roundtrip runner runners/roundtrip.py:45-237).  One evaluator serves (a)
torch-backed Fields, eager on their device, and (b) numpy-backed Fields,
the independent oracle; semantics cannot fork because both run *this*
code.  Raw tensors (a scan's column planes) go through ``common.tnp``, so
they promote as numpy arrays do.

Literal casting rule: a weak literal adapts to the deduced result dtype
of its operation (frontend._result_scalar_kind), so e.g.
``f32_field * 2.0`` stays float32 on the numpy oracle and on torch;
casting per the deduced type makes them agree bit for bit.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from gt4py_tpu_torch.core import dtypes

from . import fvir, type_system as ts
from .common import Field, _astype, tnp
from .frontend import FieldViewError, _err


def _as_value(node: fvir.Expr, raw):
    """Cast a just-evaluated scalar to the node's deduced dtype."""
    t = node.type
    if isinstance(t, ts.ScalarType) and not isinstance(raw, Field):
        return dtypes.make_scalar(raw, t.kind) if not hasattr(raw, "dtype") else raw
    return raw


class Interpreter:
    def __init__(self, ir: fvir.OperatorIR, env: Dict[str, Any]):
        self.ir = ir
        self.env = env  # params + closure values

    def run(self):
        result = self._body(self.ir.body)
        return result

    class _ReturnValue(Exception):
        def __init__(self, value):
            self.value = value

    def _body(self, body: List[fvir.Stmt]):
        for st in body:
            if isinstance(st, fvir.Return):
                return self.eval(st.value)
            if isinstance(st, fvir.Assign):
                if not st.targets:
                    self.eval(st.value)  # program call / docstring no-op
                    continue
                v = self.eval(st.value)
                if st.unpack:
                    vs = tuple(v)
                    if len(vs) != len(st.targets):
                        raise _err(
                            f"cannot unpack {len(vs)} values into "
                            f"{len(st.targets)} targets", st
                        )
                    for name, val in zip(st.targets, vs):
                        self.env[name] = val
                else:
                    self.env[st.targets[0]] = v
            elif isinstance(st, fvir.IfStmt):
                cond = self.eval(st.cond)
                try:
                    flag = bool(cond)
                except Exception:
                    raise _err(
                        "'if' condition is data-dependent; use "
                        "where()/concat_where() instead", st.cond
                    )
                r = self._body(st.body if flag else st.orelse)
                if r is not None:
                    return r
            else:  # pragma: no cover
                raise _err(f"cannot execute {type(st).__name__}", st)
        return None

    # -- expressions -- #

    def eval(self, node: fvir.Expr):
        if isinstance(node, fvir.Name):
            return self.env[node.id]
        if isinstance(node, fvir.Literal):
            if node.value is None:
                return None
            t = node.type
            if isinstance(t, ts.ScalarType):
                return dtypes.make_scalar(node.value, t.kind)
            return node.value
        if isinstance(node, fvir.TupleExpr):
            return tuple(self.eval(e) for e in node.elts)
        if isinstance(node, fvir.DictExpr):
            from .common import domain_like

            return domain_like(
                {self.eval(k): self.eval(v) for k, v in zip(node.keys, node.values)}
            )
        if isinstance(node, fvir.UnaryOp):
            v = self.eval(node.operand)
            if node.op == "neg":
                return -v
            if node.op == "pos":
                return v
            if isinstance(v, Field):
                return ~v
            if isinstance(v, torch.Tensor):
                return tnp.logical_not(v)
            return np.logical_not(v) if not hasattr(v, "dtype") or isinstance(v, np.generic) else ~v
        if isinstance(node, fvir.BinOp):
            target = getattr(node, "operand_kind", None)
            left = self._cast_operand(node.left, target)
            right = self._cast_operand(node.right, target)
            return _BINFNS[node.op](left, right)
        if isinstance(node, fvir.Compare):
            if isinstance(node.left.type, ts.DimensionType):
                # K < 5 builds a Domain via the Dimension operators
                return _CMPFNS[node.op](self.eval(node.left), self.eval(node.right))
            target = getattr(node, "operand_kind", None)
            left = self._cast_operand(node.left, target)
            right = self._cast_operand(node.right, target)
            return _CMPFNS[node.op](left, right)
        if isinstance(node, fvir.BoolOp):
            vals = [self.eval(v) for v in node.values]
            out = vals[0]
            for v in vals[1:]:
                if isinstance(out, Field) or isinstance(v, Field):
                    out = (out & v) if node.op == "and" else (out | v)
                else:
                    out = (out and v) if node.op == "and" else (out or v)
            return out
        if isinstance(node, fvir.Ternary):
            cond = self.eval(node.cond)
            try:
                flag = bool(cond)
            except Exception:
                raise _err(
                    "ternary condition is data-dependent; use "
                    "where() instead", node.cond
                )
            return self.eval(node.true_expr if flag else node.false_expr)
        if isinstance(node, fvir.Subscript):
            v = self.eval(node.value)
            return v[node.index]
        if isinstance(node, fvir.AttrGet):
            v = self.eval(node.value)
            return v[node.index]  # index resolved by type deduction
        if isinstance(node, fvir.FieldSlice):
            f, _, _ = self._eval_field_slice(node)
            return f
        if isinstance(node, fvir.Call):
            return self._call(node)
        raise _err(f"cannot evaluate {type(node).__name__}", node)

    def _cast_operand(self, opnode: fvir.Expr, target):
        """Evaluate an operand; weak scalars (and weak fields: where()/
        broadcast() of literals) are cast to the operation's deduced
        operand dtype so oracle and product agree bitwise.  Tuple-typed
        operands (tuple-branch where/concat_where) cast member-by-member
        against a tuple of kinds."""
        return self._cast_value(opnode.type, self.eval(opnode), target)

    def _cast_value(self, t, v, target):
        if target is None:
            return v
        if isinstance(t, ts.TupleType) and isinstance(v, tuple):
            if not isinstance(target, tuple):
                target = (target,) * len(v)
            return tuple(
                self._cast_value(tt, vv, tg)
                for tt, vv, tg in zip(t.types, v, target)
            )
        if isinstance(target, tuple):  # non-tuple value with tuple kinds
            return v
        if isinstance(t, ts.FieldType) and t.dtype.weak and isinstance(v, Field):
            dt = np.dtype(target)
            if np.dtype(v.dtype) != dt:
                return Field(v.domain, _astype(v.data, dt))
            return v
        if isinstance(t, ts.ScalarType) and t.weak and not isinstance(v, Field):
            if isinstance(v, (int, float, bool, complex, np.generic)):
                return dtypes.make_scalar(v, target)
            # array scalar (a scan's column plane)
            return _astype(v, np.dtype(target))
        return v

    def _eval_field_slice(self, node: fvir.FieldSlice):
        """Evaluate a relative out-slice: returns (restricted_field,
        parent_field, buffer_index).  Restrictions are views (numpy and
        torch), so writes into them reach the parent."""
        parent = self.eval(node.value)
        if not isinstance(parent, Field):
            raise _err("only fields can be sliced", node)
        index = tuple(slice(lo, hi) for lo, hi in node.slices)
        try:
            dom, idx = parent._slice_spec(index)
        except IndexError as ex:
            raise _err(f"out= slice out of range: {ex}", node) from ex
        return Field(dom, parent.data[idx]), parent, idx

    def _call(self, node: fvir.Call):
        order = getattr(node, "collection_order", None)
        if order is not None:
            # named-collection constructor: ordered plain tuple in-IR
            members = {}
            for name, a in zip(order, node.args):
                members[name] = self.eval(a)
            for k, v in node.kwargs.items():
                members[k] = self.eval(v)
            return tuple(members[n] for n in order)
        fn = self.eval(node.func)
        # builtins whose typing rule ran _binop_type (where/concat_where/
        # maximum/minimum/...) record the deduced operand kind; weak
        # literal/weak-field arguments must be cast to it, exactly like
        # binary operators -- otherwise where(c, 0.0, f32_field)
        # materializes np.float64(0.0) and silently upcasts the result.
        okind = getattr(node, "operand_kind", None)
        args = [self._cast_operand(a, okind) for a in node.args]

        def eval_out(expr):
            # sliced out= targets: restricted views of the parent buffers
            if isinstance(expr, fvir.FieldSlice):
                sub, _, _ = self._eval_field_slice(expr)
                return sub
            if isinstance(expr, fvir.TupleExpr):
                return tuple(eval_out(e) for e in expr.elts)
            return self.eval(expr)

        kwargs = {
            k: (eval_out(v) if k == "out" else self.eval(v))
            for k, v in node.kwargs.items()
        }
        ftype = node.func.type
        if isinstance(ftype, ts.OperatorType):
            return fn(*args, **kwargs)
        if isinstance(ftype, ts.FieldType) or isinstance(fn, Field):
            return fn(*args)
        if isinstance(ftype, ts.BuiltinType) or callable(fn):
            return fn(*args, **kwargs)
        raise _err(f"cannot call value of type {ftype}", node)


def _op(np_name, py_op):
    """A binary operator: ``tnp.<np_name>`` when an operand is a raw tensor
    (numpy's promotion), the Python operator otherwise (Fields, scalars,
    numpy arrays, domains)."""

    def apply(a, b):
        if (isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor)) and not (
            isinstance(a, Field) or isinstance(b, Field)
        ):
            return getattr(tnp, np_name)(a, b)
        return py_op(a, b)

    return apply


_BINFNS = {
    "add": _op("add", lambda a, b: a + b),
    "sub": _op("subtract", lambda a, b: a - b),
    "mult": _op("multiply", lambda a, b: a * b),
    "div": _op("true_divide", lambda a, b: a / b),
    "floordiv": _op("floor_divide", lambda a, b: a // b),
    "mod": _op("mod", lambda a, b: a % b),
    "pow": _op("power", lambda a, b: a ** b),
}
_CMPFNS = {
    "lt": _op("less", lambda a, b: a < b),
    "le": _op("less_equal", lambda a, b: a <= b),
    "gt": _op("greater", lambda a, b: a > b),
    "ge": _op("greater_equal", lambda a, b: a >= b),
    "eq": _op("equal", lambda a, b: a == b),
    "ne": _op("not_equal", lambda a, b: a != b),
}
