"""GTScript frontend: Python AST -> stencil IR.

A fresh, compact re-implementation of the reference's GTScript parser
(reference: src/gt4py/cartesian/frontend/gtscript_frontend.py:886-2594) that
lowers directly to the single validated IR in ``..ir`` (no DefIR step).

Features: ``with computation(order)`` / ``interval(lo, hi)`` blocks,
relative Cartesian offsets (tuple and axis-name syntax), variable-K offsets,
``field.at(K=...)`` absolute indexing, data dimensions, ``@gtscript.function``
inlining with offset composition, externals (``from __externals__ import x``),
``__INLINED`` compile-time conditionals, ``compile_assert``, pointwise
``if``/``while``, ``with horizontal(region[...])`` restrictions, math
builtins, and augmented assignment.
"""

from __future__ import annotations

import ast
import copy
import inspect
import numbers
import textwrap
from dataclasses import dataclass, field as dc_field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from gt4py_tpu_torch import config
from gt4py_tpu_torch.cartesian import gtscript, ir


class GTScriptSyntaxError(SyntaxError):
    pass


class GTScriptDefinitionError(ValueError):
    pass


# --------------------------------------------------------------------------- #
# dtype resolution for annotations
# --------------------------------------------------------------------------- #

_SCALAR_ANNOTATIONS = {
    float: np.dtype(np.float64),
    int: np.dtype(np.int64),
    bool: np.dtype(np.bool_),
}


def resolve_dtype(spec: Any, dtypes_map: Dict[Any, Any]) -> np.dtype:
    """Resolve an annotation dtype spec, honoring the ``dtypes=`` mapping."""
    if dtypes_map and spec in dtypes_map:
        spec = dtypes_map[spec]
    if spec in _SCALAR_ANNOTATIONS:
        return _SCALAR_ANNOTATIONS[spec]
    if isinstance(spec, str):
        return np.dtype(spec)
    return np.dtype(spec)


_BINOP_MAP = {
    ast.Add: ir.BinaryOperator.ADD,
    ast.Sub: ir.BinaryOperator.SUB,
    ast.Mult: ir.BinaryOperator.MUL,
    ast.Div: ir.BinaryOperator.DIV,
    ast.FloorDiv: ir.BinaryOperator.FLOOR_DIV,
    ast.Mod: ir.BinaryOperator.MOD,
    ast.Pow: ir.BinaryOperator.POW,
    ast.BitAnd: ir.BinaryOperator.BIT_AND,
    ast.BitOr: ir.BinaryOperator.BIT_OR,
    ast.BitXor: ir.BinaryOperator.BIT_XOR,
}

_CMPOP_MAP = {
    ast.Eq: ir.BinaryOperator.EQ,
    ast.NotEq: ir.BinaryOperator.NE,
    ast.Lt: ir.BinaryOperator.LT,
    ast.LtE: ir.BinaryOperator.LE,
    ast.Gt: ir.BinaryOperator.GT,
    ast.GtE: ir.BinaryOperator.GE,
}

_NATIVE_FUNCS = {
    "abs": ir.NativeFunction.ABS,
    "min": ir.NativeFunction.MIN,
    "max": ir.NativeFunction.MAX,
    "mod": ir.NativeFunction.MOD,
    "sin": ir.NativeFunction.SIN,
    "cos": ir.NativeFunction.COS,
    "tan": ir.NativeFunction.TAN,
    "asin": ir.NativeFunction.ARCSIN,
    "acos": ir.NativeFunction.ARCCOS,
    "atan": ir.NativeFunction.ARCTAN,
    "atan2": ir.NativeFunction.ARCTAN2,
    "sinh": ir.NativeFunction.SINH,
    "cosh": ir.NativeFunction.COSH,
    "tanh": ir.NativeFunction.TANH,
    "asinh": ir.NativeFunction.ARCSINH,
    "acosh": ir.NativeFunction.ARCCOSH,
    "atanh": ir.NativeFunction.ARCTANH,
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
    "round": ir.NativeFunction.ROUND,
    "round_away_from_zero": ir.NativeFunction.ROUND_AWAY_FROM_ZERO,
    "erf": ir.NativeFunction.ERF,
    "erfc": ir.NativeFunction.ERFC,
    "pow": ir.NativeFunction.POW,
}

_CAST_NAMES = {
    "int8": np.dtype(np.int8),
    "int16": np.dtype(np.int16),
    "int32": np.dtype(np.int32),
    "int64": np.dtype(np.int64),
    "float32": np.dtype(np.float32),
    "float64": np.dtype(np.float64),
    "int": np.dtype(np.int64),
    "float": np.dtype(np.float64),
    "bool": np.dtype(np.bool_),
}


@dataclass
class StencilContext:
    """Shared mutable state while building one stencil's IR."""

    name: str
    externals: Dict[str, Any]
    dtypes_map: Dict[Any, Any]
    definition_globals: Dict[str, Any]
    field_decls: Dict[str, ir.FieldDecl] = dc_field(default_factory=dict)
    scalar_decls: Dict[str, ir.ScalarDecl] = dc_field(default_factory=dict)
    temp_decls: Dict[str, ir.FieldDecl] = dc_field(default_factory=dict)
    used_externals: Dict[str, Any] = dc_field(default_factory=dict)
    _gensym: int = 0

    def gensym(self, base: str) -> str:
        self._gensym += 1
        return f"{base}__gen_{self._gensym}"

    def declare_temp(self, name: str) -> ir.FieldDecl:
        if name not in self.temp_decls:
            self.temp_decls[name] = ir.FieldDecl(
                name=name, dtype=None, dimensions=(True, True, True), is_api=False
            )
        return self.temp_decls[name]


def _const_int(node: ast.AST) -> Optional[int]:
    """Extract a compile-time integer from an AST node (handles unary +-)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, (int, np.integer)):
        if isinstance(node.value, bool):
            return None
        return int(node.value)
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, (ast.USub, ast.UAdd)):
        v = _const_int(node.operand)
        if v is None:
            return None
        return -v if isinstance(node.op, ast.USub) else v
    return None


def _with_item_call(item: ast.withitem) -> Tuple[Optional[str], Optional[ast.Call]]:
    """Return (callee_name, call_node) of a `with name(...)` item."""
    ctx = item.context_expr
    if isinstance(ctx, ast.Call) and isinstance(ctx.func, ast.Name):
        return ctx.func.id, ctx
    return None, None


# --------------------------------------------------------------------------- #
# IRMaker
# --------------------------------------------------------------------------- #


class IRMaker:
    """Builds IR statements/expressions from AST within a symbol scope.

    A fresh ``IRMaker`` is created for each inlined ``@gtscript.function``
    call with ``bindings`` mapping formal parameter names to caller IR
    expressions and ``rename`` mapping function locals to hidden temps
    (reference: gtscript_frontend.CallInliner, :488-746).
    """

    def __init__(
        self,
        ctx: StencilContext,
        *,
        bindings: Optional[Dict[str, Any]] = None,
        rename: Optional[Dict[str, str]] = None,
        local_externals: Optional[Dict[str, Any]] = None,
        func_globals: Optional[Dict[str, Any]] = None,
        in_function: bool = False,
    ):
        self.ctx = ctx
        self.bindings = bindings or {}
        self.rename = rename or {}
        self.local_externals = dict(local_externals or {})
        self.func_globals = func_globals if func_globals is not None else ctx.definition_globals
        self.in_function = in_function
        self._prelude: List[ir.Stmt] = []
        self.return_targets: Optional[List[str]] = None

    # -------------------- symbol resolution -------------------- #

    def _lookup_value(self, name: str):
        """Resolve a compile-time value (external/global); KeyError if absent."""
        if name in self.local_externals:
            return self.local_externals[name]
        if name in self.ctx.externals:
            return self.ctx.externals[name]
        if name in self.func_globals:
            return self.func_globals[name]
        raise KeyError(name)

    def _name_to_expr(self, name: str) -> ir.Expr:
        if name in self.bindings:
            b = self.bindings[name]
            return copy.deepcopy(b) if isinstance(b, ir.Expr) else self._value_to_expr(b)
        if name in self.rename:
            return ir.FieldAccess(name=self.rename[name])
        if name in self.ctx.field_decls or name in self.ctx.temp_decls:
            return ir.FieldAccess(name=name)
        if name in self.ctx.scalar_decls:
            return ir.ScalarAccess(name=name)
        if name in ("I", "J", "K") and not self._is_user_symbol(name):
            return ir.AxisPosition(axis=name)
        try:
            value = self._lookup_value(name)
        except KeyError:
            if self.in_function:
                # First assignment to a function-local creates a hidden temp.
                raise
            raise GTScriptSyntaxError(
                f"Unknown symbol '{name}' in stencil '{self.ctx.name}'"
            ) from None
        return self._value_to_expr(value, name)

    def _is_user_symbol(self, name: str) -> bool:
        return (
            name in self.ctx.field_decls
            or name in self.ctx.scalar_decls
            or name in self.ctx.temp_decls
            or name in self.bindings
            or name in self.rename
        )

    def _value_to_expr(self, value: Any, name: str = "?") -> ir.Expr:
        if isinstance(value, ir.Expr):
            return copy.deepcopy(value)
        if isinstance(value, (bool, np.bool_)):
            return ir.Literal(value=bool(value), dtype=np.dtype(np.bool_))
        if isinstance(value, (int, np.integer)):
            return ir.Literal(value=int(value))
        if isinstance(value, (float, np.floating)):
            return ir.Literal(value=float(value))
        raise GTScriptSyntaxError(
            f"Cannot use value {value!r} (external '{name}') in an expression"
        )

    # -------------------- compile-time evaluation -------------------- #

    def _compile_time_eval(self, node: ast.AST) -> Any:
        """Evaluate an expression with externals at compile time
        (for ``__INLINED`` and ``compile_assert``)."""
        expr = ast.Expression(body=copy.deepcopy(node))
        ast.fix_missing_locations(expr)
        env: Dict[str, Any] = {}
        env.update(self.func_globals)
        env.update(self.ctx.externals)
        env.update(self.local_externals)
        for k, v in self.bindings.items():
            if not isinstance(v, ir.Expr):
                env[k] = v
        code = compile(expr, filename="<gt4py_tpu_torch-compile-time>", mode="eval")
        return eval(code, {"__builtins__": __builtins__}, env)

    # -------------------- statements -------------------- #

    def parse_stmts(self, stmts: Sequence[ast.stmt]) -> List[ir.Stmt]:
        out: List[ir.Stmt] = []
        for s in stmts:
            out.extend(self.parse_stmt(s))
        return out

    def parse_stmt(self, node: ast.stmt) -> List[ir.Stmt]:
        try:
            return self._parse_stmt_inner(node)
        except GTScriptSyntaxError as e:
            if not hasattr(e, "stencil_lineno"):
                e.stencil_lineno = getattr(node, "lineno", None)
            raise

    def _parse_stmt_inner(self, node: ast.stmt) -> List[ir.Stmt]:
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            return self._stmt_with_prelude(lambda: self._parse_assign(node))
        if isinstance(node, ast.If):
            return self._parse_if(node)
        if isinstance(node, ast.While):
            return self._stmt_with_prelude(lambda: self._parse_while(node))
        if isinstance(node, ast.With):
            return self._parse_with_horizontal(node)
        if isinstance(node, ast.ImportFrom):
            self._parse_import(node)
            return []
        if isinstance(node, ast.Expr):
            if isinstance(node.value, ast.Constant) and isinstance(node.value.value, str):
                return []  # docstring
            if (
                isinstance(node.value, ast.Call)
                and isinstance(node.value.func, ast.Name)
                and node.value.func.id == "compile_assert"
            ):
                if not self._compile_time_eval(node.value.args[0]):
                    raise GTScriptDefinitionError(
                        f"compile_assert failed at line {node.lineno} "
                        f"in stencil '{self.ctx.name}'"
                    )
                return []
            raise GTScriptSyntaxError(
                f"Unsupported expression statement at line {node.lineno}"
            )
        if isinstance(node, ast.Return):
            return self._parse_return(node)
        if isinstance(node, ast.Assert):
            if not self._compile_time_eval(node.test):
                raise GTScriptDefinitionError(f"assert failed at line {node.lineno}")
            return []
        if isinstance(node, ast.Pass):
            return []
        raise GTScriptSyntaxError(
            f"Unsupported statement {type(node).__name__} at line {getattr(node, 'lineno', '?')}"
        )

    def _stmt_with_prelude(self, fn) -> List[ir.Stmt]:
        saved = self._prelude
        self._prelude = []
        stmts = fn()
        prelude, self._prelude = self._prelude, saved
        return prelude + stmts

    def _parse_import(self, node: ast.ImportFrom) -> None:
        if node.module == "__externals__":
            for alias in node.names:
                try:
                    value = self._lookup_value(alias.name)
                except KeyError:
                    raise GTScriptDefinitionError(
                        f"Missing external '{alias.name}' for stencil '{self.ctx.name}'"
                    ) from None
                self.local_externals[alias.asname or alias.name] = value
                self.ctx.used_externals[alias.name] = value
        elif node.module == "__gtscript__":
            pass  # syntactic builtins -- always available
        else:
            raise GTScriptSyntaxError(f"Unsupported import '{node.module}'")

    def _parse_assign(self, node: Union[ast.Assign, ast.AugAssign, ast.AnnAssign]) -> List[ir.Stmt]:
        if isinstance(node, ast.AugAssign):
            target_expr = self._target_to_access(node.target)
            read = copy.deepcopy(target_expr)
            value = ir.BinaryOp(
                op=_BINOP_MAP[type(node.op)], left=read, right=self.parse_expr(node.value)
            )
            return [ir.Assign(target=target_expr, value=value)]

        if isinstance(node, ast.AnnAssign):
            targets: List[ast.expr] = [node.target]
            value_node = node.value
        else:
            if len(node.targets) != 1:
                raise GTScriptSyntaxError("Chained assignment is not supported")
            targets = [node.targets[0]]
            value_node = node.value

        target_node = targets[0]
        if isinstance(target_node, ast.Tuple):
            # Multi-value assignment: must come from a gtscript.function call
            # (or be element-wise pairs).
            value = self.parse_expr_multi(value_node, len(target_node.elts))
            out: List[ir.Stmt] = []
            for tgt, val in zip(target_node.elts, value):
                acc = self._target_to_access(tgt)
                out.append(ir.Assign(target=acc, value=val))
            return out

        if self._has_matmult(value_node):
            return self._parse_matmult_assign(target_node, value_node)
        value = self.parse_expr(value_node)
        acc = self._target_to_access(target_node)
        return [ir.Assign(target=acc, value=value)]

    # ---- `@` matrix-vector products over data dimensions ---- #
    #
    # Reference: GTScript parses MatMult (gtscript_frontend.py:1506) and
    # unrolls it into per-component multiply-add chains
    # (defir_to_gtir.py:265-273, UnrollVectorExpressions), including the
    # `.T` transposed read (UnaryOperator.TRANSPOSED).  The unroll here
    # happens at parse time: the IR stays scalar-component-based, every
    # backend (numpy oracle, debug, jax, pallas component-split) executes
    # the same statements.  Accumulation order matches the reference:
    # acc = m[j,0]*v[0]; acc = acc + m[j,i]*v[i] left-to-right.

    def _field_data_dims(self, expr) -> tuple:
        if not isinstance(expr, ir.FieldAccess) or expr.data_index:
            return ()
        decl = self.ctx.field_decls.get(expr.name) or self.ctx.temp_decls.get(
            expr.name
        )
        return tuple(decl.data_dims) if decl is not None and decl.data_dims else ()

    def _has_matmult(self, node: ast.expr) -> bool:
        for n in ast.walk(node):
            if isinstance(n, ast.BinOp) and isinstance(n.op, ast.MatMult):
                return True
            if (
                isinstance(n, ast.Attribute)
                and n.attr == "T"
                and isinstance(n.value, (ast.Name, ast.Subscript))
            ):
                # `.T` only triggers the vector path when the base is a
                # data-dims field (np.pi-style constants keep their path)
                try:
                    base = self.parse_expr(n.value)
                except GTScriptSyntaxError:
                    continue
                if len(self._field_data_dims(base)) == 2:
                    return True
        return False

    def _vector_expr(self, node: ast.expr):
        """Parse a vector-valued expression into (nested) lists of scalar
        component exprs; non-vector subexpressions return a plain Expr
        (broadcast over components by the combiners)."""

        def expand(expr: ir.Expr):
            dd = self._field_data_dims(expr)
            if len(dd) == 1:
                return [
                    self._component_ref(expr, (i,)) for i in range(dd[0])
                ]
            if len(dd) == 2:
                return [
                    [self._component_ref(expr, (r, c)) for c in range(dd[1])]
                    for r in range(dd[0])
                ]
            return expr

        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.MatMult):
            lhs = self._vector_expr(node.left)
            rhs = self._vector_expr(node.right)
            if not (
                isinstance(lhs, list)
                and lhs
                and isinstance(lhs[0], list)
                and isinstance(rhs, list)
                and not isinstance(rhs[0], list)
            ):
                raise GTScriptSyntaxError(
                    "`@` requires a matrix (2 data dimensions) on the left "
                    "and a vector (1 data dimension) on the right"
                )
            if len(lhs[0]) != len(rhs):
                raise GTScriptSyntaxError(
                    f"`@` dimension mismatch: matrix columns {len(lhs[0])} "
                    f"!= vector length {len(rhs)}"
                )
            out = []
            for row in lhs:
                acc = ir.BinaryOp(
                    op=ir.BinaryOperator.MUL,
                    left=row[0],
                    right=copy.deepcopy(rhs[0]),
                )
                for i in range(1, len(rhs)):
                    acc = ir.BinaryOp(
                        op=ir.BinaryOperator.ADD,
                        left=acc,
                        right=ir.BinaryOp(
                            op=ir.BinaryOperator.MUL,
                            left=row[i],
                            right=copy.deepcopy(rhs[i]),
                        ),
                    )
                out.append(acc)
            return out
        if isinstance(node, ast.Attribute) and node.attr == "T":
            try:
                base = self.parse_expr(node.value)
            except GTScriptSyntaxError:
                base = None
            if base is not None and len(self._field_data_dims(base)) == 2:
                mat = expand(base)
                return [list(col) for col in zip(*mat)]
            return self.parse_expr(node)
        if isinstance(node, ast.BinOp) and not isinstance(node.op, ast.MatMult):
            lhs = self._vector_expr(node.left)
            rhs = self._vector_expr(node.right)
            op = _BINOP_MAP[type(node.op)]
            return self._combine_elementwise(
                lhs, rhs, lambda a, b: ir.BinaryOp(op=op, left=a, right=b)
            )
        if isinstance(node, ast.UnaryOp) and isinstance(
            node.op, (ast.USub, ast.UAdd)
        ):
            operand = self._vector_expr(node.operand)
            uop = (
                ir.UnaryOperator.NEG
                if isinstance(node.op, ast.USub)
                else ir.UnaryOperator.POS
            )
            return self._map_components(
                operand, lambda e: ir.UnaryOp(op=uop, expr=e)
            )
        return expand(self.parse_expr(node))

    def _component_ref(self, access: ir.FieldAccess, idx) -> ir.FieldAccess:
        comp = copy.deepcopy(access)
        comp.data_index = tuple(ir.Literal(value=int(i)) for i in idx)
        return comp

    def _map_components(self, v, fn):
        if isinstance(v, list):
            return [self._map_components(x, fn) for x in v]
        return fn(v)

    def _combine_elementwise(self, lhs, rhs, fn):
        if isinstance(lhs, list) and isinstance(rhs, list):
            if len(lhs) != len(rhs):
                raise GTScriptSyntaxError(
                    "elementwise vector operation on mismatched lengths"
                )
            return [
                self._combine_elementwise(a, b, fn) for a, b in zip(lhs, rhs)
            ]
        if isinstance(lhs, list):
            return [
                self._combine_elementwise(a, copy.deepcopy(rhs), fn)
                for a in lhs
            ]
        if isinstance(rhs, list):
            return [
                self._combine_elementwise(copy.deepcopy(lhs), b, fn)
                for b in rhs
            ]
        return fn(lhs, rhs)

    def _parse_matmult_assign(
        self, target_node: ast.expr, value_node: ast.expr
    ) -> List[ir.Stmt]:
        comps = self._vector_expr(value_node)
        if not isinstance(comps, list):
            raise GTScriptSyntaxError(
                "`@`/.T expression did not produce a vector value"
            )
        target = self._target_to_access(target_node)
        if target.data_index:
            raise GTScriptSyntaxError(
                "cannot assign a vector `@` result to a single component"
            )
        tdd = self._field_data_dims(target)
        shape = (len(comps),) if not isinstance(comps[0], list) else (
            len(comps),
            len(comps[0]),
        )
        if tuple(tdd) != shape:
            # temporaries have no data dims in this frontend: `@` results
            # must land in a declared data-dims field (assign the product
            # directly, or through per-component scalar statements)
            raise GTScriptSyntaxError(
                f"assignment dimension mismatch: '{target.name}' has data "
                f"dims {tuple(tdd) or None}; `@` result has {shape}"
            )
        flat: List[Tuple[Tuple[int, ...], ir.Expr]] = []
        if len(shape) == 1:
            flat = [((i,), comps[i]) for i in range(shape[0])]
        else:
            flat = [
                ((r, c), comps[r][c])
                for r in range(shape[0])
                for c in range(shape[1])
            ]
        # simultaneity guard: if the target is read by the unrolled RHS,
        # stage components through scalar temporaries so `v = m @ v`
        # keeps whole-statement parallel-assignment semantics
        reads_target = any(
            isinstance(n, ir.FieldAccess) and n.name == target.name
            for _, e in flat
            for n in ir.walk_values(e)
        )
        stmts: List[ir.Stmt] = []
        if reads_target:
            tmps = []
            for idx, e in flat:
                tname = self.ctx.gensym(f"{target.name}_mm")
                self.ctx.declare_temp(tname)
                stmts.append(
                    ir.Assign(target=ir.FieldAccess(name=tname), value=e)
                )
                tmps.append((idx, tname))
            for idx, tname in tmps:
                stmts.append(
                    ir.Assign(
                        target=self._component_ref(target, idx),
                        value=ir.FieldAccess(name=tname),
                    )
                )
        else:
            for idx, e in flat:
                stmts.append(
                    ir.Assign(target=self._component_ref(target, idx), value=e)
                )
        return stmts

    def _target_to_access(self, node: ast.expr) -> ir.FieldAccess:
        if isinstance(node, ast.Name):
            name = node.id
            if name in self.bindings:
                b = self.bindings[name]
                if isinstance(b, ir.FieldAccess):
                    return copy.deepcopy(b)
                raise GTScriptSyntaxError(
                    f"Cannot assign to function parameter '{name}' bound to a scalar"
                )
            if name in self.rename:
                return ir.FieldAccess(name=self.rename[name])
            if name in self.ctx.scalar_decls:
                raise GTScriptSyntaxError(f"Cannot assign to scalar parameter '{name}'")
            if name not in self.ctx.field_decls:
                if self.in_function:
                    hidden = self.ctx.gensym(name)
                    self.rename[name] = hidden
                    self.ctx.declare_temp(hidden)
                    return ir.FieldAccess(name=hidden)
                self.ctx.declare_temp(name)
            return ir.FieldAccess(name=name)
        if isinstance(node, ast.Subscript):
            expr = self.parse_expr(node)
            if not isinstance(expr, ir.FieldAccess):
                raise GTScriptSyntaxError("Invalid assignment target")
            return expr
        raise GTScriptSyntaxError(
            f"Invalid assignment target {type(node).__name__}"
        )

    def _parse_if(self, node: ast.If) -> List[ir.Stmt]:
        # __INLINED compile-time conditional
        if (
            isinstance(node.test, ast.Call)
            and isinstance(node.test.func, ast.Name)
            and node.test.func.id == "__INLINED"
        ):
            cond = self._compile_time_eval(node.test.args[0])
            return self.parse_stmts(node.body if cond else node.orelse)

        def make() -> List[ir.Stmt]:
            cond = self.parse_expr(node.test)
            body = self.parse_stmts(node.body)
            orelse = self.parse_stmts(node.orelse)
            return [ir.If(cond=cond, body=body, orelse=orelse)]

        return self._stmt_with_prelude(make)

    def _parse_while(self, node: ast.While) -> List[ir.Stmt]:
        prelude_before = len(self._prelude)
        cond = self.parse_expr(node.test)
        if len(self._prelude) != prelude_before:
            # an inlined gtscript.function in the condition would be hoisted
            # and evaluated once, silently freezing the loop condition
            raise GTScriptSyntaxError(
                "gtscript.function calls are not supported in while conditions "
                "(the condition must be re-evaluated every iteration); assign "
                "the result inside the loop body instead"
            )
        body = self.parse_stmts(node.body)
        return [ir.While(cond=cond, body=body)]

    def _parse_with_horizontal(self, node: ast.With) -> List[ir.Stmt]:
        names = [_with_item_call(item)[0] for item in node.items]
        if names != ["horizontal"]:
            raise GTScriptSyntaxError(
                "Only 'with horizontal(region[...])' blocks are allowed here"
            )
        call = _with_item_call(node.items[0])[1]
        masks = [self._parse_region(arg) for arg in call.args]
        body = self.parse_stmts(node.body)
        return [ir.HorizontalRestriction(masks=masks, body=body)]

    def _parse_region(self, node: ast.expr) -> ir.HorizontalMask:
        """Parse ``region[i_spec, j_spec]``
        (reference: gtscript_frontend.HorizontalIntervalParser, :224-300)."""
        if not (
            isinstance(node, ast.Subscript)
            and isinstance(node.value, ast.Name)
            and node.value.id == "region"
        ):
            raise GTScriptSyntaxError("horizontal() arguments must be region[...]")
        sl = node.slice
        specs = list(sl.elts) if isinstance(sl, ast.Tuple) else [sl]
        if len(specs) != 2:
            raise GTScriptSyntaxError("region[...] must have exactly I and J specs")
        i_int = self._parse_region_interval(specs[0], "I")
        j_int = self._parse_region_interval(specs[1], "J")
        return ir.HorizontalMask(i=i_int, j=j_int)

    def _parse_region_interval(self, node: ast.expr, axis: str) -> ir.HorizontalInterval:
        if isinstance(node, ast.Slice):
            lo = self._parse_region_bound(node.lower, axis) if node.lower else None
            hi = self._parse_region_bound(node.upper, axis) if node.upper else None
            return ir.HorizontalInterval(start=lo, end=hi)
        # single point: value : value+1
        b = self._parse_region_bound(node, axis)
        return ir.HorizontalInterval(
            start=b, end=ir.AxisBound(b.level, b.offset + 1)
        )

    def _parse_region_bound(self, node: ast.expr, axis: str) -> ir.AxisBound:
        """AxisIndex semantics: I[n] -> START+n for n>=0, END+n for n<0
        (reference: gtscript_frontend.IntervalParser._make_axis_bound,
        :128-156 -- note I[-1] maps to END-1, the last point)."""
        value = self._region_bound_value(node, axis)
        if isinstance(value, gtscript.AxisIndex):
            idx = value.index + value.offset
            level = ir.LevelMarker.START if value.index >= 0 else ir.LevelMarker.END
            return ir.AxisBound(level, idx)
        if value is None:
            raise GTScriptSyntaxError("Invalid region bound")
        raise GTScriptSyntaxError(f"Invalid region bound {value!r}")

    def _region_bound_value(self, node: ast.expr, axis: str):
        if isinstance(node, ast.Subscript):
            if not (isinstance(node.value, ast.Name) and node.value.id == axis):
                raise GTScriptSyntaxError(
                    f"Expected axis {axis} in region specification"
                )
            idx = _const_int(node.slice)
            if idx is None:
                raise GTScriptSyntaxError("Region indices must be integer literals")
            return gtscript.AxisIndex(axis, idx)
        if isinstance(node, ast.BinOp) and isinstance(node.op, (ast.Add, ast.Sub)):
            left = self._region_bound_value(node.left, axis)
            shift = _const_int(node.right)
            if shift is None or not isinstance(left, gtscript.AxisIndex):
                raise GTScriptSyntaxError("Invalid region bound arithmetic")
            return left + (shift if isinstance(node.op, ast.Add) else -shift)
        raise GTScriptSyntaxError("Invalid region bound expression")

    def _parse_return(self, node: ast.Return) -> List[ir.Stmt]:
        if not self.in_function:
            raise GTScriptSyntaxError("return outside of gtscript.function")

        def make() -> List[ir.Stmt]:
            values: List[ir.Expr]
            if isinstance(node.value, ast.Tuple):
                values = [self.parse_expr(e) for e in node.value.elts]
            else:
                values = [self.parse_expr(node.value)]
            if self.return_targets is None:
                self.return_targets = [
                    self.ctx.gensym("retval") for _ in values
                ]
                for t in self.return_targets:
                    self.ctx.declare_temp(t)
            if len(values) != len(self.return_targets):
                raise GTScriptSyntaxError("Inconsistent number of return values")
            return [
                ir.Assign(target=ir.FieldAccess(name=t), value=v)
                for t, v in zip(self.return_targets, values)
            ]

        return self._stmt_with_prelude(make)

    # -------------------- expressions -------------------- #

    def parse_expr(self, node: ast.expr) -> ir.Expr:
        if isinstance(node, ast.Constant):
            return self._parse_constant(node)
        if isinstance(node, ast.Name):
            return self._name_to_expr(node.id)
        if isinstance(node, ast.Subscript):
            return self._parse_subscript(node)
        if isinstance(node, ast.BinOp):
            if isinstance(node.op, ast.MatMult):
                raise GTScriptSyntaxError(
                    "`@` (matrix-vector product) is only supported as the "
                    "right-hand side of an assignment"
                )
            return ir.BinaryOp(
                op=_BINOP_MAP[type(node.op)],
                left=self.parse_expr(node.left),
                right=self.parse_expr(node.right),
            )
        if isinstance(node, ast.UnaryOp):
            if isinstance(node.op, ast.USub):
                return ir.UnaryOp(op=ir.UnaryOperator.NEG, expr=self.parse_expr(node.operand))
            if isinstance(node.op, ast.UAdd):
                return ir.UnaryOp(op=ir.UnaryOperator.POS, expr=self.parse_expr(node.operand))
            if isinstance(node.op, ast.Not):
                return ir.UnaryOp(op=ir.UnaryOperator.NOT, expr=self.parse_expr(node.operand))
            raise GTScriptSyntaxError(f"Unsupported unary op {type(node.op).__name__}")
        if isinstance(node, ast.BoolOp):
            op = ir.BinaryOperator.AND if isinstance(node.op, ast.And) else ir.BinaryOperator.OR
            expr = self.parse_expr(node.values[0])
            for v in node.values[1:]:
                expr = ir.BinaryOp(op=op, left=expr, right=self.parse_expr(v))
            return expr
        if isinstance(node, ast.Compare):
            if len(node.ops) != 1:
                raise GTScriptSyntaxError("Chained comparisons are not supported")
            return ir.BinaryOp(
                op=_CMPOP_MAP[type(node.ops[0])],
                left=self.parse_expr(node.left),
                right=self.parse_expr(node.comparators[0]),
            )
        if isinstance(node, ast.IfExp):
            return ir.TernaryOp(
                cond=self.parse_expr(node.test),
                true_expr=self.parse_expr(node.body),
                false_expr=self.parse_expr(node.orelse),
            )
        if isinstance(node, ast.Call):
            result = self._parse_call(node)
            if isinstance(result, list):
                if len(result) != 1:
                    raise GTScriptSyntaxError(
                        "Multi-value function call used in single-value context"
                    )
                return result[0]
            return result
        if isinstance(node, ast.Attribute):
            # e.g. np.pi / math.pi style compile-time constants
            value = self._attribute_value(node)
            return self._value_to_expr(value)
        raise GTScriptSyntaxError(
            f"Unsupported expression {type(node).__name__} at line {getattr(node, 'lineno', '?')}"
        )

    def parse_expr_multi(self, node: ast.expr, n: int) -> List[ir.Expr]:
        """Parse an expression expected to produce ``n`` values."""
        if isinstance(node, ast.Tuple):
            if len(node.elts) != n:
                raise GTScriptSyntaxError("Mismatched tuple assignment arity")
            return [self.parse_expr(e) for e in node.elts]
        if isinstance(node, ast.Call):
            result = self._parse_call(node)
            if isinstance(result, list):
                if len(result) != n:
                    raise GTScriptSyntaxError("Mismatched function return arity")
                return result
            if n == 1:
                return [result]
        raise GTScriptSyntaxError("Expected multi-value expression")

    def _parse_constant(self, node: ast.Constant) -> ir.Expr:
        v = node.value
        if isinstance(v, bool):
            return ir.Literal(value=v, dtype=np.dtype(np.bool_))
        if isinstance(v, (int, float)):
            return ir.Literal(value=v)
        raise GTScriptSyntaxError(f"Unsupported literal {v!r}")

    def _attribute_value(self, node: ast.Attribute) -> Any:
        parts: List[str] = []
        cur: ast.expr = node
        while isinstance(cur, ast.Attribute):
            parts.append(cur.attr)
            cur = cur.value
        if not isinstance(cur, ast.Name):
            raise GTScriptSyntaxError("Unsupported attribute expression")
        try:
            value = self._lookup_value(cur.id)
        except KeyError:
            raise GTScriptSyntaxError(f"Unknown symbol '{cur.id}'") from None
        for attr in reversed(parts):
            value = getattr(value, attr)
        return value

    # ---- subscripts: offsets, variable-K, data dims ---- #

    def _parse_subscript(self, node: ast.Subscript) -> ir.Expr:
        # data-dimension access: field[0,0,0][i] or field[0,0,0][i,j]
        if isinstance(node.value, ast.Subscript):
            base = self._parse_subscript(node.value)
            if not isinstance(base, ir.FieldAccess):
                raise GTScriptSyntaxError("Invalid data-dimension access")
            idx_nodes = (
                list(node.slice.elts) if isinstance(node.slice, ast.Tuple) else [node.slice]
            )
            base.data_index = tuple(self.parse_expr(n) for n in idx_nodes)
            return base

        if not isinstance(node.value, ast.Name):
            # e.g. (field.at(K=...))[...]? -- unsupported
            raise GTScriptSyntaxError("Unsupported subscript base")

        name = node.value.id
        base_expr = self._name_to_expr(name)
        if not isinstance(base_expr, ir.FieldAccess):
            raise GTScriptSyntaxError(f"Cannot subscript non-field '{name}'")

        decl = self.ctx.field_decls.get(base_expr.name) or self.ctx.temp_decls.get(
            base_expr.name
        )

        idx_nodes = list(node.slice.elts) if isinstance(node.slice, ast.Tuple) else [node.slice]

        # GlobalTable-style access (no spatial axes): subscripts are data indices
        if decl is not None and decl.is_api and not any(decl.dimensions):
            base_expr.data_index = tuple(self.parse_expr(n) for n in idx_nodes)
            return base_expr

        offsets = self._parse_offsets(idx_nodes, decl)
        return self._compose_offset(base_expr, offsets)

    def _parse_offsets(
        self, idx_nodes: List[ast.expr], decl: Optional[ir.FieldDecl]
    ) -> Union[Tuple[int, int, int], Tuple[int, int, ir.Expr]]:
        """Parse offset tuple; returns (i, j, k) where k may be an Expr
        (variable-K offset).  Supports axis-name syntax ``field[I-1, J, K]``.
        """
        dims = decl.dimensions if decl is not None else (True, True, True)
        axes_present = [ax for ax, d in zip("IJK", dims) if d]

        # Axis-name syntax?
        def axis_of(n: ast.expr) -> Optional[str]:
            if isinstance(n, ast.Name) and n.id in ("I", "J", "K"):
                return n.id
            if isinstance(n, ast.BinOp) and isinstance(n.op, (ast.Add, ast.Sub)):
                return axis_of(n.left)
            return None

        def axis_shift(n: ast.expr) -> int:
            """Accumulate nested shifts: I + 1 - 2 -> -1."""
            if isinstance(n, ast.Name):
                return 0
            assert isinstance(n, ast.BinOp)
            shift = _const_int(n.right)
            if shift is None:
                raise GTScriptSyntaxError("Axis shift must be an integer literal")
            if isinstance(n.op, ast.Sub):
                shift = -shift
            return axis_shift(n.left) + shift

        result = {"I": 0, "J": 0, "K": 0}
        if any(axis_of(n) for n in idx_nodes):
            for n in idx_nodes:
                ax = axis_of(n)
                if ax is None:
                    raise GTScriptSyntaxError("Mixed axis/non-axis offset syntax")
                result[ax] = axis_shift(n)
            return (result["I"], result["J"], result["K"])

        if len(idx_nodes) != len(axes_present):
            raise GTScriptSyntaxError(
                f"Field access has {len(idx_nodes)} offsets, expected {len(axes_present)}"
            )
        k_expr: Optional[ir.Expr] = None
        for ax, n in zip(axes_present, idx_nodes):
            c = _const_int(n)
            if c is not None:
                result[ax] = c
            elif ax == "K":
                k_expr = self.parse_expr(n)
            else:
                raise GTScriptSyntaxError(
                    "Variable offsets are only allowed on the K axis"
                )
        if k_expr is not None:
            return (result["I"], result["J"], k_expr)
        return (result["I"], result["J"], result["K"])

    def _compose_offset(self, base: ir.FieldAccess, offsets) -> ir.FieldAccess:
        oi, oj, ok = offsets
        cur = base.offset
        if isinstance(ok, ir.Expr):
            if not isinstance(cur, ir.CartesianOffset) or cur.k != 0:
                raise GTScriptSyntaxError("Cannot compose variable-K offsets")
            if cur.i + oi or cur.j + oj:
                raise GTScriptSyntaxError(
                    "Variable-K offsets cannot be combined with horizontal offsets"
                )
            base.offset = ir.VariableKOffset(k=ok)
            return base
        if isinstance(cur, ir.CartesianOffset):
            base.offset = ir.CartesianOffset(i=cur.i + oi, j=cur.j + oj, k=cur.k + ok)
            return base
        raise GTScriptSyntaxError("Cannot compose offsets with non-Cartesian base")

    # ---- calls ---- #

    def _parse_call(self, node: ast.Call) -> Union[ir.Expr, List[ir.Expr]]:
        func = node.func

        # field.at(K=expr) absolute-K access
        if isinstance(func, ast.Attribute) and func.attr == "at":
            base = self.parse_expr(func.value)
            if not isinstance(base, ir.FieldAccess):
                raise GTScriptSyntaxError("'.at()' requires a field")
            k_expr = None
            for kw in node.keywords:
                if kw.arg == "K":
                    k_expr = self.parse_expr(kw.value)
            if k_expr is None:
                raise GTScriptSyntaxError("'.at()' requires K=<expr>")
            base.offset = ir.AbsoluteKIndex(k=k_expr)
            return base

        if isinstance(func, ast.Name):
            fname = func.id
            # casting calls
            if fname in _CAST_NAMES and fname not in self.ctx.externals:
                if len(node.args) != 1:
                    raise GTScriptSyntaxError(f"{fname}() takes one argument")
                return ir.Cast(dtype=_CAST_NAMES[fname], expr=self.parse_expr(node.args[0]))
            # math builtins
            if fname in _NATIVE_FUNCS and not self._is_gtscript_function(fname):
                args = [self.parse_expr(a) for a in node.args]
                nf = _NATIVE_FUNCS[fname]
                # fold variadic min/max
                if nf in (ir.NativeFunction.MIN, ir.NativeFunction.MAX) and len(args) > 2:
                    expr = args[0]
                    for a in args[1:]:
                        expr = ir.NativeFuncCall(func=nf, args=[expr, a])
                    return expr
                return ir.NativeFuncCall(func=nf, args=args)
            # gtscript.function inlining
            value = self._maybe_gtscript_function(fname)
            if value is not None:
                return self._inline_call(value, node)
            raise GTScriptSyntaxError(f"Unknown function '{fname}'")

        if isinstance(func, ast.Attribute):
            # e.g. module.attr(...) where attr is a gtscript function
            value = self._attribute_value(func)
            if isinstance(value, gtscript.GTScriptFunction):
                return self._inline_call(value, node)
            if isinstance(value, np.dtype) or (
                isinstance(value, type) and issubclass(value, np.generic)
            ):
                return ir.Cast(dtype=np.dtype(value), expr=self.parse_expr(node.args[0]))
            raise GTScriptSyntaxError("Unsupported call")
        raise GTScriptSyntaxError("Unsupported call expression")

    def _is_gtscript_function(self, name: str) -> bool:
        try:
            return isinstance(self._lookup_value(name), gtscript.GTScriptFunction)
        except KeyError:
            return False

    def _maybe_gtscript_function(self, name: str) -> Optional[gtscript.GTScriptFunction]:
        try:
            v = self._lookup_value(name)
        except KeyError:
            return None
        return v if isinstance(v, gtscript.GTScriptFunction) else None

    def _inline_call(
        self, gtfunc: gtscript.GTScriptFunction, node: ast.Call
    ) -> Union[ir.Expr, List[ir.Expr]]:
        """Inline a @gtscript.function call: bind formals to caller exprs
        (composing offsets), hoist body statements into the prelude, and
        return accesses to the hidden result temporaries."""
        fdef = _get_function_ast(gtfunc.definition)
        sig_params = list(inspect.signature(gtfunc.definition).parameters.values())

        # Parse actual args in caller scope
        pos_args = [self.parse_expr(a) for a in node.args]
        kw_args = {kw.arg: self.parse_expr(kw.value) for kw in node.keywords}

        bindings: Dict[str, Any] = {}
        for i, p in enumerate(sig_params):
            if i < len(pos_args):
                val = pos_args[i]
            elif p.name in kw_args:
                val = kw_args[p.name]
            elif p.default is not inspect.Parameter.empty:
                val = self._value_to_expr(p.default, p.name)
            else:
                raise GTScriptSyntaxError(
                    f"Missing argument '{p.name}' for function '{gtfunc.__name__}'"
                )
            if isinstance(val, ir.FieldAccess) or isinstance(
                val, (ir.ScalarAccess, ir.Literal)
            ):
                bindings[p.name] = val
            else:
                # Arbitrary expression: materialize as a hidden temporary
                hidden = self.ctx.gensym(f"{gtfunc.__name__}_{p.name}")
                self.ctx.declare_temp(hidden)
                self._prelude.append(
                    ir.Assign(target=ir.FieldAccess(name=hidden), value=val)
                )
                bindings[p.name] = ir.FieldAccess(name=hidden)

        inliner = IRMaker(
            self.ctx,
            bindings=bindings,
            rename={},
            local_externals=self.local_externals,
            func_globals=_function_namespace(gtfunc.definition),
            in_function=True,
        )
        body_stmts = inliner.parse_stmts(fdef.body)
        self._prelude.extend(body_stmts)
        if inliner.return_targets is None:
            raise GTScriptSyntaxError(
                f"gtscript.function '{gtfunc.__name__}' has no return statement"
            )
        results = [ir.FieldAccess(name=t) for t in inliner.return_targets]
        if len(results) == 1:
            return results[0]
        return results


def _get_function_ast(func) -> ast.FunctionDef:
    source = textwrap.dedent(inspect.getsource(func))
    tree = ast.parse(source)
    fdef = tree.body[0]
    assert isinstance(fdef, ast.FunctionDef)
    return fdef


def _function_namespace(func) -> Dict[str, Any]:
    """Globals + closure cells of a definition function."""
    ns = dict(func.__globals__)
    if func.__closure__:
        for name, cell in zip(func.__code__.co_freevars, func.__closure__):
            try:
                ns[name] = cell.cell_contents
            except ValueError:  # empty cell
                pass
    return ns


# --------------------------------------------------------------------------- #
# Definition-level parsing
# --------------------------------------------------------------------------- #

_ORDER_MAP = {"PARALLEL": ir.LoopOrder.PARALLEL, "FORWARD": ir.LoopOrder.FORWARD,
              "BACKWARD": ir.LoopOrder.BACKWARD}


def _parse_interval_call(call: ast.Call, maker: "IRMaker" = None):
    """Parse ``interval(a, b)`` / ``interval(...)``
    (reference: VerticalIntervalParser, gtscript_frontend.py:300-409;
    scalar-parameter bounds become RuntimeAxisBounds resolved at call time).

    Returns ``(interval, field_cond)``.  Field-valued (per-column) bounds
    -- an IJ int field as ``a``/``b`` -- have no reference counterpart;
    they desugar to the K hull plus a pointwise condition
    ``start <= K < end`` returned as ``field_cond`` (the caller wraps the
    section body in an If), so every backend, the extent analysis, and
    the race validators see them through the ordinary mask machinery.
    """
    args = call.args
    if len(args) == 1 and isinstance(args[0], ast.Constant) and args[0].value is Ellipsis:
        return ir.Interval.full(), None
    if len(args) == 1:
        v = _const_int(args[0])
        if v is None:
            v = _axis_index_bound(args[0], maker)
        if v is None:
            raise GTScriptSyntaxError("Invalid interval bound")
        start = ir.AxisBound.from_value(v, is_end=False)
        return ir.Interval(start, ir.AxisBound(start.level, start.offset + 1)), None
    if len(args) != 2:
        raise GTScriptSyntaxError("interval() takes 1 or 2 arguments")

    conds: List[ir.Expr] = []

    def bound(nd: ast.expr, is_end: bool):
        if isinstance(nd, ast.Constant) and nd.value is None:
            return ir.AxisBound.end() if is_end else ir.AxisBound.start()
        v = _const_int(nd)
        if v is None:
            # K[n] axis-index bounds (reference: gtscript.AxisIndex used
            # as an interval bound, test_gtscript_frontend.py:730-847) --
            # K[n] means START+n for n >= 0, END+n for n < 0, i.e. the
            # same resolution as a plain integer
            v = _axis_index_bound(nd, maker)
        if v is not None:
            return ir.AxisBound.from_value(v, is_end=is_end)
        # runtime bound: a scalar parameter (or scalar +/- literal)
        name, off = _runtime_bound_parts(nd)
        if name is not None and maker is not None and name in maker.ctx.scalar_decls:
            return ir.RuntimeAxisBound(name=name, offset=off)
        if name is not None and maker is not None and name in maker.ctx.field_decls:
            decl = maker.ctx.field_decls[name]
            if decl.dimensions[2] or decl.data_dims:
                raise GTScriptSyntaxError(
                    f"Field-valued interval bound '{name}' must be a "
                    "K-less (IJ) field without data dimensions"
                )
            if not np.issubdtype(decl.dtype, np.integer):
                raise GTScriptSyntaxError(
                    f"Field-valued interval bound '{name}' must have an "
                    f"integer dtype (got {decl.dtype})"
                )
            val: ir.Expr = ir.FieldAccess(name=name)
            if off:
                val = ir.BinaryOp(
                    op=ir.BinaryOperator.ADD, left=val, right=ir.Literal(value=off)
                )
            conds.append(
                ir.BinaryOp(
                    op=ir.BinaryOperator.LT if is_end else ir.BinaryOperator.GE,
                    left=ir.AxisPosition(axis="K"),
                    right=val,
                )
            )
            return ir.AxisBound.end() if is_end else ir.AxisBound.start()
        raise GTScriptSyntaxError(
            "Interval bounds must be integer literals, None, scalar "
            "parameters, or K-less integer fields"
        )

    interval = ir.Interval(bound(args[0], False), bound(args[1], True))
    cond = None
    for c in conds:
        cond = c if cond is None else ir.BinaryOp(
            op=ir.BinaryOperator.AND, left=cond, right=c
        )
    return interval, cond


def _axis_index_bound(nd: ast.expr, maker: "IRMaker" = None):
    """Recognize ``K[n]`` (or ``gtscript.K[n]``) interval bounds; also a
    bare name bound to a ``gtscript.AxisIndex`` value (via externals or the
    definition's namespace)."""
    from gt4py_tpu_torch.cartesian import gtscript as _gts

    if isinstance(nd, ast.Subscript):
        base = nd.value
        is_k = (isinstance(base, ast.Name) and base.id == "K") or (
            isinstance(base, ast.Attribute) and base.attr == "K"
        )
        if is_k:
            return _const_int(nd.slice)
    if isinstance(nd, ast.Name) and maker is not None:
        val = maker.ctx.externals.get(nd.id)
        if val is None:
            val = maker.ctx.definition_globals.get(nd.id)
        if isinstance(val, _gts.AxisIndex) and val.axis == "K":
            return val.index + val.offset
    return None


def _runtime_bound_parts(nd: ast.expr):
    """Decompose `name` / `name + c` / `name - c` interval bounds."""
    if isinstance(nd, ast.Name):
        return nd.id, 0
    if isinstance(nd, ast.BinOp) and isinstance(nd.op, (ast.Add, ast.Sub)):
        c = _const_int(nd.right)
        if c is not None and isinstance(nd.left, ast.Name):
            return nd.left.id, c if isinstance(nd.op, ast.Add) else -c
    return None, 0


def _parse_computation_order(call: ast.Call, maker: IRMaker) -> ir.LoopOrder:
    if len(call.args) != 1 or not isinstance(call.args[0], ast.Name):
        raise GTScriptSyntaxError("computation() takes PARALLEL, FORWARD or BACKWARD")
    name = call.args[0].id
    if name not in _ORDER_MAP:
        raise GTScriptSyntaxError(f"Unknown iteration order '{name}'")
    return _ORDER_MAP[name]


def parse_definition(
    definition,
    *,
    externals: Optional[Dict[str, Any]] = None,
    dtypes: Optional[Dict[Any, Any]] = None,
    name: Optional[str] = None,
    literal_precision: Optional[int] = None,
) -> ir.Stencil:
    """Parse a GTScript definition function into a validated ``ir.Stencil``."""
    externals = dict(externals or {})
    dtypes = dict(dtypes or {})
    name = name or definition.__name__

    fdef = _get_function_ast(definition)
    sig = inspect.signature(definition)

    ctx = StencilContext(
        name=name,
        externals=externals,
        dtypes_map=dtypes,
        definition_globals=_function_namespace(definition),
    )

    api_params: List[ir.ApiParam] = []
    for p in sig.parameters.values():
        annotation = p.annotation
        if isinstance(annotation, str):
            # string annotations (``from __future__ import annotations``):
            # evaluate in the definition's globals + closure namespace
            annotation = eval(annotation, ctx.definition_globals)  # noqa: S307
        if annotation is inspect.Parameter.empty:
            raise GTScriptDefinitionError(
                f"Missing annotation for parameter '{p.name}' of stencil '{name}'"
            )
        is_kw = p.kind == inspect.Parameter.KEYWORD_ONLY
        optional = p.default is None
        if isinstance(annotation, gtscript._FieldDescriptor):
            axes = annotation.axes_names
            dims = tuple(ax in axes for ax in "IJK")
            ctx.field_decls[p.name] = ir.FieldDecl(
                name=p.name,
                dtype=resolve_dtype(annotation.dtype, dtypes),
                dimensions=dims,
                data_dims=annotation.data_dims,
                is_api=True,
            )
            api_params.append(
                ir.ApiParam(name=p.name, is_field=True, is_keyword=is_kw, optional=optional)
            )
        else:
            ctx.scalar_decls[p.name] = ir.ScalarDecl(
                name=p.name, dtype=resolve_dtype(annotation, dtypes)
            )
            api_params.append(
                ir.ApiParam(name=p.name, is_field=False, is_keyword=is_kw, optional=optional)
            )

    maker = IRMaker(ctx)
    vertical_loops: List[ir.VerticalLoop] = []

    try:
        for stmt in fdef.body:
            if isinstance(stmt, ast.ImportFrom):
                maker._parse_import(stmt)
                continue
            if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Constant):
                continue  # docstring
            if isinstance(stmt, ast.With):
                vertical_loops.extend(_parse_computation_with(stmt, maker))
                continue
            if isinstance(stmt, ast.Assert):
                if not maker._compile_time_eval(stmt.test):
                    raise GTScriptDefinitionError(f"assert failed at line {stmt.lineno}")
                continue
            raise GTScriptSyntaxError(
                f"Only 'with computation(...)' blocks allowed at stencil top level "
                f"(got {type(stmt).__name__} at line {stmt.lineno})"
            )
    except GTScriptSyntaxError as e:
        from gt4py_tpu_torch.errors import format_with_source

        lineno = getattr(e, "stencil_lineno", None)
        enriched = GTScriptSyntaxError(
            format_with_source(str(e.msg or e), definition, lineno)
        )
        raise enriched from None

    stencil = ir.Stencil(
        name=name,
        api_params=api_params,
        field_decls=ctx.field_decls,
        scalar_decls=ctx.scalar_decls,
        temp_decls=ctx.temp_decls,
        vertical_loops=vertical_loops,
        externals=dict(ctx.used_externals),
        sources=_safe_source(definition),
        literal_float_dtype=(
            np.dtype(f"f{literal_precision // 8}") if literal_precision else None
        ),
        literal_int_dtype=(
            np.dtype(f"i{literal_precision // 8}") if literal_precision else None
        ),
    )
    return stencil


def _safe_source(definition) -> str:
    try:
        return textwrap.dedent(inspect.getsource(definition))
    except (OSError, TypeError):
        return ""


def _parse_computation_with(node: ast.With, maker: IRMaker) -> List[ir.VerticalLoop]:
    items = {}
    horizontal_call = None
    for item in node.items:
        fname, call = _with_item_call(item)
        if fname is None:
            raise GTScriptSyntaxError("Invalid 'with' item in stencil body")
        if fname == "computation":
            items["computation"] = call
        elif fname == "interval":
            items["interval"] = call
        elif fname == "horizontal":
            horizontal_call = call
        else:
            raise GTScriptSyntaxError(f"Unexpected 'with {fname}(...)'")

    if "computation" not in items:
        raise GTScriptSyntaxError("Expected 'with computation(...)'")

    order = _parse_computation_order(items["computation"], maker)
    sections: List[ir.VerticalSection] = []

    def parse_body(body) -> List[ir.Stmt]:
        stmts = maker.parse_stmts(body)
        if horizontal_call is not None:
            masks = [maker._parse_region(a) for a in horizontal_call.args]
            return [ir.HorizontalRestriction(masks=masks, body=stmts)]
        return stmts

    def make_section(interval, field_cond, body) -> ir.VerticalSection:
        if field_cond is not None:
            body = [ir.If(cond=field_cond, body=body, orelse=[])]
        return ir.VerticalSection(interval=interval, body=body)

    if "interval" in items:
        interval, field_cond = _parse_interval_call(items["interval"], maker)
        sections.append(make_section(interval, field_cond, parse_body(node.body)))
    else:
        for inner in node.body:
            if not isinstance(inner, ast.With):
                raise GTScriptSyntaxError(
                    "computation() without interval() must contain only "
                    "'with interval(...)' blocks"
                )
            inner_items = [_with_item_call(i) for i in inner.items]
            if len(inner_items) != 1 or inner_items[0][0] != "interval":
                raise GTScriptSyntaxError("Expected 'with interval(...)'")
            interval, field_cond = _parse_interval_call(inner_items[0][1], maker)
            sections.append(
                make_section(interval, field_cond, parse_body(inner.body))
            )

    return [ir.VerticalLoop(loop_order=order, sections=sections)]
