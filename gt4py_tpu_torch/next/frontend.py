"""The `next` frontend: restricted-Python parser + type deduction.

Reference analogs:
  - src/gt4py/next/ffront/func_to_foast.py:120 (``FieldOperatorParser``):
    parse the decorated function's source into a validated AST, rejecting
    everything outside the DSL subset with source-located errors.
  - src/gt4py/next/ffront/foast_passes/type_deduction.py: bottom-up type
    inference over the AST (promotion rules, builtin signatures, operator
    calls), erroring with locations.
  - src/gt4py/next/ffront/func_to_past.py / past_passes: the same for
    ``@program`` definitions (operator calls with ``out=``/``domain=``).

TPU-first compaction: one parser + one typed IR (fvir.py) serve field
operators, scan operators and programs; the typed IR is *interpreted*
over jax Fields (interpreter.py) -- tracing under ``jax.jit`` replaces
the FOAST->PAST->ITIR->codegen pipeline.

Deferred typing: parameters without complete annotations (bare ``Field``)
get DeferredType and are resolved against the concrete arguments at each
new call signature -- the same places then raise the same located errors.
"""

from __future__ import annotations

import ast
import builtins as py_builtins
import copy
import inspect
import linecache
import textwrap
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from gt4py_tpu_torch.errors import GT4PyTpuError

from . import fvir, type_system as ts
from .builtins import FIELD_BUILTINS
from .common import (
    Connectivity,
    Dimension,
    DimensionKind,
    Domain,
    Field,
    FieldOffset,
    OffsetIndex,
    promote_dims,
)


class FieldViewError(GT4PyTpuError):
    """A syntax or type error in field-view DSL code, with source location."""

    def __init__(self, message: str, loc: Optional[fvir.Location] = None):
        self.raw_message = message
        self.loc = loc
        super().__init__(_format(message, loc))


def _format(message: str, loc: Optional[fvir.Location]) -> str:
    if loc is None:
        return message
    src = linecache.getline(loc.filename, loc.line)
    caret = ""
    if src:
        caret = f"\n    {src.rstrip()}\n    " + " " * loc.col + "^"
    return f"{message}\n  at {loc}{caret}"


def _err(message: str, loc) -> FieldViewError:
    if isinstance(loc, fvir.Node):
        loc = loc.loc
    return FieldViewError(message, loc)


# --------------------------------------------------------------------- #
# parsing
# --------------------------------------------------------------------- #

_BINOPS = {
    ast.Add: "add", ast.Sub: "sub", ast.Mult: "mult", ast.Div: "div",
    ast.FloorDiv: "floordiv", ast.Mod: "mod", ast.Pow: "pow",
}
_CMPOPS = {
    ast.Lt: "lt", ast.LtE: "le", ast.Gt: "gt", ast.GtE: "ge",
    ast.Eq: "eq", ast.NotEq: "ne",
}
_UNARYOPS = {ast.USub: "neg", ast.UAdd: "pos", ast.Not: "not", ast.Invert: "not"}

_DISALLOWED_STMTS = {
    ast.For: "for loops", ast.While: "while loops", ast.With: "with blocks",
    ast.Try: "try/except", ast.Import: "imports", ast.ImportFrom: "imports",
    ast.FunctionDef: "nested function definitions", ast.ClassDef: "classes",
    ast.Delete: "del", ast.Global: "global", ast.Nonlocal: "nonlocal",
    ast.Raise: "raise", ast.Assert: "assert", ast.Lambda: "lambdas",
}


class _Parser(ast.NodeVisitor):
    """Python AST -> FVIR for one operator/program definition."""

    def __init__(self, fn: Callable, kind: str, localns: Optional[Dict[str, Any]] = None):
        self.fn = fn
        self.kind = kind
        #: the locals of the frame that applied the decorator
        self.localns = dict(localns or {})
        try:
            raw = inspect.getsource(fn)
            _, self.line0 = inspect.getsourcelines(fn)
        except (OSError, TypeError) as e:
            raise FieldViewError(
                f"cannot get source of '{getattr(fn, '__name__', fn)}': {e}"
            )
        self.filename = inspect.getsourcefile(fn) or "<unknown>"
        self.src = textwrap.dedent(raw)
        self.locals: set = set()
        # closure environment: globals + closure cells + field builtins
        env: Dict[str, Any] = dict(fn.__globals__)
        if fn.__closure__:
            for name, cell in zip(fn.__code__.co_freevars, fn.__closure__):
                try:
                    env[name] = cell.cell_contents
                except ValueError:
                    pass
        self.env = env
        self.used_closure: Dict[str, Any] = {}

    def _annotations(self, fdef: ast.FunctionDef) -> Dict[str, Any]:
        """The definition's annotations, each evaluated on its own: a string
        (``from __future__ import annotations``) against the function's
        globals, its closure cells and the locals of the frame that applied
        the decorator.  One that does not resolve raises, naming it."""
        out = {}
        for name, hint in getattr(self.fn, "__annotations__", {}).items():
            if isinstance(hint, str):
                try:
                    hint = eval(hint, {**self.env, **self.localns})  # noqa: S307
                except Exception as e:
                    raise _err(f"cannot resolve the annotation {hint!r} of '{name}': "
                               f"{type(e).__name__}: {e}", self.loc(fdef))
            out[name] = hint
        return out

    def loc(self, node: ast.AST) -> fvir.Location:
        return fvir.Location(
            self.filename,
            self.line0 + getattr(node, "lineno", 1) - 1,
            getattr(node, "col_offset", 0),
        )

    # -- entry -- #

    def parse(self) -> fvir.OperatorIR:
        tree = ast.parse(self.src)
        fdef = tree.body[0]
        if not isinstance(fdef, ast.FunctionDef):
            raise FieldViewError("expected a function definition")
        a = fdef.args
        if a.vararg or a.kwarg or a.kwonlyargs or a.posonlyargs or a.defaults:
            raise _err(
                "field-view definitions take plain positional parameters "
                "(no *args/**kwargs/keyword-only/defaults)",
                self.loc(fdef),
            )
        params = []
        hints = self._annotations(fdef)
        for arg in a.args:
            hint = hints.get(arg.arg)
            try:
                ptype = ts.from_annotation(hint)
            except TypeError as e:
                raise _err(str(e), self.loc(arg))
            params.append(fvir.Param(self.loc(arg), name=arg.arg, type=ptype))
            self.locals.add(arg.arg)
        declared_return = None
        if "return" in hints:
            try:
                declared_return = ts.from_annotation(hints["return"])
            except TypeError:
                declared_return = None

        body = self._parse_body(fdef.body)
        if self.kind in ("field_operator", "scan_operator"):
            self._check_returns(body, self.loc(fdef))
        else:
            for st in body:
                if isinstance(st, fvir.Return):
                    raise _err("programs do not return values", st)
        return fvir.OperatorIR(
            self.loc(fdef),
            name=fdef.name,
            kind=self.kind,
            params=params,
            body=body,
            declared_return=declared_return,
            closure=self.used_closure,
        )

    def _check_returns(self, body: List[fvir.Stmt], loc) -> None:
        """Every control path must end in a Return (definitive-return)."""

        def terminates(stmts: List[fvir.Stmt]) -> bool:
            if not stmts:
                return False
            last = stmts[-1]
            if isinstance(last, fvir.Return):
                return True
            if isinstance(last, fvir.IfStmt):
                return terminates(last.body) and terminates(last.orelse)
            return False

        if not terminates(body):
            raise _err(
                "missing 'return': every path through a field operator "
                "must return a value",
                loc,
            )

    # -- statements -- #

    def _parse_body(self, stmts) -> List[fvir.Stmt]:
        out = []
        for st in stmts:
            out.append(self._parse_stmt(st))
        return out

    def _parse_stmt(self, node: ast.stmt) -> fvir.Stmt:
        for bad, label in _DISALLOWED_STMTS.items():
            if isinstance(node, bad):
                raise _err(f"{label} are not allowed in field-view code", self.loc(node))
        if isinstance(node, ast.Return):
            if node.value is None:
                raise _err("'return' needs a value", self.loc(node))
            return fvir.Return(self.loc(node), value=self._expr(node.value))
        if isinstance(node, ast.Assign):
            if len(node.targets) != 1:
                raise _err("chained assignment is not allowed", self.loc(node))
            t = node.targets[0]
            if isinstance(t, ast.Name):
                targets, unpack = (t.id,), False
            elif isinstance(t, ast.Tuple) and all(
                isinstance(e, ast.Name) for e in t.elts
            ):
                targets, unpack = tuple(e.id for e in t.elts), True
            else:
                raise _err(
                    "assignment targets must be names (or a tuple of names)",
                    self.loc(node),
                )
            for name in targets:
                self.locals.add(name)
            return fvir.Assign(
                self.loc(node), targets=targets, value=self._expr(node.value),
                unpack=unpack,
            )
        if isinstance(node, ast.AnnAssign):
            if not isinstance(node.target, ast.Name) or node.value is None:
                raise _err("invalid annotated assignment", self.loc(node))
            self.locals.add(node.target.id)
            return fvir.Assign(
                self.loc(node), targets=(node.target.id,),
                value=self._expr(node.value), unpack=False,
            )
        if isinstance(node, ast.AugAssign):
            if not isinstance(node.target, ast.Name):
                raise _err("augmented assignment target must be a name", self.loc(node))
            if type(node.op) not in _BINOPS:
                raise _err("unsupported augmented assignment operator", self.loc(node))
            if node.target.id not in self.locals:
                raise _err(
                    f"'{node.target.id}' used before assignment", self.loc(node)
                )
            value = fvir.BinOp(
                self.loc(node), op=_BINOPS[type(node.op)],
                left=fvir.Name(self.loc(node), id=node.target.id),
                right=self._expr(node.value),
            )
            return fvir.Assign(
                self.loc(node), targets=(node.target.id,), value=value, unpack=False
            )
        if isinstance(node, ast.If):
            return fvir.IfStmt(
                self.loc(node),
                cond=self._expr(node.test),
                body=self._parse_body(node.body),
                orelse=self._parse_body(node.orelse),
            )
        if isinstance(node, ast.Expr):
            if self.kind == "program":
                call = self._expr(node.value)
                if not isinstance(call, fvir.Call):
                    raise _err(
                        "program bodies are sequences of operator calls",
                        self.loc(node),
                    )
                return fvir.Assign(self.loc(node), targets=(), value=call)
            if isinstance(node.value, ast.Constant) and isinstance(
                node.value.value, str
            ):
                return fvir.Assign(  # docstring: no-op
                    self.loc(node), targets=(),
                    value=fvir.Literal(self.loc(node), value=None),
                )
            raise _err(
                "expression statements have no effect in a field operator",
                self.loc(node),
            )
        raise _err(
            f"unsupported statement '{type(node).__name__}' in field-view code",
            self.loc(node),
        )

    # -- expressions -- #

    def _expr(self, node: ast.expr) -> fvir.Expr:
        loc = self.loc(node)
        if isinstance(node, ast.Name):
            if isinstance(node.ctx, ast.Store):
                raise _err("internal: store context in expression", loc)
            if node.id not in self.locals and node.id not in self.used_closure:
                self._resolve(node.id, loc)
            return fvir.Name(loc, id=node.id)
        if isinstance(node, ast.Constant):
            if node.value is None or isinstance(node.value, (bool, int, float)):
                return fvir.Literal(loc, value=node.value)
            raise _err(
                f"unsupported literal {node.value!r} (allowed: bool/int/float)", loc
            )
        if isinstance(node, ast.BinOp):
            if type(node.op) not in _BINOPS:
                raise _err(
                    f"unsupported operator '{type(node.op).__name__}'", loc
                )
            return fvir.BinOp(
                loc, op=_BINOPS[type(node.op)],
                left=self._expr(node.left), right=self._expr(node.right),
            )
        if isinstance(node, ast.UnaryOp):
            if type(node.op) not in _UNARYOPS:
                raise _err("unsupported unary operator", loc)
            return fvir.UnaryOp(
                loc, op=_UNARYOPS[type(node.op)], operand=self._expr(node.operand)
            )
        if isinstance(node, ast.Compare):
            if len(node.ops) != 1:
                raise _err("chained comparisons are not allowed", loc)
            if type(node.ops[0]) not in _CMPOPS:
                raise _err("unsupported comparison operator", loc)
            return fvir.Compare(
                loc, op=_CMPOPS[type(node.ops[0])],
                left=self._expr(node.left), right=self._expr(node.comparators[0]),
            )
        if isinstance(node, ast.BoolOp):
            return fvir.BoolOp(
                loc, op="and" if isinstance(node.op, ast.And) else "or",
                values=[self._expr(v) for v in node.values],
            )
        if isinstance(node, ast.Call):
            kwargs = {}
            for kw in node.keywords:
                if kw.arg is None:
                    raise _err("**kwargs expansion is not allowed", loc)
                kwargs[kw.arg] = self._expr(kw.value)
            return fvir.Call(
                loc, func=self._expr(node.func),
                args=[self._expr(a) for a in node.args], kwargs=kwargs,
            )
        if isinstance(node, ast.Subscript):
            idx = node.slice
            if isinstance(idx, ast.UnaryOp) and isinstance(idx.op, ast.USub) and (
                isinstance(idx.operand, ast.Constant)
            ):
                index = -idx.operand.value
            elif isinstance(idx, ast.Constant) and isinstance(idx.value, int):
                index = idx.value
            elif isinstance(idx, ast.Slice) or (
                isinstance(idx, ast.Tuple)
                and idx.elts
                and all(isinstance(e, ast.Slice) for e in idx.elts)
            ):
                # out[1:-1] / out[1:-1, :]: relative restriction of a
                # program out= target (reference: past slicing,
                # past_to_itir.py:188-208); operators stay domain-based
                if self.kind != "program":
                    raise _err(
                        "field slicing is only allowed on out= targets in "
                        "programs; restrict with domains inside operators",
                        loc,
                    )
                elts = idx.elts if isinstance(idx, ast.Tuple) else [idx]

                def bound(b):
                    if b is None:
                        return None
                    if isinstance(b, ast.Constant) and isinstance(b.value, int):
                        return b.value
                    if (
                        isinstance(b, ast.UnaryOp)
                        and isinstance(b.op, ast.USub)
                        and isinstance(b.operand, ast.Constant)
                        and isinstance(b.operand.value, int)
                    ):
                        return -b.operand.value
                    raise _err(
                        "slice bounds must be integer literals", loc
                    )

                slices = []
                for e in elts:
                    if e.step is not None:
                        raise _err("slices must have step 1", loc)
                    slices.append((bound(e.lower), bound(e.upper)))
                return fvir.FieldSlice(
                    loc, value=self._expr(node.value), slices=tuple(slices)
                )
            else:
                raise _err(
                    "subscripts must be integer literals (e.g. Ioff[1], t[0])"
                    + (" or slices on out= targets" if self.kind == "program" else ""),
                    loc,
                )
            return fvir.Subscript(loc, value=self._expr(node.value), index=index)
        if isinstance(node, ast.Tuple):
            return fvir.TupleExpr(loc, elts=[self._expr(e) for e in node.elts])
        if isinstance(node, ast.Dict):
            if any(k is None for k in node.keys):
                raise _err("** expansion is not allowed in dict literals", loc)
            return fvir.DictExpr(
                loc,
                keys=[self._expr(k) for k in node.keys],
                values=[self._expr(v) for v in node.values],
            )
        if isinstance(node, ast.IfExp):
            return fvir.Ternary(
                loc, cond=self._expr(node.test),
                true_expr=self._expr(node.body), false_expr=self._expr(node.orelse),
            )
        if isinstance(node, ast.Attribute):
            # constant-inline statically resolvable chains (gtx.astype,
            # np.float32, module-level constants) -- the cartesian
            # ValueInliner analog; anything else is outside the DSL
            chain = []
            cur = node
            while isinstance(cur, ast.Attribute):
                chain.append(cur.attr)
                cur = cur.value
            if isinstance(cur, ast.Name) and cur.id in self.env:
                value = self.env[cur.id]
                ok = True
                for attr in reversed(chain):
                    try:
                        value = getattr(value, attr)
                    except AttributeError:
                        ok = False
                        break
                if ok:
                    mangled = cur.id + "." + ".".join(reversed(chain))
                    self.used_closure[mangled] = value
                    return fvir.Name(loc, id=mangled)
            # member access on a local value (named-collection parameters /
            # temporaries); type deduction validates the member name
            return fvir.AttrGet(
                loc, value=self._expr(node.value), attr=node.attr
            )
        raise _err(
            f"unsupported expression '{type(node).__name__}' in field-view code", loc
        )

    def _resolve(self, name: str, loc) -> None:
        if name in self.used_closure:
            return
        if name in self.env:
            self.used_closure[name] = self.env[name]
            return
        if name in FIELD_BUILTINS:
            self.used_closure[name] = FIELD_BUILTINS[name]
            return
        if hasattr(py_builtins, name):
            allowed = {"abs": FIELD_BUILTINS["abs"], "min": FIELD_BUILTINS["minimum"],
                       "max": FIELD_BUILTINS["maximum"],
                       "bool": bool, "int": int, "float": float}
            if name in allowed:
                self.used_closure[name] = allowed[name]
                return
            raise _err(
                f"python builtin '{name}' is not part of the field-view DSL", loc
            )
        raise _err(f"undefined symbol '{name}'", loc)


def parse_definition(fn: Callable, kind: str = "field_operator",
                     localns: Optional[Dict[str, Any]] = None) -> fvir.OperatorIR:
    """``localns``: the locals of the frame that applied the decorator,
    where string annotations may name a local of an enclosing function."""
    return _Parser(fn, kind, localns).parse()


# --------------------------------------------------------------------- #
# type deduction
# --------------------------------------------------------------------- #


def _weak(dtype) -> ts.ScalarType:
    return ts.ScalarType(np.dtype(dtype), weak=True)


def external_type(value, loc=None) -> ts.TypeSpec:
    """Type of a closure symbol."""
    from . import ffront

    if isinstance(value, ffront.FieldOperator):
        return ts.OperatorType(op=value)
    if isinstance(value, ffront.ScanOperator):
        return ts.OperatorType(op=value)
    if (isinstance(value, type) or value is ts.bfloat16) and value in ts._SCALAR_ALIASES:
        return ts.CastType(ts._SCALAR_ALIASES[value])
    if isinstance(value, type) and ts.collection_fields(value) is not None:
        # NamedTuple / dataclass class used as an in-operator constructor
        tt = ts.from_annotation(value)
        return ts.CollectionCtorType(tuple_type=tt)
    if callable(value) and value in _BUILTIN_RULES:
        return ts.BuiltinType(fn=value)
    try:
        t = ts.from_value(value)
        if isinstance(t, ts.ScalarType):
            return ts.ScalarType(t.kind, weak=True)  # closures act like literals
        return t
    except TypeError:
        raise _err(
            f"closure symbol of kind '{type(value).__name__}' cannot be used "
            "in field-view code", loc
        )


def _result_scalar_kind(op: str, kinds: List[np.dtype], node) -> np.dtype:
    """Shared-dtype rule with weak-literal adaptation (NO implicit
    promotion between concrete dtypes -- reference type_info.promote)."""
    concrete = [k for k, weak in kinds if not weak]
    weaks = [k for k, weak in kinds if weak]
    if concrete:
        base = concrete[0]
        for k in concrete[1:]:
            if k != base:
                raise _err(
                    f"could not promote '{base}' and '{k}' to a common type "
                    "(no implicit conversion; use astype)", node
                )
        for w in weaks:
            if w.kind == "f" and base.kind in "iub":
                raise _err(
                    f"float literal incompatible with '{base}' operand "
                    "(use astype)", node
                )
        result = base
    else:
        result = np.result_type(*[k for k, _ in kinds])
    if op == "div" and result.kind in "iub":  # true division of ints -> f64
        result = np.dtype(np.float64)
    return np.dtype(result)


class TypeDeduction:
    """Bottom-up type annotation of an OperatorIR (reference:
    foast_passes/type_deduction.py).  Mutates ``node.type`` in place; run
    on a fresh copy per call signature (see ``deduce``)."""

    def __init__(self, ir: fvir.OperatorIR):
        self.ir = ir
        self.symbols: Dict[str, ts.TypeSpec] = {}

    def run(self, param_types: Optional[Sequence[ts.TypeSpec]] = None) -> ts.TypeSpec:
        if param_types is not None:
            if len(param_types) != len(self.ir.params):
                raise _err(
                    f"'{self.ir.name}' takes {len(self.ir.params)} arguments, "
                    f"got {len(param_types)}", self.ir
                )
            for p, t in zip(self.ir.params, param_types):
                if not ts.is_deferred(p.type) and not ts.accepts(p.type, _strip_weak(t)):
                    raise _err(
                        f"argument '{p.name}' expects {p.type}, got {t}", p
                    )
                p.type = t if ts.is_deferred(p.type) else p.type
        for p in self.ir.params:
            self.symbols[p.name] = p.type
        for name, value in self.ir.closure.items():
            self.symbols[name] = external_type(value, self.ir.loc)
        ret = self._body(self.ir.body)
        if (
            ret is not None
            and self.ir.declared_return is not None
            and not ts.is_deferred(ret)
            and not ts.is_deferred(self.ir.declared_return)
            and not ts.accepts(self.ir.declared_return, _strip_weak(ret))
        ):
            raise _err(
                f"'{self.ir.name}' declares return type "
                f"{self.ir.declared_return} but returns {ret}", self.ir
            )
        return ret

    # -- statements -- #

    def _body(self, body: List[fvir.Stmt]) -> Optional[ts.TypeSpec]:
        ret: Optional[ts.TypeSpec] = None
        for st in body:
            if isinstance(st, fvir.Return):
                ret = self.expr(st.value)
            elif isinstance(st, fvir.IfStmt):
                ct = self.expr(st.cond)
                if not _is_scalar_bool(ct):
                    raise _err(
                        f"'if' condition must be a scalar bool, got {ct} "
                        "(use where()/concat_where() for field conditions)",
                        st.cond,
                    )
                before = dict(self.symbols)
                r1 = self._body(st.body)
                after_true = self.symbols
                self.symbols = dict(before)
                r2 = self._body(st.orelse)
                # merge: symbols defined in both branches with equal types
                merged = dict(before)
                for k in set(after_true) | set(self.symbols):
                    t1, t2 = after_true.get(k), self.symbols.get(k)
                    if t1 is not None and t2 is not None:
                        merged[k] = t1 if t1 == t2 else ts.DeferredType()
                    elif k in before:
                        merged[k] = before[k]
                self.symbols = merged
                if r1 is not None and r2 is not None:
                    ret = r1
            elif isinstance(st, fvir.Assign):
                if not st.targets:  # program call statement / docstring
                    self.expr(st.value)
                    continue
                vt = self.expr(st.value)
                if st.unpack:
                    if not isinstance(vt, ts.TupleType) and not ts.is_deferred(vt):
                        raise _err(
                            f"cannot unpack non-tuple value of type {vt}", st
                        )
                    if isinstance(vt, ts.TupleType):
                        if len(vt) != len(st.targets):
                            raise _err(
                                f"cannot unpack {len(vt)} values into "
                                f"{len(st.targets)} targets", st
                            )
                        for name, t in zip(st.targets, vt.types):
                            self.symbols[name] = t
                    else:
                        for name in st.targets:
                            self.symbols[name] = ts.DeferredType()
                else:
                    self.symbols[st.targets[0]] = vt
        return ret

    # -- expressions -- #

    def expr(self, node: fvir.Expr) -> ts.TypeSpec:
        t = self._expr(node)
        node.type = t
        return t

    def _expr(self, node: fvir.Expr) -> ts.TypeSpec:
        if isinstance(node, fvir.Name):
            if node.id not in self.symbols:
                raise _err(f"undefined symbol '{node.id}'", node)
            return self.symbols[node.id]
        if isinstance(node, fvir.Literal):
            if node.value is None:
                return ts.DeferredType()
            if isinstance(node.value, bool):
                return ts.ScalarType(np.dtype(bool))
            if isinstance(node.value, int):
                return _weak(np.int64)
            return _weak(np.float64)
        if isinstance(node, fvir.TupleExpr):
            return ts.TupleType(tuple(self.expr(e) for e in node.elts))
        if isinstance(node, fvir.DictExpr):
            dims = []
            for k, v in zip(node.keys, node.values):
                kt, vt = self.expr(k), self.expr(v)
                if ts.is_deferred(kt) or ts.is_deferred(vt):
                    return ts.DeferredType()
                if not isinstance(kt, ts.DimensionType):
                    raise _err(
                        f"domain dict keys must be dimensions, got {kt}", k
                    )
                if not (
                    isinstance(vt, ts.TupleType)
                    and len(vt) == 2
                    and all(
                        isinstance(t, ts.ScalarType)
                        and np.dtype(t.kind).kind in "iu"
                        for t in vt.types
                    )
                ):
                    raise _err(
                        "domain dict values must be (start, stop) integer "
                        f"pairs, got {vt}", v
                    )
                dims.append(kt.dim)
            return ts.DomainType(tuple(dims))
        if isinstance(node, fvir.UnaryOp):
            t = self.expr(node.operand)
            if ts.is_deferred(t):
                return t
            if node.op == "not":
                if not ts.is_logical(t):
                    raise _err(f"'not' needs a bool operand, got {t}", node)
                return t
            if not ts.is_arithmetic(t):
                raise _err(f"unary '{node.op}' needs arithmetic operand, got {t}", node)
            return t
        if isinstance(node, fvir.BinOp):
            lt, rt = self.expr(node.left), self.expr(node.right)
            return self._binop_type(node, lt, rt)
        if isinstance(node, fvir.Compare):
            lt, rt = self.expr(node.left), self.expr(node.right)
            # Dimension-vs-int comparisons build Domains (K < 5)
            if isinstance(lt, ts.DimensionType):
                if not (isinstance(rt, ts.ScalarType) and np.dtype(rt.kind).kind in "iu"):
                    raise _err(
                        "dimension comparisons need an integer bound", node
                    )
                return ts.DomainType((lt.dim,))
            if ts.is_deferred(lt) or ts.is_deferred(rt):
                return ts.DeferredType()
            for t in (lt, rt):
                if not (ts.is_arithmetic(t) or ts.is_logical(t)):
                    raise _err(f"cannot compare values of type {t}", node)
            merged = self._binop_type(node, lt, rt, compare=True)
            if isinstance(merged, ts.FieldType):
                return ts.FieldType(merged.dims, ts.ScalarType(np.dtype(bool)))
            return ts.ScalarType(np.dtype(bool))
        if isinstance(node, fvir.BoolOp):
            types = [self.expr(v) for v in node.values]
            if any(ts.is_deferred(t) for t in types):
                return ts.DeferredType()
            for t, v in zip(types, node.values):
                if not ts.is_logical(t):
                    raise _err(
                        f"'{node.op}' needs bool operands, got {t} "
                        "(comparisons produce bool fields)", v
                    )
            dims = promote_dims(*(ts.extract_dims(t) for t in types))
            if dims:
                return ts.FieldType(dims, ts.ScalarType(np.dtype(bool)))
            return ts.ScalarType(np.dtype(bool))
        if isinstance(node, fvir.Ternary):
            ct = self.expr(node.cond)
            tt, ft = self.expr(node.true_expr), self.expr(node.false_expr)
            if not _is_scalar_bool(ct):
                raise _err(
                    f"ternary condition must be a scalar bool, got {ct} "
                    "(use where() for field conditions)", node.cond
                )
            if ts.is_deferred(tt) or ts.is_deferred(ft):
                return ts.DeferredType()
            return self._binop_type(node, tt, ft, compare=True)
        if isinstance(node, fvir.AttrGet):
            vt = self.expr(node.value)
            if ts.is_deferred(vt):
                return ts.DeferredType()
            if isinstance(vt, ts.TupleType) and vt.names:
                if node.attr not in vt.names:
                    raise _err(
                        f"'{node.attr}' is not a member of {vt} "
                        f"(members: {', '.join(vt.names)})", node
                    )
                node.index = vt.names.index(node.attr)
                return vt.types[node.index]
            raise _err(
                f"cannot access attribute '{node.attr}' on a value of type "
                f"{vt} (only NamedTuple/dataclass collections have members)",
                node,
            )
        if isinstance(node, fvir.Subscript):
            vt = self.expr(node.value)
            if isinstance(vt, ts.OffsetType):
                return ts.OffsetIndexType(vt.source, vt.target)
            if isinstance(vt, ts.TupleType):
                if not (-len(vt) <= node.index < len(vt)):
                    raise _err(
                        f"tuple index {node.index} out of range "
                        f"(length {len(vt)})", node
                    )
                return vt.types[node.index]
            if ts.is_deferred(vt):
                return ts.DeferredType()
            raise _err(f"cannot subscript a value of type {vt}", node)
        if isinstance(node, fvir.FieldSlice):
            vt = self.expr(node.value)
            if ts.is_deferred(vt):
                return ts.DeferredType()
            if not isinstance(vt, ts.FieldType):
                raise _err(f"cannot slice a value of type {vt}", node)
            if len(node.slices) > len(vt.dims):
                raise _err(
                    f"too many slices for field '{getattr(node.value, 'id', '?')}': "
                    f"field is {len(vt.dims)}-dimensional, but "
                    f"{len(node.slices)} were indexed", node
                )
            return vt
        if isinstance(node, fvir.Call):
            return self._call_type(node)
        raise _err(f"cannot type expression {type(node).__name__}", node)

    def _binop_type(self, node, lt, rt, compare=False) -> ts.TypeSpec:
        if ts.is_deferred(lt) or ts.is_deferred(rt):
            return ts.DeferredType()
        for t in (lt, rt):
            if not isinstance(t, (ts.ScalarType, ts.FieldType)):
                raise _err(f"invalid operand of type {t}", node)
            if not compare and not ts.is_arithmetic(t):
                raise _err(
                    f"arithmetic needs numeric operands, got {t} "
                    "(bool fields combine with '&'/'|')", node
                )
        kinds = [
            (np.dtype(ts.extract_dtype(t).kind), getattr(ts.extract_dtype(t), "weak", False))
            for t in (lt, rt)
        ]
        op = getattr(node, "op", "")
        kind = _result_scalar_kind(op, kinds, node)
        weak = all(w for _, w in kinds)
        # the dtype weak-literal operands must be cast to at execution time
        # (interpreter._cast_operand) -- for comparisons this differs from
        # the (bool) result type
        node.operand_kind = kind
        dims = promote_dims(ts.extract_dims(lt), ts.extract_dims(rt))
        if isinstance(lt, ts.FieldType) or isinstance(rt, ts.FieldType):
            # weak survives only all-weak operands (e.g. two where()s of
            # literals); any concrete operand fixes the dtype
            return ts.FieldType(dims, ts.ScalarType(kind, weak=weak))
        return ts.ScalarType(kind, weak=weak)

    # -- calls -- #

    def _call_type(self, node: fvir.Call) -> ts.TypeSpec:
        ft = self.expr(node.func)
        argts = [self.expr(a) for a in node.args]
        kwargts = {k: self.expr(v) for k, v in node.kwargs.items()}

        # field(offset, ...) / field(connectivity, ...): shift or remap;
        # several offsets apply left-to-right (reference:
        # nd_array_field.__call__ reduces over premap, :367-376)
        if isinstance(ft, ts.FieldType):
            if not argts or kwargts:
                raise _err("field shift takes at least one offset", node)
            for a in argts[:-1]:
                ft = self._shift_type(ft, a, node)
                if ts.is_deferred(ft):
                    return ts.DeferredType()
            return self._shift_type(ft, argts[-1], node)

        if ts.is_deferred(ft):
            return ts.DeferredType()

        return self._call_type_nonfield(node, ft, argts, kwargts)

    def _shift_type(self, ft: ts.FieldType, a, node) -> ts.TypeSpec:
        if isinstance(a, ts.OffsetIndexType):
            if a.source not in ft.dims:
                raise _err(
                    f"offset along {a.source.value} applied to field "
                    f"without that dimension {_dims_str(ft)}", node
                )
            if _is_unstructured_offset(a):
                # V2E[k]: neighbor selection -- source dim replaced
                # by the offset's target element dim (the table comes
                # from offset_provider at call time)
                i = ft.dims.index(a.source)
                return ts.FieldType(
                    ft.dims[:i] + (a.target[0],) + ft.dims[i + 1 :],
                    ft.dtype,
                )
            return ft
        if isinstance(a, ts.ConnectivityType):
            return _remap_type(ft, a, node)
        if isinstance(a, ts.OffsetType):
            if _is_unstructured_offset(a):
                # full remap through a call-time provider table:
                # source dim replaced by the declared target dims
                if a.source not in ft.dims:
                    raise _err(
                        f"offset along {a.source.value} applied to field "
                        f"without that dimension {_dims_str(ft)}", node
                    )
                i = ft.dims.index(a.source)
                return ts.FieldType(
                    ft.dims[:i] + tuple(a.target) + ft.dims[i + 1 :],
                    ft.dtype,
                )
            raise _err(
                f"offset '{a.source.value}' needs an index, e.g. "
                "Ioff[1]", node
            )
        if ts.is_deferred(a):
            return ts.DeferredType()
        raise _err(f"cannot shift a field by a value of type {a}", node)

    def _call_type_nonfield(self, node, ft, argts, kwargts) -> ts.TypeSpec:
        if isinstance(ft, ts.OperatorType):
            return _operator_return_type(ft.op, argts, kwargts, node)

        if isinstance(ft, ts.CastType):
            raise _err("type constructors are only valid as astype(x, T)", node)

        if isinstance(ft, ts.CollectionCtorType):
            # Vel(u=..., v=...) or Vel(a, b): a named-collection literal --
            # lowered to an ordered tuple; reconstruction to the class
            # happens at the operator boundary
            tt = ft.tuple_type
            names = tt.names or ()
            members: dict = {}
            for name, at in zip(names, argts):
                members[name] = at
            for k, at in kwargts.items():
                if k not in names:
                    raise _err(
                        f"'{k}' is not a member of {tt} "
                        f"(members: {', '.join(names)})", node
                    )
                if k in members:
                    raise _err(f"duplicate member '{k}'", node)
                members[k] = at
            missing = [n for n in names if n not in members]
            if len(argts) > len(names) or missing:
                raise _err(
                    f"constructor of {tt} needs exactly its members "
                    f"({', '.join(names)}); missing: {missing}", node
                )
            for n, declared in zip(names, tt.types):
                got = members[n]
                if (
                    not ts.is_deferred(declared)
                    and not ts.is_deferred(got)  # unannotated params: checked at call
                    and not ts.accepts(declared, _strip_weak(got))
                ):
                    raise _err(
                        f"member '{n}' expects {declared}, got {got}", node
                    )
            node.collection_order = tuple(names)
            return ts.TupleType(
                tuple(members[n] for n in names), names=tt.names, origin=tt.origin
            )

        if isinstance(ft, ts.BuiltinType):
            rule = _BUILTIN_RULES[ft.fn]
            return rule(self, node, argts, kwargts)

        raise _err(f"value of type {ft} is not callable", node)


def _dims_str(t: ts.FieldType) -> str:
    return "[" + ", ".join(d.value for d in t.dims) + "]"


def _is_scalar_bool(t: ts.TypeSpec) -> bool:
    return ts.is_deferred(t) or (
        isinstance(t, ts.ScalarType) and np.dtype(t.kind).kind == "b"
    )


def _strip_weak(t: ts.TypeSpec) -> ts.TypeSpec:
    if isinstance(t, ts.ScalarType) and t.weak:
        return ts.ScalarType(t.kind)
    if isinstance(t, ts.FieldType) and t.dtype.weak:
        return ts.FieldType(t.dims, ts.ScalarType(t.dtype.kind))
    if isinstance(t, ts.TupleType):
        return ts.TupleType(
            tuple(_strip_weak(x) for x in t.types),
            names=t.names,  # keep collection identity: member access in
            origin=t.origin,  # unannotated callees relies on it
        )
    return t


def _is_unstructured_offset(a) -> bool:
    """True when a FieldOffset declares a remap (target dims differ from
    the source dim) rather than a cartesian shift (target == (source,))."""
    return len(a.target) != 1 or a.target[0].value != a.source.value


def _remap_type(ft: ts.FieldType, ct: ts.ConnectivityType, node) -> ts.FieldType:
    if ct.codomain not in ft.dims:
        raise _err(
            f"connectivity maps into {ct.codomain.value}, but the field has "
            f"dims {_dims_str(ft)}", node
        )
    i = ft.dims.index(ct.codomain)
    new = (ct.source, ct.local_dim) if ct.local_dim is not None else (ct.source,)
    return ts.FieldType(ft.dims[:i] + new + ft.dims[i + 1 :], ft.dtype)


def _operator_return_type(op, argts, kwargts, node) -> ts.TypeSpec:
    """Return type of calling another field/scan operator.  ``out=`` and
    ``domain=`` keyword arguments (program bodies) are validated here
    (reference: past_passes/type_deduction)."""
    from . import ffront

    out_t = kwargts.pop("out", None)
    dom_t = kwargts.pop("domain", None)
    if kwargts:
        # bind remaining keywords to the callee's parameters (scan: the
        # carry is implicit) -- the SAME binder the runtime call uses
        names = [p.name for p in op.ir.params]
        if isinstance(op, ffront.ScanOperator):
            names = names[1:]
        try:
            argts = list(
                ffront._bind_call_args(names, argts, kwargts, op.__name__)
            )
        except TypeError as e:
            raise _err(str(e), node) from None
    if dom_t is not None and not isinstance(dom_t, (ts.DomainType, ts.DeferredType)):
        raise _err(f"domain= expects a Domain, got {dom_t}", node)
    if isinstance(op, ffront.ScanOperator):
        ret = _scan_return_type(op, argts, node)
    else:
        # field operator: re-deduce the callee against these argument types
        try:
            ret = op._deduce_return([_strip_weak(t) for t in argts])
        except FieldViewError:
            raise
        except Exception as e:  # pragma: no cover
            raise _err(f"in call to '{op.__name__}': {e}", node)
    if out_t is None:
        return ret
    # out= write: validate the output accepts the result
    def chk(o, r):
        if ts.is_deferred(o) or ts.is_deferred(r):
            return
        if isinstance(o, ts.TupleType) and isinstance(r, ts.TupleType):
            if len(o) != len(r):
                raise _err(
                    f"out= tuple has {len(o)} elements, result has {len(r)}",
                    node,
                )
            for oo, rr in zip(o.types, r.types):
                chk(oo, rr)
            return
        if not isinstance(o, ts.FieldType) or not isinstance(r, ts.FieldType):
            raise _err(f"cannot write {r} into out= of type {o}", node)
        if getattr(r.dtype, "weak", False):
            # weak results adapt to the out dtype (_write_out casts), but
            # only within the same kind category: a weak float silently
            # truncated into an int/bool out would lose data
            if not np.can_cast(
                np.dtype(r.dtype.kind), np.dtype(o.dtype.kind), casting="same_kind"
            ):
                raise _err(
                    f"cannot write a {np.dtype(r.dtype.kind)} result into "
                    f"out= of dtype {np.dtype(o.dtype.kind)}",
                    node,
                )
        elif np.dtype(o.dtype.kind) != np.dtype(r.dtype.kind):
            raise _err(
                f"out= dtype {np.dtype(o.dtype.kind)} does not match result "
                f"dtype {np.dtype(r.dtype.kind)}",
                node,
            )
        missing = [d.value for d in r.dims if d not in o.dims]
        if missing:
            raise _err(
                f"result dims {missing} missing from out= field "
                f"{_dims_str(o)}", node
            )
    chk(out_t, ret)
    return ts.VoidType()


def _scan_return_type(op, argts, node) -> ts.TypeSpec:
    from . import type_system as _ts

    field_dims = []
    scalar_argts = []
    for t in argts:
        if isinstance(t, _ts.FieldType):
            field_dims.append(t.dims)
            scalar_argts.append(_ts.ScalarType(np.dtype(t.dtype.kind)))
        elif isinstance(t, _ts.ScalarType):
            scalar_argts.append(_strip_weak(t))
        elif _ts.is_deferred(t):
            return _ts.DeferredType()
        else:
            raise _err(f"scan operators take fields and scalars, got {t}", node)
    if not field_dims:
        raise _err("scan operator call needs at least one field argument", node)
    dims = promote_dims(*field_dims, (op.axis,))
    # weak python init literals adapt to the declared carry annotation
    # (same rule the call-time path applies in ScanOperator._scan_typed):
    # a float32-annotated scan with init=0.0 must not deduce f64 here
    carry_t = _ts.from_value(op.init)
    decl = op.ir.params[0].type if op.ir.params else None
    if (
        type(op.init) in (float, int)
        and isinstance(decl, _ts.ScalarType)
        and not _ts.is_deferred(decl)
    ):
        carry_t = _ts.ScalarType(np.dtype(decl.kind))
    elif (
        isinstance(op.init, tuple)
        and isinstance(decl, _ts.TupleType)
        and len(decl.types) == len(op.init)
    ):
        carry_t = _ts.TupleType(
            tuple(
                _ts.ScalarType(np.dtype(dt.kind))
                if type(v) in (float, int)
                and isinstance(dt, _ts.ScalarType)
                and not _ts.is_deferred(dt)
                else _ts.from_value(v)
                for v, dt in zip(op.init, decl.types)
            )
        )
    ret = op._deduce_return([carry_t, *scalar_argts])

    def to_field(t):
        if isinstance(t, _ts.TupleType):
            return _ts.TupleType(tuple(to_field(x) for x in t.types))
        if _ts.is_deferred(t):
            return t
        return _ts.FieldType(dims, _ts.ScalarType(np.dtype(_ts.extract_dtype(t).kind)))

    return to_field(ret)


# --------------------------------------------------------------------- #
# builtin type rules
# --------------------------------------------------------------------- #


def _rule_where(self, node, argts, kwargts):
    if len(argts) != 3 or kwargts:
        raise _err("where(cond, a, b) takes three arguments", node)
    c, a, b = argts
    if ts.is_deferred(c) or ts.is_deferred(a) or ts.is_deferred(b):
        return ts.DeferredType()
    if isinstance(a, ts.TupleType) and isinstance(b, ts.TupleType):
        # per-member operand kinds: each recursion sets node.operand_kind;
        # collect them so the interpreter can cast weak literals inside
        # tuple branches member-by-member
        types_, kinds = [], []
        for x, y in zip(a.types, b.types):
            types_.append(_rule_where(self, node, [c, x, y], {}))
            kinds.append(getattr(node, "operand_kind", None))
        node.operand_kind = tuple(kinds)
        return ts.TupleType(tuple(types_))
    if not ts.is_logical(c):
        raise _err(f"where() condition must be a bool field/scalar, got {c}", node)
    merged = self._binop_type(node, a, b, compare=True)
    dims = promote_dims(ts.extract_dims(c), ts.extract_dims(merged))
    dt = ts.extract_dtype(merged)
    if dims:
        # weak branches (both literals) keep adapting downstream, jax-style:
        # where(cond, 0.5, 1.0) + bf16_field stays bf16
        return ts.FieldType(
            dims, ts.ScalarType(np.dtype(dt.kind), weak=getattr(dt, "weak", False))
        )
    return merged


def _rule_concat_where(self, node, argts, kwargts):
    if len(argts) != 3 or kwargts:
        raise _err("concat_where(domain, a, b) takes three arguments", node)
    d, a, b = argts
    if ts.is_deferred(d) or ts.is_deferred(a) or ts.is_deferred(b):
        return ts.DeferredType()
    if not isinstance(d, ts.DomainType):
        raise _err(
            f"concat_where() condition must be a domain (e.g. K < 5), got {d} "
            "-- use where() for elementwise masks", node
        )
    if len(d.dims) != 1:
        raise _err("concat_where() condition must be one-dimensional", node)
    if isinstance(a, ts.TupleType) and isinstance(b, ts.TupleType):
        types_, kinds = [], []
        for x, y in zip(a.types, b.types):
            types_.append(_rule_concat_where(self, node, [d, x, y], {}))
            kinds.append(getattr(node, "operand_kind", None))
        node.operand_kind = tuple(kinds)
        return ts.TupleType(tuple(types_))
    merged = self._binop_type(node, a, b, compare=True)
    dims = promote_dims(ts.extract_dims(merged), d.dims)
    dt = ts.extract_dtype(merged)
    return ts.FieldType(
        dims, ts.ScalarType(np.dtype(dt.kind), weak=getattr(dt, "weak", False))
    )


def _rule_broadcast(self, node, argts, kwargts):
    if len(argts) != 2 or kwargts:
        raise _err("broadcast(value, dims) takes two arguments", node)
    v, dims_t = argts
    if ts.is_deferred(v):
        return ts.DeferredType()
    if not isinstance(dims_t, ts.TupleType) or not all(
        isinstance(t, ts.DimensionType) for t in dims_t.types
    ):
        raise _err("broadcast() dims must be a tuple of dimensions", node)
    dims = tuple(t.dim for t in dims_t.types)
    src = ts.extract_dims(v)
    for d in src:
        if d not in dims:
            raise _err(
                f"broadcast() cannot drop dimension {d.value}", node
            )
    dt = ts.extract_dtype(v)
    if dt is None:
        raise _err(f"cannot broadcast a value of type {v}", node)
    return ts.FieldType(
        dims, ts.ScalarType(np.dtype(dt.kind), weak=getattr(dt, "weak", False))
    )


def _rule_astype(self, node, argts, kwargts):
    if len(argts) != 2 or kwargts:
        raise _err("astype(value, dtype) takes two arguments", node)
    v, t = argts
    if ts.is_deferred(v):
        return ts.DeferredType()
    if not isinstance(t, ts.CastType):
        raise _err(
            "astype() dtype must be a scalar type like float32/int32", node
        )
    def cast(x):
        if isinstance(x, ts.TupleType):
            return ts.TupleType(tuple(cast(y) for y in x.types))
        if isinstance(x, ts.FieldType):
            return ts.FieldType(x.dims, ts.ScalarType(t.dtype))
        if isinstance(x, ts.ScalarType):
            return ts.ScalarType(t.dtype)
        raise _err(f"cannot cast a value of type {x}", node)
    return cast(v)


def _rule_reduction(self, node, argts, kwargts):
    axis_t = kwargts.get("axis")
    if len(argts) != 1 or axis_t is None or set(kwargts) != {"axis"}:
        raise _err("reductions take (field, axis=...)", node)
    (v,) = argts
    if ts.is_deferred(v):
        return ts.DeferredType()
    if not isinstance(v, ts.FieldType):
        raise _err(f"reductions need a field argument, got {v}", node)
    if isinstance(axis_t, ts.ConnectivityType):
        dim = axis_t.local_dim
    elif isinstance(axis_t, ts.DimensionType):
        dim = axis_t.dim
    else:
        raise _err(
            "reduction axis must be a connectivity or a local dimension", node
        )
    if dim is None or dim not in v.dims:
        raise _err(
            f"reduction axis {getattr(dim, 'value', dim)} is not a dimension "
            f"of the field {_dims_str(v)}", node
        )
    i = v.dims.index(dim)
    return ts.FieldType(v.dims[:i] + v.dims[i + 1 :], v.dtype)


def _rule_math_unary(fn_name, float_only=True):
    def rule(self, node, argts, kwargts):
        if len(argts) != 1 or kwargts:
            raise _err(f"{fn_name}() takes one argument", node)
        (v,) = argts
        if ts.is_deferred(v):
            return ts.DeferredType()
        dt = ts.extract_dtype(v)
        if dt is None or not ts.is_arithmetic(v):
            raise _err(f"{fn_name}() needs a numeric argument, got {v}", node)
        kind = np.dtype(dt.kind)
        if float_only and kind.kind in "iub":
            kind = np.dtype(np.float64)
        dims = ts.extract_dims(v)
        if dims:
            return ts.FieldType(dims, ts.ScalarType(kind))
        return ts.ScalarType(kind, weak=getattr(dt, "weak", False))
    return rule


def _rule_binary_math(name):
    def rule(self, node, argts, kwargts):
        if len(argts) != 2 or kwargts:
            raise _err(f"{name}(a, b) takes two arguments", node)
        a, b = argts
        if ts.is_deferred(a) or ts.is_deferred(b):
            return ts.DeferredType()
        return self._binop_type(node, a, b)
    return rule


def _rule_premap(self, node, argts, kwargts):
    if len(argts) < 2 or kwargts:
        raise _err("premap(field, *connectivities) needs a field and offsets", node)
    v = argts[0]
    if ts.is_deferred(v):
        return ts.DeferredType()
    if not isinstance(v, ts.FieldType):
        raise _err(f"premap() needs a field, got {v}", node)
    for ct in argts[1:]:
        if ts.is_deferred(ct):
            return ts.DeferredType()
        if isinstance(ct, ts.OffsetIndexType):
            continue
        if not isinstance(ct, ts.ConnectivityType):
            raise _err(f"premap() mapping must be a connectivity, got {ct}", node)
        v = _remap_type(v, ct, node)
    return v


def _rule_as_offset(self, node, argts, kwargts):
    if len(argts) != 2 or kwargts:
        raise _err("as_offset(offset, index_field) takes two arguments", node)
    o, f = argts
    if ts.is_deferred(f):
        return ts.DeferredType()
    if not isinstance(o, ts.OffsetType):
        raise _err("as_offset() first argument must be a FieldOffset", node)
    if not isinstance(f, ts.FieldType) or len(f.dims) != 1:
        raise _err("as_offset() needs a 1D integer field", node)
    if np.dtype(f.dtype.kind).kind not in "iu":
        raise _err(
            f"as_offset() index field must be integer, got {f.dtype}", node
        )
    return ts.ConnectivityType(
        source=f.dims[0], codomain=o.source, local_dim=None, has_skip_values=False
    )


def _make_builtin_rules():
    from . import builtins as fb

    rules = {
        fb.where: _rule_where,
        fb.concat_where: _rule_concat_where,
        fb.broadcast: _rule_broadcast,
        fb.astype: _rule_astype,
        fb.neighbor_sum: _rule_reduction,
        fb.max_over: _rule_reduction,
        fb.min_over: _rule_reduction,
        fb.premap: _rule_premap,
        fb.as_offset: _rule_as_offset,
        fb.maximum: _rule_binary_math("maximum"),
        fb.minimum: _rule_binary_math("minimum"),
        fb.fmod: _rule_binary_math("fmod"),
        fb.power: _rule_binary_math("power"),
    }
    int_preserving = {"abs", "floor", "ceil", "trunc", "neg"}
    bool_returning = {"isfinite", "isinf", "isnan"}
    for name, fn in fb.MATH_BUILTINS.items():
        if fn in rules:
            continue
        if name in bool_returning:
            def mk(nm):
                def rule(self, node, argts, kwargts):
                    t = _rule_math_unary(nm, float_only=False)(
                        self, node, argts, kwargts
                    )
                    if isinstance(t, ts.FieldType):
                        return ts.FieldType(t.dims, ts.ScalarType(np.dtype(bool)))
                    if isinstance(t, ts.ScalarType):
                        return ts.ScalarType(np.dtype(bool))
                    return t
                return rule
            rules[fn] = mk(name)
        else:
            rules[fn] = _rule_math_unary(name, float_only=name not in int_preserving)
    return rules


_BUILTIN_RULES = _make_builtin_rules()


def deduce(ir: fvir.OperatorIR, param_types=None) -> Tuple[fvir.OperatorIR, ts.TypeSpec]:
    """Type-annotate a fresh copy of ``ir`` (so per-signature typings do
    not interfere) and return (typed_ir, return_type)."""
    # closure values (operators, connectivities, collection classes) must
    # stay SHARED, not copied -- pre-seeding the memo also keeps deepcopy
    # from walking their mutable caches, which a background AOT-pool
    # compile thread may be writing concurrently ("dictionary changed
    # size during iteration")
    memo: dict = {id(v): v for v in ir.closure.values()}
    typed = copy.deepcopy(ir, memo)
    typed.closure = dict(ir.closure)
    ret = TypeDeduction(typed).run(param_types)
    return typed, ret
