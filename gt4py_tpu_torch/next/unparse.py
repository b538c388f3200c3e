"""FVIR text round-trip: unparse typed field-view IR back to restricted
Python, and reparse that text through the real frontend.

Reference analog: the ITIR pretty printer + pretty parser
(src/gt4py/next/iterator/pretty_printer.py, pretty_parser.py).  FVIR's
surface syntax IS the restricted-Python subset, so its canonical text
form is source code -- ``reparse(unparse(ir))`` runs the full parser +
type deduction again, which makes the round-trip a semantic check, not
just a lexical one.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from . import fvir, type_system as ts

_BIN = {
    "add": "+", "sub": "-", "mult": "*", "div": "/",
    "floordiv": "//", "mod": "%", "pow": "**",
}
_CMP = {"lt": "<", "le": "<=", "gt": ">", "ge": ">=", "eq": "==", "ne": "!="}
_UNARY = {"neg": "-", "pos": "+", "not": "not "}


class UnparseError(ValueError):
    pass


def _type_src(t: Optional[ts.TypeSpec]) -> Optional[str]:
    if t is None or ts.is_deferred(t):
        return "Field" if isinstance(t, ts.FieldType) else None
    if isinstance(t, ts.FieldType):
        dims = ", ".join(d.value for d in t.dims)
        return f"Field[Dims[{dims}], {t.dtype}]"
    if isinstance(t, ts.ScalarType):
        return str(np.dtype(t.kind))
    return None


def _expr(e: fvir.Expr) -> str:
    if isinstance(e, fvir.Name):
        return e.id
    if isinstance(e, fvir.Literal):
        return repr(e.value)
    if isinstance(e, fvir.BinOp):
        return f"({_expr(e.left)} {_BIN[e.op]} {_expr(e.right)})"
    if isinstance(e, fvir.UnaryOp):
        return f"({_UNARY[e.op]}{_expr(e.operand)})"
    if isinstance(e, fvir.Compare):
        return f"({_expr(e.left)} {_CMP[e.op]} {_expr(e.right)})"
    if isinstance(e, fvir.BoolOp):
        return "(" + f" {e.op} ".join(_expr(v) for v in e.values) + ")"
    if isinstance(e, fvir.Call):
        args = [_expr(a) for a in e.args]
        args += [f"{k}={_expr(v)}" for k, v in e.kwargs.items()]
        return f"{_expr(e.func)}({', '.join(args)})"
    if isinstance(e, fvir.Subscript):
        return f"{_expr(e.value)}[{e.index}]"
    if isinstance(e, fvir.FieldSlice):
        parts = ", ".join(
            f"{'' if lo is None else lo}:{'' if hi is None else hi}"
            for lo, hi in e.slices
        )
        return f"{_expr(e.value)}[{parts}]"
    if isinstance(e, fvir.AttrGet):
        return f"{_expr(e.value)}.{e.attr}"
    if isinstance(e, fvir.TupleExpr):
        inner = ", ".join(_expr(x) for x in e.elts)
        return f"({inner},)" if len(e.elts) == 1 else f"({inner})"
    if isinstance(e, fvir.DictExpr):
        items = ", ".join(
            f"{_expr(k)}: {_expr(v)}" for k, v in zip(e.keys, e.values)
        )
        return "{" + items + "}"
    if isinstance(e, fvir.Ternary):
        return (
            f"({_expr(e.true_expr)} if {_expr(e.cond)} else {_expr(e.false_expr)})"
        )
    raise UnparseError(f"cannot unparse {type(e).__name__}")


def _stmts(body, indent: str) -> list:
    lines = []
    for st in body:
        if isinstance(st, fvir.Return):
            lines.append(f"{indent}return {_expr(st.value)}")
        elif isinstance(st, fvir.Assign):
            if not st.targets:
                lines.append(f"{indent}{_expr(st.value)}")
            else:
                tgt = ", ".join(st.targets)
                lines.append(f"{indent}{tgt} = {_expr(st.value)}")
        elif isinstance(st, fvir.IfStmt):
            lines.append(f"{indent}if {_expr(st.cond)}:")
            lines.extend(_stmts(st.body, indent + "    "))
            if st.orelse:
                lines.append(f"{indent}else:")
                lines.extend(_stmts(st.orelse, indent + "    "))
        else:
            raise UnparseError(f"cannot unparse {type(st).__name__}")
    return lines


def unparse(ir: fvir.OperatorIR) -> str:
    """Canonical restricted-Python text of a parsed operator."""
    params = []
    for p in ir.params:
        t = _type_src(p.type)
        params.append(f"{p.name}: {t}" if t else p.name)
    ret = _type_src(ir.declared_return)
    head = f"def {ir.name}({', '.join(params)})"
    if ret:
        head += f" -> {ret}"
    return head + ":\n" + "\n".join(_stmts(ir.body, "    ")) + "\n"


def _namespace(ir: fvir.OperatorIR) -> Dict[str, Any]:
    from .builtins import FIELD_BUILTINS
    from .common import Field
    from .type_system import Dims

    ns: Dict[str, Any] = {"Field": Field, "Dims": Dims}
    for dt in ("float32", "float64", "int32", "int64", "bool_"):
        ns[dt] = getattr(np, dt)
    ns["bool"] = np.bool_
    ns.update(FIELD_BUILTINS)
    # dimensions referenced by the parameter/return annotations
    specs = [p.type for p in ir.params] + [ir.declared_return]
    for t in specs:
        if isinstance(t, ts.FieldType):
            for d in t.dims:
                ns[d.value] = d
    ns.update(ir.closure)
    return ns


def reparse(ir: fvir.OperatorIR) -> fvir.OperatorIR:
    """unparse + run the full frontend again (parser, validation, type
    deduction) on the text.  Supports field operators and programs."""
    import linecache

    from .frontend import parse_definition

    src = unparse(ir)
    filename = f"<fvir-roundtrip-{ir.name}>"
    linecache.cache[filename] = (len(src), None, src.splitlines(True), filename)
    ns = _namespace(ir)
    exec(compile(src, filename, "exec"), ns)
    return parse_definition(ns[ir.name], ir.kind)
