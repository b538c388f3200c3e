"""FVIR -- the field-view IR produced by the `next` frontend.

Reference analog: src/gt4py/next/ffront/field_operator_ast.py (FOAST).
Same role -- a small, validated, typed AST for the restricted Python
subset accepted inside ``@field_operator`` / ``@scan_operator`` /
``@program`` -- with a TPU-first simplification: FVIR is *interpreted*
over jax-backed Fields (tracing under jit = compilation) instead of being
lowered through ITIR to generated code, so one IR covers FOAST+PAST+ITIR.

Every node carries a source location (file, line, col) for located
diagnostics (reference: eve.concepts.SourceLocation), and a ``type`` slot
filled by the type-deduction pass (frontend.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Union

from .type_system import TypeSpec


@dataclasses.dataclass(frozen=True)
class Location:
    filename: str
    line: int  # absolute line in filename
    col: int

    def __str__(self):
        return f"{self.filename}:{self.line}:{self.col + 1}"


@dataclasses.dataclass
class Node:
    loc: Location

    def children(self):
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, Node):
                yield v
            elif isinstance(v, (list, tuple)):
                for x in v:
                    if isinstance(x, Node):
                        yield x
            elif isinstance(v, dict):
                for x in v.values():
                    if isinstance(x, Node):
                        yield x

    def walk(self):
        yield self
        for c in self.children():
            yield from c.walk()


@dataclasses.dataclass
class Expr(Node):
    type: Optional[TypeSpec] = dataclasses.field(default=None, compare=False)


@dataclasses.dataclass
class Name(Expr):
    id: str = ""


@dataclasses.dataclass
class Literal(Expr):
    value: Any = None


@dataclasses.dataclass
class BinOp(Expr):
    op: str = ""  # add sub mult div floordiv mod pow
    left: Expr = None
    right: Expr = None


@dataclasses.dataclass
class UnaryOp(Expr):
    op: str = ""  # neg pos not
    operand: Expr = None


@dataclasses.dataclass
class Compare(Expr):
    op: str = ""  # lt le gt ge eq ne
    left: Expr = None
    right: Expr = None


@dataclasses.dataclass
class BoolOp(Expr):
    op: str = ""  # and or
    values: List[Expr] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Call(Expr):
    func: Expr = None
    args: List[Expr] = dataclasses.field(default_factory=list)
    kwargs: Dict[str, Expr] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Subscript(Expr):
    """``Ioff[1]`` (offset indexing) or ``t[0]`` (tuple element)."""

    value: Expr = None
    index: int = 0


@dataclasses.dataclass
class FieldSlice(Expr):
    """``out[1:-1]`` / ``out[1:-1, :]`` -- relative domain restriction of
    an ``out=`` target in program bodies (reference:
    past_to_itir._compute_field_slice :188-208).  ``slices`` holds one
    ``(start, stop)`` pair per leading dimension, entries None when
    open."""

    value: Expr = None
    slices: Tuple = ()


@dataclasses.dataclass
class AttrGet(Expr):
    """``vel.u`` -- member access on a named collection (NamedTuple /
    dataclass typed value); type deduction resolves ``index``."""

    value: Expr = None
    attr: str = ""
    index: int = -1  # filled by type deduction


@dataclasses.dataclass
class TupleExpr(Expr):
    elts: List[Expr] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class DictExpr(Expr):
    """``{I: (0, n), J: (0, m)}`` -- a domain literal in program code
    (reference: past_passes accept dict domain= arguments)."""

    keys: List[Expr] = dataclasses.field(default_factory=list)
    values: List[Expr] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Ternary(Expr):
    cond: Expr = None
    true_expr: Expr = None
    false_expr: Expr = None


# ---- statements ---- #


@dataclasses.dataclass
class Stmt(Node):
    pass


@dataclasses.dataclass
class Assign(Stmt):
    targets: Tuple[str, ...] = ()  # >1 names = tuple-unpacking
    value: Expr = None
    unpack: bool = False


@dataclasses.dataclass
class Return(Stmt):
    value: Expr = None


@dataclasses.dataclass
class IfStmt(Stmt):
    cond: Expr = None
    body: List[Stmt] = dataclasses.field(default_factory=list)
    orelse: List[Stmt] = dataclasses.field(default_factory=list)


# ---- top level ---- #


@dataclasses.dataclass
class Param(Node):
    name: str = ""
    type: Optional[TypeSpec] = None


@dataclasses.dataclass
class OperatorIR(Node):
    """A parsed field/scan operator definition (FOAST analog) or program."""

    name: str = ""
    kind: str = "field_operator"  # | "scan_operator" | "program"
    params: List[Param] = dataclasses.field(default_factory=list)
    body: List[Stmt] = dataclasses.field(default_factory=list)
    declared_return: Optional[TypeSpec] = None
    #: closure symbols referenced by the body: name -> python value
    closure: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def param(self, name: str) -> Param:
        for p in self.params:
            if p.name == name:
                return p
        raise KeyError(name)
