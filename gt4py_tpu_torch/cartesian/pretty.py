"""Human-readable stencil-IR formatting.

Parity with the reference's IR pretty printers and the ``Program.gtir``
inspection property (reference: next/iterator/pretty_printer.py,
ffront/decorator.py:308-318): ``StencilObject.pretty_ir()`` returns the
lowered IR as GTScript-like text for debugging and review.
"""

from __future__ import annotations

from typing import List

from gt4py_tpu_torch.cartesian import ir


def _fmt_bound(b: ir.AxisBound) -> str:
    base = "0" if b.level == ir.LevelMarker.START else "END"
    if b.offset == 0:
        return base
    return f"{base}{b.offset:+d}"


def _fmt_interval(iv: ir.Interval) -> str:
    return f"[{_fmt_bound(iv.start)}:{_fmt_bound(iv.end)}]"


def _fmt_offset(off) -> str:
    if isinstance(off, ir.CartesianOffset):
        if off.i == off.j == off.k == 0:
            return ""
        return f"[{off.i}, {off.j}, {off.k}]"
    if isinstance(off, ir.VariableKOffset):
        return f"[0, 0, {fmt_expr(off.k)}]"
    if isinstance(off, ir.AbsoluteKIndex):
        return f".at(K={fmt_expr(off.k)})"
    return "?"


def fmt_expr(e: ir.Expr) -> str:
    if isinstance(e, ir.Literal):
        return repr(e.value)
    if isinstance(e, ir.ScalarAccess):
        return e.name
    if isinstance(e, ir.FieldAccess):
        s = e.name + _fmt_offset(e.offset)
        if e.data_index:
            s += "[" + ", ".join(fmt_expr(d) for d in e.data_index) + "]"
        return s
    if isinstance(e, ir.AxisPosition):
        return e.axis
    if isinstance(e, ir.AxisSize):
        return f"size({e.axis})"
    if isinstance(e, ir.UnaryOp):
        return f"({e.op.value} {fmt_expr(e.expr)})"
    if isinstance(e, ir.BinaryOp):
        return f"({fmt_expr(e.left)} {e.op.value} {fmt_expr(e.right)})"
    if isinstance(e, ir.TernaryOp):
        return (
            f"({fmt_expr(e.true_expr)} if {fmt_expr(e.cond)} "
            f"else {fmt_expr(e.false_expr)})"
        )
    if isinstance(e, ir.NativeFuncCall):
        return f"{e.func.value}({', '.join(fmt_expr(a) for a in e.args)})"
    if isinstance(e, ir.Cast):
        return f"{e.dtype}({fmt_expr(e.expr)})"
    return f"<{type(e).__name__}>"


def _fmt_stmts(stmts, indent: int, out: List[str]) -> None:
    pad = "  " * indent
    for s in stmts:
        if isinstance(s, ir.Assign):
            tgt = s.target.name + _fmt_offset(s.target.offset)
            if s.target.data_index:
                tgt += "[" + ", ".join(fmt_expr(d) for d in s.target.data_index) + "]"
            out.append(f"{pad}{tgt} = {fmt_expr(s.value)}")
        elif isinstance(s, ir.If):
            out.append(f"{pad}if {fmt_expr(s.cond)}:")
            _fmt_stmts(s.body, indent + 1, out)
            if s.orelse:
                out.append(f"{pad}else:")
                _fmt_stmts(s.orelse, indent + 1, out)
        elif isinstance(s, ir.While):
            out.append(f"{pad}while {fmt_expr(s.cond)}:")
            _fmt_stmts(s.body, indent + 1, out)
        elif isinstance(s, ir.HorizontalRestriction):
            regions = ", ".join(
                f"region[I{_fmt_hint(m.i)}, J{_fmt_hint(m.j)}]" for m in s.masks
            )
            out.append(f"{pad}with horizontal({regions}):")
            _fmt_stmts(s.body, indent + 1, out)


def _fmt_hint(h: ir.HorizontalInterval) -> str:
    lo = _fmt_bound(h.start) if h.start is not None else ""
    hi = _fmt_bound(h.end) if h.end is not None else ""
    return f"[{lo}:{hi}]"


def pformat_stencil(stencil: ir.Stencil) -> str:
    """Format a stencil IR as GTScript-like text."""
    out: List[str] = [f"stencil {stencil.name}:"]
    for name, decl in stencil.field_decls.items():
        axes = "".join(ax for ax, p in zip("IJK", decl.dimensions) if p)
        dd = f", data_dims={decl.data_dims}" if decl.data_dims else ""
        out.append(f"  field {name}: {axes or 'scalar'}[{decl.dtype}]{dd}")
    for name, decl in stencil.scalar_decls.items():
        out.append(f"  param {name}: {decl.dtype}")
    for name, decl in stencil.temp_decls.items():
        out.append(f"  temp {name}: {decl.dtype}")
    for loop in stencil.vertical_loops:
        out.append(f"  computation({loop.loop_order.name}):")
        for section in loop.sections:
            out.append(f"    interval{_fmt_interval(section.interval)}:")
            _fmt_stmts(section.body, 3, out)
    return "\n".join(out)
