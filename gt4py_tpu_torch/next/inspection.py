"""Program inspection: the field-level signature of an operator call and
what it lowers to.

The counterpart of ``gt4py_tpu.next.inspection`` (reference behavior:
next/iterator/pretty_printer.py gives a textual view of the lowered
program).  The JAX package prints the jaxpr a trace produces; here the
lowered program is the cartesian stencil IR of ``cuda_bridge`` and the
CUDA C++ generated from it, so ``describe`` prints the argument signature
and, for an operator the bridge lowers, the generated source's kernels.

Usage::

    from gt4py_tpu_torch.next import inspection

    print(inspection.describe(my_field_operator, f1, f2))
    print(inspection.format_field(f1))
"""

from __future__ import annotations

from typing import Any

from gt4py_tpu_torch.next.common import Field


def format_field(f: Field) -> str:
    """One-line signature of a field: dims, ranges, dtype."""
    dims = ", ".join(
        f"{d.value}[{r.start}:{r.stop}]" for d, r in zip(f.domain.dims, f.domain.ranges)
    )
    return f"Field<{dims}; {f.dtype}>"


def describe(op: Any, *example_args, **example_kwargs) -> str:
    """A readable report of ``op`` (a field_operator / scan_operator)
    against example arguments: the argument signature, then the lowered
    stencil's kernels (name, form, loop order) when the bridge lowers it,
    or the reason it runs embedded."""
    from . import cuda_bridge, ffront
    from .ffront import _value_type

    fn = getattr(op, "definition", op)
    name = getattr(op, "__name__", getattr(fn, "__name__", "<program>"))
    lines = [f"program {name}:"]
    for i, a in enumerate(example_args):
        lines.append(f"  arg{i}: {format_field(a) if isinstance(a, Field) else repr(a)}")
    for k, a in example_kwargs.items():
        lines.append(f"  {k}: {format_field(a) if isinstance(a, Field) else repr(a)}")
    lines.append("")
    if not isinstance(op, ffront.FieldOperator):
        lines.append("(not an operator: nothing is lowered)")
        return "\n".join(lines)
    try:
        if isinstance(op, ffront.ScanOperator):
            typed = op._scan_typed(op._scalar_types(example_args))
            plan = cuda_bridge.lower_scan_operator(
                typed, axis=op.axis, forward=op.forward, init=op.init,
                arg_info=[("field", tuple(a.domain.dims), a.dtype) if isinstance(a, Field)
                          else ("scalar", None) for a in example_args])
        else:
            typed, _ = op._typed_for(tuple(_value_type(a) for a in example_args))
            plan = cuda_bridge.lower_field_operator(typed)
    except cuda_bridge.Ineligible as ex:
        lines.append(f"runs embedded: {ex}")
        return "\n".join(lines)
    prog = plan.backend.program
    lines.append(f"stencil {plan.stencil.name}: {len(prog.kernels)} CUDA kernels")
    for k in prog.kernels:
        lines.append(f"  {k.name}: {k.form} form ({k.order.name}), reads {k.reads}, "
                     f"writes {k.writes}")
    return "\n".join(lines)
