"""Parallel-model race rules and definitive-assignment analysis.

These validators define the GTScript language semantics
(reference: gtir.py:78-110 and 222-293; gtir_to_oir.py:19-47;
gtir_definitive_assignment_analysis.py:16-73).
"""

from __future__ import annotations

from typing import Dict, List, Set, Tuple

from gt4py_tpu_torch.cartesian import ir
from gt4py_tpu_torch.cartesian.analysis import _stmt_reads, _stmt_writes


class GTScriptValidationError(ValueError):
    pass


def validate(stencil: ir.Stencil) -> None:
    _validate_lhs_offsets(stencil)
    _validate_same_stmt_races(stencil)
    _validate_vertical_loop_races(stencil)
    _validate_parallel_k_races(stencil)
    _validate_api_write_extents(stencil)
    _validate_definitive_assignment(stencil)
    _validate_data_indices(stencil)


def _validate_data_indices(stencil: ir.Stencil) -> None:
    """Data-dimension indices: arity must match the declared data_dims,
    and static indices must lie in [-d, d) (python semantics; dynamic
    per-point indices wrap modulo d on every backend)."""
    from gt4py_tpu_torch.cartesian.analysis import try_static_int

    for node in ir.walk_values(stencil.vertical_loops):
        if not isinstance(node, ir.FieldAccess):
            continue
        decl = stencil.decl(node.name)
        if decl is None:
            continue
        # no data_index on a data-dims field = whole-vector access
        # (vector assignment); otherwise the arity must match
        if node.data_index and len(node.data_index) != len(decl.data_dims):
            raise GTScriptValidationError(
                f"Field '{node.name}' has {len(decl.data_dims)} data "
                f"dimension(s) but is indexed with {len(node.data_index)}"
            )
        for e, d in zip(node.data_index, decl.data_dims):
            v = try_static_int(e)
            if v is not None and not (-d <= v < d):
                raise GTScriptValidationError(
                    f"Data index {v} out of range for dimension of size "
                    f"{d} on field '{node.name}'"
                )


def _validate_lhs_offsets(stencil: ir.Stencil) -> None:
    """LHS of assignments must not have horizontal offsets (gtir.py:87-95)."""
    for node in ir.walk_values(stencil.vertical_loops):
        if isinstance(node, ir.Assign):
            off = node.target.offset
            if isinstance(off, ir.CartesianOffset) and (off.i != 0 or off.j != 0):
                raise GTScriptValidationError(
                    f"Lhs of assignment must not have a horizontal offset "
                    f"(field '{node.target.name}')"
                )
            if isinstance(off, ir.AbsoluteKIndex):
                raise GTScriptValidationError(
                    f"Cannot assign to absolute K index of field '{node.target.name}'"
                )


def _validate_same_stmt_races(stencil: ir.Stencil) -> None:
    """Self-assignment with horizontal offset read is illegal (gtir.py:96-110)."""
    for node in ir.walk_values(stencil.vertical_loops):
        if isinstance(node, ir.Assign):
            target = node.target.name
            for acc in ir.field_accesses(node.value):
                if acc.name != target:
                    continue
                if isinstance(acc.offset, ir.CartesianOffset) and (
                    acc.offset.i != 0 or acc.offset.j != 0
                ):
                    raise GTScriptValidationError(
                        f"Self-assignment with offset in I or J is illegal "
                        f"(field '{target}')"
                    )


def _loop_write_read_offsets(
    loop: ir.VerticalLoop,
) -> Tuple[Set[str], Dict[str, List[ir.FieldAccess]]]:
    writes: Set[str] = set()
    reads: Dict[str, List[ir.FieldAccess]] = {}
    for section in loop.sections:
        for stmt in section.body:
            for w in _stmt_writes(stmt):
                writes.add(w.name)
            for r in _stmt_reads(stmt):
                reads.setdefault(r.name, []).append(r)
    return writes, reads


def _validate_vertical_loop_races(stencil: ir.Stencil) -> None:
    """Within one vertical loop an *API* field must not be both written and
    read with a horizontal offset; temporaries are exempt because they are
    computed on block-private extended domains (gtir.py:222-240)."""
    for loop in stencil.vertical_loops:
        writes, reads = _loop_write_read_offsets(loop)
        for name in writes:
            if name in stencil.temp_decls:
                continue
            for acc in reads.get(name, []):
                if isinstance(acc.offset, ir.CartesianOffset) and (
                    acc.offset.i != 0 or acc.offset.j != 0
                ):
                    raise GTScriptValidationError(
                        f"Illegal write and read with horizontal offset detected "
                        f"for '{name}'"
                    )


def _validate_parallel_k_races(stencil: ir.Stencil) -> None:
    """In PARALLEL loops, write + read of the same field with differing K
    offsets (or any variable-K / absolute-K combination) races
    (gtir.py:242-293).  Size-one intervals are exempt."""
    for loop in stencil.vertical_loops:
        if loop.loop_order != ir.LoopOrder.PARALLEL:
            continue
        for section in loop.sections:
            if section.interval.is_single_level_static():
                continue
            writes: Dict[str, List[ir.FieldAccess]] = {}
            reads: Dict[str, List[ir.FieldAccess]] = {}
            for stmt in section.body:
                for w in _stmt_writes(stmt):
                    writes.setdefault(w.name, []).append(w)
                for r in _stmt_reads(stmt):
                    reads.setdefault(r.name, []).append(r)
            for name, w_accs in writes.items():
                for acc in reads.get(name, []) + [
                    a for a in w_accs[1:]
                ]:  # differing write offsets race too
                    for w in w_accs:
                        w_off = w.offset
                        r_off = acc.offset
                        if isinstance(w_off, (ir.VariableKOffset, ir.AbsoluteKIndex)) or isinstance(
                            r_off, (ir.VariableKOffset, ir.AbsoluteKIndex)
                        ):
                            raise GTScriptValidationError(
                                "Not allowed to write and read with VariableKOffset "
                                f"and/or AbsoluteKIndex in PARALLEL loops: '{name}'"
                            )
                        if w_off.k != r_off.k:
                            raise GTScriptValidationError(
                                "Not allowed to write and read with k-offsets in "
                                f"PARALLEL loops: '{name}'"
                            )


def _validate_api_write_extents(stencil: ir.Stencil) -> None:
    """API fields must be written with zero horizontal extent: writing an
    API field and reading it with an offset anywhere in the stencil would
    require writing outside the compute domain (gtir_to_oir.py:19-47)."""
    from gt4py_tpu_torch.cartesian.analysis import compute_extents

    extents = compute_extents(stencil)
    written = {
        w.name
        for node in ir.walk_values(stencil.vertical_loops)
        if isinstance(node, ir.Assign)
        for w in [node.target]
    }
    for name in written:
        if name in stencil.temp_decls:
            continue
        ext = extents.field_extent(name)
        if ext.i != (0, 0) or ext.j != (0, 0):
            raise GTScriptValidationError(
                f"Stencil produces an extended write of API field '{name}' "
                f"(extent {ext.i}, {ext.j}); this is a memory race."
            )


def _validate_definitive_assignment(stencil: ir.Stencil) -> None:
    """Reject reads of potentially-unassigned temporaries
    (gtir_definitive_assignment_analysis.py:16-73)."""
    assigned: Set[str] = set(stencil.field_decls)

    def walk_stmts(stmts: List[ir.Stmt], assigned: Set[str]) -> Set[str]:
        for stmt in stmts:
            if isinstance(stmt, ir.Assign):
                _check_reads(stmt, assigned)
                assigned = assigned | {stmt.target.name}
            elif isinstance(stmt, ir.If):
                _check_expr(stmt.cond, assigned)
                a1 = walk_stmts(stmt.body, set(assigned))
                a2 = walk_stmts(stmt.orelse, set(assigned))
                assigned = a1 & a2
            elif isinstance(stmt, ir.While):
                _check_expr(stmt.cond, assigned)
                walk_stmts(stmt.body, set(assigned))
            elif isinstance(stmt, ir.HorizontalRestriction):
                # conditional on position: writes are not definitive
                walk_stmts(stmt.body, set(assigned))
        return assigned

    def _check_reads(stmt: ir.Assign, assigned: Set[str]) -> None:
        _check_expr(stmt.value, assigned)
        for d in stmt.target.data_index:
            _check_expr(d, assigned)

    def _check_expr(expr: ir.Expr, assigned: Set[str]) -> None:
        for acc in ir.field_accesses(expr):
            if acc.name in stencil.temp_decls and acc.name not in assigned:
                raise GTScriptValidationError(
                    f"Read of potentially-unassigned temporary '{acc.name}'"
                )

    current: Set[str] = set(stencil.field_decls)
    for loop in stencil.vertical_loops:
        for section in loop.sections:
            current = walk_stmts(section.body, current)
