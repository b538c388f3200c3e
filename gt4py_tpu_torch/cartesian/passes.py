"""IR-to-IR optimization passes.

``inline_parallel_temporaries`` is the TPU analog of the reference's
OnTheFlyMerging / recompute-instead-of-store stage fusion
(reference: gtc/passes/oir_optimizations/horizontal_execution_merging.py:135):
a temporary assigned exactly once, unmasked, in a PARALLEL section and only
read afterwards with static Cartesian offsets is replaced by its shifted
right-hand side.  Values are bitwise identical (the same expression tree is
evaluated at the same point); the win is that XLA can then fuse the whole
section into one elementwise kernel instead of materializing halo-extended
temporaries in HBM.
"""

from __future__ import annotations

import copy

import numpy as np
from typing import Dict, List, Optional, Set, Tuple

from gt4py_tpu_torch.cartesian import ir

#: do not inline when the temporary is read more than this many times and
#: its definition is large (recompute cost guard)
_MAX_READS = 6
_MAX_NODES = 120


def _shift_expr(expr: ir.Expr, off: Tuple[int, int, int]) -> Optional[ir.Expr]:
    """Deep-copy ``expr`` with every access shifted by ``off``; None if the
    expression cannot be shifted (variable-K, absolute-K)."""
    di, dj, dk = off
    expr = copy.deepcopy(expr)
    # frontends may alias one node into several positions and deepcopy
    # preserves that: the mutating shift must apply ONCE per object or
    # aliased accesses get double-shifted (same hazard class as
    # jax_backend._rewrite_section_for_planes, bridge fuzz seed 10008)
    seen: set = set()
    for node in ir.walk_values(expr):
        if isinstance(node, ir.FieldAccess):
            if id(node) in seen:
                continue
            seen.add(id(node))
            o = node.offset
            if not isinstance(o, ir.CartesianOffset):
                return None
            node.offset = ir.CartesianOffset(o.i + di, o.j + dj, o.k + dk)
        elif isinstance(node, ir.AxisPosition):
            # positions shift with the evaluation point; rewrite in place
            # via wrapping is handled by the caller check below
            return None
    return expr


def _expr_size(expr: ir.Expr) -> int:
    return len(ir.walk_values(expr))


def rename_reassigned_temporaries(stencil: ir.Stencil) -> ir.Stencil:
    """SSA-style renaming: a temporary assigned several times at the top
    level of PARALLEL sections gets a fresh name per assignment (each read
    binds to the most recent definition).  This unblocks
    ``inline_parallel_temporaries`` for patterns like the reference hdiff's
    reused ``res`` scratch variable.  In-place on a copy; bitwise neutral.
    """
    stencil = copy.deepcopy(stencil)
    for loop in stencil.vertical_loops:
        if loop.loop_order != ir.LoopOrder.PARALLEL:
            continue
        for section in loop.sections:
            # only rename temps whose every assignment is top-level in this
            # section and which are not used in any other section
            counts: Dict[str, int] = {}
            top_level: Dict[str, int] = {}
            for stmt in section.body:
                for n in ir.walk_values(stmt):
                    if isinstance(n, ir.Assign):
                        counts[n.target.name] = counts.get(n.target.name, 0) + 1
                        if n is stmt:
                            top_level[n.target.name] = top_level.get(n.target.name, 0) + 1
            outside: Set[str] = set()
            for loop2 in stencil.vertical_loops:
                for sec2 in loop2.sections:
                    if sec2 is section:
                        continue
                    for n in ir.walk_values(sec2.body):
                        if isinstance(n, ir.FieldAccess):
                            outside.add(n.name)
            eligible = {
                name
                for name in counts
                if name in stencil.temp_decls
                and counts[name] > 1
                and counts[name] == top_level.get(name, 0)
                and name not in outside
            }
            if not eligible:
                continue
            current: Dict[str, str] = {}
            version: Dict[str, int] = {}
            for stmt in section.body:
                # reads (including inside nested statements) see the
                # current version
                for n in ir.walk_values(stmt):
                    if (
                        isinstance(n, ir.FieldAccess)
                        and n.name in current
                        and not (isinstance(stmt, ir.Assign) and n is stmt.target)
                    ):
                        n.name = current[n.name]
                if isinstance(stmt, ir.Assign) and stmt.target.name in eligible:
                    base = stmt.target.name
                    version[base] = version.get(base, 0) + 1
                    if version[base] == 1:
                        new = base  # first definition keeps the name
                    else:
                        new = f"{base}__ssa{version[base]}"
                        decl = stencil.temp_decls[base]
                        stencil.temp_decls[new] = ir.FieldDecl(
                            name=new,
                            dtype=decl.dtype,
                            dimensions=decl.dimensions,
                            data_dims=decl.data_dims,
                            is_api=False,
                        )
                    stmt.target.name = new
                    current[base] = new
    return stencil


def inline_parallel_temporaries(stencil: ir.Stencil) -> ir.Stencil:
    """Return a copy of ``stencil`` with eligible temporaries inlined."""
    stencil = rename_reassigned_temporaries(stencil)

    # global access statistics
    assign_sites: Dict[str, List[Tuple[int, int, int, bool]]] = {}
    for li, loop in enumerate(stencil.vertical_loops):
        for si, section in enumerate(loop.sections):
            for pos, stmt in enumerate(section.body):
                for node in ir.walk_values(stmt):
                    if isinstance(node, ir.Assign):
                        top_level = stmt is node
                        assign_sites.setdefault(node.target.name, []).append(
                            (li, si, pos, top_level)
                        )

    for li, loop in enumerate(stencil.vertical_loops):
        if loop.loop_order != ir.LoopOrder.PARALLEL:
            continue
        for si, section in enumerate(loop.sections):
            changed = True
            while changed:
                changed = False
                for pos, stmt in enumerate(section.body):
                    if not isinstance(stmt, ir.Assign):
                        continue
                    name = stmt.target.name
                    if name not in stencil.temp_decls:
                        continue
                    sites = assign_sites.get(name, [])
                    if len(sites) != 1 or sites[0] != (li, si, pos, True):
                        continue
                    if not isinstance(stmt.target.offset, ir.CartesianOffset):
                        continue
                    to = stmt.target.offset
                    if to.i or to.j or to.k or stmt.target.data_index:
                        continue
                    if _expr_size(stmt.value) > _MAX_NODES:
                        continue
                    if any(
                        isinstance(n, ir.AxisPosition)
                        for n in ir.walk_values(stmt.value)
                    ):
                        continue
                    # reads of fields used in the RHS must not be overwritten
                    # later in this section (value-change hazard)
                    rhs_fields = {
                        a.name
                        for a in ir.walk_values(stmt.value)
                        if isinstance(a, ir.FieldAccess)
                    }
                    hazard = False
                    for later in section.body[pos + 1 :]:
                        for n in ir.walk_values(later):
                            if isinstance(n, ir.Assign) and n.target.name in rhs_fields:
                                hazard = True
                    if hazard:
                        continue
                    # all reads must be in this section after the assignment,
                    # with plain Cartesian offsets
                    reads: List[ir.FieldAccess] = []
                    ok = True
                    for li2, loop2 in enumerate(stencil.vertical_loops):
                        for si2, sec2 in enumerate(loop2.sections):
                            for pos2, stmt2 in enumerate(sec2.body):
                                for acc in ir.walk_values(stmt2):
                                    if (
                                        isinstance(acc, ir.FieldAccess)
                                        and acc.name == name
                                        and acc is not stmt.target
                                    ):
                                        if (li2, si2) != (li, si) or pos2 <= pos:
                                            ok = False
                                        elif not isinstance(
                                            acc.offset, ir.CartesianOffset
                                        ) or acc.data_index:
                                            ok = False
                                        else:
                                            reads.append(acc)
                    if not ok or not reads:
                        continue
                    if len(reads) > _MAX_READS and _expr_size(stmt.value) > 20:
                        continue
                    # substitute every read with the shifted definition
                    replacements = {}
                    for acc in reads:
                        o = acc.offset
                        shifted = _shift_expr(stmt.value, (o.i, o.j, o.k))
                        if shifted is None:
                            ok = False
                            break
                        replacements[id(acc)] = shifted
                    if not ok:
                        continue
                    for stmt2 in section.body[pos + 1 :]:
                        _replace_accesses(stmt2, replacements)
                    # drop the definition and the temporary
                    section.body.pop(pos)
                    del stencil.temp_decls[name]
                    assign_sites.pop(name, None)
                    # re-index assignment sites after the removal
                    for sites2 in assign_sites.values():
                        for k2, (l2, s2, p2, t2) in enumerate(sites2):
                            if (l2, s2) == (li, si) and p2 > pos:
                                sites2[k2] = (l2, s2, p2 - 1, t2)
                    changed = True
                    break
    return stencil


def _replace_accesses(stmt: ir.Stmt, replacements: Dict[int, ir.Expr]) -> None:
    """Replace FieldAccess nodes (by id) inside expression positions."""

    def rewrite(expr: ir.Expr) -> ir.Expr:
        if id(expr) in replacements:
            return replacements[id(expr)]
        for f in getattr(expr, "__dataclass_fields__", {}):
            v = getattr(expr, f)
            if isinstance(v, ir.Expr):
                setattr(expr, f, rewrite(v))
            elif isinstance(v, (list, tuple)):
                new = [rewrite(x) if isinstance(x, ir.Expr) else x for x in v]
                setattr(expr, f, type(v)(new))
            elif isinstance(v, (ir.VariableKOffset, ir.AbsoluteKIndex)):
                v.k = rewrite(v.k)
        return expr

    if isinstance(stmt, ir.Assign):
        stmt.value = rewrite(stmt.value)
        stmt.target.data_index = tuple(rewrite(d) for d in stmt.target.data_index)
        if isinstance(stmt.target.offset, (ir.VariableKOffset, ir.AbsoluteKIndex)):
            stmt.target.offset.k = rewrite(stmt.target.offset.k)
    elif isinstance(stmt, ir.If):
        stmt.cond = rewrite(stmt.cond)
        for s in stmt.body + stmt.orelse:
            _replace_accesses(s, replacements)
    elif isinstance(stmt, ir.While):
        stmt.cond = rewrite(stmt.cond)
        for s in stmt.body:
            _replace_accesses(s, replacements)
    elif isinstance(stmt, ir.HorizontalRestriction):
        for s in stmt.body:
            _replace_accesses(s, replacements)


def component_name(name: str, idx: Tuple[int, ...]) -> str:
    """Name of the scalar component field for data index ``idx``."""
    return name + "__c" + "_".join(str(i) for i in idx)


def split_data_dims(stencil: ir.Stencil) -> Optional[ir.Stencil]:
    """Rewrite data-dims fields into per-component scalar fields.

    TPU-first data-dims handling: a trailing data dimension would become
    the Mosaic lane dimension of every tile (tiny, unaligned), so the
    pallas backend instead splits each (K, I, J, *dd) buffer into dd
    separate (K, I, J) component buffers outside the kernel and rewrites
    every statically-indexed access to the matching component field
    (the unroll analog of the reference's UnrollVectorAssignments,
    frontend/defir_to_gtir.py:123 -- applied at the backend boundary,
    not the frontend).  Per-point (dynamic) indices expand to component
    selects: reads become nested ternaries over the components, writes
    one masked assign per reachable component (modulo wrap, the
    executors' dynamic-index semantics).  Returns None only when the
    stencil has no data dims.
    """
    import itertools

    from gt4py_tpu_torch.cartesian.analysis import try_static_int

    split: Dict[str, ir.FieldDecl] = {
        name: decl
        for decls in (stencil.field_decls, stencil.temp_decls)
        for name, decl in decls.items()
        if decl.data_dims
    }
    if not split:
        return None

    for node in ir.walk_values(stencil.vertical_loops):
        if not (isinstance(node, ir.FieldAccess) and node.name in split):
            continue
        if len(node.data_index) != len(split[node.name].data_dims):
            return None

    out = copy.deepcopy(stencil)

    def _combo_parts(acc: ir.FieldAccess):
        """(combos, conds): every component tuple the access can hit and
        the per-combo selection condition (None when fully static).
        Dynamic axes select by ``expr % d == v`` (modulo wrap, matching
        the executors' dynamic-write semantics)."""
        dims = split[acc.name].data_dims
        axis_opts = []
        for e, d in zip(acc.data_index, dims):
            v = try_static_int(e)
            if v is not None:
                axis_opts.append([(v % d, None)])
            else:
                axis_opts.append(
                    [
                        (
                            comp,
                            ir.BinaryOp(
                                op=ir.BinaryOperator.EQ,
                                left=ir.BinaryOp(
                                    op=ir.BinaryOperator.MOD,
                                    left=copy.deepcopy(e),
                                    right=ir.Literal(value=d),
                                ),
                                right=ir.Literal(value=comp),
                            ),
                        )
                        for comp in range(d)
                    ]
                )
        combos = []
        for parts in itertools.product(*axis_opts):
            idx = tuple(p[0] for p in parts)
            conds = [p[1] for p in parts if p[1] is not None]
            cond = None
            for c in conds:
                cond = c if cond is None else ir.BinaryOp(
                    op=ir.BinaryOperator.AND, left=cond, right=c
                )
            combos.append((idx, cond))
        return combos

    def rewrite_expr(node: ir.Expr) -> ir.Expr:
        # rewrite children first (incl. dynamic-K offset expressions and
        # the data-index expressions themselves)
        for f in getattr(node, "__dataclass_fields__", {}):
            v = getattr(node, f)
            if isinstance(v, ir.Expr):
                setattr(node, f, rewrite_expr(v))
            elif isinstance(v, (list, tuple)):
                setattr(
                    node, f,
                    type(v)(
                        rewrite_expr(x) if isinstance(x, ir.Expr) else x for x in v
                    ),
                )
            elif isinstance(v, (ir.VariableKOffset, ir.AbsoluteKIndex)):
                v.k = rewrite_expr(v.k)
        if isinstance(node, ir.FieldAccess) and node.name in split:
            combos = _combo_parts(node)
            if len(combos) == 1 and combos[0][1] is None:
                node.name = component_name(node.name, combos[0][0])
                node.data_index = ()
                return node
            # dynamic read: nested component select (last combo = else leaf)
            expr: ir.Expr = ir.FieldAccess(
                name=component_name(node.name, combos[-1][0]), offset=node.offset
            )
            for idx, cond in reversed(combos[:-1]):
                expr = ir.TernaryOp(
                    cond=cond,
                    true_expr=ir.FieldAccess(
                        name=component_name(node.name, idx),
                        offset=copy.deepcopy(node.offset),
                    ),
                    false_expr=expr,
                )
            return expr
        return node

    def rewrite_stmts(stmts: List[ir.Stmt]) -> List[ir.Stmt]:
        new: List[ir.Stmt] = []
        for stmt in stmts:
            if isinstance(stmt, ir.Assign):
                stmt.value = rewrite_expr(stmt.value)
                t = stmt.target
                if t.name in split:
                    t.data_index = tuple(rewrite_expr(e) for e in t.data_index)
                    combos = _combo_parts(t)
                    if len(combos) == 1 and combos[0][1] is None:
                        t.name = component_name(t.name, combos[0][0])
                        t.data_index = ()
                        new.append(stmt)
                        continue
                    # dynamic component write: one masked assign per
                    # component the index can hit (one-hot semantics)
                    for idx, cond in combos:
                        new.append(
                            ir.If(
                                cond=copy.deepcopy(cond),
                                body=[
                                    ir.Assign(
                                        target=ir.FieldAccess(
                                            name=component_name(t.name, idx),
                                            offset=copy.deepcopy(t.offset),
                                        ),
                                        value=copy.deepcopy(stmt.value),
                                    )
                                ],
                                orelse=[],
                            )
                        )
                    continue
                new.append(stmt)
            elif isinstance(stmt, ir.If):
                stmt.cond = rewrite_expr(stmt.cond)
                stmt.body = rewrite_stmts(stmt.body)
                stmt.orelse = rewrite_stmts(stmt.orelse)
                new.append(stmt)
            elif isinstance(stmt, ir.While):
                stmt.cond = rewrite_expr(stmt.cond)
                stmt.body = rewrite_stmts(stmt.body)
                new.append(stmt)
            elif isinstance(stmt, ir.HorizontalRestriction):
                stmt.body = rewrite_stmts(stmt.body)
                new.append(stmt)
            else:
                new.append(stmt)
        return new

    for loop in out.vertical_loops:
        for section in loop.sections:
            section.body = rewrite_stmts(section.body)

    def expand(decls: Dict[str, ir.FieldDecl]) -> Dict[str, ir.FieldDecl]:
        new: Dict[str, ir.FieldDecl] = {}
        for name, decl in decls.items():
            if not decl.data_dims:
                new[name] = decl
                continue
            for idx in itertools.product(*(range(d) for d in decl.data_dims)):
                cname = component_name(name, idx)
                new[cname] = ir.FieldDecl(
                    name=cname,
                    dtype=decl.dtype,
                    dimensions=decl.dimensions,
                    data_dims=(),
                    is_api=decl.is_api,
                )
        return new

    out.field_decls = expand(out.field_decls)
    out.temp_decls = expand(out.temp_decls)
    new_params = []
    for p in out.api_params:
        if p.is_field and p.name in split:
            for idx in itertools.product(
                *(range(d) for d in split[p.name].data_dims)
            ):
                new_params.append(
                    ir.ApiParam(
                        name=component_name(p.name, idx),
                        is_field=True,
                        is_keyword=p.is_keyword,
                        optional=p.optional,
                    )
                )
        else:
            new_params.append(p)
    out.api_params = new_params
    return out


# --------------------------------------------------------------------------- #
# K-blocking (reference analog: FillFlushToLocalKCaches,
# gtc/passes/oir_optimizations/caches.py:256 -- serial-K state is carried
# through per-block fills/flushes instead of whole-column residency)
# --------------------------------------------------------------------------- #


def _rebase_k_expr(e: ir.Expr, b0: int, dK: int, idt) -> ir.Expr:
    """Rewrite ``e`` (in place where possible) so block-relative evaluation
    over K sub-domain [b0, b0+KB) reproduces global-domain semantics:
    ``AxisPosition K`` gains +b0 and ``AxisSize K`` freezes to the global
    dK (the block call's domain K is only the block size)."""
    import dataclasses

    if isinstance(e, ir.AxisSize) and e.axis == "K":
        return ir.Literal(value=int(dK), dtype=idt)
    if isinstance(e, ir.AxisPosition) and e.axis == "K":
        if b0 == 0:
            return e
        return ir.BinaryOp(
            op=ir.BinaryOperator.ADD,
            left=e,
            right=ir.Literal(value=int(b0), dtype=idt),
        )
    if not dataclasses.is_dataclass(e) or isinstance(e, type):
        return e
    for f in dataclasses.fields(e):
        v = getattr(e, f.name)
        if isinstance(v, ir.Expr):
            setattr(e, f.name, _rebase_k_expr(v, b0, dK, idt))
        elif isinstance(v, (ir.VariableKOffset, ir.AbsoluteKIndex)):
            v.k = _rebase_k_expr(v.k, b0, dK, idt)
        elif isinstance(v, tuple):
            setattr(
                e,
                f.name,
                tuple(
                    _rebase_k_expr(x, b0, dK, idt) if isinstance(x, ir.Expr) else x
                    for x in v
                ),
            )
        elif isinstance(v, list):
            for i, x in enumerate(v):
                if isinstance(x, ir.Expr):
                    v[i] = _rebase_k_expr(x, b0, dK, idt)
    return e


def _rebase_k_stmt(s: ir.Stmt, b0: int, dK: int, idt) -> None:
    if isinstance(s, ir.Assign):
        _rebase_k_expr(s.target, b0, dK, idt)
        s.value = _rebase_k_expr(s.value, b0, dK, idt)
    elif isinstance(s, ir.If):
        s.cond = _rebase_k_expr(s.cond, b0, dK, idt)
        for c in s.body + s.orelse:
            _rebase_k_stmt(c, b0, dK, idt)
    elif isinstance(s, ir.While):
        s.cond = _rebase_k_expr(s.cond, b0, dK, idt)
        for c in s.body:
            _rebase_k_stmt(c, b0, dK, idt)
    elif isinstance(s, ir.HorizontalRestriction):
        for c in s.body:
            _rebase_k_stmt(c, b0, dK, idt)


def clip_stencil_to_k_block(
    stencil: ir.Stencil, b0: int, b1: int, dK: int, scalars=None
) -> Optional[ir.Stencil]:
    """A stencil that, run over domain K size ``b1 - b0``, executes exactly
    the [b0, b1) K sub-range of ``stencil`` run over ``dK`` levels.

    Sections are statically clipped and rebased to START-relative block
    coordinates; K positions/sizes in expressions are rebased to global
    coordinates.  Returns None when no section intersects the block.
    Requires static interval bounds (callers check ``is_runtime``)."""
    from gt4py_tpu_torch.cartesian.analysis import default_int_dtype

    idt = default_int_dtype(stencil)
    new_loops = []
    for loop in stencil.vertical_loops:
        sections = []
        for sec in loop.sections:
            k0, k1 = sec.interval.resolve(dK, scalars)
            k0, k1 = max(k0, 0), min(k1, dK)
            c0, c1 = max(k0, b0), min(k1, b1)
            if c1 <= c0:
                continue
            body = copy.deepcopy(sec.body)
            for stmt in body:
                _rebase_k_stmt(stmt, b0, dK, idt)
            sections.append(
                ir.VerticalSection(
                    # END-relative end bound: reads above the section end
                    # must count toward the block's upper K halo (the
                    # carry window into the not-yet/already-computed next
                    # block), which compute_k_boundary only credits for
                    # END-level bounds
                    interval=ir.Interval(
                        ir.AxisBound.start(c0 - b0), ir.AxisBound.end(c1 - b1)
                    ),
                    body=body,
                )
            )
        if sections:
            new_loops.append(ir.VerticalLoop(loop.loop_order, sections))
    if not new_loops:
        return None
    out = copy.copy(stencil)
    out.name = f"{stencil.name}__kb{b0}_{b1}"
    out.vertical_loops = new_loops
    out.field_decls = dict(stencil.field_decls)
    out.temp_decls = dict(stencil.temp_decls)
    return out


def split_serial_passes(stencil: ir.Stencil):
    """Split into K-blockable pass units, with K-carried and cross-pass
    temporaries promoted to plain (non-API) fields so each pass can be
    K-blocked independently (the promoted buffers are the HBM fill/flush
    targets, exactly the reference K-cache fill/flush role).

    Pass units: serial loops stay whole (the per-plane statement
    interleaving inside a block matches the oracle's plane order, and
    cross-block carries ride the threaded buffers).  PARALLEL loops split
    per STATEMENT: the oracle evaluates each statement over the FULL
    domain before the next, so a block-local interleaving would let a
    K-offset read of a sibling statement's output see stale planes at
    every block boundary -- each statement must complete all K blocks
    before the next starts.

    Promotion rule (conservative): a temporary is promoted unless every
    access to it lives in ONE pass unit with zero K offsets -- only then
    is its lifetime provably block-local.

    Returns ``(pass_stencils, promoted_names)``."""
    units: List[ir.VerticalLoop] = []
    for loop in stencil.vertical_loops:
        if loop.loop_order == ir.LoopOrder.PARALLEL:
            for sec in loop.sections:
                for stmt in sec.body:
                    units.append(
                        ir.VerticalLoop(
                            loop.loop_order,
                            [
                                ir.VerticalSection(
                                    interval=sec.interval,
                                    body=[copy.deepcopy(stmt)],
                                )
                            ],
                        )
                    )
        else:
            units.append(copy.deepcopy(loop))

    # classify temp usage at unit granularity
    temp_units: Dict[str, Set[int]] = {}
    temp_k_offset: Set[str] = set()
    for ui, unit in enumerate(units):
        for sec in unit.sections:
            for node in ir.walk_values(sec.body):
                if isinstance(node, ir.FieldAccess) and node.name in stencil.temp_decls:
                    temp_units.setdefault(node.name, set()).add(ui)
                    off = node.offset
                    if not isinstance(off, ir.CartesianOffset) or off.k != 0:
                        temp_k_offset.add(node.name)

    promoted = {
        name
        for name in stencil.temp_decls
        if len(temp_units.get(name, ())) > 1 or name in temp_k_offset
    }

    passes_out = []
    for ui, unit in enumerate(units):
        sub = copy.copy(stencil)
        sub.name = f"{stencil.name}__pass{ui}"
        sub.vertical_loops = [unit]
        sub.field_decls = dict(stencil.field_decls)
        sub.temp_decls = {}
        for name, decl in stencil.temp_decls.items():
            if ui not in temp_units.get(name, ()):
                continue
            if name in promoted:
                sub.field_decls[name] = ir.FieldDecl(
                    name=name,
                    dtype=decl.dtype,
                    dimensions=decl.dimensions,
                    data_dims=decl.data_dims,
                    is_api=False,
                )
            else:
                sub.temp_decls[name] = decl
        passes_out.append(sub)
    return passes_out, promoted


# --------------------------------------------------------------------------- #
# Serializing PARALLEL K (mixed-stencil VMEM rescue)
# --------------------------------------------------------------------------- #


def serialize_parallel_k(stencil: ir.Stencil) -> Optional[ir.Stencil]:
    """PARALLEL vertical loops rewritten to FORWARD (plane-by-plane serial
    evaluation).

    Bitwise-identical to the parallel statement semantics whenever no field
    written inside a PARALLEL loop is read *in that same loop* at a nonzero
    (or non-Cartesian) K offset: serializing only over K keeps each plane's
    statement sequence complete over the full IJ domain, so horizontal
    reads of same-loop outputs still see post-statement values, and K-offset
    reads only ever target fields the loop never writes.  The GTIR race
    rules already forbid the unsafe pattern for frontend stencils
    (reference: src/gt4py/cartesian/gtc/gtir.py:222-293); the check here
    re-verifies it for raw-IR callers (the next bridge, fuzzers).

    Purpose: a mixed PARALLEL+serial stencil whose mode-B pallas plan
    cannot fit VMEM (whole-column Mosaic values for the parallel sections)
    re-plans with every loop serial -- values become per-plane and most
    temporaries become plane-local scratch (see
    :func:`plane_local_temps`), e.g. the fused whole-dycore kernel
    (models.dycore.make_dycore_fused).

    Returns None when there is nothing to serialize or a loop is unsafe
    (including runtime interval bounds, which the serial kernel path does
    not resolve statically).
    """
    has_parallel = any(
        vl.loop_order == ir.LoopOrder.PARALLEL for vl in stencil.vertical_loops
    )
    if not has_parallel:
        return None
    for loop in stencil.vertical_loops:
        for sec in loop.sections:
            if sec.interval.is_runtime:
                return None
        if loop.loop_order != ir.LoopOrder.PARALLEL:
            continue
        written = {
            n.target.name
            for n in ir.walk_values(loop.sections)
            if isinstance(n, ir.Assign)
        }
        for acc in ir.field_accesses(loop.sections):
            if acc.name not in written:
                continue
            off = acc.offset
            if not isinstance(off, ir.CartesianOffset) or off.k != 0:
                return None
    out = copy.deepcopy(stencil)
    out.name = f"{stencil.name}__serK"
    for loop in out.vertical_loops:
        if loop.loop_order == ir.LoopOrder.PARALLEL:
            loop.loop_order = ir.LoopOrder.FORWARD
    return out


def plane_local_temps(stencil: ir.Stencil) -> frozenset:
    """Temporaries whose kernel scratch can be a SINGLE K plane.

    A temp qualifies when every access sits in a *serial* vertical loop at
    a zero Cartesian K offset, and every section touching it WRITES it
    first -- the first top-level statement of the section that mentions
    the temp must be an unconditional ``Assign`` to it (zero offset, no
    data index) whose RHS does not read it.  Plane-by-plane evaluation
    then always initializes the plane before any read, so reusing one
    plane of scratch across K is invisible: stale content from the
    previous plane can never be observed (the write statement's compute
    extent covers every downstream read window by extent analysis).

    This is the serial-loop complement of the SSA value temps (which
    require PARALLEL single-assign): after :func:`serialize_parallel_k`
    the bulk of a stencil's temporaries drop from whole-K VMEM arrays to
    one plane each, which is what lets VMEM-tight fused kernels plan at
    all.  TPU analog of the reference's LocalTemporariesToScalars
    (src/gt4py/cartesian/gtc/passes/oir_optimizations/temporaries.py:97).
    """
    cand = {n for n, d in stencil.temp_decls.items() if not d.data_dims}
    if not cand:
        return frozenset()
    for loop in stencil.vertical_loops:
        parallel = loop.loop_order == ir.LoopOrder.PARALLEL
        for sec in loop.sections:
            first_touch: Dict[str, ir.Stmt] = {}
            for stmt in sec.body:
                names_here = set()
                for acc in ir.field_accesses(stmt):
                    if acc.name not in cand:
                        continue
                    names_here.add(acc.name)
                    if parallel:
                        cand.discard(acc.name)
                        continue
                    off = acc.offset
                    if not isinstance(off, ir.CartesianOffset) or off.k != 0:
                        cand.discard(acc.name)
                for name in names_here:
                    first_touch.setdefault(name, stmt)
            for name, stmt in first_touch.items():
                if name not in cand:
                    continue
                ok = (
                    isinstance(stmt, ir.Assign)
                    and stmt.target.name == name
                    and isinstance(stmt.target.offset, ir.CartesianOffset)
                    and (stmt.target.offset.i, stmt.target.offset.j,
                         stmt.target.offset.k) == (0, 0, 0)
                    and not stmt.target.data_index
                    and not any(
                        acc.name == name
                        for acc in ir.field_accesses(stmt.value)
                    )
                )
                if not ok:
                    cand.discard(name)
    return frozenset(cand)


# --------------------------------------------------------------------------- #
# 16-bit floats as a STORAGE format (f32 statement compute)
# --------------------------------------------------------------------------- #


def widen_f16_compute(stencil: ir.Stencil) -> ir.Stencil:
    """Canonicalize bf16/f16 stencils to mixed-precision semantics:
    16-bit values live in HBM/buffers, every statement COMPUTES in f32
    (one widen per 16-bit read, one round per 16-bit store).

    This defines the cartesian DSL's sub-f32 float semantics (applied to
    every backend identically in StencilBuilder, so the numpy oracle IS
    this spec).  Motivation is both numeric (f32 accumulation instead of
    per-op bf16 rounding) and TPU-mechanical: Mosaic has no 16-bit
    scalar-core arith / cmpf / rolls / transcendentals, so per-op bf16
    kernels paid widen+round around nearly every op -- halved DMA bytes
    bought nothing (r3 bench: bf16 dycore 3.03 ms vs f32 2.01).  With
    storage-format semantics the kernel body is pure f32 (temps resolve
    to f32), and 16-bit stays where it pays: the HBM traffic.

    User-visible rounding points are preserved: explicit ``astype`` to a
    16-bit dtype still rounds there (then widens again), and every store
    to a 16-bit field rounds once.
    """
    import copy

    from gt4py_tpu_torch.core.definitions import F16_DTYPES

    f16_decls = {
        n
        for n, d in list(stencil.field_decls.items())
        if d.dtype is not None and np.dtype(d.dtype) in F16_DTYPES
    }
    f16_scalars = {
        n
        for n, d in stencil.scalar_decls.items()
        if d.dtype is not None and np.dtype(d.dtype) in F16_DTYPES
    }
    # temporaries with already-resolved 16-bit dtypes become f32 holders;
    # unresolved ones will infer f32 from the rewritten expressions
    f16_temps = {
        n
        for n, d in stencil.temp_decls.items()
        if d.dtype is not None and np.dtype(d.dtype) in F16_DTYPES
    }
    if not (f16_decls or f16_scalars or f16_temps):
        return stencil

    stencil = copy.deepcopy(stencil)
    F32 = np.dtype(np.float32)
    for n in f16_temps:
        stencil.temp_decls[n].dtype = F32

    def widen(expr: ir.Expr) -> ir.Expr:
        if isinstance(expr, ir.FieldAccess):
            expr.data_index = tuple(widen(d) for d in expr.data_index)
            if isinstance(expr.offset, (ir.VariableKOffset, ir.AbsoluteKIndex)):
                expr.offset = type(expr.offset)(k=widen(expr.offset.k))
            if expr.name in f16_decls:
                return ir.Cast(dtype=F32, expr=expr)
            return expr
        if isinstance(expr, ir.ScalarAccess):
            if expr.name in f16_scalars:
                return ir.Cast(dtype=F32, expr=expr)
            return expr
        if isinstance(expr, ir.Literal):
            if expr.dtype is not None and np.dtype(expr.dtype) in F16_DTYPES:
                # the literal was already rounded to 16 bits at parse
                # time; widening is exact
                expr.dtype = F32
            return expr
        if isinstance(expr, ir.Cast):
            expr.expr = widen(expr.expr)
            if np.dtype(expr.dtype) in F16_DTYPES:
                # user-requested rounding point: round, then continue f32
                return ir.Cast(dtype=F32, expr=expr)
            return expr
        if isinstance(expr, ir.UnaryOp):
            expr.expr = widen(expr.expr)
            return expr
        if isinstance(expr, ir.BinaryOp):
            expr.left = widen(expr.left)
            expr.right = widen(expr.right)
            return expr
        if isinstance(expr, ir.TernaryOp):
            expr.cond = widen(expr.cond)
            expr.true_expr = widen(expr.true_expr)
            expr.false_expr = widen(expr.false_expr)
            return expr
        if isinstance(expr, ir.NativeFuncCall):
            expr.args = [widen(a) for a in expr.args]
            return expr
        return expr  # AxisPosition / AxisSize / anything value-free

    def rewrite_stmt(stmt: ir.Stmt) -> None:
        if isinstance(stmt, ir.Assign):
            v = widen(stmt.value)
            stmt.target.data_index = tuple(
                widen(d) for d in stmt.target.data_index
            )
            if isinstance(
                stmt.target.offset, (ir.VariableKOffset, ir.AbsoluteKIndex)
            ):
                stmt.target.offset = type(stmt.target.offset)(
                    k=widen(stmt.target.offset.k)
                )
            if stmt.target.name in f16_decls:
                # one rounding point per 16-bit store (all backends cast
                # identically; explicit so masked writes stay typed)
                decl = stencil.field_decls[stmt.target.name]
                v = ir.Cast(dtype=np.dtype(decl.dtype), expr=v)
            stmt.value = v
        elif isinstance(stmt, (ir.If, ir.While)):
            stmt.cond = widen(stmt.cond)
            for s in stmt.body:
                rewrite_stmt(s)
            for s in getattr(stmt, "orelse", []):
                rewrite_stmt(s)
        elif isinstance(stmt, ir.HorizontalRestriction):
            for s in stmt.body:
                rewrite_stmt(s)

    for loop in stencil.vertical_loops:
        for section in loop.sections:
            for stmt in section.body:
                rewrite_stmt(stmt)
    return stencil
