"""Phased calls on DistributedFields: a stencil that a rank cannot compute
from one halo exchange before the call runs in phases, with an exchange
between them.

A rank computes its part of the global domain from its block grown by the
stencil's halo.  One exchange before the call serves wherever the extent
analysis grows each statement so that the rank computes itself every
value its part reads.  Two reads escape that (``cross_rank_read``): a
``while`` that reads at a horizontal offset a field it writes, whose next
iteration reads what the neighbour wrote in this one, and a FORWARD or
BACKWARD loop that reads another level of a field it writes at points its
writer does not compute.  ``if`` statements and horizontal regions with
such reads are split first (``passes.split_compound_statements``, as the
single-device ``"cuda"`` build does), after which the extent analysis
serves them.  The plan (``plan``) is a list of steps:

- ``Once``: one stencil, run once;
- ``Levels``: a serial loop, run one level at a time (section by section,
  in the loop's order), each level's writes exchanged before the next;
- ``Iterate``: one ``while``, run one iteration at a time on every rank:
  ``a = cond`` where the loop starts (under its enclosing regions and
  conditions), then per iteration the body under ``if a:`` and
  ``a = a and cond``, the written fields exchanged, and
  ``all_reduce(MAX)`` of "some point of this rank is active" deciding the
  next, so that every rank takes the same number of iterations.  This is
  the oracle's ``while``: it iterates while any point's mask holds, each
  iteration's offset reads seeing the whole plane's previous iteration.

Every stencil of a plan is derived from the call's.  Its temporaries and
the flags ``a`` are held across the plan's stencils:
``distributed.run_global`` allocates them on the rank's padded block with
the call's halo, exchanges them like the fields, and hands them to every
stencil, whose backend keeps them in device memory (``"cuda"``:
``cuda_backend.generate``'s ``held``; ``"torch"``: the executor takes
them from its views).  Each statement
keeps at least its extent in the whole stencil (``analyze``'s
``min_extents``), and the statements of an iteration are restricted to
the ``while``'s extent by a region, so a rank may compute more points at
its edges (correct ones) but never writes where the single-device call
does not.  The steps run on the call's backend: on ``"cuda"`` each step
launches the generated kernels of its stencil (a level through the
kernels' section bounds, ``levels=``), never the plain executor.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from gt4py_tpu_torch.cartesian import ir, passes
from gt4py_tpu_torch.cartesian.analysis import StencilAnalysis, _stmt_reads, _stmt_writes, analyze
from gt4py_tpu_torch.core.definitions import Extent


def _ij(off) -> bool:
    return isinstance(off, ir.CartesianOffset) and bool(off.i or off.j)


def _reads(expr) -> list:
    return [n for n in ir.walk_values(expr) if isinstance(n, ir.FieldAccess)]


def tainted(stmt: ir.Stmt) -> set:
    """The fields a compound statement writes from values it wrote itself
    around the point: a read at a horizontal offset of a field it writes
    (after a write in its body, or in a ``while``'s next iteration), and
    what is computed from such a read or under a condition that holds
    one."""
    inner = {w.name for w in _stmt_writes(stmt)}
    out: set = set()

    def bad(reads) -> bool:
        return any(r.name in out or (r.name in inner and _ij(r.offset)) for r in reads)

    def visit(node, ctrl: bool) -> None:
        if isinstance(node, ir.Assign):
            reads = _reads(node.value) + [r for d in node.target.data_index for r in _reads(d)]
            if not isinstance(node.target.offset, ir.CartesianOffset):
                reads += _reads(node.target.offset.k)
            if ctrl or bad(reads):
                out.add(node.target.name)
        elif isinstance(node, (ir.If, ir.While)):
            c = ctrl or bad(_reads(node.cond))
            for s in node.body + getattr(node, "orelse", []):
                visit(s, c)
        elif isinstance(node, ir.HorizontalRestriction):
            for s in node.body:
                visit(s, ctrl)

    size = -1
    while size != len(out):  # a while's writes feed its next iteration
        size = len(out)
        visit(stmt, False)
    return out


def live_taint(body: List[ir.Stmt], n: int) -> set:
    """What ``tainted(body[n])`` leaves for the statements after it in the
    section: the tainted fields read before an assignment at the point
    overwrites them (empty: the extent analysis serves the statement)."""
    s = body[n]
    live = tainted(s) if not isinstance(s, ir.Assign) else set()
    for later in body[n + 1:]:
        if not live:
            break
        read = live & {r.name for r in _stmt_reads(later)}
        if read:
            return read
        if isinstance(later, ir.Assign) and not later.target.data_index \
                and later.target.offset == ir.CartesianOffset.zero():
            live.discard(later.target.name)
    return live


def _covers(outer: Extent, inner: Extent) -> bool:
    return (outer.i[0] <= inner.i[0] and inner.i[1] <= outer.i[1]
            and outer.j[0] <= inner.j[0] and inner.j[1] <= outer.j[1])


def cross_level(loop: ir.VerticalLoop, ext) -> Optional[str]:
    """Why a FORWARD or BACKWARD loop needs each level's writes exchanged
    before the next: it reads, at another level, a field or temporary it
    writes (or any read of one it writes at a K offset), at points some
    writer of it in the loop does not compute (the writer's extent does
    not cover the read's), where an earlier level's value was computed by
    the neighbour.  None for a PARALLEL loop and where it does not."""
    if loop.loop_order == ir.LoopOrder.PARALLEL:
        return None
    units = [s for sec in loop.sections for s in sec.body]
    writers: Dict[str, list] = {}
    shifted = set()  # written at a K offset: another level's writer
    for s in units:
        for w in _stmt_writes(s):
            writers.setdefault(w.name, []).append(s)
            if w.offset != ir.CartesianOffset.zero():
                shifted.add(w.name)
    for s in units:
        for r in _stmt_reads(s):
            if r.name not in writers or (isinstance(r.offset, ir.CartesianOffset)
                                         and not r.offset.k and r.name not in shifted):
                continue
            at = ext.stmt_extent(s)
            if isinstance(r.offset, ir.CartesianOffset):
                at = at + Extent.from_offset(r.offset.i, r.offset.j)
            if not all(_covers(ext.stmt_extent(w), at) for w in writers[r.name]):
                return (f"'{r.name}' is read at another level, at points its writer in "
                        f"the {loop.loop_order.name} loop does not compute")
    return None


# --------------------------------------------------------------------------- #
# the plan
# --------------------------------------------------------------------------- #


@dataclass
class Once:
    """One stencil (``loops``), run once; after ``finish``: its analysis,
    backend and written names (name -> the K offsets ``(lo, hi)`` of its
    writes, None where one is not a constant offset)."""

    loops: List[ir.VerticalLoop]
    analysis: Optional[StencilAnalysis] = None
    backend: object = None
    writes: Dict[str, Optional[Tuple[int, int]]] = field(default_factory=dict)


@dataclass
class Iterate:
    """A ``while`` run one iteration at a time: ``body`` (steps) per
    iteration while a point of ``active`` within ``extent`` (the loop's
    unit extent) and the section's ``interval`` holds on some rank."""

    active: str
    extent: Extent
    interval: ir.Interval
    body: List["Step"]


@dataclass
class Levels:
    """A serial loop run one level at a time: per section (``interval``,
    its steps), each level in the loop's ``order``."""

    order: ir.LoopOrder
    sections: List[Tuple[ir.Interval, List["Step"]]]


Step = Union[Once, Iterate, Levels]


@dataclass
class Plan:
    """``steps``; ``analysis``: the call's stencil with its compound
    statements split (its temporaries are the plan's held fields);
    ``flags``: the fields the plan adds (the ``while`` flags and masks),
    name -> declaration; ``onces``: every ``Once`` of the plan."""

    steps: List[Step]
    analysis: StencilAnalysis
    flags: Dict[str, ir.FieldDecl]
    onces: List[Once]

    def held(self) -> Dict[str, ir.FieldDecl]:
        """The fields a phased call allocates: the temporaries and flags."""
        return {**self.analysis.stencil.temp_decls, **self.flags}


def _within(e: Extent, s: ir.Stmt) -> ir.HorizontalRestriction:
    """``s`` restricted to the extent ``e`` of the (global) domain."""
    return ir.HorizontalRestriction(masks=[ir.HorizontalMask(
        i=ir.HorizontalInterval(start=ir.AxisBound.start(e.i[0]), end=ir.AxisBound.end(e.i[1])),
        j=ir.HorizontalInterval(start=ir.AxisBound.start(e.j[0]), end=ir.AxisBound.end(e.j[1])))],
        body=[s])


def _rename(stmts, names: Dict[str, str]) -> None:
    for node in ir.walk_values(stmts):
        if isinstance(node, ir.FieldAccess) and node.name in names:
            node.name = names[node.name]


class _Planner:
    def __init__(self, an: StencilAnalysis, backend_cls, options: dict):
        self.an = an
        self.st = an.stencil
        self.backend_cls = backend_cls
        self.options = options
        self.flags: Dict[str, ir.FieldDecl] = {}
        self.pins: Dict[int, Extent] = {}
        self.onces: List[Once] = []

    # ------------------------------------------------------------------ #

    def plan(self) -> List[Step]:
        steps: List[Step] = []
        pending: List[ir.VerticalLoop] = []

        def flush():
            if pending:
                steps.append(Once(list(pending)))
                pending.clear()

        for loop in self.st.vertical_loops:
            order = loop.loop_order
            sync = any(self._sync_while(sec.body, n) is not None
                       for sec in loop.sections for n in range(len(sec.body)))
            if order != ir.LoopOrder.PARALLEL and (sync or cross_level(loop, self.an.extents)):
                flush()
                steps.append(Levels(order, [
                    (sec.interval, self._segments(sec.body, order, sec.interval))
                    for sec in loop.sections]))
                continue
            if not sync:
                pending.append(ir.VerticalLoop(order, [ir.VerticalSection(
                    sec.interval, [self._pinned(s) for s in sec.body]) for sec in loop.sections]))
                continue
            for sec in loop.sections:
                for step in self._segments(sec.body, order, sec.interval):
                    if isinstance(step, Once):
                        pending.extend(step.loops)
                    else:
                        flush()
                        steps.append(step)
        flush()
        return steps

    def _unit(self, s: ir.Stmt) -> Extent:
        e = self.an.extents.stmt_extent(s)
        return Extent(i=e.i, j=e.j)

    def _pinned(self, s: ir.Stmt) -> ir.Stmt:
        c = copy.deepcopy(s)
        self.pins[id(c)] = self._unit(s)
        return c

    def _sync_while(self, body, n):
        """``(while, wrappers)`` where ``body[n]`` is, or holds under
        single-statement regions and conditions (``wrappers``, outermost
        first), a ``while`` whose offset reads need an exchange between its
        iterations; None where the statement needs none.  Raises where
        another compound statement needs one (the split pieces of ``if``
        statements and regions need none)."""
        live = live_taint(body, n)
        if not live:
            return None
        chain, x = [], body[n]
        while True:
            if isinstance(x, ir.While):
                return x, chain
            if isinstance(x, ir.HorizontalRestriction) and len(x.body) == 1:
                chain.append(x)
                x = x.body[0]
            elif isinstance(x, ir.If) and len(x.body) == 1 and not x.orelse:
                chain.append(x)
                x = x.body[0]
            else:
                raise NotImplementedError(
                    f"'{sorted(live)[0]}' is computed from a read at a horizontal offset of a "
                    "field written inside the same compound statement, which no phase "
                    "boundary can part")

    def _segments(self, body: List[ir.Stmt], order, interval, wrap=None,
                  unit: Optional[Callable] = None) -> List[Step]:
        """The steps of a section body: runs of statements (each a
        ``Once`` of one section) and, at each ``while`` that needs it, its
        start and its ``Iterate``.  ``wrap``: what every statement is put
        under (an iteration's ``if a:`` and region); ``unit``: each
        statement's extent (default: its extent in the split stencil)."""
        unit = unit or self._unit
        out: List[Step] = []
        cur: List[ir.Stmt] = []

        def add(s, e):
            s = wrap(s) if wrap is not None else s
            self.pins[id(s)] = e
            cur.append(s)

        def close():
            if cur:
                out.append(Once([ir.VerticalLoop(order, [ir.VerticalSection(interval,
                                                                            list(cur))])]))
                cur.clear()

        for n, s in enumerate(body):
            found = self._sync_while(body, n)
            e = unit(s)
            if found is None:
                add(copy.deepcopy(s), e)
                continue
            w, chain = found
            a = f"__phase_active{len(self.flags)}"
            self.flags[a] = ir.FieldDecl(name=a, dtype=np.dtype(np.bool_), is_api=False)
            start: ir.Stmt = ir.Assign(target=ir.FieldAccess(name=a), value=copy.deepcopy(w.cond))
            for x in reversed(chain):  # the start under the loop's regions and conditions
                start = (ir.HorizontalRestriction(masks=copy.deepcopy(x.masks), body=[start])
                         if isinstance(x, ir.HorizontalRestriction) else
                         ir.If(cond=copy.deepcopy(x.cond), body=[start], orelse=[]))
            add(start, e)
            close()
            out.append(Iterate(a, e, interval, self._iteration(w, a, e, order, interval)))
        close()
        return out

    def _iteration(self, w: ir.While, a: str, e: Extent, order, interval) -> List[Step]:
        """The steps of one iteration of ``w``: its body's statements, each
        under ``if a:`` within ``e`` (a compound one split first, as the
        whole stencil's were), then ``a = a and cond``."""
        body = copy.deepcopy(w.body)
        st = self._stencil([ir.VerticalLoop(order, [ir.VerticalSection(interval, body)])],
                           f"{self.st.name}__body")
        split = passes.split_compound_statements(
            analyze(st, {id(s): e for s in body}, validate=False))
        if split is not None:
            sst = split[0]
            body = sst.vertical_loops[0].sections[0].body
            names = {m: f"{m}_{a}" for m in sst.temp_decls if m not in st.temp_decls}
            _rename(body, names)
            for m, new in names.items():
                self.flags[new] = ir.FieldDecl(name=new, dtype=np.dtype(np.bool_), is_api=False)

        def wrap(s):
            return _within(e, ir.If(cond=ir.FieldAccess(name=a), body=[s], orelse=[]))

        steps = self._segments(body, order, interval, wrap, unit=lambda s: e)
        update = _within(e, ir.Assign(target=ir.FieldAccess(name=a), value=ir.BinaryOp(
            op=ir.BinaryOperator.AND, left=ir.FieldAccess(name=a), right=copy.deepcopy(w.cond))))
        self.pins[id(update)] = e
        if steps and isinstance(steps[-1], Once):
            steps[-1].loops[0].sections[0].body.append(update)
        else:
            steps.append(Once([ir.VerticalLoop(order, [ir.VerticalSection(interval, [update])])]))
        return steps

    # ------------------------------------------------------------------ #

    def _stencil(self, loops: List[ir.VerticalLoop], name: str) -> ir.Stencil:
        """A stencil of ``loops``: the call's fields it accesses, and the
        held temporaries and flags as its temporaries."""
        used = []
        for node in ir.walk_values(loops):
            if isinstance(node, ir.FieldAccess) and node.name not in used:
                used.append(node.name)
        st = self.st
        held = {**st.temp_decls, **self.flags}
        decls = {n: st.field_decls[n] for n in used if n in st.field_decls}
        return ir.Stencil(
            name=name,
            api_params=[ir.ApiParam(name=n, is_field=True) for n in decls]
            + [ir.ApiParam(name=n, is_field=False) for n in st.scalar_decls],
            field_decls=decls, scalar_decls=dict(st.scalar_decls),
            temp_decls={n: copy.deepcopy(held[n]) for n in used if n in held},
            vertical_loops=loops, externals=st.externals,
            literal_float_dtype=st.literal_float_dtype, literal_int_dtype=st.literal_int_dtype)

    def finish(self, steps: List[Step]) -> None:
        """Analyse each ``Once``'s stencil (its statements pinned to their
        extents) and make its backend, which takes the held temporaries
        from the caller (``cuda_backend.generate``'s ``held``)."""
        for step in steps:
            if isinstance(step, Levels):
                for _, sub in step.sections:
                    self.finish(sub)
            elif isinstance(step, Iterate):
                self.finish(step.body)
            else:
                st = self._stencil(step.loops, f"{self.st.name}__phase{len(self.onces)}")
                step.analysis = analyze(st, self.pins, validate=False)
                step.backend = self.backend_cls(step.analysis, {
                    **self.options, "held": frozenset(st.temp_decls)})
                for node in ir.walk_values(step.loops):
                    if isinstance(node, ir.Assign):
                        off = node.target.offset
                        k = off.k if isinstance(off, ir.CartesianOffset) else None
                        have = step.writes.get(node.target.name, (k, k))
                        step.writes[node.target.name] = None if k is None or have is None \
                            else (min(have[0], k), max(have[1], k))
                self.onces.append(step)


def plan(analysis: StencilAnalysis, backend_cls, options: Optional[dict] = None) -> Plan:
    """The phased plan of a stencil (``analysis``) on ``backend_cls``
    (``options``: its build options; only those that turn a form off are
    kept, as a forced form may not plan for a phase).  Raises
    ``NotImplementedError`` where a read that needs a neighbour's value of
    the call sits in a compound statement that cannot be parted."""
    options = {k: v for k, v in (options or {}).items() if v is False}
    split = passes.split_compound_statements(analysis)
    an = analyze(*split, validate=False) if split is not None else analysis
    planner = _Planner(an, backend_cls, options)
    steps = planner.plan()
    planner.finish(steps)
    return Plan(steps=steps, analysis=an, flags=planner.flags, onces=planner.onces)
