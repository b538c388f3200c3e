"""Domain inference for field operators: per-parameter access extents.

Reference analog: src/gt4py/next/iterator/transforms/infer_domain.py
(compute the domains of inputs/temporaries from the output domain by
propagating offsets backwards) and the cartesian extent analysis
(oir_optimizations/utils.py:250-330).

TPU-first compaction: FVIR is interpreted, so no temporary-materialization
pass is needed -- what remains of domain inference is the *access extent*
of every input: for each parameter, per dimension, the (lo, hi) window
the operator reads relative to an output point.  ``required_domains``
turns that into concrete input domains for a target output domain;
``Program`` uses it to validate that arguments cover what a statement
writes (located errors instead of silently-shrunk intersections).

``FULL`` marks dimensions accessed data-dependently (connectivity remaps,
as_offset gathers, scan columns): the whole extent of the dimension is
required.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from . import fvir, type_system as ts
from .common import Dimension, Domain, UnitRange
from .frontend import _err

#: sentinel: the full dimension is required (data-dependent access)
FULL = None

# an extent map: param name -> {Dimension: (lo, hi) | FULL}
ExtMap = Dict[str, Dict[Dimension, Optional[Tuple[int, int]]]]


def _merge_ext(a, b):
    if a is FULL or b is FULL:
        return FULL
    return (min(a[0], b[0]), max(a[1], b[1]))


def _merge(maps) -> ExtMap:
    out: ExtMap = {}
    for m in maps:
        if m is None:
            continue
        for param, dims in m.items():
            dst = out.setdefault(param, {})
            for d, e in dims.items():
                dst[d] = _merge_ext(dst[d], e) if d in dst else e
    return out


def _shift(m: ExtMap, dim: Dimension, k: int) -> ExtMap:
    out: ExtMap = {}
    for param, dims in m.items():
        nd = dict(dims)
        cur = nd.get(dim, (0, 0))
        nd[dim] = FULL if cur is FULL else (cur[0] + k, cur[1] + k)
        out[param] = nd
    return out


def _full(m: ExtMap, dim: Dimension) -> ExtMap:
    out: ExtMap = {}
    for param, dims in m.items():
        nd = dict(dims)
        nd[dim] = FULL
        out[param] = nd
    return out


class _ExtentAnalysis:
    """Abstract interpretation of FVIR over extent maps."""

    def __init__(self, ir: fvir.OperatorIR):
        self.ir = ir
        self.env: Dict[str, object] = {}

    def run(self) -> ExtMap:
        for p in self.ir.params:
            self.env[p.name] = {p.name: {}}
        result = self._body(self.ir.body)
        merged = _merge([result]) if isinstance(result, dict) else _merge(
            x for x in (result or []) if isinstance(x, dict)
        )
        # ensure every field param appears
        for p in self.ir.params:
            if isinstance(p.type, ts.FieldType) or ts.is_deferred(p.type):
                merged.setdefault(p.name, {})
        return merged

    def _body(self, body):
        ret = None
        for st in body:
            if isinstance(st, fvir.Return):
                v = self.eval(st.value)
                ret = _merge(self._leaves(v)) if v is not None else ret
            elif isinstance(st, fvir.Assign):
                if st.targets:
                    v = self.eval(st.value)
                    if st.unpack and isinstance(v, (list, tuple)):
                        for name, x in zip(st.targets, v):
                            self.env[name] = x
                    elif st.unpack:
                        for name in st.targets:
                            self.env[name] = v
                    else:
                        self.env[st.targets[0]] = v
                else:
                    self.eval(st.value)
            elif isinstance(st, fvir.IfStmt):
                r1 = self._body(st.body)
                r2 = self._body(st.orelse)
                ret = _merge([ret, r1, r2])
        return ret

    def _leaves(self, v):
        if isinstance(v, (list, tuple)):
            out = []
            for x in v:
                out.extend(self._leaves(x))
            return out
        return [v] if isinstance(v, dict) else []

    def eval(self, node: fvir.Expr):
        if isinstance(node, fvir.Name):
            return self.env.get(node.id)
        if isinstance(node, fvir.Literal):
            return None
        if isinstance(node, fvir.TupleExpr):
            return tuple(self.eval(e) for e in node.elts)
        if isinstance(node, (fvir.BinOp, fvir.Compare)):
            return _merge(
                self._leaves(self.eval(node.left)) + self._leaves(self.eval(node.right))
            ) or None
        if isinstance(node, fvir.BoolOp):
            leaves = []
            for v in node.values:
                leaves.extend(self._leaves(self.eval(v)))
            return _merge(leaves) or None
        if isinstance(node, fvir.UnaryOp):
            return self.eval(node.operand)
        if isinstance(node, fvir.Ternary):
            return _merge(
                self._leaves(self.eval(node.true_expr))
                + self._leaves(self.eval(node.false_expr))
            ) or None
        if isinstance(node, fvir.Subscript):
            v = self.eval(node.value)
            if isinstance(v, (list, tuple)):
                return v[node.index]
            return v
        if isinstance(node, fvir.Call):
            return self._call(node)
        return None

    def _call(self, node: fvir.Call):
        ft = node.func.type
        arg_vals = [self.eval(a) for a in node.args]
        kw_vals = {k: self.eval(v) for k, v in node.kwargs.items()}

        # field(offset) / field(connectivity) -- also reached with deferred
        # field types (bare `Field` annotations): recognized by the offset/
        # connectivity-typed argument
        arg0_t = node.args[0].type if node.args else None
        if isinstance(ft, ts.FieldType) or (
            isinstance(ft, ts.DeferredType)
            and isinstance(
                arg0_t,
                (ts.OffsetIndexType, ts.ConnectivityType, ts.OffsetType),
            )
        ):
            m = self.eval(node.func)
            if m is None:
                return None
            at = node.args[0].type if node.args else None
            if isinstance(at, ts.OffsetIndexType):
                unstructured = (
                    len(at.target) != 1
                    or at.target[0].value != at.source.value
                )
                if unstructured:
                    # neighbor selection: data-dependent over source dim
                    return _full(m, at.source)
                if isinstance(node.args[0], fvir.Subscript):
                    # literal subscript: Ioff[k]
                    return _shift(m, at.source, node.args[0].index)
                return _full(m, at.source)  # offset held in a variable
            if isinstance(at, ts.ConnectivityType):
                return _full(m, at.codomain)
            if isinstance(at, ts.OffsetType):
                # provider-resolved remap: data-dependent gather
                return _full(m, at.source)
            return m

        if isinstance(ft, ts.OperatorType):
            from . import ffront

            op = ft.op
            if isinstance(op, ffront.ScanOperator):
                merged = _merge(
                    sum((self._leaves(v) for v in arg_vals), [])
                )
                return _full(merged, op.axis) if merged else None
            # compose callee extents with argument maps: the callee reads
            # its parameter at window E, the argument was itself read at
            # window C from our params -> our params are read at C + E
            callee = operator_extents(op)
            out: ExtMap = {}
            for p, av in zip(op.ir.params, arg_vals):
                if av is None:
                    continue
                pext = callee.get(p.name, {})
                for param, dims in av.items():
                    dst = out.setdefault(param, {})
                    for d in set(dims) | set(pext):
                        cur = dims.get(d, (0, 0))
                        e = pext.get(d, (0, 0))
                        if cur is FULL or e is FULL:
                            comp = FULL
                        else:
                            comp = (cur[0] + e[0], cur[1] + e[1])
                        dst[d] = _merge_ext(dst[d], comp) if d in dst else comp
            return out or None

        # builtins
        fname = getattr(ft, "fn", None)
        from . import builtins as fb

        leaves = sum((self._leaves(v) for v in arg_vals), [])
        leaves += sum((self._leaves(v) for v in kw_vals.values()), [])
        merged = _merge(leaves) or None
        if fname in (fb.premap,):
            at = node.args[1].type if len(node.args) > 1 else None
            if merged is not None and isinstance(at, ts.ConnectivityType):
                return _full(merged, at.codomain)
        if fname in (fb.as_offset,):
            return merged  # the index field itself
        if fname in (fb.concat_where,) and merged is not None:
            # piecewise semantics: a branch's VERTICAL offsets apply only
            # on its K pieces, so the hull over-states the demand (the
            # classic interior branch reading K-1 under `K < 1` needs NO
            # extra plane).  Mark non-zero vertical extents FULL: the
            # domain checker then leaves validation to the runtime piece
            # algebra (bridge recipes / embedded intersection), which is
            # exact and raises located errors.
            from .common import DimensionKind

            return {
                param: {
                    d: (
                        FULL
                        if d.kind == DimensionKind.VERTICAL
                        and e is not FULL
                        and e != (0, 0)
                        else e
                    )
                    for d, e in dims.items()
                }
                for param, dims in merged.items()
            }
        return merged


def operator_extents(op) -> ExtMap:
    """Per-parameter access extents of a field/scan operator (cached)."""
    cached = getattr(op, "_extents_cache", None)
    if cached is not None:
        return cached
    typed = op._decl_typed
    ext = _ExtentAnalysis(typed).run()
    op._extents_cache = ext
    return ext


def required_domains(op, out_domain: Domain) -> Dict[str, Domain]:
    """Concrete input domains needed to produce ``out_domain``
    (reference: transforms/infer_domain.py)."""
    ext = operator_extents(op)
    out: Dict[str, Domain] = {}
    for param, dims in ext.items():
        pdims = []
        pranges = []
        for d, r in out_domain:
            e = dims.get(d, (0, 0))
            if e is FULL:
                continue  # full dimension: no constraint derivable here
            pdims.append(d)
            pranges.append(UnitRange(r.start + e[0], r.stop + e[1]))
        out[param] = Domain(tuple(pdims), tuple(pranges))
    return out
