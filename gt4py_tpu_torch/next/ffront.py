"""Field-operator / scan-operator / program decorators.

The counterpart of ``gt4py_tpu.next.ffront`` (reference:
src/gt4py/next/ffront/decorator.py: field_operator :730, scan_operator
:784-871, Program :223 with .compile/.with_bound_args/.with_static_params;
the embedded semantics of src/gt4py/next/embedded/operators.py:27-90).

Definitions are parsed (frontend.parse_definition) into a validated, typed
field-view IR at decoration time; invalid syntax, undefined symbols and
type errors raise source-located ``FieldViewError``.  Execution interprets
the typed IR over Fields (interpreter.py): torch-backed fields run eagerly
on their device, numpy-backed fields are the embedded oracle.  There is no
staging: the JAX package's ``jax.jit`` path has no counterpart, and a
scan runs the explicit loop over its levels on both namespaces.  With the
``cuda`` backend, operators, scans and program segments lower to the
cartesian stencil IR and run the generated CUDA kernels
(``cuda_bridge``); an operator outside that subset runs embedded and is
recorded in ``cuda_bridge.FALLBACK_EVENTS``.  ``Program`` validates
operator calls (out=/domain= typing), performs domain inference
(extents.py) and builds kernels ahead of a call with ``compile``
(compiled_program.py).
"""

from __future__ import annotations

import contextlib
import functools
import sys
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from gt4py_tpu_torch import config
from gt4py_tpu_torch.core import dtypes
from gt4py_tpu_torch.instrumentation import metrics as _metrics

from . import frontend, fvir, type_system as ts
from .common import (
    Dimension,
    Domain,
    Field,
    UnitRange,
    _astype,
    _expand,
    current_offset_provider,
    domain_like,
    offset_provider_context,
    provider_fingerprint,
)

from .frontend import FieldViewError
from .interpreter import Interpreter


def _write_out(result: Field, out: Field, domain: Optional[Domain]) -> None:
    """Store ``result`` into ``out`` over ``domain``, in place."""
    if domain is not None:
        domain = domain_like(domain)
    target = domain or Domain(
        result.dims,
        tuple(
            result.domain[d].intersect(out.domain[d]) for d in result.dims
        ),
    )
    for d, r in target:
        rr = result.domain[d]
        orr = out.domain[d]
        if r.start < rr.start or r.stop > rr.stop:
            raise ValueError(
                f"out= domain {d.value}[{r.start}:{r.stop}] exceeds the "
                f"result's domain [{rr.start}:{rr.stop}]"
            )
        if r.start < orr.start or r.stop > orr.stop:
            raise ValueError(
                f"out= domain {d.value}[{r.start}:{r.stop}] exceeds the "
                f"output field's domain [{orr.start}:{orr.stop}]"
            )
    val = _expand(result, target)
    idx = []
    for d, r in target:
        own = out.domain[d]
        lo = r.start - own.start
        idx.append(slice(lo, lo + len(r)))
    shape = tuple(len(r) for _, r in target)
    if isinstance(out.data, np.ndarray):  # embedded numpy oracle
        if isinstance(val, torch.Tensor):
            val = val.cpu().numpy()
        out.data[tuple(idx)] = np.broadcast_to(val, shape).astype(out.dtype)
    else:
        if not isinstance(val, torch.Tensor):
            val = torch.as_tensor(np.asarray(val), device=out.data.device)
        out.data[tuple(idx)] = _astype(val, out.dtype).expand(*shape)


def _value_type(v) -> ts.TypeSpec:
    try:
        return ts.from_value(v)
    except TypeError:
        return ts.DeferredType()


_SYNTH_NT: Dict[type, type] = {}


def _synth_namedtuple(cls: type) -> type:
    """A namedtuple mirror of a dataclass: tuple-indexable for the
    interpreter while keeping member NAMES visible to type deduction
    (nested unannotated callees resolve vel.u from the value type)."""
    import collections
    import dataclasses as _dc

    nt = _SYNTH_NT.get(cls)
    if nt is None:
        nt = _SYNTH_NT[cls] = collections.namedtuple(
            cls.__name__, [f.name for f in _dc.fields(cls)]
        )
    return nt


def _canon_value(v, backend=None):
    """Canonicalize named-collection instances for the interpreter:
    NamedTuples stay NamedTuples, dataclasses become namedtuple mirrors
    (both tuple-indexable AND name-carrying) -- member Fields stay the
    SAME objects, so in-place out= writes reach the caller's collections
    -- and Fields move into the backend's namespace when one is set."""
    import dataclasses as _dc

    if _dc.is_dataclass(v) and not isinstance(v, type):
        return _synth_namedtuple(type(v))(
            *(_canon_value(getattr(v, f.name), backend) for f in _dc.fields(v))
        )
    if isinstance(v, tuple) and hasattr(v, "_fields"):
        return type(v)(*(_canon_value(x, backend) for x in v))
    if isinstance(v, tuple):
        return tuple(_canon_value(x, backend) for x in v)
    return backend.convert(v) if backend is not None else v


def _rebuild_collections(t: ts.TypeSpec, v):
    """Reconstruct named-collection instances on operator results, per the
    deduced return type's origin class."""
    if isinstance(t, ts.TupleType) and isinstance(v, tuple):
        parts = tuple(_rebuild_collections(x, y) for x, y in zip(t.types, v))
        if t.origin is not None and t.names is not None:
            return t.origin(**dict(zip(t.names, parts)))
        return parts
    return v


def _bind_call_args(params, args, kwargs, name):
    """Arbitrary positional/keyword mixes, like a plain Python call
    (reference: test_arg_call_interface.py permutation tests)."""
    if not kwargs:
        return tuple(args)
    unknown = set(kwargs) - set(params)
    if unknown:
        raise TypeError(
            f"'{name}' got unexpected keyword arguments {sorted(unknown)}"
        )
    if len(args) > len(params):
        raise TypeError(
            f"'{name}' takes {len(params)} arguments, got {len(args)} positional"
        )
    bound = dict(zip(params, args))
    for k, v in kwargs.items():
        if k in bound:
            raise TypeError(f"'{name}' got multiple values for argument '{k}'")
        bound[k] = v
    missing = [p for p in params if p not in bound]
    if missing:
        raise TypeError(f"'{name}' missing arguments: {missing}")
    return tuple(bound[p] for p in params)


def _write_out_any(result, out, domain) -> None:
    if isinstance(result, tuple):
        for r, o in zip(result, out):
            _write_out_any(r, o, domain)
    else:
        _write_out(result, out, domain)


class FieldOperator:
    """Callable wrapper over a parsed+typed operator definition
    (reference: decorator.FieldOperator :558)."""

    kind = "field_operator"

    def __init__(self, definition: Callable, name: Optional[str] = None,
                 localns: Optional[Dict[str, Any]] = None):
        self.definition = definition
        self.__name__ = name or definition.__name__
        self.ir = frontend.parse_definition(definition, self.kind, localns)
        # decoration-time deduction against the declared annotations:
        # complete annotations -> full static typing now; bare/absent
        # annotations -> deferred, resolved per call signature
        self._typed_cache: Dict[Tuple, Tuple[fvir.OperatorIR, ts.TypeSpec]] = {}
        self._decl_typed, self._decl_ret = frontend.deduce(self.ir)

    # -- typing -- #

    def _typed_for(self, arg_types: Tuple[ts.TypeSpec, ...]):
        # names/origin don't participate in TupleType equality (structural
        # typing) but DO change attribute resolution: key on the rendered
        # form too so named and plain tuples get separate deductions
        key = (arg_types, tuple(str(t) for t in arg_types))
        hit = self._typed_cache.get(key)
        if hit is None:
            hit = frontend.deduce(self.ir, list(arg_types))
            self._typed_cache[key] = hit
        return hit

    def _deduce_return(self, arg_types: Sequence[ts.TypeSpec]) -> ts.TypeSpec:
        return self._typed_for(tuple(arg_types))[1]

    @property
    def return_type(self) -> ts.TypeSpec:
        """Statically deduced return type (DeferredType when parameters
        are not fully annotated)."""
        return self._decl_ret

    def input_extents(self):
        """Per-parameter halo extents: {param: {dim: (lo, hi)}} -- the
        domain-inference analysis (see extents.py)."""
        from .extents import operator_extents

        return operator_extents(self)

    # -- execution -- #

    _backend = None  # None = embedded: follow the arguments' namespace
    #: leading parameters the caller does not pass (a scan's carry)
    _bound_params = 0

    def __call__(self, *args, out: Optional[Field] = None,
                 domain: Optional[Domain] = None, offset_provider=None, **kwargs):
        args = _bind_call_args(
            [p.name for p in self.ir.params], args, kwargs, self.__name__
        )
        with offset_provider_context(offset_provider):
            # deduce from the ORIGINAL args (named-collection instances
            # carry their member names), execute on the flattened values
            arg_types = tuple(_value_type(a) for a in args)
            canon = tuple(_canon_value(a, self._backend) for a in args)
            if self._backend is not None and getattr(
                self._backend, "compiled", ""
            ):
                # out=+domain= restricts the kernel's compute domain up
                # front (the embedded path computes everything and slices
                # at write-out -- same values, more work)
                restrict = domain if out is not None else None
                result = self._compiled_run(canon, arg_types, restrict)
            else:
                result = self._run_typed(canon, arg_types)
            if out is None:
                _, ret_t = self._typed_for(arg_types)
                return _rebuild_collections(ret_t, result)
            _write_out_any(result, _canon_value(out), domain)
        return None

    def _run_typed(self, args, arg_types=None):
        typed, _ = self._typed_for(arg_types)
        env = {p.name: a for p, a in zip(typed.params, args)}
        env.update(typed.closure)
        return Interpreter(typed, env).run()

    def _compiled_run(self, args, arg_types, restrict=None):
        """Lower to the generated CUDA kernels when eligible; run embedded
        otherwise (same numerics -- see next/cuda_bridge.py).
        ``restrict``: optional Domain/dict limiting the compute domain
        (the out=+domain= call form)."""
        from . import cuda_bridge

        restrict_t = None
        if restrict is not None:
            rdom = domain_like(restrict)
            restrict_t = tuple(
                (d.value, r.start, r.stop)
                for d, r in zip(rdom.dims, rdom.ranges)
            )
        plan = self._op_plan(arg_types)
        if plan is None:
            return self._run_typed(args, arg_types)
        try:
            return cuda_bridge.run_plan(plan, args, restrict=restrict_t)
        except cuda_bridge.Ineligible as ex:
            # per-CALL runtime ineligibility (e.g. empty output domain for
            # these particular argument domains): embedded for this call
            # only -- the plan stays cached for later calls
            cuda_bridge._record_fallback(self.__name__, str(ex))
            return self._run_typed(args, arg_types)

    def _op_plan(self, arg_types):
        """The lowered plan for these argument types (cached), or None when
        the operator is outside the kernels' subset (recorded once)."""
        from . import cuda_bridge

        key = (arg_types, tuple(str(t) for t in arg_types))
        plans = self.__dict__.setdefault("_bridge_plans", {})
        if key not in plans:
            try:
                typed, _ = self._typed_for(arg_types)
                plans[key] = cuda_bridge.lower_field_operator(typed)
            except cuda_bridge.Ineligible as ex:
                cuda_bridge._record_fallback(self.__name__, str(ex))
                plans[key] = None
        return plans[key]

    def kernels(self, *args, **kwargs):
        """Plan, without running, a ``cuda`` call on these arguments and
        return the kernel wrappers (``CudaBackend``s) it launches, so they
        can be built ahead of the first call."""
        from . import cuda_bridge

        args = _bind_call_args(
            [p.name for p in self.ir.params[self._bound_params:]], args, kwargs,
            self.__name__,
        )
        canon = tuple(_canon_value(a, self._backend) for a in args)
        if isinstance(self, ScanOperator):
            self._scan_plan(self._scan_typed(self._scalar_types(canon)), canon)
        else:
            self._op_plan(tuple(_value_type(a) for a in args))
        return cuda_bridge.kernels_of(self)

    def with_backend(self, backend) -> "FieldOperator":
        """Pick the executor (next/backends.py: numpy_oracle / torch / cuda
        or their reference-name aliases); None = embedded."""
        import copy

        from . import backends

        new = copy.copy(self)
        new.__dict__.pop("_bridge_plans", None)
        new.__dict__.pop("_scan_bridge_plans", None)
        new._backend = backends.resolve(backend)
        return new

    def with_grid_type(self, grid_type):  # API parity
        return self

    def __str__(self):
        ps = ", ".join(f"{p.name}: {p.type}" for p in self.ir.params)
        return f"@{self.kind} {self.__name__}({ps}) -> {self._decl_ret}"


def _caller_locals(depth: int = 2) -> Dict[str, Any]:
    """The locals of the frame that applied a decorator (string annotations
    may name them; see ``frontend._Parser._annotations``)."""
    return dict(sys._getframe(depth).f_locals)


def field_operator(fn=None, **kwargs):
    if fn is None:
        return lambda f: FieldOperator(f, localns=_caller_locals(), **kwargs)
    return FieldOperator(fn, localns=_caller_locals(), **kwargs)


class ScanOperator(FieldOperator):
    """Column scan (reference: decorator.scan_operator :784-871).

    ``definition(carry, *args) -> carry`` runs over the ``axis`` dimension
    level by level; the stacked carries form the result.  The embedded
    path runs the explicit column loop (the executable spec,
    embedded/operators.py:40-90) on numpy and on torch; the ``cuda``
    backend runs one column kernel (``cuda_bridge.lower_scan_operator``).
    """

    kind = "scan_operator"
    _bound_params = 1

    def __init__(self, definition: Callable, *, axis: Dimension,
                 forward: bool = True, init=0.0, localns: Optional[Dict[str, Any]] = None):
        self.axis = axis
        self.forward = forward
        self.init = init
        super().__init__(definition, localns=localns)
        if not self.ir.params:
            raise FieldViewError(
                f"scan operator '{self.__name__}' needs a carry parameter",
                self.ir.loc,
            )

    def __call__(self, *args, out: Optional[Field] = None,
                 domain: Optional[Domain] = None, offset_provider=None, **kwargs):
        with offset_provider_context(offset_provider):
            return self._scan_impl(*args, out=out, domain=domain, **kwargs)

    def _scan_typed(self, scalar_ts):
        """Typed body for scalarized arguments.  A plain Python init
        literal (float/int) is weak: it adapts to the declared carry
        annotation instead of forcing f64/i64 (reference: type_info
        weak-literal adaptation); tuple inits adapt member-by-member."""
        carry_t = ts.from_value(self.init)
        decl = self.ir.params[0].type
        if type(self.init) in (float, int) and isinstance(carry_t, ts.ScalarType):
            if isinstance(decl, ts.ScalarType) and not ts.is_deferred(decl):
                self.init = dtypes.make_scalar(self.init, decl.kind)
                carry_t = ts.from_value(self.init)
        elif (
            isinstance(self.init, tuple)
            and isinstance(decl, ts.TupleType)
            and len(decl.types) == len(self.init)
        ):
            self.init = tuple(
                dtypes.make_scalar(v, dt.kind)
                if type(v) in (float, int)
                and isinstance(dt, ts.ScalarType)
                and not ts.is_deferred(dt)
                else v
                for v, dt in zip(self.init, decl.types)
            )
            carry_t = ts.from_value(self.init)
        typed, ret_t = self._typed_for((carry_t, *tuple(scalar_ts)))
        if not ts.is_deferred(ret_t) and not ts.accepts(
            frontend._strip_weak(carry_t), frontend._strip_weak(ret_t)
        ):
            raise FieldViewError(
                f"scan '{self.__name__}' carry has type {carry_t} but the "
                f"body returns {ret_t}",
                self.ir.loc,
            )
        return typed

    def _scan_impl(self, *args, out: Optional[Field] = None,
                   domain: Optional[Domain] = None, **kwargs):
        # the first parameter is the carry: callers bind the rest
        args = _bind_call_args(
            [p.name for p in self.ir.params[1:]], args, kwargs, self.__name__
        )
        if self._backend is not None:
            # the backend picks the namespace
            args = tuple(self._backend.convert(a) for a in args)
        fields = [a for a in args if isinstance(a, Field)]
        if not fields:
            raise TypeError("scan_operator needs at least one Field argument")
        from .builtins import _merge_domains

        dom = _merge_domains(*fields)
        if self.axis not in dom.dims:
            raise ValueError(f"No argument spans the scan axis {self.axis}")
        ax = dom.dims.index(self.axis)

        # type-check the scalarized body against these argument dtypes
        typed = self._scan_typed(self._scalar_types(args))

        oracle = all(isinstance(f.data, np.ndarray) for f in fields)

        result = None
        if not oracle and self._backend is not None and getattr(
            self._backend, "compiled", ""
        ):
            # one column kernel when eligible; None -> the embedded loop
            # below (see next/cuda_bridge.py)
            result = self._compiled_scan(typed, args)
        if result is None:
            result = self._embedded_scan(typed, args, dom, ax, oracle)
        if out is None:
            return result
        if isinstance(result, tuple):
            for r, o in zip(result, out):
                _write_out(r, o, domain)
        else:
            _write_out(result, out, domain)
        return None

    def _embedded_scan(self, typed, args, dom, ax, oracle):
        """The embedded scan executor: the explicit level-by-level loop
        (the reference's executable spec, embedded/operators.py:69-80) over
        numpy arrays or torch tensors."""
        if oracle:
            def plane(v, shape):
                return np.broadcast_to(np.asarray(v), shape)

            stack = lambda planes: np.stack(planes, axis=0)  # noqa: E731
        else:
            device = next(a.data.device for a in args
                          if isinstance(a, Field) and isinstance(a.data, torch.Tensor))

            def plane(v, shape):
                if not isinstance(v, torch.Tensor):
                    v = torch.as_tensor(np.asarray(v), device=device)
                return v.to(device).expand(tuple(shape))

            stack = lambda planes: torch.stack(planes, dim=0)  # noqa: E731
        # broadcast all field args onto dom and move the scan axis first
        xs = []
        for a in args:
            if isinstance(a, Field):
                data = _expand(a, dom)
                if not oracle and not isinstance(data, torch.Tensor):
                    data = torch.as_tensor(np.asarray(data), device=device)
                data = plane(data, dom.shape)
                xs.append(np.moveaxis(data, ax, 0) if oracle else torch.movedim(data, ax, 0))
            else:
                xs.append(None)

        n = dom.shape[ax]
        plane_shape = dom.shape[:ax] + dom.shape[ax + 1 :]
        init = _tree_map(lambda v: plane(v, plane_shape), self.init)

        statics = [a for a in args if not isinstance(a, Field)]
        param_names = [p.name for p in typed.params]
        xs_stacked = tuple(x for x in xs if x is not None)

        order = range(n) if self.forward else range(n - 1, -1, -1)
        carry = init
        ys_list = [None] * n
        for k in order:
            it = iter(x[k] for x in xs_stacked)
            st = iter(statics)
            env = dict(typed.closure)
            env[param_names[0]] = carry
            for name, a in zip(param_names[1:], args):
                env[name] = next(it) if isinstance(a, Field) else next(st)
            new = Interpreter(typed, env).run()
            # a body whose result depends on neither the carry nor any
            # per-level argument returns a SCALAR; the result (and the
            # next carry) is still plane-shaped per the scan semantics
            carry = _tree_map(lambda v: plane(v, plane_shape), new)
            ys_list[k] = carry
        ys = _tree_map(lambda *planes: stack(list(planes)), *ys_list)

        def to_field(stacked):
            data = np.moveaxis(stacked, 0, ax) if oracle else torch.movedim(stacked, 0, ax)
            return Field(dom, data)

        return _tree_map(to_field, ys)

    def _scan_plan(self, typed, args):
        """The lowered column-kernel plan for these arguments (cached), or
        None when the scan is outside the kernels' subset."""
        from . import cuda_bridge

        arg_info = []
        key_parts = []
        for a in args:
            if isinstance(a, Field):
                dims = tuple(a.domain.dims)
                dt = np.dtype(a.dtype)
                arg_info.append(("field", dims, dt))
                key_parts.append(
                    (
                        "field",
                        tuple(d.value for d in dims),
                        tuple(d.kind.value for d in dims),
                        dt.str,
                    )
                )
            else:
                st = _value_type(a)
                arg_info.append(
                    (
                        "scalar",
                        np.dtype(st.kind) if isinstance(st, ts.ScalarType) else None,
                    )
                )
                key_parts.append(("scalar", str(st)))
        key = (
            tuple(key_parts),
            str(typed.params[0].type),
            repr(self.init),
            self.forward,
        )
        plans = self.__dict__.setdefault("_scan_bridge_plans", {})
        if key not in plans:
            try:
                plans[key] = cuda_bridge.lower_scan_operator(
                    typed,
                    axis=self.axis,
                    forward=self.forward,
                    init=self.init,
                    arg_info=arg_info,
                )
            except cuda_bridge.Ineligible as ex:
                cuda_bridge._record_fallback(self.__name__, str(ex))
                plans[key] = None
        return plans[key]

    def _scalar_types(self, args):
        """The scalarized argument types the scan body is typed with."""
        return [
            ts.ScalarType(np.dtype(a.dtype)) if isinstance(a, Field)
            else _value_type(a)
            for a in args
        ]

    def _compiled_scan(self, typed, args):
        """Run one column kernel when eligible (the carry at level k is the
        out field at k-+1); returns None when the scan is outside the
        kernel subset -- see next/cuda_bridge.py."""
        from . import cuda_bridge

        plan = self._scan_plan(typed, args)
        if plan is None:
            return None
        try:
            return cuda_bridge.run_scan_plan(plan, args)
        except cuda_bridge.Ineligible as ex:
            # per-CALL runtime ineligibility (e.g. unbounded domains for
            # these particular arguments): embedded path for this call only
            cuda_bridge._record_fallback(self.__name__, str(ex))
            return None


def scan_operator(fn=None, *, axis: Dimension, forward: bool = True, init=0.0):
    if fn is None:
        return lambda f: ScanOperator(f, axis=axis, forward=forward, init=init,
                                      localns=_caller_locals())
    return ScanOperator(fn, axis=axis, forward=forward, init=init, localns=_caller_locals())


class Program:
    """A validated sequence of operator calls with out= arguments
    (reference: decorator.Program :223).

    Ahead-of-time surface (reference: decorator.py:223-500 +
    otf/compiled_program.py):
      - ``with_static_params("n", ...)``: declare scalar params whose
        values select a variant
      - ``with_bound_args(n=80)``: fix parameters
      - ``compile(example_args, n=[1, 2], wait=True)``: plan every
        variant against the example arguments and build its CUDA kernels
        (nvcc processes in parallel), so the first call launches at once
      - a call runs eagerly; with the ``cuda`` backend it reuses the plans
        and kernels built for its argument domains.
    """

    _backend = None  # None = embedded (see next/backends.py)

    def __init__(self, definition: Callable, *, static_params: Tuple[str, ...] = (),
                 bound_args: Optional[Dict[str, Any]] = None,
                 localns: Optional[Dict[str, Any]] = None):
        self.definition = definition
        self.__name__ = definition.__name__
        self._localns = localns
        self.ir = frontend.parse_definition(definition, "program", localns)
        self._decl_typed, _ = frontend.deduce(self.ir)
        self._typed_cache: Dict[Tuple, fvir.OperatorIR] = {}
        self._static_params = tuple(static_params)
        self._bound_args = dict(bound_args or {})
        # ahead-of-time pools keyed by offset-provider fingerprint
        self._pools: Dict[Any, Any] = {}
        self._out_params: Tuple[str, ...] = self._find_out_params()
        self._metrics_seen: set = set()  # static-arg variants already sampled

    # -- analysis -- #

    def _find_out_params(self) -> Tuple[str, ...]:
        names = []

        def root_names(e):
            # out= targets: names, tuples of targets, collection members
            # (vel.u) and tuple elements (t[0]) -- the written param is
            # the expression's root name
            if isinstance(e, fvir.Name):
                yield e.id
            elif isinstance(e, fvir.TupleExpr):
                for x in e.elts:
                    yield from root_names(x)
            elif isinstance(e, (fvir.AttrGet, fvir.Subscript, fvir.FieldSlice)):
                yield from root_names(e.value)

        for st in self.ir.body:
            call = st.value
            if isinstance(call, fvir.Call):
                for n in root_names(call.kwargs.get("out")):
                    if n not in names:
                        names.append(n)
        return tuple(names)

    def _typed_for(self, arg_types: Tuple[ts.TypeSpec, ...]) -> fvir.OperatorIR:
        hit = self._typed_cache.get(arg_types)
        if hit is None:
            typed, _ = frontend.deduce(self.ir, list(arg_types))
            self._typed_cache[arg_types] = typed = typed
        else:
            typed = hit
        return typed

    # -- embedded execution -- #

    def _bind(self, args, kwargs):
        params = [p.name for p in self.ir.params]
        values = dict(self._bound_args)
        values.update(kwargs)
        it = iter(args)
        merged = []
        for name in params:
            if name in values:
                merged.append(values.pop(name))
            else:
                try:
                    merged.append(next(it))
                except StopIteration:
                    raise TypeError(
                        f"program '{self.__name__}' missing argument '{name}'"
                    )
        extra = list(it)
        if extra or values:
            raise TypeError(
                f"program '{self.__name__}' got unexpected arguments "
                f"({len(extra)} extra positional, {sorted(values)})"
            )
        return merged

    def __call__(self, *args, offset_provider=None, **kwargs):
        merged = self._bind(args, kwargs)
        with offset_provider_context(offset_provider):
            # flatten named-collection instances (member Fields stay
            # shared, so out= writes reach the caller); convert non-out
            # inputs to the backend's namespace -- out params keep the
            # caller's buffers
            merged = [
                _canon_value(
                    a,
                    None
                    if self._backend is None or p.name in self._out_params
                    else self._backend,
                )
                for p, a in zip(self.ir.params, merged)
            ]
            from gt4py_tpu_torch.instrumentation import program_call_context

            compiled = bool(getattr(self._backend, "compiled", ""))
            timer = self._metrics_timer(merged, compiled=compiled)
            with program_call_context.activate(
                name=self.__name__, compiled=compiled
            ), timer:
                self._run_embedded(merged)
        return None

    def _metrics_timer(self, merged, *, compiled: bool):
        """Per-call compute-time sample, keyed per static-arg variant on
        the compiled path (reference: compiled_program.py:66-88 pool+
        variant MetricsCollection; gtfn.py:61-78).  The first call of a
        variant may build its kernels -- that call is NOT sampled, so the
        metric measures launch+compute only."""
        if not _metrics.enabled(_metrics.MetricLevel.PERFORMANCE):
            return contextlib.nullcontext()
        if not compiled:
            return _metrics.timed_sample(self.__name__, "compute_time")
        params = [p.name for p in self.ir.params]

        def canon(v):
            return v.item() if hasattr(v, "item") else v

        skey = tuple(canon(merged[params.index(n)]) for n in self._static_params)
        if skey not in self._metrics_seen:
            self._metrics_seen.add(skey)
            return contextlib.nullcontext()  # compile call: don't sample
        variant = ",".join(
            f"{n}={v!r}" for n, v in zip(self._static_params, skey)
        ) or "default"

        @contextlib.contextmanager
        def timed():
            with _metrics.timed_sample(self.__name__, f"compute_time[{variant}]"):
                yield
                # launches are asynchronous: wait for the out buffers'
                # devices so the sample covers device compute
                for name in self._out_params:
                    v = merged[params.index(name)]
                    for x in (v if isinstance(v, tuple) else (v,)):
                        if isinstance(x, Field) and isinstance(x.data, torch.Tensor) \
                                and x.data.device.type == "cuda":
                            torch.cuda.synchronize(x.data.device)

        return timed()

    def _run_embedded(self, merged):
        typed = self._typed_for(tuple(_value_type(a) for a in merged))
        env = {p.name: a for p, a in zip(typed.params, merged)}
        env.update(typed.closure)
        if self._backend is not None and getattr(self._backend, "compiled", ""):
            # whole-program fusion: splice runs of eligible operator
            # statements into one stencil each (intermediates become
            # kernel temporaries) -- the reference's global-tmps +
            # as_fieldop fusion (see cuda_bridge.lower_program)
            self._check_domains(typed, env)
            if self._run_fused(typed, merged):
                return
            # compiled program backend: operator calls in the body go
            # through the same compiled path (cuda_bridge lowering with
            # per-call out=/domain= restriction; ineligible ones run
            # embedded inside the operator)
            env = {k: self._rebind_compiled(v) for k, v in env.items()}
        else:
            self._check_domains(typed, env)
        Interpreter(typed, env).run()

    def _run_fused(self, typed, merged) -> bool:
        """Try the fused-program schedule (cuda_bridge.lower_program):
        maximal runs of eligible operator statements execute as ONE
        fused kernel each, interleaved with interpreted statements
        (scans, collection targets, ...).  False -> caller uses the
        plain per-statement path.  Structural ineligibility is cached
        per typed signature; per-call gates (domain coverage,
        cross-statement read regions) are validated for EVERY segment
        before any holder mutates, so a per-call fallback is atomic."""
        from . import cuda_bridge

        if not config.PROGRAM_FUSION:
            return False
        plans = self.__dict__.setdefault("_prog_bridge_plans", {})
        env = {p.name: a for p, a in zip(typed.params, merged)}
        sched = insts = None
        # two schedule tiers: FULL fusion (scan/concat_where statements
        # join their segments) first; when an instance fails its
        # per-call gates (e.g. a scan whose vertical range differs from
        # the fused domain for THESE arguments), degrade to the
        # conservative r4-style schedule (serial statements interpreted)
        # instead of losing fusion wholesale.
        for fuse_serial in (True, False):
            key = (id(typed), fuse_serial)
            if key not in plans:
                try:
                    plans[key] = cuda_bridge.lower_program(
                        typed, fuse_serial=fuse_serial
                    )
                except cuda_bridge.Ineligible as ex:
                    if fuse_serial:
                        cuda_bridge._record_fallback(
                            self.__name__,
                            f"program fusion: {ex}",
                            warn=not getattr(ex, "quiet", False),
                        )
                    plans[key] = None
            cand = plans[key]
            if cand is None:
                continue
            try:
                insts = {
                    idx: cuda_bridge.prepare_program_plan(payload, env)
                    for idx, (kind, payload) in enumerate(cand.items)
                    if kind == "fused"
                }
                sched = cand
                break
            except cuda_bridge.Ineligible as ex:
                if fuse_serial:
                    # quiet breadcrumb; the conservative tier follows
                    cuda_bridge.FALLBACK_EVENTS.record(
                        (self.__name__, f"fusion degraded: {ex}")
                    )
                else:
                    cuda_bridge._record_fallback(
                        self.__name__, f"program fusion: {ex}"
                    )
        if sched is None:
            return False
        interp_env = None
        for idx, (kind, payload) in enumerate(sched.items):
            if kind == "fused":
                cuda_bridge.execute_program_instance(payload, insts[idx], env)
            else:
                if interp_env is None:
                    interp_env = dict(env)
                    interp_env.update(
                        {
                            k: self._rebind_compiled(v)
                            for k, v in typed.closure.items()
                        }
                    )
                Interpreter(typed, interp_env)._body([payload])
        return True

    def kernels(self, *args, offset_provider=None, **kwargs):
        """Plan, without running, a call on these arguments and return the
        kernel wrappers (``CudaBackend``s) it launches; ``compile`` and
        the chip check build them ahead of the first call."""
        merged = self._bind(args, kwargs)
        with offset_provider_context(offset_provider):
            merged = [
                _canon_value(a, None if p.name in self._out_params else self._backend)
                for p, a in zip(self.ir.params, merged)
            ]
            return self._plan_kernels(merged)

    def _plan_kernels(self, merged):
        """Plan, without running, what a ``cuda`` call on ``merged`` (the
        canonical argument values) runs: the fused segments' instances and
        every operator statement's lowered plan.  Returns the plans'
        ``CudaBackend``s (the kernels to build)."""
        from . import cuda_bridge

        typed = self._typed_for(tuple(_value_type(a) for a in merged))
        env = {p.name: a for p, a in zip(typed.params, merged)}
        interp = list(typed.body)
        if config.PROGRAM_FUSION:
            plans = self.__dict__.setdefault("_prog_bridge_plans", {})
            key = (id(typed), True)
            if key not in plans:
                try:
                    plans[key] = cuda_bridge.lower_program(typed, fuse_serial=True)
                except cuda_bridge.Ineligible:
                    plans[key] = None
            sched = plans[key]
            if sched is not None:
                interp = []
                for kind, payload in sched.items:
                    if kind == "fused":
                        try:
                            cuda_bridge.prepare_program_plan(payload, env)
                        except cuda_bridge.Ineligible:
                            interp.extend(ps.src for ps in payload.stmts)
                    else:
                        interp.append(payload)
        for st in interp:
            call = st.value if isinstance(st, fvir.Assign) else None
            if not isinstance(call, fvir.Call) or not isinstance(call.func, fvir.Name):
                continue
            op = self._rebind_compiled(typed.closure.get(call.func.id))
            if not isinstance(op, FieldOperator) or not all(
                    isinstance(a, (fvir.Name, fvir.Literal)) for a in call.args):
                continue
            args = tuple(env[a.id] if isinstance(a, fvir.Name) else a.value for a in call.args)
            args = tuple(_canon_value(a, self._backend) for a in args)
            if isinstance(op, ScanOperator):
                op._scan_plan(op._scan_typed(op._scalar_types(args)), args)
            else:
                op._op_plan(tuple(_value_type(a) for a in args))
        return cuda_bridge.kernels_of(self)

    def _rebind_compiled(self, v):
        """Closure operators re-targeted at the compiled backend (so
        interpreted schedule items still dispatch per-op kernels)."""
        if isinstance(v, FieldOperator) and v._backend is None:
            cache = self.__dict__.setdefault("_rebound_ops", {})
            try:
                r = cache.get(v)
            except TypeError:
                return v.with_backend(self._backend)
            if r is None:
                r = cache[v] = v.with_backend(self._backend)
            return r
        return v

    def _check_domains(self, typed, env) -> None:
        """Domain inference check (reference: transforms/infer_domain.py):
        every statement's inputs must cover the domain it writes, expanded
        by the callee's access extents -- located error instead of a
        silently shrunk write."""
        from .extents import required_domains
        from .frontend import _err

        for st in typed.body:
            call = st.value
            if not isinstance(call, fvir.Call):
                continue
            out_expr = call.kwargs.get("out")
            if out_expr is None or "domain" in call.kwargs:
                continue  # explicit domain=: _write_out validates coverage
            fn = env.get(call.func.id) if isinstance(call.func, fvir.Name) else None
            if not isinstance(fn, FieldOperator) or isinstance(fn, ScanOperator):
                continue

            def target_domains(e):
                if isinstance(e, fvir.Name):
                    f = env.get(e.id)
                    if isinstance(f, Field):
                        yield f.domain
                elif isinstance(e, fvir.TupleExpr):
                    for x in e.elts:
                        yield from target_domains(x)
                elif isinstance(e, fvir.FieldSlice) and isinstance(
                    e.value, fvir.Name
                ):
                    parent = env.get(e.value.id)
                    if isinstance(parent, Field):
                        index = tuple(slice(lo, hi) for lo, hi in e.slices)
                        try:
                            dom, _ = parent._slice_spec(index)
                        except IndexError:
                            return  # the interpreter raises a located error
                        yield dom

            out_domains = list(target_domains(out_expr))
            if not out_domains:
                continue
            target = out_domains[0]
            req = required_domains(fn, target)
            for p, arg in zip(fn.ir.params, call.args):
                if not isinstance(arg, fvir.Name):
                    continue
                f = env.get(arg.id)
                if not isinstance(f, Field):
                    continue
                need = req.get(p.name)
                if need is None:
                    continue
                for d, r in need:
                    if d not in f.domain.dims:
                        continue
                    have = f.domain[d]
                    if r.start < have.start or r.stop > have.stop:
                        raise _err(
                            f"argument '{arg.id}' must cover "
                            f"{d.value}[{r.start}:{r.stop}) to write 'out' over "
                            f"{d.value}[{target[d].start}:{target[d].stop}), "
                            f"but spans [{have.start}:{have.stop}) "
                            "(pass domain=... to restrict the write)",
                            call,
                        )

    # -- AOT / compiled variants -- #

    def _replace(self, **kw) -> "Program":
        new = Program(
            self.definition,
            static_params=kw.get("static_params", self._static_params),
            bound_args=kw.get("bound_args", self._bound_args),
            localns=self._localns,
        )
        new._backend = self._backend  # with_backend choice survives chaining
        return new

    def with_static_params(self, *names: str) -> "Program":
        unknown = set(names) - {p.name for p in self.ir.params}
        if unknown:
            raise ValueError(f"not parameters of '{self.__name__}': {sorted(unknown)}")
        return self._replace(static_params=tuple(names))

    def with_bound_args(self, **bound) -> "Program":
        unknown = set(bound) - {p.name for p in self.ir.params}
        if unknown:
            raise ValueError(f"not parameters of '{self.__name__}': {sorted(unknown)}")
        merged = dict(self._bound_args)
        merged.update(bound)
        return self._replace(bound_args=merged)

    def with_backend(self, backend) -> "Program":
        """Pick the executor (next/backends.py)."""
        import copy

        from . import backends

        new = copy.copy(self)
        new._backend = backends.resolve(backend)
        new._pools = {}  # each backend keeps its own compiled variants
        new._metrics_seen = set()
        return new

    def _functional(self):
        """Pure function (param datas in -> out datas): the out parameters'
        buffers are copied first, so the caller's stay unchanged."""
        params = [p.name for p in self.ir.params]
        out_idx = [params.index(n) for n in self._out_params]

        bound = dict(self._bound_args)

        def fresh_holders(a):
            # fresh Field holders over copies (collections recursively):
            # the run writes the out buffers in place
            if isinstance(a, Field):
                data = a.data.clone() if isinstance(a.data, torch.Tensor) else a.data.copy()
                return Field(a.domain, data)
            if isinstance(a, tuple):
                return tuple(fresh_holders(x) for x in a)
            return a

        def out_datas(v):
            if isinstance(v, tuple):
                return tuple(out_datas(x) for x in v)
            return v.data

        def fn(*call_args, **static_kwargs):
            it = iter(call_args)
            merged = [
                static_kwargs[name]
                if name in static_kwargs
                else bound[name]
                if name in bound
                else next(it)
                for name in params
            ]
            fresh = [fresh_holders(a) if name in self._out_params else a
                     for name, a in zip(params, merged)]
            self._run_embedded(fresh)
            return tuple(out_datas(fresh[i]) for i in out_idx)

        functools.update_wrapper(fn, self.definition)
        # publish the actual convention: dynamic params positional in
        # declared order, static params keyword-only
        import inspect

        dyn_names = [
            n for n in params if n not in self._static_params and n not in bound
        ]
        fn.__signature__ = inspect.Signature(
            [
                inspect.Parameter(n, inspect.Parameter.POSITIONAL_OR_KEYWORD)
                for n in dyn_names
            ]
            + [
                inspect.Parameter(n, inspect.Parameter.KEYWORD_ONLY)
                for n in self._static_params
            ]
        )
        return fn

    def compile(self, example_args: Tuple = (), *, wait: bool = True,
                offset_provider=None, **static_values) -> "Program":
        """Plan one variant per combination of static-parameter values
        against ``example_args``'s domains and build its kernels
        (reference: decorator.Program.compile ->
        CompiledProgramsPool.compile)."""
        from .compiled_program import CompiledProgramsPool

        with offset_provider_context(offset_provider):
            fp = provider_fingerprint(current_offset_provider())
            pool = self._pools.get(fp)
            if pool is None:
                pool = self._pools[fp] = CompiledProgramsPool(
                    self, static_params=self._static_params
                )
            pool.compile(tuple(example_args), wait=wait, **static_values)
        return self

    @property
    def _pool(self):
        """The default pool (calls without offset_provider)."""
        return self._pools.get(None)

    def wait_for_compilation(self) -> None:
        for pool in self._pools.values():
            pool.wait_for_compilation()

    def __str__(self):
        ps = ", ".join(f"{p.name}: {p.type}" for p in self.ir.params)
        return f"@program {self.__name__}({ps})"


def _tree_map(fn, *trees):
    """``fn`` over the leaves of equally shaped (nested) tuples."""
    if isinstance(trees[0], tuple):
        return tuple(_tree_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


def program(fn=None, **kwargs):
    if fn is None:
        return lambda f: Program(f, localns=_caller_locals())
    return Program(fn, localns=_caller_locals())
