"""Ahead-of-time planned program variants over static arguments.

The counterpart of ``gt4py_tpu.next.compiled_program`` (reference
behavior: next/otf/compiled_program.py:161-680, ``CompiledProgramsPool``:
precompile one variant per combination of static-argument values,
asynchronously on a thread pool, ``wait_for_compilation``).

A variant of a ``cuda``-backed program is its plans and kernels for one
set of static values and argument domains: ``compile`` plans the program
against example arguments (the fused segments' instances and every
operator statement's lowering, without running anything) and builds the
kernels of every variant with one nvcc process per distinct source, all
started together.  Calls then run eagerly and find their plans and
built kernels in place.  Kernels are built only for fields on a CUDA
device; on CPU fields the plain executor needs none.
"""

from __future__ import annotations

import itertools
import threading
import weakref
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, Iterable, List, Sequence, Tuple

import torch

from .common import Field

#: every live pool, so module-level wait_for_compilation() can drain all
#: in-flight builds (reference: otf/compiled_program.py:172)
_ALL_POOLS: "weakref.WeakSet" = weakref.WeakSet()


def wait_for_compilation() -> None:
    """Block until every pool's in-flight variants are built (useful
    before timing a first call)."""
    for pool in list(_ALL_POOLS):
        pool.wait_for_compilation()


def _domain_key(args) -> Tuple:
    def one(a):
        if isinstance(a, Field):
            return ("field", a.domain, str(a.dtype))
        if isinstance(a, tuple):
            return tuple(one(x) for x in a)
        return ("scalar", type(a).__name__)

    return tuple(one(a) for a in args)


def _on_cuda(args) -> bool:
    def leaves(a):
        if isinstance(a, tuple):
            for x in a:
                yield from leaves(x)
        else:
            yield a

    return any(isinstance(a, Field) and isinstance(a.data, torch.Tensor)
               and a.data.device.type == "cuda" for arg in args for a in leaves(arg))


def build_all(backends) -> int:
    """Build the kernels of ``backends`` (``CudaBackend``s): one nvcc per
    distinct source, all started together (nvcc runs outside the GIL);
    the rest load the built libraries.  Returns the number of distinct
    sources."""
    from gt4py_tpu_torch.cartesian.backend import _build

    first: Dict[str, Any] = {}
    for b in backends:
        first.setdefault(_build.build_key(b.source), b)
    if first:
        with ThreadPoolExecutor(max_workers=len(first)) as ex:
            for fut in [ex.submit(b.build) for b in first.values()]:
                fut.result()
    for b in backends:
        b.build()
    return len(first)


class CompiledProgramsPool:
    """Pool of planned, built variants of one program.

    Parameters
    ----------
    program:
        The ``Program`` (with its backend chosen by ``with_backend``).
    static_params:
        Names of parameters whose values select a variant.
    max_workers:
        Thread-pool width for background planning and building.
    """

    def __init__(self, program, *, static_params: Sequence[str] = (), max_workers: int = 2):
        self.program = program
        self.static_params = tuple(static_params)
        self._programs: Dict[Any, List[Any]] = {}
        self._futures: Dict[Any, Future] = {}
        self._lock = threading.Lock()
        self._pool = ThreadPoolExecutor(max_workers=max_workers)
        _ALL_POOLS.add(self)

    def _compile_one(self, example_args, static_kw) -> List[Any]:
        from .ffront import _canon_value

        prog = self.program
        merged = prog._bind(example_args, static_kw)
        merged = [
            _canon_value(a, None if p.name in prog._out_params else prog._backend)
            for p, a in zip(prog.ir.params, merged)
        ]
        if not getattr(prog._backend, "compiled", ""):
            return []
        backends = prog._plan_kernels(merged)
        if _on_cuda(merged):
            build_all(backends)
        return backends

    def compile(self, example_args: Tuple = (), *, wait: bool = False,
                **static_values: Iterable) -> "CompiledProgramsPool":
        """Plan and build one variant per combination of ``static_values``
        against ``example_args``: ``compile((x, y), n=[1, 2])`` prepares
        the variants ``n=1`` and ``n=2`` in the background."""
        names = list(static_values)
        unknown = set(names) - set(self.static_params)
        if unknown:
            raise ValueError(
                f"not static params: {sorted(unknown)} "
                f"(declared: {list(self.static_params)})"
            )
        for combo in itertools.product(*(static_values[n] for n in names)):
            kw = dict(zip(names, combo))
            key = (tuple(kw.get(n) for n in self.static_params), _domain_key(example_args))
            with self._lock:
                if key in self._programs or key in self._futures:
                    continue
                self._futures[key] = self._pool.submit(self._compile_one, example_args, kw)
        if wait:
            self.wait_for_compilation()
        return self

    def wait_for_compilation(self) -> None:
        """Block until every in-flight variant is planned and built
        (re-raises planning and build errors)."""
        while True:
            with self._lock:
                if not self._futures:
                    return
                key, fut = next(iter(self._futures.items()))
            kernels = fut.result()
            with self._lock:
                self._programs[key] = kernels
                self._futures.pop(key, None)

    @property
    def compiled_keys(self):
        with self._lock:
            return list(self._programs)
