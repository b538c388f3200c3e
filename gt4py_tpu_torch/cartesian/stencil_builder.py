"""Build orchestration: definition function -> parsed IR -> analysis ->
backend -> StencilObject.

Counterpart of ``gt4py_tpu.cartesian.stencil_builder`` (reference:
src/gt4py/cartesian/stencil_builder.py:27-301).  Built stencils are cached
in-process by their semantic fingerprint, and their parsed IR across
processes by ``artifact_cache`` (the ``"cuda"`` backend caches its compiled
kernels by source hash).
"""

from __future__ import annotations

import hashlib
import inspect
import time
from typing import Any, Dict, Optional

from gt4py_tpu_torch import config
from gt4py_tpu_torch.cartesian import analysis as analysis_mod
from gt4py_tpu_torch.cartesian import backend as backend_mod
from gt4py_tpu_torch.cartesian import passes as passes_mod
from gt4py_tpu_torch.cartesian.frontend import parse_definition
from gt4py_tpu_torch.cartesian.stencil_object import StencilObject

_STENCIL_CACHE: Dict[str, StencilObject] = {}


class StencilBuilder:
    def __init__(self, definition, *, backend: Optional[str] = None,
                 externals: Optional[Dict[str, Any]] = None,
                 dtypes: Optional[Dict[Any, Any]] = None, name: Optional[str] = None,
                 rebuild: bool = False, build_info: Optional[Dict[str, Any]] = None,
                 options: Optional[Dict[str, Any]] = None):
        self.definition = definition
        self.backend_name = backend or config.DEFAULT_BACKEND
        self.externals = dict(externals or {})
        self.dtypes = dict(dtypes or {})
        self.name = name or definition.__name__
        self.rebuild = rebuild
        self.build_info = build_info
        self.options = dict(options or {})
        self._analysis: Optional[analysis_mod.StencilAnalysis] = None

    def stencil_id(self) -> str:
        """Semantic fingerprint of definition source, annotations,
        externals, dtypes, backend and options."""
        try:
            source = inspect.getsource(self.definition)
        except (OSError, TypeError):
            source = repr(self.definition)
        annotations = {
            k: repr(v) for k, v in getattr(self.definition, "__annotations__", {}).items()
        }
        key = repr((
            # the literal precisions the frontend reads from the config
            (config.LITERAL_FLOAT_PRECISION, config.LITERAL_INT_PRECISION),
            source,
            self.name,
            sorted(annotations.items()),
            self._helper_sources(),
            sorted((k, repr(v)) for k, v in self.externals.items()),
            sorted((repr(k), repr(v)) for k, v in self.dtypes.items()),
            self.backend_name,
            sorted((k, repr(v)) for k, v in self.options.items()),
        ))
        return hashlib.sha256(key.encode()).hexdigest()[:32]

    def _helper_sources(self):
        """Sources of every ``@gtscript.function`` reachable from the
        definition (globals, closures, externals, module attributes, and
        helpers' own callees -- transitively): inlined helper bodies are
        part of the stencil's semantics, so they must be part of the
        fingerprint (otherwise editing a helper serves stale cached IR
        across processes)."""
        import types

        from gt4py_tpu_torch.cartesian.gtscript import GTScriptFunction

        out: Dict[str, str] = {}
        seen_fns: set = set()
        seen_mods: set = set()

        def scan_value(name, v, depth):
            if isinstance(v, GTScriptFunction):
                if id(v) in seen_fns:
                    return
                seen_fns.add(id(v))
                try:
                    src = inspect.getsource(v.definition)
                except (OSError, TypeError):
                    src = repr(v.definition)
                out[f"{getattr(v.definition, '__module__', '?')}.{name}"] = src
                scan_fn(v.definition, depth + 1)
            elif isinstance(v, types.ModuleType) and depth <= 1:
                # one level into directly-referenced modules: the parser
                # resolves `helpers.fn(...)` attribute calls
                if id(v) in seen_mods or v.__name__.startswith(("numpy", "torch")):
                    return
                seen_mods.add(id(v))
                for n2, v2 in vars(v).items():
                    if isinstance(v2, GTScriptFunction):
                        scan_value(n2, v2, depth + 1)

        def scan_fn(fn, depth):
            if depth > 4:
                return
            for n, v in getattr(fn, "__globals__", {}).items():
                scan_value(n, v, depth)
            for cell in getattr(fn, "__closure__", None) or ():
                try:
                    scan_value("<closure>", cell.cell_contents, depth)
                except ValueError:
                    pass

        scan_fn(self.definition, 0)
        for n, v in self.externals.items():
            scan_value(n, v, 0)
        return sorted(out.items())

    @property
    def analysis(self) -> analysis_mod.StencilAnalysis:
        if self._analysis is None:
            from gt4py_tpu_torch.cartesian import artifact_cache

            sid = self.stencil_id()
            if not self.rebuild:
                self._analysis = artifact_cache.load(sid)
            if self._analysis is None:
                stencil_ir = parse_definition(
                    self.definition,
                    externals=self.externals,
                    dtypes=self.dtypes,
                    name=self.name,
                    literal_precision=self.options.get("literal_precision"),
                )
                # 16-bit floats are storage formats; statements compute in f32
                stencil_ir = passes_mod.widen_f16_compute(stencil_ir)
                self._analysis = analysis_mod.analyze(stencil_ir)
                artifact_cache.save(sid, self._analysis)
        return self._analysis

    def build(self) -> StencilObject:
        sid = self.stencil_id()
        if not self.rebuild and sid in _STENCIL_CACHE:
            return _STENCIL_CACHE[sid]
        info = self.build_info if self.build_info is not None else {}
        t0 = time.perf_counter()
        analysis = self.analysis
        info["parse_time"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        backend = backend_mod.from_name(self.backend_name)(analysis, self.options)
        info["codegen_time"] = time.perf_counter() - t0
        info["build_time"] = info["parse_time"] + info["codegen_time"]
        obj = StencilObject(analysis=analysis, backend=backend,
                            backend_name=self.backend_name, name=self.name,
                            options=self.options, stencil_id=sid)
        _STENCIL_CACHE[sid] = obj

        from gt4py_tpu_torch.instrumentation import stencil_build_hook

        stencil_build_hook.fire(name=self.name, backend=self.backend_name, stencil_id=sid)
        return obj


class LazyStencil:
    """Deferred build handle (reference: gtscript.lazy_stencil, :355-506)."""

    def __init__(self, builder: StencilBuilder):
        self.builder = builder
        self._impl: Optional[StencilObject] = None

    @property
    def implementation(self) -> StencilObject:
        if self._impl is None:
            self._impl = self.builder.build()
        return self._impl

    @property
    def backend(self) -> str:
        return self.builder.backend_name

    @property
    def field_info(self):
        return self.implementation.field_info

    def check_syntax(self) -> None:
        self.builder.analysis  # parse + validate, no backend build

    def __call__(self, *args, **kwargs):
        return self.implementation(*args, **kwargs)

    def run(self, *args, **kwargs):
        return self.implementation.run(*args, **kwargs)
