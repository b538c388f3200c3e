"""Build orchestration: definition function -> parsed IR -> analysis ->
backend -> StencilObject.

Counterpart of ``gt4py_tpu.cartesian.stencil_builder`` (reference:
src/gt4py/cartesian/stencil_builder.py:27-301).  Built stencils are cached
in-process by their semantic fingerprint; there is no on-disk analysis
cache (the ``"cuda"`` backend caches its compiled kernels by source hash).
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
            source,
            self.name,
            sorted(annotations.items()),
            sorted((k, repr(v)) for k, v in self.externals.items()),
            sorted((repr(k), repr(v)) for k, v in self.dtypes.items()),
            self.backend_name,
            sorted((k, repr(v)) for k, v in self.options.items()),
        ))
        return hashlib.sha256(key.encode()).hexdigest()[:32]

    @property
    def analysis(self) -> analysis_mod.StencilAnalysis:
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
