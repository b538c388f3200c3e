"""Typed hook registries for instrumentation/extension points.

Reference parity: src/gt4py/next/instrumentation/hook_machinery.py:54-199
(EventHook/ContextHook registries) and hooks.py:11-18 (the hook points).
Hook points here: ``stencil_call`` (context manager around every stencil
call) and ``stencil_build`` (event after a stencil is built).
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Iterator, List


class EventHook:
    """A named list of callbacks fired with (name, **kwargs)."""

    def __init__(self, name: str):
        self.name = name
        self._callbacks: List[Callable] = []

    def register(self, fn: Callable) -> Callable:
        self._callbacks.append(fn)
        return fn

    def unregister(self, fn: Callable) -> None:
        self._callbacks.remove(fn)

    def fire(self, **kwargs: Any) -> None:
        for fn in self._callbacks:
            fn(**kwargs)


class ContextHook:
    """A named list of context-manager factories entered around an event."""

    def __init__(self, name: str):
        self.name = name
        self._factories: List[Callable] = []

    def register(self, fn: Callable) -> Callable:
        self._factories.append(fn)
        return fn

    def unregister(self, fn: Callable) -> None:
        self._factories.remove(fn)

    @contextlib.contextmanager
    def activate(self, **kwargs: Any) -> Iterator[None]:
        with contextlib.ExitStack() as stack:
            for factory in self._factories:
                stack.enter_context(factory(**kwargs))
            yield


#: fired after a stencil object is built: (name, backend, stencil_id)
stencil_build_hook = EventHook("stencil_build")

#: entered around every stencil call: (name, backend)
stencil_call_context = ContextHook("stencil_call")


#: entered around every next Program call: (name, compiled: bool)
#: (reference: hooks.program_call_context / embedded_program_call_context)
program_call_context = ContextHook("program_call")

#: entered around compiled-variant dispatch: (name, variant)
#: (reference: hooks.compiled_program_call_context)
compiled_program_call_context = ContextHook("compiled_program_call")

#: fired when the AOT pool compiles a new variant: (name, static_key)
#: (reference: hooks.compile_variant_hook)
compile_variant_hook = EventHook("compile_variant")
