"""Small shared utilities: checkpoints and resilient step loops."""

from __future__ import annotations

from typing import Any


class Registry(dict):
    """Name -> object registry (as ``gt4py_tpu.utils.Registry``)."""

    def register(self, name: str, item: Any = None):
        if item is None:

            def _reg(obj):
                self[name] = obj
                return obj

            return _reg
        self[name] = item
        return item

    @property
    def names(self):
        return list(self.keys())
