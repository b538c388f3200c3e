"""Models built on the stencil DSL (counterpart of gt4py_tpu.models).

This slice ports the mini dynamical core; the other models follow.
"""

from .dycore import MiniDycore  # noqa: F401
