"""Exception taxonomy with source context.

Reference parity: src/gt4py/next/errors/ (DSLError with source location,
pretty excepthook) -- compacted to an exception hierarchy plus a source-
frame formatter the frontend uses to point at the offending stencil line.
"""

from __future__ import annotations

import inspect
import textwrap
from typing import Optional


class GT4PyTpuError(Exception):
    """Base class for all framework errors."""


class DSLError(GT4PyTpuError):
    """An error in user DSL code, annotated with the source location."""

    def __init__(self, message: str, *, definition=None, lineno: Optional[int] = None):
        self.raw_message = message
        self.lineno = lineno
        super().__init__(format_with_source(message, definition, lineno))


def format_with_source(message: str, definition, lineno: Optional[int]) -> str:
    """Append a caret-annotated source excerpt to ``message``."""
    if definition is None or lineno is None:
        return message
    try:
        lines, start = inspect.getsourcelines(definition)
    except (OSError, TypeError):
        return message
    # lineno is relative to the dedented definition source (1-based)
    idx = lineno - 1
    if not (0 <= idx < len(lines)):
        return message
    fname = getattr(inspect.getmodule(definition), "__file__", "<unknown>")
    excerpt = textwrap.dedent("".join(lines[max(0, idx - 1) : idx + 1]))
    pointer = "    " + excerpt.rstrip("\n").splitlines()[-1]
    return (
        f"{message}\n"
        f'  in stencil "{definition.__name__}" ({fname}:{start + idx})\n'
        f"{pointer}\n"
    )
