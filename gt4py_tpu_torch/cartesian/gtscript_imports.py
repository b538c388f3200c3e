"""GTScript import machinery: ``import`` ``.gt.py`` files as modules.

Reference behavior being reproduced: src/gt4py/cartesian/gtscript_imports.py
(GtsFinder/GtsLoader, enable/enabled).  The reference copies each GTScript
source into a generated ``.py`` module and loads that; here tracing replaces
code generation, so the loader executes the ``.gt.py`` file directly -- any
``@gtscript.stencil`` decorators inside build (or lazily defer) through the
normal pipeline, and ``inspect.getsource`` keeps working because the module's
``__file__`` is the real on-disk source.

Usage::

    from gt4py_tpu_torch.cartesian import gtscript_imports

    gtscript_imports.enable()                   # .gt.py anywhere on sys.path
    gtscript_imports.enable(search_path=[dir])  # restricted search path

    with gtscript_imports.enabled(search_path=[dir]):
        import my_stencils  # finds my_stencils.gt.py
"""

from __future__ import annotations

import importlib.abc
import importlib.machinery
import pathlib
import sys
from contextlib import contextmanager
from typing import List, Optional, Union

#: recognized GTScript file extensions (reference: GTS_EXTENSIONS)
GTS_EXTENSIONS = [".gt.py", ".gtscript"]


class GtsLoader(importlib.machinery.SourceFileLoader):
    """Load a GTScript file as a plain python module.

    The file is ordinary python using the gtscript DSL; stencils build
    through tracing at decoration (or first call, for lazy stencils), so no
    intermediate module needs to be generated.
    """


class GtsFinder(importlib.abc.MetaPathFinder):
    """Find ``<name>.gt.py`` / ``<name>.gtscript`` files on the search path.

    Parameters
    ----------
    search_path:
        Directories to search; defaults to ``sys.path``.
    """

    def __init__(
        self, search_path: Optional[List[Union[str, pathlib.Path]]] = None
    ):
        self.search_path = search_path

    def iter_search_candidates(self, fullname: str, path=None):
        search_paths = list(self.search_path or sys.path)
        search_paths.extend(path or [])
        stem = fullname.rsplit(".", 1)[-1]
        for sp in search_paths:
            sp = pathlib.Path(sp)
            for ext in GTS_EXTENSIONS:
                yield (sp.absolute() / (stem + ext))

    def find_spec(self, fullname: str, path=None, target=None):
        if fullname in sys.modules:
            return None
        for candidate in self.iter_search_candidates(fullname, path):
            if candidate.exists():
                spec = importlib.machinery.ModuleSpec(
                    name=fullname,
                    loader=GtsLoader(fullname, str(candidate)),
                    origin=str(candidate),
                    is_package=False,
                )
                spec.has_location = True
                return spec
        return None

    def install(self) -> None:
        sys.meta_path.append(self)
        if self.search_path:
            sys.path.extend(str(p) for p in self.search_path)

    def uninstall(self) -> None:
        if self in sys.meta_path:
            sys.meta_path.remove(self)
        if self.search_path:
            for p in self.search_path:
                while str(p) in sys.path:
                    sys.path.remove(str(p))


def enable(
    search_path: Optional[List[Union[str, pathlib.Path]]] = None,
) -> GtsFinder:
    """Install (and return) a finder for GTScript files."""
    finder = GtsFinder(search_path=search_path)
    finder.install()
    return finder


def disable(finder: GtsFinder) -> None:
    """Remove a finder installed by :func:`enable`."""
    finder.uninstall()


@contextmanager
def enabled(search_path: Optional[List[Union[str, pathlib.Path]]] = None):
    """Scoped :func:`enable`."""
    finder = enable(search_path=search_path)
    try:
        yield finder
    finally:
        disable(finder)
