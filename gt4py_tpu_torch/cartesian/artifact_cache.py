"""Cross-process artifact cache for analyzed stencils.

Counterpart of ``gt4py_tpu.cartesian.artifact_cache`` (reference: the
FileCache / module-artifact cache behind the reference's generated
backends, src/gt4py/cartesian/backend/module_generator.py + gt4py._core
FileCache).  The compiled kernels are cached by the ``"cuda"`` backend by
source hash (``config.BUILD_DIR``); this cache persists the parsed stencil
IR so warm processes skip the frontend.

Staleness guards:
- the key is the builder's semantic fingerprint (source + annotations +
  externals + options + the sources of every reachable
  ``@gtscript.function`` helper -- see ``StencilBuilder.stencil_id``);
- the package version salts the filename (schema changes invalidate);
- so does a hash of the sources that make the cached IR (the frontend,
  ``gtscript``, ``ir`` and ``passes``: ``FRONTEND_MODULES``), so IR parsed
  by another tree's code is never loaded;
- writes are atomic (temp file + rename), concurrent writers race
  benignly (last rename wins, both contents identical).

Lives under ``config.CACHE_ROOT``; ``GT4PY_TPU_TORCH_ARTIFACT_CACHE=0``
(``config.ARTIFACT_CACHE = False``) disables it.
"""

from __future__ import annotations

import functools
import hashlib
import os
import pickle
import tempfile

from gt4py_tpu_torch import config

#: the modules, relative to ``gt4py_tpu_torch/cartesian``, whose code makes
#: the IR this cache keeps
FRONTEND_MODULES = ("frontend/__init__.py", "frontend/parser.py", "gtscript.py", "ir.py",
                    "passes.py")


def sources_hash(root: str) -> str:
    """A hash of the ``FRONTEND_MODULES`` sources under ``root``."""
    h = hashlib.sha256()
    for rel in FRONTEND_MODULES:
        with open(os.path.join(root, rel), "rb") as f:
            h.update(f.read())
        h.update(b"\0")
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def frontend_hash() -> str:
    """``sources_hash`` of this package's frontend (read once a process)."""
    return sources_hash(os.path.dirname(os.path.abspath(__file__)))


def _path(sid: str) -> str:
    from gt4py_tpu_torch import __version__

    return os.path.join(config.CACHE_ROOT, "artifacts",
                        f"{sid}-v{__version__}-{frontend_hash()}.pkl")


def load(sid: str):
    """The cached StencilAnalysis for ``sid``, or None.

    Only the parsed stencil IR is persisted; the analysis re-runs on
    load.  Analysis tables are keyed by statement object identity
    (``id(stmt)``), which dangles after unpickling -- persisting the
    whole StencilAnalysis silently served wrong per-statement extents
    (caught by the JAX package's FV oracle parity test)."""
    if not config.ARTIFACT_CACHE:
        return None
    try:
        with open(_path(sid), "rb") as f:
            stencil_ir = pickle.load(f)
    except (OSError, pickle.UnpicklingError, AttributeError, EOFError,
            ImportError, IndexError):
        return None
    from gt4py_tpu_torch.cartesian import analysis as analysis_mod

    try:
        return analysis_mod.analyze(stencil_ir)
    except Exception:
        return None


def save(sid: str, analysis) -> None:
    if not config.ARTIFACT_CACHE:
        return
    path = _path(sid)
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                pickle.dump(analysis.stencil, f, protocol=pickle.HIGHEST_PROTOCOL)
            os.replace(tmp, path)  # atomic on POSIX
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    except (OSError, pickle.PicklingError, TypeError, AttributeError):
        pass  # best-effort: the cache never breaks a build
