"""Native grid IO: binary save/load of field arrays.

Counterpart of ``gt4py_tpu.io``, in the same file format (a header, then
the raw data in C order; ``csrc/gridio.cpp`` documents it), so files
written by either package read in the other.  The C++ (``csrc/gridio.cpp``,
a copy of the JAX package's) is built with g++ at first use into
``config.BUILD_DIR`` and bound via ctypes; a failed build raises
``BuildError``.  ``save_grid_plain`` / ``load_grid_plain`` are the plain
numpy reader and writer of the same format.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
import threading
from typing import Tuple

import numpy as np

from gt4py_tpu_torch import config

_DTYPE_CODES = {
    np.dtype(np.float32): ord("f"),
    np.dtype(np.float64): ord("d"),
    np.dtype(np.int32): ord("i"),
    np.dtype(np.int64): ord("q"),
}
_CODE_DTYPES = {v: k for k, v in _DTYPE_CODES.items()}
_MAGIC = 0x4754345055474944
_VERSION = 1
_MAX_DIMS = 8
#: magic u64, version u32, dtype u32, ndim u32, pad u32, dims u64[8]
_HEADER = struct.Struct("<QIIII8Q")

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")

_lib = None
_lib_lock = threading.Lock()


class BuildError(RuntimeError):
    pass


def _build_native() -> ctypes.CDLL:
    """Compile gridio.cpp into ``config.BUILD_DIR/host`` (once per source
    hash) and load it."""
    src = os.path.join(_CSRC, "gridio.cpp")
    with open(src, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    out_dir = os.path.join(config.BUILD_DIR, "host")
    so = os.path.join(out_dir, f"libgridio_{tag}.so")
    if not os.path.exists(so):
        os.makedirs(out_dir, exist_ok=True)
        tmp = f"{so}.tmp{os.getpid()}"
        proc = subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
                               src, "-o", tmp], capture_output=True, text=True)
        if proc.returncode != 0:
            raise BuildError(f"g++ failed for gridio.cpp:\n{proc.stderr}")
        os.replace(tmp, so)  # atomic: concurrent builders race safely
    lib = ctypes.CDLL(so)
    lib.gridio_write.restype = ctypes.c_int
    lib.gridio_write.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_uint32,
                                 ctypes.c_uint32, ctypes.POINTER(ctypes.c_uint64)]
    lib.gridio_probe.restype = ctypes.c_int
    lib.gridio_probe.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint32),
                                 ctypes.POINTER(ctypes.c_uint32),
                                 ctypes.POINTER(ctypes.c_uint64)]
    lib.gridio_read.restype = ctypes.c_int
    lib.gridio_read.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_uint64]
    return lib


def _native() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = _build_native()
    return _lib


def _array(array) -> np.ndarray:
    """A C-ordered host copy (a tensor moves to the host)."""
    if hasattr(array, "detach"):
        array = array.detach().cpu().numpy()
    arr = np.ascontiguousarray(np.asarray(array))
    if arr.dtype not in _DTYPE_CODES:
        raise TypeError(f"Unsupported dtype {arr.dtype} for grid IO")
    if not 1 <= arr.ndim <= _MAX_DIMS:
        raise ValueError(f"grid IO takes 1 to {_MAX_DIMS} dimensions, got {arr.ndim}")
    return arr


def save_grid(path: str, array) -> str:
    """Write an array (numpy or tensor) as a grid record."""
    arr = _array(array)
    dims = (ctypes.c_uint64 * arr.ndim)(*arr.shape)
    rc = _native().gridio_write(path.encode(), arr.ctypes.data_as(ctypes.c_void_p),
                                _DTYPE_CODES[arr.dtype], arr.ndim, dims)
    if rc != 0:
        raise OSError(f"gridio_write failed with code {rc} for {path}")
    return path


def probe_grid(path: str) -> Tuple[np.dtype, Tuple[int, ...]]:
    """(dtype, shape) of a grid record, from its header."""
    dtype = ctypes.c_uint32()
    ndim = ctypes.c_uint32()
    dims = (ctypes.c_uint64 * _MAX_DIMS)()
    rc = _native().gridio_probe(path.encode(), ctypes.byref(dtype), ctypes.byref(ndim), dims)
    if rc != 0:
        raise OSError(f"gridio_probe failed with code {rc} for {path}")
    return _CODE_DTYPES[dtype.value], tuple(int(dims[i]) for i in range(ndim.value))


def load_grid(path: str) -> np.ndarray:
    """Read a grid record (mmap + multithreaded copy)."""
    dtype, shape = probe_grid(path)
    out = np.empty(shape, dtype=dtype)
    rc = _native().gridio_read(path.encode(), out.ctypes.data_as(ctypes.c_void_p), out.nbytes)
    if rc != 0:
        raise OSError(f"gridio_read failed with code {rc} for {path}")
    return out


def save_grid_plain(path: str, array) -> str:
    """``save_grid`` in numpy: the same bytes."""
    arr = _array(array)
    dims = list(arr.shape) + [0] * (_MAX_DIMS - arr.ndim)
    with open(path, "wb") as f:
        f.write(_HEADER.pack(_MAGIC, _VERSION, _DTYPE_CODES[arr.dtype], arr.ndim, 0, *dims))
        f.write(arr.tobytes())
    return path


def load_grid_plain(path: str) -> np.ndarray:
    """``load_grid`` in numpy."""
    with open(path, "rb") as f:
        head = f.read(_HEADER.size)
        if len(head) != _HEADER.size:
            raise OSError(f"{path} is not a grid record")
        magic, version, code, ndim, _, *dims = _HEADER.unpack(head)
        if magic != _MAGIC or version != _VERSION or not 1 <= ndim <= _MAX_DIMS \
                or code not in _CODE_DTYPES:
            raise OSError(f"{path} is not a grid record")
        shape = tuple(dims[:ndim])
        out = np.fromfile(f, dtype=_CODE_DTYPES[code])
    if out.size != int(np.prod(shape)):
        raise OSError(f"{path}: the data does not match its header's shape {shape}")
    return out.reshape(shape)
