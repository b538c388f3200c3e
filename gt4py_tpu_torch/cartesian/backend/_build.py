"""Build generated CUDA C++ into a shared library and load it with ctypes.

The source includes ``gt4py_tpu_torch/csrc/stencil_runtime.cuh`` and no
PyTorch header, so nvcc builds it in seconds.  Each build lands in
``config.BUILD_DIR/<sha256 of source, runtime header and flags>/``; a
library already there is loaded without rebuilding.  An nvcc failure
raises with nvcc's stderr.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Tuple

from gt4py_tpu_torch import config

RUNTIME_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc")

#: nvcc flags: Hopper target with the architecture-specific features
#: (sm_90a), a plain C interface (no torch headers), ptxas resource report
#: kept in the build log.  ``--fmad=false``: no contraction of ``a * b + c``
#: into one fused multiply-add, so every operation rounds as it does in the
#: oracle and the plain executor.  The flux limiter of the horizontal
#: diffusion is discontinuous, so a one-ulp difference can flip a flux and
#: grow over steps; without contraction the kernels agree with the plain
#: version bit for bit.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


class BuildError(RuntimeError):
    pass


def nvcc_path() -> str:
    for var in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(var)
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"  # the toolkit's standard prefix
    if os.path.exists(default):
        return default
    raise BuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _runtime_header() -> str:
    with open(os.path.join(RUNTIME_DIR, "stencil_runtime.cuh")) as f:
        return f.read()


def build_key(source: str) -> str:
    h = hashlib.sha256()
    for part in (source, _runtime_header(), " ".join(NVCC_FLAGS)):
        h.update(part.encode())
        h.update(b"\0")
    return h.hexdigest()


def build(source: str, name: str) -> Tuple[ctypes.CDLL, str]:
    """Compile ``source`` (unless already built) and load it.  Returns the
    library and its build directory, which also holds ``build.log`` with
    ptxas' register and spill report."""
    out_dir = os.path.join(config.BUILD_DIR, build_key(source))
    lib_path = os.path.join(out_dir, f"lib{name}.so")
    if not os.path.exists(lib_path):
        os.makedirs(out_dir, exist_ok=True)
        src_path = os.path.join(out_dir, f"{name}.cu")
        with open(src_path, "w") as f:
            f.write(source)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-I", RUNTIME_DIR, "-o", tmp, src_path]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        with open(os.path.join(out_dir, "build.log"), "w") as f:
            f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise BuildError(
                f"nvcc failed for {name} (exit {proc.returncode}):\n{proc.stderr}"
            )
        os.replace(tmp, lib_path)  # atomic: concurrent builders agree
    lib = ctypes.CDLL(lib_path)
    return lib, out_dir
