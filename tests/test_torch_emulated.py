"""The generated CUDA kernels, compiled for and run on the CPU.

The ``"cuda"`` backend's sources are C++ apart from the CUDA qualifiers and
the ``<<<grid, block>>>`` launches.  Here the host C++ compiler builds each
source against a stub ``cuda_runtime.h`` that runs the grid as nested loops
-- exact for these kernels, whose threads share nothing -- and the
wrapper's launch path runs unchanged on CPU tensors: per-field records
(strides, data strides, K range), scratch allocation and zero-fill,
section K bounds and scalars.  The results are held against the plain
executor: every canonical stencil of ``tests/cartesian/stencil_defs.py``
(``while``, regions, variable and absolute K, data dimensions), the
``gt4py_tpu_torch.testing.SURFACE`` forms, the card tests' emitter
stencils and three FullDycore steps, at rtol 1e-12 / atol 1e-12 in
float64 (the host's ``sin``/``exp`` differ from torch's by an ulp) and
exactly in float32.

What this cannot show -- that nvcc accepts a source, and the card's
rounding -- the ``cuda``-marked tests and ``chip_smoke.py`` show on the
card.  Without a host C++ compiler the tests skip.
"""

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from gt4py_tpu_torch import testing
from gt4py_tpu_torch.cartesian import gtscript
from gt4py_tpu_torch.cartesian.backend import _build, cuda_backend
from gt4py_tpu_torch.models import full_dycore

from .test_torch_cuda import DEFS, _inputs

#: the CUDA runtime as the generated sources use it, on the host: every
#: thread of the grid runs in turn
EMULATED_RUNTIME = r"""
#pragma once
#include <math.h>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline dim3 blockIdx, threadIdx, blockDim, gridDim;
typedef int cudaError_t;
const cudaError_t cudaSuccess = 0;
typedef struct CUstream_st* cudaStream_t;
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
#define GT_EMULATED_LAUNCH(grid, block, kernel, ...)                          \
  do {                                                                      \
    gridDim = grid;                                                         \
    blockDim = block;                                                       \
    for (unsigned by = 0; by < gridDim.y; ++by)                             \
      for (unsigned bx = 0; bx < gridDim.x; ++bx)                           \
        for (unsigned ty = 0; ty < blockDim.y; ++ty)                        \
          for (unsigned tx = 0; tx < blockDim.x; ++tx) {                    \
            blockIdx = dim3(bx, by);                                        \
            threadIdx = dim3(tx, ty);                                       \
            kernel(__VA_ARGS__);                                            \
          }                                                                 \
  } while (0)
"""

_LAUNCH = re.compile(r"(\w+)<<<grid, block, 0, st>>>\((.*)\);")


class _Stream:
    cuda_stream = 0


@pytest.fixture(scope="module")
def emulated_dir(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++)")
    d = tmp_path_factory.mktemp("emulated")
    (d / "cuda_runtime.h").write_text(EMULATED_RUNTIME)
    return cxx, d


@pytest.fixture
def emulated(monkeypatch, emulated_dir):
    """``backend="cuda"`` on CPU tensors runs the generated kernels, built
    by the host compiler against the emulated runtime."""
    cxx, d = emulated_dir

    def build(source, name):
        src = _LAUNCH.sub(r"GT_EMULATED_LAUNCH(grid, block, \1, \2);", source)
        out = d / hashlib.sha256(src.encode() + _build._runtime_header().encode()).hexdigest()
        lib = out / f"lib{name}.so"
        if not lib.exists():
            out.mkdir(exist_ok=True)
            (out / f"{name}.cpp").write_text(src)
            proc = subprocess.run(
                [cxx, "-std=c++17", "-O0", "-ffp-contract=off", "-shared", "-fPIC",
                 "-I", str(d), "-I", _build.RUNTIME_DIR, "-o", str(lib), str(out / f"{name}.cpp")],
                capture_output=True, text=True)
            assert proc.returncode == 0, proc.stderr[:4000]
        return ctypes.CDLL(str(lib)), str(out)

    monkeypatch.setattr(_build, "build", build)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    monkeypatch.setattr(cuda_backend.CudaBackend, "apply",
                        lambda self, env, scalars, domain, origins, periodic=():
                        self._launch(env, scalars, domain, origins, periodic))


REGISTRY = testing.load_stencil_defs()
CASES = {**{f"defs_{n}": testing.registry_case(e) for n, e in sorted(REGISTRY.items())},
         **{f"surface_{n}": c for n, c in testing.SURFACE.items()}}


@pytest.mark.parametrize("name", list(CASES))
def test_language_surface_emulated_vs_plain(emulated, name):
    got, ref, st = testing.run_pair(*CASES[name], "cpu")
    assert st.backend.launches == 1
    for k, v in ref.items():
        torch.testing.assert_close(got[k], v, rtol=1e-12, atol=1e-12, msg=k)


@pytest.mark.parametrize("name", list(DEFS))
def test_emitter_stencils_emulated_vs_plain(emulated, name):
    got = {}
    for backend in ("cuda", "torch"):
        st = gtscript.stencil(backend=backend, definition=DEFS[name], rebuild=True)
        fields, scalars, kw = _inputs(name, "cpu")
        tensors = {k: torch.from_numpy(v) for k, v in fields.items()}
        st(**tensors, **scalars, **kw)
        got[backend] = tensors
    for k, v in got["torch"].items():
        torch.testing.assert_close(got["cuda"][k], v, rtol=1e-12, atol=1e-12, msg=k)


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "tight"])
def test_full_dycore_emulated_vs_plain(emulated, aligned, dtype):
    """Three FullDycore steps: every kernel of the slice's main path
    (hdiff, vadv_update, fv_step's 13 stages, sl_step), periodic."""
    got, launched = {}, {}
    for backend in ("cuda", "torch"):
        m = full_dycore.FullDycore(10, 12, 5, dtype=dtype, backend=backend, aligned=aligned,
                                   device="cpu")
        stencils = (m.dyn.hdiff, m.dyn.vadv_upd, m.fv.fv_step, m.sl)
        before = [getattr(st.backend, "launches", 0) for st in stencils]
        state = m.init_state(seed=4)
        step = m.step_fn()
        for _ in range(3):
            state = step(state)
        got[backend] = state
        launched[backend] = [getattr(st.backend, "launches", 0) - b
                             for st, b in zip(stencils, before)]
    assert launched["cuda"] == [3, 3, 3, 3]
    for k, v in got["torch"].items():
        torch.testing.assert_close(got["cuda"][k], v, rtol=0, atol=0, msg=k)
