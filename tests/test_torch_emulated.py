"""The generated CUDA kernels, compiled for and run on the CPU.

The ``"cuda"`` backend's sources are C++ apart from the CUDA qualifiers and
the ``<<<grid, block>>>`` launches.  Here the host C++ compiler builds each
source against a stub ``cuda_runtime.h`` that runs the grid as nested loops
-- exact for kernels whose threads share nothing; the plane-sweep and
K-window kernels, which synchronise their blocks, run each block's threads
as fibers that meet at every ``__syncthreads()`` -- and the
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
from gt4py_tpu_torch import config


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points default to the card; these tests ask for
    the CPU."""
    monkeypatch.setattr(config, "DEFAULT_DEVICE", "cpu")


#: the CUDA runtime as the generated sources use it, on the host: every
#: thread of the grid runs in turn; a kernel launched with dynamic shared
#: memory (the plane-sweep and K-window forms, which synchronise their
#: blocks) runs each block's threads as fibers that each run to their next
#: ``__syncthreads()`` in turn, so all of them meet at every barrier
EMULATED_RUNTIME = r"""
#pragma once
#include <math.h>
#include <stddef.h>
#include <string.h>
#include <ucontext.h>
#include <functional>
#include <memory>
#include <utility>
#include <vector>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline dim3 blockIdx, threadIdx, blockDim, gridDim;
typedef int cudaError_t;
const cudaError_t cudaSuccess = 0;
const cudaError_t cudaErrorInvalidValue = 1;
const cudaError_t cudaErrorMisalignedAddress = 716;
typedef struct CUstream_st* cudaStream_t;
enum cudaFuncAttribute {
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
  cudaFuncAttributePreferredSharedMemoryCarveout = 9
};
const int cudaSharedmemCarveoutMaxShared = 100;
struct alignas(16) uint4 { unsigned x, y, z, w; };
// a misaligned 16-byte access faults the launch, as on the card: the access
// is skipped and cudaGetLastError reports it
inline cudaError_t gt_emu_error = cudaSuccess;
// the storages of the running gt_run's fields (GT_STORAGES, for the rest
// of gt_run): a 16-byte access that leaves all of them faults, as one past
// the allocation would (a library that names none, K9's, is not checked)
const cudaError_t cudaErrorIllegalAddress = 700;
inline std::vector<std::pair<const unsigned char*, const unsigned char*>> gt_emu_storage;
inline bool gt_emu_storage_on = false;
struct gt_emu_storage_scope {
  ~gt_emu_storage_scope() { gt_emu_storage_on = false; }
};
template <class... F>
inline gt_emu_storage_scope gt_emu_storages(const F&... f) {
  gt_emu_storage.clear();
  (gt_emu_storage.push_back({f.s0, f.s1}), ...);
  gt_emu_storage_on = true;
  return {};
}
#define GT_STORAGES(...) const gt_emu_storage_scope gt_emu_scope_ = gt_emu_storages(__VA_ARGS__)
inline bool gt_emu_in_storage(const void* p) {
  if (!gt_emu_storage_on) return true;
  const unsigned char* b = reinterpret_cast<const unsigned char*>(p);
  for (const auto& r : gt_emu_storage)
    if (b >= r.first && b + 16 <= r.second) return true;
  gt_emu_error = cudaErrorIllegalAddress;
  return false;
}
inline bool gt_emu_aligned16(const void* p) {
  if ((reinterpret_cast<size_t>(p) & 15) != 0) {
    gt_emu_error = cudaErrorMisalignedAddress;
    return false;
  }
  return gt_emu_in_storage(p);
}
inline bool gt_emu_aligned(const void* p, size_t n) {
  if ((reinterpret_cast<size_t>(p) & (n - 1)) == 0) return true;
  gt_emu_error = cudaErrorMisalignedAddress;
  return false;
}
#define GT_VECTOR_ALIGNED(p) gt_emu_aligned16(p)
// cp.async as a synchronous copy (a misaligned one faults, as on the card,
// and so does a 16-byte one whose source leaves the fields' storages); the
// library counts its 16-byte copies
#define GT_ASYNC_COPY
inline long long gt_emu_copies16 = 0;
extern "C" long long gt_emu_copies16_count() { return gt_emu_copies16; }
namespace gt {
template <int Bytes>
inline void async_copy(void* smem, const void* gmem) {
  if (gt_emu_aligned(smem, Bytes) && gt_emu_aligned(gmem, Bytes) &&
      (Bytes != 16 || gt_emu_in_storage(gmem)))
    memcpy(smem, gmem, Bytes);
  if (Bytes == 16) ++gt_emu_copies16;
}
inline void async_commit() {}
template <int N>
inline void async_wait() {}
}  // namespace gt
// the staged kernels' count of reads outside their windows
inline unsigned long long atomicAdd(unsigned long long* p, unsigned long long v) {
  const unsigned long long old = *p;
  *p += v;
  return old;
}
inline cudaError_t cudaGetLastError() {
  const cudaError_t e = gt_emu_error;
  gt_emu_error = cudaSuccess;
  return e;
}
inline const char* cudaGetErrorString(cudaError_t e) {
  return e == cudaErrorMisalignedAddress ? "misaligned address (emulated)"
         : e == cudaErrorIllegalAddress  ? "16-byte access outside the fields' storage (emulated)"
                                         : "emulated";
}
template <typename K>
inline cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) { return cudaSuccess; }
// the H100's occupancy rule without registers: 228 KiB of shared memory a
// SM (1 KiB of it reserved per block), 2048 threads, 32 blocks
template <typename K>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int threads,
                                                                 size_t smem) {
  int by_smem = (int)(233472 / (smem + 1024)), by_threads = 2048 / threads;
  *n = by_smem < by_threads ? by_smem : by_threads;
  if (*n > 32) *n = 32;
  return cudaSuccess;
}

namespace gt_emu {
constexpr size_t kStack = 256 * 1024;
struct Fiber {
  ucontext_t ctx;
  std::unique_ptr<char[]> stack;
  bool done = false;
  unsigned x = 0, y = 0;
};
inline std::vector<Fiber> fibers;
inline ucontext_t scheduler;
inline int current = -1;
inline std::vector<unsigned char> smem;
inline std::vector<unsigned long long> shfl;
inline const std::function<void()>* body = nullptr;
inline void entry() {
  (*body)();
  fibers[current].done = true;  // returns to the scheduler (uc_link)
}
inline void syncthreads() {
  if (current >= 0) swapcontext(&fibers[current].ctx, &scheduler);
}
inline void run_block(const std::function<void()>& fn, size_t smem_bytes) {
  smem.assign(smem_bytes, 0);
  const unsigned n = blockDim.x * blockDim.y;
  shfl.assign(n, 0);
  if (fibers.size() < n) fibers.resize(n);
  body = &fn;
  for (unsigned t = 0; t < n; ++t) {
    Fiber& f = fibers[t];
    if (!f.stack) f.stack.reset(new char[kStack]);
    f.done = false;
    f.x = t % blockDim.x;
    f.y = t / blockDim.x;
    getcontext(&f.ctx);
    f.ctx.uc_stack.ss_sp = f.stack.get();
    f.ctx.uc_stack.ss_size = kStack;
    f.ctx.uc_link = &scheduler;
    makecontext(&f.ctx, entry, 0);
  }
  for (bool left = true; left;) {
    left = false;
    for (unsigned t = 0; t < n; ++t) {
      if (fibers[t].done) continue;
      current = (int)t;
      threadIdx = dim3(fibers[t].x, fibers[t].y);
      swapcontext(&scheduler, &fibers[t].ctx);
      left = left || !fibers[t].done;
    }
  }
  current = -1;
}
}  // namespace gt_emu
#define __syncthreads() gt_emu::syncthreads()
// a warp shuffle: every thread of the block posts its value and meets the
// others at a barrier (the kernels shuffle with whole blocks in step)
template <typename T>
inline T __shfl_xor_sync(unsigned, T v, int d) {
  const unsigned t = threadIdx.x + threadIdx.y * blockDim.x;
  unsigned long long w = 0;
  memcpy(&w, &v, sizeof(T));
  gt_emu::shfl[t] = w;
  __syncthreads();
  w = gt_emu::shfl[t ^ (unsigned)d];
  __syncthreads();
  T r;
  memcpy(&r, &w, sizeof(T));
  return r;
}
#define GT_DYNAMIC_SMEM(name) unsigned char* const name = gt_emu::smem.data()
#define GT_EMULATED_LAUNCH(grid, block, smem_bytes, kernel, ...)              \
  do {                                                                      \
    gridDim = grid;                                                         \
    blockDim = block;                                                       \
    if (smem_bytes) {                                                       \
      const std::function<void()> fn_ = [&] { kernel(__VA_ARGS__); };       \
      for (unsigned bz = 0; bz < gridDim.z; ++bz)                           \
        for (unsigned by = 0; by < gridDim.y; ++by)                         \
          for (unsigned bx = 0; bx < gridDim.x; ++bx) {                     \
            blockIdx = dim3(bx, by, bz);                                    \
            gt_emu::run_block(fn_, smem_bytes);                             \
          }                                                                 \
      break;                                                                \
    }                                                                       \
    for (unsigned bz = 0; bz < gridDim.z; ++bz)                             \
      for (unsigned by = 0; by < gridDim.y; ++by)                           \
        for (unsigned bx = 0; bx < gridDim.x; ++bx)                         \
          for (unsigned ty = 0; ty < blockDim.y; ++ty)                      \
            for (unsigned tx = 0; tx < blockDim.x; ++tx) {                  \
              blockIdx = dim3(bx, by, bz);                                  \
              threadIdx = dim3(tx, ty);                                     \
              kernel(__VA_ARGS__);                                          \
            }                                                               \
  } while (0)
"""

#: ``cuda_fp16.h`` on the host: ``__half`` is the compiler's ``_Float16``,
#: whose conversions round to nearest even, as the card's intrinsics do
EMULATED_FP16 = r"""
#pragma once
typedef _Float16 __half;
inline float __half2float(__half h) { return (float)h; }
inline __half __float2half_rn(float f) { return (__half)f; }
inline __half __double2half(double d) { return (__half)d; }
"""

#: ``cuda_bf16.h`` on the host: ``__nv_bfloat16`` holds the upper half of
#: a float32; the conversion from float rounds to nearest even (NaN to the
#: card's canonical NaN), as ``__float2bfloat16_rn`` and torch do
EMULATED_BF16 = r"""
#pragma once
#include <stdint.h>
#include <string.h>
struct __nv_bfloat16 { uint16_t x; };
inline float __bfloat162float(__nv_bfloat16 h) {
  uint32_t u = (uint32_t)h.x << 16;
  float f;
  memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u;
  memcpy(&u, &f, 4);
  __nv_bfloat16 h;
  if ((u & 0x7fffffffu) > 0x7f800000u) { h.x = 0x7fff; return h; }
  u += 0x7fffu + ((u >> 16) & 1u);
  h.x = (uint16_t)(u >> 16);
  return h;
}
inline float __double2float_rn(double d) { return (float)d; }
"""

_LAUNCH = re.compile(r"(\w+)<<<grid, block, (\w+), st>>>\((.*)\);")


class _Stream:
    cuda_stream = 0


@pytest.fixture(scope="module")
def emulated_dir(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++)")
    d = tmp_path_factory.mktemp("emulated")
    (d / "cuda_runtime.h").write_text(EMULATED_RUNTIME)
    (d / "cuda_fp16.h").write_text(EMULATED_FP16)
    (d / "cuda_bf16.h").write_text(EMULATED_BF16)
    return cxx, d


@pytest.fixture
def emulated(monkeypatch, emulated_dir):
    """``backend="cuda"`` on CPU tensors runs the generated kernels, built
    by the host compiler against the emulated runtime (under K8 when a
    derivative is wanted, as on the card)."""
    cxx, d = emulated_dir

    def build(source, name):
        src = _LAUNCH.sub(r"GT_EMULATED_LAUNCH(grid, block, \2, \1, \3);", source)
        out = d / hashlib.sha256(src.encode() + _build._runtime_header().encode()
                                 + EMULATED_FP16.encode()
                                 + EMULATED_BF16.encode()).hexdigest()
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
    monkeypatch.setattr(cuda_backend.CudaBackend, "apply", cuda_backend.CudaBackend.run_kernels)


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


def test_emulated_half_rounds_as_torch(emulated_dir, tmp_path):
    """The stub's ``__half`` conversions round to nearest even, ties and
    subnormals included: from float as torch's ``.half()`` does; from
    double once, as numpy's ``astype(float16)`` and the card's
    ``__double2half`` do (torch rounds a double through float first)."""
    cxx, d = emulated_dir
    src = tmp_path / "half.cpp"
    src.write_text('#include "cuda_fp16.h"\n'
                   'extern "C" void from_f(const float* x, float* y, int n) {\n'
                   '  for (int i = 0; i < n; ++i) y[i] = __half2float(__float2half_rn(x[i])); }\n'
                   'extern "C" void from_d(const double* x, float* y, int n) {\n'
                   '  for (int i = 0; i < n; ++i) y[i] = __half2float(__double2half(x[i])); }\n')
    lib_path = tmp_path / "libhalf.so"
    proc = subprocess.run([cxx, "-std=c++17", "-shared", "-fPIC", "-I", str(d), "-o",
                           str(lib_path), str(src)], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[:2000]
    lib = ctypes.CDLL(str(lib_path))
    rng = np.random.default_rng(11)
    x = np.concatenate([rng.normal(0, 100, 4000), rng.normal(0, 1e-5, 1000),
                        np.float16(rng.normal(0, 10, 500)).astype(np.float64) * (1 + 2 ** -11),
                        [65504.0, 65520.0, -65519.0, 2.0 ** -24 * 0.5, 0.0, -0.0]])
    x32 = x.astype(np.float32)
    cases = ((lib.from_f, x32, torch.from_numpy(x32).half().float().numpy()),
             (lib.from_d, x, x.astype(np.float16).astype(np.float32)))
    for fn, arr, ref in cases:
        y = np.empty(arr.size, np.float32)
        fn(arr.ctypes.data_as(ctypes.c_void_p), y.ctypes.data_as(ctypes.c_void_p),
           ctypes.c_int(arr.size))
        np.testing.assert_array_equal(y, ref)


def _f16_jax_def():
    """``gt4py_tpu_torch.testing.float16_hdiff_sweep`` written for the JAX
    package."""
    from gt4py_tpu.cartesian import gtscript as jgts
    from gt4py_tpu.cartesian.gtscript import FORWARD, PARALLEL, computation, interval

    F16 = jgts.Field[np.float16]

    def f16_hdiff_sweep(inp: F16, coeff: F16, out: F16, col: F16):
        with computation(PARALLEL), interval(...):
            lap = 4.0 * inp[0, 0, 0] - (inp[1, 0, 0] + inp[-1, 0, 0]
                                         + inp[0, 1, 0] + inp[0, -1, 0])
            res = lap[1, 0, 0] - lap[0, 0, 0]
            flx = 0 if (res * (inp[1, 0, 0] - inp[0, 0, 0])) > 0 else res
            res = lap[0, 1, 0] - lap[0, 0, 0]
            fly = 0 if (res * (inp[0, 1, 0] - inp[0, 0, 0])) > 0 else res
            out = inp[0, 0, 0] - coeff[0, 0, 0] * (flx[0, 0, 0] - flx[-1, 0, 0]
                                                   + fly[0, 0, 0] - fly[0, -1, 0])
        with computation(FORWARD):
            with interval(0, 1):
                col = out[0, 0, 0]
            with interval(1, None):
                col = 0.5 * col[0, 0, -1] + out[0, 0, 0]

    return jgts.stencil(backend="numpy", definition=f16_hdiff_sweep)


def _f16_large_inputs():
    rng = np.random.default_rng(16)
    shape = (40, 70, 9)
    return {"inp": rng.random(shape).astype(np.float16),
            "coeff": (0.025 * rng.random(shape)).astype(np.float16),
            "out": np.zeros(shape, np.float16), "col": np.zeros(shape, np.float16)}, {}


@pytest.mark.parametrize("size", ["surface", "large"])
def test_float16_stencil_emulated_vs_plain_and_oracle(emulated, size):
    """A float16 stencil runs through the generated kernels (``__half``
    loads and stores, float compute) and equals the plain executor and the
    JAX package's numpy backend exactly.  Its float64 literals make float64
    values that are stored to float16: numpy, the kernels and the plain
    executor round them once (``dtypes.cast``); at the large size a
    rounding through float32 differs."""
    definition, make_inputs, kw = testing.SURFACE["float16_hdiff_sweep"]
    if size == "large":
        make_inputs, kw = _f16_large_inputs, dict(origin=(2, 2, 0), domain=(36, 66, 9))
    ref, _ = make_inputs()
    _f16_jax_def()(**ref, **kw)
    got, plain, st = testing.run_pair(definition, make_inputs, kw, "cpu")
    assert st.backend.launches == 1
    assert "__half" in st.backend.source
    for k in ("out", "col"):
        torch.testing.assert_close(got[k], plain[k], rtol=0, atol=0, msg=k)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)


def test_emulated_bf16_rounds_as_torch(emulated_dir, tmp_path):
    """The stub's ``__nv_bfloat16`` conversions round as torch's
    ``.to(torch.bfloat16)`` does, ties, overflow and subnormals included:
    from float directly, from double through float (``gt::round_bf16``;
    torch and the JAX package's oracle, ml_dtypes, round so too)."""
    cxx, d = emulated_dir
    src = tmp_path / "bf16.cpp"
    src.write_text('#include "cuda_bf16.h"\n'
                   'extern "C" void from_f(const float* x, float* y, int n) {\n'
                   '  for (int i = 0; i < n; ++i) y[i] = __bfloat162float(__float2bfloat16_rn(x[i])); }\n'
                   'extern "C" void from_d(const double* x, float* y, int n) {\n'
                   '  for (int i = 0; i < n; ++i)\n'
                   '    y[i] = __bfloat162float(__float2bfloat16_rn(__double2float_rn(x[i]))); }\n')
    lib_path = tmp_path / "libbf16.so"
    proc = subprocess.run([cxx, "-std=c++17", "-shared", "-fPIC", "-I", str(d), "-o",
                           str(lib_path), str(src)], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[:2000]
    lib = ctypes.CDLL(str(lib_path))
    rng = np.random.default_rng(12)
    ties = torch.from_numpy(rng.normal(0, 10, 500)).to(torch.bfloat16).double().numpy()
    x = np.concatenate([rng.normal(0, 100, 4000), rng.normal(0, 1e-38, 1000),
                        ties * (1 + 2 ** -8), ties * (1 + 2 ** -8 + 2 ** -30),
                        [3.3895e38, 3.4e38, -3.39e38, 1e-45, 0.0, -0.0, np.inf, -np.inf]])
    x32 = x.astype(np.float32)
    with np.errstate(over="ignore"):
        cases = ((lib.from_f, x32, torch.from_numpy(x32).to(torch.bfloat16).float().numpy()),
                 (lib.from_d, x, torch.from_numpy(x).to(torch.bfloat16).float().numpy()))
    for fn, arr, ref in cases:
        y = np.empty(arr.size, np.float32)
        fn(arr.ctypes.data_as(ctypes.c_void_p), y.ctypes.data_as(ctypes.c_void_p),
           ctypes.c_int(arr.size))
        np.testing.assert_array_equal(y, ref)


def _bf16_jax_def():
    """``gt4py_tpu_torch.testing.bfloat16_hdiff_sweep`` written for the JAX
    package."""
    from gt4py_tpu.cartesian import gtscript as jgts
    from gt4py_tpu.cartesian.gtscript import FORWARD, PARALLEL, computation, interval

    BF16 = jgts.Field[jgts.bfloat16]

    def bf16_hdiff_sweep(inp: BF16, coeff: BF16, out: BF16, col: BF16):
        with computation(PARALLEL), interval(...):
            lap = 4.0 * inp[0, 0, 0] - (inp[1, 0, 0] + inp[-1, 0, 0]
                                         + inp[0, 1, 0] + inp[0, -1, 0])
            res = lap[1, 0, 0] - lap[0, 0, 0]
            flx = 0 if (res * (inp[1, 0, 0] - inp[0, 0, 0])) > 0 else res
            res = lap[0, 1, 0] - lap[0, 0, 0]
            fly = 0 if (res * (inp[0, 1, 0] - inp[0, 0, 0])) > 0 else res
            out = inp[0, 0, 0] - coeff[0, 0, 0] * (flx[0, 0, 0] - flx[-1, 0, 0]
                                                   + fly[0, 0, 0] - fly[0, -1, 0])
        with computation(FORWARD):
            with interval(0, 1):
                col = out[0, 0, 0]
            with interval(1, None):
                col = 0.5 * col[0, 0, -1] + out[0, 0, 0]

    return jgts.stencil(backend="numpy", definition=bf16_hdiff_sweep)


@pytest.mark.parametrize("size", ["surface", "large"])
def test_bfloat16_stencil_emulated_vs_plain_and_oracle(emulated, size):
    """A bfloat16 stencil runs through the generated kernels
    (``__nv_bfloat16`` loads and stores, float compute) and equals the
    plain executor and the JAX package's numpy backend (ml_dtypes)
    exactly."""
    import ml_dtypes

    definition, make_inputs, kw = testing.SURFACE["bfloat16_hdiff_sweep"]
    if size == "large":
        def make_inputs():
            fields, _ = _f16_large_inputs()
            return {k: v.astype(np.float32) for k, v in fields.items()}, {}
        kw = dict(origin=(2, 2, 0), domain=(36, 66, 9))
    fields, _ = make_inputs()
    ref = {k: v.astype(ml_dtypes.bfloat16) for k, v in fields.items()}
    _bf16_jax_def()(**ref, **kw)
    got, plain, st = testing.run_pair(definition, make_inputs, kw, "cpu")
    assert st.backend.launches == 1
    assert "__nv_bfloat16" in st.backend.source
    for k in ("out", "col"):
        assert got[k].dtype == torch.bfloat16
        torch.testing.assert_close(got[k], plain[k], rtol=0, atol=0, msg=k)
        np.testing.assert_array_equal(got[k].float().numpy(), ref[k].astype(np.float32),
                                      err_msg=k)
