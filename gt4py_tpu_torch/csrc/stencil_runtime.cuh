// Runtime support for the stencil kernels that
// gt4py_tpu_torch/cartesian/backend/cuda_backend.py generates.
//
// Every generated .cu file includes this header and exports one plain C
// function, gt_run, which launches the stencil's kernels in order on the
// caller's stream and returns the first cudaGetLastError() that is not
// cudaSuccess.  The header needs no PyTorch headers, so a stencil builds
// with nvcc in seconds.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace gt {

// Largest number of data dimensions a field may have.
constexpr int kMaxDataDims = 4;

// A strided field.  `p` points at the compute-domain origin of the
// buffer, so (i, j, k) are domain-relative and may be negative in halos.
// A stride of 0 broadcasts an axis the field does not have.  `sd` are the
// strides of the trailing data dimensions; [klo, khi] is the buffer's K
// range in domain-relative levels, where variable and absolute K reads
// clip (the oracle's clip to [0, SK - 1] in buffer levels).
template <typename T>
struct Field {
  T* p;
  long long si, sj, sk;
  long long sd[kMaxDataDims];
  int klo, khi;
  // the bytes [s0, s1) of the storage (the allocation) the view lies in
  const unsigned char* s0;
  const unsigned char* s1;
  __device__ __forceinline__ T& at(long long i, long long j, long long k) const {
    return p[i * si + j * sj + k * sk];
  }
  // `d`: the element offset of a data-dimension component
  __device__ __forceinline__ T& at(long long i, long long j, long long k, long long d) const {
    return p[i * si + j * sj + k * sk + d];
  }
  __device__ __forceinline__ long long kclamp(long long k) const {
    return k < klo ? klo : (k > khi ? khi : k);
  }
  // whether the 16-byte word at `w` lies inside the field's storage.  A
  // row's 16-byte copies start at the aligned-down word of its first
  // element and may end past its last: such a word may hold bytes before
  // the view's first element or past its last (another row, a halo, another
  // view of the storage), which the kernels copy and never use; a word
  // that would cross the allocation itself is copied element by element
  __device__ __forceinline__ bool holds16(const void* w) const {
    const unsigned char* b = reinterpret_cast<const unsigned char*>(w);
    return b >= s0 && b + 16 <= s1;
  }
};

// A host build of the kernels checks every 16-byte read against the
// storages of the call's fields, which gt_run names here; on the card the
// kernels test the bounds themselves (Field::holds16).
#ifndef GT_STORAGES
#define GT_STORAGES(...)
#endif

// The dynamic shared memory of a kernel that synchronises its block (the
// plane-sweep and K-window forms): 16-byte aligned, its size the launch's
// third argument; the planes and windows are carved out of it.
#ifndef GT_DYNAMIC_SMEM
#define GT_DYNAMIC_SMEM(name) extern __shared__ __align__(16) unsigned char name[]
#endif

// 16-byte vector accesses of the row form's vector kernels: N elements of
// T (N * sizeof(T) a multiple of 16) between a register array and device
// memory, as uint4 words.  The wrapper checks, before it launches a vector
// kernel, that every address these reach is 16-byte aligned (a common
// phase of the fields' origins, row pitches that are multiples of 16
// bytes); GT_VECTOR_ALIGNED lets a host build of the kernels test it at
// each access, where a misaligned vector access would fault on the card.
#ifndef GT_VECTOR_ALIGNED
#define GT_VECTOR_ALIGNED(p) true
#endif
template <typename T, int N>
__device__ __forceinline__ void vload(T* dst, const T* src) {
  static_assert((N * sizeof(T)) % 16 == 0, "a whole number of 16-byte words");
  if (!GT_VECTOR_ALIGNED(src)) return;
#pragma unroll
  for (int c = 0; c < (int)(N * sizeof(T) / 16); ++c)
    reinterpret_cast<uint4*>(dst)[c] = reinterpret_cast<const uint4*>(src)[c];
}
template <typename T, int N>
__device__ __forceinline__ void vstore(T* dst, const T* src) {
  static_assert((N * sizeof(T)) % 16 == 0, "a whole number of 16-byte words");
  if (!GT_VECTOR_ALIGNED(dst)) return;
#pragma unroll
  for (int c = 0; c < (int)(N * sizeof(T) / 16); ++c)
    reinterpret_cast<uint4*>(dst)[c] = reinterpret_cast<const uint4*>(src)[c];
}

// The lead of `p`: the elements between the 16-byte word that holds it
// and `p` itself (0-3 in float32, 0-1 in float64): a staged row starts at
// that word (K6's row phase).
template <typename T>
__device__ __forceinline__ int lead16(const T* p) {
  return (int)((reinterpret_cast<size_t>(p) & 15) / sizeof(T));
}

// Asynchronous copies from device memory into shared memory (sm_80+
// cp.async): async_copy<Bytes> issues one copy of 4, 8 or 16 bytes (both
// addresses aligned to Bytes), async_commit closes the thread's group of
// copies issued since the last one, async_wait<N> waits until at most N
// of the thread's groups are pending.  A copy becomes visible to the other
// threads of the block after the wait and a __syncthreads().  A host
// build of the kernels defines GT_ASYNC_COPY and gives synchronous copies.
#ifndef GT_ASYNC_COPY
#define GT_ASYNC_COPY
template <int Bytes>
__device__ __forceinline__ void async_copy(void* smem, const void* gmem) {
  static_assert(Bytes == 4 || Bytes == 8 || Bytes == 16, "cp.async copies 4, 8 or 16 bytes");
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  if constexpr (Bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(gmem), "n"(Bytes)
                 : "memory");
  }
}
__device__ __forceinline__ void async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
#endif

// Resolved K bounds [lo, hi) of every vertical section of the stencil.
template <int N>
struct KBounds {
  int lo[N];
  int hi[N];
};

// The levels each window of a staged kernel (variable-K reads served from
// shared memory) holds in this call: a field's whole buffer column, or a
// ring of that many levels.
template <int N>
struct Slots {
  int s[N];
};

// Periodic wrap of a domain-relative index on an axis of length n.  The
// wrapper checks that no read reaches further than n beyond the domain,
// so one add or subtract is enough.
__device__ __forceinline__ int wrap(int x, int n, int periodic) {
  return periodic ? (x < 0 ? x + n : (x >= n ? x - n : x)) : x;
}

// The slot of level k in a ring of n planes (the plane-sweep form's copy
// of the planes it computed last).
__device__ __forceinline__ int slot(int k, int n) {
  const int s = k % n;
  return s < 0 ? s + n : s;
}

// float16 is a storage type: a float16 value in a kernel is a float that
// holds a float16 number.  round_half rounds a result to float16 (to
// nearest even, as torch's .half() and numpy do); from double it rounds
// once, not through float.
__device__ __forceinline__ float round_half(float x) { return __half2float(__float2half_rn(x)); }
__device__ __forceinline__ float round_half(double x) { return __half2float(__double2half(x)); }
template <typename T>
__device__ __forceinline__ float round_half(T x) { return round_half((double)x); }

// bfloat16 is a storage type in the same way (__nv_bfloat16 in memory, a
// float in the kernel).  round_bf16 rounds to nearest even, as torch's
// .to(torch.bfloat16) does; from double it rounds through float, as torch
// and the JAX package's oracle (ml_dtypes) do.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float round_bf16(double x) { return round_bf16(__double2float_rn(x)); }
template <typename T>
__device__ __forceinline__ float round_bf16(T x) { return round_bf16((double)x); }

__device__ __forceinline__ float fmod_(float a, float b) { return fmodf(a, b); }
__device__ __forceinline__ double fmod_(double a, double b) { return fmod(a, b); }
__device__ __forceinline__ float floor_(float a) { return floorf(a); }
__device__ __forceinline__ double floor_(double a) { return floor(a); }
__device__ __forceinline__ float copysign_(float a, float b) { return copysignf(a, b); }
__device__ __forceinline__ double copysign_(double a, double b) { return copysign(a, b); }

// numpy's remainder (the sign of the divisor) and floor division.
template <typename T>
__device__ __forceinline__ T imod(T a, T b) {
  if (b == 0) return T(0);
  T r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? T(r + b) : r;
}
template <typename T>
__device__ __forceinline__ T ifloordiv(T a, T b) {
  if (b == 0) return T(0);
  T q = a / b;
  return ((a % b != 0) && ((a < 0) != (b < 0))) ? T(q - 1) : q;
}
template <typename T>
__device__ __forceinline__ T fmod_py(T a, T b) {
  T m = fmod_(a, b);
  if (m != T(0)) {
    if ((b < T(0)) != (m < T(0))) m += b;
  } else {
    m = copysign_(T(0), b);
  }
  return m;
}
template <typename T>
__device__ __forceinline__ T ffloordiv(T a, T b) {
  if (b == T(0)) return a / b;
  T m = fmod_(a, b);
  T div = (a - m) / b;
  if (m != T(0) && ((b < T(0)) != (m < T(0)))) div -= T(1);
  if (div == T(0)) return copysign_(T(0), a / b);
  T fl = floor_(div);
  if (div - fl > T(0.5)) fl += T(1);
  return fl;
}

template <typename T>
__device__ __forceinline__ T ipow(T base, T e) {
  if (e < 0) return T(0);
  T r = 1;
  while (e) {
    if (e & 1) r *= base;
    base *= base;
    e >>= 1;
  }
  return r;
}

// numpy's minimum/maximum propagate NaN.
template <typename T>
__device__ __forceinline__ T minimum(T a, T b) {
  return (a != a) ? a : ((b != b) ? b : (b < a ? b : a));
}
template <typename T>
__device__ __forceinline__ T maximum(T a, T b) {
  return (a != a) ? a : ((b != b) ? b : (b > a ? b : a));
}
template <typename T>
__device__ __forceinline__ T iabs(T a) {
  return a < 0 ? T(-a) : a;
}

}  // namespace gt
