// Runtime support for the stencil kernels that
// gt4py_tpu_torch/cartesian/backend/cuda_backend.py generates.
//
// Every generated .cu file includes this header and exports one plain C
// function, gt_run, which launches the stencil's kernels in order on the
// caller's stream and returns the first cudaGetLastError() that is not
// cudaSuccess.  The header needs no PyTorch headers, so a stencil builds
// with nvcc in seconds.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace gt {

// A strided field.  `p` points at the compute-domain origin of the
// buffer, so (i, j, k) are domain-relative and may be negative in halos.
// A stride of 0 broadcasts an axis the field does not have.
template <typename T>
struct Field {
  T* p;
  long long si, sj, sk;
  __device__ __forceinline__ T& at(long long i, long long j, long long k) const {
    return p[i * si + j * sj + k * sk];
  }
};

// Resolved K bounds [lo, hi) of every vertical section of the stencil.
template <int N>
struct KBounds {
  int lo[N];
  int hi[N];
};

// Periodic wrap of a domain-relative index on an axis of length n.  The
// wrapper checks that no read reaches further than n beyond the domain,
// so one add or subtract is enough.
__device__ __forceinline__ int wrap(int x, int n, int periodic) {
  return periodic ? (x < 0 ? x + n : (x >= n ? x - n : x)) : x;
}

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
