// K9 on the H100: a static permutation y[i] = x[perm[i]] of 32-bit words
// through the 2k-1 exchange stages of a Beneš network on n = 2^k words
// (pair distances n/2, ..., 2, 1, 2, ..., n/2; each pair swaps or passes).
//
// Replaces gt4py_tpu/next/benes.py: permute :253 with its Pallas kernel
// _inner_kernel :213 (pallas_call :308) and the XLA selects of the outer
// stages, _xla_stage :204.  The control bits come from the host router
// (csrc/benes_router.cpp); next/benes.py packs them at plan time.
//
// Control-bit layout: one bit-plane per stage, one bit per PAIR (the
// router replicates a pair's bit to both members; one copy is enough).
// Pair q of the stage at distance d = 2^j has lower member
// i = q with a zero bit inserted at position j, and its bit is bit q % 32
// of word q / 32 of the stage's plane (``words`` 32-bit words per plane).
// Consecutive threads take consecutive pairs, so a warp reads one word.
//
// Two kernels, launched in order on the caller's stream by benes_permute:
// - outer_stage, one launch per stage with d >= B: a global pass in
//   place, each thread owning whole pairs (no race: a pair has one owner);
// - inner_stages, one launch: a CTA loads a block of B = 2^b words into
//   shared memory, applies every stage with d < B (pairs never leave the
//   block), separated by __syncthreads(), and writes the block back.
// Values move as raw words: float32, int32 and uint32 need no bitcast and
// any bit pattern (NaN payloads included) survives exactly.
//
// Bound on the H100: device-memory (or L2) traffic.  Each outer stage
// reads and writes the swapped pairs' words and reads n/16 bytes of bits;
// the inner pass reads and writes every word once.  At b = 13 and
// n = 2^20 that is 14 outer stages: about 125 bytes per element moved,
// where one gather (torch.index_select) moves about 16.  The fast design
// folds the outer stages into two strided passes like the inner one; this
// first form is the simple one.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t lower_member(uint32_t q, int j) {
  const uint32_t low = (1u << j) - 1u;
  return ((q & ~low) << 1) | (q & low);
}

__global__ void outer_stage(uint32_t* __restrict__ x,
                            const uint32_t* __restrict__ plane, int j,
                            uint32_t npairs) {
  const uint32_t d = 1u << j;
  for (uint32_t q = blockIdx.x * blockDim.x + threadIdx.x; q < npairs;
       q += gridDim.x * blockDim.x) {
    const uint32_t w = __ldg(plane + (q >> 5));
    if ((w >> (q & 31u)) & 1u) {
      const uint32_t i = lower_member(q, j);
      const uint32_t a = x[i];
      const uint32_t c = x[i | d];
      x[i] = c;
      x[i | d] = a;
    }
  }
}

// bits points at the plane of the first inner stage; the 2b-1 inner
// stages' planes follow, ``words`` apart.
__global__ void inner_stages(uint32_t* __restrict__ x,
                             const uint32_t* __restrict__ bits, int b,
                             uint32_t words) {
  extern __shared__ uint32_t blk[];
  const uint32_t B = 1u << b;
  const uint32_t half = B >> 1;
  const size_t base = (size_t)blockIdx.x << b;
  const uint32_t qbase = blockIdx.x * half;  // global id of the block's first pair
  for (uint32_t t = threadIdx.x; t < B; t += blockDim.x) blk[t] = x[base + t];
  __syncthreads();
  for (int s = 0; s < 2 * b - 1; ++s) {
    const int j = s < b ? b - 1 - s : s - b + 1;
    const uint32_t d = 1u << j;
    const uint32_t* plane = bits + (size_t)s * words;
    for (uint32_t q = threadIdx.x; q < half; q += blockDim.x) {
      const uint32_t g = qbase + q;
      const uint32_t w = __ldg(plane + (g >> 5));
      if ((w >> (g & 31u)) & 1u) {
        const uint32_t i = lower_member(q, j);
        const uint32_t a = blk[i];
        const uint32_t c = blk[i | d];
        blk[i] = c;
        blk[i | d] = a;
      }
    }
    __syncthreads();
  }
  for (uint32_t t = threadIdx.x; t < B; t += blockDim.x) x[base + t] = blk[t];
}

constexpr int kOuterThreads = 256;
constexpr int kInnerThreads = 1024;
constexpr uint32_t kMaxOuterBlocks = 132 * 16;

}  // namespace

extern "C" {

// Apply the whole network in place to x (n = 2^k words on the device).
// bits: (2k-1) planes of ``words`` uint32 each, stage-major; b: log2 of
// the inner block (b <= k).  Returns the first CUDA error (0 if none);
// no synchronisation.
int benes_permute(uint32_t* x, const uint32_t* bits, int k, int b,
                  uint32_t words, void* stream) {
  if (k < 1 || b < 1 || b > k || k > 24) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const uint32_t npairs = 1u << (k - 1);
  uint32_t grid = (npairs + kOuterThreads - 1) / kOuterThreads;
  if (grid > kMaxOuterBlocks) grid = kMaxOuterBlocks;
  // stages 0 .. k-b-1: distances n/2 .. B
  for (int s = 0; s < k - b; ++s) {
    outer_stage<<<grid, kOuterThreads, 0, st>>>(x, bits + (size_t)s * words,
                                                k - 1 - s, npairs);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  // stages k-b .. k+b-2: distances B/2 .. 1 .. B/2
  const uint32_t B = 1u << b;
  const int threads = B / 2 < kInnerThreads ? (int)(B / 2 < 32 ? 32 : B / 2) : kInnerThreads;
  if (B * sizeof(uint32_t) > 48 * 1024) {
    cudaError_t a = cudaFuncSetAttribute(
        inner_stages, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(B * sizeof(uint32_t)));
    if (a != cudaSuccess) return (int)a;
  }
  const uint32_t nblocks = 1u << (k - b);
  inner_stages<<<nblocks, threads, B * sizeof(uint32_t), st>>>(
      x, bits + (size_t)(k - b) * words, b, words);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // stages k+b-1 .. 2k-2: distances B .. n/2
  for (int s = k + b - 1; s <= 2 * k - 2; ++s) {
    outer_stage<<<grid, kOuterThreads, 0, st>>>(x, bits + (size_t)s * words,
                                                s - k + 1, npairs);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

const char* benes_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
