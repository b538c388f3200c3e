// K9 on the H100: a static permutation dest[j] = src[sigma(j)] of 32-bit
// words through the 2k-1 exchange stages of a Beneš network on n = 2^k
// words (pair distances n/2, ..., 2, 1, 2, ..., n/2; each pair swaps or
// passes), as three passes, each with its words in registers.
//
// Replaces gt4py_tpu/next/benes.py: permute :253 with its Pallas kernel
// _inner_kernel :213 (pallas_call :308) and the XLA selects of the outer
// stages, _xla_stage :204.  The control bits come from the host router
// (csrc/benes_router.cpp); next/benes.py packs them and plans the passes.
//
// Bound on the H100: bytes.  The function reads P words and writes P
// words, and reads (2k-1) n/2 control bits once: 0.0033 ms at n = 2^20
// over 3.35 TB/s.  The first form (one global pass per outer stage, 2(k-b)
// launches, every inner stage reading its control word from device memory
// between barriers) moved ~125 bytes a word and was latency-bound.
//
// Passes: a block of B = 2^b words.  The k-b outer stages on each side
// touch only index bits b..k-1, so one pass applies them all: a CTA takes
// the 2^(k-b) rows (bits b..k-1) of C = 2^c consecutive columns (bits
// 0..c-1 at a fixed value of bits c..b-1), each row a coalesced segment of
// C words.  The network is three launches:
//   pass A  the first side's outer stages (rows of C words),
//   inner   the 2b-1 stages below the block (a CTA per block of B words),
//   pass C  the second side's outer stages;
// one launch (the inner form over the whole array) when k = b.  Pass A
// reads the caller's P words (0 above P: no padded copy), pass C writes
// the P words of the result (no slice copy); the inner pass runs in place
// on an n-word scratch buffer.  Traffic: ~16 bytes per padded word plus 8
// per element plus the bits, in L2 at the FVM's 2^19-2^20 words.
//
// Inside a pass (benes_pass): a CTA's M = 2^m local words, local word
// L = r * C + x (row r, column x < C) being global index
// (r << b) | (blockIdx.x << c) | x, so a stage at global bit j >= b is one
// at local bit c + j - b; the inner pass is the case c = b.  Each thread
// holds E = 2^e words in registers: local bits 0..4 are its lane, e
// "register bits" pick its register, the rest its warp.  A stage on a
// register bit swaps registers inside the thread; a stage on a lane bit
// exchanges with lane ^ d by a warp shuffle; before a stage on a warp bit
// the CTA re-lays its words through shared memory (XOR-swizzled by odd
// 32-word rows: free of bank conflicts) so that the bit becomes a register
// bit.  The host plans the layouts (next/benes.py: _program): with 16
// registers a thread the inner pass at b = 12 re-lays twice for its 23
// stages, where a form with every stage in shared memory paid two loads,
// two stores and a barrier per pair and stage (0.0419 against 0.0233 ms of
// device time at 2^20 on the H100, PERF.md).  The control bits are E bits per thread and stage,
// packed per thread and staged in shared memory with cp.async at the
// kernel's start (issued before the data load, waited on after it); no
// stage reads device memory.  Values move as raw words: float32, int32
// and uint32 need no bitcast and any bit pattern (NaN payloads included)
// survives exactly.

#include <stddef.h>
#include <stdint.h>

#include "stencil_runtime.cuh"

namespace {

constexpr int kMaxOps = 64;
constexpr int kMaxLayouts = 16;
// largest pass: 2^14 words (E = 16 registers of 1024 threads)
constexpr int kMaxLog2 = 14;

// kernel launches made, counted at each launch: benes_device_launches
unsigned long long g_launches = 0;

// A pass's program (planned on the host, next/benes.py: _program):
// rb[l] are layout l's register bits (local bit positions, e of them);
// op: (kind << 6) | arg -- kind 0: a stage on register bit arg (slots s
// and s | 1 << arg), 1: a stage on lane bit arg, 2: re-lay to layout arg.
// The pass starts in layout 0.
struct Prog {
  int e;
  int n_ops;
  unsigned char rb[kMaxLayouts][5];
  unsigned char wb[kMaxLayouts][5];  // layout l's warp bits, in order
  unsigned char op[kMaxOps];
};

// the shared-memory slot of local word L: odd 32-word rows XOR 31
__device__ __forceinline__ uint32_t swz(uint32_t L) {
  return L ^ ((L & 32u) ? 31u : 0u);
}

// The local words of a thread's registers in layout l: its lane in bits
// 0..lb-1, register s's bits at rb[l][0..e-1], its warp's bits at
// wb[l][0..nwb-1].
template <int E>
__device__ __forceinline__ void addresses(uint32_t (&La)[E], const Prog& prog, int l, int nwb,
                                          uint32_t lane, uint32_t warp) {
  constexpr int e = E >= 16 ? 4 : E >= 8 ? 3 : E >= 4 ? 2 : E >= 2 ? 1 : 0;
  uint32_t base = lane;
  for (int j = 0; j < nwb; ++j) base |= ((warp >> j) & 1u) << prog.wb[l][j];
  uint32_t r[e > 0 ? e : 1];
#pragma unroll
  for (int i = 0; i < e; ++i) r[i] = 1u << prog.rb[l][i];
#pragma unroll
  for (int s = 0; s < E; ++s) {
    uint32_t a = base;
#pragma unroll
    for (int i = 0; i < e; ++i)
      if ((s >> i) & 1) a |= r[i];
    La[s] = a;
  }
}

template <int E, int I>
__device__ __forceinline__ void reg_stage(uint32_t (&v)[E], uint32_t w) {
  if constexpr ((1 << I) < E) {
#pragma unroll
    for (int s = 0; s < E; ++s) {
      if (s & (1 << I)) continue;
      const uint32_t lo = v[s], hi = v[s | (1 << I)];
      const bool x = (w >> s) & 1u;
      v[s] = x ? hi : lo;
      v[s | (1 << I)] = x ? lo : hi;
    }
  }
}

template <int E>
__global__ void __launch_bounds__(1024)
benes_pass(const uint32_t* src, uint32_t n_src, uint32_t* dst, uint32_t n_dst,
           const uint32_t* bits, int m, int c, int b, Prog prog) {
  GT_DYNAMIC_SMEM(gt_smem);
  const int lb = m < 5 ? m : 5;
  const int nwb = m - lb - prog.e;  // warp bits
  const uint32_t tid = threadIdx.x, T = blockDim.x;
  const uint32_t lane = tid & 31u, warp = tid >> 5;
  const bool valid = lane < (1u << lb);
  // this CTA's bits: nw words a thread, word-major (thread t's word w at
  // w * T + t), contiguous in device memory
  int nstages = 0;
  for (int o = 0; o < prog.n_ops; ++o) nstages += (prog.op[o] >> 6) < 2;
  const uint32_t nw = (uint32_t)(nstages * E + 31) / 32;
  uint32_t* const bsh = reinterpret_cast<uint32_t*>(gt_smem);
  uint32_t* const blk = bsh + ((nw * T + 3u) & ~3u);
  const uint32_t* const mine = bits + (size_t)blockIdx.x * nw * T;
  // 1. the control bits, asynchronously (16-byte copies when aligned)
  if (((nw * T) & 3u) == 0 && (reinterpret_cast<size_t>(mine) & 15) == 0) {
    for (uint32_t w = 4 * tid; w < nw * T; w += 4 * T) gt::async_copy<16>(bsh + w, mine + w);
  } else {
    for (uint32_t w = tid; w < nw * T; w += T) gt::async_copy<4>(bsh + w, mine + w);
  }
  gt::async_commit();
  // 2. the words, from device memory straight into layout 0's registers
  const uint32_t cmask = (1u << c) - 1u;
  const size_t gbase = (size_t)blockIdx.x << c;
  uint32_t La[E], v[E];
  addresses<E>(La, prog, 0, nwb, lane, warp);
#pragma unroll
  for (int s = 0; s < E; ++s) {
    const size_t G = ((size_t)(La[s] >> c) << b) | gbase | (La[s] & cmask);
    v[s] = valid && G < n_src ? src[G] : 0u;
  }
  gt::async_wait<0>();
  __syncthreads();
  // 3. the program: no device-memory access
  const uint32_t emask = (1u << E) - 1u;
  uint32_t off = 0;  // the next stage's first bit in this thread's stream
  for (int o = 0; o < prog.n_ops; ++o) {
    const int kind = prog.op[o] >> 6, arg = prog.op[o] & 63;
    if (kind == 2) {
#pragma unroll
      for (int s = 0; s < E; ++s) blk[swz(La[s])] = v[s];
      __syncthreads();
      addresses<E>(La, prog, arg, nwb, lane, warp);
#pragma unroll
      for (int s = 0; s < E; ++s) v[s] = blk[swz(La[s])];
      __syncthreads();
      continue;
    }
    const uint32_t w = (bsh[(off >> 5) * T + tid] >> (off & 31u)) & emask;
    off += E;
    if (kind == 1) {
#pragma unroll
      for (int s = 0; s < E; ++s) {
        const uint32_t u = __shfl_xor_sync(0xffffffffu, v[s], 1 << arg);
        if ((w >> s) & 1u) v[s] = u;
      }
      continue;
    }
    switch (arg) {
      case 0: reg_stage<E, 0>(v, w); break;
      case 1: reg_stage<E, 1>(v, w); break;
      case 2: reg_stage<E, 2>(v, w); break;
      default: reg_stage<E, 3>(v, w); break;
    }
  }
  // 4. the words back, from the last layout
#pragma unroll
  for (int s = 0; s < E; ++s) {
    const size_t G = ((size_t)(La[s] >> c) << b) | gbase | (La[s] & cmask);
    if (valid && G < n_dst) dst[G] = v[s];
  }
}

template <int E>
int launch_e(const uint32_t* src, uint32_t n_src, uint32_t* dst, uint32_t n_dst,
             const uint32_t* bits, int m, int c, int b, const Prog& prog, unsigned ncta,
             cudaStream_t st) {
  const int lb = m < 5 ? m : 5;
  const int wbits = m - lb - prog.e;
  const unsigned threads = 32u << (wbits > 0 ? wbits : 0);
  int nstages = 0, relay = 0;
  for (int o = 0; o < prog.n_ops; ++o) {
    nstages += (prog.op[o] >> 6) < 2;
    relay += (prog.op[o] >> 6) == 2;
  }
  const size_t nw = ((size_t)(nstages * E + 31) / 32 * threads + 3) & ~(size_t)3;
  const size_t smem = (nw + (relay ? (size_t)1 << m : 0)) * sizeof(uint32_t);
  if (threads > 1024 || smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  void (*const kernel)(const uint32_t*, uint32_t, uint32_t*, uint32_t, const uint32_t*, int,
                       int, int, Prog) = benes_pass<E>;
  if (smem > 48 * 1024) {
    const cudaError_t a = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (a != cudaSuccess) return (int)a;
  }
  const dim3 grid(ncta), block(threads);
  kernel<<<grid, block, smem, st>>>(src, n_src, dst, n_dst, bits, m, c, b, prog);
  ++g_launches;
  return (int)cudaGetLastError();
}

int launch_pass(const uint32_t* src, uint32_t n_src, uint32_t* dst, uint32_t n_dst,
                const uint32_t* bits, int m, int c, int b, const Prog& prog, unsigned ncta,
                cudaStream_t st) {
  if (prog.n_ops > kMaxOps || prog.e < 0 || prog.e > 4 || m > kMaxLog2)
    return (int)cudaErrorInvalidValue;
  switch (prog.e) {
    case 0: return launch_e<1>(src, n_src, dst, n_dst, bits, m, c, b, prog, ncta, st);
    case 1: return launch_e<2>(src, n_src, dst, n_dst, bits, m, c, b, prog, ncta, st);
    case 2: return launch_e<4>(src, n_src, dst, n_dst, bits, m, c, b, prog, ncta, st);
    case 3: return launch_e<8>(src, n_src, dst, n_dst, bits, m, c, b, prog, ncta, st);
    default: return launch_e<16>(src, n_src, dst, n_dst, bits, m, c, b, prog, ncta, st);
  }
}

}  // namespace

extern "C" {

// The whole network: dst[0, P) = the permutation of src[0, P) (padded
// with 0 to n = 2^k words).  k > b: three passes through ``tmp`` (n
// words), with the bits and programs of pass A, the inner pass and pass C;
// k = b: one pass from src to dst with the inner pass's.  b: log2 of the
// inner block; c: log2 of the outer passes' row segment (c <= b).
// The programs are ``Prog`` records (next/benes.py: _Prog).  Returns the
// first CUDA error (0 if none); no synchronisation.
int benes_permute(const uint32_t* src, uint32_t P, uint32_t* tmp, uint32_t* dst,
                  const uint32_t* bits_a, const uint32_t* bits_i, const uint32_t* bits_c,
                  const void* prog_a_, const void* prog_i_, const void* prog_c_, int k, int b,
                  int c, void* stream) {
  const Prog* const prog_a = static_cast<const Prog*>(prog_a_);
  const Prog* const prog_i = static_cast<const Prog*>(prog_i_);
  const Prog* const prog_c = static_cast<const Prog*>(prog_c_);
  if (k < 1 || k > 24 || b < 1 || b > k || b > kMaxLog2 || c < 0 || c > b ||
      P > (1u << k) || P == 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (k == b) return launch_pass(src, P, dst, P, bits_i, b, b, b, *prog_i, 1, st);
  const int r = k - b;  // log2 of the outer passes' rows
  if (r + c > kMaxLog2) return (int)cudaErrorInvalidValue;
  const uint32_t n = 1u << k;
  int e = launch_pass(src, P, tmp, n, bits_a, r + c, c, b, *prog_a, 1u << (b - c), st);
  if (e) return e;
  e = launch_pass(tmp, n, tmp, n, bits_i, b, b, b, *prog_i, 1u << r, st);
  if (e) return e;
  return launch_pass(tmp, n, dst, P, bits_c, r + c, c, b, *prog_c, 1u << (b - c), st);
}

// The kernel launches this library has made since it was loaded.
unsigned long long benes_device_launches() { return g_launches; }

const char* benes_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
