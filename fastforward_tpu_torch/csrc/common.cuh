// Shared device code of the port's two-level int4 GEMVs (a4_gemv.cu,
// w4a8_gemv.cu, fused_tail.cu, fused_head.cu, all on w4a8_mma.cuh's int8
// tensor-core tiles): the weight layouts, the mbarrier helpers, the
// split-K epilogue, whose compile-time ARGMAX flag turns the logits into
// token ids, and the argmax reduction. Every group runs on the tensor
// cores: the tile (w4a8_mma_kernel) where a unit's byte rows a plane are a
// multiple of 4 and N % 4 == 0, the any-group route (w4a8_rows_kernel:
// byte rows in memory order, each with its own group's multiplier) for
// every other group the references take. dp4a (dp4a_ss) is left to
// probe_int4.cu's dp4a route.
//
// The GEMVs compute, per output column n and row m,
//   acc[m, n] = sum_g m_g[n] * sum_{k in g} x[m, k] * v[k, n]      (int32)
//   y[m, n]   = (float(acc) * s_col[n]) * x_scale[m]
// with v in [-8, 7] stored as nibbles and m_g in [1, 15]. The layouts
// differ only in where the two nibbles of a weight byte sit along K; the
// multipliers come nibble-packed, 8 a word. A layer's packed weights lie
// flat (K/2, N), or pre-blocked into contiguous panels (N/bn, K/2, bn).
// Splits write int32 partials that the epilogue adds in a fixed order, so
// the result is exact and deterministic.

#pragma once

#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma.cuh"  // smem_u32

namespace ff {

constexpr int kWarps = 8;  // warps of fused_head.cu's prologue block
constexpr int kThreads = kWarps * 32;

// kVertical: byte row r holds k = 2r (low nibble) and 2r + 1 (high), two's
//            complement (pack_int4_vertical);
// kPaired:   byte row i of pair p holds k = 2pg + i and (2p+1)g + i,
//            offset binary (pack_uint4_offset_paired);
// kHalves:   byte row i of group p holds k = pg + i and pg + g/2 + i,
//            offset binary (pack_uint4_offset).
enum Layout { kVertical = 0, kPaired = 1, kHalves = 2 };

// d = a . b + c over 4 byte lanes, both signed (probe_int4.cu's dp4a route).
__device__ __forceinline__ int dp4a_ss(int a, int b, int c) {
  int d;
  asm("dp4a.s32.s32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// Byte row 0, column n of a layer's packed weights. bn: the panel width
// of the pre-blocked layout (N/bn, K/2, bn), whose byte (r, n) lies at
// (n / bn) * (K/2) * bn + r * bn + n % bn; 0 for the flat (K/2, N) layout.
// Rows lie `bn` (pre-blocked) or N (flat) bytes apart.
__device__ __forceinline__ const int8_t* panel_col(const int8_t* w, int K, int N, int bn, int n) {
  return bn > 0 ? w + (size_t)(n / bn) * (K / 2) * bn + n % bn : w + n;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Arrive on `bar` once every cp.async this thread has issued so far has
// landed (the barrier counts this arrival among its initial count).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// argmax order: a NaN beats any number; among equals (or among NaNs) the
// lower index wins — the same choice as torch.argmax / jnp.argmax.
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  if (bi == INT_MAX) return i != INT_MAX;  // INT_MAX: no candidate yet
  if (i == INT_MAX) return false;
  const bool vn = isnan(v), bn = isnan(bv);
  if (vn != bn) return vn;
  if (vn || v == bv) return i < bi;
  return v > bv;
}

template <typename OutT>
__device__ __forceinline__ void store(OutT* p, float v);
template <>
__device__ __forceinline__ void store<float>(float* p, float v) { *p = v; }
template <>
__device__ __forceinline__ void store<__nv_bfloat16>(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

constexpr int kEpiTile = 1024;  // columns one argmax epilogue block covers

template <bool ARGMAX>
constexpr int kEpiTileOf = ARGMAX ? kEpiTile : 256;

// Epilogue over one row m and one column tile (1024 columns with ARGMAX,
// else 256: one per thread):
//   y[m, n] = (float(sum_s partial[s, m, n]) * s_col[n]) * xs[m]
// with explicit round-to-nearest multiplies (no contraction: bit-equal to
// the oracle's two f32 products). ARGMAX (compile time) off: write y as
// OutT. ARGMAX on: y never leaves registers; the block writes the tile's
// (max, first index) pair, and argmax_reduce_kernel reduces the pairs.
// Grid: (ceil(N/tile), M); 256 threads.
template <typename OutT, bool ARGMAX>
__global__ void gemv_epilogue_kernel(const int32_t* __restrict__ partial, int n_split, int M,
                                     int N, const float* __restrict__ s_col,
                                     const float* __restrict__ xs, OutT* __restrict__ out,
                                     float* __restrict__ pair_val, int* __restrict__ pair_idx) {
  const int tile = blockIdx.x, m = blockIdx.y;
  const float xm = xs[m];
  float bv = 0.f;
  int bi = INT_MAX;
  constexpr int kTile = kEpiTileOf<ARGMAX>;
  for (int n = tile * kTile + threadIdx.x; n < min(N, (tile + 1) * kTile); n += blockDim.x) {
    int acc = 0;
    for (int i = 0; i < n_split; ++i) acc += partial[((size_t)i * M + m) * N + n];
    const float v = __fmul_rn(__fmul_rn(__int2float_rn(acc), s_col[n]), xm);
    if constexpr (ARGMAX) {
      if (better(v, n, bv, bi)) { bv = v; bi = n; }
    } else {
      store<OutT>(out + (size_t)m * N + n, v);
    }
  }
  if constexpr (!ARGMAX) return;
  __shared__ float sv[256];
  __shared__ int si[256];
  sv[threadIdx.x] = bv;
  si[threadIdx.x] = bi;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s && better(sv[threadIdx.x + s], si[threadIdx.x + s], sv[threadIdx.x],
                                  si[threadIdx.x])) {
      sv[threadIdx.x] = sv[threadIdx.x + s];
      si[threadIdx.x] = si[threadIdx.x + s];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    pair_val[m * gridDim.x + tile] = sv[0];
    pair_idx[m * gridDim.x + tile] = si[0];
  }
}

template <typename OutT, bool ARGMAX>
cudaError_t launch_gemv_epilogue(const int32_t* partial, int n_split, int M, int N,
                                 const float* s_col, const float* xs, OutT* out,
                                 float* pair_val, int* pair_idx, cudaStream_t stream) {
  dim3 grid((N + kEpiTileOf<ARGMAX> - 1) / kEpiTileOf<ARGMAX>, M);
  gemv_epilogue_kernel<OutT, ARGMAX><<<grid, 256, 0, stream>>>(partial, n_split, M, N, s_col,
                                                               xs, out, pair_val, pair_idx);
  return cudaGetLastError();
}

// Second pass: reduce a row's tile pairs to its token id, one warp a row
// (a lane's strided pairs, then shuffles; `better` is a total order on
// (value, index), so any order of reduction gives the same id).
__global__ void argmax_reduce_kernel(const float* __restrict__ pair_val,
                                     const int* __restrict__ pair_idx, int n_tiles,
                                     int* __restrict__ idx_out) {
  const int m = blockIdx.x, lane = threadIdx.x;
  float bv = 0.f;
  int bi = INT_MAX;  // no candidate
#pragma unroll 4
  for (int t = lane; t < n_tiles; t += 32) {
    const float v = pair_val[(size_t)m * n_tiles + t];
    const int i = pair_idx[(size_t)m * n_tiles + t];
    if (better(v, i, bv, bi)) { bv = v; bi = i; }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float v = __shfl_xor_sync(0xffffffffu, bv, off);
    const int i = __shfl_xor_sync(0xffffffffu, bi, off);
    if (better(v, i, bv, bi)) { bv = v; bi = i; }
  }
  if (lane == 0) idx_out[m] = bi;
}

}  // namespace ff
