// Shared device code of the port's two-level int4 GEMVs (a4_gemv.cu,
// w4a8_gemv.cu, fused_tail.cu, fused_head.cu, all on w4a8_mma.cuh's int8
// tensor-core tile): the weight layouts, the mbarrier helpers, the
// split-K epilogue, whose compile-time ARGMAX flag turns the logits into
// token ids, the argmax reduction, and the CUDA-core route of the groups
// the tile does not take (two_level_any_kernel).
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


// --- The CUDA-core route of the two-level GEMVs ---------------------------
// For the groups the tensor-core tile does not take (w4a8_mma.cuh: a unit
// of fewer than 4 byte rows a plane, so paired g % 4 != 0 and vertical or
// group-halves g % 8 != 0; N % 4 != 0; a paired layout is still whole
// group pairs) every layout of the tile runs this one loop: rows 1 and 5
// (ff_a4_gemv_any, ff_w4a8_gemv_any, ff_w4a8_gemv_unpaired_any), row 9 on
// flat or pre-blocked weights (ff_w4a8_gemv_stacked_any), row 4 through row
// 5's f32 logits, and the products of the fused heads and tail at those
// groups.
//
// A block owns kAnyCols weight columns, 4 a lane (one 32-bit word of a
// byte row), and kAnyRows token rows; its kAnyWarps warps take turns along
// K, a run of kAnyRun byte rows each. A warp stages its run in shared
// memory: for each byte-row pair q (rows r = 2q and r + 1; lo and hi the k
// of a byte's low and high nibble) the groups of its 4 slots and, a token
// row, one dp4a word x[lo(r)], x[hi(r)], x[lo(r + 1)], x[hi(r + 1)]. A
// lane folds its 4 columns' weights of the pair into int8 words in the
// same slot order, m_g * v = ((u * m_g + 128 - 8 m_g) ^ 128) in each byte
// (u the offset-binary nibble; the vertical layout's two's-complement
// nibbles flipped to offset binary first; m_g in [1, 15], as the two-level
// requantization makes it and the tile assumes). Each nibble plane keeps
// its group's multipliers until the group changes; where both rows of a
// pair lie in the plane's group, one multiply a plane folds the two slots
// as 16-bit lanes, else each slot is folded alone. Then one dp4a a token
// row and column. The int32 sums are exact (a run adds at most
// 64 * 128 * 120 in magnitude; a warp flushes them into the block's int64
// totals every kAnyFlush runs and at its end, by shared-memory atomics,
// integer sums in any order), so
//   acc[m, n] = sum_k x[m, k] * m_{k/g}[n] * v[k, n]
// is the oracle's int32 dot. Then the tile's epilogue,
// __fmul_rn(__fmul_rn(float(acc), s_col[n]), x_scale[m]), as f32 or bf16,
// or (kAnyPartials) acc itself as int32, the fused tail's partials of one
// split.
constexpr int kAnyWarps = 8;                    // warps a block, in turns along K
constexpr int kAnyThreads = 32 * kAnyWarps;
constexpr int kAnyCols = 128;                   // weight columns a block, 4 a lane
constexpr int kAnyRows = 16;                    // token rows a block
constexpr int kAnyRun = 32;                     // byte rows a warp's run, one a lane
constexpr int kAnyFlush = 2048;                 // runs a warp sums in int32
constexpr int kAnyF32 = 0, kAnyBf16 = 1, kAnyPartials = 2;  // w4a8_mma.cuh's kOut*

// (k of the low nibble, k of the high nibble, the group of each) of byte
// row r of LAYOUT.
template <int LAYOUT>
__device__ __forceinline__ int4 nibble_slots(int r, int group) {
  if (LAYOUT == kVertical) return make_int4(2 * r, 2 * r + 1, 2 * r / group, (2 * r + 1) / group);
  if (LAYOUT == kPaired) {
    const int p = r / group, i = r - p * group;
    return make_int4(2 * p * group + i, (2 * p + 1) * group + i, 2 * p, 2 * p + 1);
  }
  const int h = group / 2, p = r / h, i = r - p * h;
  return make_int4(p * group + i, p * group + h + i, p, p);
}

// The multipliers of group p for columns n0..n0 + 3 (0 past N): int8 rows
// (G, N), or PACKED 8 nibbles an int32 (ceil(G/8), N) (pack_mult_nibbles:
// group p in bits 4 (p % 8) of word p / 8).
template <bool PACKED>
__device__ __forceinline__ void mult4(const void* mult, int p, int N, int n0, int m[4]) {
  if (PACKED) {
    const int32_t* row = static_cast<const int32_t*>(mult) + (size_t)(p / 8) * N;
    const int sh = 4 * (p % 8);
    if (N % 4 == 0 && n0 < N) {
      const int4 v = *reinterpret_cast<const int4*>(row + n0);
      m[0] = (v.x >> sh) & 15, m[1] = (v.y >> sh) & 15;
      m[2] = (v.z >> sh) & 15, m[3] = (v.w >> sh) & 15;
      return;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) m[c] = n0 + c < N ? (row[n0 + c] >> sh) & 15 : 0;
    return;
  }
  const int8_t* row = static_cast<const int8_t*>(mult) + (size_t)p * N;
  if (N % 4 == 0 && n0 < N) {
    const unsigned v = *reinterpret_cast<const unsigned*>(row + n0);
#pragma unroll
    for (int c = 0; c < 4; ++c) m[c] = (v >> (8 * c)) & 255;
    return;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) m[c] = n0 + c < N ? row[n0 + c] : 0;
}

// Byte row r's bytes of columns n0..n0 + 3 (0 past N) as one word: one
// load where the row pitch keeps it aligned (`vec`), else byte by byte.
__device__ __forceinline__ unsigned weight_word(const int8_t* w, const int8_t* wc, bool vec,
                                                int K, int N, int bn, int pitch, int n0, int r) {
  if (vec) return *reinterpret_cast<const unsigned*>(wc + (size_t)r * pitch);
  unsigned v = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (n0 + c < N)
      v |= (unsigned)(uint8_t)panel_col(w, K, N, bn, n0 + c)[(size_t)r * pitch] << (8 * c);
  return v;
}

// Grid (ceil(N / kAnyCols), ceil(M / kAnyRows)), kAnyThreads threads. w: a
// layer's bytes, flat (K/2, N) or pre-blocked (N/bn, K/2, bn) (bn > 0).
template <int LAYOUT, bool PACKED>
__global__ void __launch_bounds__(kAnyThreads, 2)
    two_level_any_kernel(const int8_t* __restrict__ x, const float* __restrict__ xs,
                         const int8_t* __restrict__ w, const void* __restrict__ mult,
                         const float* __restrict__ s_col, void* __restrict__ out, int out_kind,
                         int M, int K, int N, int group, int bn) {
  constexpr int R = kAnyRows, Q = kAnyRun / 2;
  constexpr unsigned kAll = 0xffffffffu;
  __shared__ int xw[kAnyWarps][R][Q];          // a run's x words, a token row and pair
  __shared__ int4 slot_group[kAnyWarps][Q];     // a pair's groups: lo r, hi r, lo r+1, hi r+1
  __shared__ unsigned long long total[R][kAnyCols];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n0 = blockIdx.x * kAnyCols + 4 * lane, m0 = blockIdx.y * R;
  const int mrows = min(R, M - m0);
  const int rows = K / 2, pitch = bn > 0 ? bn : N;
  const bool vec = pitch % 4 == 0 && n0 + 3 < N;
  const int8_t* wc = panel_col(w, K, N, bn, min(n0, N - 1));
  for (int e = threadIdx.x; e < R * kAnyCols; e += kAnyThreads) (&total[0][0])[e] = 0ull;
  int acc[R][4];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0;
  // the multipliers of nibble planes 0 and 1 (groups cg0, cg1), and each
  // column word's bytes 128 - 8 m (plane 0 in bytes 0 and 2, 1 in 1 and 3)
  int cg0 = -1, cg1 = -1, ml[4] = {0, 0, 0, 0}, mh[4] = {0, 0, 0, 0};
  unsigned bias[4];
  auto flush = [&]() {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (i >= mrows) break;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        atomicAdd(&total[i][4 * lane + c], (unsigned long long)(long long)acc[i][c]);
        acc[i][c] = 0;
      }
    }
  };
  __syncthreads();  // totals zeroed
  int runs = 0;
  for (int r0 = warp * kAnyRun; r0 < rows; r0 += kAnyWarps * kAnyRun) {
    int4 s = make_int4(-1, -1, -1, -1);  // lane's byte row r0 + lane
    if (r0 + lane < rows) s = nibble_slots<LAYOUT>(r0 + lane, group);
    const int q0 = lane % Q;
    const int ka = __shfl_sync(kAll, s.x, 2 * q0), kb = __shfl_sync(kAll, s.y, 2 * q0);
    const int kc = __shfl_sync(kAll, s.x, 2 * q0 + 1), kd = __shfl_sync(kAll, s.y, 2 * q0 + 1);
    __syncwarp();  // the previous run is consumed
    reinterpret_cast<int2*>(&slot_group[warp][lane / 2])[lane % 2] = make_int2(s.z, s.w);
    for (int i = lane / Q; i < R; i += 32 / Q) {
      unsigned v = 0;
      if (i < mrows) {
        const int8_t* xr = x + (size_t)(m0 + i) * K;
        const unsigned b0 = ka >= 0 ? (uint8_t)xr[ka] : 0u, b1 = kb >= 0 ? (uint8_t)xr[kb] : 0u;
        const unsigned b2 = kc >= 0 ? (uint8_t)xr[kc] : 0u, b3 = kd >= 0 ? (uint8_t)xr[kd] : 0u;
        v = b0 | b1 << 8 | b2 << 16 | b3 << 24;
      }
      xw[warp][i][q0] = (int)v;
    }
    __syncwarp();
    const int pairs = min(Q, (rows - r0 + 1) / 2);
    unsigned wa = weight_word(w, wc, vec, K, N, bn, pitch, n0, r0);
    unsigned wb = r0 + 1 < rows ? weight_word(w, wc, vec, K, N, bn, pitch, n0, r0 + 1) : 0u;
    for (int q = 0; q < pairs; ++q) {
      const int r = r0 + 2 * q;
      unsigned a = wa, b = wb;
      if (q + 1 < pairs) {  // the next pair's words, loaded under this one's work
        wa = weight_word(w, wc, vec, K, N, bn, pitch, n0, r + 2);
        wb = r + 3 < rows ? weight_word(w, wc, vec, K, N, bn, pitch, n0, r + 3) : 0u;
      }
      if (LAYOUT == kVertical) a ^= 0x88888888u, b ^= 0x88888888u;
      int4 gs = slot_group[warp][q];
      if (gs.z < 0) gs.z = gs.x, gs.w = gs.y;  // row r + 1 past K: its x is 0
      unsigned wd[4];
      if (gs.x == gs.z && gs.y == gs.w) {
        if (gs.x != cg0 || gs.y != cg1) {
          if (gs.x != cg0) cg0 = gs.x, mult4<PACKED>(mult, cg0, N, n0, ml);
          if (gs.y != cg1) cg1 = gs.y, mult4<PACKED>(mult, cg1, N, n0, mh);
#pragma unroll
          for (int c = 0; c < 4; ++c)
            bias[c] = (128u - 8u * ml[c]) * 0x00010001u + (128u - 8u * mh[c]) * 0x01000100u;
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          // bytes a.c, a.c, b.c, b.c: the low nibbles of rows r, r + 1 in
          // bytes 0 and 2, their high nibbles (shifted down) in bytes 1 and 3
          const unsigned B = __byte_perm(a, b, c * 0x0011u + (4 + c) * 0x1100u);
          const unsigned lo = (B & 0x000F000Fu) * (unsigned)ml[c];
          const unsigned hi = ((B >> 4) & 0x0F000F00u) * (unsigned)mh[c];
          wd[c] = (lo + hi + bias[c]) ^ 0x80808080u;
        }
      } else {
        int m4[4][4];
        mult4<PACKED>(mult, gs.x, N, n0, m4[0]);
        mult4<PACKED>(mult, gs.y, N, n0, m4[1]);
        mult4<PACKED>(mult, gs.z, N, n0, m4[2]);
        mult4<PACKED>(mult, gs.w, N, n0, m4[3]);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          unsigned v = 0;
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const unsigned u = ((t < 2 ? a : b) >> (8 * c + 4 * (t % 2))) & 15u;
            const unsigned m = (unsigned)m4[t][c];
            v |= (u * m + 128u - 8u * m) << (8 * t);
          }
          wd[c] = v ^ 0x80808080u;
        }
      }
#pragma unroll
      for (int i4 = 0; i4 < R; i4 += 4) {
        if (i4 >= mrows) break;
#pragma unroll
        for (int i = i4; i < i4 + 4; ++i) {
          const int xv = xw[warp][i][q];
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][c] = dp4a_ss(xv, (int)wd[c], acc[i][c]);
        }
      }
    }
    if (++runs == kAnyFlush) flush(), runs = 0;
  }
  flush();
  __syncthreads();
  for (int e = threadIdx.x; e < R * kAnyCols; e += kAnyThreads) {
    const int i = e / kAnyCols, col = e % kAnyCols;
    const int m = m0 + i, n = blockIdx.x * kAnyCols + col;
    if (m >= M || n >= N) continue;
    const long long t = (long long)total[i][col];
    const size_t at = (size_t)m * N + n;
    if (out_kind == kAnyPartials) {
      static_cast<int32_t*>(out)[at] = (int32_t)t;
      continue;
    }
    const float y = __fmul_rn(__fmul_rn(__ll2float_rn(t), s_col[n]), xs[m]);
    if (out_kind == kAnyBf16)
      static_cast<__nv_bfloat16*>(out)[at] = __float2bfloat16_rn(y);
    else
      static_cast<float*>(out)[at] = y;
  }
}

// Whether the CUDA-core route takes LAYOUT at (K, group): the layouts'
// own rules (kernels/matmul.py two_level_route): vertical K even and whole
// groups; paired whole group pairs; group halves an even group.
template <int LAYOUT>
__host__ __device__ inline bool any_layout_ok(int K, int group) {
  if (group < 1 || K < 2 || K % 2 != 0) return false;
  if (LAYOUT == kPaired) return K % (2 * group) == 0;
  if (LAYOUT == kHalves) return group % 2 == 0 && K % group == 0;
  return K % group == 0;
}

template <int LAYOUT, bool PACKED>
cudaError_t launch_two_level_any(const int8_t* x, const float* xs, const int8_t* w,
                                 const void* mult, const float* s_col, void* out, int out_kind,
                                 int M, int K, int N, int group, int bn, cudaStream_t st) {
  if (M < 1 || N < 1 || out_kind < kAnyF32 || out_kind > kAnyPartials ||
      !any_layout_ok<LAYOUT>(K, group) || bn < 0 || (bn > 0 && N % bn != 0))
    return cudaErrorInvalidValue;
  const dim3 grid((N + kAnyCols - 1) / kAnyCols, (M + kAnyRows - 1) / kAnyRows);
  two_level_any_kernel<LAYOUT, PACKED><<<grid, kAnyThreads, 0, st>>>(x, xs, w, mult, s_col, out,
                                                                     out_kind, M, K, N, group, bn);
  return cudaGetLastError();
}

}  // namespace ff
