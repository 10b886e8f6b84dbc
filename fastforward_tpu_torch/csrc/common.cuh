// Shared device code of the port's two-level int4 GEMVs (a4_gemv.cu,
// w4a8_gemv.cu, fused_tail.cu): the split-K partial-sum tile and kernel,
// and the epilogue, whose compile-time ARGMAX flag turns the logits into
// token ids.
//
// Both GEMVs compute, per output column n and row m,
//   acc[m, n] = sum_g m_g[n] * sum_{k in g} x[m, k] * v[k, n]      (int32)
//   y[m, n]   = (float(acc) * s_col[n]) * x_scale[m]
// with v in [-8, 7] stored as nibbles and m_g in [1, 15]. They differ only
// in where the two nibbles of a weight byte sit along K (the LAYOUT
// template argument) and how the multipliers are stored.
//
// Work split. A block owns 128 columns (32 lanes x 4 adjacent columns,
// one 4-byte load per lane per byte row, 128 contiguous bytes per warp) and
// 8 activation rows, over one K split of whole "units" (a group for the
// vertical layout, an adjacent-group pair for the paired layout). Its 8
// warps take interleaved quads of 4 byte rows. A lane transposes the 4x4
// bytes it loaded so each 32-bit word holds one column's 4 consecutive
// rows, splits the nibble planes with two masks, multiplies each plane by
// the column's group multiplier (u*m <= 225 fits a byte: no carry) and
// feeds dp4a dot products against the staged activations. Nibbles
// are used offset-binary (u = v + 8), so each group contributes
//   m * (sum x*u) - 8 * m * (sum x),
// the second term from per-group activation sums computed once per block.
// Warps are summed in shared memory; splits write int32 partials that the
// epilogue adds in a fixed order, so the result is exact and deterministic.

#pragma once

#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ff {

constexpr int kBM = 8;          // activation rows per block
constexpr int kWarps = 8;       // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kBN = 128;        // columns per block (32 lanes x 4)

enum Layout { kVertical = 0, kPaired = 1 };

// d = a . b + c over 4 byte lanes, a signed, b unsigned.
__device__ __forceinline__ int dp4a_su(int a, unsigned b, int c) {
  int d;
  asm("dp4a.s32.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

__device__ __forceinline__ int dp4a_ss(int a, int b, int c) {
  int d;
  asm("dp4a.s32.s32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// 4x4 byte transpose: r[i] holds row i of 4 columns; c[j] gets column j
// of the 4 rows (byte i = row i).
__device__ __forceinline__ void transpose4x4(const unsigned r[4], unsigned c[4]) {
  unsigned t0 = __byte_perm(r[0], r[1], 0x5140);
  unsigned t1 = __byte_perm(r[0], r[1], 0x7362);
  unsigned t2 = __byte_perm(r[2], r[3], 0x5140);
  unsigned t3 = __byte_perm(r[2], r[3], 0x7362);
  c[0] = __byte_perm(t0, t2, 0x5410);
  c[1] = __byte_perm(t0, t2, 0x7632);
  c[2] = __byte_perm(t1, t3, 0x5410);
  c[3] = __byte_perm(t1, t3, 0x7632);
}

// Split-K partial GEMV.
//   x        (M, K) int8 activations
//   w        (K/2, N) int8 packed weights of one layer
//   mult     PACKED: (n_pack, N) int32, 8 nibble multipliers per word
//            (always for kVertical; the stacked W4A8 GEMV for kPaired)
//            else:   (n_groups, N) int8
//   partial  (n_split, M, N) int32
// gemv_tile computes one (row tile, column tile, split) of it with all
// kThreads threads of the block, in dynamic shared memory `smem` of
// gemv_smem_bytes(units_per_split * rows_per_unit, units_per_split) bytes;
// gemv_partial_kernel runs one tile per block on the grid
// (ceil(M/8), ceil(N/128), n_split), and fused_tail.cu runs many tiles per
// block of a persistent grid.
// rows_per_unit: byte rows of one unit (group/2 vertical, group paired).
template <int LAYOUT, bool PACKED>
__device__ __forceinline__ void
gemv_tile(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
          const void* __restrict__ mult, int32_t* __restrict__ partial,
          int M, int K, int N, int group, int units_per_split, int n_units,
          int m_tile, int n_tile, int split, unsigned char* smem) {
  const int rows_per_unit = LAYOUT == kVertical ? group / 2 : group;
  const int u0 = split * units_per_split;
  const int n_u = min(units_per_split, n_units - u0);
  const int KR = units_per_split * rows_per_unit;  // smem row pitch (bytes)
  int8_t* xa = reinterpret_cast<int8_t*>(smem);             // [kBM][KR]
  int8_t* xb = xa + kBM * KR;                               // [kBM][KR]
  int* sxa = reinterpret_cast<int*>(xb + kBM * KR);         // [kBM][units]
  int* sxb = sxa + kBM * units_per_split;                   // [kBM][units]
  int* red = sxb + kBM * units_per_split;                   // [kWarps][kBM][kBN]

  const int m0 = m_tile * kBM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = u0 * rows_per_unit;  // first byte row of this split

  // Stage the activations: xa pairs with the low nibble plane, xb with the
  // high one, both indexed by the byte row local to the split.
  const int words = n_u * rows_per_unit / 4;  // int32 words per row and plane
  for (int i = threadIdx.x; i < kBM * words; i += kThreads) {
    const int m = i / words, q = i % words;
    unsigned a = 0, b = 0;
    if (m0 + m < M) {
      const int8_t* xr = x + (size_t)(m0 + m) * K;
      if (LAYOUT == kVertical) {
        // byte row r holds k = 2r (low) and 2r + 1 (high)
        const int k = 2 * (row0 + 4 * q);
        const unsigned lo = *reinterpret_cast<const unsigned*>(xr + k);
        const unsigned hi = *reinterpret_cast<const unsigned*>(xr + k + 4);
        a = __byte_perm(lo, hi, 0x6420);
        b = __byte_perm(lo, hi, 0x7531);
      } else {
        // byte row i of pair p holds k = 2pg + i (low) and (2p+1)g + i (high)
        const int r = row0 + 4 * q;
        const int p = r / group, i_in = r % group;
        a = *reinterpret_cast<const unsigned*>(xr + 2 * p * group + i_in);
        b = *reinterpret_cast<const unsigned*>(xr + (2 * p + 1) * group + i_in);
      }
    }
    reinterpret_cast<unsigned*>(xa + m * KR)[q] = a;
    reinterpret_cast<unsigned*>(xb + m * KR)[q] = b;
  }
  __syncthreads();

  // Per-unit activation sums (the offset-binary correction): warp m sums row m.
  for (int u = 0; u < n_u; ++u) {
    const int m = warp;
    int sa = 0, sb = 0;
    const unsigned* pa = reinterpret_cast<const unsigned*>(xa + m * KR + u * rows_per_unit);
    const unsigned* pb = reinterpret_cast<const unsigned*>(xb + m * KR + u * rows_per_unit);
    for (int q = lane; q < rows_per_unit / 4; q += 32) {
      sa = dp4a_ss(static_cast<int>(pa[q]), 0x01010101, sa);
      sb = dp4a_ss(static_cast<int>(pb[q]), 0x01010101, sb);
    }
    for (int off = 16; off > 0; off >>= 1) {
      sa += __shfl_xor_sync(0xffffffffu, sa, off);
      sb += __shfl_xor_sync(0xffffffffu, sb, off);
    }
    if (lane == 0) {
      sxa[m * units_per_split + u] = sa;
      sxb[m * units_per_split + u] = sb;
    }
  }
  __syncthreads();

  const int n0 = n_tile * kBN + lane * 4;
  const bool live = n0 < N;  // N % 4 == 0: a live lane owns 4 valid columns
  int acc[kBM][4];
#pragma unroll
  for (int m = 0; m < kBM; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0;

  if (live) {
    for (int u = 0; u < n_u; ++u) {
      const int unit = u0 + u;
      unsigned ma[4], mb[4];
      if (PACKED) {
        // vertical: the unit is group `unit`; paired: groups 2u and 2u + 1,
        // adjacent nibbles of one word (2u % 8 is even)
        const int g0 = LAYOUT == kVertical ? unit : 2 * unit;
        const int32_t* mp = static_cast<const int32_t*>(mult) + (size_t)(g0 / 8) * N + n0;
        const int sh = 4 * (g0 % 8);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          ma[c] = (static_cast<unsigned>(mp[c]) >> sh) & 0xFu;
          mb[c] = LAYOUT == kVertical ? ma[c] : (static_cast<unsigned>(mp[c]) >> (sh + 4)) & 0xFu;
        }
      } else {
        const int8_t* mr = static_cast<const int8_t*>(mult);
        const unsigned wa = *reinterpret_cast<const unsigned*>(mr + (size_t)(2 * unit) * N + n0);
        const unsigned wb = *reinterpret_cast<const unsigned*>(mr + (size_t)(2 * unit + 1) * N + n0);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          ma[c] = (wa >> (8 * c)) & 0xFFu;
          mb[c] = (wb >> (8 * c)) & 0xFFu;
        }
      }
      // The correction term is added once per block: by warp 0.
      if (warp == 0) {
#pragma unroll
        for (int m = 0; m < kBM; ++m) {
          const int sa = sxa[m * units_per_split + u], sb = sxb[m * units_per_split + u];
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[m][c] -= 8 * (static_cast<int>(ma[c]) * sa + static_cast<int>(mb[c]) * sb);
        }
      }
      const int quads = rows_per_unit / 4;
#pragma unroll 2
      for (int q = warp; q < quads; q += kWarps) {
        const int lr = u * rows_per_unit + 4 * q;  // byte row local to the split
        const int8_t* wp = w + (size_t)(row0 + lr) * N + n0;
        unsigned r[4], col[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          r[i] = __ldg(reinterpret_cast<const unsigned*>(wp + (size_t)i * N));
        transpose4x4(r, col);
        unsigned pa[4], pb[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          unsigned lo = col[c] & 0x0F0F0F0Fu, hi = (col[c] >> 4) & 0x0F0F0F0Fu;
          if (LAYOUT == kVertical) {  // two's complement -> offset binary
            lo ^= 0x08080808u;
            hi ^= 0x08080808u;
          }
          pa[c] = lo * ma[c];
          pb[c] = hi * mb[c];
        }
#pragma unroll
        for (int m = 0; m < kBM; ++m) {
          const int a = *reinterpret_cast<const int*>(xa + m * KR + lr);
          const int b = *reinterpret_cast<const int*>(xb + m * KR + lr);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc[m][c] = dp4a_su(a, pa[c], acc[m][c]);
            acc[m][c] = dp4a_su(b, pb[c], acc[m][c]);
          }
        }
      }
    }
  }

  // Sum the 8 warps' accumulators and write this split's partial.
#pragma unroll
  for (int m = 0; m < kBM; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) red[(warp * kBM + m) * kBN + lane * 4 + c] = acc[m][c];
  __syncthreads();
  for (int i = threadIdx.x; i < kBM * kBN; i += kThreads) {
    const int m = i / kBN, nl = i % kBN;
    const int n = n_tile * kBN + nl;
    if (m0 + m >= M || n >= N) continue;
    int s = 0;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) s += red[(wi * kBM + m) * kBN + nl];
    partial[((size_t)split * M + m0 + m) * N + n] = s;
  }
}

template <int LAYOUT, bool PACKED>
__global__ void __launch_bounds__(kThreads)
gemv_partial_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                    const void* __restrict__ mult, int32_t* __restrict__ partial,
                    int M, int K, int N, int group, int units_per_split,
                    int n_units) {
  extern __shared__ __align__(16) unsigned char smem[];
  gemv_tile<LAYOUT, PACKED>(x, w, mult, partial, M, K, N, group, units_per_split, n_units,
                            blockIdx.x, blockIdx.y, blockIdx.z, smem);
}

inline size_t gemv_smem_bytes(int rows_per_split, int units_per_split) {
  return (size_t)2 * kBM * rows_per_split + (size_t)2 * kBM * units_per_split * 4 +
         (size_t)kWarps * kBM * kBN * 4;
}

template <int LAYOUT, bool PACKED = LAYOUT == kVertical>
cudaError_t launch_gemv_partial(const int8_t* x, const int8_t* w, const void* mult,
                                int32_t* partial, int M, int K, int N, int group,
                                int n_split, cudaStream_t stream) {
  const int rows_per_unit = LAYOUT == kVertical ? group / 2 : group;
  const int n_units = LAYOUT == kVertical ? K / group : K / (2 * group);
  const int ups = (n_units + n_split - 1) / n_split;
  const size_t smem = gemv_smem_bytes(ups * rows_per_unit, ups);
  cudaFuncSetAttribute(gemv_partial_kernel<LAYOUT, PACKED>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN, n_split);
  gemv_partial_kernel<LAYOUT, PACKED><<<grid, kThreads, smem, stream>>>(
      x, w, mult, partial, M, K, N, group, ups, n_units);
  return cudaGetLastError();
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

// Second pass: reduce a row's tile pairs to its token id.
__global__ void argmax_reduce_kernel(const float* __restrict__ pair_val,
                                     const int* __restrict__ pair_idx, int n_tiles,
                                     int* __restrict__ idx_out) {
  const int m = blockIdx.x;
  if (threadIdx.x != 0) return;
  float bv = pair_val[m * n_tiles];
  int bi = pair_idx[m * n_tiles];
  for (int t = 1; t < n_tiles; ++t) {
    const float v = pair_val[m * n_tiles + t];
    const int i = pair_idx[m * n_tiles + t];
    if (better(v, i, bv, bi)) { bv = v; bi = i; }
  }
  idx_out[m] = bi;
}

}  // namespace ff
