// Int4 -> bf16 dequantization of two-level and float-scale weights, for
// the prefill path.
//
// Replaces: fastforward_tpu/kernels/matmul.py
// dequantize_int4_vertical_stacked (:1736, kernel :1724) and
// dequantize_int4_paired_stacked (:1650, kernel :1634, on flat weights and
// on its pre-blocked branch :1666-1686, ff_dequant_paired_preblocked); at
// L = 1 with a ready per-group scale also dequantize_int4_vertical (:1511)
// and dequantize_int4 (:1561, kernels :1535 and :1549): its paired branch
// and its two group-halves branches (pack_int4's two's complement, the
// prefill of FF_BENCH_MODE=w4a8 and w4a16, and offset binary).
//   out[k, n] = bf16(float(v[k, n]) * s_eff[k / g, n])
//   s_eff[i, n] = float(mult[l, i, n]) * s_col[l, n]    (or given, f32)
// Rounding: two f32 products and one bf16 rounding, as the JAX package's
// CPU path computes it (matmul.py:1526-1527, :1583-1585, :1756-1760), bit
// for bit. The TPU kernels round s_eff to bf16 and multiply in bf16, which
// differs from that path; the port holds the CPU form.
// Layouts, byte row r of the packed (K/2, N):
//   vertical: rows 2r (low nibble) and 2r + 1 (high), two's complement;
//   paired:   p = r / g, i = r % g: rows 2pg + i (low) and (2p + 1)g + i
//             (high), offset binary u = v + 8;
//   halves:   p = r / (g/2), i = r % (g/2): rows pg + i (low) and
//             pg + g/2 + i (high), two's complement or offset binary.
// Byte (r, n) lies at r * N + n (flat), or in the pre-blocked form
// (N/bn, K/2, bn) of preblock_stacked at (n / bn) * (K/2) * bn + r * bn +
// n % bn: a thread's columns lie in one panel (8 of them where bn % 8 ==
// 0, else one), and rows lie bn bytes apart. The output is the flat (K, N)
// either way.
//
// Bound on the H100: bytes. K*N/2 packed bytes read and K*N*2 bf16 bytes
// written per call (the multipliers and scales are 1/g of that): 545 MB
// for the four projections of a Llama-3-8B layer, ~0.16 ms at 3.35 TB/s,
// with a few integer and float operations per byte. Four fifths of the
// bytes are the writes.
//
// Design for that bound (kernels/matmul.py dequant_plan mirrors the grid):
// - A thread owns 8 adjacent columns and R byte rows of one tile. It
//   issues all R of its 8-byte loads before it converts any (R loads in
//   flight a thread, where a loop of one load a row kept one), then writes
//   each byte row's two output rows as one 16-byte store each: a warp's 32
//   stores of a row are 512 contiguous bytes.
// - A block of 256 threads covers 2048 columns; the blocks walk the (row
//   tile, column tile) grid with the column tile fastest. R is 8, or 4
//   where 8 leaves fewer blocks than four of 256 threads on each SM (the
//   narrow projections, e.g. o_proj: 1,024 blocks, not 512), so every SM
//   has loads in flight from its first wave.
// - The per-group scales of the thread's columns are formed once a tile
//   (a tile's R rows lie in one group unit wherever a unit spans R byte
//   rows) and again only where a row enters another group.
// - An N that is not a multiple of 8 (pre-blocked: a bn that is not) takes
//   the same kernel with one column a thread.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocksPerSm = 4;  // R drops to 4 where 8 leaves fewer blocks an SM
enum Layout { kVertical = 0, kPaired = 1, kHalves = 2, kHalvesOffset = 3 };

// The V per-group scales of group `gi` at columns col0.. (f32).
template <int V, bool MULT>
__device__ __forceinline__ void group_scales(const int8_t* __restrict__ mult,
                                             const float* __restrict__ scale, int gi, int col0,
                                             int N, float s[V]) {
  if constexpr (MULT) {
    const int8_t* mp = mult + (size_t)gi * N + col0;
#pragma unroll
    for (int c = 0; c < V; ++c) s[c] = __fmul_rn(static_cast<float>(mp[c]), scale[col0 + c]);
  } else {
    const float* sp = scale + (size_t)gi * N + col0;
#pragma unroll
    for (int c = 0; c < V; ++c) s[c] = sp[c];
  }
}

__device__ __forceinline__ unsigned bf16x2(float lo, float hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

// A thread's packed bytes of one byte row: 8 columns (one 8-byte load) or 1.
template <int V>
struct Packed;
template <>
struct Packed<8> {
  uint2 w;
  __device__ __forceinline__ void load(const int8_t* p) {
    w = __ldg(reinterpret_cast<const uint2*>(p));
  }
  __device__ __forceinline__ unsigned byte(int c) const {
    return ((c < 4 ? w.x : w.y) >> (8 * (c % 4))) & 0xFFu;
  }
};
template <>
struct Packed<1> {
  unsigned b;
  __device__ __forceinline__ void load(const int8_t* p) {
    b = static_cast<unsigned char>(__ldg(p));
  }
  __device__ __forceinline__ unsigned byte(int) const { return b; }
};

// Writes V bf16 values of one output row at columns col0..: one 16-byte
// store for 8.
template <int V>
__device__ __forceinline__ void store_row(__nv_bfloat16* __restrict__ dst, const float y[V]) {
  if constexpr (V == 8) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(bf16x2(y[0], y[1]), bf16x2(y[2], y[3]),
                                                bf16x2(y[4], y[5]), bf16x2(y[6], y[7]));
  } else {
#pragma unroll
    for (int c = 0; c < V; ++c) dst[c] = __float2bfloat16_rn(y[c]);
  }
}

// Grid: col_tiles * ceil(K/2 / R) blocks (column tile fastest), kThreads
// threads; block b covers byte rows R (b / col_tiles) .. and columns
// kThreads V (b % col_tiles) ... w, mult and scale point at the selected
// layer. MULT: scale is s_col (N,) and mult (K/g, N) int8; else scale is
// s_eff (K/g, N) f32 and mult is unused. bn: the pre-blocked panel width,
// or N for the flat layout (one panel).
template <int LAYOUT, int V, bool MULT, int R>
__global__ void __launch_bounds__(kThreads)
dequant_kernel(const int8_t* __restrict__ w, const int8_t* __restrict__ mult,
               const float* __restrict__ scale, __nv_bfloat16* __restrict__ out, int K,
               int N, int group, int bn, int col_tiles) {
  const int col0 = ((blockIdx.x % col_tiles) * kThreads + threadIdx.x) * V;
  if (col0 >= N) return;
  const int8_t* wcol = w + (size_t)(col0 / bn) * (K / 2) * bn + col0 % bn;
  const int r0 = (blockIdx.x / col_tiles) * R;
  const int rows = min(R, K / 2 - r0);
  Packed<V> pk[R];
#pragma unroll
  for (int i = 0; i < R; ++i)  // every load before any conversion
    if (i < rows) pk[i].load(wcol + (size_t)(r0 + i) * bn);
  float s_lo[V], s_hi[V];
  int cur = -1;  // group of the low plane whose scales s_lo holds
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (i >= rows) break;
    const int r = r0 + i;
    int row_lo, row_hi, g_lo;
    if (LAYOUT == kVertical) {
      row_lo = 2 * r;
      row_hi = row_lo + 1;
      g_lo = row_lo / group;
    } else if (LAYOUT == kPaired) {
      const int p = r / group, j = r % group;
      row_lo = 2 * p * group + j;
      row_hi = row_lo + group;
      g_lo = 2 * p;
    } else {
      const int half = group / 2, p = r / half, j = r % half;
      row_lo = p * group + j;
      row_hi = row_lo + half;
      g_lo = p;
    }
    if (g_lo != cur) {
      cur = g_lo;
      group_scales<V, MULT>(mult, scale, g_lo, col0, N, s_lo);
      if (LAYOUT != kPaired) {  // both nibbles in one group
#pragma unroll
        for (int c = 0; c < V; ++c) s_hi[c] = s_lo[c];
      } else {
        group_scales<V, MULT>(mult, scale, g_lo + 1, col0, N, s_hi);
      }
    }
    float y_lo[V], y_hi[V];
#pragma unroll
    for (int c = 0; c < V; ++c) {
      const unsigned b = pk[i].byte(c);
      int v_lo, v_hi;
      if (LAYOUT == kVertical || LAYOUT == kHalves) {  // two's complement nibbles
        v_lo = static_cast<int>((b & 0xFu) ^ 8u) - 8;
        v_hi = static_cast<int>(static_cast<int8_t>(b)) >> 4;
      } else {  // offset binary
        v_lo = static_cast<int>(b & 0xFu) - 8;
        v_hi = static_cast<int>(b >> 4) - 8;
      }
      y_lo[c] = __fmul_rn(static_cast<float>(v_lo), s_lo[c]);
      y_hi[c] = __fmul_rn(static_cast<float>(v_hi), s_hi[c]);
    }
    store_row<V>(out + (size_t)row_lo * N + col0, y_lo);
    store_row<V>(out + (size_t)row_hi * N + col0, y_hi);
  }
}

int sm_count() {
  static const int n = [] {
    int dev = 0, v = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 132;
    return v;
  }();
  return n;
}

template <int LAYOUT, int V, bool MULT>
cudaError_t run(int R, int blocks, const int8_t* w, const int8_t* m, const float* s,
                __nv_bfloat16* o, int K, int N, int group, int bn, int col_tiles,
                cudaStream_t st) {
  if (R == 8)
    dequant_kernel<LAYOUT, V, MULT, 8><<<blocks, kThreads, 0, st>>>(w, m, s, o, K, N, group, bn,
                                                                     col_tiles);
  else
    dequant_kernel<LAYOUT, V, MULT, 4><<<blocks, kThreads, 0, st>>>(w, m, s, o, K, N, group, bn,
                                                                     col_tiles);
  return cudaGetLastError();
}

template <int LAYOUT>
int launch(const void* w, const void* mult, const void* scale, void* out, int K, int N, int L,
           int layer, int group, void* stream, int bn = 0) {
  (void)L;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* wl = static_cast<const int8_t*>(w) + (size_t)layer * (K / 2) * N;
  const int8_t* ml = mult ? static_cast<const int8_t*>(mult) + (size_t)layer * (K / group) * N
                          : nullptr;
  const float* sl = static_cast<const float*>(scale) + (mult ? (size_t)layer * N : 0);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  if (bn <= 0) bn = N;
  // the plan of kernels/matmul.py dequant_plan
  const int v = bn % 8 == 0 ? 8 : 1;
  const int col_tiles = (N / v + kThreads - 1) / kThreads;
  int R = 8;
  if (col_tiles * ((K / 2 + 7) / 8) < kMinBlocksPerSm * sm_count()) R = 4;
  const int blocks = col_tiles * ((K / 2 + R - 1) / R);
  if (v == 8)
    return ml ? run<LAYOUT, 8, true>(R, blocks, wl, ml, sl, o, K, N, group, bn, col_tiles, st)
              : run<LAYOUT, 8, false>(R, blocks, wl, ml, sl, o, K, N, group, bn, col_tiles, st);
  return ml ? run<LAYOUT, 1, true>(R, blocks, wl, ml, sl, o, K, N, group, bn, col_tiles, st)
            : run<LAYOUT, 1, false>(R, blocks, wl, ml, sl, o, K, N, group, bn, col_tiles, st);
}

}  // namespace

// w (L, K/2, N) int8; mult (L, K/g, N) int8 with scale = s_col (L, N) f32,
// or mult = NULL with scale = s_eff (K/g, N) f32 (L = 1, layer 0);
// out (K, N) bf16.
extern "C" int ff_dequant_vertical(const void* w, const void* mult, const void* scale, void* out,
                                   int K, int N, int L, int layer, int group, void* stream) {
  return launch<kVertical>(w, mult, scale, out, K, N, L, layer, group, stream);
}

extern "C" int ff_dequant_paired(const void* w, const void* mult, const void* scale, void* out,
                                 int K, int N, int L, int layer, int group, void* stream) {
  return launch<kPaired>(w, mult, scale, out, K, N, L, layer, group, stream);
}

// The group-halves layouts: offset_binary 0 (pack_int4) or 1.
extern "C" int ff_dequant_halves(const void* w, const void* mult, const void* scale, void* out,
                                 int K, int N, int L, int layer, int group, int offset_binary,
                                 void* stream) {
  if (offset_binary)
    return launch<kHalvesOffset>(w, mult, scale, out, K, N, L, layer, group, stream);
  return launch<kHalves>(w, mult, scale, out, K, N, L, layer, group, stream);
}

// Pre-blocked paired weights (L, N/bn, K/2, bn), mult (L, K/g, N) int8 and
// s_col (L, N) f32 (the multipliers and scales stay flat); out (K, N) bf16.
extern "C" int ff_dequant_paired_preblocked(const void* w, const void* mult, const void* scale,
                                           void* out, int K, int N, int L, int layer, int group,
                                           int bn, void* stream) {
  if (bn <= 0 || N % bn != 0) return cudaErrorInvalidValue;
  return launch<kPaired>(w, mult, scale, out, K, N, L, layer, group, stream, bn);
}
