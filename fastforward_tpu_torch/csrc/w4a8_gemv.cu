// W4A8 two-level GEMV, paired and group-halves layouts, with an optional
// argmax epilogue (paired), and its layer-stacked form.
//
// Replaces: fastforward_tpu/kernels/matmul.py matmul_w4a8_2l_gemv (:571,
// paired body :537, group-halves body :479), matmul_w4a8_2l_gemv_argmax
// (:708, body :650) and matmul_w4a8_2l_gemv_stacked (:1023): its default
// body (:815) on flat and on pre-blocked weights, its manual-DMA kernel
// (:879), its split-W kernel (:989), its dot-raw body (:949) and its
// concat-pairs body (:780), one entry each.
//   y = (sum_k x[m,k] * w8[k,n]) * s_col[n] * x_scale[m],
//   w8 = (u * m_g) - 8 * m_g per nibble plane
// x int8 (M, K); w (K/2, N) offset-binary nibbles in the adjacent-group
// pairing (byte row i of pair p: row 2p*g + i low, row (2p+1)*g + i high);
// m (K/g, N) int8 in [1, 15]; ff_w4a8_gemv_unpaired takes the
// group-halves pairing instead (pack_uint4_offset: byte row i of group p,
// row pg + i low, row pg + g/2 + i high), both planes scaled by m_p, the
// JAX package's unpaired layout (random_serving_params, repack_unpaired).
// f32 or bf16 logits, or with the argmax
// epilogue one int32 token id per row (first occurrence wins ties, a NaN
// counts as the maximum: the ids of torch.argmax over the logits).
// Bit-exact against matmul_w4a8_2l_reference.
// Every entry of the two-level layouts runs w4a8_mma.cuh's int8
// tensor-core tile, with its note: ff_w4a8_gemv and ff_w4a8_gemv_unpaired
// (row 5), the argmax head ff_w4a8_gemv_argmax (row 4) and the six routes
// of the stacked GEMV (row 9).
//
// The stacked entries read layer `layer` of (L, K/2, N) weights, or of
// their pre-blocked form (L, N/bn, K/2, bn) (preblock_stacked, matmul.py:
// 1240: each bn-column panel one contiguous chunk), its nibble-packed
// multipliers (L, ceil(K/g/8), N) int32 and s_col (L, N) in place: no
// per-layer slice is copied. Six routes, one entry and one launch count
// each, all the same tile and so bit-equal (the int32 sum is exact in any
// order; the same epilogue arithmetic):
//   ff_w4a8_gemv_stacked     flat weights, the tile's TMA box over the
//                            (K/2, N) bytes;
//   ff_w4a8_gemv_preblocked  pre-blocked: boxes over the panels where bn %
//                            128 == 0, else the tile's 4-byte feed (any bn
//                            % 4 == 0: a lane's 4 columns lie in one panel);
//   ff_w4a8_gemv_manual      pre-blocked, FF_2L_MANUAL = nbuf: the TPU
//                            kernel keeps nbuf - 1 panels in flight in a
//                            ring of nbuf VMEM slots; here the tile's ring
//                            of depth = min(nbuf, the block's stages, what
//                            fits in 227 KB) stages (the other routes take
//                            4);
//   ff_w4a8_gemv_splitw      flat, FF_2L_SPLITW: the TPU kernel reads each
//                            panel as two half-K operands, two DMA streams;
//                            the tile's producer warp already keeps depth -
//                            1 stages in flight, so it runs as it is;
//   ff_w4a8_gemv_dotraw      either layout, FF_2L_DOTRAW: the TPU body dots
//                            the sign-restored nibbles and applies the
//                            group multiplier to each group's int32 dot, to
//                            spare the VPU a multiply a weight. The tile
//                            folds the multiplier into the bytes it feeds
//                            the tensor cores (3 instructions a plane, the
//                            same sum exactly); a per-group partial would
//                            need a second accumulator set beyond the
//                            tile's 128 registers (the dp4a dot-raw body
//                            took 151 and ran slowest of the routes,
//                            PERF.md row 9d), so it runs the shared tile;
//   ff_w4a8_gemv_concat      either layout, FF_2L_CONCAT_PAIRS = cp: the
//                            TPU body folds cp pairs and issues one longer
//                            dot; the tile's ring already streams a split's
//                            units as one run of 64-row stages across pair
//                            boundaries, so it runs the shared tile, and
//                            every pair is computed (the TPU body drops the
//                            trailing pairs when cp does not divide their
//                            count, ROADMAP.md Queue 3).
// Bound: the decoder layer's below for every route (the same bytes and
// operations).
//
// Bound on the H100: the lm_head of Llama-3-8B moves 263 MB of packed
// weights per call against M <= 256 rows: bandwidth-bound (~78 us). A
// decoder layer at M = 192, g128 moves ~110 MB (0.033 ms) but asks
// 2*M*K*N = 8.4e10 int8 operations (0.042 ms at 1,979 TOP/s on the tensor
// cores).
//
// The argmax head: the TPU kernel carried a running (max, index) across
// its sequential grid; here blocks run in no order, so the tile's epilogue
// writes one (max, first index) pair per row and 128-column block and a
// second pass, one warp a row, reduces the pairs. The logits never reach
// device memory.
//
// ff_w4a8_gemv_halves: the float-scale W4A8 GEMV (FF_BENCH_MODE=w4a8).
// Replaces: matmul_w4a8_gemv (:341, kernel _w4a8_gemv_kernel :312).
//   gd_g[m, n] = sum_{k in group g} x[m, k] * v[k, n]     (int32, exact)
//   acc[m, n]  = sum_g float(gd_g) * s[g, n]               (f32, fixed order)
//   y[m, n]    = acc * xs[m]                               (f32 or bf16)
// w (K/2, N) in pack_int4's group halves (byte row i of group p: k = pg + i
// low nibble, pg + g/2 + i high, two's complement); s (K/g, N) f32. The
// group sum runs in the order of the jitted JAX oracle, which the port's
// matmul_w4a8_reference writes out: up to 32 groups a chain of fused
// multiply-adds in group order from +0; beyond, the rounded products in
// windows of 32 (the first shortened by lo = (32 ceil(G/32) - G) / 2), each
// summed in order from +0, then the window sums in order from +0. Bit for
// bit. The TPU kernel added the same products in group order without
// fusing.
//
// Bound on the H100 at M = 192: a Llama-3-8B layer reads 109 MB of packed
// weights and 1.7 MB of scales (0.033 ms) and does 8.4e10 int8 operations
// (0.042 ms at 1,979 TOP/s): operations, by a little.
//
// Design: a block owns 64 rows x 128 columns (8 warps of 32 x 32) and walks
// the groups in order, each group's activations, packed rows and scales
// staged by cp.async, two groups in flight. Per group a warp runs g/32
// int8 mma.sync k-steps into a fresh int32 accumulator, then each lane
// folds its 32 group dots into its f32 sums: every output's sum lives in
// one thread, so the order is the oracle's whatever the grid does (no
// split-K, no atomics). A nibble becomes an int8 operand with one mask —
// the high nibble in place is 16v as a signed byte, the low one shifted up
// likewise — so the int32 dot is 16 gd exactly and an arithmetic shift by 4
// recovers gd. Weight words are transposed in registers as in w8a8_gemm.cu.

#include "common.cuh"
#include "mma.cuh"
#include "w4a8_mma.cuh"

namespace {

constexpr int kHBM = 64, kHBN = 128;  // block tile of the halves GEMV
constexpr int kHThreads = 256;        // 8 warps: 2 (rows) x 4 (columns)
constexpr int kSumWindow = 32;        // the oracle's window of summation

// 16 v of the low and of the high nibble of each byte, as signed bytes.
__device__ __forceinline__ unsigned nib_lo16(unsigned w) { return (w << 4) & 0xF0F0F0F0u; }
__device__ __forceinline__ unsigned nib_hi16(unsigned w) { return w & 0xF0F0F0F0u; }

// Grid: (ceil(M / 64), ceil(N / 128)); lo: the first window's shortening
// (used when G = K / GROUP > 32).
template <int GROUP, typename OutT>
__global__ void __launch_bounds__(kHThreads)
w4a8_halves_kernel(const int8_t* __restrict__ x, const float* __restrict__ xs,
                   const int8_t* __restrict__ w, const float* __restrict__ s,
                   OutT* __restrict__ out, int M, int K, int N, int lo, bool vec16) {
  constexpr int kHalf = GROUP / 2;
  constexpr int kPA = GROUP + 16, kPB = kHBN + 16;  // shared pitches in bytes
  __shared__ __align__(16) int8_t sa[2][kHBM * kPA];
  __shared__ __align__(16) int8_t sb[2][kHalf * kPB];
  __shared__ __align__(16) float ss[2][kHBN];

  const int m0 = blockIdx.x * kHBM, n0 = blockIdx.y * kHBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int gid = lane / 4, tid = lane % 4;
  const int n_groups = K / GROUP;
  const bool windowed = n_groups > kSumWindow;

  auto load = [&](int stage, int g) {
    for (int i = threadIdx.x; i < kHBM * GROUP / 16; i += kHThreads) {
      const int r = i / (GROUP / 16), c = (i % (GROUP / 16)) * 16;
      const bool ok = m0 + r < M;
      ff::cp_async<16>(&sa[stage][r * kPA + c], ok ? x + (size_t)(m0 + r) * K + g * GROUP + c : x,
                       ok);
    }
    const int8_t* wg = w + (size_t)g * kHalf * N;
    if (vec16) {  // N % 16 == 0
      for (int i = threadIdx.x; i < kHalf * kHBN / 16; i += kHThreads) {
        const int r = i / (kHBN / 16), c = (i % (kHBN / 16)) * 16;
        const bool ok = n0 + c < N;
        ff::cp_async<16>(&sb[stage][r * kPB + c], ok ? wg + (size_t)r * N + n0 + c : w, ok);
      }
    } else {
      for (int i = threadIdx.x; i < kHalf * kHBN / 4; i += kHThreads) {
        const int r = i / (kHBN / 4), c = (i % (kHBN / 4)) * 4;
        const bool ok = n0 + c < N;
        ff::cp_async<4>(&sb[stage][r * kPB + c], ok ? wg + (size_t)r * N + n0 + c : w, ok);
      }
    }
    if (threadIdx.x < kHBN / 4) {  // N % 4 == 0: a chunk is in range or out whole
      const int c = 4 * threadIdx.x;
      const bool ok = n0 + c < N;
      ff::cp_async<16>(&ss[stage][c], ok ? s + (size_t)g * N + n0 + c : s, ok);
    }
    ff::cp_async_commit();
  };

  float facc[2][4][4], wacc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) facc[i][j][r] = wacc[i][j][r] = 0.f;

  load(0, 0);
  for (int g = 0; g < n_groups; ++g) {
    const int st = g & 1;
    if (g + 1 < n_groups) {
      load(st ^ 1, g + 1);
      ff::cp_async_wait<1>();
    } else {
      ff::cp_async_wait<0>();
    }
    __syncthreads();
    int iacc[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) iacc[i][j][r] = 0;
    const int8_t* ta = sa[st] + wm * 32 * kPA;
    const int8_t* tb = sb[st] + wn * 32 + 4 * gid;
    if constexpr (GROUP == 32) {
      // one k-step: k = 4tid.. are the low nibbles of byte rows 4tid..,
      // k = 16 + 4tid.. their high nibbles
      unsigned a[2][4], raw[4], b0[4], b1[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) ff::load_a_s8(a[i], ta + i * 16 * kPA, kPA, lane);
      ff::load_b_s8(raw, tb + 4 * tid * kPB, kPB);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b0[j] = nib_lo16(raw[j]);
        b1[j] = nib_hi16(raw[j]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) ff::mma_s8(iacc[i][j], a[i], b0[j], b1[j]);
    } else {
      // byte rows 32rb..32rb+31: their low nibbles are the k-step at
      // k = 32rb, their high nibbles the one at k = g/2 + 32rb
#pragma unroll
      for (int rb = 0; rb < kHalf / 32; ++rb) {
        unsigned r0[4], r1[4], al[2][4], ah[2][4];
        ff::load_b_s8(r0, tb + (32 * rb + 4 * tid) * kPB, kPB);
        ff::load_b_s8(r1, tb + (32 * rb + 16 + 4 * tid) * kPB, kPB);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          ff::load_a_s8(al[i], ta + i * 16 * kPA + 32 * rb, kPA, lane);
          ff::load_a_s8(ah[i], ta + i * 16 * kPA + kHalf + 32 * rb, kPA, lane);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            ff::mma_s8(iacc[i][j], al[i], nib_lo16(r0[j]), nib_lo16(r1[j]));
            ff::mma_s8(iacc[i][j], ah[i], nib_hi16(r0[j]), nib_hi16(r1[j]));
          }
      }
    }
    // Fold the group dots into the f32 sums, in group order.
    float sc[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) sc[c] = ss[st][wn * 32 + 8 * tid + c];
    const bool close = windowed && g > 0 && (g + lo) % kSumWindow == 0;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int c = 4 * (r % 2) + j;  // the column of register r of tile j
          const float gd = __int2float_rn(iacc[i][j][r] >> 4);
          if (!windowed) {
            facc[i][j][r] = __fmaf_rn(gd, sc[c], facc[i][j][r]);
          } else {
            if (close) {
              facc[i][j][r] = __fadd_rn(facc[i][j][r], wacc[i][j][r]);
              wacc[i][j][r] = 0.f;
            }
            wacc[i][j][r] = __fadd_rn(wacc[i][j][r], __fmul_rn(gd, sc[c]));
          }
        }
    __syncthreads();
  }

  const int nb = n0 + wn * 32 + 8 * tid;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 32 + i * 16 + gid + 8 * h;
      if (m >= M) continue;
      const float xm = xs[m];
      float v[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int j = c % 4, r = 2 * h + c / 4;
        const float sum = windowed ? __fadd_rn(facc[i][j][r], wacc[i][j][r]) : facc[i][j][r];
        v[c] = __fmul_rn(sum, xm);
      }
      ff::store8(out + (size_t)m * N, nb, N, v);
    }
  }
}

template <int GROUP, typename OutT>
int launch_halves(const void* x, const void* xs, const void* w, const void* s, void* out, int M,
                  int K, int N, cudaStream_t st) {
  const int n_groups = K / GROUP;
  const int padded = (n_groups + kSumWindow - 1) / kSumWindow * kSumWindow;
  const dim3 grid((M + kHBM - 1) / kHBM, (N + kHBN - 1) / kHBN);
  w4a8_halves_kernel<GROUP, OutT><<<grid, kHThreads, 0, st>>>(
      static_cast<const int8_t*>(x), static_cast<const float*>(xs), static_cast<const int8_t*>(w),
      static_cast<const float*>(s), static_cast<OutT*>(out), M, K, N, (padded - n_groups) / 2,
      N % 16 == 0);
  return cudaGetLastError();
}

template <typename OutT>
int launch_halves_group(const void* x, const void* xs, const void* w, const void* s, void* out,
                        int M, int K, int N, int group, cudaStream_t st) {
  switch (group) {
    case 32: return launch_halves<32, OutT>(x, xs, w, s, out, M, K, N, st);
    case 64: return launch_halves<64, OutT>(x, xs, w, s, out, M, K, N, st);
    case 128: return launch_halves<128, OutT>(x, xs, w, s, out, M, K, N, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (M, K) int8, xs (M,) f32, w (K/2, N) pack_int4, w_scale (K/g, N) f32,
// out (M, N) f32 or bf16; group 32, 64 or 128.
extern "C" int ff_w4a8_gemv_halves(const void* x, const void* xs, const void* w,
                                   const void* w_scale, void* out, int M, int K, int N, int group,
                                   int out_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    return launch_halves_group<__nv_bfloat16>(x, xs, w, w_scale, out, M, K, N, group, st);
  return launch_halves_group<float>(x, xs, w, w_scale, out, M, K, N, group, st);
}

// Row 5 on the int8 tensor-core tile (w4a8_mma.cuh): xf the staged
// activations (mma_plan's x_bytes), partial (n_split, M, N) int32 or NULL
// for one split, depth the ring's stages.
extern "C" int ff_w4a8_gemv(const void* x, const void* xs, const void* w, const void* mult,
                            const void* s_col, void* xf, void* partial, void* out, int M, int K,
                            int N, int group, int n_split, int depth, int out_kind,
                            void* stream) {
  return ff::mma8::launch<ff::kPaired, false>(
      static_cast<const int8_t*>(x), static_cast<const float*>(xs),
      static_cast<const int8_t*>(w), mult, static_cast<const float*>(s_col),
      static_cast<int8_t*>(xf), static_cast<int32_t*>(partial), out, out_kind, M, K, N, group,
      n_split, 0, depth, static_cast<cudaStream_t>(stream));
}

// Group-halves layout; group % 8 == 0.
extern "C" int ff_w4a8_gemv_unpaired(const void* x, const void* xs, const void* w,
                                     const void* mult, const void* s_col, void* xf,
                                     void* partial, void* out, int M, int K, int N, int group,
                                     int n_split, int depth, int out_kind, void* stream) {
  return ff::mma8::launch<ff::kHalves, false>(
      static_cast<const int8_t*>(x), static_cast<const float*>(xs),
      static_cast<const int8_t*>(w), mult, static_cast<const float*>(s_col),
      static_cast<int8_t*>(xf), static_cast<int32_t*>(partial), out, out_kind, M, K, N, group,
      n_split, 0, depth, static_cast<cudaStream_t>(stream));
}

// Row 4 on the tile with the argmax epilogue: idx_out (M,) int32; pair_val,
// pair_idx (M, ceil(N / 128)); xf, partial and depth as ff_w4a8_gemv's.
extern "C" int ff_w4a8_gemv_argmax(const void* x, const void* xs, const void* w,
                                   const void* mult, const void* s_col, void* xf, void* partial,
                                   void* pair_val, void* pair_idx, void* idx_out, int M, int K,
                                   int N, int group, int n_split, int depth, void* stream) {
  return ff::mma8::launch<ff::kPaired, false, true>(
      static_cast<const int8_t*>(x), static_cast<const float*>(xs),
      static_cast<const int8_t*>(w), mult, static_cast<const float*>(s_col),
      static_cast<int8_t*>(xf), static_cast<int32_t*>(partial), idx_out, 0, M, K, N, group,
      n_split, 0, depth, static_cast<cudaStream_t>(stream), static_cast<float*>(pair_val),
      static_cast<int*>(pair_idx));
}

namespace {

// Layer `layer` of stacked weights on the tensor-core tile: flat (L, K/2,
// N) (bn 0) or pre-blocked (L, N/bn, K/2, bn) (a layer is K*N/2 bytes
// either way), its nibble-packed multipliers (L, n_pack, N) and s_col
// (L, N), offset in place; xf and partial as ff_w4a8_gemv's, `depth` ring
// stages.
int stacked_tile(const void* x, const void* xs, const void* w, const void* mult_packed,
                 const void* s_col, void* xf, void* partial, void* out, int M, int K, int N,
                 int layer, int group, int n_pack, int n_split, int out_kind, int bn, int depth,
                 void* stream) {
  if (bn < 0 || (bn > 0 && (bn % 4 != 0 || N % bn != 0)) || n_pack * 8 < K / group)
    return cudaErrorInvalidValue;
  const int8_t* wl = static_cast<const int8_t*>(w) + (size_t)layer * (K / 2) * N;
  const int32_t* ml = static_cast<const int32_t*>(mult_packed) + (size_t)layer * n_pack * N;
  const float* sl = static_cast<const float*>(s_col) + (size_t)layer * N;
  return ff::mma8::launch<ff::kPaired, true>(
      static_cast<const int8_t*>(x), static_cast<const float*>(xs), wl, ml, sl,
      static_cast<int8_t*>(xf), static_cast<int32_t*>(partial), out, out_kind, M, K, N, group,
      n_split, bn, depth, static_cast<cudaStream_t>(stream));
}

}  // namespace

// The stacked GEMV's routes (matmul.py:1023-1237), one entry each, all on
// w4a8_mma.cuh's tile with its packed multipliers; the arguments: x, xs,
// w, mult_packed, s_col, xf, partial (or NULL for one split), out, M, K, N,
// L, layer, group, n_pack, n_split, out_kind, bn (0: flat), depth, stream.
// Flat weights: the default call (:1217) and split-W (kernel :989, call
// :1185). Pre-blocked weights (bn % 4 == 0): the default call on panels
// (:1211-1214) and the manual stream (kernel :879, call :1107, FF_2L_MANUAL
// = nbuf: depth = min(nbuf, ...) stages, depth - 1 in flight). Either
// layout: the dot-raw body (:949, picked at :1205-1208) and the
// concat-pairs body (:780, entered at :834-842; every pair computed).
extern "C" int ff_w4a8_gemv_stacked(const void* x, const void* xs, const void* w,
                                    const void* mult_packed, const void* s_col, void* xf,
                                    void* partial, void* out, int M, int K, int N, int L,
                                    int layer, int group, int n_pack, int n_split, int out_kind,
                                    int bn, int depth, void* stream) {
  (void)L;
  return stacked_tile(x, xs, w, mult_packed, s_col, xf, partial, out, M, K, N, layer, group,
                      n_pack, n_split, out_kind, bn, depth, stream);
}

extern "C" int ff_w4a8_gemv_preblocked(const void* x, const void* xs, const void* w,
                                       const void* mult_packed, const void* s_col, void* xf,
                                       void* partial, void* out, int M, int K, int N, int L,
                                       int layer, int group, int n_pack, int n_split, int out_kind,
                                       int bn, int depth, void* stream) {
  (void)L;
  return stacked_tile(x, xs, w, mult_packed, s_col, xf, partial, out, M, K, N, layer, group,
                      n_pack, n_split, out_kind, bn, depth, stream);
}

extern "C" int ff_w4a8_gemv_manual(const void* x, const void* xs, const void* w,
                                   const void* mult_packed, const void* s_col, void* xf,
                                   void* partial, void* out, int M, int K, int N, int L,
                                   int layer, int group, int n_pack, int n_split, int out_kind,
                                   int bn, int depth, void* stream) {
  (void)L;
  return stacked_tile(x, xs, w, mult_packed, s_col, xf, partial, out, M, K, N, layer, group,
                      n_pack, n_split, out_kind, bn, depth, stream);
}

extern "C" int ff_w4a8_gemv_splitw(const void* x, const void* xs, const void* w,
                                   const void* mult_packed, const void* s_col, void* xf,
                                   void* partial, void* out, int M, int K, int N, int L,
                                   int layer, int group, int n_pack, int n_split, int out_kind,
                                   int bn, int depth, void* stream) {
  (void)L;
  return stacked_tile(x, xs, w, mult_packed, s_col, xf, partial, out, M, K, N, layer, group,
                      n_pack, n_split, out_kind, bn, depth, stream);
}

extern "C" int ff_w4a8_gemv_dotraw(const void* x, const void* xs, const void* w,
                                   const void* mult_packed, const void* s_col, void* xf,
                                   void* partial, void* out, int M, int K, int N, int L,
                                   int layer, int group, int n_pack, int n_split, int out_kind,
                                   int bn, int depth, void* stream) {
  (void)L;
  return stacked_tile(x, xs, w, mult_packed, s_col, xf, partial, out, M, K, N, layer, group,
                      n_pack, n_split, out_kind, bn, depth, stream);
}

extern "C" int ff_w4a8_gemv_concat(const void* x, const void* xs, const void* w,
                                   const void* mult_packed, const void* s_col, void* xf,
                                   void* partial, void* out, int M, int K, int N, int L,
                                   int layer, int group, int n_pack, int n_split, int out_kind,
                                   int bn, int depth, void* stream) {
  (void)L;
  return stacked_tile(x, xs, w, mult_packed, s_col, xf, partial, out, M, K, N, layer, group,
                      n_pack, n_split, out_kind, bn, depth, stream);
}
