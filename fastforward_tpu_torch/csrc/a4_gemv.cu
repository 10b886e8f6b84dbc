// W4A4 two-level GEMV over layer-stacked weights, on the int8 tensor-core
// tile of w4a8_mma.cuh (the vertical layout case).
//
// Replaces: fastforward_tpu/kernels/matmul.py matmul_w4a4_2l_gemv_stacked
// (:1406, body _w4a4_2l_gemv_stacked_kernel :1342; non-stacked :1487).
//   y = (sum_g m[l,g,:] * (x4_g @ v4[l,g])) * s_col[l] * x_scale
// x int4 values in int8 (M, K); w (L, K/2, N) vertical int4 (byte row r:
// row 2r low nibble, row 2r+1 high nibble, two's complement); m
// nibble-packed 8 per int32 (L, ceil(K/g/8), N); int32 accumulation; f32
// or bf16 out. Bit-exact against matmul_w4a4_2l_reference. Groups the tile
// does not take (g % 8 != 0, N % 4 != 0) run w4a8_mma.cuh's any-group
// route on the same tensor cores (ff_a4_gemv_any).
//
// Bound on the H100: a Llama-3-8B layer (its four fused projections) at
// M = 192 does 8.4e10 int8 operations (0.042 ms at 1,979 TOP/s) on 110 MB
// of packed weights (0.033 ms): operations, by a little; at M = 8 the
// bytes.
//
// Design: the tile of the two-level W4A8 GEMV (w4a8_mma.cuh) with a unit
// of one group (g/2 byte rows, both nibble planes under the group's
// multiplier), the layer's (K/2, N) bytes read in place through the 2-D
// TMA box, the packed multipliers by bulk copy. Each weight word is
// flipped to offset binary (one XOR) and folded with its multiplier into
// int8 bytes m * v; the activations are staged once a call in fragment
// order, the two planes de-interleaved from x's alternate k. The fused A4
// layer head (fused_head.cu) runs the same tile after its prologue.

#include "w4a8_mma.cuh"

// xf: the staged activations (mma_plan's x_bytes); partial (n_split, M, N)
// int32, or NULL for one split; depth: the ring's stages; out_kind 0 f32,
// 1 bf16.
extern "C" int ff_a4_gemv(const void* x, const void* xs, const void* w,
                          const void* mult_packed, const void* s_col, void* xf, void* partial,
                          void* out, int M, int K, int N, int L, int layer, int group,
                          int n_pack, int n_split, int depth, int out_kind, void* stream) {
  if (layer < 0 || layer >= L || group < 8 || group % 8 != 0 || K % group != 0 ||
      n_pack * 8 < K / group)
    return cudaErrorInvalidValue;
  const int8_t* wl = static_cast<const int8_t*>(w) + (size_t)layer * (K / 2) * N;
  const int32_t* ml = static_cast<const int32_t*>(mult_packed) + (size_t)layer * n_pack * N;
  const float* sl = static_cast<const float*>(s_col) + (size_t)layer * N;
  return ff::mma8::launch<ff::kVertical, true>(
      static_cast<const int8_t*>(x), static_cast<const float*>(xs), wl, ml, sl,
      static_cast<int8_t*>(xf), static_cast<int32_t*>(partial), out,
      out_kind == ff::mma8::kOutBf16 ? ff::mma8::kOutBf16 : ff::mma8::kOutF32, M, K, N, group,
      n_split, 0, depth, static_cast<cudaStream_t>(stream));
}

// Any group of the vertical layout (K even, whole groups), N any, on
// w4a8_mma.cuh's any-group route (launch_rows): the arguments of
// ff_a4_gemv, xf sized and n_split, depth planned by kernels/matmul.py
// rows_plan.
extern "C" int ff_a4_gemv_any(const void* x, const void* xs, const void* w,
                              const void* mult_packed, const void* s_col, void* xf,
                              void* partial, void* out, int M, int K, int N, int L, int layer,
                              int group, int n_pack, int n_split, int depth, int out_kind,
                              void* stream) {
  if (layer < 0 || layer >= L || group < 1 || K % group != 0 || n_pack * 8 < K / group ||
      out_kind < ff::mma8::kOutF32 || out_kind > ff::mma8::kOutBf16)
    return cudaErrorInvalidValue;
  return ff::mma8::launch_rows<ff::kVertical, true>(
      static_cast<const int8_t*>(x), static_cast<const float*>(xs),
      static_cast<const int8_t*>(w) + (size_t)layer * (K / 2) * N,
      static_cast<const int32_t*>(mult_packed) + (size_t)layer * n_pack * N,
      static_cast<const float*>(s_col) + (size_t)layer * N, static_cast<int8_t*>(xf),
      static_cast<int32_t*>(partial), out, out_kind, M, K, N, group, n_split, 0, depth,
      static_cast<cudaStream_t>(stream));
}
