// W4A4 two-level GEMV over layer-stacked weights.
//
// Replaces: fastforward_tpu/kernels/matmul.py matmul_w4a4_2l_gemv_stacked
// (:1406, body _w4a4_2l_gemv_stacked_kernel :1342; non-stacked :1487).
//   y = (sum_g m[l,g,:] * (x4_g @ v4[l,g])) * s_col[l] * x_scale
// x int4 values in int8 (M, K); w (L, K/2, N) vertical int4 (byte row r:
// row 2r low nibble, row 2r+1 high nibble); m nibble-packed 8 per int32
// (L, ceil(K/g/8), N); int32 accumulation; bf16 out. Bit-exact against
// matmul_w4a4_2l_reference.
//
// Bound on the H100: for M <= 256 the packed weights dominate the bytes
// (K*N/2 per call, 109 MB per Llama-3-8B layer) and the work is a few
// integer ops per byte, so it is bandwidth-bound (3.35 TB/s).
//
// Design for that bound: weights are read exactly once per 8 activation
// rows, 128 contiguous bytes per warp and row, split over K so that even
// the narrow projections (o, down) put several hundred blocks on the 132
// SMs. Nibbles are expanded in registers (mask, xor to offset binary,
// one multiply by the group multiplier for 4 rows at once) and consumed
// by dp4a, four multiply-adds per instruction; activations sit in shared
// memory, split into the two nibble planes' rows. No intermediate goes to
// device memory except the int32 split partials (M*N*4 bytes per split).
// See common.cuh for the shared kernel.

#include "common.cuh"

extern "C" int ff_a4_gemv(const void* x, const void* xs, const void* w,
                          const void* mult_packed, const void* s_col, void* partial,
                          void* out, int M, int K, int N, int L, int layer, int group,
                          int n_pack, int n_split, void* stream) {
  (void)L;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* wl = static_cast<const int8_t*>(w) + (size_t)layer * (K / 2) * N;
  const int32_t* ml = static_cast<const int32_t*>(mult_packed) + (size_t)layer * n_pack * N;
  const float* sl = static_cast<const float*>(s_col) + (size_t)layer * N;
  cudaError_t err = ff::launch_gemv_partial<ff::kVertical>(
      static_cast<const int8_t*>(x), wl, ml, static_cast<int32_t*>(partial), M, K, N, group,
      n_split, st);
  if (err != cudaSuccess) return err;
  return ff::launch_gemv_epilogue<__nv_bfloat16, false>(
      static_cast<const int32_t*>(partial), n_split, M, N, sl, static_cast<const float*>(xs),
      static_cast<__nv_bfloat16*>(out), nullptr, nullptr, st);
}
