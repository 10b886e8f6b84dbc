// W4A8 two-level GEMV, paired layout, with an optional argmax epilogue, and
// its layer-stacked form.
//
// Replaces: fastforward_tpu/kernels/matmul.py matmul_w4a8_2l_gemv (:571,
// paired body :537), matmul_w4a8_2l_gemv_argmax (:708, body :650) and
// matmul_w4a8_2l_gemv_stacked (:1023, default body :815; the :780, :879,
// :949 and :989 variants compute the same function).
//   y = (sum_k x[m,k] * w8[k,n]) * s_col[n] * x_scale[m],
//   w8 = (u * m_g) - 8 * m_g per nibble plane
// x int8 (M, K); w (K/2, N) offset-binary nibbles in the adjacent-group
// pairing (byte row i of pair p: row 2p*g + i low, row (2p+1)*g + i high);
// m (K/g, N) int8 in [1, 15]; f32 or bf16 logits, or with the argmax
// epilogue one int32 token id per row (first occurrence wins ties, a NaN
// counts as the maximum: the ids of torch.argmax over the logits).
// Bit-exact against matmul_w4a8_2l_reference.
//
// The stacked entry reads layer `layer` of (L, K/2, N) weights, its
// nibble-packed multipliers (L, ceil(K/g/8), N) int32 and s_col (L, N) in
// place: no per-layer slice is copied.
//
// Bound on the H100: the lm_head of Llama-3-8B moves 263 MB of packed
// weights per call against M <= 256 rows: bandwidth-bound (~78 us). A
// decoder layer at M = 192, g128 moves ~110 MB (0.033 ms) but asks
// 2*M*K*N = 8.4e10 int8 operations (0.042 ms at 1,979 TOP/s on the tensor
// cores); dp4a on the CUDA cores is far from that rate.
//
// Design for that bound: the same split-K partial kernel as the A4 GEMV
// (common.cuh) reads each weight byte once per 8 rows; the two nibble
// planes of a byte go to the two groups of its pair, each plane scaled by
// its own group multiplier in one register multiply. The TPU kernel
// carried a running (max, index) across its sequential grid; here blocks
// run in no order, so the argmax epilogue writes one (max, index) pair per
// row and 1024-column tile and a second tiny pass reduces the pairs in
// tile order. The logits never reach device memory on the argmax path.

#include "common.cuh"

extern "C" int ff_w4a8_gemv(const void* x, const void* xs, const void* w, const void* mult,
                            const void* s_col, void* partial, void* out, int M, int K, int N,
                            int group, int n_split, int out_kind, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = ff::launch_gemv_partial<ff::kPaired>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), mult,
      static_cast<int32_t*>(partial), M, K, N, group, n_split, st);
  if (err != cudaSuccess) return err;
  const int32_t* p = static_cast<const int32_t*>(partial);
  const float* sc = static_cast<const float*>(s_col);
  const float* xsf = static_cast<const float*>(xs);
  if (out_kind == 0)
    return ff::launch_gemv_epilogue<float, false>(p, n_split, M, N, sc, xsf,
                                                  static_cast<float*>(out), nullptr, nullptr, st);
  return ff::launch_gemv_epilogue<__nv_bfloat16, false>(
      p, n_split, M, N, sc, xsf, static_cast<__nv_bfloat16*>(out), nullptr, nullptr, st);
}

extern "C" int ff_w4a8_gemv_argmax(const void* x, const void* xs, const void* w,
                                   const void* mult, const void* s_col, void* partial,
                                   void* pair_val, void* pair_idx, void* idx_out, int M, int K,
                                   int N, int group, int n_split, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = ff::launch_gemv_partial<ff::kPaired>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), mult,
      static_cast<int32_t*>(partial), M, K, N, group, n_split, st);
  if (err != cudaSuccess) return err;
  const int n_tiles = (N + ff::kEpiTile - 1) / ff::kEpiTile;
  err = ff::launch_gemv_epilogue<float, true>(
      static_cast<const int32_t*>(partial), n_split, M, N, static_cast<const float*>(s_col),
      static_cast<const float*>(xs), nullptr, static_cast<float*>(pair_val),
      static_cast<int*>(pair_idx), st);
  if (err != cudaSuccess) return err;
  ff::argmax_reduce_kernel<<<M, 32, 0, st>>>(static_cast<const float*>(pair_val),
                                             static_cast<const int*>(pair_idx), n_tiles,
                                             static_cast<int*>(idx_out));
  return cudaGetLastError();
}

extern "C" int ff_w4a8_gemv_stacked(const void* x, const void* xs, const void* w,
                                    const void* mult_packed, const void* s_col, void* partial,
                                    void* out, int M, int K, int N, int L, int layer, int group,
                                    int n_pack, int n_split, int out_kind, void* stream) {
  (void)L;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* wl = static_cast<const int8_t*>(w) + (size_t)layer * (K / 2) * N;
  const int32_t* ml = static_cast<const int32_t*>(mult_packed) + (size_t)layer * n_pack * N;
  const float* sl = static_cast<const float*>(s_col) + (size_t)layer * N;
  cudaError_t err = ff::launch_gemv_partial<ff::kPaired, true>(
      static_cast<const int8_t*>(x), wl, ml, static_cast<int32_t*>(partial), M, K, N, group,
      n_split, st);
  if (err != cudaSuccess) return err;
  const int32_t* p = static_cast<const int32_t*>(partial);
  const float* xsf = static_cast<const float*>(xs);
  if (out_kind == 0)
    return ff::launch_gemv_epilogue<float, false>(p, n_split, M, N, sl, xsf,
                                                  static_cast<float*>(out), nullptr, nullptr, st);
  return ff::launch_gemv_epilogue<__nv_bfloat16, false>(
      p, n_split, M, N, sl, xsf, static_cast<__nv_bfloat16*>(out), nullptr, nullptr, st);
}
