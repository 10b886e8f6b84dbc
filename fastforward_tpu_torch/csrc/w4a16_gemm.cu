// The tiled W4A16 body: a fused dequant-GEMM of bf16 activations against
// packed int4 weights, off the serving route.
//
// Replaces: fastforward_tpu/kernels/matmul.py _w4a16_kernel (:1813), the
// body of matmul_w4a16's pallas_call (:1866). No caller of the JAX package
// reaches it (matmul_w4a16 returns at :1860), and its rounding differs
// from the route that serves w4a16, so the port's matmul_w4a16 keeps the
// JAX routing and this kernel is a callable of its own (matmul_w4a16_tiled).
//   w[k, n] = bf16(bf16(v[k, n]) * bf16(s[k / g, n]))   (two roundings)
//   y[m, n] = sum_k bf16(x[m, k]) * w[k, n]             (f32 accumulation)
//   out     = round(y), then round(float(out) + bias[n]) with a bias
// x (M, K) bf16, w (K/2, N) in pack_int4's group halves, s (K/g, N) f32,
// bias (N,) f32 or null; out (M, N) f32 or bf16. The TPU body adds one f32
// dot per group to its accumulator; here the tensor cores' f32 sums run
// over the k-steps of every group in turn: held within a stated tolerance.
//
// Bound on the H100 at bench.py's w4a16 prefill (M = 24,576 rows, a
// Llama-3-8B layer's four fused projections, g128): 2 M K N = 1.07e13 bf16
// operations (10.8 ms at 989 TFLOP/s) against 3.5 GB of activations,
// weights and bf16 outputs (1.06 ms at 3.35 TB/s): operations. Only wgmma
// reaches the card's full bf16 rate.
//
// Design: w4_wgmma.cuh. Every group the reference takes runs on it: at
// groups other than 32, 64, 128 and 128 j, x is first permuted into
// byte-row order (w4_wgmma.cuh permute_x) and each byte row dequantized
// with its own group's scale. A TMA ring fed by one producer warp, the weights
// dequantized once a 128 x 128 block in bf16x2 straight into the register
// A fragments of two consumer warpgroups, wgmma.m64n128k16 against x in
// shared memory (the transposed product), the bias in the epilogue. No
// bf16 weight is written anywhere (the route it would replace writes the
// whole bf16 weight to device memory, then reads it in cuBLAS).

#include "w4_wgmma.cuh"

// x (M, K) bf16 (16-byte aligned), w (K/2, N) pack_int4, w_scale (K/g, N)
// f32 (16-byte aligned), bias (N,) f32 or null, out (M, N) f32 or bf16; any
// group the reference takes (g even, K a whole number of groups). xp: (M,
// w4g::perm_cols(K)) bf16 scratch, 16-byte aligned, where w4g::group_ok does
// not take the group (x is permuted into it first); else null.
extern "C" int ff_w4a16_gemm(const void* x, const void* w, const void* w_scale, const void* bias,
                             void* out, void* xp, int M, int K, int N, int group, int out_bf16,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    return ff::w4g::launch<__nv_bfloat16>(x, w, w_scale, bias, out, xp, M, K, N, group, st);
  return ff::w4g::launch<float>(x, w, w_scale, bias, out, xp, M, K, N, group, st);
}
