// Weight-only int4 GEMV (FF_BENCH_MODE=w4a16): bf16 activations against
// packed int4 weights dequantized in registers, bf16 tensor cores.
//
// Replaces: fastforward_tpu/kernels/matmul.py matmul_w4_gemv (:262, kernel
// _w4_gemv_kernel :240), which matmul_w4a16 (:1832) takes up to 256 rows.
//   w[k, n] = bf16(float(v[k, n]) * s[k / g, n])        (one rounding)
//   y[m, n] = sum_k x[m, k] * w[k, n]                    (f32 accumulation)
// x (M, K) bf16, w (K/2, N) in pack_int4's group halves (byte row i of
// group p: k = pg + i low nibble, pg + g/2 + i high, two's complement), s
// (K/g, N) f32; y (M, N) f32 or bf16, rounded once. The dequant rounds as
// dequantize_int4's CPU path (the TPU kernel rounds the scale to bf16 and
// multiplies in bf16 instead, :256). The f32 sums run in the tensor cores'
// order, not a plain version's: held within a stated tolerance.
//
// Bound on the H100 at M = 192: a Llama-3-8B layer reads 109 MB of packed
// weights and 1.7 MB of scales (0.033 ms) and does 8.4e10 bf16 operations
// (0.085 ms at 989 TFLOP/s): operations. (An FMA loop on the CUDA cores at
// 67 TFLOP/s would take ~1.3 ms a layer.)
//
// Design: w4_tile.cuh's tile, a block of 64 rows x 128 columns (4 warps of
// 64 x 32). Every weight is dequantized once per 64-row tile.

#include "w4_tile.cuh"

// x (M, K) bf16, w (K/2, N) pack_int4, w_scale (K/g, N) f32, out (M, N)
// f32 or bf16; group 32, 64 or 128.
extern "C" int ff_w4_gemv(const void* x, const void* w, const void* w_scale, void* out, int M,
                          int K, int N, int group, int out_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    return ff::w4::launch_tile<__nv_bfloat16>(x, w, w_scale, out, M, K, N, group, st);
  return ff::w4::launch_tile<float>(x, w, w_scale, out, M, K, N, group, st);
}
