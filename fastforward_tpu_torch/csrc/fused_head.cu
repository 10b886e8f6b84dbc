// Fused layer heads: input RMSNorm + dynamic row quantization + the
// two-level qkv GEMV, in one call.
//
// Replaces: fastforward_tpu/kernels/matmul.py fused_norm_qkv_stacked (:2615,
// body _fused_norm_qkv_kernel :2436; oracle fused_norm_qkv_reference :2471)
// and fused_norm_qkv_stacked_a4 (:2539, body :2485; oracle :2527). Per row m:
//   inv   = rsqrt(mean(x^2) + eps)                 f32, x bf16
//   h     = (x * inv) * w_norm                      f32 (no bf16 rounding)
//   s     = max(amax|h| * (1/127), 1e-8)            (A4: 1/7)
//   hq    = clamp(rint(h / s), -128, 127)           (A4: [-8, 7])
//   out   = (float(sum_g m_g * (hq_g . v_g)) * s_col) * s
// on layer `layer` of stacked weights (L, K/2, N): paired offset-binary
// nibbles for the W4A8 head, the vertical two's-complement layout for the
// A4 head; multipliers nibble-packed (L, ceil(K/g/8), N); column scales
// (L, N).
//
// Bound on the H100, Llama-3-8B (K = 4096, N = 6144): 12.6 MB of packed
// weights, ~0.1 MB of multipliers and scales, ~1.6 MB of activations and
// output at M = 192 (4.3 us at 3.35 TB/s), against 2 * M * K * N = 9.7 GOP
// (4.9 us at the int8 tensor-core rate): about balanced at M = 192,
// bandwidth-bound below.
//
// Design. The TPU kernel computed the norm and quantization at grid step
// 0 into VMEM scratch and carried it across its sequential grid over N.
// On Hopper the GEMV's blocks run in no order, so the prologue runs first,
// as its own small kernel (one block per row: the row's sum of squares,
// the amax, then hq and s written to a scratch the wrapper allocates, 4 KB
// a row). The prologue also writes its quantized row straight into the
// product's staged operand, in fragment order (w4a8_mma.cuh stage_row,
// stage_x_kernel's order), so the product needs no staging launch. Both
// products are then w4a8_mma.cuh's int8 tensor-core tile on that operand
// (launch_staged), with its split-K partials (planned by
// kernels/matmul.py mma_plan) and its epilogue: the W4A8 head's on the
// paired layout, row 9's call (w4a8_gemv.cu stacked_tile); the A4 head's
// on the vertical layout, row 1's (a4_gemv.cu). The norm's inputs stay
// out of any PyTorch op: no bf16 rounding of h and no round trip through
// the framework between the two. The int32 sums are exact in any order
// and the epilogue is (float(acc) * s_col) * s, as the plain version's.
// Groups the tile does not take (W4A8 g % 4 != 0, A4 g % 8 != 0, N % 4 !=
// 0: kernels/matmul.py two_level_route) run the same prologue without the
// staging, then w4a8_mma.cuh's any-group route on hq (launch_rows: its
// own staging launch, byte rows in memory order; ff_fused_norm_qkv_any,
// ff_fused_norm_qkv_a4_any, planned by kernels/matmul.py rows_plan): the
// same integers and epilogue.
//
// Numerics, bit-exact against the plain version: the squares are summed in
// the order XLA's CPU compiler uses for a row reduction (windows of 32 in
// order from +0, the row padded with zeros to a multiple of 32 with the
// smaller half of the padding in front, then the window sums the same way),
// the mean is the sum times float32(1/K) (given by the wrapper), rsqrt is
// the correctly rounded __frsqrt_rn, every other step an IEEE
// round-to-nearest operation; amax is exact in any order.

#include "w4a8_mma.cuh"  // the tile, stage_row (with common.cuh)

namespace {

// Sum of the n floats at `src` (shared memory, overwritten) in XLA's CPU
// order; `tmp` holds ceil(n/32) floats. Every thread of the block returns
// the sum. Skipping the padding equals adding its zeros: the running sum
// starts at +0 and never becomes -0.
__device__ float window_sum(float* src, float* tmp, int n, float* total) {
  while (n > 32) {
    const int nw = (n + 31) / 32, lo = (nw * 32 - n) / 2;
    for (int w = threadIdx.x; w < nw; w += blockDim.x) {
      float acc = 0.f;
      for (int i = 0; i < 32; ++i) {
        const int p = w * 32 + i - lo;
        if (p >= 0 && p < n) acc = __fadd_rn(acc, src[p]);
      }
      tmp[w] = acc;
    }
    __syncthreads();
    float* t = src;
    src = tmp;
    tmp = t;
    n = nw;
  }
  if (threadIdx.x == 0) {
    float acc = 0.f;
    for (int i = 0; i < n; ++i) acc = __fadd_rn(acc, src[i]);
    *total = acc;
  }
  __syncthreads();
  return *total;
}

// One block per row m of the staged rows (whole m tiles of the tile's plan
// at M rows: a block past M writes its row of zeros into xf; xf NULL: M
// blocks, no staging). Dynamic shared memory: (K + ceil(K/32)) floats and
// K bytes.
template <bool A4>
__global__ void __launch_bounds__(ff::kThreads)
norm_quant_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ norm_w,
                  int8_t* __restrict__ hq, float* __restrict__ hs, int8_t* __restrict__ xf,
                  int M, int K, int group, int n_split, float inv_k, float eps) {
  constexpr int kLayout = A4 ? ff::kVertical : ff::kPaired;
  extern __shared__ __align__(16) float sh[];
  __shared__ float red[ff::kWarps];
  __shared__ float total;
  const int m = blockIdx.x, mt = ff::mma8::tiles_of(M);
  if (m >= M) {
    if (xf) ff::mma8::stage_row<kLayout>(nullptr, xf, m, K, group, n_split, mt);
    return;
  }
  float* sq = sh;
  float* tmp = sh + K;
  int8_t* qs = reinterpret_cast<int8_t*>(sh + K + (K + 31) / 32);  // the quantized row
  const __nv_bfloat16* xr = x + (size_t)m * K;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const float v = __bfloat162float(xr[k]);
    sq[k] = __fmul_rn(v, v);
  }
  __syncthreads();
  const float ms = __fmul_rn(window_sum(sq, tmp, K, &total), inv_k);
  const float inv = __frsqrt_rn(__fadd_rn(ms, eps));

  // h into shared memory (the squares are no longer needed) and amax |h|
  float mx = 0.f;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const float h = __fmul_rn(__fmul_rn(__bfloat162float(xr[k]), inv),
                              __bfloat162float(norm_w[k]));
    sh[k] = h;
    mx = fmaxf(mx, fabsf(h));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = mx;
  __syncthreads();
  mx = red[0];
  for (int w = 1; w < ff::kWarps; ++w) mx = fmaxf(mx, red[w]);

  const float qmax = A4 ? 7.f : 127.f, qmin = A4 ? -8.f : -128.f;
  const float s = fmaxf(__fmul_rn(mx, A4 ? 1.0f / 7.0f : 1.0f / 127.0f), 1e-8f);
  if (threadIdx.x == 0) hs[m] = s;
  int8_t* qr = hq + (size_t)m * K;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const int8_t q = static_cast<int8_t>(
        static_cast<int>(fminf(fmaxf(rintf(__fdiv_rn(sh[k], s)), qmin), qmax)));
    qr[k] = q;
    qs[k] = q;
  }
  if (!xf) return;
  __syncthreads();
  ff::mma8::stage_row<kLayout>(qs, xf, m, K, group, n_split, mt);
}

// The prologue: hq (M, K), hs (M,) and the staged operand xf from x and
// layer `layer`'s norm; then the tile on xf. `any`: the prologue without
// the staging, then the any-group route on hq (which stages hq into xf).
template <bool A4>
cudaError_t fused_head(bool any, const void* x, const void* norm_w, const void* w,
                       const void* mult_packed, const void* s_col, void* hq, void* hs, void* xf,
                       void* partial, void* out, int M, int K, int N, int layer, int group,
                       int n_pack, int n_split, int depth, float inv_k, float eps, int out_bf16,
                       cudaStream_t st) {
  constexpr int kLayout = A4 ? ff::kVertical : ff::kPaired;
  if (xf == nullptr || group < 1 || (!any && (group < 4 || group % (A4 ? 8 : 4) != 0)) ||
      K % (A4 ? group : 2 * group) != 0 || n_pack * 8 < K / group || M < 1 || N < 1)
    return cudaErrorInvalidValue;
  cudaError_t err =
      any ? cudaSuccess
          : ff::mma8::check_launch<kLayout, false>(M, K, N, group, n_split, depth,
                                                    static_cast<const int32_t*>(partial), nullptr,
                                                    nullptr);
  if (err != cudaSuccess) return err;
  const size_t smem = sizeof(float) * ((size_t)K + (K + 31) / 32) + K;
  err = cudaFuncSetAttribute(norm_quant_kernel<A4>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  norm_quant_kernel<A4><<<any ? M : ff::mma8::staged_rows(M), ff::kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(norm_w) + (size_t)layer * K, static_cast<int8_t*>(hq),
      static_cast<float*>(hs), any ? nullptr : static_cast<int8_t*>(xf), M, K, group, n_split,
      inv_k, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int8_t* wl = static_cast<const int8_t*>(w) + (size_t)layer * (K / 2) * N;
  const int32_t* ml = static_cast<const int32_t*>(mult_packed) + (size_t)layer * n_pack * N;
  const float* sl = static_cast<const float*>(s_col) + (size_t)layer * N;
  if (any)
    return ff::mma8::launch_rows<kLayout, true>(
        static_cast<const int8_t*>(hq), static_cast<const float*>(hs), wl, ml, sl,
        static_cast<int8_t*>(xf), static_cast<int32_t*>(partial), out, out_bf16, M, K, N, group,
        n_split, 0, depth, st);
  return ff::mma8::launch_staged<kLayout, true>(
      static_cast<const float*>(hs), wl, ml, sl, static_cast<const int8_t*>(xf),
      static_cast<int32_t*>(partial), out, out_bf16, M, K, N, group, n_split, 0, depth, st);
}

}  // namespace

// x (M, K) bf16; norm_w (L, K) bf16; w (L, K/2, N) int8 (paired layout);
// mult_packed (L, n_pack, N) int32; s_col (L, N) f32; scratch hq (M, K)
// int8, hs (M,) f32, xf the staged activations (mma_plan's x_bytes),
// partial (n_split, M, N) int32 or NULL for one split; out (M, N) bf16 or
// f32. inv_k is float32(1/K); depth the ring's stages.
extern "C" int ff_fused_norm_qkv(const void* x, const void* norm_w, const void* w,
                                 const void* mult_packed, const void* s_col, void* hq, void* hs,
                                 void* xf, void* partial, void* out, int M, int K, int N,
                                 int layer, int group, int n_pack, int n_split, int depth,
                                 float inv_k, float eps, int out_bf16, void* stream) {
  return fused_head<false>(false, x, norm_w, w, mult_packed, s_col, hq, hs, xf, partial, out, M,
                           K, N, layer, group, n_pack, n_split, depth, inv_k, eps, out_bf16,
                           static_cast<cudaStream_t>(stream));
}

// As ff_fused_norm_qkv on the vertical layout (int4 activations).
extern "C" int ff_fused_norm_qkv_a4(const void* x, const void* norm_w, const void* w,
                                    const void* mult_packed, const void* s_col, void* hq,
                                    void* hs, void* xf, void* partial, void* out, int M, int K,
                                    int N, int layer, int group, int n_pack, int n_split,
                                    int depth, float inv_k, float eps, int out_bf16,
                                    void* stream) {
  return fused_head<true>(false, x, norm_w, w, mult_packed, s_col, hq, hs, xf, partial, out, M,
                          K, N, layer, group, n_pack, n_split, depth, inv_k, eps, out_bf16,
                          static_cast<cudaStream_t>(stream));
}

// The two heads at the groups the tile does not take: the same arguments,
// xf sized and n_split, depth planned by kernels/matmul.py rows_plan.
extern "C" int ff_fused_norm_qkv_any(const void* x, const void* norm_w, const void* w,
                                     const void* mult_packed, const void* s_col, void* hq,
                                     void* hs, void* xf, void* partial, void* out, int M, int K,
                                     int N, int layer, int group, int n_pack, int n_split,
                                     int depth, float inv_k, float eps, int out_bf16,
                                     void* stream) {
  return fused_head<false>(true, x, norm_w, w, mult_packed, s_col, hq, hs, xf, partial, out, M,
                           K, N, layer, group, n_pack, n_split, depth, inv_k, eps, out_bf16,
                           static_cast<cudaStream_t>(stream));
}

extern "C" int ff_fused_norm_qkv_a4_any(const void* x, const void* norm_w, const void* w,
                                        const void* mult_packed, const void* s_col, void* hq,
                                        void* hs, void* xf, void* partial, void* out, int M,
                                        int K, int N, int layer, int group, int n_pack,
                                        int n_split, int depth, float inv_k, float eps,
                                        int out_bf16, void* stream) {
  return fused_head<true>(true, x, norm_w, w, mult_packed, s_col, hq, hs, xf, partial, out, M,
                          K, N, layer, group, n_pack, n_split, depth, inv_k, eps, out_bf16,
                          static_cast<cudaStream_t>(stream));
}
