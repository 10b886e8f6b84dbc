// W8A8 matmul: int8 x int8 -> int32 on the tensor cores, one float epilogue.
//
// Replaces: fastforward_tpu/kernels/matmul.py matmul_w8a8 (:95, kernel
// _w8a8_kernel :78; the JAX default path is XLA's int8 dot,
// matmul_w8a8_reference :64).
//   y[m, n] = (float(sum_k x[m, k] * w[k, n]) * xs[m]) * ws[n]
// or, with a bias, the last product fused with the add (one rounding, as
// jitted XLA computes it). x (M, K) int8, xs (M,) f32, w (K, N) int8 with N
// contiguous (the at-rest layout), ws (N,) f32, bias (N,) f32 or NULL;
// y (M, N) f32 or bf16. The int32 sum is exact and the epilogue rounds as
// matmul_w8a8_reference does: bit for bit. K % 16 == 0, N % 4 == 0.
//
// Bound on the H100. Decode (M = 192): a Llama-3-8B layer's four
// projections read 218 MB of int8 weights, 0.065 ms at 3.35 TB/s, against
// 8.4e10 int8 operations, 0.042 ms at 1,979 TOP/s: bytes. Prefill
// (M = 24,576): 1.07e13 operations a layer, 5.4 ms: operations.
//
// Design: 128 x 128 output tiles, 8 warps of 64 x 32, k steps of 64
// staged by cp.async into two buffers, mma.sync m16n8k32 s8. The weight's
// N-contiguous rows do not fit the mma's column-major B operand (4
// consecutive k of one column per register): a lane reads one 4-byte word
// (4 adjacent columns) from each of 4 rows and transposes the 4 x 4 bytes
// in registers, which gives it the B registers of its 4 n8 tiles at once
// (mma.cuh's column permutation); the at-rest layout stays as it is.
// Tiles are visited in groups of 16 row tiles per column tile, so that the
// blocks in flight share weight and activation tiles in L2.

#include "mma.cuh"

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 64;
constexpr int kThreads = 256;          // 8 warps: 2 (rows) x 4 (columns)
constexpr int kPitchA = kBK + 16;      // bytes: conflict-free A fragment loads
constexpr int kPitchB = kBN + 16;
constexpr int kGroupM = 16;            // row tiles per column tile in visiting order

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
w8a8_kernel(const int8_t* __restrict__ x, const float* __restrict__ xs,
            const int8_t* __restrict__ w, const float* __restrict__ ws,
            const float* __restrict__ bias, OutT* __restrict__ out, int M, int K, int N,
            bool vec16) {
  __shared__ __align__(16) int8_t sa[2][kBM * kPitchA];
  __shared__ __align__(16) int8_t sb[2][kBK * kPitchB];

  const int tiles_m = (M + kBM - 1) / kBM, tiles_n = (N + kBN - 1) / kBN;
  const int per_group = kGroupM * tiles_n;
  const int first_m = (blockIdx.x / per_group) * kGroupM;
  const int gsize = min(tiles_m - first_m, kGroupM);
  const int in_group = blockIdx.x % per_group;
  const int m0 = (first_m + in_group % gsize) * kBM, n0 = (in_group / gsize) * kBN;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int gid = lane / 4, tid = lane % 4;

  auto load = [&](int stage, int k0) {
    for (int i = threadIdx.x; i < kBM * kBK / 16; i += kThreads) {
      const int r = i / (kBK / 16), c = (i % (kBK / 16)) * 16;
      const bool ok = m0 + r < M && k0 + c < K;
      ff::cp_async<16>(&sa[stage][r * kPitchA + c], ok ? x + (size_t)(m0 + r) * K + k0 + c : x,
                       ok);
    }
    if (vec16) {  // N % 16 == 0
      for (int i = threadIdx.x; i < kBK * kBN / 16; i += kThreads) {
        const int r = i / (kBN / 16), c = (i % (kBN / 16)) * 16;
        const bool ok = k0 + r < K && n0 + c < N;
        ff::cp_async<16>(&sb[stage][r * kPitchB + c], ok ? w + (size_t)(k0 + r) * N + n0 + c : w,
                         ok);
      }
    } else {
      for (int i = threadIdx.x; i < kBK * kBN / 4; i += kThreads) {
        const int r = i / (kBN / 4), c = (i % (kBN / 4)) * 4;
        const bool ok = k0 + r < K && n0 + c < N;
        ff::cp_async<4>(&sb[stage][r * kPitchB + c], ok ? w + (size_t)(k0 + r) * N + n0 + c : w,
                        ok);
      }
    }
    ff::cp_async_commit();
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  const int n_k = (K + kBK - 1) / kBK;
  load(0, 0);
  for (int kt = 0; kt < n_k; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < n_k) {
      load(st ^ 1, (kt + 1) * kBK);
      ff::cp_async_wait<1>();
    } else {
      ff::cp_async_wait<0>();
    }
    __syncthreads();
    const int8_t* ta = sa[st] + wm * 64 * kPitchA;
    const int8_t* tb = sb[st] + wn * 32 + 4 * gid;
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      unsigned a[4][4], b0[4], b1[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ff::load_a_s8(a[i], ta + i * 16 * kPitchA + ks, kPitchA, lane);
      ff::load_b_s8(b0, tb + (ks + 4 * tid) * kPitchB, kPitchB);
      ff::load_b_s8(b1, tb + (ks + 16 + 4 * tid) * kPitchB, kPitchB);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) ff::mma_s8(acc[i][j], a[i], b0[j], b1[j]);
    }
    __syncthreads();
  }

  // Epilogue: a lane holds rows gid, gid + 8 of each m16 tile at the 8
  // adjacent columns nb..nb+7.
  const int nb = n0 + wn * 32 + 8 * tid;
  float wsv[8], bv[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    wsv[c] = nb + c < N ? ws[nb + c] : 0.f;
    bv[c] = bias != nullptr && nb + c < N ? bias[nb + c] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 64 + i * 16 + gid + 8 * h;
      if (m >= M) continue;
      const float xm = xs[m];
      float v[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float t = __fmul_rn(__int2float_rn(acc[i][c % 4][2 * h + c / 4]), xm);
        v[c] = bias != nullptr ? __fmaf_rn(t, wsv[c], bv[c]) : __fmul_rn(t, wsv[c]);
      }
      ff::store8(out + (size_t)m * N, nb, N, v);
    }
  }
}

template <typename OutT>
int launch(const void* x, const void* xs, const void* w, const void* ws, const void* bias,
           void* out, int M, int K, int N, cudaStream_t st) {
  const int tiles = ((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  w8a8_kernel<OutT><<<tiles, kThreads, 0, st>>>(
      static_cast<const int8_t*>(x), static_cast<const float*>(xs), static_cast<const int8_t*>(w),
      static_cast<const float*>(ws), static_cast<const float*>(bias), static_cast<OutT*>(out), M, K,
      N, N % 16 == 0);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ff_w8a8_gemm(const void* x, const void* xs, const void* w, const void* ws,
                            const void* bias, void* out, int M, int K, int N, int out_bf16,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_bf16) return launch<__nv_bfloat16>(x, xs, w, ws, bias, out, M, K, N, st);
  return launch<float>(x, xs, w, ws, bias, out, M, K, N, st);
}
