// The bf16 tensor-core tile of the port's W4 GEMV (w4_gemv.cu): bf16
// activations against packed int4 weights dequantized in registers.
//
//   w[k, n] = bf16(float(v[k, n]) * s[k / g, n])       (one rounding)
//   y[m, n] = sum_k x[m, k] * w[k, n]                  (f32 accumulation)
// x (M, K) bf16, w (K/2, N) in pack_int4's group halves (byte row i of
// group p: k = pg + i low nibble, pg + g/2 + i high, two's complement), s
// (K/g, N) f32. y (M, N) f32 or bf16, rounded once.
//
// A block owns 64 rows x 128 columns: 4 warps, each 64 rows x 32 columns,
// and walks K one group at a time, the group's activations, packed rows
// and scales staged by cp.async, two groups in flight. A lane dequantizes
// the weights of its own B fragments straight from the packed bytes in
// shared memory: one 4-byte word of a byte row holds its 4 columns
// (mma.cuh's column permutation), a pair of rows gives the bf16 pair of a
// B register, and the low nibbles of a row feed the k-step at k < g/2, its
// high nibbles the one at k >= g/2. Every weight is dequantized once per
// 64-row tile.

#pragma once

#include "mma.cuh"

namespace ff {
namespace w4 {

constexpr int kBN = 128;

template <int GROUP>
struct Smem {
  static constexpr int kBM = 64;
  static constexpr int kThreads = 128;
  static constexpr int kPA = GROUP + 8;   // bf16 elements: conflict-free A fragments
  static constexpr int kPB = kBN + 16;    // bytes
  static constexpr int kA = kBM * kPA * 2, kB = GROUP / 2 * kPB, kS = kBN * 4;
  static constexpr int kStage = kA + kB + kS;  // bytes, a multiple of 16
};

__device__ __forceinline__ float nib_lo(unsigned word, int j) {
  return static_cast<float>(static_cast<int>(((word >> (8 * j)) & 0xFu) ^ 8u) - 8);
}

__device__ __forceinline__ float nib_hi(unsigned word, int j) {
  return static_cast<float>(static_cast<int>(static_cast<int8_t>(word >> (8 * j))) >> 4);
}

// Grid: (ceil(M / 64), ceil(N / 128)); dynamic shared memory 2 stages.
template <int GROUP, typename OutT>
__global__ void __launch_bounds__(128)
tile_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
            const float* __restrict__ s, OutT* __restrict__ out, int M, int K, int N, bool vec16) {
  using L = Smem<GROUP>;
  constexpr int kHalf = GROUP / 2;
  extern __shared__ __align__(16) unsigned char smem[];
  auto sa = [&](int st) { return reinterpret_cast<__nv_bfloat16*>(smem + st * L::kStage); };
  auto sb = [&](int st) { return reinterpret_cast<int8_t*>(smem + st * L::kStage + L::kA); };
  auto ss = [&](int st) {
    return reinterpret_cast<float*>(smem + st * L::kStage + L::kA + L::kB);
  };

  const int m0 = blockIdx.x * L::kBM, n0 = blockIdx.y * kBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wn = warp;  // the warp's 32 columns (every row of the tile)
  const int gid = lane / 4, tid = lane % 4;
  const int n_groups = K / GROUP;

  auto load = [&](int stage, int g) {
    __nv_bfloat16* a = sa(stage);
    for (int i = threadIdx.x; i < L::kBM * GROUP / 8; i += L::kThreads) {
      const int r = i / (GROUP / 8), c = (i % (GROUP / 8)) * 8;
      const bool ok = m0 + r < M;
      ff::cp_async<16>(a + r * L::kPA + c, ok ? x + (size_t)(m0 + r) * K + g * GROUP + c : x, ok);
    }
    int8_t* b = sb(stage);
    const int8_t* wg = w + (size_t)g * kHalf * N;
    if (vec16) {  // N % 16 == 0
      for (int i = threadIdx.x; i < kHalf * kBN / 16; i += L::kThreads) {
        const int r = i / (kBN / 16), c = (i % (kBN / 16)) * 16;
        const bool ok = n0 + c < N;
        ff::cp_async<16>(b + r * L::kPB + c, ok ? wg + (size_t)r * N + n0 + c : w, ok);
      }
    } else {
      for (int i = threadIdx.x; i < kHalf * kBN / 4; i += L::kThreads) {
        const int r = i / (kBN / 4), c = (i % (kBN / 4)) * 4;
        const bool ok = n0 + c < N;
        ff::cp_async<4>(b + r * L::kPB + c, ok ? wg + (size_t)r * N + n0 + c : w, ok);
      }
    }
    if (threadIdx.x < kBN / 4) {  // N % 4 == 0: a chunk is in range or out whole
      const int c = 4 * threadIdx.x;
      const bool ok = n0 + c < N;
      ff::cp_async<16>(ss(stage) + c, ok ? s + (size_t)g * N + n0 + c : s, ok);
    }
    ff::cp_async_commit();
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

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
    const __nv_bfloat16* ta = sa(st);
    const int8_t* tb = sb(st) + wn * 32 + 4 * gid;
    const float4 s4 = *reinterpret_cast<const float4*>(ss(st) + wn * 32 + 4 * gid);
    const float sc[4] = {s4.x, s4.y, s4.z, s4.w};
    // byte rows 16rs..16rs+15: low nibbles are the k-step at k = 16rs, high
    // nibbles the one at k = g/2 + 16rs. B register 0 of a step holds k =
    // 2tid, 2tid + 1, register 1 k = 8 + 2tid, 9 + 2tid.
#pragma unroll
    for (int rs = 0; rs < kHalf / 16; ++rs) {
      unsigned wd[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = 16 * rs + 8 * (q / 2) + 2 * tid + q % 2;
        wd[q] = *reinterpret_cast<const unsigned*>(tb + row * L::kPB);
      }
      unsigned bl[4][2], bh[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          bl[j][h] = ff::pack_bf16x2(__fmul_rn(nib_lo(wd[2 * h], j), sc[j]),
                                     __fmul_rn(nib_lo(wd[2 * h + 1], j), sc[j]));
          bh[j][h] = ff::pack_bf16x2(__fmul_rn(nib_hi(wd[2 * h], j), sc[j]),
                                     __fmul_rn(nib_hi(wd[2 * h + 1], j), sc[j]));
        }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        unsigned al[4], ah[4];
        ff::load_a_bf16(al, ta + i * 16 * L::kPA + 16 * rs, L::kPA, lane);
        ff::load_a_bf16(ah, ta + i * 16 * L::kPA + kHalf + 16 * rs, L::kPA, lane);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          ff::mma_bf16(acc[i][j], al, bl[j][0], bl[j][1]);
          ff::mma_bf16(acc[i][j], ah, bh[j][0], bh[j][1]);
        }
      }
    }
    __syncthreads();
  }

  const int nb = n0 + wn * 32 + 8 * tid;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + i * 16 + gid + 8 * h;
      if (m >= M) continue;
      float v[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) v[c] = acc[i][c % 4][2 * h + c / 4];
      ff::store8(out + (size_t)m * N, nb, N, v);
    }
  }
}

// Launch the tile on a (M, K) x (K/2, N) product; group 32, 64 or 128.
template <typename OutT>
int launch_tile(const void* x, const void* w, const void* s, void* out, int M, int K, int N,
                int group, cudaStream_t st) {
  auto run = [&](auto kernel, int bytes) -> int {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    const dim3 grid((M + 63) / 64, (N + kBN - 1) / kBN);
    kernel<<<grid, 128, bytes, st>>>(static_cast<const __nv_bfloat16*>(x),
                                     static_cast<const int8_t*>(w), static_cast<const float*>(s),
                                     static_cast<OutT*>(out), M, K, N, N % 16 == 0);
    return cudaGetLastError();
  };
  switch (group) {
    case 32:
      return run(tile_kernel<32, OutT>, 2 * Smem<32>::kStage);
    case 64:
      return run(tile_kernel<64, OutT>, 2 * Smem<64>::kStage);
    case 128:
      return run(tile_kernel<128, OutT>, 2 * Smem<128>::kStage);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace w4
}  // namespace ff
