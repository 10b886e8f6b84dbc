// W8A8 matmul on Hopper's int8 warpgroup tensor cores: int8 x int8 ->
// int32, one float epilogue. The decode's products and the prefill's GEMM
// are one kernel (int8_wgmma.cuh's block), planned by kernels/matmul.py
// w8a8_plan.
//
// Replaces: fastforward_tpu/kernels/matmul.py matmul_w8a8 (:95, kernel
// _w8a8_kernel :78, pallas_call :127; the JAX default path is XLA's int8
// dot, matmul_w8a8_reference :64).
//   y[m, n] = (float(sum_k x[m, k] * w[k, n]) * xs[m]) * ws[n]
// or, with a bias, the last product fused with the add (one rounding, as
// jitted XLA computes it). x (M, K) int8, xs (M,) f32, w (K, N) int8 with N
// contiguous (the at-rest layout), ws (N,) f32, bias (N,) f32 or NULL;
// y (M, N) f32 or bf16. The int32 sum is exact in any order and the
// epilogue rounds as matmul_w8a8_reference does: bit for bit. K % 16 == 0,
// N % 4 == 0.
//
// Bound on the H100. Decode (M = 192): a Llama-3-8B layer's four
// projections read 218 MB of int8 weights, 0.065 ms at 3.35 TB/s, against
// 8.4e10 int8 operations, 0.042 ms at 1,979 TOP/s: bytes. Prefill
// (M = 24,576): 1.07e13 operations a layer, 5.4 ms: operations.
//
// Design (int8_wgmma.cuh: out^T = w^T x^T, the weights transposed into
// wgmma's register operand, x by TMA):
// - Decode (M <= 192): every token row on wgmma's n side, m64nNk32 with n
//   = M rounded up to 8, 16, 32, 48, 64, 96, 128 or 192, so each weight
//   byte leaves device memory once a call (M = 193-256: two row tiles of
//   128; int8_wgmma.cuh kMaxRows says why not n = 256). Where the column
//   blocks fall short of the card, K splits over whole 128-k stages across
//   a cluster of up to 8 blocks, whose int32 partials are added through
//   distributed shared memory (exact in any order).
// - Prefill (M > 256): blocks of 128 weight columns x 192 token rows (two
//   consumer warpgroups of m64n192k32, 96 accumulators a thread), a TMA
//   ring of 128-k stages fed by the producer warp, the blocks visited in
//   groups of `group_m` row tiles, the row tile fastest: the group's x tiles
//   stay in L2 while it sweeps the weight panels, and the blocks in flight
//   share each panel.
// - Not the bound, measured: the x tile that every column tile reads again
//   from L2 (24 KB a stage beside 16 KB of weights at 192 rows). Two
//   adjacent column tiles sharing it by TMA multicast in a 2-block cluster
//   ran 3% slower at the prefill and the decode (PERF.md §6).
// - A stage's 128 weight rows give a thread 16 A registers (four
//   ldmatrix.x4.trans of 32 rows, two columns each); a consumer warpgroup
//   issues the stage's four k32 products (async), then waits for the
//   previous stage's, releases its slot and transposes the next stage's
//   rows into the registers those freed: two stages of products in flight.
// - The epilogue from the accumulators, or after the cluster's reduction:
//   __fmul_rn(__int2float_rn(acc), xs[m]), then __fmul_rn by ws[n], or
//   __fmaf_rn with bias[n]. The weights take the 4-byte cp.async feed where
//   N % 16 != 0 (same bits).

#include "int8_wgmma.cuh"

namespace ff {
namespace w8 {

using i8w::kBK;
using i8w::kBN;
using i8w::kConsumers;
using i8w::kRedPitch;
using i8w::kThreads;

constexpr int kWBytes = kBK * kBN;  // a stage's 128 weight rows: 16 KB

__host__ __device__ constexpr int stage_bytes(int nt) { return nt * kBK + kWBytes; }

// The ring, or the reduction tile (int32) where K is split, which reuses
// it; its barriers; the slack to align it to 1024 bytes.
inline size_t smem_bytes(int nt, int depth, int n_split) {
  const size_t ring = (size_t)depth * stage_bytes(nt);
  const size_t red = n_split > 1 ? (size_t)nt * kRedPitch * 4 : 0;
  return (ring > red ? ring : red) + (size_t)depth * 16 + 1024;
}

__device__ __forceinline__ float epilogue(int acc, float xm, float wn, float bn, bool has_bias) {
  const float t = __fmul_rn(__int2float_rn(acc), xm);
  return has_bias ? __fmaf_rn(t, wn, bn) : __fmul_rn(t, wn);
}

// A thread's A registers of one stage: f[t] those of k32 step t (columns
// cb, cb + 1 over k 32 t + 4 tid.., then 32 t + 16 + 4 tid..).
__device__ __forceinline__ void load_frags(const unsigned char* sw, const i8w::Lane& l,
                                           unsigned (&f)[4][4]) {
#pragma unroll
  for (int t = 0; t < 4; ++t) i8w::col_words(sw, l, 32 * t, f[t]);
}

// One stage of a consumer warpgroup: its four k32 products on `cur`
// (queued behind the previous stage's), the wait for the previous stage's,
// which frees `nxt` and its ring slot (one arrival a warpgroup), then the
// next stage's registers into `nxt` while this stage's products run.
template <int NT>
__device__ __forceinline__ void run_stage(unsigned char* smem, uint64_t* full, uint64_t* empty,
                                          int s, int stages, int depth, const i8w::Lane& l,
                                          int (&acc)[NT / 2], unsigned (&cur)[4][4],
                                          unsigned (&nxt)[4][4]) {
  constexpr int kStage = stage_bytes(NT);
  const unsigned xb = smem_u32(smem + (size_t)(s % depth) * kStage);
  w4g::wgmma_fence();
#pragma unroll
  for (int t = 0; t < 4; ++t) i8w::Mma<NT>::run(acc, cur[t], w4g::x_desc(xb + 32 * t), 1);
  w4g::wgmma_commit();
  w4g::wgmma_wait<1>();
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int r = 0; r < 4; ++r) w4g::fence_reg(nxt[t][r]);
  if (s > 0 && threadIdx.x % 128 == 0) mma8::mbar_arrive(empty + (s - 1) % depth);
  if (s + 1 < stages) {
    const int slot = (s + 1) % depth;
    mma8::mbar_wait_or_trap(full + slot, ((s + 1) / depth) & 1);
    load_frags(smem + (size_t)slot * kStage + NT * kBK, l, nxt);
  }
}

// Grid (n_split, m tiles * n tiles), clusters of (n_split, 1, 1); kThreads
// threads; dynamic shared memory smem_bytes(NT, depth, n_split). x_map: x
// (M, K) int8, boxes of 128 k x NT rows; w_map (when w_tma): w (K, N),
// boxes of kBN columns x kBK rows. Split z streams the stages [z sps,
// min(stages, (z + 1) sps)) of ceil(K / kBK).
template <int NT>
__global__ void __launch_bounds__(kThreads, NT <= 64 ? 2 : 1)
w8a8_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                  const __grid_constant__ CUtensorMap w_map, int w_tma,
                  const int8_t* __restrict__ w, const float* __restrict__ xs,
                  const float* __restrict__ ws, const float* __restrict__ bias,
                  void* __restrict__ out, int out_bf16, int M, int K, int N, int n_split,
                  int depth, int group_m) {
  constexpr int kXBytes = NT * kBK;
  constexpr int kStage = stage_bytes(NT);
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzle's 1024-byte period (smem_bytes asks for the slack)
  unsigned char* smem = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  const size_t ring = (size_t)depth * kStage;
  const size_t red_bytes = n_split > 1 ? (size_t)NT * kRedPitch * 4 : 0;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + (ring > red_bytes ? ring : red_bytes));
  uint64_t* empty = full + depth;
  // the block's tile: row tiles fastest within groups of group_m
  const int m_tiles = (M + NT - 1) / NT, n_tiles = (N + kBN - 1) / kBN;
  const int per_group = group_m * n_tiles, first = blockIdx.y / per_group * group_m;
  const int gm = min(group_m, m_tiles - first), local = blockIdx.y % per_group;
  const int m0 = (first + local % gm) * NT, n0 = local / gm * kBN;
  const int split = blockIdx.x;
  const int total = (K + kBK - 1) / kBK, sps = (total + n_split - 1) / n_split;
  const int s0 = split * sps, stages = min(total, s0 + sps) - s0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < depth; ++s) {
      // TMA: the producer's one arrival; else also its 32 lanes' cp.async ones
      mbar_init(full + s, w_tma ? 1 : 33);
      mbar_init(empty + s, kConsumers);
    }
    mma8::fence_barrier_init();
  }
  __syncthreads();

  const bool has_bias = bias != nullptr;
  if (warp == 4 * kConsumers) {
    // ---- the producer warp
    for (int s = 0; s < stages; ++s) {
      const int slot = s % depth, sg = s0 + s;
      if (s >= depth) mma8::mbar_wait_or_trap(empty + slot, ((s / depth) - 1) & 1);
      unsigned char* st = smem + (size_t)slot * kStage;
      if (lane == 0) {
        mma8::mbar_arrive_expect_tx(full + slot, kXBytes + (w_tma ? kWBytes : 0));
        mma8::tma_box(st, &x_map, sg * kBK, m0, full + slot);
        if (w_tma) mma8::tma_box(st + kXBytes, &w_map, n0, sg * kBK, full + slot);
      }
      if (!w_tma)
        i8w::copy_weight_rows(st + kXBytes, w, n0, N, sg * kBK, kBK, K, full + slot, lane);
    }
    if (!w_tma) mma8::cp_async_wait_all();
  } else {
    // ---- the consumer warpgroups: 64 weight columns each, the block's
    // token rows
    const int wg = warp / 4, gid = lane / 4, tid = lane % 4;
    const int cb = 64 * wg + 16 * (warp % 4) + 2 * gid;  // this thread's columns cb, cb + 1
    const i8w::Lane l = i8w::lane_of(cb, tid);
    int acc[NT / 2];
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) acc[i] = 0;
    unsigned f0[4][4], f1[4][4];
    mma8::mbar_wait_or_trap(full, 0);
    load_frags(smem + kXBytes, l, f0);
    for (int s = 0; s < stages; s += 2) {
      run_stage<NT>(smem, full, empty, s, stages, depth, l, acc, f0, f1);
      if (s + 1 < stages) run_stage<NT>(smem, full, empty, s + 1, stages, depth, l, acc, f1, f0);
    }
    w4g::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) i8w::fence_reg(acc[i]);
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        w4g::fence_reg(f0[t][r]);
        w4g::fence_reg(f1[t][r]);
      }
    // acc[4i + h] is column cb, acc[4i + 2 + h] column cb + 1, of token row
    // 8i + 2tid + h of the tile
    const int n = n0 + cb;
    if (n_split == 1 && n < N) {  // N % 4 == 0: cb even, so cb + 1 < N too
      const float w0 = ws[n], w1 = ws[n + 1];
      const float b0 = has_bias ? bias[n] : 0.f, b1 = has_bias ? bias[n + 1] : 0.f;
#pragma unroll
      for (int i = 0; i < NT / 8; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + 8 * i + 2 * tid + h;
          if (m >= M) continue;
          const float xm = xs[m];
          i8w::store2(out, (size_t)m * N + n, out_bf16,
                      epilogue(acc[4 * i + h], xm, w0, b0, has_bias),
                      epilogue(acc[4 * i + 2 + h], xm, w1, b1, has_bias));
        }
    } else if (n_split > 1) {
      i8w::consumers_sync();  // both warpgroups are past the ring
      int* red = reinterpret_cast<int*>(smem);  // [NT][kRedPitch]
#pragma unroll
      for (int i = 0; i < NT / 8; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<int2*>(red + (8 * i + 2 * tid + h) * kRedPitch + cb) =
              make_int2(acc[4 * i + h], acc[4 * i + 2 + h]);
    }
  }

  if (n_split > 1) {
    // ---- the cluster's reduction: block `split` sums token rows split,
    // split + n_split, ... of the tile over the cluster's blocks
    i8w::cluster_sync();
    const unsigned red_addr = smem_u32(smem);
    const int rows = min(NT, M - m0);
    const int mine = split < rows ? (rows - split + n_split - 1) / n_split : 0;
    for (int e = threadIdx.x; e < mine * (kBN / 4); e += kThreads) {
      const int r = split + e / (kBN / 4) * n_split, c4 = 4 * (e % (kBN / 4)), n = n0 + c4;
      if (n >= N) continue;  // N % 4 == 0
      const unsigned at = red_addr + (unsigned)(r * kRedPitch + c4) * 4u;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      for (int z = 0; z < n_split; ++z) {
        const uint4 o = i8w::ld_cluster(at, (unsigned)z);
        v = make_uint4(v.x + o.x, v.y + o.y, v.z + o.z, v.w + o.w);
      }
      const int m = m0 + r;
      const float xm = xs[m];
      const float4 wv = *reinterpret_cast<const float4*>(ws + n);
      const float4 bv = has_bias ? *reinterpret_cast<const float4*>(bias + n)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
      i8w::store4(out, (size_t)m * N + n, out_bf16,
                  make_float4(epilogue((int)v.x, xm, wv.x, bv.x, has_bias),
                              epilogue((int)v.y, xm, wv.y, bv.y, has_bias),
                              epilogue((int)v.z, xm, wv.z, bv.z, has_bias),
                              epilogue((int)v.w, xm, wv.w, bv.w, has_bias)));
    }
    i8w::cluster_sync();  // no block leaves while another reads its tile
  }
}

// Launch the product of (M, K) x (K, N) on nt-row tiles (wgmma's n), K
// split n_split ways over whole stages, a ring of `depth` stages, row tiles
// visited in groups of group_m (the plan of kernels/matmul.py w8a8_plan).
// x must admit a tensor map (16-byte aligned), and ws and bias 16-byte
// aligned where K is split; the weights take the cp.async feed where they
// admit no map.
cudaError_t launch(const void* x, const void* xs, const void* w, const void* ws,
                   const void* bias, void* out, int M, int K, int N, int out_bf16, int nt,
                   int n_split, int depth, int group_m, cudaStream_t st) {
  if (M < 1 || K < 16 || K % 16 != 0 || N < 4 || N % 4 != 0 || nt < 1 ||
      nt > i8w::kMaxRows || i8w::tile_n(nt) != nt || n_split < 1 || n_split > i8w::kMaxSplit ||
      group_m < 1)
    return cudaErrorInvalidValue;
  const int total = (K + kBK - 1) / kBK, sps = (total + n_split - 1) / n_split;
  // a stage's slot is released while the next stage is worked: two slots
  // unless a split streams one stage
  if (depth < (sps > 1 ? 2 : 1) || (n_split - 1) * sps >= total) return cudaErrorInvalidValue;
  if (n_split > 1 && (reinterpret_cast<uintptr_t>(ws) % 16 != 0 ||
                      reinterpret_cast<uintptr_t>(bias) % 16 != 0))
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(nt, depth, n_split);
  if (smem > 232448) return cudaErrorInvalidValue;
  CUtensorMap xm = {}, wm = {};
  if (!mma8::tensor_map(&xm, CU_TENSOR_MAP_DATA_TYPE_UINT8, x, K, M, K, kBK, nt,
                        CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  const int w_tma = mma8::tensor_map(&wm, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, N, K, N, kBN, kBK,
                                     CU_TENSOR_MAP_SWIZZLE_128B);
  const int tiles = ((M + nt - 1) / nt) * ((N + kBN - 1) / kBN);
  auto run = [&](auto kernel) -> cudaError_t {
    return i8w::launch_clusters(kernel, n_split, tiles, 1, smem, st, xm, wm, w_tma,
                                static_cast<const int8_t*>(w), static_cast<const float*>(xs),
                                static_cast<const float*>(ws), static_cast<const float*>(bias),
                                out, out_bf16, M, K, N, n_split, depth, group_m);
  };
  switch (nt) {
    case 8: return run(w8a8_wgmma_kernel<8>);
    case 16: return run(w8a8_wgmma_kernel<16>);
    case 32: return run(w8a8_wgmma_kernel<32>);
    case 48: return run(w8a8_wgmma_kernel<48>);
    case 64: return run(w8a8_wgmma_kernel<64>);
    case 96: return run(w8a8_wgmma_kernel<96>);
    case 128: return run(w8a8_wgmma_kernel<128>);
    default: return run(w8a8_wgmma_kernel<192>);
  }
}

}  // namespace w8
}  // namespace ff

// x (M, K) int8 (16-byte aligned), xs (M,) f32, w (K, N) int8, ws (N,) f32,
// bias (N,) f32 or NULL, out (M, N) f32 or bf16; nt (token rows a tile),
// n_split, depth and group_m from kernels/matmul.py w8a8_plan.
extern "C" int ff_w8a8_gemm(const void* x, const void* xs, const void* w, const void* ws,
                            const void* bias, void* out, int M, int K, int N, int out_bf16,
                            int nt, int n_split, int depth, int group_m, void* stream) {
  return ff::w8::launch(x, xs, w, ws, bias, out, M, K, N, out_bf16, nt, n_split, depth, group_m,
                        static_cast<cudaStream_t>(stream));
}
