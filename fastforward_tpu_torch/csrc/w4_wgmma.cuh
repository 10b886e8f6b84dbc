// The tiled W4A16 GEMM on Hopper's warpgroup tensor cores (w4a16_gemm.cu):
// bf16 activations against packed int4 weights, the weights dequantized
// once a block in bf16x2 and fed to wgmma from registers.
//
//   w[k, n] = bf16(bf16(v[k, n]) * bf16(s[k / g, n]))   (two roundings)
//   y[m, n] = sum_k x[m, k] * w[k, n]                    (f32 accumulation)
//   out     = round(y); with a bias round(float(round(y)) + bias[n])
// x (M, K) bf16, w (K/2, N) in pack_int4's group halves (byte row i of
// group p: k = pg + i low nibble, pg + g/2 + i high, two's complement), s
// (K/g, N) f32, bias (N,) f32 or null; out (M, N) f32 or bf16; g 32, 64 or
// 128, or a multiple of 128 from 256 up to K.
//
// Design:
// - The transposed product. wgmma takes its A operand from registers and
//   its B operand from shared memory, so the block computes out^T = w^T
//   x^T: the weights, which the block must convert anyway, are A (64
//   weight columns a consumer warpgroup, dequantized straight into the A
//   fragments: no bf16 weight is ever written to shared memory), and x is
//   B, K-major, which is x's own row-major layout as TMA lands it with the
//   128B swizzle (m64n128k16: the 128 token rows of the block).
// - A block owns 128 token rows x 128 weight columns: two consumer
//   warpgroups of 64 columns each, and one producer warp. Each weight is
//   dequantized once a block. The blocks come in groups of `group_m` m
//   tiles, m the fastest index within a group: the group's x tiles stay in
//   L2 while it sweeps every weight panel, and a panel meets the group's
//   blocks in L2 side by side.
// - The feed: the producer warp keeps a ring of kDepth stages in flight,
//   each with a full and an empty mbarrier. A stage holds 128 k: the x tile
//   as two 2-D TMA boxes (64 k x 128 rows each, 128B-swizzled), the 64
//   packed byte rows of those k (one box of 128 columns, 128B-swizzled) and
//   the 128 / g scale rows (one box). A group of g = 128 j (j >= 2) spans j
//   stages: stage c of group p holds byte rows pg/2 + 64c.., whose low
//   nibbles are k = pg + 64c.. and high nibbles k = pg + g/2 + 64c.., so
//   its two x boxes are those two 64-k runs and its one scale row is p's;
//   the consumers then read the stage as at g 128. Where the weights' row
//   pitch N is not
//   a multiple of 16 bytes, the producer's lanes copy their 4-byte words by
//   cp.async to the swizzled places instead and arrive on the full barrier
//   when they land. Rows and columns past the tensors arrive as zeros.
// - Dequant in bf16x2, exactly. A thread's two A rows are adjacent weight
//   columns, so one 16-bit load of a byte row gives both. Two rows' bytes
//   of one column go to bytes 0 and 2 of a word (one byte permute); then
//   (p & 0x000F000F) ^ 0x43084308 (the high nibbles after a shift by 4)
//   is the bf16 pair 128 + u, u = v + 8 (offset binary); subtracting 136
//   gives v exactly, and one mul.rn.bf16x2 by the pair of bf16(s) rounds
//   bf16(v) * bf16(s) once, as the reference's bf16 multiply does (v has at
//   most 4 significant bits, bf16(s) 8: the product is exact before its one
//   rounding). A 16-row run of byte rows feeds two k16 steps: its low
//   nibbles one, its high nibbles the step g/2 further on.
// - The pipeline of a consumer warpgroup: issue the stage's eight
//   wgmma.m64n128k16 (async, queued behind the previous stage's), wait for
//   the previous stage's and release its slot, then dequantize the next
//   stage's A fragments into the register set those freed while this
//   stage's run: two register sets, two stages of products in flight.

#pragma once

#include "w4a8_mma.cuh"  // mbarriers, TMA boxes, the tensor-map encoder, cp_async

namespace ff {
namespace w4g {

constexpr int kBM = 128;                       // token rows a block (the wgmma N)
constexpr int kBN = 128;                       // weight columns a block
constexpr int kBK = 128;                       // k a stage
constexpr int kRows = kBK / 2;                 // packed byte rows a stage
constexpr int kConsumers = 2;                  // consumer warpgroups, 64 columns each
constexpr int kThreads = 128 * kConsumers + 32;  // and the producer warp
constexpr int kXHalf = kBM * 64 * 2;           // one 64-k box of x: 16 KB
constexpr int kXBytes = 2 * kXHalf;
constexpr int kWBytes = kRows * kBN;           // 8 KB
constexpr int kSBytes = (kBK / 32) * kBN * 4;  // the scale rows at g 32: 2 KB
constexpr int kStage = kXBytes + kWBytes + kSBytes;  // 42 KB, a multiple of 1024
constexpr int kDepth = 5;

inline size_t smem_bytes() { return (size_t)kDepth * kStage + 2 * kDepth * 8 + 1024; }

// The wgmma descriptor of x's K-major, 128B-swizzled tile at shared address
// `addr`: 8-row atoms of 128 bytes, 1024 bytes apart (SBO); LBO unused (1).
__device__ __forceinline__ uint64_t x_desc(unsigned addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 weight columns x 128 token rows, f32) += a (registers: this
// thread's bf16 pairs of the 64 x 16 A tile) . B (x, 16 k x 128 rows, at
// `desc`).
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], const unsigned (&a)[4],
                                                 uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// Keep the compiler from moving a register across the asynchronous wgmma
// that reads or writes it (no instruction).
__device__ __forceinline__ void fence_reg(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void fence_reg(unsigned& r) { asm volatile("" : "+r"(r)::"memory"); }

// The bf16 pair of the nibbles in bits 0-3 and 16-19 of `p` (two's
// complement) times the bf16 pair `s2`, each rounded once: 128 + u by the
// exponent trick, minus 136 (exact), times s2.
__device__ __forceinline__ unsigned dequant_pair(unsigned p, unsigned s2) {
  const unsigned m = (p & 0x000F000Fu) ^ 0x43084308u;
  unsigned v, w;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(v) : "r"(m), "r"(0x43084308u));
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(w) : "r"(v), "r"(s2));
  return w;
}

// The output type's rounding of an f32 value, as an f32.
template <typename OutT>
__device__ __forceinline__ float round_out(float v) { return v; }
template <>
__device__ __forceinline__ float round_out<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<unsigned*>(p) = pack_bf16x2(a, b);
}

// The A fragments of one stage for this thread: a[t] of the k16 step t (k
// = 16t.. of the stage), registers as mma.m16n8k16's A (rows gid, gid + 8:
// the weight columns cb, cb + 1; k 2tid.., 2tid + 8..). sw: the stage's 64
// swizzled byte rows; ss: its scale rows (kBN f32 each).
template <int GROUP>
__device__ __forceinline__ void dequant_stage(const unsigned char* sw, const float* ss, int cb,
                                              int tid, unsigned (&a)[8][4]) {
  constexpr int kHalf = GROUP / 2;  // byte rows of a group
  const int chunk = cb >> 4, off = cb & 15;
#pragma unroll
  for (int q = 0; q < kRows / 16; ++q) {
    const int r0 = 16 * q, grp = r0 / kHalf, i0 = r0 % kHalf;
    const int t_lo = (grp * GROUP + i0) / 16, t_hi = t_lo + kHalf / 16;
    const float2 sv = *reinterpret_cast<const float2*>(ss + grp * kBN + cb);
    const unsigned sa = pack_bf16x2(sv.x, sv.x), sb = pack_bf16x2(sv.y, sv.y);
    unsigned h[4];  // byte rows r0 + 2tid, + 1, + 8, + 9: columns cb (byte 0), cb + 1 (byte 1)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = r0 + 2 * tid + (j & 1) + 8 * (j >> 1);
      h[j] = *reinterpret_cast<const unsigned short*>(sw + row * kBN + ((chunk ^ (row & 7)) << 4) +
                                                      off);
    }
    // column cb's bytes of two rows at bytes 0 and 2, then column cb + 1's
    const unsigned p[4] = {__byte_perm(h[0], h[1], 0x0400), __byte_perm(h[0], h[1], 0x0501),
                           __byte_perm(h[2], h[3], 0x0400), __byte_perm(h[2], h[3], 0x0501)};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const unsigned s2 = r % 2 ? sb : sa;
      a[t_lo][r] = dequant_pair(p[r], s2);
      a[t_hi][r] = dequant_pair(p[r] >> 4, s2);
    }
  }
}

// Wait for stage s to land, then dequantize its A fragments into `a`.
template <int GROUP>
__device__ __forceinline__ void load_stage(unsigned char* smem, uint64_t* full, int s, int cb,
                                           int tid, unsigned (&a)[8][4]) {
  mma8::mbar_wait_or_trap(full + s % kDepth, (s / kDepth) & 1);
  const unsigned char* st = smem + (size_t)(s % kDepth) * kStage;
  dequant_stage<GROUP>(st + kXBytes, reinterpret_cast<const float*>(st + kXBytes + kWBytes), cb,
                       tid, a);
}

// One stage of a consumer warpgroup: its eight k16 products on the
// fragments `cur` (queued behind the previous stage's, which may still
// run), then the wait for the previous stage's products, which frees its
// fragments `nxt` and its ring slot (one arrival a warpgroup: the wait
// completes only once all four warps have issued those products, so all
// have read the slot), then the next stage's fragments into `nxt` while
// this stage's products run.
template <int GROUP>
__device__ __forceinline__ void run_stage(unsigned char* smem, uint64_t* full, uint64_t* empty,
                                          int s, int stages, int cb, int tid, float (&acc)[64],
                                          unsigned (&cur)[8][4], unsigned (&nxt)[8][4]) {
  const unsigned xb = smem_u32(smem + (size_t)(s % kDepth) * kStage);
  wgmma_fence();
#pragma unroll
  for (int t = 0; t < 8; ++t)
    wgmma_m64n128k16(acc, cur[t], x_desc(xb + (t / 4) * kXHalf + (t % 4) * 32));
  wgmma_commit();
  wgmma_wait<1>();
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int r = 0; r < 4; ++r) fence_reg(nxt[t][r]);
  if (s > 0 && threadIdx.x % 128 == 0) mma8::mbar_arrive(empty + (s - 1) % kDepth);
  if (s + 1 < stages) load_stage<GROUP>(smem, full, s + 1, cb, tid, nxt);
}

// The k of the two 64-k x boxes of stage s (group-halves layout): at g <=
// 128 the stage's 128 contiguous k; at g = 128 j (j >= 2) the runs of its
// byte rows' low and high nibbles, g/2 apart.
__host__ __device__ inline void stage_k(int s, int group, int& k_lo, int& k_hi) {
  if (group <= kBK) {
    k_lo = s * kBK;
    k_hi = k_lo + 64;
    return;
  }
  const int r = s * kRows, half = group / 2;  // the stage's first byte row
  k_lo = r / half * group + r % half;
  k_hi = k_lo + half;
}

// Grid: (m tiles * n tiles), kThreads threads, dynamic shared memory
// smem_bytes(). x_map: x (M, K) bf16, boxes of 64 k x kBM rows; w_map (when
// w_tma): w's (K/2, N) bytes, boxes of kBN x kRows; s_map: s (K/g, N) f32,
// boxes of kBN x max(1, kBK / g). GROUP 0: g = `group`, a multiple of 128
// from 256 (a stage then reads as at g 128).
template <int GROUP, typename OutT>
__global__ void __launch_bounds__(kThreads, 1)
w4a16_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                   const __grid_constant__ CUtensorMap w_map,
                   const __grid_constant__ CUtensorMap s_map, int w_tma,
                   const int8_t* __restrict__ w, const float* __restrict__ bias,
                   OutT* __restrict__ out, int M, int K, int N, int group, int group_m) {
  constexpr int kSRows = GROUP ? kBK / GROUP : 1;
  constexpr int kDq = GROUP ? GROUP : kBK;  // the group a stage reads as
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzle's 1024-byte period (smem_bytes asks for the slack)
  unsigned char* smem = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + (size_t)kDepth * kStage);
  uint64_t* empty = full + kDepth;
  const int m_tiles = (M + kBM - 1) / kBM, n_tiles = (N + kBN - 1) / kBN;
  const int per_group = group_m * n_tiles, first = blockIdx.x / per_group * group_m;
  const int gm = min(group_m, m_tiles - first), local = blockIdx.x % per_group;
  const int m0 = (first + local % gm) * kBM, n0 = local / gm * kBN;
  const int stages = (K + kBK - 1) / kBK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kDepth; ++s) {
      // TMA: the producer's one arrival; else also its 32 lanes' cp.async ones
      mbar_init(full + s, w_tma ? 1 : 33);
      mbar_init(empty + s, kConsumers);
    }
    mma8::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4 * kConsumers) {
    // ---- the producer warp
    for (int s = 0; s < stages; ++s) {
      const int slot = s % kDepth;
      if (s >= kDepth) mma8::mbar_wait_or_trap(empty + slot, ((s / kDepth) - 1) & 1);
      unsigned char* st = smem + (size_t)slot * kStage;
      if (lane == 0) {
        int k_lo, k_hi;
        stage_k(s, group, k_lo, k_hi);
        mma8::mbar_arrive_expect_tx(full + slot,
                                    kXBytes + (w_tma ? kWBytes : 0) + kSRows * kBN * 4);
        mma8::tma_box(st, &x_map, k_lo, m0, full + slot);
        mma8::tma_box(st + kXHalf, &x_map, k_hi, m0, full + slot);
        if (w_tma) mma8::tma_box(st + kXBytes, &w_map, n0, s * kRows, full + slot);
        mma8::tma_box(st + kXBytes + kWBytes, &s_map, n0, GROUP ? s * kSRows : k_lo / group,
                      full + slot);
      }
      if (!w_tma) {
        // lane: the 4-byte word at column 4 lane of each byte row, to its
        // swizzled place; zeros past the tensor (N % 4 == 0: a word is in
        // or out whole)
        const int c = n0 + 4 * lane;
        for (int r = 0; r < kRows; ++r) {
          const int row = s * kRows + r;
          const bool ok = c < N && row < K / 2;
          cp_async<4>(st + kXBytes + r * kBN + (((lane / 4) ^ (r & 7)) << 4) + 4 * (lane % 4),
                      ok ? w + (size_t)row * N + c : w, ok);
        }
        cp_async_arrive(full + slot);
      }
    }
    if (!w_tma) mma8::cp_async_wait_all();
    return;
  }

  // ---- the consumer warpgroups: 64 weight columns each, every token row
  const int wg = warp / 4, gid = lane / 4, tid = lane % 4;
  const int cb = 64 * wg + 16 * (warp % 4) + 2 * gid;  // this thread's columns cb, cb + 1
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  unsigned a0[8][4], a1[8][4];

  load_stage<kDq>(smem, full, 0, cb, tid, a0);
  for (int s = 0; s < stages; s += 2) {
    run_stage<kDq>(smem, full, empty, s, stages, cb, tid, acc, a0, a1);
    if (s + 1 < stages) run_stage<kDq>(smem, full, empty, s + 1, stages, cb, tid, acc, a1, a0);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 64; ++i) fence_reg(acc[i]);

  // ---- epilogue: acc[4i + h] is column cb, acc[4i + 2 + h] column cb + 1,
  // of token row 8i + 2tid + h
  const int n = n0 + cb;
  if (n >= N) return;  // N % 4 == 0: cb even, so cb + 1 < N too
  const float b0 = bias != nullptr ? bias[n] : 0.f, b1 = bias != nullptr ? bias[n + 1] : 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + 8 * i + 2 * tid + h;
      if (m >= M) continue;
      float ya = acc[4 * i + h], yb = acc[4 * i + 2 + h];
      if (bias != nullptr) {
        ya = round_out<OutT>(ya) + b0;
        yb = round_out<OutT>(yb) + b1;
      }
      store2(out + (size_t)m * N + n, ya, yb);
    }
}

// The groups the group-halves tensor-core kernels take (w4_gemv.cu,
// w4a8_halves.cu, this GEMM; kernels/matmul.py float_scale_group_ok): g 32,
// 64 or 128, or g = 128 j (j >= 2) up to K; K a whole number of groups.
__host__ __device__ inline bool group_ok(int K, int group) {
  const bool small = group == 32 || group == 64 || group == 128;
  return (small || (group >= 2 * kBK && group % kBK == 0)) && K >= group && K % group == 0;
}

// Launch the GEMM on a (M, K) x (K/2, N) product; group_ok(K, group). x and
// s must admit a tensor map (16-byte aligned); the weights take the
// cp.async feed where they do not.
template <typename OutT>
cudaError_t launch(const void* x, const void* w, const void* s, const void* bias, void* out,
                   int M, int K, int N, int group, cudaStream_t st) {
  if (M < 1 || N < 4 || N % 4 != 0 || !group_ok(K, group)) return cudaErrorInvalidValue;
  CUtensorMap xm = {}, wm = {}, sm = {};
  if (!mma8::tensor_map(&xm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M, 2ll * K, 64, kBM,
                        CU_TENSOR_MAP_SWIZZLE_128B) ||
      !mma8::tensor_map(&sm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, s, N, K / group, 4ll * N, kBN,
                        group > kBK ? 1 : kBK / group, CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  const int w_tma = mma8::tensor_map(&wm, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, N, K / 2, N, kBN,
                                     kRows, CU_TENSOR_MAP_SWIZZLE_128B);
  // m tiles a group: the group's x tiles (kBM x K bf16 each) within ~16 MB of L2
  const int group_m = max(1, min(16, (16 << 20) / (kBM * K * 2)));
  const int blocks = ((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  const size_t smem = smem_bytes();
  auto run = [&](auto kernel) -> cudaError_t {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<blocks, kThreads, smem, st>>>(xm, wm, sm, w_tma, static_cast<const int8_t*>(w),
                                           static_cast<const float*>(bias),
                                           static_cast<OutT*>(out), M, K, N, group, group_m);
    return cudaGetLastError();
  };
  switch (group) {
    case 32:
      return run(w4a16_wgmma_kernel<32, OutT>);
    case 64:
      return run(w4a16_wgmma_kernel<64, OutT>);
    case 128:
      return run(w4a16_wgmma_kernel<128, OutT>);
    default:
      return run(w4a16_wgmma_kernel<0, OutT>);
  }
}

// ---- Any group: the route of every group the reference takes that
// group_ok does not (g even, K a whole number of groups; kernels/matmul.py
// float_scale_route), for the W4 GEMV (row 17, w4_gemv.cu) and this GEMM
// (row 18t). No served default reaches these groups, so the kernel is the
// plain loop on the CUDA cores: a thread owns one weight column and
// kAnyRows token rows; byte row r of group p holds k = pg + r in its low
// nibble and pg + g/2 + r in its high nibble, so a run of kAnyRun byte rows
// needs x at two runs of k, which the block stages in shared memory as f32.
// Each weight is dequantized as the row's tensor-core kernel does it: row
// 17 bf16(f32(v) * s), 18t bf16(v * bf16(s)) (TILED; the product is exact
// before its one rounding), and enters one f32 fused multiply-add a token
// row, in k order within a group and group order overall.
constexpr int kAnyCols = 128;  // weight columns a block, one a thread
constexpr int kAnyRows = 8;    // token rows a block
constexpr int kAnyRun = 64;    // byte rows a staged run

__host__ __device__ inline bool any_group_ok(int K, int group) {
  return group >= 2 && group % 2 == 0 && K >= group && K % group == 0;
}

template <typename OutT, bool TILED>
__global__ void __launch_bounds__(kAnyCols)
    w4_any_group_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                        const float* __restrict__ s, const float* __restrict__ bias,
                        OutT* __restrict__ out, int M, int K, int N, int group) {
  __shared__ float xr[kAnyRows][2 * kAnyRun];  // a run's low-nibble k, then its high-nibble k
  const int n = blockIdx.x * kAnyCols + threadIdx.x, m0 = blockIdx.y * kAnyRows;
  const int half = group / 2, G = K / group;
  float acc[kAnyRows];
#pragma unroll
  for (int i = 0; i < kAnyRows; ++i) acc[i] = 0.f;
  for (int p = 0; p < G; ++p) {
    float sc = n < N ? s[(size_t)p * N + n] : 0.f;
    if (TILED) sc = __bfloat162float(__float2bfloat16_rn(sc));
    for (int r0 = 0; r0 < half; r0 += kAnyRun) {
      const int run = min(kAnyRun, half - r0);
      __syncthreads();  // the previous run is consumed
      for (int e = threadIdx.x; e < kAnyRows * 2 * kAnyRun; e += kAnyCols) {
        const int i = e / (2 * kAnyRun), j = e % (2 * kAnyRun), r = j % kAnyRun;
        const int k = p * group + (j < kAnyRun ? 0 : half) + r0 + r;
        xr[i][j] = m0 + i < M && r < run ? __bfloat162float(x[(size_t)(m0 + i) * K + k]) : 0.f;
      }
      __syncthreads();
      if (n >= N) continue;
      for (int r = 0; r < run; ++r) {
        const int b = w[(size_t)(p * half + r0 + r) * N + n];  // sign-extended byte
        const int lo = (int)((unsigned)b << 28) >> 28, hi = b >> 4;
        const float wl = __bfloat162float(__float2bfloat16_rn(__fmul_rn((float)lo, sc)));
        const float wh = __bfloat162float(__float2bfloat16_rn(__fmul_rn((float)hi, sc)));
#pragma unroll
        for (int i = 0; i < kAnyRows; ++i) {
          acc[i] = __fmaf_rn(xr[i][r], wl, acc[i]);
          acc[i] = __fmaf_rn(xr[i][kAnyRun + r], wh, acc[i]);
        }
      }
    }
  }
  if (n >= N) return;
  const float b = bias != nullptr ? bias[n] : 0.f;
#pragma unroll
  for (int i = 0; i < kAnyRows; ++i) {
    if (m0 + i >= M) break;
    const float y = bias != nullptr ? __fadd_rn(round_out<OutT>(acc[i]), b) : acc[i];
    store<OutT>(out + (size_t)(m0 + i) * N + n, y);
  }
}

// Launch the any-group kernel on a (M, K) x (K/2, N) product; any_group_ok.
template <typename OutT, bool TILED>
cudaError_t launch_any(const void* x, const void* w, const void* s, const void* bias, void* out,
                       int M, int K, int N, int group, cudaStream_t st) {
  const int row_blocks = (M + kAnyRows - 1) / kAnyRows;
  if (M < 1 || N < 1 || !any_group_ok(K, group) || row_blocks > 65535)
    return cudaErrorInvalidValue;
  w4_any_group_kernel<OutT, TILED><<<dim3((N + kAnyCols - 1) / kAnyCols, row_blocks), kAnyCols,
                                     0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(s), static_cast<const float*>(bias), static_cast<OutT*>(out), M,
      K, N, group);
  return cudaGetLastError();
}

}  // namespace w4g
}  // namespace ff
