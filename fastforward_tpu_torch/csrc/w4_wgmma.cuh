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
//   the consumers then read the stage as at g 128. Every other group the
//   reference takes (g even, K a whole number of groups) reads x permuted
//   into byte-row order (permute_x below), which a stage reads as at g 32;
//   only the scales follow the group, one scale row a byte row. Where the
//   weights' row pitch N is not
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

// ---- Every other group the reference takes (g even, K a whole number of
// groups; kernels/matmul.py float_scale_route "permuted"): byte row b of
// pack_int4's group halves (group p = b / h, h = g/2, i = b % h) holds k =
// pg + i in its low nibble and pg + h + i in its high one, so a stage's x
// are whole TMA boxes only at the groups group_ok takes. Every other group
// first permutes x once a call (permute_x_kernel) into xp (M, perm_cols(K)):
// columns 32 r .. 32 r + 15 of run r are x at the low-nibble k of byte rows
// 16 r .. 16 r + 15, columns 32 r + 16 .. 32 r + 31 at their high-nibble k,
// zeros past byte row K/2 - 1. That is the g 32 layout of x for every group:
// the kernels read xp as they read x at g 32, and only the scales follow the
// group. A stage (64 byte rows from a 16-row run) loads the scale rows of
// every group it touches, perm_scale_box of them from its first byte row's
// group.
__host__ __device__ inline bool reference_group_ok(int K, int group) {
  return group >= 2 && group % 2 == 0 && K >= group && K % group == 0;
}
__host__ __device__ inline int perm_cols(int K) { return (K + 31) / 32 * 32; }
__host__ __device__ inline int gcd_int(int a, int b) {
  while (b != 0) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}
// Scale rows a stage loads: a stage starting on a 16-row run lies rem =
// (16 j) % h rows into its first group, rem <= h - gcd(16, h), so its 64
// rows touch at most (h - gcd(16, h) + 63) / h + 1 groups; no more than G.
__host__ __device__ inline int perm_scale_box(int K, int group) {
  const int h = group / 2, G = K / group, r = (h - gcd_int(16, h) + 63) / h + 1;
  return r < G ? r : G;
}
// Bytes of a stage's scale region: the box rounded up to an even row count,
// so a stage stays a whole number of the 128B swizzle's 1024-byte periods.
__host__ __device__ inline int perm_scale_bytes(int K, int group, int cols) {
  return (perm_scale_box(K, group) + 1) / 2 * 2 * cols * 4;
}

// The scale row of byte row B + o of a stage whose first byte row B lies rem
// = B % h rows into its group (the stage's first scale row): (rem + o) / h
// for o < 64, by a compare (h >= 64: the quotient is 0 or 1) or a multiply
// by ceil(2^16 / h) and a shift (exact for numerators below 128); at most
// `last`, the box's last row (only rows past K/2, whose weights arrive as
// zeros, would reach further where the box stops at G rows).
struct GroupDiv {
  int h, last;
  unsigned magic;
  __host__ __device__ GroupDiv(int group, int last_row)
      : h(group / 2), last(last_row),
        magic((65536u + (unsigned)(group / 2) - 1) / (unsigned)(group / 2)) {}
  __device__ __forceinline__ int operator()(int n) const {
    const int q = h >= 64 ? (int)(n >= h) : (int)(((unsigned)n * magic) >> 16);
    return q < last ? q : last;
  }
};

// xp = x in byte-row order (above). T: the raw element (2 bytes for bf16 x,
// 1 for int8). Item e writes the 16 columns of plane e % 2 of run (e / 2) %
// runs of row e / (2 runs): the 16 byte rows' k within a group are
// consecutive, so it steps p and i instead of dividing each.
template <typename T>
__global__ void permute_x_kernel(const T* __restrict__ x, T* __restrict__ xp, int M, int K,
                                 int group) {
  const int cols = perm_cols(K), runs = cols / 32, half = group / 2, byte_rows = K / 2;
  const long long items = 2ll * M * runs;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < items;
       e += (long long)gridDim.x * blockDim.x) {
    const int plane = (int)(e % 2), r = (int)(e / 2 % runs), m = (int)(e / 2 / runs);
    const T* row = x + (size_t)m * K;
    int p = 16 * r / half, i = 16 * r % half;
    alignas(16) T v[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      v[j] = 16 * r + j < byte_rows ? row[p * group + plane * half + i] : T(0);
      if (++i == half) {
        i = 0;
        ++p;
      }
    }
    uint4* dst = reinterpret_cast<uint4*>(xp + (size_t)m * cols + 32 * r + 16 * plane);
#pragma unroll
    for (int j = 0; j < (int)(16 * sizeof(T) / 16); ++j) dst[j] = reinterpret_cast<const uint4*>(v)[j];
  }
}

// Launch permute_x_kernel: x (M, K) of T, xp (M, perm_cols(K)) of T, both
// 16-byte aligned.
template <typename T>
cudaError_t permute_x(const void* x, void* xp, int M, int K, int group, cudaStream_t st) {
  if (M < 1 || !reference_group_ok(K, group) || reinterpret_cast<uintptr_t>(xp) % 16 != 0)
    return cudaErrorInvalidValue;
  const long long items = 2ll * M * (perm_cols(K) / 32);
  const int threads = 256;
  const long long want = (items + threads - 1) / threads;
  permute_x_kernel<T><<<(int)(want < 8192 ? want : 8192), threads, 0, st>>>(
      static_cast<const T*>(x), static_cast<T*>(xp), M, K, group);
  return cudaGetLastError();
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

// dequant_stage on the permuted route (x in byte-row order, GROUP 32's
// layout: k16 steps 2q and 2q + 1 are byte rows 16q.. low and high): each
// byte row takes the scale row gd(rem + its row), rem the stage's first
// byte row's place in its group.
__device__ __forceinline__ void dequant_stage_perm(const unsigned char* sw, const float* ss,
                                                   int cb, int tid, unsigned (&a)[8][4],
                                                   const GroupDiv& gd, int rem) {
  const int chunk = cb >> 4, off = cb & 15;
#pragma unroll
  for (int q = 0; q < kRows / 16; ++q) {
    const int r0 = 16 * q;
    unsigned h[4];  // byte rows r0 + 2tid, + 1, + 8, + 9: columns cb (byte 0), cb + 1 (byte 1)
    float2 sv[4];   // their scales
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = r0 + 2 * tid + (j & 1) + 8 * (j >> 1);
      h[j] = *reinterpret_cast<const unsigned short*>(sw + row * kBN + ((chunk ^ (row & 7)) << 4) +
                                                      off);
      sv[j] = *reinterpret_cast<const float2*>(ss + gd(rem + row) * kBN + cb);
    }
    const unsigned p[4] = {__byte_perm(h[0], h[1], 0x0400), __byte_perm(h[0], h[1], 0x0501),
                           __byte_perm(h[2], h[3], 0x0400), __byte_perm(h[2], h[3], 0x0501)};
    const unsigned s2[4] = {pack_bf16x2(sv[0].x, sv[1].x), pack_bf16x2(sv[0].y, sv[1].y),
                            pack_bf16x2(sv[2].x, sv[3].x), pack_bf16x2(sv[2].y, sv[3].y)};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      a[2 * q][r] = dequant_pair(p[r], s2[r]);
      a[2 * q + 1][r] = dequant_pair(p[r] >> 4, s2[r]);
    }
  }
}

// Wait for stage s of a ring of `depth` slots of `stage` bytes to land,
// then dequantize its A fragments into `a`.
template <int GROUP, bool PERM>
__device__ __forceinline__ void load_stage(unsigned char* smem, uint64_t* full, int s, int cb,
                                           int tid, unsigned (&a)[8][4], int depth, int stage,
                                           const GroupDiv& gd) {
  mma8::mbar_wait_or_trap(full + s % depth, (s / depth) & 1);
  const unsigned char* st = smem + (size_t)(s % depth) * stage;
  const float* ss = reinterpret_cast<const float*>(st + kXBytes + kWBytes);
  if constexpr (PERM)
    dequant_stage_perm(st + kXBytes, ss, cb, tid, a, gd, s * kRows % gd.h);
  else
    dequant_stage<GROUP>(st + kXBytes, ss, cb, tid, a);
}

// One stage of a consumer warpgroup: its eight k16 products on the
// fragments `cur` (queued behind the previous stage's, which may still
// run), then the wait for the previous stage's products, which frees its
// fragments `nxt` and its ring slot (one arrival a warpgroup: the wait
// completes only once all four warps have issued those products, so all
// have read the slot), then the next stage's fragments into `nxt` while
// this stage's products run.
template <int GROUP, bool PERM>
__device__ __forceinline__ void run_stage(unsigned char* smem, uint64_t* full, uint64_t* empty,
                                          int s, int stages, int cb, int tid, float (&acc)[64],
                                          unsigned (&cur)[8][4], unsigned (&nxt)[8][4], int depth,
                                          int stage, const GroupDiv& gd) {
  const unsigned xb = smem_u32(smem + (size_t)(s % depth) * stage);
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
  if (s > 0 && threadIdx.x % 128 == 0) mma8::mbar_arrive(empty + (s - 1) % depth);
  if (s + 1 < stages) load_stage<GROUP, PERM>(smem, full, s + 1, cb, tid, nxt, depth, stage, gd);
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

// The GEMM's block (w4a16_wgmma_kernel, w4a16_perm_kernel below): a ring
// of `depth` stages.
template <int GROUP, typename OutT, bool PERM>
__device__ __forceinline__ void w4a16_block(const CUtensorMap& x_map, const CUtensorMap& w_map,
                                            const CUtensorMap& s_map, int w_tma,
                                            const int8_t* __restrict__ w,
                                            const float* __restrict__ bias,
                                            OutT* __restrict__ out, int M, int K, int N,
                                            int group, int group_m, int depth) {
  constexpr int kDq = GROUP ? GROUP : kBK;  // the group a stage reads as
  const int stage = PERM ? kXBytes + kWBytes + perm_scale_bytes(K, group, kBN) : kStage;
  const int s_rows = PERM ? perm_scale_box(K, group) : GROUP ? kBK / GROUP : 1;
  const GroupDiv gd(PERM ? group : 2, s_rows - 1);
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzle's 1024-byte period (smem_bytes asks for the slack)
  unsigned char* smem = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + (size_t)depth * stage);
  uint64_t* empty = full + depth;
  const int m_tiles = (M + kBM - 1) / kBM, n_tiles = (N + kBN - 1) / kBN;
  const int per_group = group_m * n_tiles, first = blockIdx.x / per_group * group_m;
  const int gm = min(group_m, m_tiles - first), local = blockIdx.x % per_group;
  const int m0 = (first + local % gm) * kBM, n0 = local / gm * kBN;
  const int stages = (K + kBK - 1) / kBK;
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

  if (warp == 4 * kConsumers) {
    // ---- the producer warp
    for (int s = 0; s < stages; ++s) {
      const int slot = s % depth;
      if (s >= depth) mma8::mbar_wait_or_trap(empty + slot, ((s / depth) - 1) & 1);
      unsigned char* st = smem + (size_t)slot * stage;
      if (lane == 0) {
        int k_lo, k_hi;
        stage_k(s, PERM ? kBK : group, k_lo, k_hi);
        mma8::mbar_arrive_expect_tx(full + slot,
                                    kXBytes + (w_tma ? kWBytes : 0) + s_rows * kBN * 4);
        mma8::tma_box(st, &x_map, k_lo, m0, full + slot);
        mma8::tma_box(st + kXHalf, &x_map, k_hi, m0, full + slot);
        if (w_tma) mma8::tma_box(st + kXBytes, &w_map, n0, s * kRows, full + slot);
        mma8::tma_box(st + kXBytes + kWBytes, &s_map, n0,
                      PERM ? s * kRows / gd.h : GROUP ? s * s_rows : k_lo / group, full + slot);
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

  load_stage<kDq, PERM>(smem, full, 0, cb, tid, a0, depth, stage, gd);
  for (int s = 0; s < stages; s += 2) {
    run_stage<kDq, PERM>(smem, full, empty, s, stages, cb, tid, acc, a0, a1, depth, stage, gd);
    if (s + 1 < stages)
      run_stage<kDq, PERM>(smem, full, empty, s + 1, stages, cb, tid, acc, a1, a0, depth, stage,
                           gd);
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
  w4a16_block<GROUP, OutT, false>(x_map, w_map, s_map, w_tma, w, bias, out, M, K, N, group,
                                  group_m, kDepth);
}

// The permuted route: any group the reference takes, x in byte-row order
// (x_map: xp, boxes of 64 k x kBM rows, read as at g 32), s_map's boxes
// perm_scale_box rows, a ring of `depth` stages of kXBytes + kWBytes +
// perm_scale_bytes (launch: perm_depth).
template <typename OutT>
__global__ void __launch_bounds__(kThreads, 1)
w4a16_perm_kernel(const __grid_constant__ CUtensorMap x_map,
                  const __grid_constant__ CUtensorMap w_map,
                  const __grid_constant__ CUtensorMap s_map, int w_tma,
                  const int8_t* __restrict__ w, const float* __restrict__ bias,
                  OutT* __restrict__ out, int M, int K, int N, int group, int group_m,
                  int depth) {
  w4a16_block<32, OutT, true>(x_map, w_map, s_map, w_tma, w, bias, out, M, K, N, group,
                              group_m, depth);
}

// The groups the group-halves tensor-core kernels read x for as it lies
// (w4_gemv.cu, w4a8_halves.cu, this GEMM; kernels/matmul.py wgmma_group_ok):
// g 32, 64 or 128, or g = 128 j (j >= 2) up to K; K a whole number of
// groups. Every other group the reference takes reads xp (permute_x).
__host__ __device__ inline bool group_ok(int K, int group) {
  const bool small = group == 32 || group == 64 || group == 128;
  return (small || (group >= 2 * kBK && group % kBK == 0)) && K >= group && K % group == 0;
}

// Shared memory of the GEMM's block on the permuted route: the deepest ring
// of at most kDepth stages that fits an SM (the scale region grows as the
// group shrinks: 32 KB a stage at g 2).
inline int perm_depth(int K, int group) {
  const int stage = kXBytes + kWBytes + perm_scale_bytes(K, group, kBN);
  const int depth = (232448 - 1024 - 2 * kDepth * 8) / stage;
  return depth < kDepth ? depth : kDepth;
}

// Launch the GEMM on a (M, K) x (K/2, N) product; reference_group_ok(K,
// group). x and s must admit a tensor map (16-byte aligned); the weights
// take the cp.async feed where they do not. Where group_ok does not take the
// group, x is first permuted into xp (M, perm_cols(K)) bf16, 16-byte aligned.
template <typename OutT>
cudaError_t launch(const void* x, const void* w, const void* s, const void* bias, void* out,
                   void* xp, int M, int K, int N, int group, cudaStream_t st) {
  if (M < 1 || N < 4 || N % 4 != 0 || !reference_group_ok(K, group)) return cudaErrorInvalidValue;
  const bool perm = !group_ok(K, group);
  if (perm) {
    if (xp == nullptr) return cudaErrorInvalidValue;
    const cudaError_t err = permute_x<unsigned short>(x, xp, M, K, group, st);
    if (err != cudaSuccess) return err;
  }
  CUtensorMap xm = {}, wm = {}, sm = {};
  if (!mma8::tensor_map(&xm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, perm ? xp : x,
                        perm ? perm_cols(K) : K, M, 2ll * (perm ? perm_cols(K) : K), 64, kBM,
                        CU_TENSOR_MAP_SWIZZLE_128B) ||
      !mma8::tensor_map(&sm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, s, N, K / group, 4ll * N, kBN,
                        perm ? perm_scale_box(K, group) : group > kBK ? 1 : kBK / group,
                        CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  const int w_tma = mma8::tensor_map(&wm, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, N, K / 2, N, kBN,
                                     kRows, CU_TENSOR_MAP_SWIZZLE_128B);
  // m tiles a group: the group's x tiles (kBM x K bf16 each) within ~16 MB of L2
  const int group_m = max(1, min(16, (16 << 20) / (kBM * K * 2)));
  const int blocks = ((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  const int depth = perm ? perm_depth(K, group) : kDepth;
  const size_t smem = perm ? (size_t)depth * (kXBytes + kWBytes + perm_scale_bytes(K, group, kBN)) +
                                 2 * depth * 8 + 1024
                           : smem_bytes();
  if (depth < 2) return cudaErrorInvalidValue;
  auto run = [&](auto kernel, auto... extra) -> cudaError_t {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<blocks, kThreads, smem, st>>>(xm, wm, sm, w_tma, static_cast<const int8_t*>(w),
                                           static_cast<const float*>(bias),
                                           static_cast<OutT*>(out), M, K, N, group, group_m,
                                           extra...);
    return cudaGetLastError();
  };
  if (perm) return run(w4a16_perm_kernel<OutT>, depth);
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

}  // namespace w4g
}  // namespace ff
