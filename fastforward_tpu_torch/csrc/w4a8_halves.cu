// The float-scale W4A8 GEMV (FF_BENCH_MODE=w4a8) on Hopper's int8 warpgroup
// tensor cores: int8 activations against pack_int4 group-halves weights,
// each group's int32 dot folded into f32 sums in the jitted oracle's order.
//
// Replaces: fastforward_tpu/kernels/matmul.py matmul_w4a8_gemv (:341,
// kernel _w4a8_gemv_kernel :312, pallas_call :363), which matmul_w4a8
// takes up to 256 rows.
//   gd_g[m, n] = sum_{k in group g} x[m, k] * v[k, n]     (int32, exact)
//   acc[m, n]  = sum_g float(gd_g) * s[g, n]               (f32, fixed order)
//   y[m, n]    = acc * xs[m]                               (f32 or bf16)
// x (M <= 256, K) int8, xs (M,) f32, w (K/2, N) in pack_int4's group
// halves (byte row i of group p: k = pg + i low nibble, pg + g/2 + i high,
// two's complement), s (K/g, N) f32, any group the reference takes (g even,
// K a whole number of groups). The group sum runs in
// the order of the jitted JAX oracle, which the port's
// matmul_w4a8_reference writes out (kernels/matmul.py _group_sum): up to
// 32 groups a chain of fused multiply-adds in group order from +0; beyond,
// the rounded products in windows of 32 (the first shortened by lo = (32
// ceil(G/32) - G) / 2), each summed in order from +0, then the window sums
// in order from +0. Bit for bit. The TPU kernel added the same products in
// group order without fusing.
//
// Bound on the H100 at M = 192: a Llama-3-8B layer's four projections read
// 109 MB of packed weights and 1.7 MB of scales (0.033 ms at 3.35 TB/s)
// and do 8.4e10 int8 operations (0.042 ms at 1,979 TOP/s): operations, by
// a little.
//
// Design (int8_wgmma.cuh's block: 128 weight columns, two consumer
// warpgroups of 64, a producer warp, x by TMA):
// - The nibbles enter wgmma's register operand as signed bytes 16 v (the
//   high nibble masked in place, the low one shifted up by 4), so the int32
//   dot is 16 gd exactly (group_dot turns it into the float gd). A 16-row
//   run of byte rows gives a thread two words (its two columns); their low
//   nibbles feed the k of the group's first half, their high nibbles the k
//   g/2 further on.
// - A group is g/32 m64nNk32 products into a fresh int32 accumulator (the
//   first with scale-d 0); after their wait each thread folds its own
//   outputs' group dots into their f32 sums with its columns' two scales:
//   every output's sum lives in one thread, in group order.
// - Registers bound the token rows: an int32 accumulator and the f32 sums
//   (and a window sum beyond 32 groups without a split) are NT/2 each a
//   thread, so a block takes at most 96 token rows (64 with three sets);
//   more rows split over blocks (`row_blocks`, kernels/matmul.py
//   w4a8_plan, which also splits narrow projections' rows to fill the
//   card). (Two accumulators, one group folded while the next runs, did
//   not fit: ptxas kept the 168 registers a thread of a 9-warp block gets
//   even under setmaxnreg, spilled and serialized the products, and the
//   M = 8 product, whose chain it was to shorten, ran no faster.)
// - K splits only at window boundaries (33-256 groups): block z of a
//   cluster sums window z from +0 (Llama-3-8B's down_proj at g128, 112
//   groups: windows of 24, 32, 32, 24, a cluster of 4), and after a cluster
//   barrier the window sums are added in window order from +0 through
//   distributed shared memory. Up to 32 groups (qkv, o and gate/up at K =
//   4096) the chain cannot split: those products take their parallelism
//   from column and row blocks alone. Beyond 256 groups one block walks
//   every window.
// - The ring's stages hold 128 k: x (one box), the 64 packed byte rows (one
//   128B-swizzled box; the 4-byte cp.async feed where N % 16 != 0) and the
//   128/g scale rows. A split starts at its first group, so its last stage
//   may hold groups of the next window, which it folds with a zero scale.
// - A group of g = 128 j (j >= 2) spans j stages (consume_big). Stage c of
//   group p holds byte rows pg/2 + 64c.., whose low nibbles are k = pg +
//   64c.. and high nibbles k = pg + g/2 + 64c..: x arrives as those two
//   64-k runs, each a box of 64 bytes a token row with the 64B swizzle
//   (x_desc64), and the stage's four k32 steps read them as the g 128
//   steps read their one box. The group's int32 dot accumulates over its j
//   stages (16 |gd| <= 16 * 128 * 8 * g < 2^31 up to g = 2^16) and is
//   folded once, after its last stage, in the same order as at g <= 128;
//   window splits (every 32 groups) fall on stage boundaries.
// - Every other group (and more than 32 x 32 groups, or g above 2^16) takes
//   the permuted route (w4a8_perm_kernel below): x permuted into byte-row
//   order (w4_wgmma.cuh permute_x), which a stage reads as at g 32, and the
//   group pieces of each k32 step masked apart in the register operand.

#include "int8_wgmma.cuh"

namespace ff {
namespace w4h {

using i8w::kBK;
using i8w::kBN;
using i8w::kConsumers;
using i8w::kRedPitch;
using i8w::kThreads;

constexpr int kRows = kBK / 2;                 // packed byte rows a stage
constexpr int kWBytes = kRows * kBN;           // 8 KB
constexpr int kSBytes = (kBK / 32) * kBN * 4;  // the scale rows at g 32: 2 KB
constexpr int kWindow = 32;                    // the oracle's window of summation
constexpr int kMaxRows = 96;                   // token rows a block (64 with three sum sets)
// How a block folds its group dots (kernels/matmul.py W4A8_FOLDS): one
// fused multiply-add chain (up to 32 groups, no split); the sum of one
// window's rounded products, window z in split z; every window in one
// block (a chain sum and a window sum).
constexpr int kChain = 0, kWindowSplit = 1, kMulti = 2;

__host__ __device__ constexpr int stage_bytes(int nt) { return nt * kBK + kWBytes + kSBytes; }

// The ring, or the reduction tile (f32 window sums) where K is split,
// which reuses it; its barriers; the slack to align it to 1024 bytes.
inline size_t smem_bytes(int nt, int depth, int n_split) {
  const size_t ring = (size_t)depth * stage_bytes(nt);
  const size_t red = n_split > 1 ? (size_t)nt * kRedPitch * 4 : 0;
  return (ring > red ? ring : red) + (size_t)depth * 16 + 1024;
}

// The first window's shortening and split z's groups [g0, g1).
__host__ __device__ inline int window_lo(int G) {
  return ((G + kWindow - 1) / kWindow * kWindow - G) / 2;
}
__host__ __device__ inline void split_groups(int fold, int G, int z, int& g0, int& g1) {
  g0 = 0;
  g1 = G;
  if (fold == kWindowSplit) {
    const int lo = window_lo(G);
    g0 = kWindow * z - lo > 0 ? kWindow * z - lo : 0;
    g1 = kWindow * (z + 1) - lo < G ? kWindow * (z + 1) - lo : G;
  }
}

// 16 v of the low and of the high nibble of each byte, as signed bytes.
__device__ __forceinline__ unsigned nib_lo16(unsigned w) { return (w << 4) & 0xF0F0F0F0u; }
__device__ __forceinline__ unsigned nib_hi16(unsigned w) { return w & 0xF0F0F0F0u; }

// A thread's raw words of one stage: f[b] columns cb, cb + 1 over byte rows
// 16 b + 4 tid .. + 3.
__device__ __forceinline__ void load_raw(const unsigned char* sw, const i8w::Lane& l,
                                         unsigned (&f)[4][2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    unsigned c[4];
    i8w::col_words(sw, l, 32 * h, c);
    f[2 * h][0] = c[0];
    f[2 * h][1] = c[1];
    f[2 * h + 1][0] = c[2];
    f[2 * h + 1][1] = c[3];
  }
}

// The A registers of k32 step t of group q of a stage (rows gid, gid + 8:
// columns cb, cb + 1; slots 4 tid.. then 16 + 4 tid..), and the step's
// first k in the stage. g 32: one step, slots 0-15 the low nibbles of the
// group's 16 byte rows, 16-31 their high nibbles. g 64 and 128: a step is
// 32 byte rows of one nibble plane (g 64: plane t of group q's rows; g 128:
// plane t / 2 of chunk t % 2).
__device__ __forceinline__ void step_regs(int group, int q, int t, const unsigned (&f)[4][2],
                                          unsigned (&a)[4]) {
  if (group == 32) {
    a[0] = nib_lo16(f[q][0]);
    a[1] = nib_lo16(f[q][1]);
    a[2] = nib_hi16(f[q][0]);
    a[3] = nib_hi16(f[q][1]);
    return;
  }
  const int b = group == 64 ? 2 * q : 2 * (t % 2);
  const bool hi = group == 64 ? t == 1 : t >= 2;
  a[0] = hi ? nib_hi16(f[b][0]) : nib_lo16(f[b][0]);
  a[1] = hi ? nib_hi16(f[b][1]) : nib_lo16(f[b][1]);
  a[2] = hi ? nib_hi16(f[b + 1][0]) : nib_lo16(f[b + 1][0]);
  a[3] = hi ? nib_hi16(f[b + 1][1]) : nib_lo16(f[b + 1][1]);
}

__host__ __device__ constexpr int step_k(int group, int q, int t) {
  return group == 32 ? 32 * q : group == 64 ? 64 * q + 32 * t : 64 * (t / 2) + 32 * (t % 2);
}

// The f32 sums of a consumer thread: fs its outputs' chain or window sum
// (MULTI: the closed windows' sum), wsum (MULTI) the open window's.
template <int NT, bool MULTI>
struct Sums {
  float fs[NT / 2];
  float wsum[MULTI ? NT / 2 : 1];
};

// gd = acc / 16 as a float, exactly, without the conversion unit (a
// quarter of the FMA rate): |acc| <= 16 * 8 * 128 * 128 < 2^22, so adding
// acc to the bits of 1.5 * 2^23 gives the float 1.5 * 2^23 + acc, and one
// fused multiply-add by 1/16 minus 1.5 * 2^19 leaves acc / 16 (every step
// exact). BIG (g > 128, one conversion a group of several stages): float(acc)
// rounded once, times 1/16, which is float(gd) rounded once as the oracle's
// f64 dot is (acc = 16 gd: the power of two commutes with the rounding).
template <bool BIG = false>
__device__ __forceinline__ float group_dot(int acc) {
  if constexpr (BIG) return __fmul_rn(__int2float_rn(acc), 0.0625f);
  return __fmaf_rn(__int_as_float(acc + 0x4B400000), 0.0625f, -786432.0f);
}

// The wgmma descriptor of a K-major tile of 64-byte rows with the 64B
// swizzle (x's two 64-k boxes of a stage at g > 128): 8-row atoms of 512
// bytes (SBO); LBO unused (1).
__device__ __forceinline__ uint64_t x_desc64(unsigned addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(512 >> 4) << 32) |
         ((uint64_t)2 << 62);
}

// Fold one group's dots (acc, 16 gd) into the sums with the scales of
// columns cb (sc.x) and cb + 1 (sc.y); `close` (MULTI): the group opens a
// window, so the open window's sum joins the closed ones first.
template <int NT, bool MULTI, bool BIG = false>
__device__ __forceinline__ void fold(const int (&acc)[NT / 2], Sums<NT, MULTI>& sm, float2 sc,
                                     int fold_mode, bool close) {
  // acc[4i + h] is column cb, acc[4i + 2 + h] column cb + 1
  if constexpr (MULTI) {
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      if (close) {
        sm.fs[j] = __fadd_rn(sm.fs[j], sm.wsum[j]);
        sm.wsum[j] = 0.f;
      }
      sm.wsum[j] =
          __fadd_rn(sm.wsum[j], __fmul_rn(group_dot<BIG>(acc[j]), j & 2 ? sc.y : sc.x));
    }
  } else if (fold_mode == kChain) {
#pragma unroll
    for (int j = 0; j < NT / 2; ++j)
      sm.fs[j] = __fmaf_rn(group_dot<BIG>(acc[j]), j & 2 ? sc.y : sc.x, sm.fs[j]);
  } else {
#pragma unroll
    for (int j = 0; j < NT / 2; ++j)
      sm.fs[j] = __fadd_rn(sm.fs[j], __fmul_rn(group_dot<BIG>(acc[j]), j & 2 ? sc.y : sc.x));
  }
}

// One stage of a consumer warpgroup at GROUP: for each of its groups, the
// group's products into `acc` (fresh), the wait, the fold. The next
// stage's raw words go into `nxt` while the stage's last group runs. The
// groups of the stage past the split's end (g1: a window's last stage may
// hold the next window's first groups, or k past K) run with a zero scale,
// so their fold adds +-0, which leaves a sum that is never -0 as it is:
// no branch around the products. The A registers and scales are pinned
// before the fence that precedes the products, and the scales are read
// before the products are issued, so once the last group's products are
// done every warp of the warpgroup is past its reads of the slot, which
// then goes back to the producer (one arrival a warpgroup).
template <int NT, int GROUP, bool MULTI>
__device__ __forceinline__ void run_stage(unsigned char* smem, uint64_t* full, uint64_t* empty,
                                          int s, int stages, int depth, int gs, int g1, int lo,
                                          int fold_mode, const i8w::Lane& l, int cb,
                                          int (&acc)[NT / 2], Sums<NT, MULTI>& sm,
                                          unsigned (&cur)[4][2], unsigned (&nxt)[4][2]) {
  constexpr int kStage = stage_bytes(NT), kXBytes = NT * kBK;
  constexpr int kGps = kBK / GROUP, kSteps = GROUP / 32;
  const unsigned char* st = smem + (size_t)(s % depth) * kStage;
  const unsigned xb = smem_u32(st);
#pragma unroll
  for (int q = 0; q < kGps; ++q) {
    unsigned a[kSteps][4];
#pragma unroll
    for (int t = 0; t < kSteps; ++t) step_regs(GROUP, q, t, cur, a[t]);
    float2 sc = *reinterpret_cast<const float2*>(st + kXBytes + kWBytes + 4 * (q * kBN + cb));
    const bool live = gs + q < g1;
    sc.x = live ? sc.x : 0.f;
    sc.y = live ? sc.y : 0.f;
    w4g::fence_reg(sc.x);
    w4g::fence_reg(sc.y);
#pragma unroll
    for (int t = 0; t < kSteps; ++t)
#pragma unroll
      for (int r = 0; r < 4; ++r) w4g::fence_reg(a[t][r]);
    w4g::wgmma_fence();
#pragma unroll
    for (int t = 0; t < kSteps; ++t)
      i8w::Mma<NT>::run(acc, a[t], w4g::x_desc(xb + step_k(GROUP, q, t)), t > 0);
    w4g::wgmma_commit();
    if (q == kGps - 1 && s + 1 < stages) {
      const int slot = (s + 1) % depth;
      mma8::mbar_wait_or_trap(full + slot, ((s + 1) / depth) & 1);
      load_raw(smem + (size_t)slot * kStage + kXBytes, l, nxt);
    }
    w4g::wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) i8w::fence_reg(acc[j]);
#pragma unroll
    for (int t = 0; t < kSteps; ++t)
#pragma unroll
      for (int r = 0; r < 4; ++r) w4g::fence_reg(a[t][r]);
    const int gi = gs + q;
    fold<NT, MULTI>(acc, sm, sc, fold_mode, MULTI && gi > 0 && (gi + lo) % kWindow == 0);
  }
  if (threadIdx.x % 128 == 0) mma8::mbar_arrive(empty + s % depth);
}

// The consumer warpgroups' walk over a split's groups [g0, g1).
template <int NT, int GROUP, bool MULTI>
__device__ __forceinline__ void consume(unsigned char* smem, uint64_t* full, uint64_t* empty,
                                        int stages, int depth, int g0, int g1, int lo,
                                        int fold_mode, int cb, int tid, Sums<NT, MULTI>& sm) {
  constexpr int kGps = kBK / GROUP;
  const i8w::Lane l = i8w::lane_of(cb, tid);
  int acc[NT / 2];
#pragma unroll
  for (int j = 0; j < NT / 2; ++j) acc[j] = 0;
  unsigned f0[4][2], f1[4][2];
  mma8::mbar_wait_or_trap(full, 0);
  load_raw(smem + NT * kBK, l, f0);
  for (int s = 0; s < stages; s += 2) {
    const int gs = g0 + s * kGps;
    run_stage<NT, GROUP, MULTI>(smem, full, empty, s, stages, depth, gs, g1, lo, fold_mode, l, cb,
                                acc, sm, f0, f1);
    if (s + 1 < stages)
      run_stage<NT, GROUP, MULTI>(smem, full, empty, s + 1, stages, depth, gs + kGps, g1, lo,
                                  fold_mode, l, cb, acc, sm, f1, f0);
  }
}

// The consumer warpgroups' walk over a split's groups [g0, g1) at g = 128 j
// (j >= 2): stage s is stage c = s % j of group g0 + s / j. Its four k32
// steps are the g 128 steps (step_regs), on x's low-nibble box (steps 0, 1)
// and high-nibble box (2, 3); the group's dot accumulates from its first
// step (scale-d 0) over its j stages and is folded after the last. The next
// stage's raw words are read while a stage's products run; its slot goes
// back to the producer once they are done.
// One stage s (stage c = s % spg of group gi = g0 + s / spg) at g > 128:
// its four products on `cur` into the group's dot, the next stage's raw
// words into `nxt` while they run, the wait, the slot's release, and after
// the group's last stage the fold.
template <int NT, bool MULTI>
__device__ __forceinline__ void run_stage_big(unsigned char* smem, uint64_t* full,
                                              uint64_t* empty, int s, int stages, int depth,
                                              int spg, int g0, int lo, int fold_mode,
                                              const i8w::Lane& l, int cb, int (&acc)[NT / 2],
                                              Sums<NT, MULTI>& sm, unsigned (&cur)[4][2],
                                              unsigned (&nxt)[4][2]) {
  constexpr int kStage = stage_bytes(NT), kXBytes = NT * kBK, kBox = NT * 64;
  const unsigned char* st = smem + (size_t)(s % depth) * kStage;
  const unsigned xb = smem_u32(st);
  const int c = s % spg, gi = g0 + s / spg;
  unsigned a[4][4];
#pragma unroll
  for (int t = 0; t < 4; ++t) step_regs(128, 0, t, cur, a[t]);
  float2 sc = *reinterpret_cast<const float2*>(st + kXBytes + kWBytes + 4 * cb);
  w4g::fence_reg(sc.x);
  w4g::fence_reg(sc.y);
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int r = 0; r < 4; ++r) w4g::fence_reg(a[t][r]);
  w4g::wgmma_fence();
#pragma unroll
  for (int t = 0; t < 4; ++t)
    i8w::Mma<NT>::run(acc, a[t], x_desc64(xb + (t / 2) * kBox + (t % 2) * 32), c > 0 || t > 0);
  w4g::wgmma_commit();
  if (s + 1 < stages) {
    const int slot = (s + 1) % depth;
    mma8::mbar_wait_or_trap(full + slot, ((s + 1) / depth) & 1);
    load_raw(smem + (size_t)slot * kStage + kXBytes, l, nxt);
  }
  w4g::wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < NT / 2; ++j) i8w::fence_reg(acc[j]);
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int r = 0; r < 4; ++r) w4g::fence_reg(a[t][r]);
  if (threadIdx.x % 128 == 0) mma8::mbar_arrive(empty + s % depth);
  if (c == spg - 1)
    fold<NT, MULTI, true>(acc, sm, sc, fold_mode, MULTI && gi > 0 && (gi + lo) % kWindow == 0);
}

// The consumer warpgroups' walk over a split's groups [g0, g1) at g = 128 j
// (j >= 2, `spg`): stage s is stage s % j of group g0 + s / j. Its four k32
// steps are the g 128 steps (step_regs), on x's low-nibble box (steps 0, 1)
// and high-nibble box (2, 3); the group's dot accumulates from its first
// step (scale-d 0) over its j stages and is folded after the last.
template <int NT, bool MULTI>
__device__ __forceinline__ void consume_big(unsigned char* smem, uint64_t* full, uint64_t* empty,
                                            int stages, int depth, int spg, int g0, int lo,
                                            int fold_mode, int cb, int tid,
                                            Sums<NT, MULTI>& sm) {
  const i8w::Lane l = i8w::lane_of(cb, tid);
  int acc[NT / 2];
#pragma unroll
  for (int j = 0; j < NT / 2; ++j) acc[j] = 0;
  unsigned f0[4][2], f1[4][2];
  mma8::mbar_wait_or_trap(full, 0);
  load_raw(smem + NT * kBK, l, f0);
  for (int s = 0; s < stages; s += 2) {  // stages = (groups) * spg: even
    run_stage_big<NT, MULTI>(smem, full, empty, s, stages, depth, spg, g0, lo, fold_mode, l, cb,
                             acc, sm, f0, f1);
    run_stage_big<NT, MULTI>(smem, full, empty, s + 1, stages, depth, spg, g0, lo, fold_mode, l,
                             cb, acc, sm, f1, f0);
  }
}

// Grid (n_split, column blocks, row_blocks), clusters of (n_split, 1, 1);
// kThreads threads; dynamic shared memory smem_bytes(NT, depth, n_split).
// x_map: x (M, K) int8, boxes of 128 k x NT rows (g > 128: 64 k, 64B
// swizzle); w_map (when w_tma): w's (K/2, N) bytes, boxes of kBN x kRows;
// s_map: s (K/g, N) f32, boxes of kBN x max(1, kBK / g). Row block z owns
// token rows [z rows, min(M, (z + 1) rows)), rows = ceil(M / row_blocks) <=
// NT.
template <int NT, bool MULTI>
__global__ void __launch_bounds__(kThreads, NT <= 32 ? 2 : 1)
w4a8_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                  const __grid_constant__ CUtensorMap w_map,
                  const __grid_constant__ CUtensorMap s_map, int w_tma,
                  const int8_t* __restrict__ w, const float* __restrict__ xs,
                  void* __restrict__ out, int out_bf16, int M, int K, int N, int group,
                  int row_blocks, int n_split, int fold_mode, int depth) {
  constexpr int kXBytes = NT * kBK;
  constexpr int kStage = stage_bytes(NT);
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzle's 1024-byte period (smem_bytes asks for the slack)
  unsigned char* smem = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  const size_t ring = (size_t)depth * kStage;
  const size_t red_bytes = n_split > 1 ? (size_t)NT * kRedPitch * 4 : 0;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + (ring > red_bytes ? ring : red_bytes));
  uint64_t* empty = full + depth;
  // groups a stage holds (g <= 128), or stages a group spans (g > 128)
  const int G = K / group, lo = window_lo(G), gps = group > kBK ? 1 : kBK / group;
  const int spg = group > kBK ? group / kBK : 1;
  const int split = blockIdx.x, n0 = blockIdx.y * kBN;
  const int rows = (M + row_blocks - 1) / row_blocks, m0 = blockIdx.z * rows;
  const int rows_here = min(rows, M - m0);
  int g0, g1;
  split_groups(fold_mode, G, split, g0, g1);
  const int stages = (g1 - g0 + gps - 1) / gps * spg;
  const int k0 = g0 * group;  // the split's first k
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
      unsigned char* st = smem + (size_t)slot * kStage;
      if (lane == 0) {
        mma8::mbar_arrive_expect_tx(full + slot,
                                    kXBytes + (w_tma ? kWBytes : 0) + gps * kBN * 4);
        if (spg > 1) {  // the stage's two 64-k runs
          int k_lo, k_hi;
          w4g::stage_k(g0 * spg + s, group, k_lo, k_hi);
          mma8::tma_box(st, &x_map, k_lo, m0, full + slot);
          mma8::tma_box(st + NT * 64, &x_map, k_hi, m0, full + slot);
        } else {
          mma8::tma_box(st, &x_map, k0 + s * kBK, m0, full + slot);
        }
        if (w_tma) mma8::tma_box(st + kXBytes, &w_map, n0, k0 / 2 + s * kRows, full + slot);
        mma8::tma_box(st + kXBytes + kWBytes, &s_map, n0, g0 + s / spg * gps, full + slot);
      }
      if (!w_tma)
        i8w::copy_weight_rows(st + kXBytes, w, n0, N, k0 / 2 + s * kRows, kRows, K / 2,
                              full + slot, lane);
    }
    if (!w_tma) mma8::cp_async_wait_all();
    if (n_split == 1) return;
  } else {
    // ---- the consumer warpgroups: 64 weight columns each, the block's
    // token rows
    const int wg = warp / 4, gid = lane / 4, tid = lane % 4;
    const int cb = 64 * wg + 16 * (warp % 4) + 2 * gid;  // this thread's columns cb, cb + 1
    Sums<NT, MULTI> sm;
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) sm.fs[j] = 0.f;
    if constexpr (MULTI) {
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) sm.wsum[j] = 0.f;
    }
    if (spg > 1)
      consume_big<NT, MULTI>(smem, full, empty, stages, depth, spg, g0, lo, fold_mode, cb, tid,
                             sm);
    else if (group == 32)
      consume<NT, 32, MULTI>(smem, full, empty, stages, depth, g0, g1, lo, fold_mode, cb, tid, sm);
    else if (group == 64)
      consume<NT, 64, MULTI>(smem, full, empty, stages, depth, g0, g1, lo, fold_mode, cb, tid, sm);
    else
      consume<NT, 128, MULTI>(smem, full, empty, stages, depth, g0, g1, lo, fold_mode, cb, tid,
                              sm);
    // fs[4i + h] is column cb, fs[4i + 2 + h] column cb + 1, of token row
    // 8i + 2tid + h of the block
    const int n = n0 + cb;
    if (n_split == 1) {
      if (n >= N) return;  // N % 4 == 0: cb even, so cb + 1 < N too
#pragma unroll
      for (int i = 0; i < NT / 8; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 8 * i + 2 * tid + h;
          if (r >= rows_here) continue;
          float v0 = sm.fs[4 * i + h], v1 = sm.fs[4 * i + 2 + h];
          if constexpr (MULTI) {
            v0 = __fadd_rn(v0, sm.wsum[4 * i + h]);
            v1 = __fadd_rn(v1, sm.wsum[4 * i + 2 + h]);
          }
          const float xm = xs[m0 + r];
          i8w::store2(out, (size_t)(m0 + r) * N + n, out_bf16, __fmul_rn(v0, xm),
                      __fmul_rn(v1, xm));
        }
      return;
    }
    i8w::consumers_sync();  // both warpgroups are past the ring
    float* red = reinterpret_cast<float*>(smem);  // [NT][kRedPitch]
#pragma unroll
    for (int i = 0; i < NT / 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(red + (8 * i + 2 * tid + h) * kRedPitch + cb) =
            make_float2(sm.fs[4 * i + h], sm.fs[4 * i + 2 + h]);
  }

  // ---- the cluster's reduction (window splits): block `split` adds the
  // window sums of token rows split, split + n_split, ... in window order
  // from +0
  i8w::cluster_sync();
  const unsigned red_addr = smem_u32(smem);
  const int mine = split < rows_here ? (rows_here - split + n_split - 1) / n_split : 0;
  for (int e = threadIdx.x; e < mine * (kBN / 4); e += kThreads) {
    const int r = split + e / (kBN / 4) * n_split, c4 = 4 * (e % (kBN / 4)), n = n0 + c4;
    if (n >= N) continue;  // N % 4 == 0
    const unsigned at = red_addr + (unsigned)(r * kRedPitch + c4) * 4u;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int z = 0; z < n_split; ++z) {
      const uint4 o = i8w::ld_cluster(at, (unsigned)z);
      v = make_float4(__fadd_rn(v.x, __uint_as_float(o.x)), __fadd_rn(v.y, __uint_as_float(o.y)),
                      __fadd_rn(v.z, __uint_as_float(o.z)), __fadd_rn(v.w, __uint_as_float(o.w)));
    }
    const float xm = xs[m0 + r];
    i8w::store4(out, (size_t)(m0 + r) * N + n, out_bf16,
                make_float4(__fmul_rn(v.x, xm), __fmul_rn(v.y, xm), __fmul_rn(v.z, xm),
                            __fmul_rn(v.w, xm)));
  }
  i8w::cluster_sync();  // no block leaves while another reads its tile
}

// The groups the kernel above reads x for as it lies (kernels/matmul.py
// float_scale_route "direct" under row 16's limits): w4g::group_ok, g <=
// 2^16 (its int32 group dot) and at most 32 x 32 groups (its folds).
inline bool direct_ok(int K, int group) {
  return w4g::group_ok(K, group) && group <= (1 << 16) && K / group <= kWindow * kWindow;
}

// Launch the GEMV on a (M, K) x (K/2, N) product, the plan of
// kernels/matmul.py w4a8_plan: nt token rows a block (wgmma's n), the rows
// in row_blocks blocks, n_split K splits (window splits only), the fold, a
// ring of `depth` stages. x and s must admit a tensor map (16-byte
// aligned); the weights take the cp.async feed where they do not.
cudaError_t launch(const void* x, const void* xs, const void* w, const void* s, void* out,
                   int M, int K, int N, int group, int out_bf16, int nt, int row_blocks,
                   int n_split, int fold_mode, int depth, cudaStream_t st) {
  if (M < 1 || N < 4 || N % 4 != 0 || !direct_ok(K, group) || row_blocks < 1 || nt < 1 ||
      nt > kMaxRows || i8w::tile_n(nt) != nt)
    return cudaErrorInvalidValue;
  const int G = K / group, gps = group > kBK ? 1 : kBK / group;
  const int spg = group > kBK ? group / kBK : 1;
  const int rows = (M + row_blocks - 1) / row_blocks;
  if (rows > nt || (row_blocks - 1) * rows >= M) return cudaErrorInvalidValue;
  const int windows = (G + kWindow - 1) / kWindow;
  const bool ok = fold_mode == kChain ? G <= kWindow && n_split == 1
                  : fold_mode == kWindowSplit
                      ? G > kWindow && windows <= i8w::kMaxSplit && n_split == windows
                      : fold_mode == kMulti && G > kWindow && n_split == 1 && nt <= 64;
  if (!ok) return cudaErrorInvalidValue;
  int most = 0;  // the stages of the longest split
  for (int z = 0; z < n_split; ++z) {
    int g0, g1;
    split_groups(fold_mode, G, z, g0, g1);
    const int stages = (g1 - g0 + gps - 1) / gps * spg;
    if (stages > most) most = stages;
  }
  // the next stage's weight rows are read before a stage's slot is
  // released: two slots unless a split streams one stage
  if (depth < 1 || (depth < 2 && most > 1)) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(nt, depth, n_split);
  if (smem > 232448) return cudaErrorInvalidValue;
  CUtensorMap xm = {}, wm = {}, sm = {};
  if (!mma8::tensor_map(&xm, CU_TENSOR_MAP_DATA_TYPE_UINT8, x, K, M, K, spg > 1 ? 64 : kBK, nt,
                        spg > 1 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B) ||
      !mma8::tensor_map(&sm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, s, N, G, 4ll * N, kBN, gps,
                        CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  const int w_tma = mma8::tensor_map(&wm, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, N, K / 2, N, kBN,
                                     kRows, CU_TENSOR_MAP_SWIZZLE_128B);
  const int n_tiles = (N + kBN - 1) / kBN;
  auto run = [&](auto kernel) -> cudaError_t {
    return i8w::launch_clusters(kernel, n_split, n_tiles, row_blocks, smem, st, xm, wm, sm, w_tma,
                                static_cast<const int8_t*>(w), static_cast<const float*>(xs),
                                out, out_bf16, M, K, N, group, row_blocks, n_split, fold_mode,
                                depth);
  };
  if (fold_mode == kMulti) {
    switch (nt) {
      case 8: return run(w4a8_wgmma_kernel<8, true>);
      case 16: return run(w4a8_wgmma_kernel<16, true>);
      case 32: return run(w4a8_wgmma_kernel<32, true>);
      case 48: return run(w4a8_wgmma_kernel<48, true>);
      default: return run(w4a8_wgmma_kernel<64, true>);
    }
  }
  switch (nt) {
    case 8: return run(w4a8_wgmma_kernel<8, false>);
    case 16: return run(w4a8_wgmma_kernel<16, false>);
    case 32: return run(w4a8_wgmma_kernel<32, false>);
    case 48: return run(w4a8_wgmma_kernel<48, false>);
    case 64: return run(w4a8_wgmma_kernel<64, false>);
    default: return run(w4a8_wgmma_kernel<96, false>);
  }
}


// ---- The permuted route: every group the reference takes that the kernel
// above does not (w4_wgmma.cuh group_ok), more than 32 x 32 groups, and g
// above 2^16 (kernels/matmul.py float_scale_route "permuted"). x arrives
// permuted into byte-row order (w4_wgmma.cuh permute_x): run r of xp (32
// columns) holds the low-nibble k of byte rows 16 r .. 16 r + 15, then their
// high-nibble k, so k32 step q of a stage (byte rows 16 q .. of its 64) is
// step_regs' g 32 step for every group: slot 4 tid + i (and 16 + 4 tid + i)
// of each register is byte row 16 q + 4 tid + i. A step holds pieces of the
// groups its 16 byte rows meet (g even: up to 16 / h + 2 of them, h = g /
// 2); each piece is one product on the step's registers with the other
// groups' bytes masked to zero, into the open group's int32 dot (scale-d 0
// on its first piece). A group's dot is folded after its last piece, in
// group order, as the kernel above folds: the oracle's order bit for bit.
// The register sets: a piece that closes its group waits for its products
// at once; the open piece of step q keeps its own set until the stage's
// last wait. A split (window splits: every 32 groups) starts on the 16-row
// run of its first group's first byte row and skips the pieces of groups
// outside it. Beyond 32 x 32 groups the fold is the oracle's deeper window
// tree (Tree, kTree: four levels up to 32^4 groups; beyond, kDeep, six: 32^6
// = 2^30 groups, every K below 2^31); above g = 2^16 (WIDE, any fold) a
// group's dot is widened into int64 at every stage's end (16 |partial| <=
// 16 * 128 * 8 * 128 a stage).
constexpr int kTree = 3;  // the fold beyond 32 x 32 groups (kernels/matmul.py W4A8_FOLDS)
constexpr int kDeep = 4;  // the kernel's KIND for kTree beyond 32^4 groups
constexpr int kTreeGroups = kWindow * kWindow * kWindow * kWindow;

// The oracle's window tree over the group products of R outputs (kernels/
// matmul.py _window_sum): at each level the terms padded with zeros to
// whole windows of 32 (the smaller half of the padding in front), each
// window summed in order from +0, the window sums the terms of the next
// level, up to a level of at most 32 terms (top) summed in order from +0.
// The padding adds +0, which moves no sum. The LEVELS levels are unrolled,
// so the sums stay in registers; the bookkeeping is the same in every thread.
template <int R, int LEVELS>
struct Tree {
  float lv[LEVELS][R];
  int cnt[LEVELS], lo[LEVELS], top;

  __device__ explicit Tree(int n) : top(0) {
#pragma unroll
    for (int l = 0; l < LEVELS; ++l) {
      cnt[l] = lo[l] = 0;
#pragma unroll
      for (int i = 0; i < R; ++i) lv[l][i] = 0.f;
    }
#pragma unroll
    for (int l = 0; l < LEVELS - 1; ++l) {
      if (n > kWindow) {
        const int windows = (n + kWindow - 1) / kWindow;
        lo[l] = (windows * kWindow - n) / 2;
        n = windows;
        top = l + 1;
      }
    }
  }

  // Add the terms v from level `from` up: a term that starts a window closes
  // the one before, whose sum goes up as the next level's term.
  __device__ __forceinline__ void push(float (&v)[R], int from) {
    bool go = true;
#pragma unroll
    for (int l = 0; l < LEVELS; ++l) {
      if (l < from || !go) continue;
      const int idx = cnt[l]++;
      const bool closes = l < top && idx > 0 && (idx + lo[l]) % kWindow == 0;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float up = lv[l][i];
        lv[l][i] = __fadd_rn(closes ? 0.f : up, v[i]);
        v[i] = up;
      }
      go = closes;
    }
  }

  // Close every level's last window; the sums are then level top's.
  __device__ __forceinline__ void finish(float (&out)[R]) {
#pragma unroll
    for (int l = 0; l < LEVELS - 1; ++l) {
      if (l >= top) continue;
      float v[R];
#pragma unroll
      for (int i = 0; i < R; ++i) v[i] = lv[l][i];
      push(v, l + 1);
    }
#pragma unroll
    for (int l = 0; l < LEVELS; ++l)
      if (l == top)
#pragma unroll
        for (int i = 0; i < R; ++i) out[i] = lv[l][i];
  }
};

// w4a8_wgmma_kernel's cluster reduction (window splits), which that kernel
// keeps inline (its served instances compile as they did): after the
// cluster barrier, block `split` adds the window sums (each block's tile at
// the start of its shared memory) of token rows split, split + n_split, ...
// in window order from +0, times xs; the second barrier keeps every block
// until the others have read its tile.
__device__ __forceinline__ void reduce_windows(unsigned char* smem, const float* xs, void* out,
                                               int out_bf16, int N, int n0, int m0,
                                               int rows_here, int split, int n_split) {
  i8w::cluster_sync();
  const unsigned red_addr = smem_u32(smem);
  const int mine = split < rows_here ? (rows_here - split + n_split - 1) / n_split : 0;
  for (int e = threadIdx.x; e < mine * (kBN / 4); e += kThreads) {
    const int r = split + e / (kBN / 4) * n_split, c4 = 4 * (e % (kBN / 4)), n = n0 + c4;
    if (n >= N) continue;  // N % 4 == 0
    const unsigned at = red_addr + (unsigned)(r * kRedPitch + c4) * 4u;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int z = 0; z < n_split; ++z) {
      const uint4 o = i8w::ld_cluster(at, (unsigned)z);
      v = make_float4(__fadd_rn(v.x, __uint_as_float(o.x)), __fadd_rn(v.y, __uint_as_float(o.y)),
                      __fadd_rn(v.z, __uint_as_float(o.z)), __fadd_rn(v.w, __uint_as_float(o.w)));
    }
    const float xm = xs[m0 + r];
    i8w::store4(out, (size_t)(m0 + r) * N + n, out_bf16,
                make_float4(__fmul_rn(v.x, xm), __fmul_rn(v.y, xm), __fmul_rn(v.z, xm),
                            __fmul_rn(v.w, xm)));
  }
  i8w::cluster_sync();
}

// The byte lanes of a register word (slot i: byte row 4 tid + i of the
// step) that lie in the piece's rows [a0, a1) of the step.
__device__ __forceinline__ unsigned piece_mask(int a0, int a1, int tid) {
  const int lo = min(max(a0 - 4 * tid, 0), 4), hi = min(max(a1 - 4 * tid, 0), 4);
  return (unsigned)((1ull << (8 * hi)) - 1) & ~(unsigned)((1ull << (8 * lo)) - 1);
}

// The f32 sums of a consumer thread on the permuted route: fs and wsum as
// Sums (chain, window, multi), or the window tree (KIND kTree, kDeep).
template <int NT, int KIND>
struct PermSums {
  static constexpr bool kTreeFold = KIND == kTree || KIND == kDeep;
  Sums<NT, KIND == kMulti> sm;
  Tree<kTreeFold ? NT / 2 : 1, KIND == kDeep ? 6 : 4> tree;
  __device__ explicit PermSums(int G) : tree(kTreeFold ? G : 1) {
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) sm.fs[j] = 0.f;
    if constexpr (KIND == kMulti) {
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) sm.wsum[j] = 0.f;
    }
  }

  // Fold group gi's dots gd (floats) with its columns' scales.
  __device__ __forceinline__ void fold(float (&gd)[NT / 2], float2 sc, int fold_mode, int gi,
                                       int lo) {
    if constexpr (kTreeFold) {
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) gd[j] = __fmul_rn(gd[j], j & 2 ? sc.y : sc.x);
      tree.push(gd, 0);
    } else if constexpr (KIND == kMulti) {
      const bool close = gi > 0 && (gi + lo) % kWindow == 0;
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        if (close) {
          sm.fs[j] = __fadd_rn(sm.fs[j], sm.wsum[j]);
          sm.wsum[j] = 0.f;
        }
        sm.wsum[j] = __fadd_rn(sm.wsum[j], __fmul_rn(gd[j], j & 2 ? sc.y : sc.x));
      }
    } else if (fold_mode == kChain) {
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) sm.fs[j] = __fmaf_rn(gd[j], j & 2 ? sc.y : sc.x, sm.fs[j]);
    } else {
#pragma unroll
      for (int j = 0; j < NT / 2; ++j)
        sm.fs[j] = __fadd_rn(sm.fs[j], __fmul_rn(gd[j], j & 2 ? sc.y : sc.x));
    }
  }

  // The block's sums: fs (plus the open window, or the tree's top).
  __device__ __forceinline__ void result(float (&out)[NT / 2]) {
    if constexpr (kTreeFold) {
      tree.finish(out);
    } else {
#pragma unroll
      for (int j = 0; j < NT / 2; ++j)
        out[j] = KIND == kMulti ? __fadd_rn(sm.fs[j], sm.wsum[j]) : sm.fs[j];
    }
  }
};

// Grid, clusters and shared memory as w4a8_wgmma_kernel's, a stage
// kXBytes + kWBytes + w4_wgmma.cuh perm_scale_bytes. x_map: xp (M,
// perm_cols(K)) int8, boxes of 128 k x NT rows (128B swizzle); s_map: s,
// boxes of kBN x perm_scale_box. KIND: kChain (chain and window folds),
// kMulti, kTree, kDeep.
template <int NT, int KIND, bool WIDE>
__global__ void __launch_bounds__(kThreads, NT <= 32 ? 2 : 1)
w4a8_perm_kernel(const __grid_constant__ CUtensorMap x_map,
                 const __grid_constant__ CUtensorMap w_map,
                 const __grid_constant__ CUtensorMap s_map, int w_tma,
                 const int8_t* __restrict__ w, const float* __restrict__ xs,
                 void* __restrict__ out, int out_bf16, int M, int K, int N, int group,
                 int row_blocks, int n_split, int fold_mode, int depth) {
  constexpr int kXBytes = NT * kBK;
  const int stage = kXBytes + kWBytes + w4g::perm_scale_bytes(K, group, kBN);
  const int s_rows = w4g::perm_scale_box(K, group);
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzle's 1024-byte period (smem_bytes asks for the slack)
  unsigned char* smem = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  const size_t ring = (size_t)depth * stage;
  const size_t red_bytes = n_split > 1 ? (size_t)NT * kRedPitch * 4 : 0;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + (ring > red_bytes ? ring : red_bytes));
  uint64_t* empty = full + depth;
  const int half = group / 2, G = K / group, lo = window_lo(G);
  const int split = blockIdx.x, n0 = blockIdx.y * kBN;
  const int rows = (M + row_blocks - 1) / row_blocks, m0 = blockIdx.z * rows;
  const int rows_here = min(rows, M - m0);
  int g0, g1;
  split_groups(fold_mode, G, split, g0, g1);
  // the split's 16-row runs: from its first group's first byte row's run
  const int r0 = g0 * half / 16, r1 = (g1 * half + 15) / 16;
  const int stages = (r1 - r0 + 3) / 4;
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
    // ---- the producer warp: stage s holds byte rows 16 r0 + 64 s .. + 63
    for (int s = 0; s < stages; ++s) {
      const int slot = s % depth, b0 = 16 * r0 + 64 * s;
      if (s >= depth) mma8::mbar_wait_or_trap(empty + slot, ((s / depth) - 1) & 1);
      unsigned char* st = smem + (size_t)slot * stage;
      if (lane == 0) {
        mma8::mbar_arrive_expect_tx(full + slot,
                                    kXBytes + (w_tma ? kWBytes : 0) + s_rows * kBN * 4);
        mma8::tma_box(st, &x_map, 2 * b0, m0, full + slot);
        if (w_tma) mma8::tma_box(st + kXBytes, &w_map, n0, b0, full + slot);
        mma8::tma_box(st + kXBytes + kWBytes, &s_map, n0, b0 / half, full + slot);
      }
      if (!w_tma)
        i8w::copy_weight_rows(st + kXBytes, w, n0, N, b0, kRows, K / 2, full + slot, lane);
    }
    if (!w_tma) mma8::cp_async_wait_all();
    if (n_split == 1) return;
  } else {
    // ---- the consumer warpgroups: 64 weight columns each, the block's
    // token rows
    const int wg = warp / 4, gid = lane / 4, tid = lane % 4;
    const int cb = 64 * wg + 16 * (warp % 4) + 2 * gid;  // this thread's columns cb, cb + 1
    const i8w::Lane l = i8w::lane_of(cb, tid);
    PermSums<NT, KIND> ps(G);
    // the group of the next step's first byte row and that row's place in
    // it, stepped a piece at a time (no division in the loop)
    int pg = 16 * r0 / half, pr = 16 * r0 % half;
    int acc[NT / 2];
    long long wide[WIDE ? NT / 2 : 1];
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) acc[j] = 0;
#pragma unroll
    for (int j = 0; j < (WIDE ? NT / 2 : 1); ++j) wide[j] = 0;
    bool fresh = true;  // the next product starts the open group's dot
    for (int s = 0; s < stages; ++s) {
      const int slot = s % depth, b0 = 16 * r0 + 64 * s, p0 = b0 / half;
      mma8::mbar_wait_or_trap(full + slot, (s / depth) & 1);
      const unsigned char* st = smem + (size_t)slot * stage;
      const unsigned xb = smem_u32(st);
      const float* ss = reinterpret_cast<const float*>(st + kXBytes + kWBytes);
      unsigned f[4][2];
      load_raw(st + kXBytes, l, f);
      unsigned open[4][4];  // the open piece's registers of each step, kept to the stage's end
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int r = 0; r < 4; ++r) open[q][r] = 0u;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        unsigned a[4];
        step_regs(32, q, 0, f, a);
        const uint64_t desc = w4g::x_desc(xb + 32 * q);
        // the step's pieces: rows [a0, a1) of group p, from row pr of it
        for (int a0 = 0; a0 < 16;) {
          const int p = pg, a1 = min(a0 + half - pr, 16);
          const bool closes = pr + (a1 - a0) == half;
          pr = closes ? 0 : pr + (a1 - a0);
          pg += closes;
          const int start = a0;
          a0 = a1;
          if (p < g0 || p >= g1) continue;  // another split's group, or rows past K/2
          const unsigned mk = piece_mask(start, a1, tid);
          if (!closes) {  // the group goes on past this step
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              open[q][r] = a[r] & mk;
              w4g::fence_reg(open[q][r]);
            }
            w4g::wgmma_fence();
            i8w::Mma<NT>::run(acc, open[q], desc, !fresh);
            fresh = false;
            break;  // the step's last piece
          }
          // the group's last piece: its products, the wait, the fold
          unsigned am[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            am[r] = a[r] & mk;
            w4g::fence_reg(am[r]);
          }
          float2 sc = *reinterpret_cast<const float2*>(ss + (p - p0) * kBN + cb);
          w4g::fence_reg(sc.x);
          w4g::fence_reg(sc.y);
          w4g::wgmma_fence();
          i8w::Mma<NT>::run(acc, am, desc, !fresh);
          w4g::wgmma_commit();
          w4g::wgmma_wait<0>();
#pragma unroll
          for (int j = 0; j < NT / 2; ++j) i8w::fence_reg(acc[j]);
#pragma unroll
          for (int r = 0; r < 4; ++r) w4g::fence_reg(am[r]);
          float gd[NT / 2];
#pragma unroll
          for (int j = 0; j < NT / 2; ++j) {
            if constexpr (WIDE) {
              gd[j] = __fmul_rn(__ll2float_rn(wide[j] + acc[j]), 0.0625f);
              wide[j] = 0;
            } else {
              gd[j] = group > kBK ? group_dot<true>(acc[j]) : group_dot<false>(acc[j]);
            }
          }
          ps.fold(gd, sc, fold_mode, p, lo);
          fresh = true;
        }
      }
      if (!fresh) {  // the open group's products read this slot: wait for them
        w4g::wgmma_commit();
        w4g::wgmma_wait<0>();
#pragma unroll
        for (int j = 0; j < NT / 2; ++j) i8w::fence_reg(acc[j]);
        if constexpr (WIDE) {
#pragma unroll
          for (int j = 0; j < NT / 2; ++j) wide[j] += acc[j];
          fresh = true;
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int r = 0; r < 4; ++r) w4g::fence_reg(open[q][r]);
      if (threadIdx.x % 128 == 0) mma8::mbar_arrive(empty + slot);
    }
    float fin[NT / 2];
    ps.result(fin);
    // fin[4i + h] is column cb, fin[4i + 2 + h] column cb + 1, of token row
    // 8i + 2tid + h of the block
    const int n = n0 + cb;
    if (n_split == 1) {
      if (n >= N) return;  // N % 4 == 0: cb even, so cb + 1 < N too
#pragma unroll
      for (int i = 0; i < NT / 8; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 8 * i + 2 * tid + h;
          if (r >= rows_here) continue;
          const float xm = xs[m0 + r];
          i8w::store2(out, (size_t)(m0 + r) * N + n, out_bf16, __fmul_rn(fin[4 * i + h], xm),
                      __fmul_rn(fin[4 * i + 2 + h], xm));
        }
      return;
    }
    i8w::consumers_sync();  // both warpgroups are past the ring
    float* red = reinterpret_cast<float*>(smem);  // [NT][kRedPitch]
#pragma unroll
    for (int i = 0; i < NT / 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(red + (8 * i + 2 * tid + h) * kRedPitch + cb) =
            make_float2(fin[4 * i + h], fin[4 * i + 2 + h]);
  }
  reduce_windows(smem, xs, out, out_bf16, N, n0, m0, rows_here, split, n_split);
}

// Launch the permuted route (the plan of kernels/matmul.py w4a8_plan, its
// fold kTree beyond 32 x 32 groups): x is first permuted into xp (M,
// perm_cols(K)) int8, 16-byte aligned.
cudaError_t launch_perm(const void* x, const void* xs, const void* w, const void* s, void* out,
                        void* xp, int M, int K, int N, int group, int out_bf16, int nt,
                        int row_blocks, int n_split, int fold_mode, int depth, cudaStream_t st) {
  if (M < 1 || N < 4 || N % 4 != 0 || !w4g::reference_group_ok(K, group) || row_blocks < 1 ||
      nt < 1 || nt > kMaxRows || i8w::tile_n(nt) != nt || xp == nullptr)
    return cudaErrorInvalidValue;
  const int G = K / group, half = group / 2, wide = group > (1 << 16);
  const int rows = (M + row_blocks - 1) / row_blocks;
  if (rows > nt || (row_blocks - 1) * rows >= M) return cudaErrorInvalidValue;
  const int windows = (G + kWindow - 1) / kWindow;
  const bool ok = fold_mode == kChain ? G <= kWindow && n_split == 1
                  : fold_mode == kWindowSplit
                      ? G > kWindow && windows <= i8w::kMaxSplit && n_split == windows
                  : fold_mode == kMulti ? G > kWindow && windows <= kWindow && n_split == 1 && nt <= 64
                  : fold_mode == kTree && windows > kWindow && n_split == 1 && nt <= 16;
  // beyond 32^4 groups (kDeep) and above g = 2^16 the tree takes 8 rows a
  // block, every other fold above 2^16 32 (their sums' registers)
  const bool deep = fold_mode == kTree && G > kTreeGroups;
  if (!ok || (fold_mode == kTree && (deep || wide) && nt > 8) || (wide && nt > 32))
    return cudaErrorInvalidValue;
  int most = 0;  // the stages of the longest split
  for (int z = 0; z < n_split; ++z) {
    int g0, g1;
    split_groups(fold_mode, G, z, g0, g1);
    const int runs = (g1 * half + 15) / 16 - g0 * half / 16;
    if ((runs + 3) / 4 > most) most = (runs + 3) / 4;
  }
  if (depth < 1 || (depth < 2 && most > 1)) return cudaErrorInvalidValue;
  const int stage = nt * kBK + kWBytes + w4g::perm_scale_bytes(K, group, kBN);
  const size_t ring = (size_t)depth * stage, red = n_split > 1 ? (size_t)nt * kRedPitch * 4 : 0;
  const size_t smem = (ring > red ? ring : red) + (size_t)depth * 16 + 1024;
  if (smem > 232448) return cudaErrorInvalidValue;
  cudaError_t err = w4g::permute_x<unsigned char>(x, xp, M, K, group, st);
  if (err != cudaSuccess) return err;
  CUtensorMap xm = {}, wm = {}, sm = {};
  if (!mma8::tensor_map(&xm, CU_TENSOR_MAP_DATA_TYPE_UINT8, xp, w4g::perm_cols(K), M,
                        w4g::perm_cols(K), kBK, nt, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !mma8::tensor_map(&sm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, s, N, G, 4ll * N, kBN,
                        w4g::perm_scale_box(K, group), CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  const int w_tma = mma8::tensor_map(&wm, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, N, K / 2, N, kBN,
                                     kRows, CU_TENSOR_MAP_SWIZZLE_128B);
  const int n_tiles = (N + kBN - 1) / kBN;
  auto run = [&](auto kernel) -> cudaError_t {
    return i8w::launch_clusters(kernel, n_split, n_tiles, row_blocks, smem, st, xm, wm, sm, w_tma,
                                static_cast<const int8_t*>(w), static_cast<const float*>(xs),
                                out, out_bf16, M, K, N, group, row_blocks, n_split, fold_mode,
                                depth);
  };
  if (wide) {
    if (fold_mode == kTree)
      return deep ? run(w4a8_perm_kernel<8, kDeep, true>) : run(w4a8_perm_kernel<8, kTree, true>);
    if (fold_mode == kMulti) {
      switch (nt) {
        case 8: return run(w4a8_perm_kernel<8, kMulti, true>);
        case 16: return run(w4a8_perm_kernel<16, kMulti, true>);
        default: return run(w4a8_perm_kernel<32, kMulti, true>);
      }
    }
    switch (nt) {
      case 8: return run(w4a8_perm_kernel<8, kChain, true>);
      case 16: return run(w4a8_perm_kernel<16, kChain, true>);
      default: return run(w4a8_perm_kernel<32, kChain, true>);
    }
  }
  if (fold_mode == kTree) {
    if (deep) return run(w4a8_perm_kernel<8, kDeep, false>);
    if (nt == 8) return run(w4a8_perm_kernel<8, kTree, false>);
    return run(w4a8_perm_kernel<16, kTree, false>);
  }
  if (fold_mode == kMulti) {
    switch (nt) {
      case 8: return run(w4a8_perm_kernel<8, kMulti, false>);
      case 16: return run(w4a8_perm_kernel<16, kMulti, false>);
      case 32: return run(w4a8_perm_kernel<32, kMulti, false>);
      case 48: return run(w4a8_perm_kernel<48, kMulti, false>);
      default: return run(w4a8_perm_kernel<64, kMulti, false>);
    }
  }
  switch (nt) {
    case 8: return run(w4a8_perm_kernel<8, kChain, false>);
    case 16: return run(w4a8_perm_kernel<16, kChain, false>);
    case 32: return run(w4a8_perm_kernel<32, kChain, false>);
    case 48: return run(w4a8_perm_kernel<48, kChain, false>);
    case 64: return run(w4a8_perm_kernel<64, kChain, false>);
    default: return run(w4a8_perm_kernel<96, kChain, false>);
  }
}

}  // namespace w4h
}  // namespace ff

// x (M, K) int8 (16-byte aligned), xs (M,) f32, w (K/2, N) pack_int4,
// w_scale (K/g, N) f32 (16-byte aligned), out (M, N) f32 or bf16; any group
// the reference takes (g even, K a whole number of groups); xp (M,
// w4g::perm_cols(K)) int8 scratch on the permuted route (the groups
// direct_ok does not take), else null; nt, row_blocks, n_split, fold (0
// chain, 1 window splits, 2 every window in one block, 3 the window tree)
// and depth from kernels/matmul.py w4a8_plan.
extern "C" int ff_w4a8_gemv_halves(const void* x, const void* xs, const void* w,
                                   const void* w_scale, void* out, void* xp, int M, int K, int N,
                                   int group, int out_bf16, int nt, int row_blocks, int n_split,
                                   int fold, int depth, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!ff::w4h::direct_ok(K, group))
    return ff::w4h::launch_perm(x, xs, w, w_scale, out, xp, M, K, N, group, out_bf16, nt,
                                row_blocks, n_split, fold, depth, st);
  return ff::w4h::launch(x, xs, w, w_scale, out, M, K, N, group, out_bf16, nt, row_blocks,
                         n_split, fold, depth, st);
}
