// The two-level int4 GEMVs on int8 tensor cores: the tile of w4a8_gemv.cu's
// ff_w4a8_gemv (paired layout), ff_w4a8_gemv_unpaired (group halves),
// ff_w4a8_gemv_argmax (paired, an argmax epilogue) and the stacked GEMV's
// six routes (ff_w4a8_gemv_stacked, _preblocked, _manual, _splitw,
// _dotraw, _concat: flat or pre-blocked paired layers), of a4_gemv.cu's
// ff_a4_gemv (the vertical W4A4 layout), the product of fused_head.cu's
// two layer heads (ff_fused_norm_qkv paired, ff_fused_norm_qkv_a4
// vertical) and the three products of fused_tail.cu's layer tail
// (ff_fused_o_mlp, ff_fused_o_gu: paired, partials to its own epilogues).
//
// Replaces: fastforward_tpu/kernels/matmul.py matmul_w4a8_2l_gemv (:571;
// paired body :537, group-halves body :479, pallas_call :620),
// matmul_w4a8_2l_gemv_stacked (:1023: default body :815, manual-DMA kernel
// :879 called at :1107, split-W kernel :989, dot-raw body :949,
// concat-pairs body :780), matmul_w4a8_2l_gemv_argmax (:708, kernel :650,
// pallas_call :744) and matmul_w4a4_2l_gemv_stacked (:1406, body :1342).
//   acc[m, n] = sum_k x[m, k] * (m_g[n] * v[k, n])        (int32, exact)
//   y[m, n]   = (float(acc) * s_col[n]) * x_scale[m]      (f32 or bf16)
// with v in [-8, 7] stored as nibbles (offset binary u = v + 8 in the W4A8
// layouts, two's complement in the vertical one) and m_g in [1, 15]; x
// int8 (W4A8) or int4 values in int8 (W4A4). The int32 sum is exact in any
// order (|acc| <= 128 * 120 * K < 2^31 for K <= 14336), so the tile is
// bit-equal to matmul_w4a8_2l_reference and matmul_w4a4_2l_reference. The
// argmax epilogue reduces y, the value the f32 store would write, to one
// (max, first index) pair a row and block; argmax_reduce_kernel reduces
// the pairs: the ids of torch.argmax over the f32 logits.
//
// Two kernels. w4a8_mma_kernel, "the tile", takes every shape where a
// unit's byte rows a plane are a multiple of 4 (paired g % 4 == 0,
// vertical and group halves g % 8 == 0) and N % 4 == 0.
// w4a8_rows_kernel, "the any-group route", takes every other group and
// width the references take, on the same int8 tensor cores (the entries
// *_any: ff_a4_gemv_any, ff_w4a8_gemv_any, ff_w4a8_gemv_unpaired_any,
// ff_w4a8_gemv_stacked_any, and the fused heads' and tail's products at
// those groups); kernels/matmul.py two_level_route picks by shape. The
// design notes below are the tile's; "The any-group route" says where the
// second kernel differs.
//
// Bound on the H100: Llama-3-8B's lm_head at M = 192 does 2.0e11 int8
// operations (0.10 ms at 1,979 TOP/s) on 263 MB of packed weights (0.08
// ms); a decoder layer's projections 8.4e10 (0.042 ms) on 110 MB. The dp4a
// tile these entries ran before (deleted once the layer tail left it) sat
// at the CUDA cores' dp4a rate, ~30x those bounds; int8 mma.sync runs 6.2x
// dp4a on this card (PERF.md, row 24's probe).
//
// Design:
// - Fold. The TPU kernels fold each group's multiplier into the nibbles in
//   registers and feed int8 bytes to the matrix unit. Here too: per 32-bit
//   word (4 nibble pairs of one column) and nibble plane p,
//     ((p & 0x0F0F0F0F) * m + (0x80808080 - 8m * 0x01010101)) ^ 0x80808080
//   is the int8 pattern of m * v in every byte: u * m <= 225 and
//   m * v + 128 in [8, 233] never carry across bytes (one AND, one IMAD,
//   one XOR a plane). The paired layout takes m_2p for its low plane and
//   m_2p+1 for its high one, the group-halves and vertical layouts m_g for
//   both. The vertical layout's two's-complement nibbles become offset
//   binary by flipping bit 3 of each (one XOR a word, 0x88888888), so the
//   same fold follows. The JAX body multiplies each group's int32 dot by
//   its multiplier instead; that needs a second accumulator set, and the
//   tile is at its 128 registers: folding is exact, so it is the same sum.
// - Products. mma.sync.m16n8k32.s8.s8.s32. A k-step is 32 "slots" of one
//   nibble plane: slot 16h + 4t + i is the byte row 16h + 2t + (i & 1) +
//   8 (i >> 1) of a 32-row chunk, so a lane (gid, t) reads 4 rows of its
//   column word and one 4x4 byte transpose gives the B register of slots
//   4t..4t+3; the 4 lanes of a column read rows 2 apart, which the 128B
//   swizzle puts in 4 distinct 16-byte chunks (no bank conflict). A warp
//   owns 32 columns (4 n8 tiles; mma column c of tile j is column 4c + j)
//   and every activation row of the block: the fold of a weight word feeds
//   MT m16 tiles. A block owns 16 * MT rows (MT = 1, 2 or 4: 16, 32 or 64;
//   at M = 8 the 8 activation rows are padded to 16 rather than swapped to
//   the n side: the folds, not the products, bound small M) and kN = 128
//   columns, so at M = 192 a weight byte leaves device memory for 3 blocks,
//   which run side by side (the m tile is the grid's fastest index) and
//   meet it in L2. Three blocks an SM (128 registers a thread; at MT = 4 a
//   few bytes spill) measured 8% faster at M = 192 than two at 155.
// - Activations in fragment order. A first launch (stage_x_kernel), or the
//   fused heads' prologue row by row (stage_row), writes x as the A
//   fragments of every stage, each lane's 16 bytes contiguous in
//   slot order, nibble planes apart, zeros for padding rows and rows past
//   M; the tile then reads one 16-byte word a fragment. In the vertical
//   layout a plane's byte rows are every other k (byte row i of group u:
//   k = ug + 2i low, ug + 2i + 1 high): 32 contiguous bytes of x are
//   de-interleaved by __byte_perm into the two planes' 16.
// - Groups shorter than 16 rows a plane (paired group % 16 != 0, or group
//   halves) are padded to 16 byte rows with zero activations, so the 4 rows
//   of a word always share one multiplier; the padding rows' weights are
//   never copied and multiply zeros.
// - The feed: Hopper's DMA ring. One producer warp streams each stage (kR
//   padded byte rows) into a ring of `depth` shared-memory stages, each
//   with a full and an empty mbarrier; four consumer warps wait on a
//   stage's full barrier, run the fold and the products on it and arrive
//   on its empty barrier, and the producer refills the stage when all four
//   have. A stage holds the block's kN columns of its weight rows, the
//   multiplier rows of its units (so a unit change costs no trip to L2)
//   and its activation fragments. The weight rows come as one 2-D TMA box
//   (kN x kR bytes, 128B swizzle) of a tensor map over the flat (K/2, N)
//   or the pre-blocked (N/bn * K/2, bn) bytes, encoded on the host by
//   cuTensorMapEncodeTiled (reached through cudaGetDriverEntryPoint:
//   nothing more to link); the multiplier rows and
//   the fragments as cp.async.bulk copies; all counted by the full
//   barrier's transaction count. One 8 KB request a stage: a first version
//   copied each 128-byte weight row by its own bulk copy, and the TMA
//   unit's per-request cost held it to ~0.8 TB/s (PERF.md §7). Where
//   the box does not fit (N or bn % 16 != 0, a block's columns across
//   panels, groups padded to 16 rows) the producer's lanes copy 4-byte
//   words by cp.async to their swizzled places and arrive on the full
//   barrier when they land (cp.async.mbarrier.arrive.noinc).
// - Split-K only where the tiles are too few to fill the card (w4a8_gemv's
//   plan, kernels/matmul.py mma_plan): splits cover whole units, write
//   int32 partials, and common.cuh's epilogue adds them in split order.
//   With one split the epilogue runs in the tile:
//   __fmul_rn(__fmul_rn(__int2float_rn(acc), s_col[n]), x_scale[m]).
//   Output kind kOutPartials (fused_tail.cu) writes every split's partial,
//   a single split's too, and runs no epilogue: the caller's next kernel
//   adds them with its own (a residual add or fused multiply-add, SiLU).
// - The argmax epilogue (ARGMAX, paired): with one split the f32 logits
//   never leave registers. A row's 8 columns in a lane, then its 4 lanes
//   (shuffles), then the 4 consumer warps (shared memory: stage 0 of the
//   ring, free once every consumer warp is past its last stage) give the
//   block's (max, first index) pair under common.cuh's `better`; split
//   partials take common.cuh's argmax epilogue instead.
//
// The any-group route (w4a8_rows_kernel, launch_rows). It replaces a
// CUDA-core loop (dp4a on folded words, x gathered byte by byte into
// shared memory once per 32-row run and row block, weights by synchronous
// 4-byte loads, multipliers re-read from global memory at every group
// change, int64 shared-memory atomics; 60-70x its bound at down_proj g 14,
// PERF.md §6). The padding above would cost 16 / 7 of the products at a
// vertical g of 14 and 4-16x at g <= 4, and an odd vertical group puts a
// byte row's two nibbles in different groups, so this route pads nothing:
// - Byte rows in memory order. A split covers rps byte rows (whole kR-row
//   stages; RowsPlan, kernels/matmul.py rows_plan); slot 4 t + i of half h
//   of a stage's chunk c is byte row 32 c + 16 h + 4 t + i, so a lane
//   reads 4 consecutive rows of its column word (the swizzle puts rows 4t
//   and 4t + 8 in one bank: 2-way conflicts) and a stage is kR contiguous
//   rows: the tile's TMA box, with no padding rows to skip.
// - x staged once a call in that order (stage_rows_kernel: a thread a
//   32-bit fragment word, the k of each slot from the layout, slot_k;
//   vertical rows as the even or odd bytes of one 8-byte load), zeros past
//   the split's rows and past M. The fused heads and tail write their int8
//   rows unstaged and stage them by the same launch.
// - The fold. Each stage brings the multiplier rows of every group its
//   rows meet (int8 group rows, or packed words of 8 groups). A word's 4
//   rows are aligned to 4 (splits and stages start on multiples of 64), so
//   they meet at most two groups a plane wherever a unit has >= 2 rows
//   (paired g >= 2, group halves g >= 4, vertical g = 4 or >= 6:
//   RowsPlan.pairs). Then fold2 folds the plane once with the first row's
//   multiplier and once with the last row's, and takes the bytes past the
//   first group's rows from the second (d * m + 0x80808080 with d the
//   signed nibbles as packed bytes: the tile's fold with its bias folded
//   into d, carry-free by the same argument); 6 instructions a plane word
//   where the tile takes 3. Elsewhere (paired g 1, group halves g 2,
//   vertical g 1, 2, 3, 5) each slot is folded with its own row's
//   multiplier. Rows past the split multiply zero activations; their
//   groups are clamped to the split's last row.
// - Exactness. A split adds at most kMaxSplitRows byte rows in int32
//   (|acc| <= 65,536 * 2 * 128 * 120 < 2^31); the plan splits K further
//   where it must. One split: the tile's epilogue in registers
//   (__int2float_rn of the int32 sum, the value __ll2float_rn gives); more:
//   int32 partials, summed in int64 by rows_epilogue_kernel, then
//   __ll2float_rn and the two products; kOutPartials writes each split's
//   int32 partial for the fused tail's row kernels, as on the tile.
// - Width. The producer fills a stage by the tile's TMA box and bulk
//   copies where rows are 16-byte runs (N % 16 == 0, a pre-blocked panel
//   a multiple of kN), else by 4-byte cp.async (N % 4 == 0, bn % 4 == 0),
//   else byte by byte (N % 4 != 0 or bn % 4 != 0); the consumers read
//   the same swizzled stage whatever filled it. The epilogue stores 16
//   bytes only where N % 4 == 0.
// - Splits. Two blocks an SM; kernels/matmul.py rows_plan picks the K
//   splits whose blocks the SMs finish first when they take them in turns
//   (a partial last wave costs a whole block's time: at down_proj g 14, M
//   = 192, 4 splits beat the tile's rule of 3 by a fifth). Bound: that
//   shape's 2.3e10 int8 operations, 0.0114 ms at 1,979 TOP/s.

#pragma once

#include <cstdint>
#include <mutex>
#include <cuda.h>  // CUtensorMap (the encoder is reached through cudaGetDriverEntryPoint)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"  // unit layouts, panel_col, mbarrier init, the split-K epilogue
#include "mma.cuh"     // cp_async, transpose4x4, store8

namespace ff {
namespace mma8 {

constexpr int kR = 64;                        // padded byte rows a ring stage holds
constexpr int kChunks = kR / 32;              // 32-row chunks (two k-steps each) a stage
constexpr int kN = 128;                       // columns a block owns
constexpr int kConsumers = 4;                 // consumer warps (32 columns each)
constexpr int kThreads = 32 * (kConsumers + 1);  // and the producer warp
constexpr int kFrag = 512;                    // bytes of one m16 x k32 int8 A fragment
constexpr int kMulSlot = 4 * kN;              // shared bytes of one unit's multipliers
constexpr int kUnitsPerStage = kR / 16;       // a stage meets at most this many units
constexpr int kWBytes = kR * kN;              // weight rows, 128B-swizzled
constexpr int kMBytes = kUnitsPerStage * kMulSlot;
// What the tile writes: y as f32 or bf16, or (kOutPartials) the int32
// partial of every split, one split included, with no epilogue.
constexpr int kOutF32 = 0, kOutBf16 = 1, kOutPartials = 2;

__host__ __device__ constexpr int a_stage_bytes(int mt) { return kChunks * 2 * mt * kFrag; }
// (a multiple of 1024 bytes: every stage's weight rows start on the
// swizzle pattern's 1024-byte period)
__host__ __device__ constexpr int stage_bytes(int mt) { return kWBytes + kMBytes + a_stage_bytes(mt); }
// m16 tiles a block owns at M rows (kernels/matmul.py mma_tiles).
__host__ __device__ constexpr int tiles_of(int M) { return M <= 16 ? 1 : M <= 32 ? 2 : 4; }

// The split plan, derived from the launch's n_split the same way on the
// host, in the kernels and in kernels/matmul.py mma_plan.
struct Plan {
  int unit_rows;  // byte rows of one unit: a group pair (paired) or a group
  int p16;        // unit_rows padded to a multiple of 16
  int n_units;
  int ups;        // units a split covers (the last split fewer)
  int stages;     // ring stages a split streams: ceil(ups * p16 / kR)
};

__host__ __device__ inline Plan plan_of(int layout, int K, int group, int n_split) {
  Plan p;
  p.unit_rows = layout == kPaired ? group : group / 2;
  p.n_units = layout == kPaired ? K / (2 * group) : K / group;
  p.p16 = (p.unit_rows + 15) / 16 * 16;
  p.ups = (p.n_units + n_split - 1) / n_split;
  p.stages = (p.ups * p.p16 + kR - 1) / kR;
  return p;
}

// First k of nibble plane `plane` of unit u: byte row i of the unit holds
// k = plane_k + i * plane_step in that plane (vertical: k = ug + 2i + plane).
__host__ __device__ inline int plane_k(int layout, int u, int plane, int group) {
  return layout == kPaired   ? (2 * u + plane) * group
         : layout == kHalves ? u * group + plane * (group / 2)
                             : u * group + plane;
}
__host__ __device__ constexpr int plane_step(int layout) { return layout == kVertical ? 2 : 1; }

// Wait until every cp.async this thread has issued has landed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// mbar_wait that gives up: a phase that has not completed after ~2^34
// cycles (seconds) traps, so a fault in the ring's accounting fails the
// launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait_or_trap(uint64_t* bar, unsigned parity) {
  const long long t0 = clock64();
  for (;;) {
    unsigned done;
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P1;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// One bulk copy of `bytes` (a multiple of 16; both addresses 16-byte
// aligned) from global to shared memory, completing on `bar`'s
// transaction count.
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src, unsigned bytes,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// One 2-D TMA box (kN columns x kR rows of `tmap`, 128B-swizzled) at
// column c, row r into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* tmap, int c, int r,
                                        uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(tmap)), "r"(c), "r"(r),
      "r"(smem_u32(bar))
      : "memory");
}

// Byte offset of column c of weight row r in a stage: the 128B swizzle puts
// the row's 16-byte chunk j at chunk j ^ (r % 8).
__host__ __device__ constexpr int swz(int r, int c) {
  return r * kN + (((c / 16) ^ (r % 8)) << 4) + c % 16;
}

// c += a . b on one 16 x 8 tile, int8, k = 32 (not volatile: the compiler
// may interleave the products with the next chunk's loads).
__device__ __forceinline__ void mma16832(int c[4], const uint4& a, unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// The fold of one nibble plane p (bytes in [0, 15]) by multiplier m with
// bias = 0x80808080 - m * 0x08080808: the int8 bytes m * (p - 8).
__device__ __forceinline__ unsigned fold(unsigned p, unsigned m, unsigned bias) {
  return (p * m + bias) ^ 0x80808080u;
}

// x (M, K) to the fragments of every (m tile, split, stage): fragment f =
// ((((m_tile * n_split + split) * stages + s) * kChunks + c) * 2 + plane)
// * mt + t holds rows 16 t.. of the m tile and the 32 slots of chunk c of
// stage s in nibble plane `plane`; lane l's 16 bytes at 16 l are its a[0..3]
// (mma.cuh load_a_s8's order), slot 4 t + i of a 16-slot half being the
// half's byte row 2t + (i & 1) + 8 (i >> 1) (the tile's B order). One
// thread a (fragment, row, half): 16 consecutive byte rows of one unit are
// 16 consecutive k of x, or every other k of 32 (vertical).
template <int LAYOUT>
__global__ void stage_x_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ xf, int M,
                               int K, int group, int n_split, int mt, long long total) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const Plan pl = plan_of(LAYOUT, K, group, n_split);
  const int r16 = (int)(t % 32) / 2, h = (int)(t % 2);
  long long f = t / 32;
  const int ti = (int)(f % mt);
  long long g = f / mt;
  const int plane = (int)(g % 2);
  g /= 2;
  const int c = (int)(g % kChunks);
  g /= kChunks;
  const int s = (int)(g % pl.stages);
  g /= pl.stages;
  const int split = (int)(g % n_split);
  const int m_tile = (int)(g / n_split);
  const int m = (m_tile * mt + ti) * 16 + r16;
  const int q = s * kR + 32 * c + 16 * h;  // first padded row of the half, in the split
  const int u = split * pl.ups + q / pl.p16, i0 = q % pl.p16;
  const int u_end = min(pl.n_units, (split + 1) * pl.ups);
  unsigned wd[4] = {0u, 0u, 0u, 0u};  // wd[i] byte b: byte row i0 + 4i + b
  constexpr int kStep = plane_step(LAYOUT);
  if (m < M && u < u_end) {
    const int8_t* xr = x + (size_t)m * K + plane_k(LAYOUT, u, plane, group) + kStep * i0;
    // byte rows i0.. of both planes (vertical) or of this one
    const int8_t* run = xr - (kStep == 2 ? plane : 0);
    if (i0 + 16 <= pl.unit_rows && reinterpret_cast<uintptr_t>(run) % 16 == 0) {
      const uint4 v = *reinterpret_cast<const uint4*>(run);
      if constexpr (kStep == 2) {
        // the plane's bytes of 32: even bytes (plane 0) or odd ones
        const uint4 v2 = *reinterpret_cast<const uint4*>(run + 16);
        const unsigned sel = plane ? 0x7531u : 0x6420u;
        wd[0] = __byte_perm(v.x, v.y, sel);
        wd[1] = __byte_perm(v.z, v.w, sel);
        wd[2] = __byte_perm(v2.x, v2.y, sel);
        wd[3] = __byte_perm(v2.z, v2.w, sel);
      } else {
        wd[0] = v.x;
        wd[1] = v.y;
        wd[2] = v.z;
        wd[3] = v.w;
      }
    } else {
      for (int b = 0; b < 16 && i0 + b < pl.unit_rows; ++b)
        wd[b / 4] |= static_cast<unsigned>(static_cast<uint8_t>(xr[kStep * b])) << (8 * (b % 4));
    }
  }
  // slot 4 tid + i of the half is its byte row 2 tid + (i & 1) + 8 (i >> 1)
  const int gid = r16 % 8, reg = 2 * h + r16 / 8;
  unsigned* frag = reinterpret_cast<unsigned*>(xf + (size_t)f * kFrag);
#pragma unroll
  for (int tid = 0; tid < 4; ++tid)
    frag[(4 * gid + tid) * 4 + reg] =
        __byte_perm(wd[tid / 2], wd[2 + tid / 2], tid % 2 ? 0x7632 : 0x5410);
}

// Row m's words of the staged activations, in stage_x_kernel's order, by
// the threads of one block (the fused heads' prologue and the fused tail's
// row kernels, which stage their own quantized rows: no staging launch).
// xr: the row's K bytes (any memory space), or null for a padding row
// (zeros). Word (split, stage s, chunk c, plane, half h, tid) holds byte
// rows i0 + 2 tid + {0, 1, 8, 9} of the half's unit (zeros for padding
// and rows past the split's units) at lane 4 gid + tid, register 2 h + r16
// / 8 of fragment f, as stage_x_kernel's __byte_perm of its 16 rows puts
// them.
template <int LAYOUT>
__device__ void stage_row(const int8_t* xr, int8_t* __restrict__ xf, int m, int K, int group,
                          int n_split, int mt) {
  const Plan pl = plan_of(LAYOUT, K, group, n_split);
  constexpr int kStep = plane_step(LAYOUT);
  const int m_tile = m / (16 * mt), ti = m % (16 * mt) / 16, r16 = m % 16;
  const int words = n_split * pl.stages * kChunks * 16;
  for (int wi = threadIdx.x; wi < words; wi += blockDim.x) {
    const int tid = wi % 4, h = wi / 4 % 2, plane = wi / 8 % 2;
    int g = wi / 16;
    const int c = g % kChunks;
    g /= kChunks;
    const int s = g % pl.stages, split = g / pl.stages;
    const int q = s * kR + 32 * c + 16 * h;  // first padded row of the half, in the split
    const int u = split * pl.ups + q / pl.p16, i0 = q % pl.p16;
    unsigned word = 0;
    if (xr != nullptr && u < min(pl.n_units, (split + 1) * pl.ups)) {
      const int8_t* xp = xr + plane_k(LAYOUT, u, plane, group);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int i = i0 + 2 * tid + (b & 1) + 8 * (b >> 1);
        if (i < pl.unit_rows)
          word |= static_cast<unsigned>(static_cast<uint8_t>(xp[kStep * i])) << (8 * b);
      }
    }
    const long long f =
        ((((long long)m_tile * n_split + split) * pl.stages + s) * kChunks + c) * 2 + plane;
    reinterpret_cast<unsigned*>(xf + (size_t)(f * mt + ti) * kFrag)[(4 * (r16 % 8) + tid) * 4 +
                                                                    2 * h + r16 / 8] = word;
  }
}

// The consumer warps' barrier (named barrier 1; the producer warp has left).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kConsumers) : "memory");
}

// The tile. Grid (m tiles, n tiles, n_split), kThreads threads, dynamic
// shared memory smem_bytes(MT, depth). Weights flat (K/2, N) (bn 0) or
// pre-blocked (N/bn, K/2, bn); mult int8 (K/g, N) or, PACKED, nibble-packed
// int32 (n_pack, N). tma: the weights come as `tmap`'s boxes (flat: the
// (N, K/2) bytes; pre-blocked: the (bn, N/bn * K/2) bytes, bn % kN == 0),
// else by 4-byte cp.async. n_split > 1 or out_kind kOutPartials: int32
// partials (n_split, M, N) for common.cuh's epilogue or the caller's; else
// y as f32 (out_kind kOutF32) or bf16 (kOutBf16), or with ARGMAX
// the (max, first index) pair of each row over the block's columns in
// pair_val, pair_idx (M, n tiles).
template <int LAYOUT, bool PACKED, int MT, bool ARGMAX>
__global__ void __launch_bounds__(kThreads, 3)
w4a8_mma_kernel(const __grid_constant__ CUtensorMap tmap, int tma,
                const int8_t* __restrict__ xf, const float* __restrict__ xs,
                const int8_t* __restrict__ w, const void* __restrict__ mult,
                const float* __restrict__ s_col, int32_t* __restrict__ partial,
                void* __restrict__ out, int out_kind, int M, int K, int N, int group,
                int n_split, int bn, int depth, float* __restrict__ pair_val,
                int* __restrict__ pair_idx) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzle's 1024-byte period (smem_bytes asks for the slack)
  unsigned char* smem = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  const Plan pl = plan_of(LAYOUT, K, group, n_split);
  constexpr int kStage = stage_bytes(MT);
  constexpr int kABytes = a_stage_bytes(MT);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + (size_t)depth * kStage);
  uint64_t* empty = full + depth;
  const int m_tile = blockIdx.x, n_tile = blockIdx.y, split = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int pitch = bn > 0 ? bn : N;  // bytes between byte rows
  const int u0 = split * pl.ups, u_end = min(pl.n_units, u0 + pl.ups);
  const int c0 = n_tile * kN;
  if (threadIdx.x == 0) {
    for (int s = 0; s < depth; ++s) {
      // tma: the producer's one arrival; else also its 32 lanes' cp.async ones
      mbar_init(full + s, tma ? 1 : 33);
      mbar_init(empty + s, kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == kConsumers) {
    // ---- the producer warp
    const int wcols = min(kN, N - c0);  // valid columns of the block
    const unsigned unit_mbytes = PACKED ? 4u * wcols : (LAYOUT == kPaired ? 2u : 1u) * wcols;
    const int8_t* xsrc =
        xf + (size_t)((size_t)m_tile * n_split + split) * pl.stages * kABytes;
    for (int s = 0; s < pl.stages; ++s) {
      const int slot = s % depth;
      if (s >= depth) mbar_wait_or_trap(empty + slot, ((s / depth) - 1) & 1);
      unsigned char* st = smem + (size_t)slot * kStage;
      int8_t* sw = reinterpret_cast<int8_t*>(st);
      unsigned char* sm = st + kWBytes;
      const int q0 = s * kR;
      const int uf = u0 + q0 / pl.p16;  // the stage's first unit
      const int nu = max(0, min(u0 + (q0 + kR - 1) / pl.p16, u_end - 1) - uf + 1);
      if (tma) {
        // one box of weight rows, the stage's fragments and its units'
        // multiplier rows (bulk copies, 16-byte runs: N % 16 == 0 or packed)
        if (lane == 0) {
          mbar_arrive_expect_tx(full + slot, kWBytes + kABytes + nu * unit_mbytes);
          const int r0 = u0 * pl.unit_rows + q0;  // p16 == unit_rows: rows are real rows
          if (bn > 0)
            tma_box(sw, &tmap, c0 % bn, (c0 / bn) * (K / 2) + r0, full + slot);
          else
            tma_box(sw, &tmap, c0, r0, full + slot);
          bulk_g2s(st + kWBytes + kMBytes, xsrc + (size_t)s * kABytes, kABytes, full + slot);
        }
        __syncwarp();
        if (lane < nu) {
          const int u = uf + lane;
          unsigned char* dst = sm + lane * kMulSlot;
          if (PACKED) {
            const int32_t* src = static_cast<const int32_t*>(mult) +
                                 (size_t)((LAYOUT == kPaired ? 2 * u : u) / 8) * N + c0;
            bulk_g2s(dst, src, 4 * wcols, full + slot);
          } else {
            const int8_t* mr = static_cast<const int8_t*>(mult);
            const int ra = LAYOUT == kPaired ? 2 * u : u;
            bulk_g2s(dst, mr + (size_t)ra * N + c0, wcols, full + slot);
            if (LAYOUT == kPaired) bulk_g2s(dst + kN, mr + (size_t)(ra + 1) * N + c0, wcols,
                                            full + slot);
          }
        }
      } else {
        // 4-byte copies, each lane one 4-column word a row, to its swizzled
        // place, padding rows skipped
        if (lane == 0) {
          mbar_arrive_expect_tx(full + slot, kABytes);
          bulk_g2s(st + kWBytes + kMBytes, xsrc + (size_t)s * kABytes, kABytes, full + slot);
        }
        const int c = c0 + 4 * lane;
        if (c < N) {
          for (int rho = 0; rho < kR; ++rho) {
            const int q = q0 + rho;
            const int u = u0 + q / pl.p16, i = q % pl.p16;
            if (u >= u_end || i >= pl.unit_rows) continue;
            cp_async<4>(sw + swz(rho, 4 * lane),
                        panel_col(w, K, N, bn, c) + (size_t)((long long)u * pl.unit_rows + i) * pitch,
                        true);
          }
        }
        for (int v = 0; v < nu; ++v) {
          const int u = uf + v;
          unsigned char* dst = sm + v * kMulSlot;
          if (PACKED) {
            const int32_t* src = static_cast<const int32_t*>(mult) +
                                 (size_t)((LAYOUT == kPaired ? 2 * u : u) / 8) * N;
            for (int cc = lane; cc < kN; cc += 32)
              if (c0 + cc < N) cp_async<4>(dst + 4 * cc, src + c0 + cc, true);
          } else if (c < N) {
            const int8_t* mr = static_cast<const int8_t*>(mult);
            const int ra = LAYOUT == kPaired ? 2 * u : u;
            cp_async<4>(dst + 4 * lane, mr + (size_t)ra * N + c, true);
            if (LAYOUT == kPaired)
              cp_async<4>(dst + kN + 4 * lane, mr + (size_t)(ra + 1) * N + c, true);
          }
        }
        cp_async_arrive(full + slot);
      }
    }
    if (!tma) cp_async_wait_all();
    return;
  }

  // ---- the consumer warps: 32 columns each, every row of the block
  const int gid = lane / 4, tid = lane % 4;
  const int cw = warp * 32 + 4 * gid;  // this lane's 4 B columns in the block
  // its word in rows 2 tid (+ 8, 16, ...) and 2 tid + 1 (+ 8, ...): row r of
  // a stage at r * kN + xo[r % 2] (the 4 lanes of a column meet 4 distinct
  // swizzled chunks, rows 2 tid apart: no bank conflict)
  const int xo[2] = {swz(2 * tid, cw) - 2 * tid * kN, swz(2 * tid + 1, cw) - (2 * tid + 1) * kN};
  int acc[MT][4][4];
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[t][j][r] = 0;
  int cur = -1;  // the unit whose multipliers ma, mb (and biases) hold
  unsigned ma[4], mb[4], ba[4], bb[4];
  for (int s = 0; s < pl.stages; ++s) {
    const int slot = s % depth;
    mbar_wait_or_trap(full + slot, (s / depth) & 1);
    const unsigned char* st = smem + (size_t)slot * kStage;
    const int8_t* sw = reinterpret_cast<const int8_t*>(st) + 2 * tid * kN;
    const unsigned char* sm = st + kWBytes;
    const unsigned char* sa = st + kWBytes + kMBytes + lane * 16;
    const int uf = u0 + s * kR / pl.p16;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      unsigned lo[2][4], hi[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int u = u0 + (s * kR + 32 * c + 16 * h) / pl.p16;
        if (u != cur) {  // warp-uniform
          cur = u;
          const unsigned char* mp = sm + (u - uf) * kMulSlot;
          if (PACKED) {
            const int sh = 4 * ((LAYOUT == kPaired ? 2 * u : u) % 8);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const unsigned wd = reinterpret_cast<const unsigned*>(mp)[cw + j];
              ma[j] = (wd >> sh) & 0xFu;
              mb[j] = LAYOUT == kPaired ? (wd >> (sh + 4)) & 0xFu : ma[j];
            }
          } else {
            const unsigned wa = *reinterpret_cast<const unsigned*>(mp + cw);
            const unsigned wb =
                LAYOUT == kPaired ? *reinterpret_cast<const unsigned*>(mp + kN + cw) : wa;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              ma[j] = (wa >> (8 * j)) & 0xFFu;
              mb[j] = (wb >> (8 * j)) & 0xFFu;
            }
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            ba[j] = 0x80808080u - ma[j] * 0x08080808u;
            bb[j] = 0x80808080u - mb[j] * 0x08080808u;
          }
        }
        // slot 4 tid + i: row 32c + 16h + 2 tid + (i & 1) + 8 (i >> 1)
        unsigned r[4], col[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          r[i] = *reinterpret_cast<const unsigned*>(
              sw + (32 * c + 16 * h + (i & 1) + 8 * (i >> 1)) * kN + xo[i & 1]);
        transpose4x4(r, col);  // col[j] byte i: slot 4 tid + i of column 4gid + j
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // vertical: two's complement -> offset binary (bit 3 of each nibble)
          const unsigned cj = LAYOUT == kVertical ? col[j] ^ 0x88888888u : col[j];
          lo[h][j] = fold(cj & 0x0F0F0F0Fu, ma[j], ba[j]);
          hi[h][j] = fold((cj >> 4) & 0x0F0F0F0Fu, mb[j], bb[j]);
        }
      }
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        const uint4 alo = *reinterpret_cast<const uint4*>(sa + ((c * 2 + 0) * MT + t) * kFrag);
        const uint4 ahi = *reinterpret_cast<const uint4*>(sa + ((c * 2 + 1) * MT + t) * kFrag);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma16832(acc[t][j], alo, lo[0][j], lo[1][j]);
          mma16832(acc[t][j], ahi, hi[0][j], hi[1][j]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + slot);
  }

  // ---- epilogue: register r of tile j holds column 8 tid + 4 (r % 2) + j
  // of row gid + 8 (r / 2) (mma.cuh's column permutation)
  const int nb = c0 + warp * 32 + 8 * tid;
  if (ARGMAX && n_split == 1) {
    // each row's (max, first index) over the block's columns: the lane's 8,
    // its row's 4 lanes, then the 4 warps through stage 0 of the ring
    constexpr int kRows = 16 * MT;
    float* red_v = reinterpret_cast<float*>(smem);  // [kConsumers][kRows]
    int* red_i = reinterpret_cast<int*>(red_v + kConsumers * kRows);
    float sc[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) sc[c] = nb + c < N ? s_col[nb + c] : 0.f;
    consumers_sync();  // every consumer warp is past its last stage
#pragma unroll
    for (int t = 0; t < MT; ++t)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = t * 16 + gid + 8 * hr;
        const int m = m_tile * kRows + row;
        const float xm = m < M ? xs[m] : 0.f;
        float bv = 0.f;
        int bi = INT_MAX;  // no candidate
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float y =
              __fmul_rn(__fmul_rn(__int2float_rn(acc[t][c % 4][2 * hr + c / 4]), sc[c]), xm);
          // `better` on ascending columns: a later column wins by a larger
          // value only, or as the first NaN
          if (nb + c < N && (bi == INT_MAX || y > bv || (isnan(y) && !isnan(bv)))) {
            bv = y;
            bi = nb + c;
          }
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
          const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
          if (better(ov, oi, bv, bi)) {
            bv = ov;
            bi = oi;
          }
        }
        if (tid == 0) {
          red_v[warp * kRows + row] = bv;
          red_i[warp * kRows + row] = bi;
        }
      }
    consumers_sync();
    const int row = threadIdx.x, m = m_tile * kRows + row;
    if (row < kRows && m < M) {
      float bv = red_v[row];
      int bi = red_i[row];
#pragma unroll
      for (int wi = 1; wi < kConsumers; ++wi)
        if (better(red_v[wi * kRows + row], red_i[wi * kRows + row], bv, bi)) {
          bv = red_v[wi * kRows + row];
          bi = red_i[wi * kRows + row];
        }
      pair_val[(size_t)m * gridDim.y + n_tile] = bv;
      pair_idx[(size_t)m * gridDim.y + n_tile] = bi;
    }
    return;
  }
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int m = (m_tile * MT + t) * 16 + gid + 8 * hr;
      if (m >= M || nb >= N) continue;
      int v[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) v[c] = acc[t][c % 4][2 * hr + c / 4];
      if (n_split > 1 || out_kind == kOutPartials) {
        int32_t* p = partial + ((size_t)split * M + m) * N + nb;
        if (nb + 8 <= N) {
          reinterpret_cast<int4*>(p)[0] = make_int4(v[0], v[1], v[2], v[3]);
          reinterpret_cast<int4*>(p)[1] = make_int4(v[4], v[5], v[6], v[7]);
        } else {
#pragma unroll
          for (int c = 0; c < 8; ++c)
            if (nb + c < N) p[c] = v[c];
        }
        continue;
      }
      const float xm = xs[m];
      float y[8];
#pragma unroll
      for (int c = 0; c < 8; ++c)
        y[c] = nb + c < N ? __fmul_rn(__fmul_rn(__int2float_rn(v[c]), s_col[nb + c]), xm) : 0.f;
      if (out_kind == kOutBf16)
        store8(static_cast<__nv_bfloat16*>(out) + (size_t)m * N, nb, N, y);
      else
        store8(static_cast<float*>(out) + (size_t)m * N, nb, N, y);
    }
}

// depth stages, their barriers, and the slack to align the stages to 1024
// bytes.
inline size_t smem_bytes(int mt, int depth) {
  return (size_t)depth * stage_bytes(mt) + (size_t)depth * 16 + 1024;
}

// The tensor-map encoder cuTensorMapEncodeTiled, reached through the
// runtime (nothing more to link); null where the CUDA installation has
// none.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A 2-D tensor map of `rows` rows of `cols` elements, `pitch` bytes apart,
// boxes of box_c x box_r elements (zeros past the tensor); false where the
// encoder or the shape refuses one.
inline bool tensor_map(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                       long long cols, long long rows, long long pitch, int box_c, int box_r,
                       CUtensorMapSwizzle swizzle) {
  const auto encode = tensor_map_encoder();
  if (encode == nullptr || pitch % 16 != 0 || reinterpret_cast<uintptr_t>(base) % 16 != 0)
    return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)pitch};
  const cuuint32_t box[2] = {(cuuint32_t)box_c, (cuuint32_t)box_r};
  const cuuint32_t estr[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box, estr,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The weights' tensor map for the TMA feed: `cols` bytes a row, `rows`
// rows `pitch` bytes apart, boxes of kN x kR bytes, 128B swizzle. False
// where the shape does not allow one (the tile then takes 4-byte copies).
inline bool weight_map(CUtensorMap* map, const int8_t* w, long long cols, long long rows,
                       long long pitch) {
  return tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, cols, rows, pitch, kN, kR,
                    CU_TENSOR_MAP_SWIZZLE_128B);
}

// weight_map through a direct-mapped cache keyed on every argument of the
// encoding: the map is a function of them alone, so a hit is the map the
// encoder would give (a refusal is kept too). A decode step asks for the
// same few hundred maps (a layer's products) every step; the host then
// encodes each once.
inline bool cached_weight_map(CUtensorMap* map, const int8_t* w, long long cols, long long rows,
                              long long pitch) {
  struct Entry {
    const int8_t* w;
    long long cols, rows, pitch;
    bool ok;
    CUtensorMap map;
  };
  constexpr size_t kEntries = 1024;
  static Entry cache[kEntries] = {};
  static std::mutex mu;
  constexpr size_t kMul = 0x9E3779B97F4A7C15ull;
  size_t h = reinterpret_cast<uintptr_t>(w) >> 8;
  h = ((h * kMul + (size_t)cols) * kMul + (size_t)rows) * kMul + (size_t)pitch;
  Entry& e = cache[(h ^ (h >> 29)) % kEntries];
  std::lock_guard<std::mutex> lock(mu);
  if (e.w != w || e.cols != cols || e.rows != rows || e.pitch != pitch) {
    e.w = w;
    e.cols = cols;
    e.rows = rows;
    e.pitch = pitch;
    e.ok = weight_map(&e.map, w, cols, rows, pitch);
  }
  if (e.ok) *map = e.map;
  return e.ok;
}

template <int LAYOUT, bool PACKED, bool ARGMAX, int MT>
cudaError_t launch_tile(const CUtensorMap& tmap, int tma, const int8_t* xf, const float* xs,
                        const int8_t* w, const void* mult,
                        const float* s_col, int32_t* partial, void* out, int out_kind, int M,
                        int K, int N, int group, int n_split, int bn, int depth,
                        float* pair_val, int* pair_idx, cudaStream_t stream) {
  const size_t smem = smem_bytes(MT, depth);
  auto kernel = w4a8_mma_kernel<LAYOUT, PACKED, MT, ARGMAX>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + 16 * MT - 1) / (16 * MT), (N + kN - 1) / kN, n_split);
  kernel<<<grid, kThreads, smem, stream>>>(tmap, tma, xf, xs, w, mult, s_col, partial, out,
                                           out_kind, M, K, N, group, n_split, bn, depth,
                                           pair_val, pair_idx);
  return cudaGetLastError();
}

// Rows of x the staged activations cover at M rows: whole m tiles.
__host__ __device__ inline int staged_rows(int M) {
  return (M + 16 * tiles_of(M) - 1) / (16 * tiles_of(M)) * 16 * tiles_of(M);
}

// Whether a launch of the tile fits its plan: cudaErrorInvalidValue where
// it does not.
template <int LAYOUT, bool ARGMAX>
cudaError_t check_launch(int M, int K, int N, int group, int n_split, int depth,
                         const int32_t* partial, const float* pair_val, const int* pair_idx) {
  if (M < 1 || N < 4 || N % 4 != 0 || n_split < 1 || depth < 1 ||
      smem_bytes(tiles_of(M), depth) > 232448 || (n_split > 1 && partial == nullptr) ||
      (ARGMAX && (pair_val == nullptr || pair_idx == nullptr)))
    return cudaErrorInvalidValue;
  const Plan pl = plan_of(LAYOUT, K, group, n_split);
  if (pl.unit_rows % 4 != 0 || pl.n_units < 1 || (n_split - 1) * pl.ups >= pl.n_units)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// The tile and, with n_split > 1, common.cuh's epilogue over the int32
// partials, on activations already staged in xf (stage_x_kernel's or
// stage_row's order). ARGMAX (paired): out is the int32 token id a row;
// the tile's pairs (or the split epilogue's, a kEpiTile columns each) go
// to pair_val, pair_idx (M, ceil(N / kN)), then argmax_reduce_kernel.
template <int LAYOUT, bool PACKED, bool ARGMAX = false>
cudaError_t launch_staged(const float* xs, const int8_t* w, const void* mult, const float* s_col,
                          const int8_t* xf, int32_t* partial, void* out, int out_kind, int M,
                          int K, int N, int group, int n_split, int bn, int depth,
                          cudaStream_t stream, float* pair_val = nullptr,
                          int* pair_idx = nullptr) {
  cudaError_t err =
      check_launch<LAYOUT, ARGMAX>(M, K, N, group, n_split, depth, partial, pair_val, pair_idx);
  if (err != cudaSuccess) return err;
  if (out_kind < kOutF32 || out_kind > kOutPartials ||
      (out_kind == kOutPartials && (ARGMAX || partial == nullptr)))
    return cudaErrorInvalidValue;
  const Plan pl = plan_of(LAYOUT, K, group, n_split);
  const int mt = tiles_of(M);
  // The TMA feed where every padded row is a real row (unit_rows % 16 ==
  // 0), the rows are 16-byte runs and a block's kN columns lie in one panel;
  // the multipliers then come as bulk copies too (int8 rows of N % 16 == 0
  // bytes, or packed int32).
  CUtensorMap tmap = {};
  const int pitch = bn > 0 ? bn : N;
  const bool mult_ok = PACKED || (N % 16 == 0 && reinterpret_cast<uintptr_t>(mult) % 16 == 0);
  const int tma = pl.p16 == pl.unit_rows && mult_ok && (bn == 0 || bn % kN == 0) &&
                  cached_weight_map(&tmap, w, pitch,
                                    bn > 0 ? (long long)(N / bn) * (K / 2) : K / 2, pitch);
  switch (mt) {
    case 1:
      err = launch_tile<LAYOUT, PACKED, ARGMAX, 1>(tmap, tma, xf, xs, w, mult, s_col, partial,
                                                   out, out_kind, M, K, N, group, n_split, bn,
                                                   depth, pair_val, pair_idx, stream);
      break;
    case 2:
      err = launch_tile<LAYOUT, PACKED, ARGMAX, 2>(tmap, tma, xf, xs, w, mult, s_col, partial,
                                                   out, out_kind, M, K, N, group, n_split, bn,
                                                   depth, pair_val, pair_idx, stream);
      break;
    default:
      err = launch_tile<LAYOUT, PACKED, ARGMAX, 4>(tmap, tma, xf, xs, w, mult, s_col, partial,
                                                   out, out_kind, M, K, N, group, n_split, bn,
                                                   depth, pair_val, pair_idx, stream);
  }
  if (err != cudaSuccess) return err;
  if constexpr (ARGMAX) {
    int n_pairs = (N + kN - 1) / kN;  // the tile's pairs a row
    if (n_split > 1) {
      n_pairs = (N + kEpiTile - 1) / kEpiTile;
      err = launch_gemv_epilogue<float, true>(partial, n_split, M, N, s_col, xs, nullptr,
                                              pair_val, pair_idx, stream);
      if (err != cudaSuccess) return err;
    }
    argmax_reduce_kernel<<<M, 32, 0, stream>>>(pair_val, pair_idx, n_pairs,
                                               static_cast<int*>(out));
    return cudaGetLastError();
  }
  if (n_split == 1 || out_kind == kOutPartials) return cudaSuccess;
  if (out_kind == kOutBf16)
    return launch_gemv_epilogue<__nv_bfloat16, false>(partial, n_split, M, N, s_col, xs,
                                                      static_cast<__nv_bfloat16*>(out), nullptr,
                                                      nullptr, stream);
  return launch_gemv_epilogue<float, false>(partial, n_split, M, N, s_col, xs,
                                            static_cast<float*>(out), nullptr, nullptr, stream);
}

// The whole GEMV: stage x into xf (the wrapper sizes it: mma_plan's
// x_bytes) by stage_x_kernel, then launch_staged. Every argument is checked
// against the plan; a shape the plan does not cover returns
// cudaErrorInvalidValue.
template <int LAYOUT, bool PACKED, bool ARGMAX = false>
cudaError_t launch(const int8_t* x, const float* xs, const int8_t* w, const void* mult,
                   const float* s_col, int8_t* xf, int32_t* partial, void* out, int out_kind,
                   int M, int K, int N, int group, int n_split, int bn, int depth,
                   cudaStream_t stream, float* pair_val = nullptr, int* pair_idx = nullptr) {
  cudaError_t err =
      check_launch<LAYOUT, ARGMAX>(M, K, N, group, n_split, depth, partial, pair_val, pair_idx);
  if (err != cudaSuccess) return err;
  const Plan pl = plan_of(LAYOUT, K, group, n_split);
  const int mt = tiles_of(M);
  const long long total = (long long)(staged_rows(M) / (16 * mt)) * n_split * pl.stages *
                          kChunks * 2 * mt * 32;
  stage_x_kernel<LAYOUT><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      x, xf, M, K, group, n_split, mt, total);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_staged<LAYOUT, PACKED, ARGMAX>(xs, w, mult, s_col, xf, partial, out, out_kind, M,
                                               K, N, group, n_split, bn, depth, stream, pair_val,
                                               pair_idx);
}

// --- The any-group route: byte rows in memory order ------------------------
// (the header's "The any-group route"). Host and kernels derive the same
// RowsPlan from (layout, K, group, n_split); kernels/matmul.py rows_plan
// mirrors it.

constexpr int kMaxSplitRows = 65536;  // byte rows one split sums in int32
// How the producer fills a stage: one TMA box, 4-byte cp.async words, or
// byte loads and stores (N % 4 != 0, or a panel width bn % 4 != 0).
constexpr int kFeedTma = 0, kFeedWords = 1, kFeedBytes = 2;

// Whether the reference takes LAYOUT at (K, group): vertical K even and
// whole groups; paired whole group pairs; group halves an even group.
template <int LAYOUT>
__host__ __device__ inline bool layout_takes(int K, int group) {
  if (group < 1 || K < 2 || K % 2 != 0) return false;
  if (LAYOUT == kPaired) return K % (2 * group) == 0;
  if (LAYOUT == kHalves) return group % 2 == 0 && K % group == 0;
  return K % group == 0;
}

struct RowsPlan {
  int rows;        // byte rows of the layer, K / 2
  int rps;         // byte rows a split covers (whole stages; the last split fewer)
  int n_split;
  int stages;      // ring stages a split streams: rps / kR
  int mult_rows;   // multiplier rows a stage holds: int8 group rows, or packed words
  int mult_bytes;  // their shared bytes
  bool pairs;      // a word's 4 rows meet at most 2 groups in each plane
};

__host__ __device__ inline RowsPlan rows_plan_of(int layout, bool packed, int K, int group,
                                                 int n_split) {
  RowsPlan p;
  p.rows = K / 2;
  const int per = (p.rows + n_split - 1) / n_split;
  p.rps = (per + kR - 1) / kR * kR;
  p.n_split = (p.rows + p.rps - 1) / p.rps;
  p.stages = p.rps / kR;
  // the groups kR consecutive byte rows can meet, in both planes
  const int n_groups = K / group;
  const int span = layout == kPaired   ? 2 * ((kR - 1) / group + 2)
                   : layout == kHalves ? (kR - 1) / (group / 2) + 2
                                       : (2 * kR - 1) / group + 2;
  const int groups = span < n_groups ? span : n_groups;
  const int words = (n_groups + 7) / 8;
  p.mult_rows = packed ? ((groups - 1) / 8 + 2 < words ? (groups - 1) / 8 + 2 : words) : groups;
  p.mult_bytes = p.mult_rows * kN * (packed ? 4 : 1);
  // aligned 4-row words: paired units of g >= 2 rows, group halves of
  // g / 2 >= 2, vertical k = 8a + {0, 2, 4, 6} (+1) at g = 4 or g >= 6
  p.pairs = layout == kPaired   ? group >= 2
            : layout == kHalves ? group >= 4
                                : group == 4 || group >= 6;
  return p;
}

// A stage: the weight rows, the multiplier rows, the activation fragments
// (a multiple of 1024 bytes: the swizzle's period).
__host__ __device__ constexpr int rows_stage_bytes(int mt, int mult_bytes) {
  return (kWBytes + mult_bytes + a_stage_bytes(mt) + 1023) / 1024 * 1024;
}
inline size_t rows_smem_bytes(int mt, int depth, int mult_bytes) {
  return (size_t)depth * rows_stage_bytes(mt, mult_bytes) + (size_t)depth * 16 + 1024;
}

// Division by a launch-uniform divisor d as one multiply-high: m =
// floor((2^32 - 1) / d) + 1 gives floor(n / d) for every n with n * d <
// 2^32 (launch_rows checks (K + 2) * group < 2^32).
struct FastDiv {
  unsigned d, m;
  __host__ __device__ explicit FastDiv(unsigned d_)
      : d(d_), m(d_ <= 1 ? 0u : 0xFFFFFFFFu / d_ + 1u) {}
  __device__ __forceinline__ int operator()(int n) const {
    return d <= 1 ? n : (int)__umulhi((unsigned)n, m);
  }
};

// The group of the nibble of byte row r in plane p, and the first byte row
// past group G's rows in plane p. Paired rows come in units of g (groups 2u
// and 2u + 1), group halves in units of g / 2 (group u in both planes), and
// so does the vertical layout at an even g (k = 2r, 2r + 1 both in group
// r / (g / 2)); at an odd g its planes change group at different rows.
template <int LAYOUT>
struct RowGroups {
  FastDiv gdiv, hdiv;
  int group;
  __device__ __forceinline__ int of(int r, int p) const {
    if (LAYOUT == kVertical) return gdiv(2 * r + p);
    if (LAYOUT == kPaired) return 2 * gdiv(r) + p;
    return hdiv(r);
  }
  __device__ __forceinline__ int end(int G, int p) const {
    if (LAYOUT == kVertical) return ((G + 1) * group - p + 1) / 2;
    if (LAYOUT == kPaired) return (G / 2 + 1) * group;
    return (G + 1) * (group / 2);
  }
};

// k of the nibble of byte row r in plane p (pack_int4_vertical,
// pack_uint4_offset_paired, pack_uint4_offset).
template <int LAYOUT>
__device__ __forceinline__ int slot_k(int r, int p, int group) {
  if (LAYOUT == kVertical) return 2 * r + p;
  if (LAYOUT == kPaired) {
    const int u = r / group;
    return (2 * u + p) * group + (r - u * group);
  }
  const int h = group / 2, u = r / h;
  return u * group + p * h + (r - u * h);
}

// x (M, K) to the fragments of every (m tile, split, stage) in the order of
// stage_x_kernel, with the slots in byte-row order: slot 4 t + i of half h
// of chunk c of stage s holds byte row split * rps + s * kR + 32 c + 16 h +
// 4 t + i (its k in `plane`); zeros past the split's rows and past M. One
// thread a 32-bit word (a lane's register of a fragment).
template <int LAYOUT>
__global__ void stage_rows_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ xf, int M,
                                  int K, int group, int rps, int n_split, int stages, int mt,
                                  long long words) {
  const long long wi = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (wi >= words) return;
  const int reg = (int)(wi & 3), lane = (int)((wi >> 2) & 31);
  long long f = wi >> 7;
  const int ti = (int)(f % mt);
  f /= mt;
  const int plane = (int)(f % 2);
  f /= 2;
  const int c = (int)(f % kChunks);
  f /= kChunks;
  const int s = (int)(f % stages);
  f /= stages;
  const int split = (int)(f % n_split), m_tile = (int)(f / n_split);
  const int m = (m_tile * mt + ti) * 16 + lane / 4 + 8 * (reg & 1);
  const int rows = K / 2;
  const int ra = split * rps + s * kR + 32 * c + 16 * (reg >> 1) + 4 * (lane % 4);
  const int re = min(rows, (split + 1) * rps);
  unsigned word = 0;
  if (m < M) {
    const int8_t* xr = x + (size_t)m * K;
    if (LAYOUT == kVertical && ra + 4 <= re &&
        reinterpret_cast<uintptr_t>(xr + 2 * ra) % 8 == 0) {
      // k = 2 ra + plane + {0, 2, 4, 6}: the even or odd bytes of 8
      const uint2 v = *reinterpret_cast<const uint2*>(xr + 2 * ra);
      word = __byte_perm(v.x, v.y, plane ? 0x7531u : 0x6420u);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (ra + i < re)
          word |= static_cast<unsigned>(static_cast<uint8_t>(xr[slot_k<LAYOUT>(ra + i, plane, group)]))
                  << (8 * i);
    }
  }
  reinterpret_cast<unsigned*>(xf)[wi] = word;
}

// Columns cw..cw + 3 of group G's multipliers in a stage's rows (first row
// `base`: a group, or PACKED a word of 8 groups).
template <bool PACKED>
__device__ __forceinline__ void stage_mult(const unsigned char* sm, int G, int base, int cw,
                                           unsigned m[4]) {
  if (PACKED) {
    const uint4 v = *reinterpret_cast<const uint4*>(sm + ((size_t)((G >> 3) - base) * kN + cw) * 4);
    const int sh = 4 * (G & 7);
    m[0] = (v.x >> sh) & 15u, m[1] = (v.y >> sh) & 15u;
    m[2] = (v.z >> sh) & 15u, m[3] = (v.w >> sh) & 15u;
  } else {
    const unsigned v = *reinterpret_cast<const unsigned*>(sm + (size_t)(G - base) * kN + cw);
#pragma unroll
    for (int j = 0; j < 4; ++j) m[j] = (v >> (8 * j)) & 255u;
  }
}

// Both planes' multipliers of paired unit u (groups 2u, 2u + 1: one packed
// word, bits 8 (u % 4) and up).
template <bool PACKED>
__device__ __forceinline__ void stage_mult_pair(const unsigned char* sm, int u, int base, int cw,
                                                unsigned lo[4], unsigned hi[4]) {
  if (PACKED) {
    const uint4 v = *reinterpret_cast<const uint4*>(sm + ((size_t)((u >> 2) - base) * kN + cw) * 4);
    const int sh = 8 * (u & 3);
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) lo[j] = (w[j] >> sh) & 15u, hi[j] = (w[j] >> (sh + 4)) & 15u;
  } else {
    stage_mult<false>(sm, 2 * u, base, cw, lo);
    stage_mult<false>(sm, 2 * u + 1, base, cw, hi);
  }
}

// Bytes i >= n of a word (n rows of the word in its first group).
__device__ __forceinline__ unsigned tail_mask(int n) {
  return n >= 4 ? 0u : n <= 0 ? 0xFFFFFFFFu : 0xFFFFFFFFu << (8 * n);
}

// One plane of a column word with two multipliers: the fold of the tile
// (d = the signed nibbles as packed bytes, d * m + 0x80808080 is m * v +
// 128 in every byte, no carry: m * v + 128 in [8, 233]), once with mA and
// once with mB, the bytes of `mask` from the second; ^ 0x80808080 gives
// the int8 bytes m * v.
__device__ __forceinline__ unsigned fold2(unsigned nib, unsigned mA, unsigned mB,
                                          unsigned mask) {
  const unsigned d = nib - 0x08080808u;
  const unsigned fa = d * mA + 0x80808080u, fb = d * mB + 0x80808080u;
  return ((fa & ~mask) | (fb & mask)) ^ 0x80808080u;
}

// The folded B registers of one half: col[j] holds byte rows ra..ra + 3 of
// column cw + j (byte i row ra + i); rows past `rlast` multiply zero
// activations, so their groups are clamped to rlast's (the stage holds
// them). PAIRS: each plane meets groups gA (the first row's) and gB (the
// last's); else slot by slot, each row with its own group.
template <int LAYOUT, bool PACKED, bool PAIRS>
__device__ __forceinline__ void fold_rows(const unsigned col[4], int ra, int rlast,
                                          const RowGroups<LAYOUT>& grp, const unsigned char* sm,
                                          int base, int cw, unsigned lo[4], unsigned hi[4]) {
  unsigned v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = LAYOUT == kVertical ? col[j] ^ 0x88888888u : col[j];
  const int r0 = min(ra, rlast), r3 = min(ra + 3, rlast);
  if constexpr (PAIRS) {
    unsigned a0[4], a1[4], b0[4], b1[4], mask0, mask1;
    if (LAYOUT == kPaired) {
      const int uA = grp.gdiv(r0), uB = grp.gdiv(r3);
      mask0 = mask1 = tail_mask((uA + 1) * grp.group - ra);
      stage_mult_pair<PACKED>(sm, uA, base, cw, a0, a1);
      stage_mult_pair<PACKED>(sm, uB, base, cw, b0, b1);
    } else if (LAYOUT == kHalves || grp.group % 2 == 0) {
      const int uA = grp.hdiv(r0), uB = grp.hdiv(r3);
      mask0 = mask1 = tail_mask((uA + 1) * (grp.group / 2) - ra);
      stage_mult<PACKED>(sm, uA, base, cw, a0);
      stage_mult<PACKED>(sm, uB, base, cw, b0);
#pragma unroll
      for (int j = 0; j < 4; ++j) a1[j] = a0[j], b1[j] = b0[j];
    } else {
      const int gA0 = grp.of(r0, 0), gA1 = grp.of(r0, 1);
      mask0 = tail_mask(grp.end(gA0, 0) - ra);
      mask1 = tail_mask(grp.end(gA1, 1) - ra);
      stage_mult<PACKED>(sm, gA0, base, cw, a0);
      stage_mult<PACKED>(sm, grp.of(r3, 0), base, cw, b0);
      stage_mult<PACKED>(sm, gA1, base, cw, a1);
      stage_mult<PACKED>(sm, grp.of(r3, 1), base, cw, b1);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      lo[j] = fold2(v[j] & 0x0F0F0F0Fu, a0[j], b0[j], mask0);
      hi[j] = fold2((v[j] >> 4) & 0x0F0F0F0Fu, a1[j], b1[j], mask1);
    }
  } else {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      unsigned m[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) stage_mult<PACKED>(sm, grp.of(min(ra + i, r3), p), base, cw, m[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        unsigned f = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int u = (int)((v[j] >> (8 * i + 4 * p)) & 15u);
          f |= ((unsigned)((u - 8) * (int)m[i][j]) & 255u) << (8 * i);
        }
        (p ? hi : lo)[j] = f;
      }
    }
  }
}

// The any-group tile. Grid (m tiles, n tiles, n_split), kThreads threads,
// dynamic shared memory rows_smem_bytes(MT, depth, mult_bytes). Operands
// as w4a8_mma_kernel's; xf staged by stage_rows_kernel; feed kFeedTma,
// kFeedWords or kFeedBytes. n_split > 1 or out_kind kOutPartials: int32
// partials (n_split, M, N); else y as f32 or bf16.
// Two blocks an SM (up to 204 registers; MT = 4 takes ~145, no spill).
template <int LAYOUT, bool PACKED, int MT, bool PAIRS>
__global__ void __launch_bounds__(kThreads, 2)
w4a8_rows_kernel(const __grid_constant__ CUtensorMap tmap, int feed,
                 const int8_t* __restrict__ xf, const float* __restrict__ xs,
                 const int8_t* __restrict__ w, const void* __restrict__ mult,
                 const float* __restrict__ s_col, int32_t* __restrict__ partial,
                 void* __restrict__ out, int out_kind, int M, int K, int N, int group,
                 int n_split, int rps, int bn, int depth, int mult_bytes) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  constexpr int kABytes = a_stage_bytes(MT);
  const int stage_b = rows_stage_bytes(MT, mult_bytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + (size_t)depth * stage_b);
  uint64_t* empty = full + depth;
  const int m_tile = blockIdx.x, n_tile = blockIdx.y, split = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rows = K / 2, pitch = bn > 0 ? bn : N;
  const int rs = split * rps, re = min(rows, rs + rps);
  const int stages = (re - rs + kR - 1) / kR;  // this split's; rps / kR in xf
  const int c0 = n_tile * kN;
  const RowGroups<LAYOUT> grp{FastDiv(group), FastDiv(max(1, group / 2)), group};
  if (threadIdx.x == 0) {
    for (int s = 0; s < depth; ++s) {
      mbar_init(full + s, feed == kFeedTma ? 1 : 33);
      mbar_init(empty + s, kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == kConsumers) {
    // ---- the producer warp
    const int wcols = min(kN, N - c0);
    const unsigned mrow = PACKED ? 4u * wcols : (unsigned)wcols;  // bytes of a multiplier row
    const int8_t* xsrc = xf + ((size_t)m_tile * n_split + split) * (rps / kR) * kABytes;
    for (int s = 0; s < stages; ++s) {
      const int slot = s % depth;
      if (s >= depth) mbar_wait_or_trap(empty + slot, ((s / depth) - 1) & 1);
      unsigned char* st = smem + (size_t)slot * stage_b;
      int8_t* sw = reinterpret_cast<int8_t*>(st);
      unsigned char* sm = st + kWBytes;
      unsigned char* sa = sm + mult_bytes;
      const int ra0 = rs + s * kR, n_rows = min(kR, re - ra0);
      const int g0 = grp.of(ra0, 0), g1 = grp.of(ra0 + n_rows - 1, 1);
      const int base = PACKED ? g0 >> 3 : g0;
      const int nm = (PACKED ? g1 >> 3 : g1) - base + 1;
      if (feed == kFeedTma) {
        // one box of weight rows (rows past the layer read as zeros, rows
        // of the next split multiply zeros), the fragments, and one bulk
        // copy a multiplier row
        if (lane == 0) {
          mbar_arrive_expect_tx(full + slot, kWBytes + kABytes + nm * mrow);
          if (bn > 0)
            tma_box(sw, &tmap, c0 % bn, (c0 / bn) * rows + ra0, full + slot);
          else
            tma_box(sw, &tmap, c0, ra0, full + slot);
          bulk_g2s(sa, xsrc + (size_t)s * kABytes, kABytes, full + slot);
        }
        __syncwarp();
        for (int v = lane; v < nm; v += 32) {
          if (PACKED)
            bulk_g2s(sm + (size_t)v * kN * 4,
                     static_cast<const int32_t*>(mult) + (size_t)(base + v) * N + c0, mrow,
                     full + slot);
          else
            bulk_g2s(sm + (size_t)v * kN,
                     static_cast<const int8_t*>(mult) + (size_t)(base + v) * N + c0, mrow,
                     full + slot);
        }
        continue;
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(full + slot, kABytes);
        bulk_g2s(sa, xsrc + (size_t)s * kABytes, kABytes, full + slot);
      }
      if (feed == kFeedWords) {
        // each lane one 4-column word a row, to its swizzled place
        const int c = c0 + 4 * lane;
        if (c < N) {
          const int8_t* wc = panel_col(w, K, N, bn, c);
          for (int rho = 0; rho < n_rows; ++rho)
            cp_async<4>(sw + swz(rho, 4 * lane), wc + (size_t)(ra0 + rho) * pitch, true);
        }
        for (int v = 0; v < nm; ++v) {
          if (PACKED) {
            const int32_t* src = static_cast<const int32_t*>(mult) + (size_t)(base + v) * N + c0;
            for (int cc = lane; cc < wcols; cc += 32)
              cp_async<4>(sm + ((size_t)v * kN + cc) * 4, src + cc, true);
          } else if (c < N) {
            cp_async<4>(sm + (size_t)v * kN + 4 * lane,
                        static_cast<const int8_t*>(mult) + (size_t)(base + v) * N + c, true);
          }
        }
        cp_async_arrive(full + slot);
      } else {
        // byte by byte (no 4-byte run is aligned)
        for (int rho = 0; rho < n_rows; ++rho)
          for (int cc = lane; cc < wcols; cc += 32)
            sw[swz(rho, cc)] = panel_col(w, K, N, bn, c0 + cc)[(size_t)(ra0 + rho) * pitch];
        for (int v = 0; v < nm; ++v)
          for (int cc = lane; cc < wcols; cc += 32) {
            const size_t at = (size_t)(base + v) * N + c0 + cc;
            if (PACKED)
              reinterpret_cast<int32_t*>(sm)[(size_t)v * kN + cc] =
                  static_cast<const int32_t*>(mult)[at];
            else
              sm[(size_t)v * kN + cc] =
                  static_cast<uint8_t>(static_cast<const int8_t*>(mult)[at]);
          }
        mbar_arrive(full + slot);
      }
    }
    if (feed == kFeedWords) cp_async_wait_all();
    return;
  }

  // ---- the consumer warps: 32 columns each, every row of the block
  const int gid = lane / 4, tid = lane % 4;
  const int cw = warp * 32 + 4 * gid;  // this lane's 4 B columns in the block
  // its word in rows 4 tid + i of each 16-row half: row r0 + 4 tid + i of
  // a stage (r0 a multiple of 16) at r0 * kN + 4 tid * kN + xo[i]
  int xo[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) xo[i] = swz(4 * tid + i, cw) - 4 * tid * kN;
  int acc[MT][4][4];
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[t][j][r] = 0;
  for (int s = 0; s < stages; ++s) {
    const int slot = s % depth;
    mbar_wait_or_trap(full + slot, (s / depth) & 1);
    const unsigned char* st = smem + (size_t)slot * stage_b;
    const int8_t* sw = reinterpret_cast<const int8_t*>(st) + 4 * tid * kN;
    const unsigned char* sm = st + kWBytes;
    const unsigned char* sa = sm + mult_bytes + lane * 16;
    const int ra0 = rs + s * kR, rlast = min(ra0 + kR, re) - 1;
    const int base = PACKED ? grp.of(ra0, 0) >> 3 : grp.of(ra0, 0);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      unsigned lo[2][4], hi[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        unsigned r[4], col[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          r[i] = *reinterpret_cast<const unsigned*>(sw + (32 * c + 16 * h) * kN + xo[i]);
        transpose4x4(r, col);  // col[j] byte i: row 4 tid + i of column cw + j
        fold_rows<LAYOUT, PACKED, PAIRS>(col, ra0 + 32 * c + 16 * h + 4 * tid, rlast, grp, sm,
                                         base, cw, lo[h], hi[h]);
      }
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        const uint4 alo = *reinterpret_cast<const uint4*>(sa + ((c * 2 + 0) * MT + t) * kFrag);
        const uint4 ahi = *reinterpret_cast<const uint4*>(sa + ((c * 2 + 1) * MT + t) * kFrag);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma16832(acc[t][j], alo, lo[0][j], lo[1][j]);
          mma16832(acc[t][j], ahi, hi[0][j], hi[1][j]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + slot);
  }

  // ---- epilogue: register r of tile j holds column 8 tid + 4 (r % 2) + j
  // of row gid + 8 (r / 2); 16-byte stores only where N % 4 == 0
  const int nb = c0 + warp * 32 + 8 * tid;
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int m = (m_tile * MT + t) * 16 + gid + 8 * hr;
      if (m >= M || nb >= N) continue;
      int v[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) v[c] = acc[t][c % 4][2 * hr + c / 4];
      if (n_split > 1 || out_kind == kOutPartials) {
        int32_t* p = partial + ((size_t)split * M + m) * N + nb;
        if (N % 4 == 0 && nb + 8 <= N) {
          reinterpret_cast<int4*>(p)[0] = make_int4(v[0], v[1], v[2], v[3]);
          reinterpret_cast<int4*>(p)[1] = make_int4(v[4], v[5], v[6], v[7]);
        } else {
#pragma unroll
          for (int c = 0; c < 8; ++c)
            if (nb + c < N) p[c] = v[c];
        }
        continue;
      }
      const float xm = xs[m];
      float y[8];
#pragma unroll
      for (int c = 0; c < 8; ++c)
        y[c] = nb + c < N ? __fmul_rn(__fmul_rn(__int2float_rn(v[c]), s_col[nb + c]), xm) : 0.f;
      if (out_kind == kOutBf16) {
        store8(static_cast<__nv_bfloat16*>(out) + (size_t)m * N, nb, N, y);  // 16 bytes at N % 8 == 0
      } else if (N % 4 == 0) {
        store8(static_cast<float*>(out) + (size_t)m * N, nb, N, y);
      } else {
        float* row = static_cast<float*>(out) + (size_t)m * N;
#pragma unroll
        for (int c = 0; c < 8; ++c)
          if (nb + c < N) row[nb + c] = y[c];
      }
    }
}

// The split epilogue of the any-group route: the int32 partials summed in
// int64 (exact for every K), then __ll2float_rn and the tile's two
// round-to-nearest products. One thread an output.
template <typename OutT>
__global__ void rows_epilogue_kernel(const int32_t* __restrict__ partial, int n_split, int M,
                                     int N, const float* __restrict__ s_col,
                                     const float* __restrict__ xs, OutT* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long MN = (long long)M * N;
  if (i >= MN) return;
  long long acc = 0;
  for (int s = 0; s < n_split; ++s) acc += partial[s * MN + i];
  store<OutT>(out + i,
              __fmul_rn(__fmul_rn(__ll2float_rn(acc), s_col[i % N]), xs[i / N]));
}

template <int LAYOUT, bool PACKED, int MT, bool PAIRS>
cudaError_t launch_rows_tile(const CUtensorMap& tmap, int feed, const int8_t* xf,
                             const float* xs, const int8_t* w, const void* mult,
                             const float* s_col, int32_t* partial, void* out, int out_kind,
                             int M, int K, int N, int group, const RowsPlan& pl, int bn,
                             int depth, cudaStream_t stream) {
  const size_t smem = rows_smem_bytes(MT, depth, pl.mult_bytes);
  auto kernel = w4a8_rows_kernel<LAYOUT, PACKED, MT, PAIRS>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + 16 * MT - 1) / (16 * MT), (N + kN - 1) / kN, pl.n_split);
  kernel<<<grid, kThreads, smem, stream>>>(tmap, feed, xf, xs, w, mult, s_col, partial, out,
                                           out_kind, M, K, N, group, pl.n_split, pl.rps, bn,
                                           depth, pl.mult_bytes);
  return cudaGetLastError();
}

template <int LAYOUT, bool PACKED, bool PAIRS>
cudaError_t launch_rows_mt(const CUtensorMap& tmap, int feed, const int8_t* xf, const float* xs,
                           const int8_t* w, const void* mult, const float* s_col,
                           int32_t* partial, void* out, int out_kind, int M, int K, int N,
                           int group, const RowsPlan& pl, int bn, int depth,
                           cudaStream_t stream) {
  switch (tiles_of(M)) {
    case 1:
      return launch_rows_tile<LAYOUT, PACKED, 1, PAIRS>(tmap, feed, xf, xs, w, mult, s_col,
                                                        partial, out, out_kind, M, K, N, group,
                                                        pl, bn, depth, stream);
    case 2:
      return launch_rows_tile<LAYOUT, PACKED, 2, PAIRS>(tmap, feed, xf, xs, w, mult, s_col,
                                                        partial, out, out_kind, M, K, N, group,
                                                        pl, bn, depth, stream);
    default:
      return launch_rows_tile<LAYOUT, PACKED, 4, PAIRS>(tmap, feed, xf, xs, w, mult, s_col,
                                                        partial, out, out_kind, M, K, N, group,
                                                        pl, bn, depth, stream);
  }
}

// The whole any-group GEMV: stage x (M, K) into xf (the wrapper sizes it:
// rows_plan's x_bytes) by stage_rows_kernel, the tile, and with n_split > 1
// (f32 or bf16 out) rows_epilogue_kernel. Weights flat (K/2, N) or
// pre-blocked (N/bn, K/2, bn); mult int8 (K/g, N) or PACKED nibble-packed
// int32. cudaErrorInvalidValue for a shape the plan does not cover.
template <int LAYOUT, bool PACKED>
cudaError_t launch_rows(const int8_t* x, const float* xs, const int8_t* w, const void* mult,
                        const float* s_col, int8_t* xf, int32_t* partial, void* out,
                        int out_kind, int M, int K, int N, int group, int n_split, int bn,
                        int depth, cudaStream_t stream) {
  if (M < 1 || N < 1 || n_split < 1 || depth < 1 || out_kind < kOutF32 ||
      out_kind > kOutPartials || !layout_takes<LAYOUT>(K, group) || bn < 0 ||
      (bn > 0 && N % bn != 0) || (long long)(K + 2) * group >= (1ll << 32))
    return cudaErrorInvalidValue;
  const RowsPlan pl = rows_plan_of(LAYOUT, PACKED, K, group, n_split);
  if (pl.n_split != n_split || pl.rps > kMaxSplitRows ||
      rows_smem_bytes(tiles_of(M), depth, pl.mult_bytes) > 232448 ||
      ((n_split > 1 || out_kind == kOutPartials) && partial == nullptr))
    return cudaErrorInvalidValue;
  const int mt = tiles_of(M);
  const long long words = (long long)(staged_rows(M) / (16 * mt)) * n_split * pl.stages *
                          (a_stage_bytes(mt) / 4);
  stage_rows_kernel<LAYOUT><<<(unsigned)((words + 255) / 256), 256, 0, stream>>>(
      x, xf, M, K, group, pl.rps, n_split, pl.stages, mt, words);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the feed: the tile's TMA box and bulk copies where rows are 16-byte
  // runs and a block's columns lie in one panel, else 4-byte words, else
  // bytes
  const int pitch = bn > 0 ? bn : N;
  const bool words_ok = N % 4 == 0 && pitch % 4 == 0 &&
                        reinterpret_cast<uintptr_t>(w) % 4 == 0 &&
                        reinterpret_cast<uintptr_t>(mult) % 4 == 0;
  const bool mult_ok = reinterpret_cast<uintptr_t>(mult) % 16 == 0 && (PACKED || N % 16 == 0);
  CUtensorMap tmap = {};
  const bool tma = words_ok && mult_ok && (bn == 0 || bn % kN == 0) &&
                   cached_weight_map(&tmap, w, pitch,
                                     bn > 0 ? (long long)(N / bn) * (K / 2) : K / 2, pitch);
  const int feed = tma ? kFeedTma : words_ok ? kFeedWords : kFeedBytes;
  err = pl.pairs ? launch_rows_mt<LAYOUT, PACKED, true>(tmap, feed, xf, xs, w, mult, s_col,
                                                        partial, out, out_kind, M, K, N, group,
                                                        pl, bn, depth, stream)
                 : launch_rows_mt<LAYOUT, PACKED, false>(tmap, feed, xf, xs, w, mult, s_col,
                                                         partial, out, out_kind, M, K, N, group,
                                                         pl, bn, depth, stream);
  if (err != cudaSuccess || n_split == 1 || out_kind == kOutPartials) return err;
  const long long outs = (long long)M * N;
  const unsigned blocks = (unsigned)((outs + 255) / 256);
  if (out_kind == kOutBf16)
    rows_epilogue_kernel<__nv_bfloat16><<<blocks, 256, 0, stream>>>(
        partial, n_split, M, N, s_col, xs, static_cast<__nv_bfloat16*>(out));
  else
    rows_epilogue_kernel<float><<<blocks, 256, 0, stream>>>(partial, n_split, M, N, s_col, xs,
                                                           static_cast<float*>(out));
  return cudaGetLastError();
}

}  // namespace mma8
}  // namespace ff
