// Hopper's int8 warpgroup MMA for the weight-streaming products of the
// float-scale modes: the W8A8 GEMM (w8a8_gemm.cu, row 19) and the W4A8 GEMV
// with f32 group scales (w4a8_halves.cu ff_w4a8_gemv_halves, row 16).
//
// The transposed product out^T = w^T x^T, as in w4_gemv.cu (row 17):
// - The weights are wgmma's A operand, from registers. A block owns kBN =
//   128 weight columns: two consumer warpgroups of 64 columns each and one
//   producer warp. A thread's two A rows (gid, gid + 8 of its warp) are the
//   adjacent columns cb, cb + 1, cb = 64 wg + 16 (warp % 4) + 2 gid.
// - x (M, K) int8 is the B operand: K-major in shared memory as TMA lands
//   it, one box of 128 k (128 bytes, the 128B swizzle's width) by the
//   block's token rows a stage; wgmma's n is the token rows of the block.
//   Token rows past M arrive as zeros.
// - The at-rest weights are N-contiguous (W8A8 (K, N) int8; W4A8 (K/2, N)
//   pack_int4 group halves), and int8 wgmma reads only K-major operands
//   from shared memory: so the weights land by TMA as they lie (128 columns
//   of 128-byte rows, 128B-swizzled) and each thread transposes its bytes
//   into A registers, "4 consecutive k of column cb" and "of column cb +
//   1" (the 4 x 4 byte transposition of mma.cuh, on two columns): one
//   ldmatrix.x4.trans (a column pair as one 16-bit element, four matrices
//   of 8 k rows) and four byte permutes give a thread the words of 32 k
//   rows (lane_of, col_words). It replaced 16-bit loads of one k row each,
//   which took 16% of the prefill's time (PERF.md §6). No second copy
//   of the weights is made.
// - A ring of `depth` stages, a full and an empty mbarrier each (the
//   producer's one arrival with the TMA transaction count; the weights'
//   4-byte cp.async feed, where N % 16 != 0, adds its 32 lanes' arrivals).
// - K splits over the blocks of a thread-block cluster; each block writes
//   its tile (int32 partials, or f32 window sums) to its own shared memory
//   and, after a cluster barrier, block r reduces token rows r, r +
//   n_split, ... over the cluster's blocks through distributed shared
//   memory in split order. No partial goes through device memory.

#pragma once

#include "w4_wgmma.cuh"  // wgmma fence/commit/wait, x_desc, mbarriers, TMA boxes, tensor maps

namespace ff {
namespace i8w {

constexpr int kBN = 128;                         // weight columns a block
constexpr int kBK = 128;                         // k a stage: one x box row of 128 bytes
constexpr int kConsumers = 2;                    // consumer warpgroups, 64 columns each
constexpr int kThreads = 128 * kConsumers + 32;  // and the producer warp
constexpr int kRedPitch = kBN + 8;               // 4-byte words a token row of the reduction tile
constexpr int kMaxSplit = 8;                     // blocks of a cluster (portable)
// Token rows a block: wgmma's n. At n = 256 the 128 accumulators a thread
// and the A registers do not fit the 168 registers that 9 warps a block
// leave each (an SM's sub-partition holds three of them), and ptxas
// serializes the products.
constexpr int kMaxRows = 192;

// wgmma's n for rows <= kMaxRows token rows (kernels/matmul.py _I8_TILES).
__host__ __device__ constexpr int tile_n(int rows) {
  return rows <= 8 ? 8 : rows <= 16 ? 16 : rows <= 32 ? 32 : rows <= 48 ? 48 : rows <= 64 ? 64
       : rows <= 96 ? 96 : rows <= 128 ? 128 : 192;
}

template <int N>
struct Mma;

// d (64 weight columns x N token rows, s32) = a (registers: this thread's
// int8 quadruples of the 64 x 32 A tile) . B (x, 32 k x N rows, at `desc`),
// plus d where `accumulate` (else d is overwritten).
template <>
struct Mma<8> {
  static __device__ __forceinline__ void run(int (&d)[4], const unsigned (&a)[4], uint64_t desc,
                                             int accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 "
        "{%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, %8, p;\n"
        "}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
  }
};

template <>
struct Mma<16> {
  static __device__ __forceinline__ void run(int (&d)[8], const unsigned (&a)[4], uint64_t desc,
                                             int accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p;\n"
        "}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
  }
};

template <>
struct Mma<32> {
  static __device__ __forceinline__ void run(int (&d)[16], const unsigned (&a)[4], uint64_t desc,
                                             int accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p;\n"
        "}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
  }
};

template <>
struct Mma<48> {
  static __device__ __forceinline__ void run(int (&d)[24], const unsigned (&a)[4], uint64_t desc,
                                             int accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23}, "
        "{%24, %25, %26, %27}, %28, p;\n"
        "}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
  }
};

template <>
struct Mma<64> {
  static __device__ __forceinline__ void run(int (&d)[32], const unsigned (&a)[4], uint64_t desc,
                                             int accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p;\n"
        "}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
  }
};

template <>
struct Mma<96> {
  static __device__ __forceinline__ void run(int (&d)[48], const unsigned (&a)[4], uint64_t desc,
                                             int accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
        "{%48, %49, %50, %51}, %52, p;\n"
        "}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
  }
};

template <>
struct Mma<128> {
  static __device__ __forceinline__ void run(int (&d)[64], const unsigned (&a)[4], uint64_t desc,
                                             int accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p;\n"
        "}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
  }
};

template <>
struct Mma<192> {
  static __device__ __forceinline__ void run(int (&d)[96], const unsigned (&a)[4], uint64_t desc,
                                             int accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %101, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
        "{%96, %97, %98, %99}, %100, p;\n"
        "}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
  }
};

__device__ __forceinline__ void fence_reg(int& r) { asm volatile("" : "+r"(r)::"memory"); }

// A consumer thread's place in a stage's weight rows, for ldmatrix: a
// column pair (cb, cb + 1) is one 16-bit element, and ldmatrix.x4.trans of
// four 8 x 8 matrices whose rows this lane addresses gives a thread
// (gid, tid) the pair gid of its warp's 16 columns at two k rows a matrix.
// Lane L addresses row r = L % 8 of matrix j = L / 8 = 2h + m: k row 16 h +
// 4 (r / 2) + 2 (m ^ (r / 4)) + r % 2 of a 32-row run, so matrix m of half
// h gives thread tid the k rows 4 tid + {0, 1} (m = 0) or + {2, 3} (m = 1),
// swapped for tid >= 2: then the 8 rows of a matrix lie in 8 distinct
// 16-byte chunks of the 128B swizzle (no bank conflict). `off` is the
// lane's row address in the run (swizzled), `sel_lo` / `sel_hi` the byte
// permutes that turn a matrix pair into column cb's and cb + 1's words.
struct Lane {
  int off;
  unsigned sel_lo, sel_hi;
};

__device__ __forceinline__ Lane lane_of(int cb, int tid) {
  const int lane = threadIdx.x % 32, r = lane % 8, j = lane / 8;
  const int k = 16 * (j / 2) + 4 * (r / 2) + 2 * ((j % 2) ^ (r / 4)) + r % 2;
  Lane l;
  l.off = k * kBN + (((cb >> 4) ^ (k & 7)) << 4);
  l.sel_lo = tid & 2 ? 0x2064u : 0x6420u;
  l.sel_hi = tid & 2 ? 0x3175u : 0x7531u;
  return l;
}

// Byte rows r0 + 4 tid .. + 3 and r0 + 16 + 4 tid .. + 3 (r0 % 32 == 0) of
// a stage's swizzled weight rows `w`: c[0] column cb's 4 bytes of the first
// run (row r0 + 4 tid in byte 0), c[1] column cb + 1's, c[2], c[3] the same
// of the second run.
__device__ __forceinline__ void col_words(const unsigned char* w, const Lane& l, int r0,
                                          unsigned (&c)[4]) {
  unsigned m[4];
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(m[0]), "=r"(m[1]), "=r"(m[2]), "=r"(m[3])
               : "r"(smem_u32(w + r0 * kBN + l.off))
               : "memory");
  c[0] = __byte_perm(m[0], m[1], l.sel_lo);
  c[1] = __byte_perm(m[0], m[1], l.sel_hi);
  c[2] = __byte_perm(m[2], m[3], l.sel_lo);
  c[3] = __byte_perm(m[2], m[3], l.sel_hi);
}

// The consumer warpgroups' barrier (named barrier 2; the producer warp
// does not take part).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 2, %0;\n" ::"n"(128 * kConsumers) : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

// Four 32-bit words at shared address `addr` of block `rank` of the cluster.
__device__ __forceinline__ uint4 ld_cluster(unsigned addr, unsigned rank) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  uint4 v;
  asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}

// Two adjacent outputs, rounded once to the output type.
__device__ __forceinline__ void store2(void* out, size_t at, int out_bf16, float a, float b) {
  if (out_bf16)
    *reinterpret_cast<unsigned*>(static_cast<__nv_bfloat16*>(out) + at) = pack_bf16x2(a, b);
  else
    *reinterpret_cast<float2*>(static_cast<float*>(out) + at) = make_float2(a, b);
}

__device__ __forceinline__ void store4(void* out, size_t at, int out_bf16, float4 v) {
  if (out_bf16)
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(out) + at) =
        make_uint2(pack_bf16x2(v.x, v.y), pack_bf16x2(v.z, v.w));
  else
    *reinterpret_cast<float4*>(static_cast<float*>(out) + at) = v;
}

// The producer warp's weight rows of one stage where they take no TMA box
// (N % 16 != 0): lane copies the 4-byte word at column n0 + 4 lane of each
// of `rows` byte rows from `row0` (of `total` rows, N bytes apart) to its
// swizzled place in `dst`; zeros past the tensor (N % 4 == 0: a word is in
// or out whole); the lanes arrive on `full` when their copies land.
__device__ __forceinline__ void copy_weight_rows(unsigned char* dst, const int8_t* w, int n0,
                                                 int N, int row0, int rows, int total,
                                                 uint64_t* full, int lane) {
  const int c = n0 + 4 * lane;
  for (int r = 0; r < rows; ++r) {
    const int row = row0 + r;
    const bool ok = c < N && row < total;
    cp_async<4>(dst + r * kBN + (((lane / 4) ^ (r & 7)) << 4) + 4 * (lane % 4),
                ok ? w + (size_t)row * N + c : w, ok);
  }
  cp_async_arrive(full);
}

// Launch `kernel` on a grid of (n_split, gy, gz) blocks of kThreads
// threads in clusters of (n_split, 1, 1), `smem` bytes of dynamic shared
// memory.
template <typename Kernel, typename... Args>
cudaError_t launch_clusters(Kernel kernel, int n_split, int gy, int gz, size_t smem,
                            cudaStream_t st, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, gy, gz);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace i8w
}  // namespace ff
