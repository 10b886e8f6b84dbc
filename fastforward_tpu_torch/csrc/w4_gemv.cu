// Weight-only int4 GEMV (FF_BENCH_MODE=w4a16) on Hopper's warpgroup
// tensor cores: bf16 activations against packed int4 weights, each weight
// dequantized once a call straight into wgmma's register operand.
//
// Replaces: fastforward_tpu/kernels/matmul.py matmul_w4_gemv (:262, kernel
// _w4_gemv_kernel :240, pallas_call :281), which matmul_w4a16 (:1832)
// takes up to 256 rows.
//   w[k, n] = bf16(float(v[k, n]) * s[k / g, n])        (one rounding)
//   y[m, n] = sum_k x[m, k] * w[k, n]                    (f32 accumulation)
// x (M <= 256, K) bf16, w (K/2, N) in pack_int4's group halves (byte row i
// of group p: k = pg + i low nibble, pg + g/2 + i high, two's complement),
// s (K/g, N) f32, any group the reference takes (g even, K a whole number
// of groups); y (M, N) f32 or bf16, rounded once. The dequant rounds
// as dequantize_int4's CPU path (the TPU kernel rounds the scale to bf16
// and multiplies in bf16 instead, :256). The f32 sums run in the tensor
// cores' order and, split over K, add the splits in split order: held
// within a stated tolerance of the plain version, the same bits call to
// call.
//
// Bound on the H100, a Llama-3-8B layer's four projections (K x N: 4096 x
// 6144, 4096 x 4096, 4096 x 28672, 14336 x 4096), g128: 109 MB of packed
// weights and 1.7 MB of scales (0.033 ms at 3.35 TB/s) against 2 M K N
// bf16 operations: at M = 192 8.4e10 (0.085 ms at 989 TFLOP/s,
// operations), at M = 8 3.5e9 (0.0035 ms: the bytes bound, 0.033 ms).
//
// What bounds it (PERF.md §7): at M = 192 the x tiles, which every column
// block reads again from L2 (~6x the weight bytes), and the dequant's issue
// beside the tensor cores; at M = 8 the dequant's issue and latency on
// the consumer warps.
//
// Design (the transposed product of w4_wgmma.cuh, sized for decode):
// - out^T = w^T x^T. The weights are wgmma's A operand from registers (64
//   weight columns a consumer warpgroup, a thread's two A rows the adjacent
//   columns cb, cb + 1, so one 16-bit load of a byte row feeds both); x is
//   the B operand, K-major in shared memory as TMA lands it with the 128B
//   swizzle. Every token row of the call is on the wgmma N side: one
//   m64nNk16 with n = M rounded up to 8, 16, 32, 64, 128, 192 or 256 (one
//   instruction of n = 192 ran faster than three of 64 at M = 192). So each
//   weight is dequantized once a call; token rows past M arrive from TMA as
//   zeros. (At n = 256 the accumulators leave ptxas too few registers to
//   keep the wgmmas asynchronous: M = 193-256 runs serialized.)
// - Row 17's dequant, exactly: a nibble at bit b of a word becomes the
//   float 2^(23-b) + u (u = v + 8, offset binary) by one AND-XOR of the
//   word with the exponent bits (bit 3 of the nibble flipped), minus
//   2^(23-b) + 8 (exact: v), one __fmul_rn by the f32 scale (the
//   reference's f32 product, rounded once), and cvt.rn.bf16x2.f32 of two
//   such products (its bf16 rounding). Two byte rows of a column sit in
//   bytes 0 and 1 of a word (one byte permute), so the four nibbles are at
//   bits 0, 8 (low plane) and 4, 12 (high plane); the masks live in
//   registers so the AND-XOR is one LOP3. About four instructions a weight.
// - A block owns 128 weight columns: two consumer warpgroups and one
//   producer warp. The producer keeps a ring of `depth` stages in flight,
//   each 128 k: x as two 64-k boxes (every token row), the 64 packed byte
//   rows as one 128B-swizzled box and the 128 / g scale rows as one box; a
//   4-byte cp.async feed where N % 16 != 0. A group of g = 128 j (j >= 2)
//   spans j stages: a stage's two x boxes are then the 64-k runs of its
//   byte rows' low and high nibbles (w4_wgmma.cuh stage_k), g/2 apart, and
//   its one scale row the group's, so the consumers read it as at g 128.
//   Every other group reads x permuted into byte-row order (w4_wgmma.cuh
//   permute_x, one pass before the GEMV: a stage then reads it as at g 32)
//   and the scale rows of every group its 64 byte rows touch; each pair of
//   byte rows is dequantized with its two rows' own scales.
//   A consumer warpgroup works a stage in two halves of four k16 steps: it
//   issues a half's wgmmas (async) and dequantizes the next half into the
//   other register set while they run, then waits for them.
// - Split-K where the column blocks fall short of the card: K splits over
//   whole stages (whole groups), 1-8 ways. The splits of a column block
//   form one thread-block cluster; a cluster must fit in one GPC, so larger
//   ones leave SMs idle, and each block pays the ring's fill and the
//   reduction. kernels/matmul.py w4_plan weighs both (at M = 192: 2 splits
//   for qkv, 3 for o and down, 1 for gate/up). Each block
//   writes its f32 tile to its own shared memory; after a cluster barrier
//   block r sums token rows r, r + n_split, ... over the cluster's blocks
//   through distributed shared memory in split order, rounds once and
//   stores. No partial goes through device memory, no float atomics: two
//   calls give the same bits.

#include "w4_wgmma.cuh"  // the wgmma helpers, mbarriers, TMA boxes, tensor maps

namespace ff {
namespace w4v {

constexpr int kBN = 128;                          // weight columns a block
constexpr int kBK = 128;                          // k a stage
constexpr int kRows = kBK / 2;                    // packed byte rows a stage
constexpr int kConsumers = 2;                     // consumer warpgroups, 64 columns each
constexpr int kThreads = 128 * kConsumers + 32;   // and the producer warp
constexpr int kWBytes = kRows * kBN;              // 8 KB
constexpr int kSBytes = (kBK / 32) * kBN * 4;     // the scale rows at g 32: 2 KB
constexpr int kRedPitch = kBN + 8;                // floats a token row of the reduction tile
constexpr int kMaxSplit = 8;                      // blocks of a cluster (portable)
constexpr int kMaxRows = 256;                     // token rows a call

// The wgmma n a call issues at M token rows (kernels/matmul.py w4_plan).
__host__ __device__ constexpr int tile_n(int M) {
  return M <= 8 ? 8 : M <= 16 ? 16 : M <= 32 ? 32 : M <= 64 ? 64 : M <= 128 ? 128 : M <= 192 ? 192 : 256;
}

// Shared bytes of one ring stage at `rows` token rows (x, weights, scales;
// a multiple of 1024: every box starts on the swizzle's period).
__host__ __device__ constexpr int stage_bytes(int rows) { return 2 * rows * 128 + kWBytes + kSBytes; }

// The same on the permuted route (w4_wgmma.cuh perm_scale_bytes: the scale
// rows of every group a stage touches).
__host__ __device__ inline int perm_stage_bytes(int rows, int K, int group) {
  return 2 * rows * 128 + kWBytes + w4g::perm_scale_bytes(K, group, kBN);
}

// The ring of `stage`-byte stages (or the reduction tile, which reuses it),
// its barriers and the slack to align it to 1024 bytes.
inline size_t smem_bytes(int rows, int depth, int stage) {
  const size_t ring = (size_t)depth * stage, red = (size_t)rows * kRedPitch * 4;
  return (ring > red ? ring : red) + (size_t)depth * 16 + 1024;
}
inline size_t smem_bytes(int rows, int depth) { return smem_bytes(rows, depth, stage_bytes(rows)); }

template <int N>
struct Wgmma;

// d (64 weight columns x N token rows, f32) += a (registers: this thread's
// bf16 pairs of the 64 x 16 A tile) . B (x, 16 k x N rows, at `desc`).
template <>
struct Wgmma<8> {
  static __device__ __forceinline__ void run(float (&d)[4], const unsigned (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void run(float (&d)[8], const unsigned (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void run(float (&d)[16], const unsigned (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void run(float (&d)[32], const unsigned (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void run(float (&d)[64], const unsigned (&a)[4], uint64_t desc) {
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
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<192> {
  static __device__ __forceinline__ void run(float (&d)[96], const unsigned (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %101, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
        "{%96, %97, %98, %99}, %100, p, 1, 1, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<256> {
  static __device__ __forceinline__ void run(float (&d)[128], const unsigned (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

// The bf16 pair (lo in the low half) of two f32 values, each rounded once.
__device__ __forceinline__ unsigned cvt_bf16x2(float lo, float hi) {
  unsigned r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// (p & mask) ^ magic in one LOP3: the mask comes in a register (two
// immediates do not fit one instruction).
template <unsigned MAGIC>
__device__ __forceinline__ unsigned and_xor(unsigned p, unsigned mask) {
  unsigned r;
  asm("lop3.b32 %0, %1, %2, %3, 0x6a;\n" : "=r"(r) : "r"(p), "r"(mask), "n"(MAGIC));
  return r;
}

// The A register of a column's two byte rows r (k even) and r + 1 in bytes
// 0 and 1 of `p`, low nibble plane (HI false: bits 0 and 8) or high plane
// (bits 4 and 12), times the column's f32 scale: v exactly as 2^(23-b) + u
// minus 2^(23-b) + 8, one f32 product, one bf16 rounding. mk: the masks
// 0xF, 0xF00, 0xF0, 0xF000 in registers.
template <bool HI>
__device__ __forceinline__ unsigned dequant_reg(unsigned p, float s, const unsigned (&mk)[4]) {
  float v0, v1;
  if (HI) {
    v0 = __fadd_rn(__uint_as_float(and_xor<0x49000080u>(p, mk[2])), -524296.0f);  // 2^19 + 8
    v1 = __fadd_rn(__uint_as_float(and_xor<0x45008000u>(p, mk[3])), -2056.0f);    // 2^11 + 8
  } else {
    v0 = __fadd_rn(__uint_as_float(and_xor<0x4B000008u>(p, mk[0])), -8388616.0f);  // 2^23 + 8
    v1 = __fadd_rn(__uint_as_float(and_xor<0x47000800u>(p, mk[1])), -32776.0f);    // 2^15 + 8
  }
  return cvt_bf16x2(__fmul_rn(v0, s), __fmul_rn(v1, s));
}

// The same with row r's scale s0 and row r + 1's s1 (the permuted route:
// the two rows may lie in two groups).
template <bool HI>
__device__ __forceinline__ unsigned dequant_reg2(unsigned p, float s0, float s1,
                                                 const unsigned (&mk)[4]) {
  float v0, v1;
  if (HI) {
    v0 = __fadd_rn(__uint_as_float(and_xor<0x49000080u>(p, mk[2])), -524296.0f);
    v1 = __fadd_rn(__uint_as_float(and_xor<0x45008000u>(p, mk[3])), -2056.0f);
  } else {
    v0 = __fadd_rn(__uint_as_float(and_xor<0x4B000008u>(p, mk[0])), -8388616.0f);
    v1 = __fadd_rn(__uint_as_float(and_xor<0x47000800u>(p, mk[1])), -32776.0f);
  }
  return cvt_bf16x2(__fmul_rn(v0, s0), __fmul_rn(v1, s1));
}

// A consumer thread's fixed offsets into a stage (every stage has the same
// layout): its two columns' 16-bit words in byte rows 2 tid and 2 tid + 1 of
// the swizzled weight box (rows 8 and 16 further keep the swizzle: it
// XORs by row % 8), its scale of run q's group, and the x bytes of run q's
// low and high k (the group-halves layout: the low plane at k = pg + i, the
// high one g/2 further).
struct Thread {
  int w[2], s[4], xlo[4], xhi[4];
  unsigned mk[4];
};

__device__ __forceinline__ Thread thread_of(int cb, int tid, int group, int xhalf) {
  Thread t;
  const int chunk = cb >> 4, off = cb & 15;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = 2 * tid + j;
    t.w[j] = 2 * xhalf + row * kBN + ((chunk ^ row) << 4) + off;
  }
  const int half = group / 2;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int grp = 16 * q / half, lo = grp * group + 16 * q % half, hi = lo + half;
    t.s[q] = 2 * xhalf + kWBytes + 4 * (grp * kBN + cb);
    t.xlo[q] = lo / 64 * xhalf + lo % 64 / 16 * 32;
    t.xhi[q] = hi / 64 * xhalf + hi % 64 / 16 * 32;
  }
  // opaque to the compiler, so each mask stays one register
  asm volatile("mov.b32 %0, 0xF;\n" : "=r"(t.mk[0]));
  asm volatile("mov.b32 %0, 0xF00;\n" : "=r"(t.mk[1]));
  asm volatile("mov.b32 %0, 0xF0;\n" : "=r"(t.mk[2]));
  asm volatile("mov.b32 %0, 0xF000;\n" : "=r"(t.mk[3]));
  return t;
}

// The A fragments of half HH of the stage at `st` (runs 2HH, 2HH + 1) for
// this thread: a[2j] the low plane of run 2HH + j, a[2j + 1] its high
// plane, registers as m64k16's A (rows gid, gid + 8: the columns cb, cb +
// 1; k 2tid.., 2tid + 8..).
template <int HH>
__device__ __forceinline__ void dequant_half(const unsigned char* st, const Thread& t,
                                             unsigned (&a)[4][4]) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int q = 2 * HH + j;
    const float2 sv = *reinterpret_cast<const float2*>(st + t.s[q]);
    unsigned h[4];  // byte rows 16q + 2tid, + 1, + 8, + 9: column cb in byte 0, cb + 1 in byte 1
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = *reinterpret_cast<const unsigned short*>(st + t.w[i & 1] +
                                                      (16 * q + 8 * (i >> 1)) * kBN);
    // a column's bytes of two rows at bytes 0 and 1: column cb, then cb + 1
    const unsigned p[4] = {__byte_perm(h[0], h[1], 0x0040), __byte_perm(h[0], h[1], 0x0051),
                           __byte_perm(h[2], h[3], 0x0040), __byte_perm(h[2], h[3], 0x0051)};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float sc = r % 2 ? sv.y : sv.x;
      a[2 * j][r] = dequant_reg<false>(p[r], sc, t.mk);
      a[2 * j + 1][r] = dequant_reg<true>(p[r], sc, t.mk);
    }
  }
}

// dequant_half on the permuted route: byte rows 16q + 2tid, + 1, + 8, + 9
// take the scales of their own groups, scale rows gd(rem + row) of the
// stage's (rem: its first byte row's place in its group).
template <int HH>
__device__ __forceinline__ void dequant_half_perm(const unsigned char* st, const Thread& t,
                                                  int sbase, int cb, int tid,
                                                  const w4g::GroupDiv& gd, int rem,
                                                  unsigned (&a)[4][4]) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int q = 2 * HH + j;
    float2 sv[4];
    unsigned h[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = 16 * q + 2 * tid + (i & 1) + 8 * (i >> 1);
      sv[i] = *reinterpret_cast<const float2*>(st + sbase + 4 * (gd(rem + row) * kBN + cb));
      h[i] = *reinterpret_cast<const unsigned short*>(st + t.w[i & 1] +
                                                      (16 * q + 8 * (i >> 1)) * kBN);
    }
    const unsigned p[4] = {__byte_perm(h[0], h[1], 0x0040), __byte_perm(h[0], h[1], 0x0051),
                           __byte_perm(h[2], h[3], 0x0040), __byte_perm(h[2], h[3], 0x0051)};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float2 s0 = sv[r / 2 * 2], s1 = sv[r / 2 * 2 + 1];
      const float a0 = r % 2 ? s0.y : s0.x, a1 = r % 2 ? s1.y : s1.x;
      a[2 * j][r] = dequant_reg2<false>(p[r], a0, a1, t.mk);
      a[2 * j + 1][r] = dequant_reg2<true>(p[r], a0, a1, t.mk);
    }
  }
}

// Issue half HH of a stage's products: its four k16 steps on `a`, each
// against every token sub-tile of x at shared address `xb`, as one
// committed group (queued behind the previous half's).
template <int NT, int HH>
__device__ __forceinline__ void issue_half(unsigned xb, const Thread& t, float (&acc)[NT / 2],
                                           unsigned (&a)[4][4]) {
  w4g::wgmma_fence();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = 2 * HH + i / 2;
    Wgmma<NT>::run(acc, a[i], w4g::x_desc(xb + (i % 2 ? t.xhi[q] : t.xlo[q])));
  }
  w4g::wgmma_commit();
}

// Wait until at most one group is in flight (the one just issued), which
// frees the registers of the group before it.
__device__ __forceinline__ void retire(unsigned (&a)[4][4]) {
  w4g::wgmma_wait<1>();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) w4g::fence_reg(a[i][r]);
}

// The consumer warpgroups' barrier (named barrier 2; the producer warp
// does not take part).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 2, %0;\n" ::"n"(128 * kConsumers) : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

// Four floats at shared address `addr` of block `rank` of the cluster.
__device__ __forceinline__ float4 ld_cluster(unsigned addr, unsigned rank) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}

__device__ __forceinline__ void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(cvt_bf16x2(v.x, v.y), cvt_bf16x2(v.z, v.w));
}

// Grid (n_split, column blocks), clusters of (n_split, 1, 1); kThreads
// threads; dynamic shared memory smem_bytes(NT, depth) (PERM: at
// perm_stage_bytes). x_map: x (M, K) bf16 (PERM: xp), boxes of 64 k x NT
// rows; w_map (when w_tma): w's (K/2, N) bytes, boxes of kBN x kRows; s_map:
// s (K/g, N) f32, boxes of kBN x max(1, kBK / g) (PERM: perm_scale_box).
// Split z streams the stages [z sps, min(stages, (z + 1) sps)) of ceil(K /
// kBK).
template <int NT, typename OutT, bool PERM = false>
__global__ void __launch_bounds__(kThreads, NT <= 64 ? 2 : 1)
w4_gemv_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                     const __grid_constant__ CUtensorMap w_map,
                     const __grid_constant__ CUtensorMap s_map, int w_tma,
                     const int8_t* __restrict__ w, OutT* __restrict__ out, int M, int K, int N,
                     int group, int n_split, int depth) {
  constexpr int kXRows = NT;
  constexpr int kXHalf = kXRows * 128;  // one 64-k box of x
  const int kStage = PERM ? perm_stage_bytes(kXRows, K, group) : stage_bytes(kXRows);
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzle's 1024-byte period (smem_bytes asks for the slack)
  unsigned char* smem = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  const size_t ring = (size_t)depth * kStage, red_bytes = (size_t)kXRows * kRedPitch * 4;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + (ring > red_bytes ? ring : red_bytes));
  uint64_t* empty = full + depth;
  const int split = blockIdx.x, n0 = blockIdx.y * kBN;
  const int total = (K + kBK - 1) / kBK, sps = (total + n_split - 1) / n_split;
  const int s0 = split * sps, stages = min(total, s0 + sps) - s0;
  const int kSRows = PERM ? w4g::perm_scale_box(K, group) : group > kBK ? 1 : kBK / group;
  const w4g::GroupDiv gd(PERM ? group : 2, kSRows - 1);
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

  float* red = reinterpret_cast<float*>(smem);  // [kXRows][kRedPitch], after the ring's last use
  if (warp == 4 * kConsumers) {
    // ---- the producer warp
    for (int s = 0; s < stages; ++s) {
      const int slot = s % depth, sg = s0 + s;
      if (s >= depth) mma8::mbar_wait_or_trap(empty + slot, ((s / depth) - 1) & 1);
      unsigned char* st = smem + (size_t)slot * kStage;
      if (lane == 0) {
        int k_lo, k_hi;
        w4g::stage_k(sg, PERM ? kBK : group, k_lo, k_hi);
        mma8::mbar_arrive_expect_tx(full + slot,
                                    2 * kXHalf + (w_tma ? kWBytes : 0) + kSRows * kBN * 4);
        mma8::tma_box(st, &x_map, k_lo, 0, full + slot);
        mma8::tma_box(st + kXHalf, &x_map, k_hi, 0, full + slot);
        if (w_tma) mma8::tma_box(st + 2 * kXHalf, &w_map, n0, sg * kRows, full + slot);
        mma8::tma_box(st + 2 * kXHalf + kWBytes, &s_map, n0,
                      PERM ? sg * kRows / gd.h : group > kBK ? k_lo / group : sg * kSRows,
                      full + slot);
      }
      if (!w_tma) {
        // lane: the 4-byte word at column 4 lane of each byte row, to its
        // swizzled place; zeros past the tensor (N % 4 == 0: a word is in
        // or out whole)
        const int c = n0 + 4 * lane;
        for (int r = 0; r < kRows; ++r) {
          const int row = sg * kRows + r;
          const bool ok = c < N && row < K / 2;
          cp_async<4>(st + 2 * kXHalf + r * kBN + (((lane / 4) ^ (r & 7)) << 4) + 4 * (lane % 4),
                      ok ? w + (size_t)row * N + c : w, ok);
        }
        cp_async_arrive(full + slot);
      }
    }
    if (!w_tma) mma8::cp_async_wait_all();
  } else {
    // ---- the consumer warpgroups: 64 weight columns each, every token row
    const int wg = warp / 4, gid = lane / 4, tid = lane % 4;
    const int cb = 64 * wg + 16 * (warp % 4) + 2 * gid;  // this thread's columns cb, cb + 1
    const Thread t = thread_of(cb, tid, PERM ? 32 : group > kBK ? kBK : group, kXHalf);
    const int sbase = 2 * kXHalf + kWBytes;  // the stage's scale rows
    // the first half's fragments (the permuted route: from its groups' scales)
    auto first_half = [&](const unsigned char* st, int sg, unsigned(&a)[4][4]) {
      if constexpr (PERM)
        dequant_half_perm<0>(st, t, sbase, cb, tid, gd, sg * kRows % gd.h, a);
      else
        dequant_half<0>(st, t, a);
    };
    float acc[NT / 2];
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) acc[i] = 0.f;
    unsigned a0[4][4], a1[4][4];
    // A stage's two halves run on a0 and a1: while one half's products
    // run, the other's fragments are dequantized; a stage's slot goes back
    // to the producer once its second half's products are done.
    int slot = 0;
    unsigned phase = 0;
    mma8::mbar_wait_or_trap(full, 0);
    first_half(smem, s0, a0);
    for (int s = 0; s < stages; ++s) {
      const unsigned char* st = smem + (size_t)slot * kStage;
      const unsigned xb = smem_u32(st);
      issue_half<NT, 0>(xb, t, acc, a0);
      retire(a1);  // the previous stage's second half is done: its slot is free
      if (s > 0 && threadIdx.x % 128 == 0)
        mma8::mbar_arrive(empty + (slot == 0 ? depth - 1 : slot - 1));
      if constexpr (PERM)
        dequant_half_perm<1>(st, t, sbase, cb, tid, gd, (s0 + s) * kRows % gd.h, a1);
      else
        dequant_half<1>(st, t, a1);
      issue_half<NT, 1>(xb, t, acc, a1);
      retire(a0);
      if (s + 1 < stages) {
        if (++slot == depth) {
          slot = 0;
          phase ^= 1;
        }
        mma8::mbar_wait_or_trap(full + slot, phase);
        first_half(smem + (size_t)slot * kStage, s0 + s + 1, a0);
      }
    }
    w4g::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) w4g::fence_reg(acc[i]);
    consumers_sync();  // both warpgroups are past the ring
    // acc[4i + h] is column cb, acc[4i + 2 + h] column cb + 1, of token row
    // 8i + 2tid + h
#pragma unroll
    for (int i = 0; i < NT / 8; ++i)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        *reinterpret_cast<float2*>(red + (8 * i + 2 * tid + hr) * kRedPitch + cb) =
            make_float2(acc[4 * i + hr], acc[4 * i + 2 + hr]);
  }

  // ---- the cluster's reduction: block `split` sums token rows split,
  // split + n_split, ... over the n_split tiles in split order
  cluster_sync();
  const unsigned red_addr = smem_u32(red);
  const int mine = split < M ? (M - split + n_split - 1) / n_split : 0;
  for (int e = threadIdx.x; e < mine * (kBN / 4); e += kThreads) {
    const int m = split + e / (kBN / 4) * n_split, c4 = 4 * (e % (kBN / 4)), n = n0 + c4;
    if (n >= N) continue;  // N % 4 == 0
    const unsigned at = red_addr + (unsigned)(m * kRedPitch + c4) * 4u;
    float4 v = ld_cluster(at, 0);
    for (int r = 1; r < n_split; ++r) {
      const float4 o = ld_cluster(at, (unsigned)r);
      v = make_float4(__fadd_rn(v.x, o.x), __fadd_rn(v.y, o.y), __fadd_rn(v.z, o.z),
                      __fadd_rn(v.w, o.w));
    }
    store4(out + (size_t)m * N + n, v);
  }
  cluster_sync();  // no block leaves while another reads its tile
}

// Launch the GEMV on a (M, K) x (K/2, N) product; M <= 256,
// w4g::reference_group_ok(K, group), K split n_split ways over whole stages,
// a ring of `depth` stages (the plan of kernels/matmul.py w4_plan). x and s
// must admit a tensor map (16-byte aligned); the weights take the cp.async
// feed where they do not. Where w4g::group_ok does not take the group, x is
// first permuted into xp (M, w4g::perm_cols(K)) bf16, 16-byte aligned.
template <typename OutT>
cudaError_t launch(const void* x, const void* w, const void* s, void* out, void* xp, int M,
                   int K, int N, int group, int n_split, int depth, cudaStream_t st) {
  if (M < 1 || M > kMaxRows || N < 4 || N % 4 != 0 || !w4g::reference_group_ok(K, group) ||
      n_split < 1 || n_split > kMaxSplit)
    return cudaErrorInvalidValue;
  const bool perm = !w4g::group_ok(K, group);
  const int total = (K + kBK - 1) / kBK, sps = (total + n_split - 1) / n_split;
  // a stage's slot is released while the next stage is worked: two slots
  // unless a split streams one stage
  if (depth < (sps > 1 ? 2 : 1)) return cudaErrorInvalidValue;
  const int rows = tile_n(M);
  const size_t smem =
      smem_bytes(rows, depth, perm ? perm_stage_bytes(rows, K, group) : stage_bytes(rows));
  if ((n_split - 1) * sps >= total || smem > 232448 || (perm && xp == nullptr))
    return cudaErrorInvalidValue;
  if (perm) {
    const cudaError_t err = w4g::permute_x<unsigned short>(x, xp, M, K, group, st);
    if (err != cudaSuccess) return err;
  }
  const int xcols = perm ? w4g::perm_cols(K) : K;
  CUtensorMap xm = {}, wm = {}, sm = {};
  if (!mma8::tensor_map(&xm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, perm ? xp : x, xcols, M,
                        2ll * xcols, 64, rows, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !mma8::tensor_map(&sm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, s, N, K / group, 4ll * N, kBN,
                        perm ? w4g::perm_scale_box(K, group) : group > kBK ? 1 : kBK / group,
                        CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  const int w_tma = mma8::tensor_map(&wm, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, N, K / 2, N, kBN,
                                     kRows, CU_TENSOR_MAP_SWIZZLE_128B);
  auto run = [&](auto kernel) -> cudaError_t {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(n_split, (N + kBN - 1) / kBN, 1);
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
    err = cudaLaunchKernelEx(&cfg, kernel, xm, wm, sm, w_tma, static_cast<const int8_t*>(w),
                             static_cast<OutT*>(out), M, K, N, group, n_split, depth);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  };
  if (perm) {
    switch (rows) {
      case 8:
        return run(w4_gemv_wgmma_kernel<8, OutT, true>);
      case 16:
        return run(w4_gemv_wgmma_kernel<16, OutT, true>);
      case 32:
        return run(w4_gemv_wgmma_kernel<32, OutT, true>);
      case 64:
        return run(w4_gemv_wgmma_kernel<64, OutT, true>);
      case 128:
        return run(w4_gemv_wgmma_kernel<128, OutT, true>);
      case 192:
        return run(w4_gemv_wgmma_kernel<192, OutT, true>);
      default:
        return run(w4_gemv_wgmma_kernel<256, OutT, true>);
    }
  }
  switch (rows) {
    case 8:
      return run(w4_gemv_wgmma_kernel<8, OutT>);
    case 16:
      return run(w4_gemv_wgmma_kernel<16, OutT>);
    case 32:
      return run(w4_gemv_wgmma_kernel<32, OutT>);
    case 64:
      return run(w4_gemv_wgmma_kernel<64, OutT>);
    case 128:
      return run(w4_gemv_wgmma_kernel<128, OutT>);
    case 192:
      return run(w4_gemv_wgmma_kernel<192, OutT>);
    default:
      return run(w4_gemv_wgmma_kernel<256, OutT>);
  }
}

}  // namespace w4v
}  // namespace ff

// x (M, K) bf16 (16-byte aligned), w (K/2, N) pack_int4, w_scale (K/g, N)
// f32 (16-byte aligned), out (M, N) f32 or bf16; M <= 256; any group the
// reference takes (g even, K a whole number of groups); xp (M,
// w4g::perm_cols(K)) bf16 scratch where w4g::group_ok does not take the
// group, else null; n_split and depth from kernels/matmul.py w4_plan.
extern "C" int ff_w4_gemv(const void* x, const void* w, const void* w_scale, void* out, void* xp,
                          int M, int K, int N, int group, int n_split, int depth, int out_bf16,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    return ff::w4v::launch<__nv_bfloat16>(x, w, w_scale, out, xp, M, K, N, group, n_split, depth,
                                          st);
  return ff::w4v::launch<float>(x, w, w_scale, out, xp, M, K, N, group, n_split, depth, st);
}

// The clusters of n_split blocks the card runs at once for the launch of
// M token rows with a ring of `depth` stages (cudaOccupancyMaxActiveClusters;
// kernels/matmul.py W4_CLUSTERS holds the H100's), or minus a cudaError_t.
extern "C" int ff_w4_gemv_clusters(int M, int depth, int n_split) {
  using namespace ff::w4v;
  if (M < 1 || M > kMaxRows || depth < 1 || n_split < 1 || n_split > kMaxSplit)
    return -(int)cudaErrorInvalidValue;
  const int rows = tile_n(M);
  auto query = [&](auto kernel) -> int {
    const size_t smem = smem_bytes(rows, depth);
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return -(int)err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(n_split, 1, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = n_split;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
    return err == cudaSuccess ? n : -(int)err;
  };
  switch (rows) {
    case 8:
      return query(w4_gemv_wgmma_kernel<8, float>);
    case 16:
      return query(w4_gemv_wgmma_kernel<16, float>);
    case 32:
      return query(w4_gemv_wgmma_kernel<32, float>);
    case 64:
      return query(w4_gemv_wgmma_kernel<64, float>);
    case 128:
      return query(w4_gemv_wgmma_kernel<128, float>);
    case 192:
      return query(w4_gemv_wgmma_kernel<192, float>);
    default:
      return query(w4_gemv_wgmma_kernel<256, float>);
  }
}
