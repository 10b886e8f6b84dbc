// Blocked causal prefill attention over one layer of the KV cache, INT8
// or bf16, on Hopper's warpgroup tensor cores.
//
// Replaces: fastforward_tpu/kernels/attention.py flash_prefill (:971,
// kernel _flash_prefill_kernel :886), both branches.
//   q (B, H, T, D) bf16; k, v (B, Hkv, S, D) int8 with per-token f32
//   scales (B, Hkv, S), or bf16 without scales (ff_flash_prefill_bf16:
//   the TPU kernel multiplies by all-ones scales, which here are skipped:
//   x * 1 is x); starts (B,) int32; out (B, H, T, D) bf16; D = 128.
// Query row t of sequence b sits at position starts[b] + t and sees the
// keys s <= starts[b] + t. The G = H / Hkv query heads of a kv head share
// its K/V tiles. Per tile of 64 keys, at the TPU kernel's rounding points:
//   scores = (q . bf16(k)) [f32 accumulation] * k_scale * sm_scale,
//            -1e30 where masked;
//   online softmax in f32: m' = max(m, rowmax), alpha = exp(m - m'),
//            p = exp(scores - m'), l = l * alpha + rowsum(p);
//   acc = acc * alpha + bf16(p * v_scale) . bf16(v)   [f32 accumulation];
// and out = acc / max(l, 1e-20) (exp by ex2.approx, the division as a
// multiply by the row's reciprocal). Held against flash_prefill_reference
// (f32 throughout) within 8e-3 of the largest output.
//
// Bound on the H100: bytes. q is read and out written once (B*H*T*D*2
// bytes each), and the live K/V rows with their scales once: at bench.py's
// shape (B 192, H 32, Hkv 8, T 128, starts 0) ~0.45 GB, ~0.136 ms (bf16
// K/V: ~0.50 GB, ~0.150 ms); q and out are ~0.40 GB of it. The
// 4*B*H*D*T(T+1)/2 = 2.6e10 bf16 operations take 0.026 ms at 989 TFLOP/s.
//
// Design (kernels/attention.py prefill_plan mirrors the grid and the
// tiles):
// - Work items: a (sequence, kv head, position tile) of 128 query rows,
//   the G heads x 128/G positions of the tile. A persistent grid of one
//   block an SM walks the items (item i, i + grid, ...; position tiles in
//   snake order, so a block alternates short and long frontiers). A block
//   is two consumer warpgroups of 64 query rows each (G >= 2: G/2 heads x
//   all the tile's positions; G = 1: 64 positions) and one producer
//   warpgroup (384 threads, 168 registers each).
// - The producer streams each item's K/V tiles of 64 keys up to the item's
//   causal frontier starts[b] + t_last by TMA (3-D tensor maps over (D, S,
//   B*Hkv): keys past S arrive as zeros). Each K/V row is read once for all
//   of the item's 128 rows. bf16 K/V land straight in the 128B-swizzled
//   layout wgmma reads (two 64-dim boxes a tile), one warp keeping a ring
//   of full and empty mbarriers. int8 K/V land as int8 (the same swizzle)
//   in a ring of their own, and the producer warpgroup widens each tile,
//   exactly, into that bf16 layout in one of two buffers (with its scale
//   rows, read from device memory meanwhile), then refills the ring slot:
//   the consumers see the int8 cache as the bf16 one, with no barrier
//   between the two warpgroups.
// - Q arrives by TMA too, into a consumer warpgroup's own buffer (two, so
//   an item's Q is loaded while the item before it runs: each warpgroup
//   asks for item j + 2's once item j is done with its buffer). A 3-D map
//   over (D, T, B*H) lands a warpgroup's (heads x positions) rows in one
//   box a 64-dim half; positions past T arrive as zeros.
// - Scores: wgmma m64n64k16, A = Q and B = the K tile, both K-major from
//   shared memory (8 k16 steps over D). Only a tile that crosses the
//   warpgroup's diagonal or the end of the slab is masked; tiles wholly
//   past its frontier are skipped.
// - P.V: the probabilities stay in registers (the score accumulator's
//   layout is the A fragment layout of the next product) and are the A
//   operand of wgmma m64n128k16; V is the B operand, MN-major (keys x
//   dims as it lies), read through the transpose bit that 16-bit wgmma
//   allows.
// - Output: acc / l in bf16 through a staging tile in shared memory
//   (128B-swizzled, conflict-free) and out by TMA store, whole rows of 256
//   bytes; positions past T are clipped by the map. A warpgroup's store of
//   item j drains while it computes item j + 1.

#include "w4_wgmma.cuh"  // wgmma fence/commit/wait, x_desc, mbarriers, the tensor-map encoder

namespace ff {
namespace fp {

constexpr int kD = 128;                          // head dim
constexpr int kRowsWG = 64;                      // query rows a consumer warpgroup
constexpr int kConsumers = 2;                    // consumer warpgroups
constexpr int kRows = kRowsWG * kConsumers;      // query rows a work item
constexpr int kThreads = 128 * (kConsumers + 1);  // and the producer warpgroup
constexpr int kBS = 64;                          // keys a tile
constexpr int kHalf = 64 * 128;                  // one 64-dim half of a 64-row bf16 tile
constexpr int kTile = 2 * kHalf;                 // a 64 x 128 bf16 tile: 16 KB
constexpr int kRawTile = kBS * kD;               // a 64 x 128 int8 tile: 8 KB
constexpr int kRawStage = 2 * kRawTile;         // int8 K and V
constexpr int kConvBytes = 2 * kTile + 1024;     // the widened K, V and their scales
constexpr int kQBytes = kConsumers * 2 * kTile;  // two Q buffers a warpgroup
constexpr int kOBytes = kConsumers * kTile;      // an output staging tile a warpgroup
constexpr float kNegInf = -1e30f;                // the TPU kernel's NEG_INF

template <typename KV>
struct Cfg;
template <>
struct Cfg<__nv_bfloat16> {
  static constexpr bool kInt8 = false;
  static constexpr int kDepth = 3;
  static constexpr int kStage = 2 * kTile;  // K and V, bf16
  static constexpr int kRing = kQBytes + kOBytes;
};
template <>
struct Cfg<int8_t> {
  static constexpr bool kInt8 = true;
  static constexpr int kDepth = 3;
  static constexpr int kStage = kRawStage;
  static constexpr int kRing = kQBytes + kOBytes + 2 * kConvBytes;  // two widened tiles
};

// The buffers and the ring, the barriers (full, empty, the widened tiles'
// full and empty, the Q buffers'), the alignment slack.
template <typename KV>
constexpr size_t smem_bytes() {
  return (size_t)Cfg<KV>::kRing + (size_t)Cfg<KV>::kDepth * Cfg<KV>::kStage + 1024 + 1024;
}

// One work item: sequence b, kv head h, position tile pt (positions pt P ..).
struct Item {
  int b, h, pt;
};

// Item i of B * Hkv * n_pt: (b, h) in order, position tiles in snake order
// (reversed for odd (b, h)): a block that takes every grid-th item then
// alternates near and far frontiers (kernels/attention.py PrefillPlan.item).
__device__ __forceinline__ Item item_of(int i, int Hkv, int n_pt) {
  const int bh = i / n_pt;
  int pt = i % n_pt;
  if (bh & 1) pt = n_pt - 1 - pt;
  return Item{bh / Hkv, bh % Hkv, pt};
}

// Key tiles up to the frontier of positions [.., last]: keys s <= start +
// last, s < S.
__device__ __forceinline__ int tiles_to(int start, int last, int S) {
  return min((S + kBS - 1) / kBS, (start + last) / kBS + 1);
}

// e^x by one ex2.approx of x log2(e) (-1e30 gives +0): within a few ulp,
// far inside the kernel's tolerance.
__device__ __forceinline__ float exp_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// ---- PTX wrappers

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, int c0, int c1, int c2,
                                             const void* src) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%1, %2, %3}], [%4];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(src))
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Wait until the committed stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// Make this thread's shared-memory writes visible to the async proxy
// (wgmma operands, TMA stores).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Named barriers: 1 the producer warpgroup, 2 + wg a consumer warpgroup.
__device__ __forceinline__ void sync_producers() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}
__device__ __forceinline__ void sync_wg(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
}

// The wgmma descriptor of a V tile as the MN-major B operand (keys along
// K, dims along N): 128B-swizzled atoms of 8 keys x 64 dims, the two 64-dim
// halves kHalf apart (LBO), 8-key groups 1024 bytes apart (SBO).
__device__ __forceinline__ uint64_t v_desc(unsigned addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(kHalf >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// s (64 query rows x 64 keys, f32) = Q . K^T over one k16 step: A and B
// K-major in shared memory; `acc` 0 overwrites.
__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t qa, uint64_t kb, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(qa), "l"(kb), "r"(acc));
}

// o (64 query rows x 128 dims, f32) += P (registers: this thread's bf16
// pairs of the 64 x 16 A tile) . V (16 keys x 128 dims, MN-major at `vb`).
__device__ __forceinline__ void wgmma_pv(float (&d)[64], const unsigned (&a)[4], uint64_t vb) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(vb), "r"(1));
}

// 16 int8 values widened, exactly, to the two 16-byte bf16 chunks at lo, hi.
__device__ __forceinline__ void widen16(uint4 src, unsigned char* lo, unsigned char* hi) {
  const unsigned words[4] = {src.x, src.y, src.z, src.w};
  unsigned o[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const unsigned wd = words[i / 2], sh = 16 * (i % 2);
    o[i] = pack_bf16x2(static_cast<float>(static_cast<int8_t>((wd >> sh) & 0xFFu)),
                       static_cast<float>(static_cast<int8_t>((wd >> (sh + 8)) & 0xFFu)));
  }
  *reinterpret_cast<uint4*>(lo) = make_uint4(o[0], o[1], o[2], o[3]);
  *reinterpret_cast<uint4*>(hi) = make_uint4(o[4], o[5], o[6], o[7]);
}

// Producer thread p of 128 widens dims 64 (p / 64).. of key p % 64 of the
// raw int8 K and V tiles (128-byte rows, 128B-swizzled) into the bf16 tiles
// at `conv` (two 64-dim halves each, the same swizzle): a warp's 32 keys
// read and write 8 distinct 16-byte chunks a phase.
__device__ __forceinline__ void widen_tile(const unsigned char* raw, unsigned char* conv, int p) {
  const int r = p % kBS, h = p / kBS, sw = r & 7;
#pragma unroll
  for (int t = 0; t < 2; ++t) {  // K, V
    const unsigned char* src = raw + t * kRawTile + r * 128;
    unsigned char* dst = conv + t * kTile + h * kHalf + r * 128;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = 4 * h + jj;  // 16-dim chunk of the raw row: bf16 chunks 2 jj, 2 jj + 1
      const uint4 v = *reinterpret_cast<const uint4*>(src + ((j ^ sw) << 4));
      widen16(v, dst + (((2 * jj) ^ sw) << 4), dst + (((2 * jj + 1) ^ sw) << 4));
    }
  }
}

// Grid: min(items, SMs) blocks of kThreads threads (one an SM), dynamic
// shared memory smem_bytes<KV>(). q_map / o_map: q, out as (D, T, B*H)
// bf16, boxes of 64 dims x pw positions x gw heads (a warpgroup's rows:
// pw = min(128 / G, 64), gw = 64 / pw); k_map / v_map: k, v as (D, S,
// B*Hkv), boxes of 64 dims (bf16) or 128 (int8) x 64 keys, all
// 128B-swizzled. ks / vs: the int8 cache's scales (B*Hkv, S), else null.
template <typename KV>
__global__ void __launch_bounds__(kThreads, 1)
flash_prefill_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const __grid_constant__ CUtensorMap o_map, const float* __restrict__ ks,
                     const float* __restrict__ vs, const int* __restrict__ starts, int B, int H,
                     int Hkv, int T, int S, float sm_scale) {
  using C = Cfg<KV>;
  constexpr int kDepth = C::kDepth;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzle's 1024-byte period (smem_bytes asks for the slack)
  unsigned char* smem = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  unsigned char* q_buf = smem;            // [wg][2][kTile]
  unsigned char* o_buf = smem + kQBytes;  // [wg][kTile]
  unsigned char* conv = o_buf + kOBytes;  // int8: [2][the widened K, V and their scales]
  unsigned char* ring = smem + C::kRing;  // [kDepth][kStage]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kDepth * C::kStage);
  uint64_t* empty = full + kDepth;  // bf16
  uint64_t* cfull = empty + kDepth;  // int8: [2] a widened tile is ready
  uint64_t* cempty = cfull + 2;      // int8: [2] both warpgroups are done with it
  uint64_t* qbar = cempty + 2;       // [wg][2]

  const int G = H / Hkv, P = kRows / G;      // positions a work item
  const int pw = P < kRowsWG ? P : kRowsWG;  // positions a warpgroup
  const int n_pt = (T + P - 1) / P, n_items = B * Hkv * n_pt;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // the key tiles of item i (its last position's frontier)
  auto item_tiles = [&](const Item& it) {
    return tiles_to(starts[it.b], min((it.pt + 1) * P, T) - 1, S);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kDepth; ++s) {
      mbar_init(full + s, 1);             // the TMA issue's one arrival
      mbar_init(empty + s, kConsumers);   // bf16: both warpgroups past their products
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(cfull + s, 1);
      mbar_init(cempty + s, kConsumers);
    }
    for (int j = 0; j < 2 * kConsumers; ++j) mbar_init(qbar + j, 1);
    mma8::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 4 * kConsumers) {
    const int p = threadIdx.x - 128 * kConsumers;  // producer thread 0-127
    if constexpr (!C::kInt8) {
      // ---- bf16: one warp streams every item's K/V tiles up to its frontier
      if (warp != 4 * kConsumers) return;
      int cnt = 0;
      for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
        const Item it = item_of(i, Hkv, n_pt);
        const int n = item_tiles(it), kvh = it.b * Hkv + it.h;
        for (int t = 0; t < n; ++t, ++cnt) {
          const int slot = cnt % kDepth;
          if (cnt >= kDepth) mma8::mbar_wait_or_trap(empty + slot, ((cnt / kDepth) - 1) & 1);
          unsigned char* st = ring + slot * C::kStage;
          if (lane == 0) {
            mma8::mbar_arrive_expect_tx(full + slot, 2 * kTile);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              tma_load_3d(st + h * kHalf, &k_map, 64 * h, t * kBS, kvh, full + slot);
              tma_load_3d(st + kTile + h * kHalf, &v_map, 64 * h, t * kBS, kvh, full + slot);
            }
          }
        }
      }
      return;
    } else {
      // ---- int8: thread 0 keeps kDepth raw tiles in flight (an issue
      // cursor over the items' tiles); the warpgroup widens tile c into
      // conv[c % 2] once its consumers have released it, then refills the
      // tile's ring slot with tile c + kDepth
      int i_iss = blockIdx.x, t_iss = 0;
      int n_iss = i_iss < n_items ? item_tiles(item_of(i_iss, Hkv, n_pt)) : 0;
      auto issue = [&](int c) {
        const Item it = item_of(i_iss, Hkv, n_pt);
        const int slot = c % kDepth, kvh = it.b * Hkv + it.h;
        unsigned char* st = ring + slot * C::kStage;
        mma8::mbar_arrive_expect_tx(full + slot, 2 * kRawTile);
        tma_load_3d(st, &k_map, 0, t_iss * kBS, kvh, full + slot);
        tma_load_3d(st + kRawTile, &v_map, 0, t_iss * kBS, kvh, full + slot);
        if (++t_iss == n_iss) {
          i_iss += gridDim.x;
          t_iss = 0;
          n_iss = i_iss < n_items ? item_tiles(item_of(i_iss, Hkv, n_pt)) : 0;
        }
      };
      if (p == 0)
        for (int c = 0; c < kDepth && i_iss < n_items; ++c) issue(c);
      int cnt = 0;
      for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
        const Item it = item_of(i, Hkv, n_pt);
        const int n = item_tiles(it);
        const size_t row = (size_t)(it.b * Hkv + it.h) * S;
        for (int t = 0; t < n; ++t, ++cnt) {
          const int slot = cnt % kDepth, cs = cnt & 1;
          // this thread's scale: k_scale of key p (p < 64), else v_scale of p - 64
          const int key = t * kBS + p % kBS;
          const float scale = key < S ? (p < kBS ? ks : vs)[row + key] : 0.f;
          unsigned char* dst = conv + cs * kConvBytes;
          mma8::mbar_wait_or_trap(full + slot, (cnt / kDepth) & 1);
          if (cnt >= 2) mma8::mbar_wait_or_trap(cempty + cs, ((cnt >> 1) - 1) & 1);
          widen_tile(ring + slot * C::kStage, dst, p);
          reinterpret_cast<float*>(dst + 2 * kTile)[p] = scale;
          fence_async_smem();
          sync_producers();  // the tile is widened, its raw slot read
          if (p == 0) {
            mma8::mbar_arrive(cfull + cs);
            if (i_iss < n_items) issue(cnt + kDepth);
          }
        }
      }
      return;
    }
  }

  // ---- the consumer warpgroups: 64 query rows each
  const int wg = warp / 4, wl = warp % 4, gid = lane / 4, tid = lane % 4;
  const bool leader = threadIdx.x % 128 == 0;
  const int p_off = P > kRowsWG ? kRowsWG * wg : 0;         // G = 1: the warpgroup's positions
  const int h_off = P > kRowsWG ? 0 : wg * (kRowsWG / pw);  // G >= 2: its heads
  unsigned char* qw = q_buf + wg * 2 * kTile;
  unsigned char* ow = o_buf + wg * kTile;
  uint64_t* qb = qbar + 2 * wg;
  // this thread's two rows 16 wl + gid (+ 8): head (r / pw), position (r % pw)
  int prow[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) prow[e] = (16 * wl + gid + 8 * e) % pw;

  // item i's Q rows of this warpgroup into buffer j % 2
  auto load_q = [&](int j, int i) {
    const Item it = item_of(i, Hkv, n_pt);
    unsigned char* dst = qw + (j & 1) * kTile;
    mma8::mbar_arrive_expect_tx(qb + (j & 1), 2 * kHalf);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      tma_load_3d(dst + h * kHalf, &q_map, 64 * h, it.pt * P + p_off,
                  (it.b * Hkv + it.h) * G + h_off, qb + (j & 1));
  };
  if (leader) {
    if (blockIdx.x < n_items) load_q(0, blockIdx.x);
    if (blockIdx.x + gridDim.x < n_items) load_q(1, blockIdx.x + gridDim.x);
  }

  int cnt = 0, j = 0;
  for (int i = blockIdx.x; i < n_items; i += gridDim.x, ++j) {
    const Item it = item_of(i, Hkv, n_pt);
    const int start = starts[it.b];
    const int t0 = it.pt * P + p_off;  // the warpgroup's first position
    const int n = item_tiles(it);
    const bool rows = t0 < T;          // uniform over the warpgroup
    const int n_w = rows ? tiles_to(start, min(t0 + pw, T) - 1, S) : 0;
    // tiles below `open` hold only keys every row of the warpgroup sees
    const int open = min((start + t0 + 1) / kBS, S / kBS);
    const int pos0 = start + t0 + prow[0], pos1 = start + t0 + prow[1];
    mma8::mbar_wait_or_trap(qb + (j & 1), (j >> 1) & 1);
    const unsigned qa = smem_u32(qw + (j & 1) * kTile);

    float o[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) o[e] = 0.f;
    float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};

    for (int t = 0; t < n; ++t, ++cnt) {
      // this tile's K, V (bf16, 128B-swizzled) and, int8, its scales
      const unsigned char* kv;
      const float* kss = nullptr;
      uint64_t* done;  // released once this warpgroup's products are done
      if constexpr (C::kInt8) {
        const int cs = cnt & 1;
        mma8::mbar_wait_or_trap(cfull + cs, (cnt >> 1) & 1);
        kv = conv + cs * kConvBytes;
        kss = reinterpret_cast<const float*>(kv + 2 * kTile);
        done = cempty + cs;
      } else {
        const int slot = cnt % kDepth;
        mma8::mbar_wait_or_trap(full + slot, (cnt / kDepth) & 1);
        kv = ring + slot * C::kStage;
        done = empty + slot;
      }
      if (t < n_w) {
        const unsigned kb = smem_u32(kv), vb = kb + kTile;
        // ---- scores: 64 rows x 64 keys, 8 k16 steps over D
        float sc[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) sc[e] = 0.f;
        w4g::wgmma_fence();
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int off = (k / 4) * kHalf + (k % 4) * 32;
          wgmma_qk(sc, w4g::x_desc(qa + off), w4g::x_desc(kb + off), k > 0);
        }
        w4g::wgmma_commit();
        w4g::wgmma_wait<0>();
#pragma unroll
        for (int e = 0; e < 32; ++e) w4g::fence_reg(sc[e]);

        // ---- scale, mask, online softmax (sc[4 c + e]: row e / 2, key
        // 8 c + 2 tid + e % 2 of the tile; a row's keys lie in a quad)
        const int s0 = t * kBS;
        const bool masked = t >= open;
        float mx[2] = {kNegInf, kNegInf};
#pragma unroll
        for (int c = 0; c < 8; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 8 * c + 2 * tid + (e & 1), r = e >> 1;
            float x = sc[4 * c + e];
            if constexpr (C::kInt8) x = __fmul_rn(x, kss[col]);
            x = __fmul_rn(x, sm_scale);
            if (masked) {
              const int s = s0 + col;
              x = (s < S && s <= (r ? pos1 : pos0)) ? x : kNegInf;
            }
            sc[4 * c + e] = x;
            mx[r] = fmaxf(mx[r], x);
          }
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m_run[r], mx[r]);
          alpha[r] = exp_approx(m_run[r] - m_new);
          m_run[r] = m_new;
        }
        float psum[2] = {0.f, 0.f};
#pragma unroll
        for (int c = 0; c < 8; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 8 * c + 2 * tid + (e & 1), r = e >> 1;
            float p = exp_approx(sc[4 * c + e] - m_run[r]);
            psum[r] += p;
            if constexpr (C::kInt8) p = __fmul_rn(p, kss[kBS + col]);
            sc[4 * c + e] = p;
          }
#pragma unroll
        for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + psum[r];
        // P as the A fragments of the four k16 steps over the tile's keys
        unsigned pa[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            pa[kk][q] = pack_bf16x2(sc[8 * kk + 2 * q], sc[8 * kk + 2 * q + 1]);
#pragma unroll
        for (int c = 0; c < 16; ++c) {
          o[4 * c] *= alpha[0];
          o[4 * c + 1] *= alpha[0];
          o[4 * c + 2] *= alpha[1];
          o[4 * c + 3] *= alpha[1];
        }
        // ---- acc += P . V: 4 k16 steps over the tile's keys
        w4g::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_pv(o, pa[kk], v_desc(vb + kk * 16 * 128));
        w4g::wgmma_commit();
        w4g::wgmma_wait<0>();
#pragma unroll
        for (int e = 0; e < 64; ++e) w4g::fence_reg(o[e]);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int q = 0; q < 4; ++q) w4g::fence_reg(pa[kk][q]);
      }
      if (leader) mma8::mbar_arrive(done);  // this warpgroup is done with the tile
    }

    // ---- epilogue: acc / max(l, 1e-20) in bf16 through the staging tile
    if (leader) bulk_wait_read();  // the previous item's store has read the staging tile
    sync_wg(wg);                   // and every warp is past this item's products
    if (leader && i + 2 * (int)gridDim.x < n_items) load_q(j + 2, i + 2 * gridDim.x);
    if (rows) {
      float inv[2];  // 1 / max(l, 1e-20), one reciprocal a row
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float l = l_run[r];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        inv[r] = __frcp_rn(fmaxf(l, 1e-20f));
      }
      // o[4 c + e]: row 16 wl + gid + 8 (e / 2), dim 8 c + 2 tid + e % 2
#pragma unroll
      for (int c = 0; c < 16; ++c)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = 16 * wl + gid + 8 * r, chunk = c % 8;
          *reinterpret_cast<unsigned*>(ow + (c / 8) * kHalf + row * 128 +
                                       ((chunk ^ (row & 7)) << 4) + 4 * tid) =
              pack_bf16x2(o[4 * c + 2 * r] * inv[r], o[4 * c + 2 * r + 1] * inv[r]);
        }
      fence_async_smem();
      sync_wg(wg);
      if (leader) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
          tma_store_3d(&o_map, 64 * h, t0, (it.b * Hkv + it.h) * G + h_off, ow + h * kHalf);
        bulk_commit();
      }
    }
  }
  if (leader) bulk_wait();
}

// A 3-D tensor map of (d0, d1, d2) elements, dims 1 and 2 `s1`, `s2` bytes
// apart, boxes of b0 x b1 x b2, 128B-swizzled (zeros past the tensor).
inline bool map3d(CUtensorMap* map, CUtensorMapDataType type, const void* base, long long d0,
                  long long d1, long long d2, long long s1, long long s2, int b0, int b1,
                  int b2) {
  const auto encode = mma8::tensor_map_encoder();
  if (encode == nullptr || s1 % 16 != 0 || s2 % 16 != 0 ||
      reinterpret_cast<uintptr_t>(base) % 16 != 0)
    return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2};
  const cuuint64_t strides[2] = {(cuuint64_t)s1, (cuuint64_t)s2};
  const cuuint32_t box[3] = {(cuuint32_t)b0, (cuuint32_t)b1, (cuuint32_t)b2};
  const cuuint32_t estr[3] = {1, 1, 1};
  return encode(map, type, 3, const_cast<void*>(base), dims, strides, box, estr,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

inline int sm_count() {
  static const int n = [] {
    int dev = 0, v = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 132;
    return v;
  }();
  return n;
}

// The plan of kernels/attention.py prefill_plan: 128 query rows an item,
// min(items, SMs) persistent blocks.
template <typename KV>
int launch(const void* q, const void* k, const void* ks, const void* v, const void* vs,
           const void* starts, void* out, int B, int H, int Hkv, int T, int S, int D,
           float sm_scale, cudaStream_t st) {
  if (D != kD || B < 1 || T < 1 || S < 1 || Hkv < 1 || H % Hkv != 0) return cudaErrorInvalidValue;
  const int G = H / Hkv;
  if (G != 1 && G != 2 && G != 4 && G != 8) return cudaErrorInvalidValue;
  const int P = kRows / G, pw = P < kRowsWG ? P : kRowsWG, gw = kRowsWG / pw;
  constexpr bool kInt8 = Cfg<KV>::kInt8;
  const auto kv_type = kInt8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const long long row = (long long)kD * sizeof(KV);  // bytes a cache row
  CUtensorMap qm = {}, om = {}, km = {}, vm = {};
  if (!map3d(&qm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, q, kD, T, (long long)B * H, 2ll * kD,
             2ll * kD * T, 64, pw, gw) ||
      !map3d(&om, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, out, kD, T, (long long)B * H, 2ll * kD,
             2ll * kD * T, 64, pw, gw) ||
      !map3d(&km, kv_type, k, kD, S, (long long)B * Hkv, row, row * S, kInt8 ? 128 : 64, kBS,
             1) ||
      !map3d(&vm, kv_type, v, kD, S, (long long)B * Hkv, row, row * S, kInt8 ? 128 : 64, kBS, 1))
    return cudaErrorInvalidValue;
  const long long items = (long long)B * Hkv * ((T + P - 1) / P);
  const int grid = (int)(items < sm_count() ? items : sm_count());
  const size_t smem = smem_bytes<KV>();
  cudaError_t err = cudaFuncSetAttribute(flash_prefill_kernel<KV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  flash_prefill_kernel<KV><<<grid, kThreads, smem, st>>>(
      qm, km, vm, om, static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int*>(starts), B, H, Hkv, T, S, sm_scale);
  return cudaGetLastError();
}

}  // namespace fp
}  // namespace ff

// Both entries return cudaErrorInvalidValue for a head dim other than 128,
// a group size outside {1, 2, 4, 8}, or tensors no tensor map takes (16-byte
// aligned); the wrappers check these first.
extern "C" int ff_flash_prefill(const void* q, const void* k, const void* ks, const void* v,
                                const void* vs, const void* starts, void* out, int B, int H,
                                int Hkv, int T, int S, int D, float sm_scale, void* stream) {
  return ff::fp::launch<int8_t>(q, k, ks, v, vs, starts, out, B, H, Hkv, T, S, D, sm_scale,
                                static_cast<cudaStream_t>(stream));
}

// bf16 K/V (B, Hkv, S, D), no scales.
extern "C" int ff_flash_prefill_bf16(const void* q, const void* k, const void* v,
                                     const void* starts, void* out, int B, int H, int Hkv, int T,
                                     int S, int D, float sm_scale, void* stream) {
  return ff::fp::launch<__nv_bfloat16>(q, k, nullptr, v, nullptr, starts, out, B, H, Hkv, T, S,
                                       D, sm_scale, static_cast<cudaStream_t>(stream));
}
