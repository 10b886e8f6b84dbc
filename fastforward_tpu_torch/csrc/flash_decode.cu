// Length-aware flash-decode attention over the layer-stacked INT8 KV cache,
// and over the paged INT8 pool through a page table.
//
// Replaces: fastforward_tpu/kernels/attention.py
// flash_decode_int8_stacked_ragged (:635, bodies :518 and :408) and
// flash_decode_int8_stacked (:271, bodies :204 / :131): the same function
// over the whole slab or over the live blocks; and the per-layer
// flash_decode_int8 (:721, bodies _flash_decode_kernel_allheads and
// _flash_decode_kernel): a (B, Hkv, S, D) cache is layer 0 of L = 1 to
// ff_flash_decode, the same rows at the same offsets. One query token per
// sequence; q (B, H, D) bf16; K/V layer l of (L, B, Hkv, S, D) int8 with
// per-token scales (L, B, Hkv, S) f32; GQA with G = H / Hkv query heads
// per kv head; out (B, H, D) bf16; a length of 0 gives zeros. Held against
// flash_decode_int8_reference within 8e-3 of the largest output (f32
// online softmax, another summation order).
//
// Paged form. Replaces fastforward_tpu/kernels/paged_attention.py
// paged_flash_decode_int8 (:156, body _paged_flash_decode_kernel :56):
// the same function with token t of sequence b read from row t % page of
// pool (L, P, Hkv, page, D) page table[b, t / page] (-1 reads page 0, the
// trash page); it reads min(len, MP * page) tokens.
//
// Bound on the H100: the live cache bytes, 2 * len * (D + 4) per (b, kv
// head), read once: at bench.py's decode (B 192, Hkv 8, lengths 129-160)
// ~59 MB, 0.0185 ms. The G * len * D * 4 operations are far below it.
//
// Design for that bound. One block of 4 warps per (b, kv head), so each
// K/V row leaves device memory once for all G query heads, walks the live
// tokens in chunks of kC = 64, aligned at token 0:
// - Feed. The block copies each chunk's K rows, V rows and scales into
//   shared memory by 16-byte cp.async (4-byte for the scales; rows past
//   the length zero-filled), two stages: chunk i + 1 streams in while
//   chunk i computes, and chunk i + 2 goes into chunk i's stage once
//   every warp is done with it. Every token's row address is
//   computed on its own (slab: base + t; paged: the table entry of its
//   page), so a chunk may span pages of any size.
// - Scores on the tensor cores. Warp w takes tokens 16w..16w+15 of a chunk
//   as the 16 rows of one mma.sync m16n8k16 (bf16, f32 sums): A = the
//   K rows widened to bf16 (int8 is exact in bf16; a 0x4B000000 magic
//   number turns a byte into f32 with one PRMT and one FADD), B = the G
//   query heads as its 8 columns (heads past G zero), 8 k-steps over the
//   128 dims. In k-step s a lane (gid, tid) feeds dims 32 tid + 4 s..+3
//   into its four k slots, the same dims in A and B, so its A operands are
//   two 16-byte shared loads a row, conflict-free at a row pitch of 144
//   bytes, and its q operands 16 registers loaded once. The f32 dot is
//   scaled once by k_scale * sm_scale * log2(e).
// - One online-softmax step a warp and chunk: the slice's max per head
//   (three shuffles), one exp2 a score, one rescale of the accumulator.
//   p * v_scale goes to the warp's 16 x G scratch in shared memory.
// - P.V on the CUDA cores in f32: lane l owns dims 4l..4l+3 of every head,
//   reads a V word a token (consecutive lanes, consecutive words) and the
//   token's G weights (broadcast), and adds 4G products.
// - One merge at the end: the four warps' (max, sum, accumulator) states,
//   in shared memory, in warp order.
// Every step's order depends on the token index alone (chunk, warp slice,
// row of the tile), so the slab, the per-layer and the paged forms give
// the same bits over the same tokens.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "mma.cuh"  // cp_async, mma_bf16

namespace {

constexpr int kD = 128;                  // head dim
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kSlice = 16;               // tokens of a chunk one warp takes (one m16 tile)
constexpr int kC = kWarps * kSlice;      // tokens a chunk
constexpr int kKPitch = kD + 16;         // shared bytes between K rows: conflict-free A loads
constexpr int kStages = 2;               // chunks in shared memory: one in flight
static_assert(kStages == 2, "the waits keep exactly one chunk in flight");
constexpr float kLog2e = 1.4426950408889634f;

// One stage of the feed: a chunk's K rows (padded), V rows and scales.
struct Stage {
  int8_t k[kC * kKPitch];
  int8_t v[kC * kD];
  float ks[kC];
  float vs[kC];
};

// Row index (in token rows of kD bytes) of token t of sequence b, kv head h.
struct SlabRows {
  int B, Hkv, S, layer;
  __device__ int limit() const { return S; }
  __device__ size_t row(int b, int h, int t) const {
    return (((size_t)layer * B + b) * Hkv + h) * S + t;
  }
};

struct PagedRows {
  const int* table;
  int P, Hkv, page, MP, layer;
  __device__ int limit() const { return MP * page; }
  __device__ size_t row(int b, int h, int t) const {
    const int pid = min(max(table[(size_t)b * MP + t / page], 0), P - 1);
    return (((size_t)layer * P + pid) * Hkv + h) * page + t % page;
  }
};

// Byte j of u (an int8 word with every byte's top bit flipped) as the f32
// value of the int8 byte: 2^23 + (x + 128), less 2^23 + 128. Exact.
__device__ __forceinline__ float byte_f32(unsigned u, int j) {
  return __int_as_float(__byte_perm(u, 0x4B000000u, 0x7440 | j)) - 8388736.f;
}

__device__ __forceinline__ unsigned bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

template <int G, class Rows>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ k,
                    const float* __restrict__ ks, const int8_t* __restrict__ v,
                    const float* __restrict__ vs, const int* __restrict__ lengths,
                    __nv_bfloat16* __restrict__ out, int Hkv, Rows rows, float sm_scale) {
  __shared__ __align__(16) unsigned char smem[kStages * sizeof(Stage)];
  __shared__ __align__(16) float sp[kWarps][kSlice][G];  // p * v_scale of each warp's slice
  Stage* stage = reinterpret_cast<Stage*>(smem);
  const int b = blockIdx.x, h = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tid = lane % 4;
  const int H = Hkv * G;
  const int len = max(0, min(lengths[b], rows.limit()));
  const int n_chunks = (len + kC - 1) / kC;

  auto load = [&](Stage& st, int c) {
    const int t0 = c * kC;
    // thread i: 16-byte pieces i % 8 of tokens i / 8, i / 8 + 16, ...
    for (int i = threadIdx.x; i < kC * 8; i += kThreads) {
      const int tl = i / 8, piece = 16 * (i % 8), t = t0 + tl;
      const bool ok = t < len;
      const size_t r = ok ? rows.row(b, h, t) : 0;
      ff::cp_async<16>(st.k + tl * kKPitch + piece, k + r * kD + piece, ok);
      ff::cp_async<16>(st.v + tl * kD + piece, v + r * kD + piece, ok);
    }
    if (threadIdx.x < kC) {
      const int t = t0 + threadIdx.x;
      const bool ok = t < len;
      const size_t r = ok ? rows.row(b, h, t) : 0;
      ff::cp_async<4>(st.ks + threadIdx.x, ks + r, ok);
      ff::cp_async<4>(st.vs + threadIdx.x, vs + r, ok);
    }
    ff::cp_async_commit();
  };
  for (int c = 0; c < min(kStages, n_chunks); ++c) load(stage[c], c);

  // B fragments of q: column gid is head gid; k-step s holds dims
  // 32 tid + 4 s, +1 (register 0) and +2, +3 (register 1)
  unsigned qb[8][2];
  {
    const unsigned short* qp = reinterpret_cast<const unsigned short*>(q) +
                               ((size_t)b * H + h * G + min(gid, G - 1)) * kD + 32 * tid;
#pragma unroll
    for (int s = 0; s < 8; ++s)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        qb[s][r] = gid < G ? static_cast<unsigned>(qp[4 * s + 2 * r]) |
                                 (static_cast<unsigned>(qp[4 * s + 2 * r + 1]) << 16)
                           : 0u;
  }

  // the online softmax of heads 2 tid and 2 tid + 1 over this lane's
  // tokens (log2 domain; the max is the warp's), and the accumulator of
  // dims 4 lane.. of every head
  float m_f[2] = {-INFINITY, -INFINITY}, l_f[2] = {0.f, 0.f};
  float acc[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[g][j] = 0.f;
  const float scale2 = sm_scale * kLog2e;

  for (int c = 0; c < n_chunks; ++c) {
    // chunk c has landed once only chunk c + 1's copies may be pending
    if (c + 1 < n_chunks)
      ff::cp_async_wait<1>();
    else
      ff::cp_async_wait<0>();
    __syncthreads();
    const Stage& st = stage[c % kStages];
    const int base = warp * kSlice;                    // the warp's rows of the stage
    const int nv = min(kSlice, len - c * kC - base);   // its live tokens (warp-uniform)
    if (nv > 0) {
      // scores: rows gid, gid + 8 (tokens), columns 2 tid, 2 tid + 1 (heads);
      // even and odd k-steps in two accumulators (two dependent chains)
      float sc[2][4] = {};
      const int8_t* kr = st.k + (base + gid) * kKPitch + 32 * tid;
      const uint4 r0 = *reinterpret_cast<const uint4*>(kr);
      const uint4 r1 = *reinterpret_cast<const uint4*>(kr + 16);
      const uint4 r8 = *reinterpret_cast<const uint4*>(kr + 8 * kKPitch);
      const uint4 r9 = *reinterpret_cast<const uint4*>(kr + 8 * kKPitch + 16);
      const unsigned lo[8] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
      const unsigned hi[8] = {r8.x, r8.y, r8.z, r8.w, r9.x, r9.y, r9.z, r9.w};
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        const unsigned ul = lo[s] ^ 0x80808080u, uh = hi[s] ^ 0x80808080u;
        const unsigned a[4] = {bf16x2(byte_f32(ul, 0), byte_f32(ul, 1)),
                               bf16x2(byte_f32(uh, 0), byte_f32(uh, 1)),
                               bf16x2(byte_f32(ul, 2), byte_f32(ul, 3)),
                               bf16x2(byte_f32(uh, 2), byte_f32(uh, 3))};
        ff::mma_bf16(sc[s % 2], a, qb[s][0], qb[s][1]);
      }
      const float k0 = st.ks[base + gid] * scale2, k1 = st.ks[base + gid + 8] * scale2;
      const bool ok0 = gid < nv, ok1 = gid + 8 < nv;
      const float x[4] = {ok0 ? (sc[0][0] + sc[1][0]) * k0 : -INFINITY,
                          ok0 ? (sc[0][1] + sc[1][1]) * k0 : -INFINITY,
                          ok1 ? (sc[0][2] + sc[1][2]) * k1 : -INFINITY,
                          ok1 ? (sc[0][3] + sc[1][3]) * k1 : -INFINITY};
      float alpha[2], p[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float cm = fmaxf(x[e], x[e + 2]);
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, off));
        const float mn = fmaxf(m_f[e], cm);  // finite: row 0 of the slice is live
        alpha[e] = exp2f(m_f[e] - mn);
        m_f[e] = mn;
        p[e] = exp2f(x[e] - mn);
        p[e + 2] = exp2f(x[e + 2] - mn);
        l_f[e] = l_f[e] * alpha[e] + (p[e] + p[e + 2]);
      }
      const float v0 = st.vs[base + gid], v1 = st.vs[base + gid + 8];
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (2 * tid + e < G) {
          sp[warp][gid][2 * tid + e] = p[e] * v0;
          sp[warp][gid + 8][2 * tid + e] = p[e + 2] * v1;
        }
      __syncwarp();
      // rescale by each head's alpha (held by lane g / 2), then P.V
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float al = __shfl_sync(0xffffffffu, alpha[g & 1], g >> 1);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[g][j] *= al;
      }
      // every row of the slice: rows past the length hold zeros (V and
      // v_scale zero-filled, so their weights are 0), which add nothing
      const int8_t* vr = st.v + base * kD + 4 * lane;
#pragma unroll
      for (int t = 0; t < kSlice; ++t) {
        const unsigned u = *reinterpret_cast<const unsigned*>(vr + t * kD) ^ 0x80808080u;
        float vf[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) vf[j] = byte_f32(u, j);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float pg = sp[warp][t][g];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[g][j] = fmaf(pg, vf[j], acc[g][j]);
        }
      }
      __syncwarp();  // the scratch is read before the next chunk writes it
    }
    __syncthreads();  // every warp is done with the stage
    if (c + kStages < n_chunks) load(stage[c % kStages], c + kStages);
  }

  // Merge the warps in shared memory (the stages are free): the sums over
  // the warp's tokens first, then each (head, dim) over the warps in order.
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) l_f[e] += __shfl_xor_sync(0xffffffffu, l_f[e], off);
  float* sh_acc = reinterpret_cast<float*>(smem);  // [kWarps][G][kD]
  float* sh_m = sh_acc + kWarps * G * kD;          // [kWarps][G]
  float* sh_l = sh_m + kWarps * G;
#pragma unroll
  for (int e = 0; e < 2; ++e)
    if (gid == 0 && 2 * tid + e < G) {
      sh_m[warp * G + 2 * tid + e] = m_f[e];
      sh_l[warp * G + 2 * tid + e] = l_f[e];
    }
#pragma unroll
  for (int g = 0; g < G; ++g)
    *reinterpret_cast<float4*>(sh_acc + (warp * G + g) * kD + 4 * lane) =
        make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
  __syncthreads();
  for (int i = threadIdx.x; i < G * kD; i += kThreads) {
    const int g = i / kD, d = i % kD;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sh_m[w * G + g]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = sh_m[w * G + g];
      const float cw = mw == -INFINITY ? 0.f : exp2f(mw - mx);
      num += sh_acc[(w * G + g) * kD + d] * cw;
      den += sh_l[w * G + g] * cw;
    }
    out[((size_t)b * H + h * G + g) * kD + d] = __float2bfloat16_rn(num / fmaxf(den, 1e-20f));
  }
}

template <class Rows>
cudaError_t launch(const void* q, const void* k, const void* ks, const void* v, const void* vs,
                   const void* lengths, void* out, int B, int H, int Hkv, int D, Rows rows,
                   float sm_scale, cudaStream_t st) {
  if (D != kD || H % Hkv != 0 || reinterpret_cast<uintptr_t>(k) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v) % 16 != 0)
    return cudaErrorInvalidValue;
  const dim3 grid(B, Hkv);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const int8_t*>(k);
  const auto* ksp = static_cast<const float*>(ks);
  const auto* vp = static_cast<const int8_t*>(v);
  const auto* vsp = static_cast<const float*>(vs);
  const auto* lp = static_cast<const int*>(lengths);
  auto* op = static_cast<__nv_bfloat16*>(out);
  switch (H / Hkv) {
    case 1: flash_decode_kernel<1, Rows><<<grid, kThreads, 0, st>>>(qp, kp, ksp, vp, vsp, lp, op, Hkv, rows, sm_scale); break;
    case 2: flash_decode_kernel<2, Rows><<<grid, kThreads, 0, st>>>(qp, kp, ksp, vp, vsp, lp, op, Hkv, rows, sm_scale); break;
    case 4: flash_decode_kernel<4, Rows><<<grid, kThreads, 0, st>>>(qp, kp, ksp, vp, vsp, lp, op, Hkv, rows, sm_scale); break;
    case 8: flash_decode_kernel<8, Rows><<<grid, kThreads, 0, st>>>(qp, kp, ksp, vp, vsp, lp, op, Hkv, rows, sm_scale); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// Both entries return cudaErrorInvalidValue for a head dim other than 128,
// a group size outside {1, 2, 4, 8} or K/V not 16-byte aligned; the
// wrappers check all three first.
extern "C" int ff_flash_decode(const void* q, const void* k, const void* ks, const void* v,
                               const void* vs, const void* lengths, void* out, int L, int B,
                               int H, int Hkv, int S, int D, int layer, float sm_scale,
                               void* stream) {
  (void)L;
  return launch(q, k, ks, v, vs, lengths, out, B, H, Hkv, D, SlabRows{B, Hkv, S, layer},
                sm_scale, static_cast<cudaStream_t>(stream));
}

// table (B, MP) int32; any page size (the wrapper asks for a multiple of 4
// tokens, as the JAX wrapper's pages are).
extern "C" int ff_paged_flash_decode(const void* q, const void* k, const void* ks,
                                     const void* v, const void* vs, const void* table,
                                     const void* lengths, void* out, int L, int P, int B, int H,
                                     int Hkv, int page, int MP, int D, int layer,
                                     float sm_scale, void* stream) {
  (void)L;
  return launch(q, k, ks, v, vs, lengths, out, B, H, Hkv, D,
                PagedRows{static_cast<const int*>(table), P, Hkv, page, MP, layer}, sm_scale,
                static_cast<cudaStream_t>(stream));
}
