// Length-aware flash-decode attention over the layer-stacked INT8 KV cache,
// and over the paged INT8 pool through a page table.
//
// Replaces: fastforward_tpu/kernels/attention.py
// flash_decode_int8_stacked_ragged (:635, bodies :518 and :408) and
// flash_decode_int8_stacked (:271, bodies :204 / :131): the same function
// over the whole slab or over the live blocks. One query token per
// sequence; q (B, H, D) bf16; K/V layer l of (L, B, Hkv, S, D) int8 with
// per-token scales (L, B, Hkv, S) f32; GQA with G = H / Hkv query heads
// per kv head; out (B, H, D) bf16. Held against flash_decode_int8_reference
// within a stated tolerance (f32 online softmax, another summation order).
//
// Bound on the H100: the live cache bytes, 2 * len * (D + 4) per (b, kv
// head), read once: bandwidth-bound, and at decode lengths of a few
// hundred tokens mostly launch latency.
//
// Design for that bound: one block per (b, kv head) so each K/V row is
// read once for all G query heads; the block walks only the
// ceil(len/256) live 256-token blocks, never the dead rest of the slab.
// Each warp takes every 4th token of a block; a lane holds 4 of the 128
// dims, dequantizes with the token's scale in registers and keeps an f32
// online softmax (running max, sum, accumulator) per query head. The four
// warps' states are merged in shared memory at the end.
//
// Paged form. Replaces fastforward_tpu/kernels/paged_attention.py
// paged_flash_decode_int8 (:156, body _paged_flash_decode_kernel :56):
// the same function with block i of sequence b read from pool
// (L, P, Hkv, page, D) page table[b, i] (-1 reads page 0, the trash page);
// it walks min(ceil(len / page), MP) pages. Bound: the live pages' bytes,
// as the slab form, plus one 4-byte table entry per page. Both forms run
// one kernel body, templated on where a block of tokens lives (SlabRows,
// PagedRows): a warp visits the tokens t = warp (mod 4) in increasing
// order whatever the block size, so over the same tokens the paged and
// slab forms sum in the same order and give the same bits.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kD = 128;       // head dim (4 per lane)
constexpr int kWarps = 4;
constexpr int kBlockS = 256;  // tokens per slab block

// Row index (in token rows of kD bytes) of the first token of block `blk`
// of sequence b, kv head h; blocks hold `block` tokens.
struct SlabRows {
  int B, Hkv, S, layer;
  __device__ int limit() const { return S; }
  __device__ int block() const { return kBlockS; }
  __device__ size_t row0(int b, int h, int blk) const {
    return (((size_t)layer * B + b) * Hkv + h) * S + (size_t)blk * kBlockS;
  }
};

struct PagedRows {
  const int* table;
  int P, Hkv, page, MP, layer;
  __device__ int limit() const { return MP * page; }
  __device__ int block() const { return page; }
  __device__ size_t row0(int b, int h, int blk) const {
    const int pid = min(max(table[(size_t)b * MP + blk], 0), P - 1);
    return (((size_t)layer * P + pid) * Hkv + h) * page;
  }
};

template <int G, class Rows>
__global__ void __launch_bounds__(kWarps * 32)
flash_decode_kernel(const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ k,
                    const float* __restrict__ ks, const int8_t* __restrict__ v,
                    const float* __restrict__ vs, const int* __restrict__ lengths,
                    __nv_bfloat16* __restrict__ out, int Hkv, Rows rows, float sm_scale) {
  __shared__ float sh_m[kWarps][G], sh_l[kWarps][G];
  __shared__ float sh_acc[kWarps][G][kD];
  const int b = blockIdx.x, h = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int H = Hkv * G;
  const int len = min(lengths[b], rows.limit());

  float qf[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const __nv_bfloat16* qp = q + ((size_t)b * H + h * G + g) * kD + lane * 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) qf[g][j] = __bfloat162float(qp[j]);
  }
  float m_run[G], l_run[G], acc[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m_run[g] = -INFINITY;
    l_run[g] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[g][j] = 0.f;
  }

  const int bs = rows.block();
  const int n_blocks = (len + bs - 1) / bs;
  for (int blk = 0; blk < n_blocks; ++blk) {
    const size_t r0 = rows.row0(b, h, blk);
    const int t0 = blk * bs;
    const int t_end = min(len, t0 + bs);
    for (int t = t0 + warp; t < t_end; t += kWarps) {
      const size_t r = r0 + (t - t0);
      const unsigned kw = *reinterpret_cast<const unsigned*>(k + r * kD + lane * 4);
      const unsigned vw = *reinterpret_cast<const unsigned*>(v + r * kD + lane * 4);
      float kf[4], vf[4];
      const float kscale = ks[r], vscale = vs[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kf[j] = static_cast<float>(static_cast<int8_t>((kw >> (8 * j)) & 0xFF)) * kscale;
        vf[j] = static_cast<float>(static_cast<int8_t>((vw >> (8 * j)) & 0xFF)) * vscale;
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float s = qf[g][0] * kf[0] + qf[g][1] * kf[1] + qf[g][2] * kf[2] + qf[g][3] * kf[3];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
        s *= sm_scale;
        const float m_new = fmaxf(m_run[g], s);
        const float alpha = expf(m_run[g] - m_new);
        const float p = expf(s - m_new);
        l_run[g] = l_run[g] * alpha + p;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[g][j] = acc[g][j] * alpha + p * vf[j];
        m_run[g] = m_new;
      }
    }
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sh_m[warp][g] = m_run[g];
      sh_l[warp][g] = l_run[g];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) sh_acc[warp][g][lane * 4 + j] = acc[g][j];
  }
  __syncthreads();
  // Merge the warps: thread i writes dims of head i / kD.
  for (int i = threadIdx.x; i < G * kD; i += kWarps * 32) {
    const int g = i / kD, d = i % kD;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sh_m[w][g]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = sh_m[w][g] == -INFINITY ? 0.f : expf(sh_m[w][g] - mx);
      num += sh_acc[w][g][d] * c;
      den += sh_l[w][g] * c;
    }
    out[((size_t)b * H + h * G + g) * kD + d] = __float2bfloat16_rn(num / fmaxf(den, 1e-20f));
  }
}

template <class Rows>
cudaError_t launch(const void* q, const void* k, const void* ks, const void* v, const void* vs,
                   const void* lengths, void* out, int B, int H, int Hkv, int D, Rows rows,
                   float sm_scale, cudaStream_t st) {
  if (D != kD || H % Hkv != 0) return cudaErrorInvalidValue;
  const dim3 grid(B, Hkv);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const int8_t*>(k);
  const auto* ksp = static_cast<const float*>(ks);
  const auto* vp = static_cast<const int8_t*>(v);
  const auto* vsp = static_cast<const float*>(vs);
  const auto* lp = static_cast<const int*>(lengths);
  auto* op = static_cast<__nv_bfloat16*>(out);
  switch (H / Hkv) {
    case 1: flash_decode_kernel<1, Rows><<<grid, kWarps * 32, 0, st>>>(qp, kp, ksp, vp, vsp, lp, op, Hkv, rows, sm_scale); break;
    case 2: flash_decode_kernel<2, Rows><<<grid, kWarps * 32, 0, st>>>(qp, kp, ksp, vp, vsp, lp, op, Hkv, rows, sm_scale); break;
    case 4: flash_decode_kernel<4, Rows><<<grid, kWarps * 32, 0, st>>>(qp, kp, ksp, vp, vsp, lp, op, Hkv, rows, sm_scale); break;
    case 8: flash_decode_kernel<8, Rows><<<grid, kWarps * 32, 0, st>>>(qp, kp, ksp, vp, vsp, lp, op, Hkv, rows, sm_scale); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// Both entries return cudaErrorInvalidValue for a head dim other than 128
// or a group size outside {1, 2, 4, 8}; the wrappers check both first.
extern "C" int ff_flash_decode(const void* q, const void* k, const void* ks, const void* v,
                               const void* vs, const void* lengths, void* out, int L, int B,
                               int H, int Hkv, int S, int D, int layer, float sm_scale,
                               void* stream) {
  (void)L;
  return launch(q, k, ks, v, vs, lengths, out, B, H, Hkv, D, SlabRows{B, Hkv, S, layer},
                sm_scale, static_cast<cudaStream_t>(stream));
}

// table (B, MP) int32; page a multiple of 4 tokens.
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
