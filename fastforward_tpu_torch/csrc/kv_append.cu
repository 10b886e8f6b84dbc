// In-place decode-step append into the layer-stacked INT8 KV cache, and
// into the paged pool through a page table.
//
// Replaces: fastforward_tpu/kernels/kv_update.py
// kv_append_decode_int8_stacked (:100, body _kv_update_stacked_kernel :69)
// and the per-layer kv_append_decode_int8 (:219, body _kv_update_kernel
// :192): a per-layer (B, Hkv, S, D) cache is layer 0 of L = 1, the same
// rows at the same offsets, so ff_kv_append serves both exactly;
// and fastforward_tpu/kernels/paged_attention.py
// paged_kv_append_decode_int8 (:293, body _paged_append_kernel :260).
// Writes one token's int8 K and V rows (B, Hkv, D) and their f32 scales
// (B, Hkv) at row starts[b] of layer l of the (L, B, Hkv, S, D) cache; a
// start outside [0, S) writes nothing, as in the masked-select oracle
// kv_append_decode_stacked_reference. Bit-exact (pure copies).
//
// Bound on the H100: 2*B*Hkv*(D + 4) bytes of new data, a few KB per
// layer: launch latency, far below any bandwidth or compute bound.
//
// Design for that bound: one block per (b, kv head), one thread per byte
// of the row; only the written row is touched, the cache is never read.
// The TPU kernel's tile-aligned read-modify-write of a 32-row block is not
// needed: global memory takes byte-granular stores.
//
// The paged append writes the same row into pool (L, P, Hkv, page, D) at
// page table[b, pos / page], row pos % page; one block per (b, kv head)
// reads its page id itself. A page id of -1 addresses page 0, the trash
// page, as the JAX wrapper's max(table, 0) makes it. A page index
// pos / page at or beyond MP addresses page 0 as in the JAX reference
// (paged_kv_append_reference), where the TPU kernel reads the flat table
// at b * MP + pos / page, the next sequence's entry. Bound and design as
// the slab append: a few KB per layer, launch latency.
//
// The decode step's entries (ff_kv_quantize_append, ff_paged_kv_quantize_
// append) fuse the K/V quantizer into the append, so a layer's decode
// quantize-and-append is one launch where it was nineteen (the quantizer's
// nine elementwise kernels a tensor in PyTorch, then the copy). They take
// the token's bf16 (or f32) k and v (B, Hkv, 1, D) as they lie, through
// their strides (v is a view of the qkv projection's output), and compute
// the serving package's _quantize_kv (JAX: serving/kv_cache.py:24) per
// (b, head) row, bit for bit:
//   amax  = max_d |f32(x[d])|                        (exact in any order)
//   scale = max(amax * f32(1/127), 1e-8)             (one rounded multiply)
//   q[d]  = clamp(rint(f32(x[d]) / scale), -128, 127) (IEEE division, ties
//                                                      to even)
// then write the row as the int8 entries do (for finite k and v: a NaN
// row's bytes are not held to PyTorch's casts). One block per (b, kv head),
// a thread per d: a warp-shuffle max, one more through shared memory, one
// store a byte. The int8-input entries stay the counterparts of the JAX
// functions of their names.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__global__ void kv_append_kernel(int8_t* __restrict__ kc, int8_t* __restrict__ vc,
                                 float* __restrict__ ks, float* __restrict__ vs,
                                 const int8_t* __restrict__ k_new,
                                 const int8_t* __restrict__ v_new,
                                 const float* __restrict__ ks_new,
                                 const float* __restrict__ vs_new,
                                 const int* __restrict__ starts, int B, int Hkv, int S, int D,
                                 int layer) {
  const int b = blockIdx.x, h = blockIdx.y;
  const int s = starts[b];
  if (s < 0 || s >= S) return;
  const size_t bh = ((size_t)layer * B + b) * Hkv + h;  // (l, b, h) row of S
  const size_t src = (size_t)b * Hkv + h;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    kc[(bh * S + s) * D + d] = k_new[src * D + d];
    vc[(bh * S + s) * D + d] = v_new[src * D + d];
  }
  if (threadIdx.x == 0) {
    ks[bh * S + s] = ks_new[src];
    vs[bh * S + s] = vs_new[src];
  }
}

__global__ void paged_kv_append_kernel(int8_t* __restrict__ kc, int8_t* __restrict__ vc,
                                       float* __restrict__ ks, float* __restrict__ vs,
                                       const int8_t* __restrict__ k_new,
                                       const int8_t* __restrict__ v_new,
                                       const float* __restrict__ ks_new,
                                       const float* __restrict__ vs_new,
                                       const int* __restrict__ positions,
                                       const int* __restrict__ table, int P, int Hkv, int page,
                                       int MP, int D, int layer) {
  const int b = blockIdx.x, h = blockIdx.y;
  const int pos = positions[b];
  const int idx = pos / page;
  int pid = (idx >= 0 && idx < MP) ? table[(size_t)b * MP + idx] : 0;
  pid = min(max(pid, 0), P - 1);
  const size_t row = (((size_t)layer * P + pid) * Hkv + h) * page + pos % page;
  const size_t src = (size_t)b * Hkv + h;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    kc[row * D + d] = k_new[src * D + d];
    vc[row * D + d] = v_new[src * D + d];
  }
  if (threadIdx.x == 0) {
    ks[row] = ks_new[src];
    vs[row] = vs_new[src];
  }
}


// The larger of two |x|, a NaN winning as in torch.amax.
__device__ __forceinline__ float nan_max(float a, float b) { return (b > a || b != b) ? b : a; }

template <typename T>
__device__ __forceinline__ float load_f32(const T* p);
template <>
__device__ __forceinline__ float load_f32<float>(const float* p) { return *p; }
template <>
__device__ __forceinline__ float load_f32<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// The row (b, h) of k and v quantized and written at cache row `row` (of D
// bytes and one scale), or nowhere where row < 0. blockDim.x = D rounded up
// to a warp, at most 1024.
template <typename T>
__device__ __forceinline__ void quantize_rows(int8_t* __restrict__ kc, int8_t* __restrict__ vc,
                                              float* __restrict__ ks, float* __restrict__ vs,
                                              const T* __restrict__ k, const T* __restrict__ v,
                                              const int* sk, const int* sv, int D, long long row) {
  __shared__ float red[2][32];
  const int b = blockIdx.x, h = blockIdx.y, d = threadIdx.x;
  const int lane = d % 32, warp = d / 32;
  const float kf = d < D ? load_f32(k + (size_t)b * sk[0] + (size_t)h * sk[1] + (size_t)d * sk[2])
                         : 0.f;
  const float vf = d < D ? load_f32(v + (size_t)b * sv[0] + (size_t)h * sv[1] + (size_t)d * sv[2])
                         : 0.f;
  float ka = fabsf(kf), va = fabsf(vf);
#pragma unroll
  for (int o = 16; o > 0; o /= 2) {
    ka = nan_max(ka, __shfl_xor_sync(0xffffffffu, ka, o));
    va = nan_max(va, __shfl_xor_sync(0xffffffffu, va, o));
  }
  if (lane == 0) {
    red[0][warp] = ka;
    red[1][warp] = va;
  }
  __syncthreads();
  ka = red[0][0];
  va = red[1][0];
  for (int w = 1; w < (int)(blockDim.x / 32); ++w) {
    ka = nan_max(ka, red[0][w]);
    va = nan_max(va, red[1][w]);
  }
  if (row < 0) return;
  float s_k = __fmul_rn(ka, 1.0f / 127.0f), s_v = __fmul_rn(va, 1.0f / 127.0f);
  s_k = s_k != s_k ? s_k : fmaxf(s_k, 1e-8f);  // torch.clamp keeps a NaN
  s_v = s_v != s_v ? s_v : fmaxf(s_v, 1e-8f);
  if (d < D) {
    const float qk = fminf(fmaxf(rintf(__fdiv_rn(kf, s_k)), -128.f), 127.f);
    const float qv = fminf(fmaxf(rintf(__fdiv_rn(vf, s_v)), -128.f), 127.f);
    kc[row * D + d] = (int8_t)(int)qk;
    vc[row * D + d] = (int8_t)(int)qv;
  }
  if (d == 0) {
    ks[row] = s_k;
    vs[row] = s_v;
  }
}

// Slab (L, B, Hkv, S, D): row starts[b] of layer `layer`; none outside [0, S).
template <typename T>
__global__ void kv_quantize_append_kernel(int8_t* kc, int8_t* vc, float* ks, float* vs,
                                          const T* k, const T* v, const int* __restrict__ starts,
                                          int B, int Hkv, int S, int D, int layer, int k_sb,
                                          int k_sh, int k_sd, int v_sb, int v_sh, int v_sd) {
  const int b = blockIdx.x, h = blockIdx.y;
  const int s = starts[b];
  const long long row = s < 0 || s >= S ? -1 : (((long long)layer * B + b) * Hkv + h) * S + s;
  const int sk[3] = {k_sb, k_sh, k_sd}, sv[3] = {v_sb, v_sh, v_sd};
  quantize_rows(kc, vc, ks, vs, k, v, sk, sv, D, row);
}

// Paged pool (L, P, Hkv, page, D): row pos % page of page table[b, pos /
// page], page 0 for a page id of -1 or an index at or beyond MP.
template <typename T>
__global__ void paged_kv_quantize_append_kernel(int8_t* kc, int8_t* vc, float* ks, float* vs,
                                                const T* k, const T* v,
                                                const int* __restrict__ positions,
                                                const int* __restrict__ table, int P, int Hkv,
                                                int page, int MP, int D, int layer, int k_sb,
                                                int k_sh, int k_sd, int v_sb, int v_sh, int v_sd) {
  const int b = blockIdx.x, h = blockIdx.y;
  const int pos = positions[b];
  const int idx = pos / page;
  int pid = (idx >= 0 && idx < MP) ? table[(size_t)b * MP + idx] : 0;
  pid = min(max(pid, 0), P - 1);
  const long long row = (((long long)layer * P + pid) * Hkv + h) * page + pos % page;
  const int sk[3] = {k_sb, k_sh, k_sd}, sv[3] = {v_sb, v_sh, v_sd};
  quantize_rows(kc, vc, ks, vs, k, v, sk, sv, D, row);
}

}  // namespace

// Positions must be >= 0 (the engine's positions are).
extern "C" int ff_paged_kv_append(void* kc, void* vc, void* ks, void* vs, const void* k_new,
                                  const void* v_new, const void* ks_new, const void* vs_new,
                                  const void* positions, const void* table, int L, int P, int B,
                                  int Hkv, int page, int MP, int D, int layer, void* stream) {
  (void)L;
  paged_kv_append_kernel<<<dim3(B, Hkv), 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int8_t*>(kc), static_cast<int8_t*>(vc), static_cast<float*>(ks),
      static_cast<float*>(vs), static_cast<const int8_t*>(k_new),
      static_cast<const int8_t*>(v_new), static_cast<const float*>(ks_new),
      static_cast<const float*>(vs_new), static_cast<const int*>(positions),
      static_cast<const int*>(table), P, Hkv, page, MP, D, layer);
  return cudaGetLastError();
}

extern "C" int ff_kv_append(void* kc, void* vc, void* ks, void* vs, const void* k_new,
                            const void* v_new, const void* ks_new, const void* vs_new,
                            const void* starts, int L, int B, int Hkv, int S, int D, int layer,
                            void* stream) {
  (void)L;
  kv_append_kernel<<<dim3(B, Hkv), 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int8_t*>(kc), static_cast<int8_t*>(vc), static_cast<float*>(ks),
      static_cast<float*>(vs), static_cast<const int8_t*>(k_new),
      static_cast<const int8_t*>(v_new), static_cast<const float*>(ks_new),
      static_cast<const float*>(vs_new), static_cast<const int*>(starts), B, Hkv, S, D, layer);
  return cudaGetLastError();
}

// The decode step's fused entries: k, v (B, Hkv, 1, D) bf16 (in_bf16) or
// f32 at element strides (b, h, d); D <= 1024; starts (B,) int32.
extern "C" int ff_kv_quantize_append(void* kc, void* vc, void* ks, void* vs, const void* k,
                                     const void* v, const void* starts, int L, int B, int Hkv,
                                     int S, int D, int layer, int k_sb, int k_sh, int k_sd,
                                     int v_sb, int v_sh, int v_sd, int in_bf16, void* stream) {
  (void)L;
  if (D < 1 || D > 1024) return cudaErrorInvalidValue;
  const dim3 grid(B, Hkv), block((D + 31) / 32 * 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t *kq = static_cast<int8_t*>(kc), *vq = static_cast<int8_t*>(vc);
  float *kscale = static_cast<float*>(ks), *vscale = static_cast<float*>(vs);
  const int* rows = static_cast<const int*>(starts);
  if (in_bf16)
    kv_quantize_append_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
        kq, vq, kscale, vscale, static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), rows, B, Hkv, S, D, layer, k_sb, k_sh, k_sd, v_sb,
        v_sh, v_sd);
  else
    kv_quantize_append_kernel<float><<<grid, block, 0, st>>>(
        kq, vq, kscale, vscale, static_cast<const float*>(k), static_cast<const float*>(v), rows,
        B, Hkv, S, D, layer, k_sb, k_sh, k_sd, v_sb, v_sh, v_sd);
  return cudaGetLastError();
}

// Positions must be >= 0 (the engine's are); table (B, MP) int32.
extern "C" int ff_paged_kv_quantize_append(void* kc, void* vc, void* ks, void* vs, const void* k,
                                           const void* v, const void* positions,
                                           const void* table, int L, int P, int B, int Hkv,
                                           int page, int MP, int D, int layer, int k_sb,
                                           int k_sh, int k_sd, int v_sb, int v_sh, int v_sd,
                                           int in_bf16, void* stream) {
  (void)L;
  if (D < 1 || D > 1024) return cudaErrorInvalidValue;
  const dim3 grid(B, Hkv), block((D + 31) / 32 * 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t *kq = static_cast<int8_t*>(kc), *vq = static_cast<int8_t*>(vc);
  float *kscale = static_cast<float*>(ks), *vscale = static_cast<float*>(vs);
  const int *pos = static_cast<const int*>(positions), *tab = static_cast<const int*>(table);
  if (in_bf16)
    paged_kv_quantize_append_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
        kq, vq, kscale, vscale, static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), pos, tab, P, Hkv, page, MP, D, layer, k_sb, k_sh,
        k_sd, v_sb, v_sh, v_sd);
  else
    paged_kv_quantize_append_kernel<float><<<grid, block, 0, st>>>(
        kq, vq, kscale, vscale, static_cast<const float*>(k), static_cast<const float*>(v), pos,
        tab, P, Hkv, page, MP, D, layer, k_sb, k_sh, k_sd, v_sb, v_sh, v_sd);
  return cudaGetLastError();
}
