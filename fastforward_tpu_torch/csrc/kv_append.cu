// In-place decode-step append into the layer-stacked INT8 KV cache, and
// into the paged pool through a page table.
//
// Replaces: fastforward_tpu/kernels/kv_update.py
// kv_append_decode_int8_stacked (:100, body _kv_update_stacked_kernel :69),
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

#include <cstdint>
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
