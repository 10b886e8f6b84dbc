// Blocked causal prefill attention over one layer of the KV cache, INT8
// or bf16.
//
// Replaces: fastforward_tpu/kernels/attention.py flash_prefill (:971,
// kernel _flash_prefill_kernel :886), both branches.
//   q (B, H, T, D) bf16; k, v (B, Hkv, S, D) int8 with per-token f32
//   scales (B, Hkv, S), or bf16 without scales (ff_flash_prefill_bf16:
//   the TPU kernel multiplies by all-ones scales, which here are the
//   constant 1); starts (B,) int32; out (B, H, T, D) bf16; D = 128.
// Query row t of sequence b sits at position starts[b] + t and sees the
// keys s <= starts[b] + t. The G = H / Hkv query heads of a kv head share
// its K/V tiles (no repeat). Per tile of 64 keys, as the TPU kernel
// computes it:
//   scores = (q . bf16(k)) [f32 accumulation] * k_scale * sm_scale,
//            -1e30 where masked;
//   online softmax in f32: m' = max(m, rowmax), alpha = exp(m - m'),
//            p = exp(scores - m'), l = l * alpha + rowsum(p);
//   acc = acc * alpha + bf16(p * v_scale) . bf16(v)   [f32 accumulation];
// and out = acc / max(l, 1e-20). Held against flash_prefill_reference
// (f32 throughout) within 8e-3 of the largest output.
//
// Bound on the H100: bytes. q is read and out written once (B*H*T*D*2
// bytes each), and the live K/V rows with their scales once: at bench.py's
// shape (B 192, H 32, Hkv 8, T 128, starts 0) ~0.45 GB, ~0.135 ms (bf16
// K/V: ~0.53 GB, ~0.16 ms); the 4*B*H*D*T(T+1)/2 = 2.6e10 bf16 operations
// take 0.026 ms at 989 TFLOP/s.
//
// Design for that bound: one block per (t tile, kv head, sequence) with
// 64 query rows (G heads x 64/G positions), 4 warps of 16 rows. The block
// walks only the key tiles at or below its causal frontier
// starts[b] + t_last, never the dead rest of the slab (the TPU kernel
// skipped their compute but still copied them in). Each tile's K and V
// rows are read once for all G heads into shared memory as bf16: int8
// widened on the way (exact), bf16 copied as it is. The element type is a
// template argument of the one kernel body, so both caches run the same
// products in the same order. Both products run on the tensor cores (mma.sync m16n8k16 bf16,
// f32 accumulation); the score fragments stay in registers, become the
// bf16 A fragments of the PV product in place, and the output accumulator
// never leaves registers until the final store.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kD = 128;              // head dim
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps * 16;   // query rows per block
constexpr int kBS = 64;              // keys per tile
constexpr int kPitch = kD + 8;       // shared row pitch in bf16 (272 bytes): conflict-free fragment loads
constexpr float kNegInf = -1e30f;    // the TPU kernel's NEG_INF

// c += a . b on one 16x8 tile (A 16x16 row-major, B 16x8 column-major).
__device__ __forceinline__ void mma_bf16(float c[4], const unsigned a[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned bf16x2(float lo, float hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

__device__ __forceinline__ unsigned raw2(const __nv_bfloat16* lo, const __nv_bfloat16* hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(*lo)) |
         (static_cast<unsigned>(__bfloat16_as_ushort(*hi)) << 16);
}

// 16 int8 values (one uint4) widened to bf16 at dst (32 bytes, 16-aligned).
__device__ __forceinline__ void widen16(const uint4 src, __nv_bfloat16* dst) {
  const unsigned words[4] = {src.x, src.y, src.z, src.w};
  unsigned out[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const unsigned wd = words[i / 2], sh = 16 * (i % 2);
    const float lo = static_cast<float>(static_cast<int8_t>((wd >> sh) & 0xFFu));
    const float hi = static_cast<float>(static_cast<int8_t>((wd >> (sh + 8)) & 0xFFu));
    out[i] = bf16x2(lo, hi);  // exact: |int8| < 2^8
  }
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(out[0], out[1], out[2], out[3]);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(out[4], out[5], out[6], out[7]);
}

// 16 cache values at src (16-byte aligned) into bf16 at dst.
__device__ __forceinline__ void load16(const int8_t* src, __nv_bfloat16* dst) {
  widen16(*reinterpret_cast<const uint4*>(src), dst);
}
__device__ __forceinline__ void load16(const __nv_bfloat16* src, __nv_bfloat16* dst) {
  reinterpret_cast<uint4*>(dst)[0] = reinterpret_cast<const uint4*>(src)[0];
  reinterpret_cast<uint4*>(dst)[1] = reinterpret_cast<const uint4*>(src)[1];
}
__device__ __forceinline__ void zero16(__nv_bfloat16* dst) {
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(0, 0, 0, 0);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(0, 0, 0, 0);
}

// Grid: (ceil(T / (64 / G)), Hkv, B); kThreads threads. KV: int8_t with
// f32 scales ks/vs, or __nv_bfloat16 with ks = vs = nullptr (scale 1).
template <typename KV>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const __nv_bfloat16* __restrict__ q, const KV* __restrict__ k,
                     const float* __restrict__ ks, const KV* __restrict__ v,
                     const float* __restrict__ vs, const int* __restrict__ starts,
                     __nv_bfloat16* __restrict__ out, int Hkv, int G, int T, int S,
                     float sm_scale) {
  __shared__ __align__(16) __nv_bfloat16 sk[kBS * kPitch];
  __shared__ __align__(16) __nv_bfloat16 sv[kBS * kPitch];
  __shared__ float sks[kBS], svs[kBS];

  const int bt = kRows / G;  // positions per block
  const int t0 = blockIdx.x * bt;
  const int h = blockIdx.y, b = blockIdx.z;
  const int H = Hkv * G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;  // mma group id, thread in group
  const int start = starts[b];

  // This lane's two query rows: block rows warp*16 + gq and + 8.
  int t_pos[2];
  size_t row_off[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + gq + 8 * i;
    t_pos[i] = t0 + r % bt;
    row_off[i] = (((size_t)b * H + h * G + r / bt) * T + t_pos[i]) * kD;
  }
  // Q as A fragments: 8 chunks of 16 dims; padding rows (t >= T) are 0.
  unsigned qa[8][4];
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = j % 2, col = kk * 16 + 2 * tq + 8 * (j / 2);
      qa[kk][j] = t_pos[i] < T ? *reinterpret_cast<const unsigned*>(q + row_off[i] + col) : 0u;
    }
  }

  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  float o[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  // Causal frontier of the block: the last key any of its live rows sees.
  const int frontier = start + min(t0 + bt, T) - 1;
  const int n_tiles = min((S + kBS - 1) / kBS, frontier / kBS + 1);
  const size_t kv0 = ((size_t)b * Hkv + h) * S;  // first cache row of (b, h)

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int s0 = tile * kBS;
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < kBS * (kD / 16); i += kThreads) {
      const int r = i / (kD / 16), c = (i % (kD / 16)) * 16;
      if (s0 + r < S) {
        load16(k + (kv0 + s0 + r) * kD + c, sk + r * kPitch + c);
        load16(v + (kv0 + s0 + r) * kD + c, sv + r * kPitch + c);
      } else {
        zero16(sk + r * kPitch + c);
        zero16(sv + r * kPitch + c);
      }
    }
    if (threadIdx.x < kBS) {
      const int s = s0 + threadIdx.x;
      sks[threadIdx.x] = s < S ? (ks != nullptr ? ks[kv0 + s] : 1.f) : 0.f;
      svs[threadIdx.x] = s < S ? (vs != nullptr ? vs[kv0 + s] : 1.f) : 0.f;
    }
    __syncthreads();

    // scores (16 rows x 64 keys per warp) = Q K^T
    float sc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const __nv_bfloat16* kp = sk + (j * 8 + gq) * kPitch + kk * 16 + 2 * tq;
        mma_bf16(sc[j], qa[kk], *reinterpret_cast<const unsigned*>(kp),
                 *reinterpret_cast<const unsigned*>(kp + 8));
      }
    }

    // scale, mask, online softmax (element e of tile j: row e / 2, key
    // s0 + 8j + 2tq + e % 2; a row's 64 keys lie in the 4 lanes of a quad)
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * tq + e % 2, i = e / 2;
        const int s = s0 + col;
        const float x = __fmul_rn(__fmul_rn(sc[j][e], sks[col]), sm_scale);
        sc[j][e] = (s < S && s <= start + t_pos[i]) ? x : kNegInf;
        mx[i] = fmaxf(mx[i], sc[j][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_run[i], mx[i]);
      alpha[i] = expf(m_run[i] - m_new);
      m_run[i] = m_new;
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * tq + e % 2, i = e / 2;
        const float p = expf(sc[j][e] - m_run[i]);
        psum[i] += p;
        sc[j][e] = __fmul_rn(p, svs[col]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_run[i] = l_run[i] * alpha[i] + psum[i];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // acc += bf16(p * v_scale) V: the score tiles 2kk and 2kk + 1 are the
    // A fragment of key chunk kk; B is read from V (keys x dims) rows.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const unsigned pa[4] = {bf16x2(sc[2 * kk][0], sc[2 * kk][1]),
                              bf16x2(sc[2 * kk][2], sc[2 * kk][3]),
                              bf16x2(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                              bf16x2(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const __nv_bfloat16* vp = sv + (kk * 16 + 2 * tq) * kPitch + j * 8 + gq;
        mma_bf16(o[j], pa, raw2(vp, vp + kPitch), raw2(vp + 8 * kPitch, vp + 9 * kPitch));
      }
    }
  }

  // Row sums are partial per lane: add the quad's four, then normalize.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float den = fmaxf(l, 1e-20f);
    if (t_pos[i] >= T) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      *reinterpret_cast<unsigned*>(out + row_off[i] + j * 8 + 2 * tq) =
          bf16x2(o[j][2 * i] / den, o[j][2 * i + 1] / den);
    }
  }
}

template <typename KV>
int launch(const void* q, const void* k, const void* ks, const void* v, const void* vs,
           const void* starts, void* out, int B, int H, int Hkv, int T, int S, int D,
           float sm_scale, cudaStream_t st) {
  if (D != kD || H % Hkv != 0) return cudaErrorInvalidValue;
  const int G = H / Hkv;
  if (G != 1 && G != 2 && G != 4 && G != 8) return cudaErrorInvalidValue;
  const int bt = kRows / G;
  const dim3 grid((T + bt - 1) / bt, Hkv, B);
  flash_prefill_kernel<KV><<<grid, kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(k),
      static_cast<const float*>(ks), static_cast<const KV*>(v), static_cast<const float*>(vs),
      static_cast<const int*>(starts), static_cast<__nv_bfloat16*>(out), Hkv, G, T, S,
      sm_scale);
  return cudaGetLastError();
}

}  // namespace

// Both entries return cudaErrorInvalidValue for a head dim other than 128
// or a group size outside {1, 2, 4, 8}; the wrappers check both first.
extern "C" int ff_flash_prefill(const void* q, const void* k, const void* ks, const void* v,
                                const void* vs, const void* starts, void* out, int B, int H,
                                int Hkv, int T, int S, int D, float sm_scale, void* stream) {
  return launch<int8_t>(q, k, ks, v, vs, starts, out, B, H, Hkv, T, S, D, sm_scale,
                        static_cast<cudaStream_t>(stream));
}

// bf16 K/V (B, Hkv, S, D), no scales.
extern "C" int ff_flash_prefill_bf16(const void* q, const void* k, const void* v,
                                     const void* starts, void* out, int B, int H, int Hkv, int T,
                                     int S, int D, float sm_scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, nullptr, v, nullptr, starts, out, B, H, Hkv, T, S, D,
                               sm_scale, static_cast<cudaStream_t>(stream));
}
