// Fused W4A8 layer tail: o_proj + residual + RMSNorm + int8 requant +
// gate/up + SiLU + requant + down + residual, in one cooperative launch;
// and its head alone, o_proj through gate/up (ff_fused_o_gu).
//
// Replaces: fastforward_tpu/kernels/matmul.py fused_o_mlp_stacked (:2298,
// body _fused_o_mlp_kernel :1959); held against fused_o_mlp_reference
// (:2263). And fused_o_gu_stacked (:2118, body _fused_o_gu_kernel :2051;
// oracle fused_o_gu_reference :2241): the same kernel through phase GU,
// which then writes x1 and bf16 gu and stops (the GU_ONLY template flag);
// its x1 takes the o_proj epilogue's last product and the residual add as
// one fused multiply-add, as the jitted oracle computes it. The serving
// path runs it where the full tail is not taken, up to 256 rows. Per row m
// of the decode batch (M <= 64 for the full tail on the serving path):
//   x1 = x_res + o(quant(attn))                       f32
//   h  = x1 * rsqrt(mean(x1^2) + eps) * w_norm
//   gu = bf16(gateup(quant(h)))
//   g  = gate * sigmoid(gate) * up
//   y  = x1 + down(quant(g))
// Every product is the two-level W4A8 GEMV of common.cuh on layer `layer`
// of stacked paired weights (L, K/2, N) with nibble-packed multipliers
// (L, ceil(K/g/8), N) and column scales (L, N); each epilogue is
// (float(acc) * s_col) * x_scale with round-to-nearest multiplies, as the
// oracle computes it. quant(attn) is the wrapper's (quantize_rowwise).
//
// Bound on the H100, Llama-3-8B: 8.39 + 58.72 + 29.36 MB of packed
// weights, ~0.75 MB of multipliers and ~0.15 MB of scales per layer,
// ~97.4 MB in all: ~29 us at 3.35 TB/s. The operations, 2 * M * 1.93e8
// int8, take 6.2 us at M = 32 at the int8 tensor-core rate, so the tail is
// bandwidth-bound up to M = 64. This first design runs the three products
// on dp4a (the CUDA cores), like the stacked GEMV, and sits far above it.
//
// Design. The TPU kernel carried x1, hq, gu and x2 in VMEM across a
// sequential grid; on Hopper blocks run in no order and two row-wide
// reductions (the norm over H, the amax over H and over the intermediate
// width) sit between the products. So: one persistent grid of
// (blocks per SM x SMs) blocks, all resident (cudaLaunchCooperativeKernel),
// with a grid barrier between nine phases:
//   O    GEMV tiles of o_proj (8 rows x 128 columns x one K split each,
//        common.cuh gemv_tile) -> int32 partials
//   E1   x1 = x_res + epilogue(sum of partials); per (row, 128-column
//        chunk) partial sums of x1^2
//   E2   every block adds a row's chunk sums in chunk order -> inv;
//        h = (x1 * inv) * w_norm; per-chunk partial amax |h|
//   E3   row amax in chunk order -> s_h; hq = clamp(rint(h / s_h))
//   GU   GEMV tiles of gate/up on hq
//   E4   gu = bf16(epilogue); g = (gate * sigmoid(gate)) * up; partial amax
//   E5   row amax -> s_g; x2 = clamp(rint(g / s_g))
//   DN   GEMV tiles of down on x2
//   E6   y = x1 + epilogue
// Intermediates live in one global scratch the wrapper allocates (~5.6 MB
// at M = 64, held in the 50 MB L2; for the o + gate/up head at M = 192 the
// gate/up partials alone are 22 MB per K split). The grid and the per-row
// shared memory (8 bytes a row) take any M the launch's memory holds; the
// launch refuses a shape whose tile does not fit an SM. Row reductions never use float
// atomics: every block reads the per-chunk partials in the same order, so
// the result does not change from run to run. IEEE functions only
// (expf, __frsqrt_rn, __fdiv_rn), no fast-math intrinsics.

#include <cooperative_groups.h>

#include <mutex>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kChunk = 128;  // columns per elementwise item: one warp, 4 per lane

struct TailArgs {
  const int8_t* xq;            // (M, K1) quantized attention output
  const float* xs;             // (M,)
  const __nv_bfloat16* x_res;  // (M, H)
  const __nv_bfloat16* norm_w; // (H,) of this layer
  const int8_t* o_w;           // layer slices of the stacked weights
  const int32_t* o_m;
  const float* o_s;
  const int8_t* gu_w;
  const int32_t* gu_m;
  const float* gu_s;
  const int8_t* dn_w;
  const int32_t* dn_m;
  const float* dn_s;
  int32_t* partial;  // (split, M, N) of the running product
  float* x1;         // (M, H)
  int8_t* hq;        // (M, H)
  float* gated;      // (M, I)
  int8_t* x2;        // (M, I)
  float* red_a;      // (M, max chunks) row partials
  float* red_b;
  float* scales;     // (2, M): s_h, s_g
  void* out;         // (M, H) f32 or bf16; GU_ONLY: gu (M, 2I) bf16
  int M, K1, H, I, group, split_o, split_gu, split_dn, out_bf16;
  float eps;
};

__device__ void gemv_phase(const int8_t* x, const int8_t* w, const int32_t* mult,
                           int32_t* partial, int M, int K, int N, int group, int n_split,
                           unsigned char* smem) {
  const int n_units = K / (2 * group);
  const int ups = (n_units + n_split - 1) / n_split;
  const int m_tiles = (M + ff::kBM - 1) / ff::kBM;
  const int n_tiles = (N + ff::kBN - 1) / ff::kBN;
  // row tiles innermost: blocks in flight together read the same weights
  const int items = m_tiles * n_split * n_tiles;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int m_tile = it % m_tiles, rest = it / m_tiles;
    ff::gemv_tile(x, w, mult, partial, M, K, N, group, ups, n_units, m_tile, rest / n_split,
                  rest % n_split, smem);
  }
}

__device__ __forceinline__ int sum_splits(const int32_t* partial, int n_split, int M, int N,
                                          int m, int n) {
  int acc = 0;
  for (int s = 0; s < n_split; ++s) acc += partial[((size_t)s * M + m) * N + n];
  return acc;
}

__device__ __forceinline__ float epi(int acc, float s_col, float x_scale) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), s_col), x_scale);
}

__device__ __forceinline__ int8_t quant8(float v, float s) {
  return static_cast<int8_t>(static_cast<int>(fminf(fmaxf(rintf(__fdiv_rn(v, s)), -128.f), 127.f)));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Per-row totals of the (M, nck) chunk partials into shared memory, added
// (or maxed) in chunk order by one thread per row: every block computes
// the same bits.
template <bool MAX>
__device__ void row_totals(const float* red, int M, int nck, float* out) {
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    float t = 0.f;  // a sum, or the max of values >= 0
    for (int c = 0; c < nck; ++c) {
      const float v = red[(size_t)m * nck + c];
      t = MAX ? fmaxf(t, v) : __fadd_rn(t, v);
    }
    out[m] = t;
  }
  __syncthreads();
}

__device__ __forceinline__ float row_scale(float amax) {
  return fmaxf(__fmul_rn(amax, 1.0f / 127.0f), 1e-8f);
}

// Phases E4, E5, DN and E6 of the full tail (after GU), on the grid of
// fused_tail_kernel.
__device__ void mlp_down_phases(const TailArgs& a, cg::grid_group& grid, unsigned char* smem,
                                float* row_b) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gw = blockIdx.x * ff::kWarps + warp, nw = gridDim.x * ff::kWarps;
  const int M = a.M, H = a.H, I = a.I;
  const int nck_i = (I + kChunk - 1) / kChunk;

  // E4: bf16 gate/up, SiLU-gated product and per-chunk amax
  for (int item = gw; item < M * nck_i; item += nw) {
    const int m = item / nck_i, c = item % nck_i;
    const int n0 = c * kChunk + lane * 4;
    const float s_h = a.scales[m];
    float mx = 0.f;
    if (n0 < I) {
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + j;
        const int ag = sum_splits(a.partial, a.split_gu, M, 2 * I, m, n);
        const int au = sum_splits(a.partial, a.split_gu, M, 2 * I, m, I + n);
        const float gate = __bfloat162float(__float2bfloat16_rn(epi(ag, a.gu_s[n], s_h)));
        const float up = __bfloat162float(__float2bfloat16_rn(epi(au, a.gu_s[I + n], s_h)));
        const float sig = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-gate)));
        const float g = __fmul_rn(__fmul_rn(gate, sig), up);
        a.gated[(size_t)m * I + n] = g;
        mx = fmaxf(mx, fabsf(g));
      }
    }
    mx = warp_max(mx);
    if (lane == 0) a.red_a[(size_t)m * nck_i + c] = mx;
  }
  grid.sync();

  // E5: s_g per row; x2
  row_totals<true>(a.red_a, M, nck_i, row_b);
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    row_b[m] = row_scale(row_b[m]);
    if (blockIdx.x == 0) a.scales[M + m] = row_b[m];
  }
  __syncthreads();
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < M * I; i += gridDim.x * blockDim.x)
    a.x2[i] = quant8(a.gated[i], row_b[i / I]);
  grid.sync();

  // DN: down partials on x2
  gemv_phase(a.x2, a.dn_w, a.dn_m, a.partial, M, I, H, a.group, a.split_dn, smem);
  grid.sync();

  // E6: y = x1 + down
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < M * H; i += gridDim.x * blockDim.x) {
    const int m = i / H, n = i % H;
    const int acc = sum_splits(a.partial, a.split_dn, M, H, m, n);
    const float y = __fadd_rn(a.x1[i], epi(acc, a.dn_s[n], a.scales[M + m]));
    if (a.out_bf16)
      static_cast<__nv_bfloat16*>(a.out)[i] = __float2bfloat16_rn(y);
    else
      static_cast<float*>(a.out)[i] = y;
  }
}

template <bool GU_ONLY>
__global__ void __launch_bounds__(ff::kThreads) fused_tail_kernel(TailArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gw = blockIdx.x * ff::kWarps + warp, nw = gridDim.x * ff::kWarps;
  const int M = a.M, H = a.H, I = a.I;
  const int nck_h = (H + kChunk - 1) / kChunk;
  float* row_a = reinterpret_cast<float*>(smem);  // (M,) per-row values between phases
  float* row_b = row_a + M;

  // O: o_proj partials
  gemv_phase(a.xq, a.o_w, a.o_m, a.partial, M, a.K1, H, a.group, a.split_o, smem);
  grid.sync();

  // E1: x1 and per-chunk sums of squares
  for (int item = gw; item < M * nck_h; item += nw) {
    const int m = item / nck_h, c = item % nck_h;
    const int n0 = c * kChunk + lane * 4;
    float sq = 0.f;
    if (n0 < H) {
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + j;
        const int acc = sum_splits(a.partial, a.split_o, M, H, m, n);
        const float res = __bfloat162float(a.x_res[(size_t)m * H + n]);
        const float x1 =
            GU_ONLY ? __fmaf_rn(__fmul_rn(__int2float_rn(acc), a.o_s[n]), a.xs[m], res)
                    : __fadd_rn(res, epi(acc, a.o_s[n], a.xs[m]));
        a.x1[(size_t)m * H + n] = x1;
        sq = __fadd_rn(sq, __fmul_rn(x1, x1));
      }
    }
    sq = warp_sum(sq);
    if (lane == 0) a.red_a[(size_t)m * nck_h + c] = sq;
  }
  grid.sync();

  // E2: inv per row; h and per-chunk amax |h|
  row_totals<false>(a.red_a, M, nck_h, row_a);
  for (int m = threadIdx.x; m < M; m += blockDim.x)
    row_a[m] = __frsqrt_rn(__fadd_rn(__fdiv_rn(row_a[m], (float)H), a.eps));
  __syncthreads();
  for (int item = gw; item < M * nck_h; item += nw) {
    const int m = item / nck_h, c = item % nck_h;
    const int n0 = c * kChunk + lane * 4;
    float mx = 0.f;
    if (n0 < H) {
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + j;
        const float h = __fmul_rn(__fmul_rn(a.x1[(size_t)m * H + n], row_a[m]),
                                  __bfloat162float(a.norm_w[n]));
        mx = fmaxf(mx, fabsf(h));
      }
    }
    mx = warp_max(mx);
    if (lane == 0) a.red_b[(size_t)m * nck_h + c] = mx;
  }
  grid.sync();

  // E3: s_h per row; hq (row_a still holds inv)
  row_totals<true>(a.red_b, M, nck_h, row_b);
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    row_b[m] = row_scale(row_b[m]);
    if (blockIdx.x == 0) a.scales[m] = row_b[m];
  }
  __syncthreads();
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < M * H; i += gridDim.x * blockDim.x) {
    const int m = i / H, n = i % H;
    const float h = __fmul_rn(__fmul_rn(a.x1[i], row_a[m]), __bfloat162float(a.norm_w[n]));
    a.hq[i] = quant8(h, row_b[m]);
  }
  grid.sync();

  // GU: gate/up partials on hq
  gemv_phase(a.hq, a.gu_w, a.gu_m, a.partial, M, H, 2 * I, a.group, a.split_gu, smem);
  grid.sync();

  if constexpr (GU_ONLY) {
    // EGU: gu = bf16(epilogue), and stop
    __nv_bfloat16* gu = static_cast<__nv_bfloat16*>(a.out);
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < M * 2 * I;
         i += gridDim.x * blockDim.x) {
      const int m = i / (2 * I), n = i % (2 * I);
      const int acc = sum_splits(a.partial, a.split_gu, M, 2 * I, m, n);
      gu[i] = __float2bfloat16_rn(epi(acc, a.gu_s[n], a.scales[m]));
    }
  } else {
    mlp_down_phases(a, grid, smem, row_b);
  }
}

// Blocks of the persistent grid on device `dev` at `smem` bytes of dynamic
// shared memory: (resident blocks per SM) x SMs. The attribute setting and
// the occupancy query run once per (device, smem); a decode step launches
// the tail once per layer with the same few keys. The attribute only ever
// grows, so a smaller size cached earlier stays launchable.
template <bool GU_ONLY>
cudaError_t grid_blocks(int dev, size_t smem, int* blocks) {
  struct Entry {
    int dev;
    size_t smem;
    int blocks;
  };
  constexpr int kMaxEntries = 16, kMaxDevices = 16;
  static Entry cache[kMaxEntries];
  static int n_cached = 0;
  static size_t attr_bytes[kMaxDevices] = {};
  static std::mutex mu;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n_cached; ++i)
    if (cache[i].dev == dev && cache[i].smem == smem) {
      *blocks = cache[i].blocks;
      return cudaSuccess;
    }
  cudaError_t err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem > attr_bytes[dev]) {
    err = cudaFuncSetAttribute(fused_tail_kernel<GU_ONLY>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    attr_bytes[dev] = smem;
  }
  int sms = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_tail_kernel<GU_ONLY>,
                                                      ff::kThreads, smem);
  if (err != cudaSuccess) return err;
  *blocks = per_sm * sms;
  if (n_cached < kMaxEntries) cache[n_cached++] = {dev, smem, *blocks};
  return cudaSuccess;
}

// Dynamic shared memory (the largest GEMV tile of the products run, and
// two floats per row between the elementwise phases), the persistent grid,
// and the cooperative launch. Products: o, gu and, unless GU_ONLY, dn.
template <bool GU_ONLY>
cudaError_t launch_tail(TailArgs& a, cudaStream_t stream) {
  size_t smem = 2 * sizeof(float) * (size_t)a.M;
  const int ks[3] = {a.K1, a.H, a.I}, splits[3] = {a.split_o, a.split_gu, a.split_dn};
  for (int i = 0; i < (GU_ONLY ? 2 : 3); ++i) {
    const int n_units = ks[i] / (2 * a.group);
    const int ups = (n_units + splits[i] - 1) / splits[i];
    const size_t t = ff::gemv_smem_bytes(ups * a.group, ups);
    if (t > smem) smem = t;
  }
  if (smem > 232448) return cudaErrorInvalidConfiguration;  // above an H100 block's 227 KB
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  if ((err = grid_blocks<GU_ONLY>(dev, smem, &blocks)) != cudaSuccess) return err;
  if (blocks < 1) return cudaErrorInvalidConfiguration;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(fused_tail_kernel<GU_ONLY>),
                                    dim3(blocks), dim3(ff::kThreads), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Layer `layer` of the stacked weights: o (L, K1/2, H), gu (L, H/2, 2I),
// dn (L, I/2, H) int8; multipliers (L, n_pack_*, N) int32; s_col (L, N)
// f32; norm_w (L, H) bf16. Scratch pointers as TailArgs; the wrapper sizes
// them. Returns cudaErrorInvalidConfiguration when not one block of the
// kernel fits an SM, else the launch's error.
extern "C" int ff_fused_o_mlp(const void* xq, const void* xs, const void* x_res,
                              const void* norm_w, const void* o_w, const void* o_m,
                              const void* o_s, const void* gu_w, const void* gu_m,
                              const void* gu_s, const void* dn_w, const void* dn_m,
                              const void* dn_s, void* partial, void* x1, void* hq, void* gated,
                              void* x2, void* red_a, void* red_b, void* scales, void* out, int M,
                              int K1, int H, int I, int L, int layer, int group, int n_pack_o,
                              int n_pack_gu, int n_pack_dn, int split_o, int split_gu,
                              int split_dn, float eps, int out_bf16, void* stream) {
  (void)L;
  TailArgs a;
  a.xq = static_cast<const int8_t*>(xq);
  a.xs = static_cast<const float*>(xs);
  a.x_res = static_cast<const __nv_bfloat16*>(x_res);
  a.norm_w = static_cast<const __nv_bfloat16*>(norm_w) + (size_t)layer * H;
  a.o_w = static_cast<const int8_t*>(o_w) + (size_t)layer * (K1 / 2) * H;
  a.o_m = static_cast<const int32_t*>(o_m) + (size_t)layer * n_pack_o * H;
  a.o_s = static_cast<const float*>(o_s) + (size_t)layer * H;
  a.gu_w = static_cast<const int8_t*>(gu_w) + (size_t)layer * (H / 2) * (2 * I);
  a.gu_m = static_cast<const int32_t*>(gu_m) + (size_t)layer * n_pack_gu * (2 * I);
  a.gu_s = static_cast<const float*>(gu_s) + (size_t)layer * (2 * I);
  a.dn_w = static_cast<const int8_t*>(dn_w) + (size_t)layer * (I / 2) * H;
  a.dn_m = static_cast<const int32_t*>(dn_m) + (size_t)layer * n_pack_dn * H;
  a.dn_s = static_cast<const float*>(dn_s) + (size_t)layer * H;
  a.partial = static_cast<int32_t*>(partial);
  a.x1 = static_cast<float*>(x1);
  a.hq = static_cast<int8_t*>(hq);
  a.gated = static_cast<float*>(gated);
  a.x2 = static_cast<int8_t*>(x2);
  a.red_a = static_cast<float*>(red_a);
  a.red_b = static_cast<float*>(red_b);
  a.scales = static_cast<float*>(scales);
  a.out = out;
  a.M = M;
  a.K1 = K1;
  a.H = H;
  a.I = I;
  a.group = group;
  a.split_o = split_o;
  a.split_gu = split_gu;
  a.split_dn = split_dn;
  a.out_bf16 = out_bf16;
  a.eps = eps;
  return launch_tail<false>(a, static_cast<cudaStream_t>(stream));
}

// The o + gate/up head: o (L, K1/2, H), gu (L, H/2, 2I); scratch partial,
// hq, red_a, red_b, scales (2, M); outputs x1 (M, H) f32 and gu (M, 2I)
// bf16. Errors as ff_fused_o_mlp.
extern "C" int ff_fused_o_gu(const void* xq, const void* xs, const void* x_res,
                             const void* norm_w, const void* o_w, const void* o_m,
                             const void* o_s, const void* gu_w, const void* gu_m,
                             const void* gu_s, void* partial, void* hq, void* red_a, void* red_b,
                             void* scales, void* x1, void* gu, int M, int K1, int H, int I,
                             int layer, int group, int n_pack_o, int n_pack_gu, int split_o,
                             int split_gu, float eps, void* stream) {
  TailArgs a = {};
  a.xq = static_cast<const int8_t*>(xq);
  a.xs = static_cast<const float*>(xs);
  a.x_res = static_cast<const __nv_bfloat16*>(x_res);
  a.norm_w = static_cast<const __nv_bfloat16*>(norm_w) + (size_t)layer * H;
  a.o_w = static_cast<const int8_t*>(o_w) + (size_t)layer * (K1 / 2) * H;
  a.o_m = static_cast<const int32_t*>(o_m) + (size_t)layer * n_pack_o * H;
  a.o_s = static_cast<const float*>(o_s) + (size_t)layer * H;
  a.gu_w = static_cast<const int8_t*>(gu_w) + (size_t)layer * (H / 2) * (2 * I);
  a.gu_m = static_cast<const int32_t*>(gu_m) + (size_t)layer * n_pack_gu * (2 * I);
  a.gu_s = static_cast<const float*>(gu_s) + (size_t)layer * (2 * I);
  a.partial = static_cast<int32_t*>(partial);
  a.x1 = static_cast<float*>(x1);
  a.hq = static_cast<int8_t*>(hq);
  a.red_a = static_cast<float*>(red_a);
  a.red_b = static_cast<float*>(red_b);
  a.scales = static_cast<float*>(scales);
  a.out = gu;
  a.M = M;
  a.K1 = K1;
  a.H = H;
  a.I = I;
  a.group = group;
  a.split_o = split_o;
  a.split_gu = split_gu;
  a.eps = eps;
  return launch_tail<true>(a, static_cast<cudaStream_t>(stream));
}
