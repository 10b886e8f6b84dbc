// Fused W4A8 layer tail: o_proj + residual + RMSNorm + int8 requant +
// gate/up + SiLU + requant + down + residual, from one C entry; and its
// head alone, o_proj through gate/up (ff_fused_o_gu).
//
// Replaces: fastforward_tpu/kernels/matmul.py fused_o_mlp_stacked (:2298,
// body _fused_o_mlp_kernel :1959, pallas_call :2413); held against
// fused_o_mlp_reference (:2263). And fused_o_gu_stacked (:2118, body
// _fused_o_gu_kernel :2051, pallas_call :2217; oracle fused_o_gu_reference
// :2241): the same launches through gate/up, which then writes x1 and bf16
// gu and stops; its x1 takes the o_proj epilogue's last product and the
// residual add as one fused multiply-add, as the jitted oracle computes it.
// The serving path runs it where the full tail is not taken, up to 256
// rows. Per row m of the decode batch (M <= 64 for the full tail on the
// serving path):
//   xq = quant(attn)                                  int8, scale xs
//   x1 = x_res + o(xq)                                f32
//   h  = x1 * rsqrt(mean(x1^2) + eps) * w_norm
//   gu = bf16(gateup(quant(h)))
//   g  = gate * sigmoid(gate) * up
//   y  = x1 + down(quant(g))
// Every product is the two-level W4A8 GEMV on layer `layer` of stacked
// paired weights (L, K/2, N) with nibble-packed multipliers (L,
// ceil(K/g/8), N) and column scales (L, N); each epilogue is
// (float(acc) * s_col) * x_scale with round-to-nearest multiplies, as the
// oracle computes it. quant is the row quantizer max(amax * (1/127), 1e-8),
// clamp(rint(v / s)) (kernels/matmul.py quantize_rowwise).
//
// Bound on the H100, Llama-3-8B: 8.39 + 58.72 + 29.36 MB of packed
// weights, ~0.75 MB of multipliers and ~0.15 MB of scales per layer,
// ~97.4 MB in all: ~29 us at 3.35 TB/s. The operations, 2 * M * 1.93e8
// int8, take 6.2 us at M = 32 at the int8 tensor-core rate, so the tail is
// bandwidth-bound up to M = 64 (the o + gate/up head at M = 192: 2.9e10
// operations, 15 us, against 67.5 MB, 20 us).
//
// Design. The TPU kernel carried x1, hq, gu and x2 in VMEM across a
// sequential grid; on Hopper blocks run in no order, and two row-wide
// reductions (the norm over H, the amax over H and over the intermediate
// width) sit between the products. So each product is w4a8_mma.cuh's int8
// tensor-core tile (launch_staged, planned per product by kernels/matmul.py
// tail_plan, paired layout), and each step between two products is a small
// row kernel that reads the tile's int32 partials (output kind
// kOutPartials: a single split's too), applies the epilogue this step
// needs, reduces its row, requantizes it and stages it for the next
// product in the tile's fragment order (stage_row, from the int8 row it
// computed), one block of 1,024 threads a row. Launches, in stream order
// from one C entry:
//   tail_quant_kernel     xq, xs; stages xq for o_proj
//   tile                  o_proj partials
//   tail_norm_kernel      x1; the row's sum of squares, inv, h, amax, s_h,
//                         hq; stages hq for gate/up
//   tile                  gate/up: ff_fused_o_gu writes bf16 gu through the
//                         tile's own epilogue (and common.cuh's split
//                         epilogue where the plan splits) and stops here
//   tail_act_kernel       gate, up = bf16(epilogue); g; amax, s_g, x2;
//                         stages x2 for down
//   tile                  down partials
//   tail_out_kernel       y = x1 + epilogue
// The intermediates live in one scratch buffer the wrapper allocates. A
// cooperative grid running the tile's body between grid barriers would
// save the launches but would have to re-arm the ring's mbarriers across
// them; the first design (a persistent grid of dp4a tiles, eight grid
// barriers) spent more on barriers and on dp4a than the launches cost.
//
// Numerics, bit-equal to that first kernel: the int32 sums are exact in
// any order; a row's sum of squares is added per 128-column chunk (a
// lane's 4 columns in order, then the warp's xor-shuffle tree), then the
// chunks in order from +0; every other step is an IEEE round-to-nearest
// operation (expf, __frsqrt_rn, __fdiv_rn, no fast-math intrinsics); the
// amax is exact in any order. Against the plain version: x1 bit-equal, hq
// and x2 within one level where the row sums and exp round differently.
//
// Groups the tile does not take (g % 4 != 0: kernels/matmul.py
// two_level_route) take the same launches from ff_fused_o_mlp_any and
// ff_fused_o_gu_any, the row kernels writing int8 rows (xq, hq, x2) in
// place of staged operands, and each product on w4a8_mma.cuh's any-group
// route over them (launch_rows: its staging launch, then the tensor-core
// tile in byte-row order; planned by kernels/matmul.py tail_plan with
// rows_plan): the same integers, so the same numerics.

#include "w4a8_mma.cuh"  // the tile, stage_row (with common.cuh)

namespace {

// A row kernel's block: one a row, 32 warps, so the row's chunks and their
// loads run side by side (with 8 warps a row's block waited on its loads
// in turn). Spreading a row over a cluster of blocks, its reductions
// through distributed shared memory, cost more in cluster barriers than it
// saved, but for the SiLU step at M = 8.
constexpr int kRowWarps = 32;
constexpr int kRowThreads = 32 * kRowWarps;
constexpr int kChunk = 128;  // columns of one row-reduction item: a warp, 4 a lane

__device__ __forceinline__ float epi(int acc, float s_col, float x_scale) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), s_col), x_scale);
}

__device__ __forceinline__ int8_t quant8(float v, float s) {
  return static_cast<int8_t>(static_cast<int>(fminf(fmaxf(rintf(__fdiv_rn(v, s)), -128.f), 127.f)));
}

__device__ __forceinline__ float row_scale(float amax) {
  return fmaxf(__fmul_rn(amax, 1.0f / 127.0f), 1e-8f);
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

// Columns n0..n0+3 of row m of the (n_split, M, N) int32 partials, summed
// over the splits (16-byte loads: N % 4 == 0).
__device__ __forceinline__ int4 split_sum4(const int32_t* __restrict__ partial, int n_split, int M,
                                           int N, int m, int n0) {
  int4 acc = make_int4(0, 0, 0, 0);
#pragma unroll 4
  for (int s = 0; s < n_split; ++s) {
    const int4 v = *reinterpret_cast<const int4*>(partial + ((size_t)s * M + m) * N + n0);
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
  return acc;
}

// Element j of four packed values (an int4, a float4, or four bf16 in a uint2).
__device__ __forceinline__ int lane_of(const int4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}
__device__ __forceinline__ float lane_of(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}
__device__ __forceinline__ float bf16_of(const uint2& v, int j) {
  const unsigned w = j < 2 ? v.x : v.y;
  return __uint_as_float(j % 2 ? w & 0xFFFF0000u : w << 16);
}

// Four consecutive values at p (16- or 8-byte aligned).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ uint2 load4(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint2*>(p);
}

// The chunk values red[0..nck) (shared memory) added in chunk order from
// +0 by one thread, or (MAX, values >= 0: exact in any order) maxed by
// the first warp; every thread of the block returns the total.
template <bool MAX>
__device__ float chunk_total(const float* red, int nck, float* slot) {
  __syncthreads();
  if (MAX && threadIdx.x < 32) {
    float t = 0.f;
    for (int c = threadIdx.x; c < nck; c += 32) t = fmaxf(t, red[c]);
    t = warp_max(t);
    if (threadIdx.x == 0) *slot = t;
  } else if (!MAX && threadIdx.x == 0) {
    float t = 0.f;
    for (int c = 0; c < nck; ++c) t = __fadd_rn(t, red[c]);
    *slot = t;
  }
  __syncthreads();
  return *slot;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// One block a row of the staged rows (a block past M stages zeros): the
// row quantizer on x (M, K), scale into xs, the int8 row staged into xf
// for the tile's plan at n_split, or (xf NULL: the any-group route, which
// stages it itself) written to xq (M, K). Dynamic shared memory: K bytes.
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
tail_quant_kernel(const T* __restrict__ x, float* __restrict__ xs, int8_t* __restrict__ xf,
                  int8_t* __restrict__ xq, int M, int K, int group, int n_split) {
  extern __shared__ __align__(16) int8_t qs[];
  __shared__ float red[kRowWarps];
  const int m = blockIdx.x, mt = ff::mma8::tiles_of(M);
  if (m >= M) {
    if (xf) ff::mma8::stage_row<ff::kPaired>(nullptr, xf, m, K, group, n_split, mt);
    return;
  }
  const T* xr = x + (size_t)m * K;
  float mx = 0.f;
#pragma unroll 4
  for (int k = threadIdx.x; k < K; k += blockDim.x) mx = fmaxf(mx, fabsf(to_float(xr[k])));
  mx = warp_max(mx);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = mx;
  __syncthreads();
  mx = red[0];
  for (int w = 1; w < kRowWarps; ++w) mx = fmaxf(mx, red[w]);
  const float s = row_scale(mx);
  if (threadIdx.x == 0) xs[m] = s;
  if (!xf) {
    for (int k = threadIdx.x; k < K; k += blockDim.x)
      xq[(size_t)m * K + k] = quant8(to_float(xr[k]), s);
    return;
  }
#pragma unroll 4
  for (int k = threadIdx.x; k < K; k += blockDim.x) qs[k] = quant8(to_float(xr[k]), s);
  __syncthreads();
  ff::mma8::stage_row<ff::kPaired>(qs, xf, m, K, group, n_split, mt);
}

// One block a staged row: x1 from o_proj's partials (FMA: the o + gate/up
// head's fused multiply-add, else the tail's add of the rounded epilogue),
// the RMSNorm and the row quantizer; writes x1 (M, H), hq (M, H), s_h[m]
// and stages hq into xf for gate/up's plan at n_split_gu (xf NULL: no
// staging). Dynamic shared memory: 4 H + 4 ceil(H / 128) + H bytes.
template <bool FMA>
__global__ void __launch_bounds__(kRowThreads)
tail_norm_kernel(const int32_t* __restrict__ partial, int n_split_o, const float* __restrict__ o_s,
                 const float* __restrict__ xs, const __nv_bfloat16* __restrict__ x_res,
                 const __nv_bfloat16* __restrict__ norm_w, float* __restrict__ x1,
                 int8_t* __restrict__ hq, float* __restrict__ s_h, int8_t* __restrict__ xf, int M,
                 int H, int group, int n_split_gu, float eps) {
  extern __shared__ __align__(16) float sh[];
  __shared__ float slot;
  const int m = blockIdx.x, mt = ff::mma8::tiles_of(M);
  if (m >= M) {
    if (xf) ff::mma8::stage_row<ff::kPaired>(nullptr, xf, m, H, group, n_split_gu, mt);
    return;
  }
  const int nck = (H + kChunk - 1) / kChunk;
  float* xrow = sh;       // x1 of the row
  float* red = sh + H;    // one value a chunk
  int8_t* qs = reinterpret_cast<int8_t*>(red + nck);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float xm = xs[m];

  // x1 and the chunks' sums of squares
  for (int c = warp; c < nck; c += kRowWarps) {
    const int n0 = c * kChunk + lane * 4;
    float sq = 0.f;
    if (n0 < H) {
      const int4 acc = split_sum4(partial, n_split_o, M, H, m, n0);
      const float4 sc = load4(o_s + n0);
      const uint2 res = load4(x_res + (size_t)m * H + n0);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int a = lane_of(acc, j);
        const float r = bf16_of(res, j);
        const float v = FMA ? __fmaf_rn(__fmul_rn(__int2float_rn(a), lane_of(sc, j)), xm, r)
                            : __fadd_rn(r, epi(a, lane_of(sc, j), xm));
        xrow[n0 + j] = v;
        sq = __fadd_rn(sq, __fmul_rn(v, v));
      }
      *reinterpret_cast<float4*>(x1 + (size_t)m * H + n0) = *reinterpret_cast<float4*>(xrow + n0);
    }
    sq = warp_sum(sq);
    if (lane == 0) red[c] = sq;
  }
  const float inv =
      __frsqrt_rn(__fadd_rn(__fdiv_rn(chunk_total<false>(red, nck, &slot), (float)H), eps));

  // h's amax, then s_h and hq
  float mx = 0.f;
  for (int n = threadIdx.x; n < H; n += blockDim.x)
    mx = fmaxf(mx, fabsf(__fmul_rn(__fmul_rn(xrow[n], inv), __bfloat162float(norm_w[n]))));
  mx = warp_max(mx);
  if (lane == 0) red[warp] = mx;  // chunk_total's last barrier: red is free
  const float s = row_scale(chunk_total<true>(red, kRowWarps, &slot));
  if (threadIdx.x == 0) s_h[m] = s;
  for (int n = threadIdx.x; n < H; n += blockDim.x) {
    const int8_t q =
        quant8(__fmul_rn(__fmul_rn(xrow[n], inv), __bfloat162float(norm_w[n])), s);
    hq[(size_t)m * H + n] = q;
    qs[n] = q;
  }
  if (!xf) return;
  __syncthreads();
  ff::mma8::stage_row<ff::kPaired>(qs, xf, m, H, group, n_split_gu, mt);
}

// One block a staged row: gate and up (bf16 of their epilogues from the
// gate/up partials, (n_split_gu, M, 2I)), g = (gate * sigmoid(gate)) * up,
// the row quantizer; writes x2 (M, I), s_g[m] and stages x2 into xf for
// down's plan at n_split_dn (xf NULL: no staging). Dynamic shared memory: 4 I + 4 ceil(I / 128)
// + I bytes.
__global__ void __launch_bounds__(kRowThreads)
tail_act_kernel(const int32_t* __restrict__ partial, int n_split_gu, const float* __restrict__ gu_s,
                const float* __restrict__ s_h, int8_t* __restrict__ x2, float* __restrict__ s_g,
                int8_t* __restrict__ xf, int M, int I, int group, int n_split_dn) {
  extern __shared__ __align__(16) float sh[];
  __shared__ float slot;
  const int m = blockIdx.x, mt = ff::mma8::tiles_of(M);
  if (m >= M) {
    if (xf) ff::mma8::stage_row<ff::kPaired>(nullptr, xf, m, I, group, n_split_dn, mt);
    return;
  }
  const int nck = (I + kChunk - 1) / kChunk;
  float* grow = sh;
  float* red = sh + I;
  int8_t* qs = reinterpret_cast<int8_t*>(red + nck);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float xm = s_h[m];
  float mx = 0.f;
#pragma unroll 4
  for (int c = warp; c < nck; c += kRowWarps) {
    const int n0 = c * kChunk + lane * 4;
    if (n0 < I) {
      const int4 ag = split_sum4(partial, n_split_gu, M, 2 * I, m, n0);
      const int4 au = split_sum4(partial, n_split_gu, M, 2 * I, m, I + n0);
      const float4 sg = load4(gu_s + n0), su = load4(gu_s + I + n0);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float gate =
            __bfloat162float(__float2bfloat16_rn(epi(lane_of(ag, j), lane_of(sg, j), xm)));
        const float up =
            __bfloat162float(__float2bfloat16_rn(epi(lane_of(au, j), lane_of(su, j), xm)));
        const float sig = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-gate)));
        const float g = __fmul_rn(__fmul_rn(gate, sig), up);
        grow[n0 + j] = g;
        mx = fmaxf(mx, fabsf(g));
      }
    }
  }
  mx = warp_max(mx);
  if (lane == 0) red[warp] = mx;
  const float s = row_scale(chunk_total<true>(red, kRowWarps, &slot));
  if (threadIdx.x == 0) s_g[m] = s;
  for (int n = threadIdx.x; n < I; n += blockDim.x) {
    const int8_t q = quant8(grow[n], s);
    x2[(size_t)m * I + n] = q;
    qs[n] = q;
  }
  if (!xf) return;
  __syncthreads();
  ff::mma8::stage_row<ff::kPaired>(qs, xf, m, I, group, n_split_dn, mt);
}

// y = x1 + epilogue of down's partials (n_split, M, H); 4 columns a thread.
template <typename OutT>
__global__ void __launch_bounds__(256)
tail_out_kernel(const int32_t* __restrict__ partial, int n_split, const float* __restrict__ dn_s,
                const float* __restrict__ s_g, const float* __restrict__ x1,
                OutT* __restrict__ out, int M, int H) {
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= M * H) return;
  const int m = i / H, n0 = i % H;
  const int4 acc = split_sum4(partial, n_split, M, H, m, n0);
  const float4 sc = load4(dn_s + n0), xv = load4(x1 + i);
  const float xm = s_g[m];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    ff::store<OutT>(out + i + j,
                    __fadd_rn(lane_of(xv, j), epi(lane_of(acc, j), lane_of(sc, j), xm)));
}

// Dynamic shared memory of a row kernel over `width` columns (a row of
// f32, the chunk values, the int8 row), with the attribute set where it
// passes the 48 KB default; 0 where one block cannot hold it.
template <typename Kernel>
size_t row_smem(Kernel kernel, int width) {
  const size_t bytes = 4 * (size_t)width + 4 * (size_t)((width + kChunk - 1) / kChunk) + width;
  if (bytes > 232448) return 0;
  if (bytes > 48 * 1024 &&
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes) !=
          cudaSuccess)
    return 0;
  return bytes;
}

// The products' operands of one layer.
struct Product {
  const int8_t* w;
  const int32_t* m;
  const float* s;
  int K, N, n_split, depth;
};

Product layer_product(const void* w, const void* m, const void* s, int K, int N, int layer,
                      int n_pack, int n_split, int depth) {
  return {static_cast<const int8_t*>(w) + (size_t)layer * (K / 2) * N,
          static_cast<const int32_t*>(m) + (size_t)layer * n_pack * N,
          static_cast<const float*>(s) + (size_t)layer * N, K, N, n_split, depth};
}

// Whether the route takes product p at this group: whole group pairs
// along K, N % 4 == 0 (the row kernels' 16-byte loads of its partials),
// and on the tile (not `any`) group % 4 == 0.
bool takes(const Product& p, int group, bool any) {
  return group >= 1 && (any || (group >= 4 && group % 4 == 0)) && p.K % (2 * group) == 0 &&
         p.N % 4 == 0;
}

// Product p on the tile over the staged xf, or (any) on the any-group
// route over the int8 rows xq (M, p.K), which it stages into xf.
cudaError_t product(bool any, const Product& p, const float* xs, int8_t* xf, const int8_t* xq,
                    int32_t* partial, void* out, int out_kind, int M, int group,
                    cudaStream_t st) {
  if (any)
    return ff::mma8::launch_rows<ff::kPaired, true>(xq, xs, p.w, p.m, p.s, xf, partial, out,
                                                    out_kind, M, p.K, p.N, group, p.n_split, 0,
                                                    p.depth, st);
  return ff::mma8::launch_staged<ff::kPaired, true>(xs, p.w, p.m, p.s, xf, partial, out, out_kind,
                                                    M, p.K, p.N, group, p.n_split, 0, p.depth,
                                                    st);
}

// The head, through hq staged for gate/up: the quantizer of attn (bf16 or
// f32), o_proj's partials, x1, hq, s_h. `any`: attn's int8 rows into xq
// (M, K1), no staging by the row kernels.
cudaError_t head(bool any, bool fma, const void* attn, int attn_bf16, const void* x_res,
                 const __nv_bfloat16* norm_w, const Product& o, int gu_split, float* xs,
                 int8_t* xf_o, int8_t* xf_gu, int8_t* xq, int32_t* partial, float* x1,
                 int8_t* hq, float* s_h, int M, int group, float eps, cudaStream_t st) {
  if (M < 1 || !takes(o, group, any) || xf_o == nullptr || xf_gu == nullptr ||
      (any && xq == nullptr))
    return cudaErrorInvalidValue;
  const int rows = any ? M : ff::mma8::staged_rows(M);
  int8_t* stage_o = any ? nullptr : xf_o;
  if (attn_bf16)
    tail_quant_kernel<__nv_bfloat16><<<rows, kRowThreads, o.K, st>>>(
        static_cast<const __nv_bfloat16*>(attn), xs, stage_o, xq, M, o.K, group, o.n_split);
  else
    tail_quant_kernel<float><<<rows, kRowThreads, o.K, st>>>(
        static_cast<const float*>(attn), xs, stage_o, xq, M, o.K, group, o.n_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if ((err = product(any, o, xs, xf_o, xq, partial, nullptr, ff::mma8::kOutPartials, M, group,
                     st)) != cudaSuccess)
    return err;
  const int H = o.N;
  auto norm = fma ? tail_norm_kernel<true> : tail_norm_kernel<false>;
  const size_t smem = row_smem(norm, H);
  if (smem == 0) return cudaErrorInvalidValue;
  norm<<<rows, kRowThreads, smem, st>>>(partial, o.n_split, o.s, xs,
                                        static_cast<const __nv_bfloat16*>(x_res), norm_w, x1, hq,
                                        s_h, any ? nullptr : xf_gu, M, H, group, gu_split, eps);
  return cudaGetLastError();
}

// The tail's launches (the tile, or `any` the any-group route over xq, hq
// and x2); ff_fused_o_mlp's arguments.
cudaError_t o_mlp(bool any, const void* attn, const void* x_res, const void* norm_w,
                  const Product& o, const Product& gu, const Product& dn, void* xs, void* scales,
                  void* x1, void* xq, void* hq, void* x2, void* xf_o, void* xf_gu, void* xf_dn,
                  void* partial, void* out, int M, int H, int I, int layer, int group, float eps,
                  int attn_bf16, int out_bf16, cudaStream_t st) {
  if (I % 4 != 0 || !takes(gu, group, any) || !takes(dn, group, any) || xf_dn == nullptr)
    return cudaErrorInvalidValue;
  float* s_h = static_cast<float*>(scales);
  float* s_g = s_h + M;
  int32_t* part = static_cast<int32_t*>(partial);
  cudaError_t err = head(any, false, attn, attn_bf16, x_res,
                         static_cast<const __nv_bfloat16*>(norm_w) + (size_t)layer * H, o,
                         gu.n_split, static_cast<float*>(xs), static_cast<int8_t*>(xf_o),
                         static_cast<int8_t*>(xf_gu), static_cast<int8_t*>(xq), part,
                         static_cast<float*>(x1), static_cast<int8_t*>(hq), s_h, M, group, eps,
                         st);
  if (err != cudaSuccess) return err;
  if ((err = product(any, gu, s_h, static_cast<int8_t*>(xf_gu), static_cast<int8_t*>(hq), part,
                     nullptr, ff::mma8::kOutPartials, M, group, st)) != cudaSuccess)
    return err;
  const size_t smem = row_smem(tail_act_kernel, I);
  if (smem == 0) return cudaErrorInvalidValue;
  tail_act_kernel<<<any ? M : ff::mma8::staged_rows(M), kRowThreads, smem, st>>>(
      part, gu.n_split, gu.s, s_h, static_cast<int8_t*>(x2), s_g,
      any ? nullptr : static_cast<int8_t*>(xf_dn), M, I, group, dn.n_split);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = product(any, dn, s_g, static_cast<int8_t*>(xf_dn), static_cast<int8_t*>(x2), part,
                     nullptr, ff::mma8::kOutPartials, M, group, st)) != cudaSuccess)
    return err;
  const int blocks = (M * H / 4 + 255) / 256;
  if (out_bf16)
    tail_out_kernel<__nv_bfloat16><<<blocks, 256, 0, st>>>(
        part, dn.n_split, dn.s, s_g, static_cast<const float*>(x1),
        static_cast<__nv_bfloat16*>(out), M, H);
  else
    tail_out_kernel<float><<<blocks, 256, 0, st>>>(part, dn.n_split, dn.s, s_g,
                                                   static_cast<const float*>(x1),
                                                   static_cast<float*>(out), M, H);
  return cudaGetLastError();
}

// The o + gate/up head's launches (the tile, or `any` the any-group route
// over xq and hq).
cudaError_t o_gu(bool any, const void* attn, const void* x_res, const void* norm_w,
                 const Product& o, const Product& g, void* xs, void* scales, void* xq, void* hq,
                 void* xf_o, void* xf_gu, void* partial, void* x1, void* gu, int M, int H,
                 int layer, int group, float eps, int attn_bf16, cudaStream_t st) {
  if (!takes(g, group, any)) return cudaErrorInvalidValue;
  float* s_h = static_cast<float*>(scales);
  int32_t* part = static_cast<int32_t*>(partial);
  cudaError_t err = head(any, true, attn, attn_bf16, x_res,
                         static_cast<const __nv_bfloat16*>(norm_w) + (size_t)layer * H, o,
                         g.n_split, static_cast<float*>(xs), static_cast<int8_t*>(xf_o),
                         static_cast<int8_t*>(xf_gu), static_cast<int8_t*>(xq), part,
                         static_cast<float*>(x1), static_cast<int8_t*>(hq), s_h, M, group, eps,
                         st);
  if (err != cudaSuccess) return err;
  return product(any, g, s_h, static_cast<int8_t*>(xf_gu), static_cast<int8_t*>(hq), part, gu,
                 ff::mma8::kOutBf16, M, group, st);
}

}  // namespace

// Layer `layer` of the stacked weights: o (L, K1/2, H), gu (L, H/2, 2I),
// dn (L, I/2, H) int8; multipliers (L, n_pack_*, N) int32; s_col (L, N)
// f32; norm_w (L, H) bf16; attn (M, K1) bf16 (attn_bf16) or f32, x_res
// (M, H) bf16. Scratch (the wrapper sizes it from the three mma_plans):
// xs (M,), scales (2, M) (s_h, s_g), x1 (M, H) f32, hq (M, H), x2 (M, I)
// int8, the staged operands xf_o, xf_gu, xf_dn (each plan's x_bytes), and
// partial (the largest split * M * N of the three, int32). out (M, H) f32
// or bf16 (out_bf16). split_* and depth_* each product's plan and ring.
// Returns cudaErrorInvalidValue for a shape the kernels do not take, else
// the first launch error.
extern "C" int ff_fused_o_mlp(const void* attn, const void* x_res, const void* norm_w,
                              const void* o_w, const void* o_m, const void* o_s,
                              const void* gu_w, const void* gu_m, const void* gu_s,
                              const void* dn_w, const void* dn_m, const void* dn_s, void* xs,
                              void* scales, void* x1, void* hq, void* x2, void* xf_o,
                              void* xf_gu, void* xf_dn, void* partial, void* out, int M, int K1,
                              int H, int I, int layer, int group, int n_pack_o, int n_pack_gu,
                              int n_pack_dn, int split_o, int split_gu, int split_dn,
                              int depth_o, int depth_gu, int depth_dn, float eps, int attn_bf16,
                              int out_bf16, void* stream) {
  return o_mlp(false, attn, x_res, norm_w,
               layer_product(o_w, o_m, o_s, K1, H, layer, n_pack_o, split_o, depth_o),
               layer_product(gu_w, gu_m, gu_s, H, 2 * I, layer, n_pack_gu, split_gu, depth_gu),
               layer_product(dn_w, dn_m, dn_s, I, H, layer, n_pack_dn, split_dn, depth_dn), xs,
               scales, x1, nullptr, hq, x2, xf_o, xf_gu, xf_dn, partial, out, M, H, I, layer,
               group, eps, attn_bf16, out_bf16, static_cast<cudaStream_t>(stream));
}

// The o + gate/up head: o (L, K1/2, H), gu (L, H/2, N_GU); scratch xs,
// scales (2, M) (s_h first), hq, xf_o, xf_gu, partial (split_o * M * H,
// and split_gu * M * N_GU where gate/up splits); outputs x1 (M, H) f32 and
// gu (M, N_GU) bf16. Errors as ff_fused_o_mlp.
extern "C" int ff_fused_o_gu(const void* attn, const void* x_res, const void* norm_w,
                             const void* o_w, const void* o_m, const void* o_s, const void* gu_w,
                             const void* gu_m, const void* gu_s, void* xs, void* scales,
                             void* hq, void* xf_o, void* xf_gu, void* partial, void* x1,
                             void* gu, int M, int K1, int H, int N_GU, int layer, int group,
                             int n_pack_o, int n_pack_gu, int split_o, int split_gu,
                             int depth_o, int depth_gu, float eps, int attn_bf16,
                             void* stream) {
  return o_gu(false, attn, x_res, norm_w,
              layer_product(o_w, o_m, o_s, K1, H, layer, n_pack_o, split_o, depth_o),
              layer_product(gu_w, gu_m, gu_s, H, N_GU, layer, n_pack_gu, split_gu, depth_gu), xs,
              scales, nullptr, hq, xf_o, xf_gu, partial, x1, gu, M, H, layer, group, eps,
              attn_bf16, static_cast<cudaStream_t>(stream));
}

// The same launches at the groups the tile does not take (g % 4 != 0;
// whole group pairs, N % 4 == 0), each product on the any-group route:
// ff_fused_o_mlp's arguments with xq (M, K1) int8 scratch after x1, each
// product's xf, split and depth planned by rows_plan (kernels/matmul.py
// tail_plan).
extern "C" int ff_fused_o_mlp_any(const void* attn, const void* x_res, const void* norm_w,
                                  const void* o_w, const void* o_m, const void* o_s,
                                  const void* gu_w, const void* gu_m, const void* gu_s,
                                  const void* dn_w, const void* dn_m, const void* dn_s, void* xs,
                                  void* scales, void* x1, void* xq, void* hq, void* x2,
                                  void* xf_o, void* xf_gu, void* xf_dn, void* partial, void* out,
                                  int M, int K1, int H, int I, int layer, int group,
                                  int n_pack_o, int n_pack_gu, int n_pack_dn, int split_o,
                                  int split_gu, int split_dn, int depth_o, int depth_gu,
                                  int depth_dn, float eps, int attn_bf16, int out_bf16,
                                  void* stream) {
  return o_mlp(true, attn, x_res, norm_w,
               layer_product(o_w, o_m, o_s, K1, H, layer, n_pack_o, split_o, depth_o),
               layer_product(gu_w, gu_m, gu_s, H, 2 * I, layer, n_pack_gu, split_gu, depth_gu),
               layer_product(dn_w, dn_m, dn_s, I, H, layer, n_pack_dn, split_dn, depth_dn), xs,
               scales, x1, xq, hq, x2, xf_o, xf_gu, xf_dn, partial, out, M, H, I, layer, group,
               eps, attn_bf16, out_bf16, static_cast<cudaStream_t>(stream));
}

// ff_fused_o_gu's launches on the any-group route: its arguments with xq
// (M, K1) int8 scratch after scales.
extern "C" int ff_fused_o_gu_any(const void* attn, const void* x_res, const void* norm_w,
                                 const void* o_w, const void* o_m, const void* o_s,
                                 const void* gu_w, const void* gu_m, const void* gu_s, void* xs,
                                 void* scales, void* xq, void* hq, void* xf_o, void* xf_gu,
                                 void* partial, void* x1, void* gu, int M, int K1, int H,
                                 int N_GU, int layer, int group, int n_pack_o, int n_pack_gu,
                                 int split_o, int split_gu, int depth_o, int depth_gu, float eps,
                                 int attn_bf16, void* stream) {
  return o_gu(true, attn, x_res, norm_w,
              layer_product(o_w, o_m, o_s, K1, H, layer, n_pack_o, split_o, depth_o),
              layer_product(gu_w, gu_m, gu_s, H, N_GU, layer, n_pack_gu, split_gu, depth_gu), xs,
              scales, xq, hq, xf_o, xf_gu, partial, x1, gu, M, H, layer, group, eps, attn_bf16,
              static_cast<cudaStream_t>(stream));
}
