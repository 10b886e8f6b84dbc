// An integer dot-throughput probe: the same rounds of (rows x K) @ (K x N)
// integer products through each instruction the two-level GEMVs could be
// built on, to measure their rates on this card.
//
// Replaces: scripts/tpu_probe_int4.py make_probe (:67, kernel _kernel :44),
// which asked whether the TPU's MXU runs int4 dots faster than int8.
//   for r in 0 .. rounds - 1:
//     acc = sum_p x @ w[p]               (int32; p < panels)
//     x   = (acc + r) & 0xF              (int4 form: sign-extended to 4 bits)
//   out = x                              (int8)
// x (R, K) int8 in [0, 15] (the int4 form sign-extends it first), w[p]
// (K, N) int8 with N == K (the int4 form sign-extends it too). Row i of a
// round reads only row i of the round before, so the rows are independent
// chains: R = copies x BM rows fill the card.
//
// Routes (INST), each computing the same integers:
//   kDp4a     dp4a on the CUDA cores, as the two-level GEMVs ran before
//             the int8 tensor-core tile: a lane owns 4 adjacent columns
//             of 16 rows, loads 4 byte rows of (K, N) weights and
//             transposes them;
//   kMmaS8    int8 mma.sync.m16n8k32;
//   kMmaS4    int4 mma.sync.m16n8k64 .s4 (int4 form only): x and w as
//             packed nibbles;
//   kMmaBf16  bf16 mma.sync.m16n8k16 with f32 sums, exact here: every
//             operand is an integer of at most 128 in magnitude and the
//             wrapper keeps panels * K * 15 * 128 below 2^24.
// The mma routes take the weights transposed (N, K) (kMmaS4: (N, K/2)
// nibbles, k even low), so a lane's B register is one 32-bit load.
//
// Design: a block owns four 16-row tiles (64 rows) of x in shared memory,
// two buffers (this round's and the next), and 8 warps; a warp computes 64
// rows x 32 columns (16 mma tiles, each B fragment it loads feeding four
// products), 256 columns a pass, and writes its part of the next round's x
// into the other buffer; the block synchronizes once a round. The weights
// (panels x K x N bytes, 1.5 MB at the defaults) stay in L2 and are read
// through L1 by every block each round. Bound: operations (int8 routes at
// the int8 tensor-core rate, bf16 at the bf16 rate; the H100 lists no int4
// rate).

#include <type_traits>

#include "common.cuh"

namespace {

enum Inst { kDp4a = 0, kMmaS8 = 1, kMmaS4 = 2, kMmaBf16 = 3 };

constexpr int kRows = 64;                     // rows of a block: four 16-row tiles
constexpr int kWarps = 8, kThreads = kWarps * 32;
constexpr int kWarpCols = 32;                 // columns of a warp's tile
constexpr int kPassCols = kWarps * kWarpCols;

// Bytes of one row of x in shared memory, and its pitch (16 bytes more:
// conflict-free fragment loads).
template <int INST>
__host__ __device__ constexpr int row_bytes(int K) {
  return INST == kMmaS4 ? K / 2 : INST == kMmaBf16 ? 2 * K : K;
}
template <int INST>
__host__ __device__ constexpr int pitch_of(int K) {
  return row_bytes<INST>(K) + 16;
}

__device__ __forceinline__ int sext4(int v) { return ((v & 0xF) ^ 8) - 8; }

// The round's update of one element: (acc + r) & 0xF, sign-extended in the
// int4 form.
__device__ __forceinline__ int next_x(int acc, int r, int int4) {
  const int v = (acc + r) & 0xF;
  return int4 ? sext4(v) : v;
}

// Store x[row][c], x[row][c + 1] (c even) in the route's format.
template <int INST>
__device__ __forceinline__ void put2(unsigned char* buf, int pitch, int row, int c, int v0,
                                     int v1) {
  unsigned char* p = buf + (size_t)row * pitch;
  if constexpr (INST == kMmaS4) {
    p[c / 2] = static_cast<unsigned char>((v0 & 0xF) | ((v1 & 0xF) << 4));
  } else if constexpr (INST == kMmaBf16) {
    *reinterpret_cast<unsigned*>(p + 2 * c) =
        ff::pack_bf16x2(static_cast<float>(v0), static_cast<float>(v1));
  } else {
    *reinterpret_cast<unsigned short*>(p + c) =
        static_cast<unsigned short>((v0 & 0xFF) | ((v1 & 0xFF) << 8));
  }
}

template <int INST>
__device__ __forceinline__ int get1(const unsigned char* buf, int pitch, int row, int c) {
  const unsigned char* p = buf + (size_t)row * pitch;
  if constexpr (INST == kMmaS4) {
    return sext4(p[c / 2] >> (4 * (c % 2)));
  } else if constexpr (INST == kMmaBf16) {
    return __float2int_rn(__bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[c]));
  } else {
    return static_cast<int8_t>(p[c]);
  }
}

__device__ __forceinline__ void mma_s4(int c[4], const unsigned a[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k64.row.col.s32.s4.s4.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One warp's 64 rows x 32 columns (nb..) of a round on the tensor cores.
template <int INST>
__device__ __forceinline__ void mma_pass(const unsigned char* xs, unsigned char* xn, int pitch,
                                         const void* __restrict__ w, int K, int N, int panels,
                                         int rd, int int4, int nb, int lane) {
  using Acc = typename std::conditional<INST == kMmaBf16, float, int>::type;
  constexpr int kStep = INST == kMmaS4 ? 64 : INST == kMmaBf16 ? 16 : 32;  // k a product
  const int gid = lane / 4, tid = lane % 4;
  Acc acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;
  // bytes of one weight row (N, K) and of a panel
  const size_t wrow = INST == kMmaS4 ? K / 2 : INST == kMmaBf16 ? 2 * (size_t)K : K;
  for (int p = 0; p < panels; ++p) {
    const unsigned char* wp = static_cast<const unsigned char*>(w) + (size_t)p * N * wrow;
    for (int k0 = 0; k0 < K; k0 += kStep) {
      // B registers of the 4 n8 tiles: column nb + 8j + gid; register 0 at
      // byte kb of the column's row, register 1 16 bytes further (k + 16
      // int8, k + 8 bf16, k + 32 int4)
      const int kb = INST == kMmaS4 ? k0 / 2 + 4 * tid
                     : INST == kMmaBf16 ? 2 * (k0 + 2 * tid) : k0 + 4 * tid;
      unsigned b[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned char* col = wp + (size_t)(nb + 8 * j + gid) * wrow + kb;
        b[j][0] = __ldg(reinterpret_cast<const unsigned*>(col));
        b[j][1] = __ldg(reinterpret_cast<const unsigned*>(col + 16));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        unsigned a[4];
        if constexpr (INST == kMmaBf16) {
          ff::load_a_bf16(a, reinterpret_cast<const __nv_bfloat16*>(xs + i * 16 * pitch) + k0,
                          pitch / 2, lane);
        } else {
          ff::load_a_s8(a, reinterpret_cast<const int8_t*>(xs + i * 16 * pitch) +
                               (INST == kMmaS4 ? k0 / 2 : k0), pitch, lane);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if constexpr (INST == kMmaBf16) ff::mma_bf16(acc[i][j], a, b[j][0], b[j][1]);
          else if constexpr (INST == kMmaS4) mma_s4(acc[i][j], a, b[j][0], b[j][1]);
          else ff::mma_s8(acc[i][j], a, b[j][0], b[j][1]);
        }
      }
    }
  }
  // C register r of tile (i, j): row 16i + gid + 8(r / 2), column nb + 8j +
  // 2tid + r % 2
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const Acc a = acc[i][j][2 * h + e];
          int ai;
          if constexpr (INST == kMmaBf16) ai = __float2int_rn(a);
          else ai = a;
          v[e] = next_x(ai, rd, int4);
        }
        put2<INST>(xn, pitch, 16 * i + gid + 8 * h, nb + 8 * j + 2 * tid, v[0], v[1]);
      }
}

// One warp's 64 rows x 32 columns (nb..) of a round with dp4a: lane = 4-column
// quad cq (lane % 8) and row group rg (lane / 8), rows rg + 4m (m < 16).
__device__ __forceinline__ void dp4a_pass(const unsigned char* xs, unsigned char* xn, int pitch,
                                          const int8_t* __restrict__ w, int K, int N, int panels,
                                          int rd, int int4, int nb, int lane) {
  const int cq = lane % 8, rg = lane / 8;
  const int n = nb + 4 * cq;
  int acc[16][4];
#pragma unroll
  for (int m = 0; m < 16; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0;
  for (int p = 0; p < panels; ++p) {
    const int8_t* wp = w + (size_t)p * K * N + n;
#pragma unroll 2
    for (int k = 0; k < K; k += 4) {
      unsigned r[4], col[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        r[i] = __ldg(reinterpret_cast<const unsigned*>(wp + (size_t)(k + i) * N));
      ff::transpose4x4(r, col);
#pragma unroll
      for (int m = 0; m < 16; ++m) {
        const int a = *reinterpret_cast<const int*>(xs + (size_t)(rg + 4 * m) * pitch + k);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[m][c] = ff::dp4a_ss(a, static_cast<int>(col[c]), acc[m][c]);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < 16; ++m) {
    const int row = rg + 4 * m;
    put2<kDp4a>(xn, pitch, row, n, next_x(acc[m][0], rd, int4), next_x(acc[m][1], rd, int4));
    put2<kDp4a>(xn, pitch, row, n + 2, next_x(acc[m][2], rd, int4), next_x(acc[m][3], rd, int4));
  }
}

// Grid: ceil(R / 64) blocks; dynamic shared memory 2 * 64 * pitch.
template <int INST>
__global__ void __launch_bounds__(kThreads)
probe_kernel(const int8_t* __restrict__ x, const void* __restrict__ w, int8_t* __restrict__ out,
             int R, int K, int N, int panels, int rounds, int int4) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int pitch = pitch_of<INST>(K);
  unsigned char* buf[2] = {smem, smem + kRows * pitch};
  const int r0 = blockIdx.x * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // rows past R compute on zeros and are never written out
  for (int i = threadIdx.x; i < kRows * K / 2; i += kThreads) {
    const int row = i / (K / 2), c = 2 * (i % (K / 2));
    int v0 = 0, v1 = 0;
    if (r0 + row < R) {
      v0 = x[(size_t)(r0 + row) * K + c];
      v1 = x[(size_t)(r0 + row) * K + c + 1];
    }
    put2<INST>(buf[0], pitch, row, c, int4 ? sext4(v0) : v0, int4 ? sext4(v1) : v1);
  }
  __syncthreads();
  int cur = 0;
  for (int rd = 0; rd < rounds; ++rd) {
    for (int nb = warp * kWarpCols; nb < N; nb += kPassCols) {
      if constexpr (INST == kDp4a)
        dp4a_pass(buf[cur], buf[cur ^ 1], pitch, static_cast<const int8_t*>(w), K, N, panels, rd,
                  int4, nb, lane);
      else
        mma_pass<INST>(buf[cur], buf[cur ^ 1], pitch, w, K, N, panels, rd, int4, nb, lane);
    }
    __syncthreads();
    cur ^= 1;
  }
  for (int i = threadIdx.x; i < kRows * K; i += kThreads) {
    const int row = i / K, c = i % K;
    if (r0 + row < R)
      out[(size_t)(r0 + row) * K + c] = static_cast<int8_t>(get1<INST>(buf[cur], pitch, row, c));
  }
}

template <int INST>
int launch(const void* x, const void* w, void* out, int R, int K, int N, int panels, int rounds,
           int int4, cudaStream_t st) {
  const int bytes = 2 * kRows * pitch_of<INST>(K);
  cudaError_t err = cudaFuncSetAttribute(probe_kernel<INST>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  probe_kernel<INST><<<(R + kRows - 1) / kRows, kThreads, bytes, st>>>(
      static_cast<const int8_t*>(x), w, static_cast<int8_t*>(out), R, K, N, panels, rounds, int4);
  return cudaGetLastError();
}

}  // namespace

// x (R, K) int8, w the route's weights (kDp4a: (panels, K, N) int8; kMmaS8:
// (panels, N, K) int8; kMmaS4: (panels, N, K/2) nibbles; kMmaBf16: (panels,
// N, K) bf16), out (R, K) int8; N == K, K % 64 == 0, N % 32 == 0; int4: the
// int4 form (required by kMmaS4).
extern "C" int ff_probe_int4(const void* x, const void* w, void* out, int R, int K, int N,
                             int panels, int rounds, int int4, int inst, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N != K || K % 64 != 0 || R < 1 || panels < 1 || rounds < 0) return cudaErrorInvalidValue;
  switch (inst) {
    case kDp4a: return launch<kDp4a>(x, w, out, R, K, N, panels, rounds, int4, st);
    case kMmaS8: return launch<kMmaS8>(x, w, out, R, K, N, panels, rounds, int4, st);
    case kMmaS4:
      if (!int4) return cudaErrorInvalidValue;
      return launch<kMmaS4>(x, w, out, R, K, N, panels, rounds, int4, st);
    case kMmaBf16: return launch<kMmaBf16>(x, w, out, R, K, N, panels, rounds, int4, st);
    default: return cudaErrorInvalidValue;
  }
}
