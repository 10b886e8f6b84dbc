// Shared device code of the port's tensor-core products (w4a8_mma.cuh's
// two-level tile, flash decode and prefill, the int4/int8 probe, and the
// copies and packing of the wgmma kernels): asynchronous global -> shared
// copies, the mma.sync tile products and their operand fragments.
//
// Fragments (PTX ISA, mma.m16n8k32 .s8 and mma.m16n8k16 .bf16). In a warp,
// lane = 4 * gid + tid. A (16 x k, row-major) and C (16 x 8) cover rows gid
// and gid + 8; B (k x 8, column-major) column gid. A 32-bit register holds
// 4 consecutive k of int8 or 2 of bf16, the lowest k in the lowest bits.
//
// Column permutation. A warp covers 32 output columns as 4 n8 tiles, and
// mma column c of tile j stands for column 4c + j of the warp's 32. So the
// B columns of a lane (c = gid, j = 0..3) are the 4 adjacent columns
// 4gid..4gid+3 — one 32-bit word of a weight row whose N is contiguous —
// and its C columns (c = 2tid, 2tid + 1) are the 8 adjacent columns
// 8tid..8tid+7: C register r of tile j holds column 8tid + 4(r % 2) + j of
// row gid + 8(r / 2).

#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ff {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copy BYTES (4 or 16) from global to shared memory without waiting; when
// !valid nothing is read and the destination is zero-filled.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  const int n = valid ? BYTES : 0;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "n"(BYTES), "r"(n));
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// c += a . b on one 16 x 8 tile, int8 operands, k = 32, exact int32 sums.
__device__ __forceinline__ void mma_s8(int c[4], const unsigned a[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b on one 16 x 8 tile, bf16 operands, k = 16, f32 sums.
__device__ __forceinline__ void mma_bf16(float c[4], const unsigned a[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 4x4 byte transpose: r[i] holds row i of 4 columns; c[j] gets column j
// of the 4 rows (byte i = row i).
__device__ __forceinline__ void transpose4x4(const unsigned r[4], unsigned c[4]) {
  unsigned t0 = __byte_perm(r[0], r[1], 0x5140);
  unsigned t1 = __byte_perm(r[0], r[1], 0x7362);
  unsigned t2 = __byte_perm(r[2], r[3], 0x5140);
  unsigned t3 = __byte_perm(r[2], r[3], 0x7362);
  c[0] = __byte_perm(t0, t2, 0x5410);
  c[1] = __byte_perm(t0, t2, 0x7632);
  c[2] = __byte_perm(t1, t3, 0x5410);
  c[3] = __byte_perm(t1, t3, 0x7632);
}

// The int8 A fragment of rows gid, gid + 8 and k = 4tid.., 16 + 4tid.. of
// a row-major tile (pitch in bytes) whose first row and k are at `tile`.
__device__ __forceinline__ void load_a_s8(unsigned a[4], const int8_t* tile, int pitch,
                                          int lane) {
  const int8_t* p = tile + (lane / 4) * pitch + 4 * (lane % 4);
  a[0] = *reinterpret_cast<const unsigned*>(p);
  a[1] = *reinterpret_cast<const unsigned*>(p + 8 * pitch);
  a[2] = *reinterpret_cast<const unsigned*>(p + 16);
  a[3] = *reinterpret_cast<const unsigned*>(p + 8 * pitch + 16);
}

// The bf16 A fragment of rows gid, gid + 8 and k = 2tid.., 8 + 2tid.. of a
// row-major tile (pitch in elements).
__device__ __forceinline__ void load_a_bf16(unsigned a[4], const __nv_bfloat16* tile, int pitch,
                                            int lane) {
  const __nv_bfloat16* p = tile + (lane / 4) * pitch + 2 * (lane % 4);
  a[0] = *reinterpret_cast<const unsigned*>(p);
  a[1] = *reinterpret_cast<const unsigned*>(p + 8 * pitch);
  a[2] = *reinterpret_cast<const unsigned*>(p + 8);
  a[3] = *reinterpret_cast<const unsigned*>(p + 8 * pitch + 8);
}

__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

// Store 8 adjacent outputs of row `row` (columns n..n+7; only n + c < N):
// one 16-byte store where the whole run is in range and aligned.
__device__ __forceinline__ void store8(float* row, int n, int N, const float v[8]) {
  if (n + 8 <= N) {  // N % 4 == 0: 16-byte aligned
    reinterpret_cast<float4*>(row + n)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(row + n)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int c = 0; c < 8; ++c)
      if (n + c < N) row[n + c] = v[c];
  }
}

__device__ __forceinline__ void store8(__nv_bfloat16* row, int n, int N, const float v[8]) {
  if (n + 8 <= N && N % 8 == 0) {
    *reinterpret_cast<uint4*>(row + n) = make_uint4(
        pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]), pack_bf16x2(v[4], v[5]),
        pack_bf16x2(v[6], v[7]));
  } else {
#pragma unroll
    for (int c = 0; c < 8; ++c)
      if (n + c < N) row[n + c] = __float2bfloat16_rn(v[c]);
  }
}

}  // namespace ff
