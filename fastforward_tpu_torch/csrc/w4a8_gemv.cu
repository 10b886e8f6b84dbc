// W4A8 two-level GEMV, paired and group-halves layouts, with an optional
// argmax epilogue (paired), and its layer-stacked form.
//
// Replaces: fastforward_tpu/kernels/matmul.py matmul_w4a8_2l_gemv (:571,
// paired body :537, group-halves body :479), matmul_w4a8_2l_gemv_argmax
// (:708, body :650) and matmul_w4a8_2l_gemv_stacked (:1023): its default
// body (:815) on flat and on pre-blocked weights, its manual-DMA kernel
// (:879), its split-W kernel (:989), its dot-raw body (:949) and its
// concat-pairs body (:780), one entry each.
//   y = (sum_k x[m,k] * w8[k,n]) * s_col[n] * x_scale[m],
//   w8 = (u * m_g) - 8 * m_g per nibble plane
// x int8 (M, K); w (K/2, N) offset-binary nibbles in the adjacent-group
// pairing (byte row i of pair p: row 2p*g + i low, row (2p+1)*g + i high);
// m (K/g, N) int8 in [1, 15]; ff_w4a8_gemv_unpaired takes the
// group-halves pairing instead (pack_uint4_offset: byte row i of group p,
// row pg + i low, row pg + g/2 + i high), both planes scaled by m_p, the
// JAX package's unpaired layout (random_serving_params, repack_unpaired).
// f32 or bf16 logits, or with the argmax
// epilogue one int32 token id per row (first occurrence wins ties, a NaN
// counts as the maximum: the ids of torch.argmax over the logits).
// Bit-exact against matmul_w4a8_2l_reference.
// Every entry of the two-level layouts runs w4a8_mma.cuh's int8
// tensor-core tile, with its note: ff_w4a8_gemv and ff_w4a8_gemv_unpaired
// (row 5), the argmax head ff_w4a8_gemv_argmax (row 4) and the six routes
// of the stacked GEMV (row 9).
//
// The stacked entries read layer `layer` of (L, K/2, N) weights, or of
// their pre-blocked form (L, N/bn, K/2, bn) (preblock_stacked, matmul.py:
// 1240: each bn-column panel one contiguous chunk), its nibble-packed
// multipliers (L, ceil(K/g/8), N) int32 and s_col (L, N) in place: no
// per-layer slice is copied. Six routes, one entry and one launch count
// each, all the same tile and so bit-equal (the int32 sum is exact in any
// order; the same epilogue arithmetic):
//   ff_w4a8_gemv_stacked     flat weights, the tile's TMA box over the
//                            (K/2, N) bytes;
//   ff_w4a8_gemv_preblocked  pre-blocked: boxes over the panels where bn %
//                            128 == 0, else the tile's 4-byte feed (any bn
//                            % 4 == 0: a lane's 4 columns lie in one panel);
//   ff_w4a8_gemv_manual      pre-blocked, FF_2L_MANUAL = nbuf: the TPU
//                            kernel keeps nbuf - 1 panels in flight in a
//                            ring of nbuf VMEM slots; here the tile's ring
//                            of depth = min(nbuf, the block's stages, what
//                            fits in 227 KB) stages (the other routes take
//                            4);
//   ff_w4a8_gemv_splitw      flat, FF_2L_SPLITW: the TPU kernel reads each
//                            panel as two half-K operands, two DMA streams;
//                            the tile's producer warp already keeps depth -
//                            1 stages in flight, so it runs as it is;
//   ff_w4a8_gemv_dotraw      either layout, FF_2L_DOTRAW: the TPU body dots
//                            the sign-restored nibbles and applies the
//                            group multiplier to each group's int32 dot, to
//                            spare the VPU a multiply a weight. The tile
//                            folds the multiplier into the bytes it feeds
//                            the tensor cores (3 instructions a plane, the
//                            same sum exactly); a per-group partial would
//                            need a second accumulator set beyond the
//                            tile's 128 registers (the dp4a dot-raw body
//                            took 151 and ran slowest of the routes,
//                            PERF.md row 9d), so it runs the shared tile;
//   ff_w4a8_gemv_concat      either layout, FF_2L_CONCAT_PAIRS = cp: the
//                            TPU body folds cp pairs and issues one longer
//                            dot; the tile's ring already streams a split's
//                            units as one run of 64-row stages across pair
//                            boundaries, so it runs the shared tile, and
//                            every pair is computed (the TPU body drops the
//                            trailing pairs when cp does not divide their
//                            count, ROADMAP.md Queue 3).
// Bound: the decoder layer's below for every route (the same bytes and
// operations).
//
// Bound on the H100: the lm_head of Llama-3-8B moves 263 MB of packed
// weights per call against M <= 256 rows: bandwidth-bound (~78 us). A
// decoder layer at M = 192, g128 moves ~110 MB (0.033 ms) but asks
// 2*M*K*N = 8.4e10 int8 operations (0.042 ms at 1,979 TOP/s on the tensor
// cores).
//
// The argmax head: the TPU kernel carried a running (max, index) across
// its sequential grid; here blocks run in no order, so the tile's epilogue
// writes one (max, first index) pair per row and 128-column block and a
// second pass, one warp a row, reduces the pairs. The logits never reach
// device memory.
//
// Groups the tile does not take (paired g % 4 != 0, group halves g % 8 !=
// 0, N % 4 != 0) run w4a8_mma.cuh's any-group route on the same tensor
// cores, one entry a layout and one for the stacked GEMV's every route (the
// *_any entries below, the tile entries' arguments), chosen by
// kernels/matmul.py two_level_route; row 4 then takes row 5's f32 logits
// and their argmax.
//
// The float-scale W4A8 GEMV (ff_w4a8_gemv_halves, row 16) is w4a8_halves.cu.

#include "common.cuh"
#include "w4a8_mma.cuh"

// Row 5 on the int8 tensor-core tile (w4a8_mma.cuh): xf the staged
// activations (mma_plan's x_bytes), partial (n_split, M, N) int32 or NULL
// for one split, depth the ring's stages.
extern "C" int ff_w4a8_gemv(const void* x, const void* xs, const void* w, const void* mult,
                            const void* s_col, void* xf, void* partial, void* out, int M, int K,
                            int N, int group, int n_split, int depth, int out_kind,
                            void* stream) {
  return ff::mma8::launch<ff::kPaired, false>(
      static_cast<const int8_t*>(x), static_cast<const float*>(xs),
      static_cast<const int8_t*>(w), mult, static_cast<const float*>(s_col),
      static_cast<int8_t*>(xf), static_cast<int32_t*>(partial), out, out_kind, M, K, N, group,
      n_split, 0, depth, static_cast<cudaStream_t>(stream));
}

// Group-halves layout; group % 8 == 0.
extern "C" int ff_w4a8_gemv_unpaired(const void* x, const void* xs, const void* w,
                                     const void* mult, const void* s_col, void* xf,
                                     void* partial, void* out, int M, int K, int N, int group,
                                     int n_split, int depth, int out_kind, void* stream) {
  return ff::mma8::launch<ff::kHalves, false>(
      static_cast<const int8_t*>(x), static_cast<const float*>(xs),
      static_cast<const int8_t*>(w), mult, static_cast<const float*>(s_col),
      static_cast<int8_t*>(xf), static_cast<int32_t*>(partial), out, out_kind, M, K, N, group,
      n_split, 0, depth, static_cast<cudaStream_t>(stream));
}

// Row 4 on the tile with the argmax epilogue: idx_out (M,) int32; pair_val,
// pair_idx (M, ceil(N / 128)); xf, partial and depth as ff_w4a8_gemv's.
extern "C" int ff_w4a8_gemv_argmax(const void* x, const void* xs, const void* w,
                                   const void* mult, const void* s_col, void* xf, void* partial,
                                   void* pair_val, void* pair_idx, void* idx_out, int M, int K,
                                   int N, int group, int n_split, int depth, void* stream) {
  return ff::mma8::launch<ff::kPaired, false, true>(
      static_cast<const int8_t*>(x), static_cast<const float*>(xs),
      static_cast<const int8_t*>(w), mult, static_cast<const float*>(s_col),
      static_cast<int8_t*>(xf), static_cast<int32_t*>(partial), idx_out, 0, M, K, N, group,
      n_split, 0, depth, static_cast<cudaStream_t>(stream), static_cast<float*>(pair_val),
      static_cast<int*>(pair_idx));
}

namespace {

// Layer `layer` of stacked weights on the tensor-core tile: flat (L, K/2,
// N) (bn 0) or pre-blocked (L, N/bn, K/2, bn) (a layer is K*N/2 bytes
// either way), its nibble-packed multipliers (L, n_pack, N) and s_col
// (L, N), offset in place; xf and partial as ff_w4a8_gemv's, `depth` ring
// stages.
int stacked_tile(const void* x, const void* xs, const void* w, const void* mult_packed,
                 const void* s_col, void* xf, void* partial, void* out, int M, int K, int N,
                 int layer, int group, int n_pack, int n_split, int out_kind, int bn, int depth,
                 void* stream) {
  if (bn < 0 || (bn > 0 && (bn % 4 != 0 || N % bn != 0)) || n_pack * 8 < K / group)
    return cudaErrorInvalidValue;
  const int8_t* wl = static_cast<const int8_t*>(w) + (size_t)layer * (K / 2) * N;
  const int32_t* ml = static_cast<const int32_t*>(mult_packed) + (size_t)layer * n_pack * N;
  const float* sl = static_cast<const float*>(s_col) + (size_t)layer * N;
  return ff::mma8::launch<ff::kPaired, true>(
      static_cast<const int8_t*>(x), static_cast<const float*>(xs), wl, ml, sl,
      static_cast<int8_t*>(xf), static_cast<int32_t*>(partial), out, out_kind, M, K, N, group,
      n_split, bn, depth, static_cast<cudaStream_t>(stream));
}

}  // namespace

// The stacked GEMV's routes (matmul.py:1023-1237), one entry each, all on
// w4a8_mma.cuh's tile with its packed multipliers; the arguments: x, xs,
// w, mult_packed, s_col, xf, partial (or NULL for one split), out, M, K, N,
// L, layer, group, n_pack, n_split, out_kind, bn (0: flat), depth, stream.
// Flat weights: the default call (:1217) and split-W (kernel :989, call
// :1185). Pre-blocked weights (bn % 4 == 0): the default call on panels
// (:1211-1214) and the manual stream (kernel :879, call :1107, FF_2L_MANUAL
// = nbuf: depth = min(nbuf, ...) stages, depth - 1 in flight). Either
// layout: the dot-raw body (:949, picked at :1205-1208) and the
// concat-pairs body (:780, entered at :834-842; every pair computed).
extern "C" int ff_w4a8_gemv_stacked(const void* x, const void* xs, const void* w,
                                    const void* mult_packed, const void* s_col, void* xf,
                                    void* partial, void* out, int M, int K, int N, int L,
                                    int layer, int group, int n_pack, int n_split, int out_kind,
                                    int bn, int depth, void* stream) {
  (void)L;
  return stacked_tile(x, xs, w, mult_packed, s_col, xf, partial, out, M, K, N, layer, group,
                      n_pack, n_split, out_kind, bn, depth, stream);
}

extern "C" int ff_w4a8_gemv_preblocked(const void* x, const void* xs, const void* w,
                                       const void* mult_packed, const void* s_col, void* xf,
                                       void* partial, void* out, int M, int K, int N, int L,
                                       int layer, int group, int n_pack, int n_split, int out_kind,
                                       int bn, int depth, void* stream) {
  (void)L;
  return stacked_tile(x, xs, w, mult_packed, s_col, xf, partial, out, M, K, N, layer, group,
                      n_pack, n_split, out_kind, bn, depth, stream);
}

extern "C" int ff_w4a8_gemv_manual(const void* x, const void* xs, const void* w,
                                   const void* mult_packed, const void* s_col, void* xf,
                                   void* partial, void* out, int M, int K, int N, int L,
                                   int layer, int group, int n_pack, int n_split, int out_kind,
                                   int bn, int depth, void* stream) {
  (void)L;
  return stacked_tile(x, xs, w, mult_packed, s_col, xf, partial, out, M, K, N, layer, group,
                      n_pack, n_split, out_kind, bn, depth, stream);
}

extern "C" int ff_w4a8_gemv_splitw(const void* x, const void* xs, const void* w,
                                   const void* mult_packed, const void* s_col, void* xf,
                                   void* partial, void* out, int M, int K, int N, int L,
                                   int layer, int group, int n_pack, int n_split, int out_kind,
                                   int bn, int depth, void* stream) {
  (void)L;
  return stacked_tile(x, xs, w, mult_packed, s_col, xf, partial, out, M, K, N, layer, group,
                      n_pack, n_split, out_kind, bn, depth, stream);
}

extern "C" int ff_w4a8_gemv_dotraw(const void* x, const void* xs, const void* w,
                                   const void* mult_packed, const void* s_col, void* xf,
                                   void* partial, void* out, int M, int K, int N, int L,
                                   int layer, int group, int n_pack, int n_split, int out_kind,
                                   int bn, int depth, void* stream) {
  (void)L;
  return stacked_tile(x, xs, w, mult_packed, s_col, xf, partial, out, M, K, N, layer, group,
                      n_pack, n_split, out_kind, bn, depth, stream);
}

extern "C" int ff_w4a8_gemv_concat(const void* x, const void* xs, const void* w,
                                   const void* mult_packed, const void* s_col, void* xf,
                                   void* partial, void* out, int M, int K, int N, int L,
                                   int layer, int group, int n_pack, int n_split, int out_kind,
                                   int bn, int depth, void* stream) {
  (void)L;
  return stacked_tile(x, xs, w, mult_packed, s_col, xf, partial, out, M, K, N, layer, group,
                      n_pack, n_split, out_kind, bn, depth, stream);
}

// The any-group route (w4a8_mma.cuh launch_rows), planned by
// kernels/matmul.py rows_plan. Rows 5 and 4: ff_w4a8_gemv's arguments;
// paired (whole group pairs) and group halves (g even), N any.
extern "C" int ff_w4a8_gemv_any(const void* x, const void* xs, const void* w, const void* mult,
                                const void* s_col, void* xf, void* partial, void* out, int M,
                                int K, int N, int group, int n_split, int depth, int out_kind,
                                void* stream) {
  if (out_kind < ff::mma8::kOutF32 || out_kind > ff::mma8::kOutBf16) return cudaErrorInvalidValue;
  return ff::mma8::launch_rows<ff::kPaired, false>(
      static_cast<const int8_t*>(x), static_cast<const float*>(xs),
      static_cast<const int8_t*>(w), mult, static_cast<const float*>(s_col),
      static_cast<int8_t*>(xf), static_cast<int32_t*>(partial), out, out_kind, M, K, N, group,
      n_split, 0, depth, static_cast<cudaStream_t>(stream));
}

extern "C" int ff_w4a8_gemv_unpaired_any(const void* x, const void* xs, const void* w,
                                         const void* mult, const void* s_col, void* xf,
                                         void* partial, void* out, int M, int K, int N,
                                         int group, int n_split, int depth, int out_kind,
                                         void* stream) {
  if (out_kind < ff::mma8::kOutF32 || out_kind > ff::mma8::kOutBf16) return cudaErrorInvalidValue;
  return ff::mma8::launch_rows<ff::kHalves, false>(
      static_cast<const int8_t*>(x), static_cast<const float*>(xs),
      static_cast<const int8_t*>(w), mult, static_cast<const float*>(s_col),
      static_cast<int8_t*>(xf), static_cast<int32_t*>(partial), out, out_kind, M, K, N, group,
      n_split, 0, depth, static_cast<cudaStream_t>(stream));
}

// Row 9 at those groups, every route: ff_w4a8_gemv_stacked's arguments,
// layer `layer` of flat (bn 0) or pre-blocked (L, N/bn, K/2, bn) weights.
extern "C" int ff_w4a8_gemv_stacked_any(const void* x, const void* xs, const void* w,
                                        const void* mult_packed, const void* s_col, void* xf,
                                        void* partial, void* out, int M, int K, int N, int L,
                                        int layer, int group, int n_pack, int n_split,
                                        int out_kind, int bn, int depth, void* stream) {
  if (layer < 0 || layer >= L || group < 1 || n_pack * 8 < K / group ||
      out_kind < ff::mma8::kOutF32 || out_kind > ff::mma8::kOutBf16)
    return cudaErrorInvalidValue;
  return ff::mma8::launch_rows<ff::kPaired, true>(
      static_cast<const int8_t*>(x), static_cast<const float*>(xs),
      static_cast<const int8_t*>(w) + (size_t)layer * (K / 2) * N,
      static_cast<const int32_t*>(mult_packed) + (size_t)layer * n_pack * N,
      static_cast<const float*>(s_col) + (size_t)layer * N, static_cast<int8_t*>(xf),
      static_cast<int32_t*>(partial), out, out_kind, M, K, N, group, n_split, bn, depth,
      static_cast<cudaStream_t>(stream));
}
