"""The int8 tensor-core tile's two new entries on the CPU: the W4A4 GEMV on
the vertical layout (`csrc/a4_gemv.cu` on `csrc/w4a8_mma.cuh`) and the
argmax epilogue of the two-level W4A8 lm_head (`ff_w4a8_gemv_argmax`),
held against `fastforward_tpu.kernels.matmul`.

For the vertical layout the tile flips bit 3 of every nibble (two's
complement to offset binary), folds the group's multiplier into both
nibble planes (`fold_w4a4_2l_words`), stages the activations as the two
planes of each byte row (x's even and odd k, de-interleaved from 32-byte
runs by ``__byte_perm``), multiplies int8 bytes into int32 sums over the
splits of its plan (`mma_plan(..., "vertical")`) and adds the splits in
order before the oracle's epilogue. The argmax epilogue reduces each
row's f32 logits to one (max, first index) pair per 128-column block (a
lane's 8 columns, its row's 4 lanes, the 4 warps), then one warp a row
reduces the pairs. Here both are written out in torch and numpy and
compared with the JAX oracles, the JAX GEMVs and ``jnp.argmax``.
Tolerance: none — integer sums, one float epilogue and token ids, bit
for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastforward_tpu.kernels import matmul as jm
from fastforward_tpu.kernels import packing as jpk
from fastforward_tpu_torch.kernels import matmul as tm
from fastforward_tpu_torch.kernels import packing as tpk

STAGE_ROWS, BLOCK_N, WARPS = 64, 128, 4  # csrc/w4a8_mma.cuh kR, kN, kConsumers
NONE = np.iinfo(np.int32).max            # common.cuh `better`'s "no candidate" index

# Llama-3-8B's decoder projections at g512 (bench.py's default, run (a))
PROJ_A = [(4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096)]


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)


@pytest.mark.parametrize("plane", [0, 1])
def test_vertical_fold_gives_m_times_v_for_every_nibble_and_multiplier(plane):
    # GIVEN every (v, m) pair, v in [-8, 7] and m in [1, 15], as the nibble
    # of one plane in every byte position of a word, the other nibbles random
    rs = np.random.RandomState(plane)
    v, m, pos = np.meshgrid(np.arange(-8, 8), np.arange(1, 16), np.arange(4), indexing="ij")
    v, m, pos = v.ravel(), m.ravel(), pos.ravel()
    nib = rs.randint(-8, 8, (2, v.size, 4))
    nib[plane, np.arange(v.size), pos] = v
    words = (((nib[0] & 0xF) | ((nib[1] & 0xF) << 4)).astype(np.uint32)
             << (8 * np.arange(4))).sum(1).astype(np.uint32)
    # WHEN folded as the tile folds a vertical word
    folded = tm.fold_w4a4_2l_words(torch.from_numpy(words.view(np.int32)), torch.from_numpy(m))
    # THEN every byte of both planes is m * v as a signed byte
    for p, f in enumerate(folded):
        assert f.dtype == torch.int32
        b = f.numpy().view(np.int8).reshape(-1, 4)
        np.testing.assert_array_equal(b, m[:, None] * nib[p])
    np.testing.assert_array_equal(
        folded[plane].numpy().view(np.int8).reshape(-1, 4)[np.arange(v.size), pos], m * v)


def _byte_perm(a, b, sel):
    """CUDA's __byte_perm on uint32 values held in int64: byte j of the
    result is byte (sel >> 4j) & 7 of the eight bytes b:a."""
    both = (b << 32) | a
    out = torch.zeros_like(a)
    for j in range(4):
        out |= ((both >> (8 * ((sel >> (4 * j)) & 7))) & 0xFF) << (8 * j)
    return out


def _stage_vertical(x_q, plan, g):
    """stage_x_kernel's plane bytes for the vertical layout, as signed
    values: (2, M, n_split, stages * STAGE_ROWS). Padded byte row q of a
    split is row q % p16 of its unit q // p16; a half of 16 rows inside its
    unit comes from the 32 bytes x[m, ug + 2 i0 ..] de-interleaved by
    __byte_perm (0x6420: the even bytes, plane 0; 0x7531: the odd ones),
    a half past the unit's rows byte by byte (x[m, ug + 2i + p]), padding
    and rows past the split's units zero."""
    M, K = x_q.shape
    xb = x_q.view(torch.uint8).long()
    out = torch.zeros((2, M, plan.n_split, plan.stages * STAGE_ROWS), dtype=torch.int64)
    for s, (u0, u1) in enumerate(plan.unit_ranges()):
        for h0 in range(0, plan.stages * STAGE_ROWS, 16):
            u, i0 = u0 + h0 // plan.p16, h0 % plan.p16
            if u >= u1:
                continue
            base = u * g + 2 * i0
            for p, sel in enumerate((0x6420, 0x7531)):
                if i0 + 16 <= plan.unit_rows:
                    words = (xb[:, base:base + 32].reshape(M, 8, 4)
                             << (8 * torch.arange(4))).sum(-1)
                    wd = [_byte_perm(words[:, 2 * j], words[:, 2 * j + 1], sel) for j in range(4)]
                    rows = torch.stack([(w >> (8 * b)) & 0xFF for w in wd for b in range(4)], 1)
                else:
                    n = min(16, plan.unit_rows - i0)
                    rows = torch.zeros((M, 16), dtype=torch.int64)
                    rows[:, :n] = xb[:, base + p + 2 * torch.arange(n)]
                out[p, :, s, h0:h0 + 16] = rows
    return out - ((out >> 7) << 8)


def _a4_tile(x_q, x_s, w_packed, mult, s_col, g):
    """The tile's arithmetic on the vertical layout: words of 4 byte rows
    of one column folded with their group's multiplier (bit 3 flipped),
    the staged planes times the folded planes summed in int32 over each
    split's padded rows, the splits added in order, the oracle's bf16
    epilogue."""
    M, K = x_q.shape
    N = w_packed.shape[1]
    plan = tm.mma_plan(M, K, N, g, "vertical")
    ur = plan.unit_rows
    assert (plan.unit_rows, plan.n_units) == (g // 2, K // g)
    words = (w_packed.view(torch.uint8).reshape(K // 8, 4, N).permute(0, 2, 1).contiguous()
             .view(torch.int32).reshape(K // 8, N))
    unit = 4 * torch.arange(K // 8) // ur  # a word's 4 rows lie in one group
    planes = [f.contiguous().view(torch.int8).reshape(K // 8, N, 4).permute(0, 2, 1)
              .reshape(K // 2, N).long()
              for f in tm.fold_w4a4_2l_words(words, mult[unit].to(torch.int64))]
    staged = _stage_vertical(x_q, plan, g)
    acc = torch.zeros((M, N), dtype=torch.int64)
    for s, (u0, u1) in enumerate(plan.unit_ranges()):
        q = torch.arange(plan.stages * STAGE_ROWS)
        u, i = u0 + q // plan.p16, q % plan.p16
        real = (u < u1) & (i < ur)  # the padding rows' weights are never copied
        rows = (u * ur + i)[real]
        part = sum(staged[p, :, s][:, real] @ planes[p][rows] for p in range(2))
        acc += part
        assert acc.abs().max() < 2**31
    return tm._epilogue(acc.to(torch.int32).float(), s_col, x_s, None, torch.bfloat16)


def _a4_inputs(M, K, N, g, seed, extreme):
    rs = np.random.RandomState(seed)
    w = rs.randint(-128, 128, (K // 2, N)).astype(np.int8)
    m = rs.randint(1, 16, (K // g, N)).astype(np.int8)
    s = (rs.rand(N) * 1e-2 + 1e-4).astype(np.float32)
    x = (rs.randn(M, K) * 3).astype(np.float32)
    x_q, x_s = jax.jit(jm.quantize_rowwise_a4)(jnp.asarray(x).astype(jnp.bfloat16))
    x_q, x_s = np.array(x_q), np.array(x_s)
    if extreme:  # the extreme nibbles, activations and multipliers: -8 and 7, m = 15
        x_q = np.where(rs.rand(M, K) < 0.5, 7, -8).astype(np.int8)
        v = np.where(rs.rand(K, N) < 0.5, 7, -8).astype(np.int8)
        w = tpk.pack_int4_vertical(torch.from_numpy(v)).numpy()
        m[:] = 15
    return w, m, s, x_q, x_s


@pytest.mark.parametrize("M", [1, 8, 17])
@pytest.mark.parametrize("K,N,g,extreme", [
    (1024, 128, 512, False),  # two g512 units of 256 byte rows: 4 stages each
    (512, 384, 128, False),   # three column tiles, K split
    (256, 136, 32, False),    # a 16-row unit a stage quarter, a ragged column tile
    (256, 132, 8, False),     # 4-row units, padded to 16
    (1024, 256, 512, True),   # -8 and 7 everywhere, m = 15
    (512, 128, 32, True),
])
def test_a4_tile_arithmetic_equals_jax_reference_and_gemv(M, K, N, g, extreme):
    # GIVEN W4A4 two-level weights in the vertical layout and int4
    # activations (the JAX quantizer's), seeded with numpy
    w, m, s, x_q, x_s = _a4_inputs(M, K, N, g, seed=M * K + N + g, extreme=extreme)
    xt, st = torch.from_numpy(x_q), torch.from_numpy(x_s)
    # WHEN the tile's arithmetic runs in torch and the JAX oracle and stacked
    # GEMV (layer 1 of 2) run on the same integers
    out = _a4_tile(xt, st, torch.from_numpy(w), torch.from_numpy(m), torch.from_numpy(s), g)
    ref = jm.matmul_w4a4_2l_reference(jnp.asarray(x_q), jnp.asarray(x_s), jnp.asarray(w),
                                      jnp.asarray(m), jnp.asarray(s), None, g)
    w2, m2, s2 = (np.stack([np.zeros_like(a), a]) for a in (w, m, s))
    mp = jpk.pack_mult_nibbles(jnp.asarray(m2))
    gemv = jm.matmul_w4a4_2l_gemv_stacked(jnp.asarray(x_q), jnp.asarray(x_s), jnp.asarray(w2),
                                          mp, jnp.asarray(s2), jnp.int32(1), group_size=g)
    # THEN all three agree bit for bit, and the port's plain stacked GEMV
    np.testing.assert_array_equal(_np(out), _np(ref))
    np.testing.assert_array_equal(_np(out), _np(gemv))
    plain = tm.matmul_w4a4_2l_gemv_stacked(xt, st, torch.from_numpy(w2),
                                           torch.from_numpy(np.array(mp)),
                                           torch.from_numpy(s2), 1, group_size=g)
    np.testing.assert_array_equal(_np(out), _np(plain))


@pytest.mark.parametrize("K,N", PROJ_A)
def test_vertical_plan_covers_every_group_at_run_a_shapes(K, N):
    # GIVEN run (a)'s projections at g512, every row count of the GEMV
    g = 512
    for M in range(1, 257):
        plan = tm.mma_plan(M, K, N, g, "vertical")
        # THEN a unit is one group of g/2 byte rows (4 ring stages at g512)
        assert (plan.unit_rows, plan.p16, plan.n_units) == (g // 2, g // 2, K // g)
        assert plan.p16 == 4 * STAGE_ROWS
        # the splits cover every group once and in order
        ranges = plan.unit_ranges()
        assert len(ranges) == plan.n_split and all(u0 < u1 for u0, u1 in ranges)
        assert [u for u0, u1 in ranges for u in range(u0, u1)] == list(range(K // g))
        assert plan.ups == -(-plan.n_units // plan.n_split)
        assert plan.stages * STAGE_ROWS == plan.ups * plan.p16
        # the plan equals the group-halves one (the same unit), and the ring
        # fits the 227 KB a block may use
        assert plan == tm.mma_plan(M, K, N, g, "halves")
        depth = tm.manual_depth(plan, 4)
        assert 1 <= depth <= min(4, plan.stages)
        assert depth * (plan.stage_bytes + 16) + 1024 <= 232448


def test_mma_plan_rejects_an_unknown_layout():
    with pytest.raises(ValueError, match="layout"):
        tm.mma_plan(8, 1024, 128, 128, "diagonal")


def _better(v, i, bv, bi):
    """common.cuh `better`, elementwise: a NaN beats any number, among equals
    (or NaNs) the lower index wins; NONE is no candidate."""
    vn, bn = np.isnan(v), np.isnan(bv)
    with np.errstate(invalid="ignore"):
        res = np.where(vn != bn, vn, np.where(vn | (v == bv), i < bi, v > bv))
    res = np.where(i == NONE, False, res)
    return np.where(bi == NONE, i != NONE, res)


def _take(v, i, bv, bi):
    b = _better(v, i, bv, bi)
    return np.where(b, v, bv), np.where(b, i, bi)


def _argmax_epilogue(logits):
    """The tile's argmax epilogue and argmax_reduce_kernel, written out on
    the f32 logits (M, N): per row and 128-column block, lane (warp, tid)
    scans its columns 32 warp + 8 tid + c in order (a later column taken
    for a larger value or as the first NaN), the 4 lanes of a row
    meet by shuffles (xor 1, then 2), the 4 warps in order; then one warp a
    row: lane l scans pairs l, l + 32, .., the lanes meet by shuffles (xor
    16, 8, 4, 2, 1)."""
    M, N = logits.shape
    n_tiles = -(-N // BLOCK_N)
    cols = np.arange(n_tiles * BLOCK_N)
    y = np.zeros((M, n_tiles * BLOCK_N), np.float32)
    y[:, :N] = logits
    idx = np.broadcast_to(np.where(cols < N, cols, NONE), y.shape)
    y = y.reshape(M, n_tiles, WARPS, 4, 8)
    idx = idx.reshape(M, n_tiles, WARPS, 4, 8)
    bv, bi = np.zeros(y.shape[:-1], np.float32), np.full(y.shape[:-1], NONE)
    for c in range(8):  # ascending: a later column wins by a larger value or as the first NaN
        yc, ic = y[..., c], idx[..., c]
        with np.errstate(invalid="ignore"):
            take = (ic != NONE) & ((bi == NONE) | (yc > bv) | (np.isnan(yc) & ~np.isnan(bv)))
        bv, bi = np.where(take, yc, bv), np.where(take, ic, bi)
    for off in (1, 2):
        partner = np.arange(4) ^ off
        bv, bi = _take(bv[..., partner], bi[..., partner], bv, bi)
    pv, pi = bv[..., 0, 0], bi[..., 0, 0]  # lane tid 0 of warp 0
    for w in range(1, WARPS):
        pv, pi = _take(bv[..., w, 0], bi[..., w, 0], pv, pi)
    # the reduce kernel over the (M, n_tiles) pairs
    lanes = -(-n_tiles // 32) * 32
    lv, li = np.zeros((M, lanes), np.float32), np.full((M, lanes), NONE)
    lv[:, :n_tiles], li[:, :n_tiles] = pv, pi
    lv, li = lv.reshape(M, -1, 32), li.reshape(M, -1, 32)
    rv, ri = np.zeros((M, 32), np.float32), np.full((M, 32), NONE)
    for t in range(lv.shape[1]):
        rv, ri = _take(lv[:, t], li[:, t], rv, ri)
    for off in (16, 8, 4, 2, 1):
        partner = np.arange(32) ^ off
        rv, ri = _take(rv[:, partner], ri[:, partner], rv, ri)
    return ri[:, 0].astype(np.int32)


@pytest.mark.parametrize("M,K,N,g", [
    (17, 512, 300, 128),   # a ragged last block (300 % 128 = 44)
    (8, 256, 1000, 64),    # 8 blocks, the last ragged
    (3, 512, 5000, 128),   # 40 blocks: more pairs a row than a warp's lanes
    (1, 1024, 128, 512),   # one block
])
@pytest.mark.parametrize("nan", [None, "row", "column"])
def test_argmax_epilogue_equals_jnp_argmax_of_the_jax_logits(M, K, N, g, nan):
    # GIVEN paired two-level W4A8 weights with planted ties: column 3's
    # weights, multipliers and scale copied to column 77 (the same block),
    # 130 and N - 2 (other blocks, N - 2 in the ragged last one), all four
    # scaled up so that they carry the maximum wherever column 3's sum is
    # positive; row 0 all zeros (every logit 0: a tie over the whole row)
    rs = np.random.RandomState(M + N + g)
    w = rs.randint(-128, 128, (K // 2, N)).astype(np.int8)
    m = rs.randint(1, 16, (K // g, N)).astype(np.int8)
    s = (rs.rand(N) * 1e-3 + 1e-5).astype(np.float32)
    tied = [c for c in (3, 77, 130, N - 2) if c < N]
    for c in tied:
        w[:, c], m[:, c] = w[:, 3], m[:, 3]
    s[tied] = 1.0
    x = (rs.randn(M, K) * 3).astype(np.float32)
    x_q, x_s = (np.asarray(a) for a in jax.jit(jm.quantize_rowwise)(
        jnp.asarray(x).astype(jnp.bfloat16)))
    x_q, x_s = x_q.copy(), x_s.copy()
    x_q[0] = 0
    if nan == "row":
        x_s[M - 1] = np.nan      # every logit of the last row NaN: index 0
    elif nan == "column":
        s[N // 2] = np.nan       # one NaN column: every row's maximum
    args = [jnp.asarray(a) for a in (x_q, x_s, w, m, s)]
    # WHEN the JAX f32 logits are reduced by jnp.argmax and the port's plain
    # f32 logits by the epilogue written out
    logits = jm.matmul_w4a8_2l_reference(*args, None, g, jnp.float32, paired=True)
    plain = tm.matmul_w4a8_2l_reference(*(torch.from_numpy(a) for a in (x_q, x_s, w, m, s)),
                                        None, g, torch.float32, paired=True)
    np.testing.assert_array_equal(_np(plain), _np(logits))
    ids = _argmax_epilogue(plain.numpy())
    # THEN the ids are jnp.argmax's, the JAX head's and the port's plain head's
    want = np.asarray(jnp.argmax(logits, axis=-1)).astype(np.int32)
    np.testing.assert_array_equal(ids, want)
    np.testing.assert_array_equal(ids, np.asarray(jm.matmul_w4a8_2l_gemv_argmax(
        *args, group_size=g, paired=True)))
    np.testing.assert_array_equal(ids, tm.matmul_w4a8_2l_gemv_argmax(
        *(torch.from_numpy(a) for a in (x_q, x_s, w, m, s)), g, paired=True).numpy())
    if nan != "column":
        assert ids[0] == 0
    if nan == "row":
        assert ids[M - 1] == 0
    elif nan == "column":
        assert (ids == N // 2).all()
    else:
        hit = [r for r in range(1, M) if ids[r] in tied]
        assert all(ids[r] == 3 for r in hit)  # the first of the tied columns
