"""The wgmma W4 GEMV (`csrc/w4_gemv.cu`, row 17) and the staged operand of
the fused layer heads' prologue (`csrc/fused_head.cu`, rows 13 and 12), on
the CPU.

The W4 GEMV turns a nibble at bit b of a word into the float 2^(23-b) + u
(one AND-XOR with exponent bits), subtracts 2^(23-b) + 8, multiplies by
the f32 scale and rounds to bf16 (`w4_gemv_dequant_words` mirrors it): for
every nibble and a spread of f32 scales (both signs, subnormal to large)
that is `dequantize_int4_reference`'s bf16 bit for bit. Its plan
(`w4_plan`) splits K over whole stages of 128 k (whole groups up to g128;
a group of 128 j spans j stages), none empty,
and fills at least 70% of the card's block slots at the Llama-3-8B shapes
of run (f). Written out in
torch, its split arithmetic (f32 partials over each split's k, added in
split order) stays within the W4 GEMV's tolerance of the JAX function.

The fused heads' prologue writes its quantized row straight into the int8
tensor-core tile's staged operand (`mma_staged_operand` mirrors it); that
equals what the tile's staging launch, `stage_x_kernel`, writes (mirrored
here thread by thread) in the paired layout of the W4A8 head and the
vertical one of the A4 head. The W4A8 head plans its product as row 9's
GEMV (`mma_plan(..., "paired")`) at the decode's row counts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastforward_tpu.kernels import matmul as jm
from fastforward_tpu_torch.kernels import matmul as mm
from fastforward_tpu_torch.kernels.packing import unpack_int4

# Llama-3-8B's four projections and lm_head (K, N) in run (f), g128
SHAPES_F = {"qkv": (4096, 6144), "o": (4096, 4096), "gate_up": (4096, 28672),
            "down": (14336, 4096), "lm_head": (4096, 128256)}
SMS = 132                 # the H100's streaming multiprocessors
W4_GEMV_RTOL = 1e-4       # f32 outputs: this share of the largest output
STAGE_ROWS, CHUNKS, FRAG = 64, 2, 512  # csrc/w4a8_mma.cuh kR, kChunks, kFrag


def _f32_scales(n, seed):
    """``n`` f32 scales drawn as bit patterns with numpy: either sign,
    biased exponents 0 (subnormal) to 230 (2^103), any mantissa."""
    rng = np.random.default_rng(seed)
    sign = rng.integers(0, 2, n, dtype=np.uint32) << 31
    exp = rng.integers(0, 231, n, dtype=np.uint32) << 23
    man = rng.integers(0, 1 << 23, n, dtype=np.uint32)
    return torch.from_numpy((sign | exp | man).view(np.int32)).view(torch.float32)


def _bits(t):
    return t.view(torch.int16).to(torch.int32) & 0xFFFF


@pytest.mark.parametrize("seed", [0, 1])
def test_dequant_mirror_rounds_as_the_reference(seed):
    # GIVEN every pair of nibbles of two byte rows (a column's bytes 0 and 1
    # of a word) and 2,000 f32 scales, subnormal to large, both signs
    s = _f32_scales(2000, seed)
    sb = s.view(torch.int32)
    assert (((sb >> 23) & 0xFF) == 0).any() and (s.abs() > 2.0 ** 90).any()
    assert (s < 0).any() and (s > 0).any()
    lo, hi = torch.meshgrid(torch.arange(256), torch.arange(256), indexing="ij")
    words = (lo | (hi << 8)).flatten()  # byte row r at byte 0, row r + 1 at byte 1
    # WHEN the kernel's dequant runs on them
    got = mm.w4_gemv_dequant_words(words[:, None], s[None, :])
    # THEN row r's and row r + 1's low then high nibbles are
    # dequantize_int4_reference's bf16 weights bit for bit (one byte row of
    # group 2: k = 0 the low nibble, k = 1 the high)
    packed = torch.stack([words & 0xFF, words >> 8], 0).to(torch.uint8).view(torch.int8)
    for r in range(2):
        v = unpack_int4(packed[r].reshape(1, -1), group_size=2).reshape(2, -1)
        for plane in range(2):
            ref = (v[plane].float()[:, None] * s[None, :]).to(torch.bfloat16)
            assert torch.equal(_bits(got[..., 2 * plane + r]), _bits(ref))
    # AND on every nibble v the float before the scale is v exactly
    one = mm.w4_gemv_dequant_words(torch.arange(65536), torch.tensor(1.0)).float()
    nib = torch.arange(65536)[:, None] >> torch.tensor([0, 8, 4, 12])
    assert torch.equal(one, (((nib & 0xF) ^ 8) - 8).float())


@pytest.mark.parametrize("M", [1, 7, 8, 9, 16, 17, 32, 33, 63, 64, 65, 128, 129, 192, 256])
@pytest.mark.parametrize("name", list(SHAPES_F))
def test_w4_plan_splits_whole_groups_and_fills_the_card(M, name):
    # GIVEN a projection of run (f) at g128, and the smaller groups
    K, N = SHAPES_F[name]
    for g in (128, 64, 32):
        plan = mm.w4_plan(M, K, N, g)
        # THEN the token tiles cover the rows, the splits cover every stage
        # once in order, each non-empty and starting on a whole group
        assert M <= plan.n < 2 * max(M, 8)
        ranges = plan.stage_ranges()
        assert [t for a, b in ranges for t in range(a, b)] == list(range(-(-K // 128)))
        assert all(a < b and a * 128 % g == 0 for a, b in ranges)
        assert 1 <= plan.n_split <= 8 and plan.n_tiles == -(-N // 128)
        # AND the ring holds two stages where a split has two, in the
        # shared memory the SM gives each of its blocks
        assert min(2, plan.sps) <= plan.depth <= plan.sps
        assert plan.smem_bytes <= 233472 // plan.per_sm - 1024
    if M in (8, 192):
        # AND at the decode's M = 192 and 8 its first wave of clusters holds
        # at least 70% of the card's block slots (larger clusters leave SMs
        # idle: W4_CLUSTERS), and no other split costs less by the plan's
        # measure
        plan = mm.w4_plan(M, K, N, 128)
        cap = mm.W4_CLUSTERS[plan.per_sm]
        assert min(plan.n_tiles, cap[plan.n_split - 1]) * plan.n_split >= 0.7 * SMS * plan.per_sm

        def cost(p):
            return -(-p.n_tiles // cap[p.n_split - 1]) * (p.sps + mm._W4_BLOCK_COST)
        assert all(cost(plan) <= cost(mm.w4_plan(M, K, N, 128, s)) for s in range(1, 9))


def test_w4_plan_refuses_what_the_kernel_does_not_take():
    # no row, more than 256 rows, an odd group, no group, K not whole groups,
    # a group above K (g 192 and K % 128 != 0 at g256 take the permuted route)
    for M, K, g in ((0, 4096, 128), (257, 4096, 128), (8, 4096, 3), (8, 4160, 0),
                    (8, 4000, 128), (8, 256, 512)):
        with pytest.raises(ValueError, match="W4 GEMV plan"):
            mm.w4_plan(M, K, 64, g)


@pytest.mark.parametrize("M", [1, 8, 192, 256])
@pytest.mark.parametrize("name", list(SHAPES_F))
def test_w4_plan_at_large_groups(M, name):
    # GIVEN a projection of run (f) at g 256, 512 and g = K
    K, N = SHAPES_F[name]
    for g in (256, 512, K):
        plan = mm.w4_plan(M, K, N, g)
        # THEN the splits cover every 128-k stage once, none empty; a
        # group spans g / 128 stages, so a split may start inside one (the
        # f32 sums need no group boundary)
        ranges = plan.stage_ranges()
        assert [t for a, b in ranges for t in range(a, b)] == list(range(K // 128))
        assert all(a < b for a, b in ranges)
        assert mm.stage_groups(g) == (1, g // 128)
        assert min(2, plan.sps) <= plan.depth <= plan.sps
        assert plan.smem_bytes <= 233472 // plan.per_sm - 1024
        # AND the plan is g128's: the stages do not depend on the group
        assert plan == mm.w4_plan(M, K, N, 128)


def _mirror_weights(w_packed, s, g):
    """The (K, N) bf16 weights as the kernel dequantizes them: each pair of
    byte rows r, r + 1 (r even) of a column through `w4_gemv_dequant_words`,
    the low plane at k = pg + i, the high one g/2 further (pack_int4)."""
    K2, N = w_packed.shape
    b = w_packed.view(torch.uint8).long()
    words = b[0::2] | (b[1::2] << 8)  # (K/4, N)
    r = 2 * torch.arange(K2 // 2)
    p, i = r // (g // 2), r % (g // 2)
    scale = s[p]  # (K/4, N): a pair's rows share the group
    d = mm.w4_gemv_dequant_words(words, scale)  # (K/4, N, 4)
    w = torch.empty((K2 * 2, N), dtype=torch.bfloat16)
    k_lo = p * g + i
    for j, k in enumerate((k_lo, k_lo + 1, k_lo + g // 2, k_lo + g // 2 + 1)):
        w[k] = d[..., j]
    return w


@pytest.mark.parametrize("M,K,g", [(8, 14336, 128), (192, 4096, 128), (65, 1024, 64),
                                   (3, 320, 32), (8, 2048, 256), (192, 1024, 512),
                                   (17, 1024, 1024)])
def test_split_arithmetic_within_tolerance_of_jax(M, K, g):
    # GIVEN numpy-seeded activations, packed weights and f32 scales
    N = 136
    rs = np.random.RandomState(M + K + g)
    w = rs.randint(-128, 128, (K // 2, N)).astype(np.int8)
    s = (rs.rand(K // g, N) * 0.05 + 1e-3).astype(np.float32)
    x = rs.randn(M, K).astype(np.float32)
    wt, st = torch.from_numpy(w), torch.from_numpy(s)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    # WHEN the kernel's arithmetic runs in torch: the mirrored dequant, an
    # f32 partial over each split's k, the partials added in split order
    wq = _mirror_weights(wt, st, g)
    jw = jax.jit(jm.dequantize_int4, static_argnums=2)(jnp.asarray(w), jnp.asarray(s), g)
    assert torch.equal(_bits(wq), _bits(torch.from_numpy(np.array(jw.view(jnp.int16)))
                                        .view(torch.bfloat16)))
    plan = mm.w4_plan(M, K, N, g)
    out = None
    for a, b in plan.stage_ranges():
        ks = slice(128 * a, min(K, 128 * b))
        part = xt[:, ks].float() @ wq[ks].float()
        out = part if out is None else out + part
    # THEN it is within W4_GEMV_RTOL of the largest output of JAX's function
    # (the bf16 product of x and the dequantized weight, f32 accumulation)
    ref = np.asarray(jax.jit(lambda x, w: jax.lax.dot(
        x.astype(jnp.bfloat16), w, preferred_element_type=jnp.float32))(jnp.asarray(x), jw))
    assert np.abs(out.numpy() - ref).max() <= W4_GEMV_RTOL * np.abs(ref).max()


def _byte_perm(a, b, sel):
    """CUDA's __byte_perm on uint32 values held in int64."""
    both = (b << 32) | a
    out = np.zeros_like(a)
    for j in range(4):
        out |= ((both >> (8 * ((sel >> (4 * j)) & 7))) & 0xFF) << (8 * j)
    return out


def _stage_x_kernel(x_q, plan, g, layout):
    """`csrc/w4a8_mma.cuh` stage_x_kernel, thread by thread (vectorized over
    its threads): thread t owns (fragment f, row r16, half h); its words
    wd[i] hold byte rows i0 + 4i.. of the half's unit (16 consecutive k of
    the plane, or every other k of 32 in the vertical layout; zeros past M,
    the unit's rows and the split's units); lane quarter tid's register is
    __byte_perm(wd[tid / 2], wd[2 + tid / 2], tid odd ? 0x7632 : 0x5410)."""
    M, K = x_q.shape
    mt = plan.mt
    total = plan.m_tiles * plan.n_split * plan.stages * CHUNKS * 2 * mt * 32
    t = np.arange(total)
    r16, h, f = t % 32 // 2, t % 2, t // 32
    ti, rest = f % mt, f // mt
    plane, rest = rest % 2, rest // 2
    c, rest = rest % CHUNKS, rest // CHUNKS
    s, rest = rest % plan.stages, rest // plan.stages
    split, m_tile = rest % plan.n_split, rest // plan.n_split
    m = (m_tile * mt + ti) * 16 + r16
    q = s * STAGE_ROWS + 32 * c + 16 * h
    u, i0 = split * plan.ups + q // plan.p16, q % plan.p16
    u_end = np.minimum(plan.n_units, (split + 1) * plan.ups)
    step = 2 if layout == "vertical" else 1
    first = {"paired": (2 * u + plane) * g, "vertical": u * g + plane}[layout]
    xb = np.zeros((M + 1, K), dtype=np.int64)
    xb[:M] = x_q.view(torch.uint8).numpy()
    wd = []
    for i in range(4):
        word = np.zeros(total, dtype=np.int64)
        for b in range(4):
            row = i0 + 4 * i + b
            ok = (m < M) & (u < u_end) & (row < plan.unit_rows)
            k = np.clip(first + step * row, 0, K - 1)
            word |= np.where(ok, xb[np.minimum(m, M), k], 0) << (8 * b)
        wd.append(word)
    out = np.zeros(plan.x_bytes // 4, dtype=np.int64)
    gid, reg = r16 % 8, 2 * h + r16 // 8
    for tid in range(4):
        val = _byte_perm(wd[tid // 2], wd[2 + tid // 2], 0x7632 if tid % 2 else 0x5410)
        out[f * (FRAG // 4) + (4 * gid + tid) * 4 + reg] = val
    return torch.from_numpy((out - ((out >> 31) << 32)).astype(np.int32)).view(torch.int8)


@pytest.mark.parametrize("layout,K,N,g", [("paired", 4096, 6144, 128), ("paired", 1152, 136, 36),
                                          ("vertical", 4096, 6144, 512), ("vertical", 640, 136, 40)])
@pytest.mark.parametrize("M", [1, 8, 17, 64, 192, 256])
def test_prologue_staging_equals_the_staging_launch(layout, K, N, g, M):
    # GIVEN int8 activations of the head (row 13: paired, g128; row 12:
    # vertical int4 values, g512; and groups that pad to 16 rows)
    rs = np.random.RandomState(M + K)
    lo, hi = (-8, 8) if layout == "vertical" else (-128, 128)
    x_q = torch.from_numpy(rs.randint(lo, hi, (M, K)).astype(np.int8))
    plan = mm.mma_plan(M, K, N, g, layout)
    # WHEN the prologue's row-by-row staging and the staging launch run
    ours = mm.mma_staged_operand(x_q, plan, g, layout)
    # THEN they write the same bytes, every padding byte zero
    assert ours.shape == (plan.x_bytes,)
    assert torch.equal(ours, _stage_x_kernel(x_q, plan, g, layout))


@pytest.mark.parametrize("M", [1, 2, 8, 16, 17, 32, 33, 64, 65, 128, 192, 255, 256])
def test_w4a8_head_plans_its_product_as_row_9(M):
    # GIVEN the fused W4A8 head's qkv product at Llama-3-8B's widths, g128
    K, N, g = 4096, 6144, 128
    plan = mm.mma_plan(M, K, N, g, "paired")
    # THEN its splits cover every group pair once, in order, and its ring
    # fits; its staged operand is the whole plan's
    assert (plan.unit_rows, plan.n_units) == (g, K // (2 * g))
    covered = [u for a, b in plan.unit_ranges() for u in range(a, b)]
    assert covered == list(range(K // (2 * g)))
    assert 1 <= mm.manual_depth(plan, 4) <= 4
    assert plan.x_bytes == plan.m_tiles * plan.n_split * plan.stages * 2 * 2 * plan.mt * FRAG
