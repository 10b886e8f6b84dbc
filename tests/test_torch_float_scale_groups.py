"""The permuted route of rows 16, 17 and 18t (`csrc/w4a8_halves.cu`
w4a8_perm_kernel, `csrc/w4_gemv.cu` and `csrc/w4_wgmma.cuh` with PERM), on
the CPU.

At every group the reference takes that the kernels do not read x for as it
lies (g even, K a whole number of groups; `float_scale_route` "permuted"),
x is first permuted into byte-row order (`permute_x`): run r of 32 columns
holds x at the low-nibble k of byte rows 16 r .. 16 r + 15, then at their
high-nibble k. Each stage of 64 byte rows loads the scale rows of every
group it touches (`perm_scale_box`, `perm_stage_scale_rows`); row 16 cuts
each k32 step into the pieces of the groups its 16 byte rows meet
(`perm_stage_pieces`) and masks the other groups' bytes out of each
piece's product. Written out in torch (`w4a8_perm_fold`, `w4_perm_product`)
that arithmetic equals the jitted JAX oracle bit for bit (row 16) and the
plain versions of rows 17 and 18t within W4_GEMV_RTOL, at g 2, 16, 48, 96,
112, 192 and 320 and at 1,026 groups (the window tree), and its plans fit an
SM's shared memory.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastforward_tpu.kernels import matmul as jm
from fastforward_tpu_torch.kernels import matmul as mm

EXACT = {"xla_allow_excess_precision": False}
SMEM_BUDGET = {1: 233472 - 1024, 2: 233472 // 2 - 1024}  # an H100 SM's shared memory a block
W4_GEMV_RTOL = 1e-4  # rows 17 and 18t, f32: this share of the largest output
# (K, g, N): g 2, 16, 48, 96, Llama-3-8B's down_proj depth at g 112, g = K at
# 192 and 320, and 1,026 groups of 8 (past 32 x 32: the window tree)
CASES = [(64, 2, 20), (256, 16, 20), (1536, 48, 20), (1536, 96, 20), (14336, 112, 64),
         (192, 192, 20), (320, 320, 20), (8208, 8, 12)]
PROJ = {"qkv": (4096, 6144), "o": (4096, 4096), "gate_up": (4096, 28672),
        "down": (14336, 4096), "lm_head": (4096, 128256)}


@functools.lru_cache(maxsize=None)
def _jax_w4a8(M, K, N, g):
    """The JAX oracle jitted and compiled with EXACT for one shape (f32 out)."""
    f = jax.jit(lambda q, xs, w, s: jm.matmul_w4a8_reference(q, xs, w, s, None, g, jnp.float32))
    spec = (jax.ShapeDtypeStruct((M, K), jnp.int8), jax.ShapeDtypeStruct((M,), jnp.float32),
            jax.ShapeDtypeStruct((K // 2, N), jnp.int8),
            jax.ShapeDtypeStruct((K // g, N), jnp.float32))
    return f.lower(*spec).compile(compiler_options=EXACT)


def _case(M, K, N, g, seed):
    rng = np.random.RandomState(seed)
    w = rng.randint(-128, 128, (K // 2, N)).astype(np.int8)
    s = (rng.rand(K // g, N) * 0.05 + 1e-3).astype(np.float32)
    x_q = rng.randint(-127, 128, (M, K)).astype(np.int8)
    xs = (rng.rand(M) * 0.02 + 1e-4).astype(np.float32)
    x = rng.randn(M, K).astype(np.float32)
    return x_q, xs, w, s, x


@pytest.mark.parametrize("K,g,N", CASES)
def test_permuted_x_is_byte_row_order(K, g, N):
    # GIVEN x whose entries name their own k
    M, h = 2, g // 2
    x = torch.arange(M * K, dtype=torch.int64).reshape(M, K)
    xp = mm.permute_x(x, g)
    # THEN run r's low plane is x at the low-nibble k of byte rows 16 r ..,
    # its high plane x at their high-nibble k (pack_int4: byte row b of group
    # p = b // h holds k = p g + b % h and p g + h + b % h), zeros past K / 2
    assert xp.shape == (M, mm.perm_cols(K)) and mm.perm_cols(K) % 32 == 0
    for r in range(mm.perm_cols(K) // 32):
        for j in range(16):
            b = 16 * r + j
            lo, hi = xp[:, 32 * r + j], xp[:, 32 * r + 16 + j]
            if b < K // 2:
                k = b // h * g + b % h
                assert torch.equal(lo, x[:, k]) and torch.equal(hi, x[:, k + h])
            else:
                assert not lo.any() and not hi.any()
    # AND every k of a row appears once (row 1's entries are all nonzero)
    assert sorted(xp[1][xp[1] != 0].tolist()) == x[1].tolist()


@pytest.mark.parametrize("M", [1, 8, 17])
@pytest.mark.parametrize("K,g,N", CASES)
def test_permuted_route_equals_the_oracle(M, K, g, N):
    # GIVEN a group that takes the permuted route
    assert mm.float_scale_route(K, g, mm._MAX_BIG_GROUP, 32 * 32) == "permuted"
    x_q, xs, w, s, x = _case(M, K, N, g, M + K + g)
    t = [torch.from_numpy(a) for a in (x_q, xs, w, s)]
    plan = mm.w4a8_plan(M, K, N, g)
    assert plan.permuted and plan.fold == ("tree" if K // g > 1024 else plan.fold)
    # WHEN row 16's arithmetic is written out under its plan: the permuted
    # x, each stage's pieces and masked int32 products, the fold
    got = mm.w4a8_perm_fold(*t, g, torch.float32, plan)
    # THEN it is the jitted JAX oracle and the port's plain version, bit for
    # bit (and so is its bf16 rounding)
    np.testing.assert_array_equal(got.numpy(), np.asarray(_jax_w4a8(M, K, N, g)(x_q, xs, w, s)))
    assert torch.equal(got, mm.matmul_w4a8_reference(*t, None, g, torch.float32))
    assert torch.equal(mm.w4a8_perm_fold(*t, g, torch.bfloat16, plan),
                       mm.matmul_w4a8_reference(*t, None, g, torch.bfloat16))
    # AND rows 17 and 18t's arithmetic (each byte row's weight dequantized
    # with its stage's scale row: one rounding, or 18t's two) is within
    # W4_GEMV_RTOL of their plain versions
    xb = torch.from_numpy(x).to(torch.bfloat16)
    for tiled, ref in ((False, mm.matmul_w4_gemv_reference(xb, t[2], t[3], g, torch.float32)),
                       (True, mm.matmul_w4a16_tiled_reference(xb, t[2], t[3], None, g,
                                                              torch.float32))):
        out = mm.w4_perm_product(xb, t[2], t[3], g, tiled)
        assert (out - ref).abs().max() <= W4_GEMV_RTOL * ref.abs().max()


@pytest.mark.parametrize("K,g,N", CASES)
def test_stage_pieces_cover_every_group_once(K, g, N):
    # GIVEN row 16's plan at the group (its splits: the oracle's windows)
    h, G = g // 2, K // g
    plan = mm.w4a8_plan(8, K, N, g)
    box = mm.perm_scale_box(K, g)
    for g0, g1 in plan.group_ranges(G):
        r0, r1 = g0 * h // 16, -(-g1 * h // 16)
        rows = {p: [] for p in range(g0, g1)}
        closed = []
        for st in range(-(-(r1 - r0) // 4)):
            b0 = 16 * r0 + 64 * st
            scale_rows = mm.perm_stage_scale_rows(b0, K, g)
            for q, p, a0, a1, closes in mm.perm_stage_pieces(b0, g, g0, g1):
                rows[p] += list(range(b0 + 16 * q + a0, b0 + 16 * q + a1))
                # THEN a piece's rows are its group's, and the stage's box
                # holds its scale row
                assert all(b // h == p for b in rows[p][-(a1 - a0):])
                assert p - b0 // h < box
                assert all(scale_rows[b - b0] == p for b in range(b0 + 16 * q + a0,
                                                                 b0 + 16 * q + a1))
                if closes:
                    closed.append(p)
        # AND each group of the split is covered once, in order, and closed
        # once, in group order (the fold's order)
        assert all(rows[p] == list(range(p * h, (p + 1) * h)) for p in rows)
        assert closed == list(range(g0, g1))


def test_group_division_is_exact():
    # the kernels' scale row of a byte row (`csrc/w4_wgmma.cuh` GroupDiv):
    # (rem + o) // h for rem < h, o < 64, by a compare where h >= 64 and by
    # a multiply by ceil(2^16 / h) and a shift where h < 64
    for h in range(1, 64):
        magic = (65536 + h - 1) // h
        n = np.arange(128)
        np.testing.assert_array_equal((n * magic) >> 16, n // h)
    for h in (64, 65, 96, 160, 4104, 1 << 15, 1 << 16):
        n = np.arange(h + 64)
        np.testing.assert_array_equal((n >= h).astype(int), n // h)
    # and the box holds every group a stage from any 16-row run touches
    for g in range(2, 700, 2):
        h, K = g // 2, 64 * g
        most = max((b0 % h + 63) // h + 1 for b0 in range(0, 16 * h * 16 + 1, 16))
        assert mm.perm_scale_box(K, g) == min(most, K // g)
        assert (h - math.gcd(16, h) + 63) // h + 1 == most


@pytest.mark.parametrize("name,g", [(n, g) for n in PROJ for g in (16, 8)] + [("down", 112)])
@pytest.mark.parametrize("M", [1, 8, 17, 192, 256])
def test_permuted_plans_fit_the_sm(name, g, M):
    # GIVEN a Llama-3-8B projection at a group the permuted route takes (g
    # 112 divides only down_proj's K)
    K, N = PROJ[name]
    p16, p17 = mm.w4a8_plan(M, K, N, g), mm.w4_plan(M, K, N, g)
    # THEN both rows plan it on the permuted route, with the scale rows of
    # every group a stage touches, in a ring that fits the SM
    for plan in (p16, p17):
        assert plan.permuted and plan.scale_bytes == mm.perm_scale_bytes(K, g)
        assert plan.smem_bytes <= SMEM_BUDGET[plan.per_sm]
    assert p17.depth >= min(2, p17.sps) and p16.depth >= min(2, p16.stages)
    # AND row 16 keeps its fold's token rows a block (the window tree at
    # most 16) and splits K only at the oracle's windows
    G = K // g
    assert p16.rows * p16.row_blocks >= M and p16.n <= (16 if G > 1024 else 96)
    assert p16.fold == ("chain" if G <= 32 else "window" if G <= 256 else
                        "multi" if G <= 1024 else "tree")
