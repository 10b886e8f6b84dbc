"""The int8 wgmma kernels of the float-scale modes (`csrc/int8_wgmma.cuh`:
the W8A8 GEMM, row 19, `csrc/w8a8_gemm.cu`; the W4A8 GEMV with f32 group
scales, row 16, `csrc/w4a8_halves.cu`), on the CPU.

Their plans: the W4A8 GEMV splits K only at the windows of the jitted
oracle's group sum (`w4a8_plan`: none up to 32 groups, one split a window
for 33-256 groups, e.g. 4 at Llama-3-8B's down_proj, K = 14,336 g128, and
2 at K = 1,056 g32), keeps at most 96 token rows a block, takes groups
of 128 j (j >= 2) up to g = K as j stages each (`stage_groups`, the
windows on stage boundaries), takes every other group the reference takes
on the permuted route (x in byte-row order: `float_scale_route`,
`tests/test_torch_float_scale_groups.py`), and refuses what the reference
does not take; the W8A8 GEMM's (`w8a8_plan`) covers every
stage once with no split empty. The GEMV's fold written out in torch under
its plan (`w4a8_split_fold`: each split's window summed from +0, then the
window sums in order) equals the port's plain version and the jitted JAX
oracle bit for bit. The A operand's byte transposition (ldmatrix of column
pairs from the 128B-swizzled rows, then byte permutes: `i8_operand_words`)
gives every column's bytes in k order, so the register words times x are
the dense int32 product; its W4A8 steps (`w4a8_step_operands`) hold 16 v
of each weight at the step's k. The GEMV's exact float conversion of a
group dot (no conversion instruction) is checked over its whole range.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastforward_tpu.kernels import matmul as jm
from fastforward_tpu_torch.kernels import matmul as mm
from fastforward_tpu_torch.kernels.packing import unpack_int4

EXACT = {"xla_allow_excess_precision": False}
SMEM_BUDGET = {1: 233472 - 1024, 2: 233472 // 2 - 1024}  # an H100 SM's shared memory a block
# Llama-3-8B's four fused projections and lm_head (K, N), g128
SHAPES = {"qkv": (4096, 6144), "o": (4096, 4096), "gate_up": (4096, 28672),
          "down": (14336, 4096), "lm_head": (4096, 128256)}
DECODE_M = [1, 7, 8, 17, 64, 96, 97, 128, 129, 192, 193, 256]


def _windows(G):
    """The windows of the jitted oracle's sum over G groups: 32 wide, the
    first shortened by the smaller half of the padding to a multiple of 32."""
    lo = (-(-G // 32) * 32 - G) // 2
    return [(max(0, 32 * z - lo), min(G, 32 * (z + 1) - lo)) for z in range(-(-G // 32))]


@pytest.mark.parametrize("name", list(SHAPES))
@pytest.mark.parametrize("M", DECODE_M)
def test_w4a8_plan_splits_only_at_windows(name, M):
    K, N = SHAPES[name]
    plan = mm.w4a8_plan(M, K, N, 128)
    G = K // 128
    ranges = plan.group_ranges(G)
    if G <= 32:  # qkv, o, gate/up, lm_head: one fused multiply-add chain
        assert plan.fold == "chain" and plan.n_split == 1 and ranges == [(0, G)]
    else:  # down_proj: 112 groups, windows 24-32-32-24, a cluster of 4
        assert plan.fold == "window" and plan.n_split == 4
        assert ranges == _windows(G) == [(0, 24), (24, 56), (56, 88), (88, 112)]
    # every group once, in order; the token rows of a block within the
    # kernel's registers and its wgmma n; every row block holds a row
    assert ranges[0][0] == 0 and ranges[-1][1] == G
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert plan.rows <= plan.n <= 96 and plan.n == mm.i8_tile(plan.rows)
    assert plan.rows * plan.row_blocks >= M > (plan.row_blocks - 1) * plan.rows
    assert plan.stages == max(-(-(g1 - g0) // 1) for g0, g1 in ranges)
    assert 1 <= plan.depth <= 8 and plan.depth >= min(2, plan.stages)
    assert plan.smem_bytes <= SMEM_BUDGET[plan.per_sm]


@pytest.mark.parametrize("K,g,splits", [(1056, 32, 2), (4096, 32, 4), (4096, 64, 2),
                                        (4096, 128, 1), (1024, 32, 1), (2560, 64, 2),
                                        (8192, 32, 8), (8448, 32, 1), (32768, 32, 1)])
def test_w4a8_plan_window_splits_at_other_groups(K, g, splits):
    # K = 1,056 at g32: 33 groups, windows of 17 and 16 (the first
    # shortened by 15 of the 31 padding groups); beyond 256 groups (8448,
    # 32768 at g32) one block walks every window, with three sets of sums
    G = K // g
    plan = mm.w4a8_plan(192, K, 260, g)
    assert plan.n_split == splits
    if G <= 32:
        assert plan.fold == "chain"
    elif splits > 1:
        assert plan.fold == "window" and plan.group_ranges(G) == _windows(G)
        assert plan.lo == (-(-G // 32) * 32 - G) // 2
    else:
        assert plan.fold == "multi" and plan.n <= 64 and plan.group_ranges(G) == [(0, G)]
    if K == 1056:
        assert plan.group_ranges(G) == [(0, 17), (17, 33)]
    gps = 128 // g
    assert plan.stages == max(-(-(g1 - g0) // gps) for g0, g1 in plan.group_ranges(G))


@pytest.mark.parametrize("args", [(0, 4096, 64, 128), (257, 4096, 64, 128), (8, 4096, 64, 3),
                                  (8, 4096, 64, 0), (8, 2 * (32 ** 6 + 1), 64, 2),
                                  (8, 4000, 64, 128), (8, 4096, 66, 128), (8, 64, 64, 128),
                                  (8, 4096, 64, -2)])
def test_w4a8_plan_refuses_what_the_kernel_does_not_take(args):
    # no row, more than the GEMV's 256 rows, an odd group, no group, more
    # than the window tree's 32^6 groups (K then passes C's int), K not
    # whole groups, N % 4 != 0, K below a group, a negative group
    with pytest.raises(ValueError):
        mm.w4a8_plan(*args)


@pytest.mark.parametrize("name", list(SHAPES))
@pytest.mark.parametrize("g", [256, 512, "K"])
@pytest.mark.parametrize("M", [1, 8, 192, 256])
def test_w4a8_plan_at_large_groups(name, g, M):
    # GIVEN a Llama-3-8B projection at g 256, 512 or g = K (the loader's
    # fallback), which the GEMV now takes
    K, N = SHAPES[name]
    g = K if g == "K" else g
    assert mm.wgmma_group_ok(K, g) and mm.float_scale_route(K, g) == "direct"
    plan = mm.w4a8_plan(M, K, N, g)
    assert not plan.permuted
    G = K // g
    # THEN a group spans g / 128 stages and a stage holds one group's scale row
    gps, spg = mm.stage_groups(g)
    assert (gps, spg) == (1, g // 128)
    # AND K splits only at the oracle's windows (down_proj at g256: 56
    # groups, windows 28-28), each window starting on a stage boundary
    ranges = plan.group_ranges(G)
    assert ranges[0][0] == 0 and ranges[-1][1] == G
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    if G <= 32:
        assert plan.fold == "chain" and ranges == [(0, G)]
    else:
        assert plan.fold == "window" and ranges == _windows(G)
    assert all(g0 * g % 128 == 0 for g0, _ in ranges)
    # AND the longest split streams its groups' stages, the ring fits
    assert plan.stages == max((g1 - g0) * spg for g0, g1 in ranges)
    assert plan.rows <= plan.n <= 96 and plan.rows * plan.row_blocks >= M
    assert 2 <= plan.depth <= 8 and plan.smem_bytes <= SMEM_BUDGET[plan.per_sm]


@pytest.mark.parametrize("g", [32, 64, 128, 256, 512, 4096])
def test_stage_groups_cover_a_stage_or_a_group(g):
    gps, spg = mm.stage_groups(g)
    assert gps * g == 128 * spg  # a stage's k, or a group's stages
    assert (gps == 1) or (spg == 1)


@pytest.mark.parametrize("name", list(SHAPES))
@pytest.mark.parametrize("M", DECODE_M + [24576])
def test_w8a8_plan_covers_every_stage(name, M):
    K, N = SHAPES[name]
    plan = mm.w8a8_plan(M, K, N)
    stages = -(-K // 128)
    ranges = plan.stage_ranges()
    assert ranges[0][0] == 0 and ranges[-1][1] == stages
    assert all(a[1] == b[0] < b[1] for a, b in zip(ranges, ranges[1:]))  # none empty
    assert 1 <= plan.n_split <= 8 and plan.n <= 192
    if M <= 192:  # every token row on wgmma's n side: each weight byte read once
        assert plan.m_tiles == 1 and plan.n == mm.i8_tile(M)
    else:
        assert plan.n * plan.m_tiles >= M > plan.n * (plan.m_tiles - 1)
    assert plan.depth >= min(2, plan.sps) and plan.smem_bytes <= SMEM_BUDGET[plan.per_sm]


@pytest.mark.parametrize("args", [(0, 4096, 64), (8, 40, 64), (8, 4096, 66), (8, 8, 64)])
def test_w8a8_plan_refuses_what_the_kernel_does_not_take(args):
    with pytest.raises(ValueError):
        mm.w8a8_plan(*args)


@functools.lru_cache(maxsize=None)
def _jax_w4a8(M, K, N, g):
    """The JAX oracle jitted and compiled with EXACT for one shape (f32 out)."""
    f = jax.jit(lambda q, xs, w, s: jm.matmul_w4a8_reference(q, xs, w, s, None, g, jnp.float32))
    spec = (jax.ShapeDtypeStruct((M, K), jnp.int8), jax.ShapeDtypeStruct((M,), jnp.float32),
            jax.ShapeDtypeStruct((K // 2, N), jnp.int8),
            jax.ShapeDtypeStruct((K // g, N), jnp.float32))
    return f.lower(*spec).compile(compiler_options=EXACT)


def _w4a8_case(M, K, N, g, seed):
    rng = np.random.RandomState(seed)
    w = rng.randint(-128, 128, (K // 2, N)).astype(np.int8)
    s = (rng.rand(K // g, N) * 0.05 + 1e-3).astype(np.float32)
    x_q = rng.randint(-127, 128, (M, K)).astype(np.int8)
    xs = (rng.rand(M) * 0.02 + 1e-4).astype(np.float32)
    return x_q, xs, w, s


@pytest.mark.parametrize("M", [1, 8, 192])
@pytest.mark.parametrize("K,g", [(4096, 128), (14336, 128), (1056, 32), (2560, 64), (8448, 32),
                                 (2048, 256), (2048, 512), (1024, 1024), (12288, 256)])
def test_split_fold_equals_the_oracle(M, K, g):
    # GIVEN W4A8 weights of 32 groups (the chain), 112, 33 and 40 (window
    # splits) and 264 (every window in one block); and groups that span
    # several stages: 8, 4 and 1 (g = K) groups, and 48 at g256 (windows)
    N = 12
    x_q, xs, w, s = _w4a8_case(M, K, N, g, M + K)
    t = [torch.from_numpy(a) for a in (x_q, xs, w, s)]
    # WHEN the kernel's fold is written out under its plan
    got = mm.w4a8_split_fold(*t, g, torch.float32)
    # THEN it is the port's plain version and the jitted JAX oracle, bit for
    # bit (and so is its bf16 rounding)
    ref = mm.matmul_w4a8_reference(*t, None, g, torch.float32)
    jax_out = np.asarray(_jax_w4a8(M, K, N, g)(x_q, xs, w, s))
    assert torch.equal(got, ref)
    np.testing.assert_array_equal(got.numpy(), jax_out)
    assert torch.equal(mm.w4a8_split_fold(*t, g, torch.bfloat16),
                       mm.matmul_w4a8_reference(*t, None, g, torch.bfloat16))


def _swizzle_rows(lane):
    """The k row (of a 32-row run) lane ``lane`` addresses for ldmatrix
    (`csrc/int8_wgmma.cuh` lane_of)."""
    r, j = lane % 8, lane // 8
    return 16 * (j // 2) + 4 * (r // 2) + 2 * ((j % 2) ^ (r // 4)) + r % 2


def test_ldmatrix_rows_are_conflict_free_and_cover_the_run():
    # each matrix's 8 rows sit in 8 distinct 16-byte chunks of the 128B
    # swizzle (row k's chunk c at c ^ (k % 8)), and the 32 lanes address
    # each of the run's 32 rows once
    rows = [_swizzle_rows(lane) for lane in range(32)]
    assert sorted(rows) == list(range(32))
    for j in range(4):
        assert len({rows[8 * j + r] % 8 for r in range(8)}) == 8


@pytest.mark.parametrize("seed", [0, 1])
def test_operand_words_give_the_dense_product(seed):
    # GIVEN a (K, N) int8 weight, staged 128 k rows at a time as TMA lands
    # them, and int8 activations
    rng = np.random.RandomState(seed)
    K, N, M = 256, 128, 5
    w = torch.from_numpy(rng.randint(-128, 128, (K, N)).astype(np.int8))
    x = torch.from_numpy(rng.randint(-128, 128, (M, K)).astype(np.int8)).long()
    acc = torch.zeros((M, N), dtype=torch.int64)
    for k0 in range(0, K, 128):
        # WHEN each thread's A register words are built (words[b, c, tid]:
        # column c, rows 16 b + 4 tid ..)
        words = mm.i8_operand_words(w[k0:k0 + 128])
        for t in range(4):  # k32 step t: slots 4 tid + i, then 16 + 4 tid + i
            lo, hi = words[2 * t], words[2 * t + 1]  # (128, 4)
            for tid in range(4):
                for i in range(4):
                    for half, reg in ((0, lo), (16, hi)):
                        byte = (reg[:, tid] >> (8 * i)) & 0xFF
                        v = torch.where(byte >= 128, byte - 256, byte)
                        k = k0 + 32 * t + half + 4 * tid + i
                        acc += x[:, k:k + 1] * v[None, :]
    # THEN the register words times x are the dense int32 product
    assert torch.equal(acc, x @ w.long())


@pytest.mark.parametrize("g", [32, 64, 128])
def test_w4a8_steps_hold_16v_at_their_k(g):
    rng = np.random.RandomState(g)
    rows = torch.from_numpy(rng.randint(-128, 128, (64, 128)).astype(np.int8))
    v = unpack_int4(rows, g)  # (128, 128): the stage's k rows
    steps = mm.w4a8_step_operands(mm.i8_operand_words(rows), g)
    assert len(steps) == 4  # 128 k: four k32 steps
    assert sorted(k for _, k, _ in steps) == [0, 32, 64, 96]
    for q, k, slots in steps:
        assert k // g == q  # a step lies in one group
        assert torch.equal(slots, 16 * v[k:k + 32].T.long())


def test_group_dot_conversion_is_exact():
    # the GEMV turns acc = 16 gd (|acc| < 2^22) into the float gd by adding
    # acc to the bits of 1.5 * 2^23 and one fused multiply-add by 1/16
    # minus 1.5 * 2^19 (csrc/w4a8_halves.cu group_dot): exact everywhere,
    # the extremes of int8 x 16 v over a group of 128 included
    top = 16 * 8 * 128 * 128
    acc = np.concatenate([np.arange(-4096, 4097), np.array([top, -top, top - 16, 1 - top]),
                          np.random.RandomState(3).randint(-top // 16, top // 16, 20000) * 16])
    acc = acc.astype(np.int32)
    t = (acc + np.int32(0x4B400000)).view(np.float32).astype(np.float64)
    got = (t * 0.0625 - 786432.0).astype(np.float32)  # every step exact in float64 and float32
    np.testing.assert_array_equal(got, (acc / 16).astype(np.float32))


# (K, g): the groups of 32, 64, 128 and 128 j that the tensor-core kernels
# take, and others the reference takes (g even, K a whole number of groups)
_WGMMA_GROUPS = [(4096, 32), (4096, 64), (4096, 128), (4096, 256), (14336, 512), (4096, 4096),
                 (14336, 14336)]
_ANY_GROUPS = [(64, 2), (4096, 16), (1536, 48), (1536, 96), (14336, 112), (192, 192), (384, 192),
               (320, 320), (4160, 320), (2880, 320), (14336, 448)]


@pytest.mark.parametrize("K,g", _WGMMA_GROUPS + _ANY_GROUPS)
def test_group_predicates_split_the_routes(K, g):
    # GIVEN a group the reference takes at depth K
    assert mm.float_scale_group_ok(K, g)
    direct = (K, g) in _WGMMA_GROUPS
    # THEN the predicate of x as it lies takes exactly the first list, and
    # the route is chosen by shape alone: x as it lies, or x permuted into
    # byte-row order
    assert mm.wgmma_group_ok(K, g) == direct
    assert mm.float_scale_route(K, g) == ("direct" if direct else "permuted")
    # AND every one of them has a tensor-core plan, on that route, whose
    # ring fits the SM's shared memory
    for M in (1, 8, 192):
        for plan in (mm.w4a8_plan(M, K, 4096, g), mm.w4_plan(M, K, 4096, g)):
            assert plan.permuted == (not direct) and plan.depth >= 1
            assert plan.smem_bytes <= SMEM_BUDGET[plan.per_sm]


@pytest.mark.parametrize("K,g", [(96, 3), (192, 0), (96, 192), (100, 16), (4096, 7)])
def test_group_predicates_refuse_what_the_reference_does_not_take(K, g):
    # an odd group, no group, a group above K, K not whole groups
    assert not mm.float_scale_group_ok(K, g) and not mm.wgmma_group_ok(K, g)
    with pytest.raises(ValueError, match="group"):
        mm.float_scale_route(K, g)


def test_row_16_route_keeps_its_int32_group_limit():
    # row 16's direct route sums 16 v a group in int32 up to g = 2^16; a
    # larger multiple of 128 takes the permuted route, which widens each
    # stage's int32 partial into an int64 dot (at most 32 token rows a block)
    g = 1 << 17
    assert mm.float_scale_route(g, g) == "direct"
    assert mm.float_scale_route(g, g, max_group=1 << 16) == "permuted"
    assert mm.float_scale_route(1 << 16, 1 << 16, max_group=1 << 16) == "direct"
    plan = mm.w4a8_plan(8, g, 4096, g)
    assert plan.permuted and plan.fold == "chain" and plan.n == 8
    assert mm.w4a8_plan(256, g, 4096, g).n <= 32
    assert not mm.w4a8_plan(8, 1 << 16, 4096, 1 << 16).permuted
    # and its direct fold takes at most 32 x 32 groups: more take the
    # permuted route's window tree (at most 16 token rows a block)
    assert mm.float_scale_route(32 * 1024, 32, max_groups=1024) == "direct"
    assert mm.float_scale_route(32 * 1025, 32, max_groups=1024) == "permuted"
    plan = mm.w4a8_plan(192, 32 * 1025, 4096, 32)
    assert plan.permuted and plan.fold == "tree" and plan.n <= 16
    assert mm.w4a8_plan(192, 32 * 1024, 4096, 32).fold == "multi"
    # the tree goes as deep as K allows (g 2 beyond 32^4 groups: five of its
    # six levels, 8 rows a block)
    plan = mm.w4a8_plan(192, 2 * (32 ** 4 + 1), 64, 2)
    assert plan.permuted and plan.fold == "tree" and plan.n == 8 and plan.depth >= 1
    # and the int64 dots above 2^16 take every fold: every window in one
    # block at 257 groups (at most 32 rows a block), the tree at 1,025 (8)
    plan = mm.w4a8_plan(256, 257 << 17, 64, 1 << 17)
    assert plan.permuted and plan.fold == "multi" and plan.n <= 32
    plan = mm.w4a8_plan(256, 1025 * (1 << 17), 64, 1 << 17)
    assert plan.permuted and plan.fold == "tree" and plan.n == 8


@pytest.mark.parametrize("n", [1, 5, 31, 32, 33, 100, 1024, 1025, 1056, 2047, 33000])
def test_window_tree_sum_is_the_oracles_order(n):
    # the permuted route's streaming window tree (one term at a time, a
    # window's sum sent up a level as the next window starts) against the
    # oracle's order written out (`_window_sum`: padded windows, recursing)
    t = torch.from_numpy(np.random.RandomState(n).randn(3, n).astype(np.float32) * 100)
    assert torch.equal(mm.window_tree_sum(t), mm._window_sum(t))
