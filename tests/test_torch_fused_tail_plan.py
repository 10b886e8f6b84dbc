"""The plan of the fused W4A8 layer tail (`csrc/fused_tail.cu`, rows 10 and
11) on the CPU.

The tail runs its three products (its o + gate/up head two) on the int8
tensor-core tile (`csrc/w4a8_mma.cuh`), each planned by `mma_plan` on the
paired layout (unsplit where its tiles already cover the SMs), with a row
kernel between each two that stages the next
product's int8 operand in the tile's fragment order (`stage_row`, which
`mma_staged_operand` mirrors). `tail_plan` holds the three plans, their
ring depths and the one scratch buffer of a call. Here, at Llama-3-8B's
widths (M = 1-64 for the tail, 1-256 for the head) and at the card tests'
odd shapes: every product's splits cover each group pair once; the
scratch regions are disjoint, 256-byte aligned and in the C entry's
argument order; the staged operands are sized as the plans say; and the
staged bytes sit where the tile's consumer warps read them (its A
fragments, decoded here from the mma.sync operand layout), zeros elsewhere.
"""

import numpy as np
import pytest
import torch

from fastforward_tpu_torch.kernels import matmul as mm

H, INTER, G = 4096, 14336, 128  # Llama-3-8B, g128
STAGE_ROWS, CHUNKS, FRAG = 64, 2, 512  # csrc/w4a8_mma.cuh kR, kChunks, kFrag
SMEM_MAX = 232448
SMS = 132  # the H100's SMs

# (M, K1, H, N_GU, group, full): the tail at the engine's rows, the head up
# to FUSED_OGU_MAX_ROWS, and the odd shapes of the card tests
CASES = [(M, H, H, 2 * INTER, G, True) for M in (1, 8, 32, 64)] + \
        [(M, H, H, 2 * INTER, G, False) for M in (1, 64, 192, 256)]
ODD = [(5, 512, 256, 768, 64, True), (33, 256, 256, 1024, 32, True),
       (72, 2048, 1024, 768, 512, False)]


def _ids(case):
    M, K1, h, n_gu, g, full = case
    return f"{'tail' if full else 'head'}-M{M}-K{K1}-H{h}-gu{n_gu}-g{g}"


def _shapes(K1, h, n_gu, full):
    return [(K1, h), (h, n_gu)] + ([(n_gu // 2, h)] if full else [])


@pytest.mark.parametrize("case", CASES + ODD, ids=_ids)
def test_every_product_covers_each_group_pair_once(case):
    # GIVEN a fused call's shape
    M, K1, h, n_gu, g, full = case
    plan = mm.tail_plan(M, K1, h, n_gu, g, full)
    shapes = _shapes(K1, h, n_gu, full)
    # THEN it plans each product in launch order as the tile's paired GEMV,
    # unsplit where its (m, n) tiles already give every SM a block
    assert len(plan.plans) == len(plan.depths) == len(shapes)
    for p, depth, (K, N) in zip(plan.plans, plan.depths, shapes):
        own = mm.mma_plan(M, K, N, g, "paired")
        assert p == (own if own.m_tiles * own.n_tiles < SMS
                     else mm.mma_plan(M, K, N, g, "paired", 1))
        if N == 2 * INTER:  # Llama-3-8B's gate/up: 224 column tiles
            assert p.n_split == 1
        assert (p.unit_rows, p.n_units) == (g, K // (2 * g))
        # whose splits cover every group pair once, in order, none empty
        covered = [u for a, b in p.unit_ranges() for u in range(a, b)]
        assert covered == list(range(K // (2 * g)))
        assert all(b > a for a, b in p.unit_ranges())
        # and whose ring fits a block's shared memory
        assert 1 <= depth <= min(4, p.stages)
        assert depth * (p.stage_bytes + 16) + 1024 <= SMEM_MAX
    assert plan.splits == tuple(p.n_split for p in plan.plans)


@pytest.mark.parametrize("case", CASES + ODD[:1], ids=_ids)
def test_scratch_regions_are_disjoint_aligned_and_in_argument_order(case):
    M, K1, h, n_gu, g, full = case
    plan = mm.tail_plan(M, K1, h, n_gu, g, full)
    names = [r[0] for r in plan.regions]
    # THEN the regions follow the C entry's scratch arguments
    assert names == (["xs", "scales", "x1", "hq", "x2", "xf_o", "xf_gu", "xf_dn", "partial"]
                     if full else ["xs", "scales", "hq", "xf_o", "xf_gu", "partial"])
    # each 256-byte aligned, none overlapping another, all inside the buffer
    spans = sorted((off, off + size) for _, off, size in plan.regions)
    assert all(off % 256 == 0 for off, _ in spans)
    assert all(end <= nxt for (_, end), (nxt, _) in zip(spans, spans[1:]))
    assert spans[-1][1] <= plan.total and plan.total % 256 == 0
    size = {name: s for name, _, s in plan.regions}
    want = {"xs": 4 * M, "scales": 8 * M, "hq": M * h}
    if full:
        want.update(x1=4 * M * h, x2=M * (n_gu // 2))
    assert {k: size[k] for k in want} == want
    # the partials of the largest product that hands them to a row kernel
    raw = [p.n_split * M * N for p, (_, N) in zip(plan.plans, _shapes(K1, h, n_gu, full))]
    if not full and plan.plans[1].n_split == 1:
        raw[1] = 0  # the head's unsplit gate/up writes bf16 gu itself
    assert size["partial"] == 4 * max(raw)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_staged_operands_are_sized_as_their_plans(case):
    M, K1, h, n_gu, g, full = case
    plan = mm.tail_plan(M, K1, h, n_gu, g, full)
    size = {name: s for name, _, s in plan.regions}
    rs = np.random.RandomState(M)
    for name, p, (K, _) in zip(("xf_o", "xf_gu", "xf_dn"), plan.plans,
                               _shapes(K1, h, n_gu, full)):
        assert size[name] == p.x_bytes
        q = torch.from_numpy(rs.randint(-128, 128, (M, K)).astype(np.int8))
        assert mm.mma_staged_operand(q, p, g, "paired").shape == (p.x_bytes,)


def _tile_reads(plan, M, K, g):
    """(row, k) the tile's consumer warps take from each byte of the staged
    operand, (-1, -1) for a byte that must be zero: fragment f = ((((m_tile
    * n_split + split) * stages + s) * chunks + c) * 2 + plane) * mt + t;
    lane 4 gid + tid's register r holds A[gid + 8 (r % 2)][16 (r // 2) + 4
    tid + i] (mma.m16n8k32 .s8), and slot 16 h + 4 t + i of chunk c is its
    byte row 32 c + 16 h + 2 t + (i & 1) + 8 (i >> 1), in a split's padded
    rows; byte row i of pair u holds k = (2u + plane) g + i (paired)."""
    pos = np.arange(plan.x_bytes)
    byte, lane, f = pos % 16, pos % FRAG // 16, pos // FRAG
    reg, i = byte // 4, byte % 4
    gid, tid = lane // 4, lane % 4
    t, rest = f % plan.mt, f // plan.mt
    plane, rest = rest % 2, rest // 2
    c, rest = rest % CHUNKS, rest // CHUNKS
    s, rest = rest % plan.stages, rest // plan.stages
    split, m_tile = rest % plan.n_split, rest // plan.n_split
    row = (m_tile * plan.mt + t) * 16 + gid + 8 * (reg % 2)
    h = reg // 2
    q = s * STAGE_ROWS + 32 * c + 16 * h + 2 * tid + (i & 1) + 8 * (i >> 1)
    u, ui = split * plan.ups + q // plan.p16, q % plan.p16
    live = (u < np.minimum(plan.n_units, (split + 1) * plan.ups)) & (ui < plan.unit_rows) \
        & (row < M)
    k = (2 * u + plane) * g + ui
    return np.where(live, row, -1), np.where(live, k, -1)


@pytest.mark.parametrize("case", CASES[1:3] + CASES[5:7] + ODD, ids=_ids)
def test_staged_bytes_sit_where_the_tile_reads_them(case):
    # GIVEN the int8 rows the row kernels stage (xq, hq and x2)
    M, K1, h, n_gu, g, full = case
    plan = mm.tail_plan(M, K1, h, n_gu, g, full)
    rs = np.random.RandomState(M + K1)
    for p, (K, _) in zip(plan.plans, _shapes(K1, h, n_gu, full)):
        q = rs.randint(-128, 128, (M, K)).astype(np.int8)
        staged = mm.mma_staged_operand(torch.from_numpy(q), p, g, "paired").numpy()
        rows, ks = _tile_reads(p, M, K, g)
        live = rows >= 0
        # THEN every byte the tile multiplies is that row's activation at
        # that k, every other byte zero, and each (row, k) read exactly once
        assert np.array_equal(staged[live], q[rows[live], ks[live]])
        assert not staged[~live].any()
        seen = np.bincount(rows[live] * K + ks[live], minlength=M * K)
        assert (seen == 1).all()
