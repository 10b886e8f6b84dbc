"""The int8 tensor-core tile of the two-level W4A8 GEMV (`csrc/w4a8_mma.cuh`)
on the CPU: its fold, its split plan and its ring depth, held against
`fastforward_tpu.kernels.matmul`.

The tile folds each group's multiplier into the nibbles (the TPU kernels'
SWAR fold), multiplies int8 bytes into int32 sums over the K ranges of its
split plan and adds the splits in order before the oracle's epilogue. Here
that arithmetic is written out in torch integer ops (`fold_w4a8_2l_words`,
`mma_plan`) and compared with the JAX oracle and the JAX GEMV on the CPU.
Tolerance: none — integer sums and one float epilogue, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastforward_tpu.kernels import matmul as jm
from fastforward_tpu_torch.kernels import matmul as tm

# Llama-3-8B's shapes on the serve runs: (K, N, group, paired)
LM_HEAD = [(4096, 128256, 512, True), (4096, 128256, 128, True), (4096, 128256, 128, False)]
LAYER_PROJ = [(K, N, 128, False) for K, N in ((4096, 4096), (4096, 1024), (4096, 14336),
                                              (14336, 4096))]
PROJ = [(K, N, 128, True) for K, N in ((4096, 6144), (4096, 4096), (4096, 28672),
                                       (14336, 4096))]


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)


def test_fold_words_gives_m_times_v_for_every_nibble_and_multiplier():
    # GIVEN every (u, m) pair, u in [0, 15] and m in [1, 15], in every byte
    # position of a word, the other nibbles random, and a second multiplier
    # for the high plane
    rs = np.random.RandomState(0)
    u, m, pos = np.meshgrid(np.arange(16), np.arange(1, 16), np.arange(4), indexing="ij")
    u, m, pos = u.ravel(), m.ravel(), pos.ravel()
    lo = rs.randint(0, 16, (u.size, 4))
    hi = rs.randint(0, 16, (u.size, 4))
    lo[np.arange(u.size), pos] = u
    hi[np.arange(u.size), pos] = 15 - u
    m_hi = 16 - m
    words = ((lo | (hi << 4)).astype(np.uint32) << (8 * np.arange(4))).sum(1).astype(np.uint32)
    # WHEN folded
    flo, fhi = tm.fold_w4a8_2l_words(torch.from_numpy(words.view(np.int32)),
                                     torch.from_numpy(m), torch.from_numpy(m_hi))
    # THEN every byte of the low plane is m * (u - 8), of the high plane
    # m_hi * (u_hi - 8), as signed bytes
    assert flo.dtype == torch.int32 and fhi.dtype == torch.int32
    blo = flo.numpy().view(np.int8).reshape(-1, 4)
    bhi = fhi.numpy().view(np.int8).reshape(-1, 4)
    np.testing.assert_array_equal(blo, m[:, None] * (lo - 8))
    np.testing.assert_array_equal(bhi, m_hi[:, None] * (hi - 8))
    np.testing.assert_array_equal(blo[np.arange(u.size), pos], m * (u - 8))
    # and the group-halves form takes one multiplier for both planes
    flo1, fhi1 = tm.fold_w4a8_2l_words(torch.from_numpy(words.view(np.int32)),
                                       torch.from_numpy(m))
    np.testing.assert_array_equal(fhi1.numpy().view(np.int8).reshape(-1, 4), m[:, None] * (hi - 8))


def _tile_emulation(x_q, x_s, w_packed, mult, s_col, g, paired, out_dtype):
    """The tile's arithmetic: words of 4 byte rows of one column folded with
    their unit's multipliers, int8 products summed in int32 over each
    split's K range, the splits added in order, the oracle's epilogue."""
    M, K = x_q.shape
    N = w_packed.shape[1]
    plan = tm.mma_plan(M, K, N, g, "paired" if paired else "halves")
    ur = plan.unit_rows
    # (K/8, N) words, byte i of word (r, n) = byte row 4r + i of column n
    words = (w_packed.view(torch.uint8).reshape(K // 8, 4, N).permute(0, 2, 1).contiguous()
             .view(torch.int32).reshape(K // 8, N))
    unit = 4 * torch.arange(K // 8) // ur  # every word's 4 rows lie in one unit
    m_lo = mult[2 * unit if paired else unit].to(torch.int64)
    m_hi = mult[2 * unit + 1 if paired else unit].to(torch.int64)
    planes = []
    for f in tm.fold_w4a8_2l_words(words, m_lo, m_hi):
        planes.append(f.contiguous().view(torch.int8).reshape(K // 8, N, 4).permute(0, 2, 1)
                      .reshape(K // 2, N))
    q = torch.arange(K // 2)
    uq, iq = q // ur, q % ur
    k_lo = 2 * uq * g + iq if paired else uq * g + iq
    k_hi = (2 * uq + 1) * g + iq if paired else uq * g + g // 2 + iq
    w8 = torch.empty((K, N), dtype=torch.int64)
    w8[k_lo], w8[k_hi] = planes[0].long(), planes[1].long()
    acc = torch.zeros((M, N), dtype=torch.int64)
    covered = 0
    for u0, u1 in plan.unit_ranges():
        k0, k1 = u0 * (2 * ur), u1 * (2 * ur)  # a unit's two planes: 2 * unit_rows k
        part = x_q[:, k0:k1].long() @ w8[k0:k1]
        acc += part
        assert acc.abs().max() < 2**31
        covered += k1 - k0
    assert covered == K
    return tm._epilogue(acc.to(torch.int32).float(), s_col, x_s, None, out_dtype)


def _inputs(M, K, N, g, seed, extreme=False):
    rs = np.random.RandomState(seed)
    w = rs.randint(-128, 128, (K // 2, N)).astype(np.int8)
    m = rs.randint(1, 16, (K // g, N)).astype(np.int8)
    s = (rs.rand(N) * 1e-2 + 1e-4).astype(np.float32)
    if extreme:  # the largest sums: x = +-127, m = 15, u = 0 or 15 in both planes
        x_q = np.where(rs.rand(M, K) < 0.5, 127, -127).astype(np.int8)
        x_s = (rs.rand(M) + 0.5).astype(np.float32)
        w = np.where(rs.rand(K // 2, N) < 0.5, 0, -1).astype(np.int8)
        m[:] = 15
        s *= 1e-4
        return w, m, s, (jnp.asarray(x_q), jnp.asarray(x_s)), (torch.from_numpy(x_q),
                                                               torch.from_numpy(x_s))
    x = (rs.randn(M, K) * 3).astype(np.float32)
    qj = jax.jit(jm.quantize_rowwise)(jnp.asarray(x).astype(jnp.bfloat16))
    qt = tm.quantize_rowwise(torch.from_numpy(x).to(torch.bfloat16))
    return w, m, s, qj, qt


@pytest.mark.parametrize("paired,M,K,N,g,extreme", [
    (p, *case) for p in (True, False) for case in (
        (1, 2048, 48, 64, False),     # one tile: K split 8 ways
        (8, 1024, 300, 128, False),   # a ragged column tile
        (17, 512, 40, 8 - 4 * p, False),  # groups of 4 byte rows a plane (padded to 16)
        (72, 1024, 136, 32, False),   # 64-row blocks, a 16-row group plane (group halves)
        (72, 14336, 16, 128, True),   # the extreme sums at Llama-3-8B's down_proj K
    )])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_tile_arithmetic_equals_jax_reference_and_gemv(paired, M, K, N, g, extreme, out_dtype):
    # GIVEN two-level W4A8 weights in either layout and int8 activations
    w, m, s, (qj, sj), (qt, st) = _inputs(M, K, N, g, seed=M + K + paired, extreme=extreme)
    jd, td = getattr(jnp, out_dtype), getattr(torch, out_dtype)
    wt = torch.from_numpy(w)
    # WHEN the tile's arithmetic runs in torch and the JAX oracle and GEMV
    # run on the same integers
    out = _tile_emulation(qt, st, wt, torch.from_numpy(m), torch.from_numpy(s), g, paired, td)
    ref = jm.matmul_w4a8_2l_reference(qj, sj, jnp.asarray(w), jnp.asarray(m), jnp.asarray(s),
                                      None, g, jd, paired=paired)
    gemv = jm.matmul_w4a8_2l_gemv(qj, sj, jnp.asarray(w), jnp.asarray(m), jnp.asarray(s),
                                  group_size=g, out_dtype=jd, paired=paired)
    # THEN all three agree bit for bit, and the port's plain GEMV with them
    np.testing.assert_array_equal(_np(out), _np(ref))
    np.testing.assert_array_equal(_np(out), _np(gemv))
    plain = tm.matmul_w4a8_2l_gemv(qt, st, wt, torch.from_numpy(m), torch.from_numpy(s), g, td,
                                   paired=paired)
    np.testing.assert_array_equal(_np(out), _np(plain))


@pytest.mark.parametrize("K,N,g,paired", LM_HEAD + LAYER_PROJ + PROJ)
def test_split_plan_and_ring_cover_every_group_and_fit(K, N, g, paired):
    # GIVEN a serve run's shape at every row count of the GEMV (1-256)
    n_groups = K // g
    for M in range(1, 257):
        plan = tm.mma_plan(M, K, N, g, "paired" if paired else "halves")
        # THEN the splits cover every unit, hence every group, once and in order
        ranges = plan.unit_ranges()
        assert len(ranges) == plan.n_split and all(u0 < u1 for u0, u1 in ranges)
        units = [u for u0, u1 in ranges for u in range(u0, u1)]
        assert units == list(range(plan.n_units))
        groups = sorted(gr for u in units for gr in ((2 * u, 2 * u + 1) if paired else (u,)))
        assert groups == list(range(n_groups))
        # the kernel derives the same units a split from n_split
        assert plan.ups == -(-plan.n_units // plan.n_split)
        # every padded row of a split lies in its stages; the blocks cover M
        assert plan.stages * tm._MMA_ROWS >= plan.ups * plan.p16 > (plan.stages - 1) * tm._MMA_ROWS
        assert plan.mt == tm.mma_tiles(M) and (plan.m_tiles - 1) * 16 * plan.mt < M
        assert plan.m_tiles * 16 * plan.mt >= M and plan.n_tiles * tm._MMA_N >= N
        assert plan.x_bytes == (plan.m_tiles * plan.n_split * plan.stages
                                * (tm._MMA_ROWS // 32) * 2 * plan.mt * tm._MMA_FRAG)
        for nbuf in range(2, 9):
            depth = tm.manual_depth(plan, nbuf)
            # AND the ring fits the 227 KB a block may use
            assert 1 <= depth <= min(nbuf, plan.stages)
            assert depth * (plan.stage_bytes + 16) + tm._MMA_SLACK <= 232448
