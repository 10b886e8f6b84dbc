"""The two-level GEMVs at every group their JAX functions serve, on the CPU.

The card's tensor-core tile takes a unit of 4 byte rows a plane (paired
groups a multiple of 4, vertical and group-halves groups a multiple of 8)
and N % 4 == 0; every other group the references take runs the any-group
route on the same tensor cores (`two_level_route`, `rows_plan`), whose
arithmetic `two_level_rows_dot` mirrors. Here each wrapper's CPU path
(the plain version the card is held to) is held bit for bit against the
jitted JAX function on the same inputs, made with numpy from a seed, at
groups 2-14 and at 1,024 groups along K: rows 1 (A4 GEMV, f32 and bf16
out), 4 (argmax head), 5 (W4A8 GEMV, both layouts) and 9 (stacked GEMV,
flat and pre-blocked), and the fused heads, the o + gate/up head and the
fused tail at groups 2, 6 and 12 (JAX serves all three on the CPU; the
heads' and the tail's norms traced with a correctly rounded rsqrt, as in
`tests/test_torch_fused_heads.py`). It also holds the route choice.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastforward_tpu.kernels import matmul as jm
from fastforward_tpu.kernels import packing as jpk
from fastforward_tpu_torch.kernels import matmul as tm
from tests.test_torch_fused_heads import EXACT, _np, _stacked, rounded_rsqrt  # noqa: F401

GROUPS = list(range(2, 15))


def _jit(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=EXACT)(*args)


def _x(rs, M, K, a4=False):
    lo, hi = (-8, 8) if a4 else (-127, 128)
    x_q = rs.randint(lo, hi, (M, K)).astype(np.int8)
    x_s = (rs.rand(M) * 1e-2 + 1e-4).astype(np.float32)
    return x_q, x_s


def _weights(rs, K, N, g, L=None):
    lead = () if L is None else (L,)
    w = rs.randint(-128, 128, lead + (K // 2, N)).astype(np.int8)
    m = rs.randint(1, 16, lead + (K // g, N)).astype(np.int8)
    s = (rs.rand(*lead, N) * 1e-2 + 1e-4).astype(np.float32)
    return w, m, s


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("layout,K,N,g,route", [
    ("paired", 4096, 4096, 128, "tile"), ("paired", 8, 4, 2, "any"),
    ("paired", 48, 16, 12, "tile"), ("paired", 48, 18, 12, "any"),
    ("halves", 256, 64, 8, "tile"), ("halves", 256, 64, 4, "any"),
    ("halves", 48, 16, 12, "any"), ("vertical", 48, 16, 12, "any"),
    ("vertical", 4096, 6144, 512, "tile"), ("vertical", 54, 16, 3, "any"),
    ("vertical", 48, 16, 8, "tile"), ("vertical", 48, 14, 8, "any"),
])
def test_route_by_group_and_width(layout, K, N, g, route):
    # GIVEN a layout, a depth, a width and a group WHEN the route is chosen
    # THEN the tile takes units of 4 byte rows a plane and N % 4 == 0, the
    # CUDA-core loop every other group the reference takes
    assert tm.two_level_route(layout, K, N, g) == route


@pytest.mark.parametrize("layout,K,g", [
    ("paired", 20, 4), ("paired", 18, 6), ("halves", 30, 3), ("halves", 50, 4),
    ("vertical", 50, 4), ("vertical", 9, 3), ("bogus", 8, 2),
])
def test_route_refuses_what_the_reference_does_not_take(layout, K, g):
    # GIVEN a group the layout's packer cannot hold (an odd group-pair count,
    # an odd group of group halves, K not whole groups) THEN it raises
    with pytest.raises(ValueError):
        tm.two_level_route(layout, K, 16, g)


def _any_cases():
    for layout in tm.MMA_LAYOUTS:
        for g in range(1, 15):
            if layout == "halves" and g % 2:
                continue
            unit = 2 * g if layout == "paired" else g
            # K even, whole units, an odd byte-row count (K = 2 mod 4) where
            # the layout allows one
            Ks = [unit * j for j in (3, 5, 6, 10) if unit * j % 2 == 0]
            yield layout, g, next((K for K in Ks if K % 4 == 2), Ks[0])


def _jax_oracle(layout, g, x_q, x_s, w, m, s):
    """The JAX package's oracle of ``layout`` in f32 (eager)."""
    if layout == "vertical":
        return np.asarray(jm.matmul_w4a4_2l_reference(x_q, x_s, w, m, s, None, g, jnp.float32))
    return np.asarray(jm.matmul_w4a8_2l_reference(x_q, x_s, w, m, s, None, g, jnp.float32,
                                                  paired=layout == "paired"))


@pytest.mark.parametrize("layout,g,K,N,bn", [(lay, g, K, 12, 0) for lay, g, K in _any_cases()]
                         + [("paired", 14, 14336, 12, 0), ("paired", 6, 120, 18, 0),
                            ("paired", 6, 120, 16, 4)])
def test_any_loop_arithmetic_equals_the_plain_version(layout, g, K, N, bn):
    # GIVEN the any-group route's arithmetic, mirrored by two_level_rows_dot:
    # x staged in byte-row slot order by the fragments' index arithmetic,
    # each 4-row word folded per plane with its first and last rows' group
    # multipliers (the bytes past the first group's rows from the second),
    # or slot by slot where a word meets more groups; N % 4 != 0 (18) and
    # pre-blocked weights (bn 4) as the kernel reads them WHEN its integer
    # product goes through the oracle's epilogue THEN it equals the port's
    # plain version and the JAX oracle bit for bit
    rs = np.random.RandomState(K * 16 + g)
    M = 17
    a4 = layout == "vertical"
    x_q, x_s = _x(rs, M, K, a4=a4)
    w, m, s = _weights(rs, K, N, g)
    tx, ts, tw, tmul, tsc = _t(x_q, x_s, w, m, s)
    plan = tm.rows_plan(M, K, N, g, layout)
    assert plan.pairs == (g >= {"paired": 2, "halves": 4, "vertical": 6}[layout] or
                          (layout == "vertical" and g == 4))
    wk = tm.preblock_stacked(tw[None], bn)[0] if bn else tw
    acc = tm.two_level_rows_dot(tx, wk, tmul, g, layout, plan)
    got = tm._epilogue(acc.double().float(), tsc, ts, None, torch.float32)
    if a4:
        want = tm.matmul_w4a4_2l_reference(tx, ts, tw, tmul, tsc, None, g, torch.float32)
    else:
        want = tm.matmul_w4a8_2l_reference(tx, ts, tw, tmul, tsc, None, g, torch.float32,
                                           paired=layout == "paired")
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got.numpy(), _jax_oracle(layout, g, x_q, x_s, w, m, s))


@pytest.mark.parametrize("M,K,N,g,layout,packed", [
    (192, 14336, 4096, 14, "paired", True), (192, 14336, 4096, 14, "vertical", True),
    (8, 14336, 4096, 14, "halves", False), (8, 4096, 28672, 2, "paired", True),
    (1, 18, 130, 1, "vertical", True), (17, 28, 12, 1, "paired", False),
])
def test_rows_plan_covers_every_row_once(M, K, N, g, layout, packed):
    # GIVEN an any-group shape WHEN rows_plan splits it THEN the splits cover
    # every byte row once in whole 64-row stages (none empty, each within
    # the int32 bound), the stage's multiplier rows hold every group its
    # rows meet, and one ring stage fits with room for the kernel's depth
    plan = tm.rows_plan(M, K, N, g, layout, packed=packed)
    ranges = plan.row_ranges()
    assert ranges[0][0] == 0 and ranges[-1][1] == K // 2
    assert all(a < b and b - a <= plan.rps for a, b in ranges)
    assert all(b == c for (_, b), (c, _) in zip(ranges, ranges[1:]))
    assert plan.rps % 64 == 0 and plan.rps <= tm._ROWS_MAX_SPLIT
    assert plan == tm.rows_plan(M, K, N, g, layout, plan.n_split, packed)
    r = torch.arange(K // 2)
    for a, _ in ranges:
        for s0 in range(a, min(a + plan.rps, K // 2), 64):
            rr = r[s0:min(s0 + 64, K // 2, a + plan.rps)]
            lo, hi = tm._row_group(rr[0], 0, g, layout), tm._row_group(rr[-1], 1, g, layout)
            need = (hi // 8 - lo // 8 + 1) if packed else (hi - lo + 1)
            assert need <= plan.mult_rows
    assert 1 <= tm.manual_depth(plan, 4) <= 4
    assert plan.x_bytes == len(tm.rows_staged_operand(
        torch.zeros((M, K), dtype=torch.int8), plan, g, layout))


@pytest.mark.parametrize("M", [1, 17])
@pytest.mark.parametrize("g", GROUPS)
def test_a4_gemv_bit_equal_to_jax(M, g):
    # GIVEN int4 activations and layer 1 of 2 of vertical weights at group g
    # WHEN both packages run the A4 GEMV in f32 and bf16 THEN bit-equal
    rs = np.random.RandomState(M * 100 + g)
    K, N = 2 * g * 9, 130 if g % 2 else 132
    x_q, x_s = _x(rs, M, K, a4=True)
    w, m, s = _weights(rs, K, N, g, L=2)
    mp = np.asarray(jpk.pack_mult_nibbles(jnp.asarray(m)))
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = _jit(lambda *a: jm.matmul_w4a4_2l_gemv_stacked(*a, group_size=g, out_dtype=jdt),
                    x_q, x_s, w, mp, s, jnp.int32(1))
        got = tm.matmul_w4a4_2l_gemv_stacked(*_t(x_q, x_s, w, mp, s), 1, group_size=g,
                                             out_dtype=tdt)
        assert got.dtype == tdt
        np.testing.assert_array_equal(_np(want), _np(got))


def _w4a8_cases():
    return [(True, g) for g in GROUPS] + [(False, g) for g in GROUPS if g % 2 == 0]


@pytest.mark.parametrize("M", [1, 17])
@pytest.mark.parametrize("paired,g", _w4a8_cases())
def test_w4a8_gemv_and_argmax_bit_equal_to_jax(M, paired, g):
    # GIVEN int8 activations and two-level weights of either layout at group
    # g WHEN both packages run the GEMV (f32, bf16) and the argmax head THEN
    # the logits are bit-equal and the token ids equal
    rs = np.random.RandomState(M * 100 + g + paired)
    K, N = 2 * g * 9, 260
    x_q, x_s = _x(rs, M, K)
    w, m, s = _weights(rs, K, N, g)
    args = _t(x_q, x_s, w, m, s)
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = _jit(lambda *a: jm.matmul_w4a8_2l_gemv(*a, group_size=g, out_dtype=jdt,
                                                      paired=paired), x_q, x_s, w, m, s)
        got = tm.matmul_w4a8_2l_gemv(*args, g, tdt, paired=paired)
        np.testing.assert_array_equal(_np(want), _np(got))
    want = _jit(lambda *a: jm.matmul_w4a8_2l_gemv_argmax(*a, group_size=g, paired=paired),
                x_q, x_s, w, m, s)
    got = tm.matmul_w4a8_2l_gemv_argmax(*args, g, paired=paired)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("M", [3])
@pytest.mark.parametrize("bn", [0, 4])
@pytest.mark.parametrize("g", GROUPS)
def test_stacked_gemv_bit_equal_to_jax(M, bn, g):
    # GIVEN layer 1 of 2 of stacked paired weights, flat or pre-blocked
    # (JAX's CPU path restores the flat layer, `matmul.py:1055-1066`) WHEN
    # both packages run the stacked GEMV THEN bit-equal
    rs = np.random.RandomState(M * 100 + g + bn)
    K, N = 2 * g * 7, 264
    x_q, x_s = _x(rs, M, K)
    w, m, s = _weights(rs, K, N, g, L=2)
    mp = np.asarray(jpk.pack_mult_nibbles(jnp.asarray(m)))
    wb = np.asarray(jm.preblock_stacked(jnp.asarray(w), bn)) if bn else w
    want = _jit(lambda *a: jm.matmul_w4a8_2l_gemv_stacked(*a, group_size=g),
                x_q, x_s, wb, mp, s, jnp.int32(1))
    got = tm.matmul_w4a8_2l_gemv_stacked(*_t(x_q, x_s, wb, mp, s), 1, group_size=g)
    np.testing.assert_array_equal(_np(want), _np(got))


def test_1024_groups_bit_equal_to_jax():
    # GIVEN K = 14,336 in 1,024 groups of 14 WHEN both packages run rows 5
    # (both layouts), 9 and 1 THEN bit-equal
    rs = np.random.RandomState(14336)
    M, K, N, g = 8, 14336, 64, 14
    x_q, x_s = _x(rs, M, K)
    w, m, s = _weights(rs, K, N, g)
    for paired in (True, False):
        want = _jit(lambda *a: jm.matmul_w4a8_2l_gemv(*a, group_size=g, out_dtype=jnp.float32,
                                                      paired=paired), x_q, x_s, w, m, s)
        got = tm.matmul_w4a8_2l_gemv(*_t(x_q, x_s, w, m, s), g, torch.float32, paired=paired)
        np.testing.assert_array_equal(np.asarray(want), got.numpy())
    mp = np.asarray(jpk.pack_mult_nibbles(jnp.asarray(m)))[None]
    want = _jit(lambda *a: jm.matmul_w4a8_2l_gemv_stacked(*a, group_size=g),
                x_q, x_s, w[None], mp, s[None], jnp.int32(0))
    got = tm.matmul_w4a8_2l_gemv_stacked(*_t(x_q, x_s, w[None], mp, s[None]), 0, group_size=g)
    np.testing.assert_array_equal(_np(want), _np(got))
    x4, x4s = _x(rs, M, K, a4=True)
    want = _jit(lambda *a: jm.matmul_w4a4_2l_gemv_stacked(*a, group_size=g),
                x4, x4s, w[None], mp, s[None], jnp.int32(0))
    got = tm.matmul_w4a4_2l_gemv_stacked(*_t(x4, x4s, w[None], mp, s[None]), 0, group_size=g)
    np.testing.assert_array_equal(_np(want), _np(got))


FUSED_GROUPS = [2, 6, 12]


def _bf16_pair(a):
    return jnp.asarray(a).astype(jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)


@pytest.mark.parametrize("a4", [False, True], ids=["w4a8", "a4"])
@pytest.mark.parametrize("g", FUSED_GROUPS)
def test_fused_heads_serve_the_groups_jax_serves(rounded_rsqrt, a4, g):
    # GIVEN bf16 rows and stacked qkv weights at group g WHEN both packages
    # run the fused head on layer 1 THEN the bf16 outputs are bit-equal
    rs = np.random.RandomState(g + a4)
    M, K, N = 5, 2 * g * 16, 132
    w, mp, s = _stacked(rs, K, N, g)
    (xj, xt), (nj, nt) = _bf16_pair((rs.randn(M, K) * 3).astype(np.float32)), \
        _bf16_pair((rs.rand(3, K) + 0.5).astype(np.float32))
    jfn, tfn = ((jm.fused_norm_qkv_stacked_a4, tm.fused_norm_qkv_stacked_a4) if a4
                else (jm.fused_norm_qkv_stacked, tm.fused_norm_qkv_stacked))
    want = _jit(lambda *a: jfn(*a, group_size=g), xj, nj, w, mp, s, jnp.int32(1))
    got = tfn(xt, nt, *_t(w, mp, s), 1, group_size=g)
    np.testing.assert_array_equal(_np(want), _np(got))


@pytest.mark.parametrize("g", FUSED_GROUPS)
def test_fused_tail_and_o_gu_serve_the_groups_jax_serves(rounded_rsqrt, g):
    # GIVEN attention rows, the residual and stacked o, gate/up and down
    # weights at group g (attention width = hidden, as JAX's tail needs)
    # WHEN both packages run the o + gate/up head and the fused tail on
    # layer 1 THEN x1 and gu are bit-equal, and the tail's output agrees
    # within rtol 1e-2 of its largest value (the JAX oracle's bf16 gate/up
    # rounding and its row quantizers follow XLA's fused order)
    rs = np.random.RandomState(g)
    M, H, inter = 5, 2 * g * 16, 2 * g * 24
    ops = _stacked(rs, H, H, g) + _stacked(rs, H, 2 * inter, g) + _stacked(rs, inter, H, g)
    ops = [a[:2] for a in ops]  # two layers
    (aj, at), (rj, rt) = _bf16_pair((rs.randn(M, H) * 3).astype(np.float32)), \
        _bf16_pair((rs.randn(M, H) * 3).astype(np.float32))
    nj, nt = _bf16_pair((rs.rand(2, H) + 0.5).astype(np.float32))
    x1, gu = _jit(lambda a, r, n, *w: jm.fused_o_gu_stacked(a, r, n, *w[:6], w[6], group_size=g),
                  aj, rj, nj, *ops[:6], jnp.int32(1))
    tx1, tgu = tm.fused_o_gu_stacked(at, rt, nt, *_t(*ops[:6]), 1, group_size=g)
    np.testing.assert_array_equal(np.asarray(x1), tx1.numpy())
    np.testing.assert_array_equal(_np(gu), _np(tgu))
    y = _jit(lambda a, r, n, *w: jm.fused_o_mlp_stacked(a, r, n, *w[:9], w[9], group_size=g),
             aj, rj, nj, *ops, jnp.int32(1))
    ty = tm.fused_o_mlp_stacked(at, rt, nt, *_t(*ops), 1, group_size=g)
    assert ty.dtype == torch.bfloat16 and tuple(ty.shape) == (M, H)
    a, b = _np(y), _np(ty)
    assert np.abs(a - b).max() <= 1e-2 * np.abs(a).max()


@pytest.mark.parametrize("full", [True, False], ids=["tail", "o_gu"])
def test_tail_plan_of_the_any_group_route(full):
    # GIVEN the fused tail (or its o + gate/up head) at g 2, the 8B widths,
    # M = 8 WHEN it is planned for the any-group route THEN each product
    # takes rows_plan's plan, and the scratch regions follow the C entry's
    # argument order, xq (M, K1) after x1 (the tail) or the scales (the
    # head), each 256-byte aligned and disjoint
    M, K1, H, N_GU, g = 8, 4096, 4096, 28672, 2
    plan = tm.tail_plan(M, K1, H, N_GU, g, full, "any")
    names = [name for name, _, _ in plan.regions]
    assert names == (["xs", "scales", "x1", "xq", "hq", "x2", "xf_o", "xf_gu", "xf_dn", "partial"]
                     if full else ["xs", "scales", "xq", "hq", "xf_o", "xf_gu", "partial"])
    shapes = ((K1, H), (H, N_GU)) + (((N_GU // 2, H),) if full else ())
    assert all(isinstance(p, tm.RowsPlan) and p.rows == K // 2
               for p, (K, _) in zip(plan.plans, shapes))
    sizes = {name: size for name, _, size in plan.regions}
    assert sizes["xq"] == M * K1
    assert [sizes[f"xf_{n}"] for n in ("o", "gu", "dn")[:len(shapes)]] == \
        [p.x_bytes for p in plan.plans]
    ends = 0
    for _, off, size in plan.regions:
        assert off % 256 == 0 and off >= ends
        ends = off + size
    assert plan.total >= ends
