"""The port's two-level int4 GEMVs and their helpers against
`fastforward_tpu.kernels.matmul`, on the CPU (the port's plain versions,
the JAX package's references). Tolerance for all of them: none — the
outputs are integer math and one float epilogue, and must be bit-equal.

The activation quantizers are compared with the jitted JAX functions:
that is how the JAX serving path runs them, and XLA compiles their
division by a constant into a multiplication by its reciprocal, which
the port writes out.
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


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)


def _eq(a, b):
    np.testing.assert_array_equal(_np(a), _np(b))


def _act(shape, seed):
    x = (np.random.RandomState(seed).randn(*shape) * 3).astype(np.float32)
    return jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


@pytest.mark.parametrize("name", ["quantize_rowwise", "quantize_rowwise_a4"])
def test_activation_quantizers_bit_exact(name):
    xj, xt = _act((16, 96), seed=0)
    qj, sj = jax.jit(getattr(jm, name))(xj)
    qt, st = getattr(tm, name)(xt)
    _eq(qj, qt)
    _eq(sj, st)


@pytest.mark.parametrize("paired", [True, False])
def test_convert_two_level_bit_exact(paired):
    # GIVEN float-per-group int4 weights (pack_int4) with random scales
    K, N, g = 128, 24, 32
    rs = np.random.RandomState(1)
    w = rs.randint(-8, 8, (K, N)).astype(np.int8)
    s = (rs.rand(K // g, N) * 0.1 + 1e-3).astype(np.float32)
    pj = jpk.pack_int4(jnp.asarray(w), g)
    pt = tpk.pack_int4(torch.from_numpy(w), g)
    # WHEN moved to the two-level grid THEN packed bytes, multipliers and
    # column scales agree
    for a, b in zip(jm.convert_two_level(pj, jnp.asarray(s), g, paired=paired),
                    tm.convert_two_level(pt, torch.from_numpy(s), g, paired=paired)):
        _eq(a, b)


def test_convert_two_level_a4_bit_exact():
    K, N, g = 128, 24, 32
    rs = np.random.RandomState(2)
    w = rs.randint(-8, 8, (K, N)).astype(np.int8)
    s = (rs.rand(K // g, N) * 0.1 + 1e-3).astype(np.float32)
    for a, b in zip(jm.convert_two_level_a4(jpk.pack_int4(jnp.asarray(w), g), jnp.asarray(s), g),
                    tm.convert_two_level_a4(tpk.pack_int4(torch.from_numpy(w), g),
                                            torch.from_numpy(s), g)):
        _eq(a, b)


def _a4_inputs(L, M, K, N, g, seed):
    rs = np.random.RandomState(seed)
    w = rs.randint(-128, 128, (L, K // 2, N)).astype(np.int8)
    m = rs.randint(1, 16, (L, K // g, N)).astype(np.int8)
    s = (rs.rand(L, N) * 1e-2).astype(np.float32)
    xj, xt = _act((M, K), seed + 1)
    qj, sj = jax.jit(jm.quantize_rowwise_a4)(xj)
    qt, st = tm.quantize_rowwise_a4(xt)
    return w, m, s, (qj, sj), (qt, st)


@pytest.mark.parametrize("M,K,g", [(1, 64, 32), (8, 256, 32), (24, 512, 64)])
def test_a4_gemv_stacked_bit_exact(M, K, g):
    # GIVEN a 2-layer stacked vertical-layout weight with packed multipliers
    L, N = 2, 40
    w, m, s, (qj, sj), (qt, st) = _a4_inputs(L, M, K, N, g, seed=K + M)
    mpj = jpk.pack_mult_nibbles(jnp.asarray(m))
    mpt = tpk.pack_mult_nibbles(torch.from_numpy(m))
    for layer in range(L):
        # WHEN each layer's GEMV runs in both packages THEN bf16 outputs agree
        a = jm.matmul_w4a4_2l_gemv_stacked(qj, sj, jnp.asarray(w), mpj, jnp.asarray(s),
                                           jnp.int32(layer), group_size=g)
        b = tm.matmul_w4a4_2l_gemv_stacked(qt, st, torch.from_numpy(w), mpt,
                                           torch.from_numpy(s), layer, group_size=g)
        assert b.dtype == torch.bfloat16
        _eq(a, b)


@pytest.mark.parametrize("out_dtype", ["bfloat16", "float32"])
def test_a4_gemv_non_stacked_and_reference(out_dtype):
    w, m, s, (qj, sj), (qt, st) = _a4_inputs(1, 6, 128, 32, 32, seed=5)
    jd, td = getattr(jnp, out_dtype), getattr(torch, out_dtype)
    a = jm.matmul_w4a4_2l_gemv(qj, sj, jnp.asarray(w[0]), jnp.asarray(m[0]), jnp.asarray(s[0]),
                               group_size=32, out_dtype=jd)
    b = tm.matmul_w4a4_2l_gemv(qt, st, torch.from_numpy(w[0]), torch.from_numpy(m[0]),
                               torch.from_numpy(s[0]), group_size=32, out_dtype=td)
    _eq(a, b)
    bias = np.linspace(-1, 1, 32).astype(np.float32)
    _eq(jm.matmul_w4a4_2l_reference(qj, sj, jnp.asarray(w[0]), jnp.asarray(m[0]),
                                    jnp.asarray(s[0]), jnp.asarray(bias), 32, jd),
        tm.matmul_w4a4_2l_reference(qt, st, torch.from_numpy(w[0]), torch.from_numpy(m[0]),
                                    torch.from_numpy(s[0]), torch.from_numpy(bias), 32, td))


def _w4a8_inputs(M, K, N, g, seed):
    rs = np.random.RandomState(seed)
    w = rs.randint(-128, 128, (K // 2, N)).astype(np.int8)
    m = rs.randint(1, 16, (K // g, N)).astype(np.int8)
    s = (rs.rand(N) * 1e-2).astype(np.float32)
    xj, xt = _act((M, K), seed + 1)
    return w, m, s, jax.jit(jm.quantize_rowwise)(xj), tm.quantize_rowwise(xt)


@pytest.mark.parametrize("paired", [True, False])
@pytest.mark.parametrize("out_dtype", ["bfloat16", "float32"])
def test_w4a8_gemv_bit_exact(paired, out_dtype):
    # GIVEN an lm_head-like two-level W4A8 weight (2 groups for the paired layout)
    w, m, s, (qj, sj), (qt, st) = _w4a8_inputs(5, 128, 56, 32, seed=3)
    a = jm.matmul_w4a8_2l_gemv(qj, sj, jnp.asarray(w), jnp.asarray(m), jnp.asarray(s),
                               group_size=32, out_dtype=getattr(jnp, out_dtype), paired=paired)
    b = tm.matmul_w4a8_2l_gemv(qt, st, torch.from_numpy(w), torch.from_numpy(m),
                               torch.from_numpy(s), group_size=32,
                               out_dtype=getattr(torch, out_dtype), paired=paired)
    _eq(a, b)


def test_w4a8_argmax_ids_bit_exact_with_ties_and_nan():
    # GIVEN logits with exact ties (duplicated columns) and a NaN row
    w, m, s, (qj, sj), (qt, st) = _w4a8_inputs(6, 128, 64, 32, seed=4)
    w[:, 40:48] = w[:, 8:16]
    m[:, 40:48] = m[:, 8:16]
    s[40:48] = s[8:16]
    sj = sj.at[5].set(jnp.nan)
    st = st.clone()
    st[5] = float("nan")

    def run_jax(paired):
        return jm.matmul_w4a8_2l_gemv_argmax(qj, sj, jnp.asarray(w), jnp.asarray(m),
                                             jnp.asarray(s), group_size=32, paired=paired)

    for paired in (True, False):
        a = run_jax(paired)
        b = tm.matmul_w4a8_2l_gemv_argmax(qt, st, torch.from_numpy(w), torch.from_numpy(m),
                                          torch.from_numpy(s), group_size=32, paired=paired)
        # THEN the ids agree, first occurrence wins, a NaN row picks its first NaN
        assert b.dtype == torch.int32
        _eq(a, b)
        logits = tm.matmul_w4a8_2l_reference(qt, st, torch.from_numpy(w), torch.from_numpy(m),
                                             torch.from_numpy(s), None, 32, torch.float32,
                                             paired=paired)
        _eq(torch.argmax(logits, dim=-1).to(torch.int32), b)
        assert int(b[5]) == 0


def _stacked_two_level(L, K, N, g, seed):
    rs = np.random.RandomState(seed)
    w = rs.randint(-128, 128, (L, K // 2, N)).astype(np.int8)
    m = rs.randint(1, 16, (L, K // g, N)).astype(np.int8)
    s = (rs.rand(L, N) * 1e-2 + 1e-4).astype(np.float32)
    return w, m, s


@pytest.mark.parametrize("g", [32, 128])
@pytest.mark.parametrize("out_dtype", ["bfloat16", "float32"])
def test_w4a8_gemv_stacked_bit_exact(g, out_dtype):
    # GIVEN 3 layers of paired W4A8 weights, multipliers nibble-packed by JAX
    L, M, K, N = 3, 6, 8 * g, 40
    w, m, s = _stacked_two_level(L, K, N, g, seed=g)
    xj, xt = _act((M, K), seed=g + 1)
    qj, sj = jax.jit(jm.quantize_rowwise)(xj)
    qt, st = tm.quantize_rowwise(xt)
    mpj = jpk.pack_mult_nibbles(jnp.asarray(m))
    mpt = torch.from_numpy(np.array(mpj))
    for layer in range(L):
        # WHEN each layer's GEMV runs in both packages THEN the outputs agree
        a = jm.matmul_w4a8_2l_gemv_stacked(qj, sj, jnp.asarray(w), mpj, jnp.asarray(s),
                                           jnp.int32(layer), group_size=g,
                                           out_dtype=getattr(jnp, out_dtype))
        b = tm.matmul_w4a8_2l_gemv_stacked(qt, st, torch.from_numpy(w), mpt,
                                           torch.from_numpy(s), layer, group_size=g,
                                           out_dtype=getattr(torch, out_dtype))
        assert b.dtype == getattr(torch, out_dtype)
        _eq(a, b)


@pytest.mark.parametrize("layout", ["vertical", "paired"])
@pytest.mark.parametrize("g", [32, 128])
def test_dequant_stacked_bit_exact(layout, g):
    # GIVEN 3 layers of two-level weights (vertical W4A4 or paired W4A8)
    L, K, N = 3, 4 * g, 48
    w, m, s = _stacked_two_level(L, K, N, g, seed=7 * g)
    jfn = getattr(jm, f"dequantize_int4_{layout}_stacked")
    tfn = getattr(tm, f"dequantize_int4_{layout}_stacked")
    for layer in range(L):
        # WHEN each layer is dequantized by both packages THEN the bf16
        # weights agree bit for bit (the JAX package's CPU rounding)
        a = jfn(jnp.asarray(w), jnp.asarray(m), jnp.asarray(s), jnp.int32(layer), group_size=g)
        b = tfn(torch.from_numpy(w), torch.from_numpy(m), torch.from_numpy(s), layer,
                group_size=g)
        assert b.dtype == torch.bfloat16 and tuple(b.shape) == (K, N)
        _eq(a, b)


def test_dequant_non_stacked_bit_exact():
    # the non-stacked forms take a ready per-group scale (mult * s_col)
    K, N, g = 128, 40, 32
    w, m, s = _stacked_two_level(1, K, N, g, seed=11)
    s_eff = m[0].astype(np.float32) * s[0][None, :]
    _eq(jm.dequantize_int4_vertical(jnp.asarray(w[0]), jnp.asarray(s_eff), g),
        tm.dequantize_int4_vertical(torch.from_numpy(w[0]), torch.from_numpy(s_eff), g))
    _eq(jm.dequantize_int4(jnp.asarray(w[0]), jnp.asarray(s_eff), g, offset_binary=True,
                           paired=True),
        tm.dequantize_int4(torch.from_numpy(w[0]), torch.from_numpy(s_eff), g,
                           offset_binary=True, paired=True))
    # the group-halves branches (two's complement and offset binary) too
    for offset_binary in (False, True):
        _eq(jm.dequantize_int4(jnp.asarray(w[0]), jnp.asarray(s_eff), g,
                               offset_binary=offset_binary),
            tm.dequantize_int4(torch.from_numpy(w[0]), torch.from_numpy(s_eff), g,
                               offset_binary=offset_binary))


EXACT = {"xla_allow_excess_precision": False}


def _tail_operands(L, H, inter, g, seed):
    """Stacked paired W4A8 o, gate/up and down weights of a layer tail,
    multipliers nibble-packed, and bf16 post-norm weights."""
    ops = []
    for K, N, s in ((H, H, 0), (H, 2 * inter, 1), (inter, H, 2)):
        w, m, sc = _stacked_two_level(L, K, N, g, seed=seed + s)
        ops += [w, np.array(jpk.pack_mult_nibbles(jnp.asarray(m))), sc]
    norm = (np.random.RandomState(seed + 3).rand(L, H) + 0.5).astype(np.float32)
    return norm, ops


@pytest.mark.parametrize("M", [1, 5, 16])
def test_fused_o_mlp_matches_jax(M):
    # GIVEN a 2-layer stack of tail weights (H 256, inter 384, group 64:
    # even group counts, the paired layout) and bf16 attention output and
    # residual rows
    L, H, inter, g, eps = 2, 256, 384, 64, 1e-5
    norm, ops = _tail_operands(L, H, inter, g, seed=M)
    attn_j, attn_t = _act((M, H), seed=M + 10)
    res_j, res_t = _act((M, H), seed=M + 11)
    norm_j = jnp.asarray(norm).astype(jnp.bfloat16)
    norm_t = torch.from_numpy(norm).to(torch.bfloat16)
    jops = [jnp.asarray(a) for a in ops]
    tops = [torch.from_numpy(a) for a in ops]
    jfn = jax.jit(lambda a, r, n, *w: jm.fused_o_mlp_stacked(a, r, n, *w[:9], w[9],
                                                            group_size=g, eps=eps))
    for layer in range(L):
        args = (attn_j, res_j, norm_j, *jops, jnp.int32(layer))
        # WHEN both packages run the tail (JAX off the TPU runs its oracle,
        # the port on the CPU its plain version)
        a = np.asarray(jfn.lower(*args).compile(compiler_options=EXACT)(*args)).astype(np.float32)
        b = tm.fused_o_mlp_stacked(attn_t, res_t, norm_t, *tops, layer, group_size=g, eps=eps)
        # THEN the bf16 outputs agree within one bf16 ulp of the largest
        # value (the f32 mean and sigmoid may round differently in XLA and
        # PyTorch; a moved int8 level moves the output by less)
        assert b.dtype == torch.bfloat16 and tuple(b.shape) == (M, H)
        b = b.float().numpy()
        assert np.abs(a - b).max() <= 8e-3 * np.abs(a).max()


def test_fused_o_mlp_reference_parts():
    # the oracle's intermediates: x1 is the residual plus the o_proj GEMV,
    # hq and x2 the row-quantized inputs of gate/up and down, and the output
    # x1 + down; the f32 oracle agrees with JAX's within 1e-5 of its largest
    L, H, inter, g, M = 1, 256, 256, 64, 4
    norm, ops = _tail_operands(L, H, inter, g, seed=40)
    attn_j, attn_t = _act((M, H), seed=41)
    res_j, res_t = _act((M, H), seed=42)
    layer_ops = tm._fused_o_mlp_layer(torch.from_numpy(norm).to(torch.bfloat16),
                                      *[torch.from_numpy(a) for a in ops], 0, g)
    y, x1, hq, hs, x2, gs = tm._fused_o_mlp_parts(attn_t.float(), res_t.float(), *layer_ops,
                                                  group_size=g)
    xq, xs = tm.quantize_rowwise(attn_t.float())
    o = tm.matmul_w4a8_2l_reference(xq, xs, layer_ops[1], layer_ops[2], layer_ops[3], None, g,
                                    torch.float32, paired=True)
    assert torch.equal(x1, res_t.float() + o)
    assert hq.dtype == x2.dtype == torch.int8 and tuple(x2.shape) == (M, inter)
    assert tuple(hs.shape) == tuple(gs.shape) == (M,)
    jl = [jnp.asarray(np.asarray(t)) if t.dtype != torch.bfloat16 else
          jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in layer_ops]
    args = (attn_j.astype(jnp.float32), res_j.astype(jnp.float32), *jl)
    ref = jax.jit(lambda *a: jm.fused_o_mlp_reference(*a, group_size=g, eps=1e-5))
    a = np.asarray(ref.lower(*args).compile(compiler_options=EXACT)(*args))
    assert np.abs(a - y.numpy()).max() <= 1e-5 * np.abs(a).max()
