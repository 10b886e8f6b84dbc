"""The float-scale serving modes (w8a8, w4a8, w4a16) of the port against the
JAX package, on the CPU.

Kernel functions: the port's plain versions against the jitted JAX
functions, inputs made from a seed with numpy. Bit-equal: the group-halves
dequant, the W8A8 product and the W4A8 GEMV (`matmul_w4a8_reference`,
whose group sum jitted XLA computes as a fused multiply-add chain up to 32
groups and as a tree of 32-wide windows beyond: the port writes both
orders out). The W4A16 GEMV against ``jax.lax.dot(x_bf16,
dequantize_int4(...), preferred_element_type=f32)``: its f32 sums run in
another order, so f32 outputs are held within 2e-6 of the largest output,
and bf16 outputs within one bf16 ulp of the JAX value plus that f32 error
(an output near 0 is a cancellation, whose f32 error exceeds its own ulp).

End to end: greedy tokens of a 2-layer model in each mode, made by the JAX
package and carried by `params_from_flat`, against the JAX decode loop,
from prefills of 16 rows (the GEMVs: logits bit-equal) and of 288 rows
(the dequant and a dense product: logits within a relative RMS error;
the decode then starts from JAX's cache in both). The JAX side takes the
TPU routing through test-local shims of the names
`fastforward_tpu.serving.engine` imports: up to 256 rows the GEMV's
function, above it `dequantize_int4`'s CPU path and ``jax.lax.dot`` with
an f32 result; flash prefill through its reference (as
`tests/test_torch_batching.py` routes it). Both sides compile with
``xla_allow_excess_precision=False``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastforward_tpu.kernels import matmul as jm
from fastforward_tpu.kernels import packing as jpk
from fastforward_tpu.models.llama import LlamaConfig as JConfig
from fastforward_tpu.serving import engine as je
from fastforward_tpu.serving import stacked as js
from fastforward_tpu_torch.kernels import matmul as tm
from fastforward_tpu_torch.kernels import packing as tpk
from fastforward_tpu_torch.models.llama import LlamaConfig as TConfig
from fastforward_tpu_torch.serving import engine as te
from fastforward_tpu_torch.serving import stacked as ts
from fastforward_tpu_torch.serving.convert import params_from_flat, params_to_flat
from tests.test_torch_batching import routes  # noqa: F401  (fixture)
from tests.test_torch_serving import jax_to_flat

EXACT = {"xla_allow_excess_precision": False}
MODES = ["w8a8", "w4a8", "w4a16"]
W4_F32_RTOL = 2e-6  # W4A16 GEMV f32 outputs, relative to the largest


def _jit(fn, *args):
    """``fn`` jitted and compiled with EXACT, applied to ``args``."""
    f = jax.jit(fn)
    return f.lower(*args).compile(compiler_options=EXACT)(*args)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)


def _eq(a, b):
    np.testing.assert_array_equal(_np(a), _np(b))


def _act(shape, seed):
    x = (np.random.RandomState(seed).randn(*shape) * 3).astype(np.float32)
    return jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


def _int8_act(M, K, seed):
    xj, xt = _act((M, K), seed)
    return jax.jit(jm.quantize_rowwise)(xj), tm.quantize_rowwise(xt)


def _w4(K, N, g, seed):
    """`pack_int4` weights (K//2, N) and per-group scales (K//g, N)."""
    rs = np.random.RandomState(seed)
    w = np.asarray(jpk.pack_int4(jnp.asarray(rs.randint(-8, 8, (K, N)).astype(np.int8)), g))
    s = (rs.rand(K // g, N) * 0.1 + 1e-3).astype(np.float32)
    return w, s


def _t(a):
    return torch.from_numpy(np.array(a))


def _bf16_ulp(a):
    """One bf16 ulp at each value of the f32 array ``a``."""
    e = np.floor(np.log2(np.maximum(np.abs(a), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


def _within_bf16(a, b, rtol=W4_F32_RTOL):
    """bf16 ``b`` within one bf16 ulp of ``a`` plus ``rtol`` of a's largest."""
    return (np.abs(a - b) <= _bf16_ulp(a) + rtol * np.abs(a).max()).all()


# --- kernel functions --------------------------------------------------------


@pytest.mark.parametrize("offset_binary", [False, True])
@pytest.mark.parametrize("K", [4096, 14336])
def test_dequant_halves_bit_exact(offset_binary, K):
    # GIVEN group-halves weights in either nibble encoding, g = 128
    g, N = 128, 24
    rs = np.random.RandomState(K + offset_binary)
    w = rs.randint(-128, 128, (K // 2, N)).astype(np.int8)
    s = (rs.rand(K // g, N) * 0.1).astype(np.float32)
    # WHEN dequantized by both packages THEN the bf16 weights are bit-equal
    a = _jit(lambda w, s: jm.dequantize_int4(w, s, g, offset_binary=offset_binary),
             jnp.asarray(w), jnp.asarray(s))
    b = tm.dequantize_int4(_t(w), _t(s), g, offset_binary=offset_binary)
    assert b.dtype == torch.bfloat16 and tuple(b.shape) == (K, N)
    _eq(a, b)


def test_unpack_layouts_bit_exact_at_112_groups():
    # the port's unpackers read the JAX packers' bytes at K = 14336, g = 128
    K, N, g = 14336, 12, 128
    v = np.random.RandomState(9).randint(-8, 8, (K, N)).astype(np.int8)
    _eq(jpk.unpack_int4(jpk.pack_int4(jnp.asarray(v), g), g),
        tpk.unpack_int4(_t(jpk.pack_int4(jnp.asarray(v), g)), g))
    _eq(jpk.unpack_uint4_offset(jpk.pack_uint4_offset(jnp.asarray(v), g), g),
        tpk.unpack_uint4_offset(_t(jpk.pack_uint4_offset(jnp.asarray(v), g)), g))
    _eq(tpk.pack_int4(_t(v), g), jpk.pack_int4(jnp.asarray(v), g))


@pytest.mark.parametrize("M", [1, 8, 192, 300])
@pytest.mark.parametrize("K", [4096, 14336])
@pytest.mark.parametrize("out_dtype", ["bfloat16", "float32"])
def test_w8a8_bit_exact(M, K, out_dtype):
    # GIVEN int8 activations (per-row scales) and int8 weights (per-column)
    N = 20
    rs = np.random.RandomState(M + K)
    w = rs.randint(-127, 128, (K, N)).astype(np.int8)
    ws = (rs.rand(N) * 0.02 / np.sqrt(K)).astype(np.float32)
    (qj, sj), (qt, st) = _int8_act(M, K, M)
    # WHEN both packages multiply THEN the outputs are bit-equal
    a = _jit(lambda q, s, w, ws: jm.matmul_w8a8(q, s, w, ws, out_dtype=getattr(jnp, out_dtype)),
             qj, sj, jnp.asarray(w), jnp.asarray(ws))
    b = tm.matmul_w8a8(qt, st, _t(w), _t(ws), out_dtype=getattr(torch, out_dtype))
    assert b.dtype == getattr(torch, out_dtype)
    _eq(a, b)


def test_w8a8_bias_is_one_fused_rounding():
    # jitted XLA fuses the bias add into the last product: one rounding
    M, K, N = 9, 256, 36
    rs = np.random.RandomState(4)
    w = rs.randint(-127, 128, (K, N)).astype(np.int8)
    ws = (rs.rand(N) * 0.01).astype(np.float32)
    bias = rs.randn(N).astype(np.float32)
    (qj, sj), (qt, st) = _int8_act(M, K, 5)
    a = _jit(lambda q, s, w, ws, b: jm.matmul_w8a8(q, s, w, ws, b, out_dtype=jnp.float32),
             qj, sj, jnp.asarray(w), jnp.asarray(ws), jnp.asarray(bias))
    b = tm.matmul_w8a8(qt, st, _t(w), _t(ws), _t(bias), out_dtype=torch.float32)
    _eq(a, b)


@pytest.mark.parametrize("M", [1, 8, 192])
@pytest.mark.parametrize("K,g", [(4096, 128), (14336, 128), (1056, 32)])
@pytest.mark.parametrize("out_dtype", ["bfloat16", "float32"])
def test_w4a8_gemv_bit_exact(M, K, g, out_dtype):
    # GIVEN float-per-group W4A8 weights: 32 groups (the fused multiply-add
    # chain), 112 and 33 groups (XLA's tree of 32-wide windows)
    N = 20
    w, s = _w4(K, N, g, seed=K + M)
    (qj, sj), (qt, st) = _int8_act(M, K, M + 1)
    # WHEN the port's GEMV runs its plain version and JAX its oracle, jitted
    a = _jit(lambda q, xs, w, s: jm.matmul_w4a8_reference(
        q, xs, w, s, None, g, getattr(jnp, out_dtype)), qj, sj, jnp.asarray(w), jnp.asarray(s))
    b = tm.matmul_w4a8_gemv(qt, st, _t(w), _t(s), g, getattr(torch, out_dtype))
    # THEN the outputs are bit-equal
    assert b.dtype == getattr(torch, out_dtype)
    _eq(a, b)


@pytest.mark.parametrize("M", [1, 8, 192])
@pytest.mark.parametrize("K,g", [(1024, 256), (2048, 256), (1024, 512), (2048, 512)])
@pytest.mark.parametrize("out_dtype", ["bfloat16", "float32"])
def test_w4a8_gemv_bit_exact_at_large_groups(M, K, g, out_dtype):
    # GIVEN float-per-group W4A8 weights whose groups span several of the
    # kernel's 128-k stages (FF_BENCH_GROUP=256 and 512)
    N = 20
    w, s = _w4(K, N, g, seed=K + M + g)
    (qj, sj), (qt, st) = _int8_act(M, K, M + g)
    # WHEN the port's GEMV runs its plain version and JAX its oracle, jitted
    a = _jit(lambda q, xs, w, s: jm.matmul_w4a8_reference(
        q, xs, w, s, None, g, getattr(jnp, out_dtype)), qj, sj, jnp.asarray(w), jnp.asarray(s))
    b = tm.matmul_w4a8_gemv(qt, st, _t(w), _t(s), g, getattr(torch, out_dtype))
    # THEN the outputs are bit-equal, and the kernel's fold under its plan
    # gives the same bits
    _eq(a, b)
    _eq(a, tm.w4a8_split_fold(qt, st, _t(w), _t(s), g, getattr(torch, out_dtype)))


@pytest.mark.parametrize("M", [1, 8, 192])
@pytest.mark.parametrize("K,g", [(1024, 256), (2048, 512)])
@pytest.mark.parametrize("out_dtype", ["bfloat16", "float32"])
def test_w4_gemv_within_tolerance_at_large_groups(M, K, g, out_dtype):
    # GIVEN bf16 activations and a weight-only int4 weight at g 256 and 512
    N = 20
    w, s = _w4(K, N, g, seed=K + 5 * M + g)
    xj, xt = _act((M, K), seed=M + g)
    # WHEN the port's GEMV (its plain version here) and the JAX TPU route's
    # function run
    a = _np(_jit(lambda x, w, s: _jax_w4a16_tpu(x, w, s, None, g, getattr(jnp, out_dtype)),
                 xj, jnp.asarray(w), jnp.asarray(s)))
    b = _np(tm.matmul_w4_gemv(xt, _t(w), _t(s), g, getattr(torch, out_dtype)))
    # THEN f32 within W4_F32_RTOL of the largest, bf16 within one bf16 ulp more
    if out_dtype == "float32":
        assert np.abs(a - b).max() <= W4_F32_RTOL * np.abs(a).max()
    else:
        assert _within_bf16(a, b)


# Groups the kernels read x for permuted into byte-row order on the card
# (`float_scale_route` "permuted"): g = K at 192 and 320, 16 and 40 groups
# of 96 (the fused multiply-add chain; XLA's windows), 32 groups of 2, and
# 1,025 groups (XLA's windows of window sums, past the direct fold's 32 x 32)
@pytest.mark.parametrize("M", [1, 192])
@pytest.mark.parametrize("K,g", [(192, 192), (320, 320), (1536, 96), (3840, 96), (64, 2),
                                 (2050, 2)])
def test_float_scale_gemvs_at_any_group(M, K, g):
    N = 20
    w, s = _w4(K, N, g, seed=K + M + g)
    (qj, sj), (qt, st) = _int8_act(M, K, M + g)
    xj, xt = _act((M, K), seed=M + g + 1)
    for out_dtype in ("bfloat16", "float32"):
        # WHEN both packages' W4A8 GEMV (the port's plain version, JAX's
        # oracle, jitted) and W4 GEMV (JAX: its TPU route's function) run
        a = _jit(lambda q, xs, w, s: jm.matmul_w4a8_reference(
            q, xs, w, s, None, g, getattr(jnp, out_dtype)), qj, sj, jnp.asarray(w),
            jnp.asarray(s))
        # THEN the W4A8 outputs are bit-equal
        _eq(a, tm.matmul_w4a8_gemv(qt, st, _t(w), _t(s), g, getattr(torch, out_dtype)))
        a = _np(_jit(lambda x, w, s: _jax_w4a16_tpu(x, w, s, None, g, getattr(jnp, out_dtype)),
                     xj, jnp.asarray(w), jnp.asarray(s)))
        b = _np(tm.matmul_w4_gemv(xt, _t(w), _t(s), g, getattr(torch, out_dtype)))
        # AND the W4 outputs within W4_F32_RTOL (f32), one bf16 ulp more (bf16)
        if out_dtype == "float32":
            assert np.abs(a - b).max() <= W4_F32_RTOL * np.abs(a).max()
        else:
            assert _within_bf16(a, b)


def test_w4a8_reference_with_bias_bit_exact():
    M, K, N, g = 6, 4096, 16, 128
    w, s = _w4(K, N, g, seed=77)
    bias = np.random.RandomState(78).randn(N).astype(np.float32)
    (qj, sj), (qt, st) = _int8_act(M, K, 79)
    a = _jit(lambda q, xs, w, s, b: jm.matmul_w4a8_reference(q, xs, w, s, b, g, jnp.float32),
             qj, sj, jnp.asarray(w), jnp.asarray(s), jnp.asarray(bias))
    _eq(a, tm.matmul_w4a8_reference(qt, st, _t(w), _t(s), _t(bias), g, torch.float32))


def _jax_w4a8_tpu(x_q, x_scale, w_packed, w_scale, bias=None, group_size=128,
                  out_dtype=jnp.bfloat16):
    """`matmul_w4a8`'s TPU routing (`matmul.py:218-232`) from functions that
    run on the CPU: the GEMV's function up to 256 rows, else the dequant's
    CPU path and an f32-accumulated dot."""
    assert bias is None
    if x_q.shape[0] <= 256:
        return jm.matmul_w4a8_reference(x_q, x_scale, w_packed, w_scale, None, group_size,
                                        out_dtype)
    w = jm.dequantize_int4(w_packed, w_scale, group_size)
    xb = (x_q.astype(jnp.float32) * x_scale[:, None]).astype(jnp.bfloat16)
    return jax.lax.dot(xb, w, preferred_element_type=jnp.float32).astype(out_dtype)


def _jax_w4a16_tpu(x, w_packed, w_scale, bias=None, group_size=128, out_dtype=None):
    """`matmul_w4a16`'s TPU routing (`matmul.py:1849-1860`): the GEMV's
    function (with the dequant's CPU rounding) up to 256 rows, else the
    dequant and an f32-accumulated dot; both ``x_bf16 @ dequant(w)``."""
    assert bias is None
    w = jm.dequantize_int4(w_packed, w_scale, group_size)
    out = jax.lax.dot(x.astype(jnp.bfloat16), w, preferred_element_type=jnp.float32)
    return out.astype(out_dtype or x.dtype)


@pytest.mark.parametrize("M", [1, 8, 192, 300])
@pytest.mark.parametrize("K", [4096, 14336])
@pytest.mark.parametrize("out_dtype", ["bfloat16", "float32"])
def test_w4_gemv_within_tolerance(M, K, out_dtype):
    # GIVEN bf16 activations and a weight-only int4 weight, g = 128
    g, N = 128, 20
    w, s = _w4(K, N, g, seed=K + 3 * M)
    xj, xt = _act((M, K), seed=M + 2)
    # WHEN the port's matmul_w4a16 (GEMV up to 256 rows, else dequant and a
    # dense product) and the JAX TPU route's function run
    a = _np(_jit(lambda x, w, s: _jax_w4a16_tpu(x, w, s, None, g, getattr(jnp, out_dtype)),
                 xj, jnp.asarray(w), jnp.asarray(s)))
    b = tm.matmul_w4a16(xt, _t(w), _t(s), None, g, getattr(torch, out_dtype))
    assert b.dtype == getattr(torch, out_dtype) and tuple(b.shape) == (M, N)
    b = _np(b)
    # THEN f32 within W4_F32_RTOL of the largest, bf16 within one bf16 ulp
    # more
    if out_dtype == "float32":
        assert np.abs(a - b).max() <= W4_F32_RTOL * np.abs(a).max()
    else:
        assert _within_bf16(a, b)


def test_w4a16_reference_and_w4a8_prefill_route():
    # the JAX W4A16 oracle rounds the product to x's dtype (bf16 logits);
    # the port's oracle does the same, within one bf16 ulp (bf16 dot sums)
    M, K, N, g = 5, 512, 24, 64
    w, s = _w4(K, N, g, seed=31)
    xj, xt = _act((M, K), seed=32)
    a = _np(_jit(lambda x, w, s: jm.matmul_w4a16_reference(x, w, s, None, g, jnp.float32),
                 xj, jnp.asarray(w), jnp.asarray(s)))
    b = tm.matmul_w4a16_reference(xt, _t(w), _t(s), None, g, torch.float32).numpy()
    assert _within_bf16(a, b)
    # 300 rows of W4A8 take the dequant and a dense product: within 1e-5 of
    # the largest output (f32 sums in another order)
    (qj, sj), (qt, st) = _int8_act(300, K, 33)
    a = _np(_jit(lambda q, xs, w, s: _jax_w4a8_tpu(q, xs, w, s, None, g, jnp.float32),
                 qj, sj, jnp.asarray(w), jnp.asarray(s)))
    b = tm.matmul_w4a8(qt, st, _t(w), _t(s), None, g, torch.float32).numpy()
    assert np.abs(a - b).max() <= 1e-5 * np.abs(a).max()


def test_quantize_static_bit_exact():
    # the scale is a runtime value: XLA keeps the division
    xj, xt = _act((7, 96), seed=8)
    sc = np.float32(0.0371)
    qa, sa = _jit(je.quantize_static, xj, jnp.asarray(sc))
    qb, sb = te.quantize_static(xt, torch.tensor(sc))
    _eq(qa, qb)
    _eq(sa, sb)
    assert qb.dtype == torch.int8 and tuple(sb.shape) == (7,)


@pytest.mark.parametrize("mode", ["w8a8", "w4a8", "w4a8_2l"])
def test_stacked_in_scale_bit_exact(mode, monkeypatch):
    # GIVEN a 2-layer stacked projection with a per-layer static input scale
    L, K, N, g, M = 2, 256, 24, 64, 6
    rs = np.random.RandomState(12)
    w = [rs.randn(K, N).astype(np.float32) * 0.05 for _ in range(L)]
    qls = [je.quantize_linear(jnp.asarray(wl), mode, group_size=g) for wl in w]
    stack = {f: np.stack([np.asarray(getattr(q, f)) for q in qls]) for f in ("data", "scale", "mult")
             if getattr(qls[0], f) is not None}
    in_scale = np.array([0.031, 0.047], np.float32)
    jq = je.QuantLinear(*(jnp.asarray(stack[f]) for f in ("data", "scale")), mode=mode,
                        group_size=qls[0].group_size, paired=qls[0].paired,
                        mult=jnp.asarray(stack["mult"]) if "mult" in stack else None,
                        in_scale=jnp.asarray(in_scale))
    tq = te.QuantLinear(_t(stack["data"]), _t(stack["scale"]), mode=mode,
                        group_size=qls[0].group_size, paired=qls[0].paired,
                        mult=_t(stack["mult"]) if "mult" in stack else None,
                        in_scale=_t(in_scale))
    xj, xt = _act((M, K), seed=13)
    for layer in range(L):
        # WHEN each layer is applied THEN the outputs are bit-equal
        a = _jit(lambda q, x: q.call_layer(x, jnp.int32(layer), out_dtype=jnp.float32), jq, xj)
        b = tq.call_layer(xt, layer, out_dtype=torch.float32)
        _eq(a, b)


@pytest.mark.parametrize("mode", MODES)
def test_quantize_linear_and_apply(mode):
    # GIVEN a dense weight quantized by both packages
    rs = np.random.RandomState(1)
    w = rs.randn(512, 40).astype(np.float32) * 0.05
    qj = je.quantize_linear(jnp.asarray(w), mode, group_size=128)
    qt = te.quantize_linear(torch.from_numpy(w), mode, group_size=128)
    # THEN the frozen arrays are equal
    for f in ("data", "scale"):
        _eq(getattr(qj, f), getattr(qt, f))
    assert qt.mode == mode and qt.group_size == qj.group_size
    # WHEN applied at 6 rows (the GEMV) and 260 rows (the prefill route)
    for M, seed in ((6, 2), (260, 3)):
        xj, xt = _act((2, M // 2, 512), seed)
        fn = {"w4a8": _jax_w4a8_tpu, "w4a16": _jax_w4a16_tpu}.get(mode)
        with pytest.MonkeyPatch.context() as mp:
            if fn is not None:
                mp.setattr(je, f"matmul_{mode}", fn)
            a = _np(_jit(lambda q, x: q(x, out_dtype=jnp.float32), qj, xj))
        b = qt(xt, out_dtype=torch.float32).numpy()
        assert b.shape == a.shape == (2, M // 2, 40)
        if mode == "w4a16" or M > 256 and mode == "w4a8":
            # THEN within the stated tolerance where f32 sums change order
            tol = W4_F32_RTOL if M <= 256 else 1e-5
            assert np.abs(a - b).max() <= tol * np.abs(a).max()
        else:
            # THEN bit-equal where the product is exact in integers
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fused", [False, True])
def test_convert_carries_mode_byte_for_byte(mode, fused):
    # GIVEN the JAX package's random stacked weights of the mode
    cfg = JConfig.tiny()
    params, layers = js.random_stacked_params(cfg, mode, group_size=32, seed=0)
    if fused:
        layers = js.fuse_stacked_layers(layers)
    flat = jax_to_flat(params, layers)
    # WHEN carried into the port and back THEN every array is byte-equal
    tp, tl = params_from_flat(flat, device="cpu")
    back = params_to_flat(tp, tl)
    assert set(back) == set(flat)
    for key, a in flat.items():
        assert np.ascontiguousarray(a).tobytes() == np.ascontiguousarray(back[key]).tobytes(), key
    assert tl.down_proj.mode == tp.lm_head.mode == mode


@pytest.mark.parametrize("mode", MODES)
def test_random_stacked_params_layouts(mode):
    # the port's random weights have the JAX package's shapes and dtypes
    cfg = TConfig.tiny()
    tp, tl = ts.random_stacked_params(cfg, mode, group_size=32, seed=0, device="cpu")
    jp, jl = js.random_stacked_params(JConfig.tiny(), mode, group_size=32, seed=0)
    for name in ("q_proj", "o_proj", "down_proj"):
        for f in ("data", "scale"):
            a, b = getattr(getattr(jl, name), f), getattr(getattr(tl, name), f)
            assert tuple(a.shape) == tuple(b.shape) and str(a.dtype) == str(b.dtype).split(".")[1]
    assert tp.lm_head.mode == jp.lm_head.mode == mode
    assert tuple(tp.lm_head.scale.shape) == tuple(jp.lm_head.scale.shape)
    with pytest.raises(ValueError, match="unknown mode"):
        ts.random_stacked_params(cfg, "bogus", device="cpu")


# --- end to end --------------------------------------------------------------

# hidden 256, head dim 128 (flash prefill), 2 query heads per kv head;
# intermediate 1152 = 36 groups of 32, so the down projection's W4A8 sum
# takes XLA's window tree and the others its fused multiply-add chain
_KW = dict(vocab_size=256, hidden_size=256, intermediate_size=1152, num_layers=2,
           num_heads=2, num_kv_heads=1, head_dim=128, max_seq_len=512)


@pytest.fixture(scope="module", params=MODES)
def mode_models(request):
    jc, tc = JConfig(**_KW, dtype=jnp.float32), TConfig(**_KW, dtype=torch.float32)
    params, layers = js.random_stacked_params(jc, request.param, group_size=32, seed=2)
    layers = js.fuse_stacked_layers(layers)
    tp, tl = params_from_flat(jax_to_flat(params, layers), device="cpu")
    return request.param, jc, params, layers, tc, tp, tl


def _margin(logits):
    top2 = np.sort(np.asarray(logits), axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


def _rel_rms(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2) / np.mean(a ** 2)))


# Relative RMS error of the 288-row prefill logits. Its dense product sums
# in f32 in another order than XLA's CPU dot; where that moves a bf16
# projection output by one ulp, a quantized activation level moves and the
# random model carries it to later positions (measured 0.0012-0.0023).
PREFILL_288_RMS = 1e-2


@pytest.mark.parametrize("B,T", [(2, 8), (3, 96)])
def test_greedy_tokens_match_jax(mode_models, routes, monkeypatch, B, T):
    # GIVEN a 2-layer model of the mode in both packages, B prompts of T
    # tokens (16 prefill rows: the GEMVs; 288: the dequant + dense product,
    # the lm_head included) on a 128-token slab; the JAX side on its TPU
    # routing through the shims
    mode, jc, jp, jl, tc, tp, tl = mode_models
    monkeypatch.setattr(je, "matmul_w4a8", _jax_w4a8_tpu)
    monkeypatch.setattr(je, "matmul_w4a16", _jax_w4a16_tpu)
    S, steps = 128, 6
    ids = np.random.RandomState(B * T).randint(0, jc.vocab_size, (B, T))
    jcache = js.StackedKVCache.create(jc.num_layers, B, S, jc.num_kv_heads, jc.head_dim)
    tcache = ts.StackedKVCache.create(tc.num_layers, B, S, tc.num_kv_heads, tc.head_dim,
                                      device="cpu")
    # WHEN both prefill, with logits at every position
    jlogits, jcache = _jit(lambda p, l, c, i: js.serving_forward_stacked(p, l, jc, i, cache=c),
                           jp, jl, jcache, jnp.asarray(ids))
    tlogits, tcache = ts.serving_forward_stacked(tp, tl, tc, torch.from_numpy(ids), cache=tcache)
    jlogits, tl_np = np.asarray(jlogits), tlogits.numpy()
    assert tl_np.shape == jlogits.shape == (B, T, jc.vocab_size)
    assert tcache.length == int(jcache.length) == T
    if B * T <= 256:
        # THEN through the GEMVs the logits are bit-equal
        np.testing.assert_array_equal(jlogits, tl_np)
    else:
        # THEN through the dense product within the stated RMS error; at
        # position 0 (one key) within 1e-3 of the largest. The decode then
        # starts from JAX's cache in both, so that it compares the loops and
        # not the prefill's sum order (which moves a greedy token of w4a8
        # here: JAX's top-2 margin 0.058 against prefill logit differences
        # up to 0.031)
        assert _rel_rms(jlogits, tl_np) <= PREFILL_288_RMS
        assert np.abs(jlogits[:, 0] - tl_np[:, 0]).max() <= 1e-3 * np.abs(jlogits).max()
        tcache = ts.StackedKVCache(*(torch.from_numpy(np.array(getattr(jcache, f)))
                                     for f in ("k", "v", "k_scale", "v_scale")), length=T)
    # WHEN both decode greedy tokens from the last position
    first = jnp.argmax(jlogits[:, -1], axis=-1).astype(jnp.int32)[:, None]
    monkeypatch.setenv("FF_KV_STACKED", "force")
    loop = js.make_stacked_decode_loop(jc, steps, donate=False)
    jtok, _ = _jit(loop, jp, jl, jcache, first)
    ttok, tcache = ts.make_stacked_decode_loop(tc, steps)(
        tp, tl, tcache, torch.from_numpy(np.array(first)).long())
    jtok, ttok = np.asarray(jtok), ttok.numpy()
    # THEN the tokens are equal; on a difference, report the step and JAX's
    # top-2 logit margin there
    if not np.array_equal(jtok, ttok):
        step = int(np.argmax((jtok != ttok).any(axis=0)))
        seq = np.concatenate([ids, np.asarray(first), jtok[:, :step]], axis=1)
        ref, _ = js.serving_forward_stacked(
            jp, jl, jc, jnp.asarray(seq),
            cache=js.StackedKVCache.create(jc.num_layers, B, S, jc.num_kv_heads, jc.head_dim))
        pytest.fail(f"{mode}: greedy tokens differ at step {step}: jax {jtok[:, step]} vs port "
                    f"{ttok[:, step]}; jax top-2 margin {_margin(np.asarray(ref)[:, -1])}")
    assert tcache.length == T + steps
    assert {"port fused tail", "jax fused tail"}.isdisjoint(routes)
