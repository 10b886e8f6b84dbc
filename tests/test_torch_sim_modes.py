"""The sim tier (``sim_w8``, ``sim_w4``: bench.py's baseline) of the port
against the JAX package on the CPU.

The weights stay dense bf16 and are quantized and dequantized in f32 on
every use, then one bf16 product. The quantize-dequantize is the same f32
arithmetic in both packages (a true division, round half to even, clip,
product). The product is bf16 x bf16 with f32 sums rounded once to bf16:
PyTorch's CPU GEMM and XLA's CPU dot block the sums differently at some
shapes, so an output is held within one bf16 ulp of JAX's (the f32
out_dtype is the bf16 product cast, as in JAX). End to end: greedy tokens
of a 2-layer model in each mode, made by the JAX package and carried by
`params_from_flat`, equal to the jitted JAX decode loop's, the prefill
logits within a relative RMS error (`SIM_LOGIT_RMS`). Both sides compile with
``xla_allow_excess_precision=False`` and the JAX side takes the TPU routing
of attention (`tests/test_torch_batching.py` ``routes``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastforward_tpu.models.llama import LlamaConfig as JConfig
from fastforward_tpu.serving import engine as je
from fastforward_tpu.serving import stacked as js
from fastforward_tpu_torch.models.llama import LlamaConfig as TConfig
from fastforward_tpu_torch.serving import engine as te
from fastforward_tpu_torch.serving import stacked as ts
from fastforward_tpu_torch.serving.convert import params_from_flat, params_to_flat
from tests.test_torch_batching import routes  # noqa: F401  (fixture)
from tests.test_torch_serving import jax_to_flat

EXACT = {"xla_allow_excess_precision": False}
SIM = ["sim_w8", "sim_w4"]
# Relative RMS error of the 16-row prefill logits. A projection output one
# bf16 ulp apart (the two CPU products' sum orders) moves the next layer's
# bf16 inputs, and the random model carries it on (measured 0.0031 sim_w8,
# 0.00076 sim_w4); the greedy tokens are equal.
SIM_LOGIT_RMS = 1e-2


def _jit(fn, *args):
    f = jax.jit(fn)
    return f.lower(*args).compile(compiler_options=EXACT)(*args)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _within_ulp(a, b):
    """``b`` within one bf16 ulp of each value of ``a``."""
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(a), np.finfo(np.float32).tiny))) - 7)
    return bool((np.abs(a - b) <= ulp).all())


def _sim_weights(mode, L, K, N, g, seed):
    rs = np.random.RandomState(seed)
    w = jnp.asarray((rs.randn(L, K, N) / np.sqrt(K)).astype(np.float32)).astype(jnp.bfloat16)
    shape = (L, N) if mode == "sim_w8" else (L, K // g, N)
    s = (rs.rand(*shape) * 0.05 / np.sqrt(K) + 1e-3).astype(np.float32)
    wt = torch.from_numpy(np.array(w.astype(jnp.float32))).to(torch.bfloat16)
    return w, jnp.asarray(s), wt, torch.from_numpy(s)


# sim_w8; sim_w4 at g 16 and at the g = K fallback (K % g != 0 in JAX's
# random_stacked_params gives g = K: here K = 96)
@pytest.mark.parametrize("mode,K,g", [("sim_w8", 256, 128), ("sim_w4", 256, 16),
                                      ("sim_w4", 96, 96)])
@pytest.mark.parametrize("M", [1, 8, 300])
def test_quant_linear_matches_jax(mode, K, g, M):
    # GIVEN two stacked layers of dense bf16 weights and their scales
    N = 48
    wj, sj, wt, st = _sim_weights(mode, 2, K, N, g, seed=K + g)
    qj = je.QuantLinear(wj, sj, mode=mode, group_size=g)
    qt = te.QuantLinear(wt, st, mode=mode, group_size=g)
    x = np.random.RandomState(M).randn(M, K).astype(np.float32)
    xj, xt = jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    for out_dtype in ("bfloat16", "float32"):
        # WHEN layer 1 is applied by both packages (JAX slices the layer and
        # calls the layer's projection, as the port's call_layer does)
        a = _f32(_jit(lambda q, x: q.call_layer(x, jnp.int32(1), out_dtype=getattr(jnp, out_dtype)),
                      qj, xj))
        b = qt.call_layer(xt, 1, out_dtype=getattr(torch, out_dtype))
        # THEN within one bf16 ulp, in the requested dtype
        assert b.dtype == getattr(torch, out_dtype) and b.shape == (M, N)
        assert _within_ulp(a, _f32(b))
    # AND the fake-quantized weight itself is bit-equal to JAX's
    ref = wj[1].astype(jnp.float32)
    if mode == "sim_w8":
        ref = jnp.clip(jnp.round(ref / sj[1][None, :]), -128, 127) * sj[1][None, :]
    else:
        wg = ref.reshape(K // g, g, N)
        ref = (jnp.clip(jnp.round(wg / sj[1][:, None, :]), -8, 7) * sj[1][:, None, :]).reshape(K, N)
    np.testing.assert_array_equal(np.asarray(ref), te.sim_weight(wt[1], st[1], mode, g).numpy())


@pytest.mark.parametrize("mode", SIM)
def test_random_stacked_params_and_convert(mode):
    # GIVEN a tiny config with a K that is not a multiple of the group
    kw = dict(vocab_size=64, hidden_size=96, intermediate_size=192, num_layers=2, num_heads=2,
              num_kv_heads=1, head_dim=48, max_seq_len=64)
    jp, jl = js.random_stacked_params(JConfig(**kw), mode, group_size=64, seed=0)
    tp, tl = ts.random_stacked_params(TConfig(**kw), mode, group_size=64, seed=0, device="cpu")
    # THEN the port's random weights have JAX's shapes, group sizes (the g =
    # K fallback at K = 96) and scales. The data is dense bf16 in the port;
    # JAX's is float32 (its bf16 normals divided by a numpy float64 scalar
    # promote), which the sim product reads the same way
    for name in ("q_proj", "o_proj", "gate_proj", "down_proj"):
        a, b = getattr(jl, name), getattr(tl, name)
        assert (a.mode, a.group_size) == (b.mode, b.group_size)
        assert tuple(a.data.shape) == tuple(b.data.shape) and b.data.dtype == torch.bfloat16
        assert a.data.dtype == jnp.float32
        np.testing.assert_array_equal(np.asarray(a.scale), b.scale.numpy())
    assert tl.q_proj.group_size == (96 if mode == "sim_w4" else 128)
    assert tp.lm_head.mode == jp.lm_head.mode == mode
    assert tuple(tp.lm_head.scale.shape) == tuple(jp.lm_head.scale.shape)
    # AND the JAX weights carry into the port and back byte for byte, fused
    layers = js.fuse_stacked_layers(jl)
    flat = jax_to_flat(jp, layers)
    cp, cl = params_from_flat(flat, device="cpu")
    back = params_to_flat(cp, cl)
    assert set(back) == set(flat)
    for key, a in flat.items():
        assert np.ascontiguousarray(a).tobytes() == np.ascontiguousarray(back[key]).tobytes(), key
    assert cl.qkv_proj.mode == mode


# hidden 256, head dim 128 (flash prefill), 2 query heads per kv head; at
# group 96 sim_w4 takes the g = K fallback on hidden (256) and g 96 on the
# down projection (K = 1,152)
_KW = dict(vocab_size=256, hidden_size=256, intermediate_size=1152, num_layers=2,
           num_heads=2, num_kv_heads=1, head_dim=128, max_seq_len=512)


@pytest.fixture(scope="module", params=SIM)
def sim_models(request):
    jc, tc = JConfig(**_KW, dtype=jnp.float32), TConfig(**_KW, dtype=torch.float32)
    params, layers = js.random_stacked_params(jc, request.param, group_size=96, seed=4)
    layers = js.fuse_stacked_layers(layers)
    tp, tl = params_from_flat(jax_to_flat(params, layers), device="cpu")
    return request.param, jc, params, layers, tc, tp, tl


def test_greedy_tokens_match_jax(sim_models, routes):
    # GIVEN a 2-layer model of the mode in both packages, 2 prompts of 8
    # tokens on a 128-token int8 slab
    mode, jc, jp, jl, tc, tp, tl = sim_models
    assert jl.down_proj.group_size == (96 if mode == "sim_w4" else 128)
    B, T, S, steps = 2, 8, 128, 6
    ids = np.random.RandomState(B * T).randint(0, jc.vocab_size, (B, T))
    jcache = js.StackedKVCache.create(jc.num_layers, B, S, jc.num_kv_heads, jc.head_dim)
    tcache = ts.StackedKVCache.create(tc.num_layers, B, S, tc.num_kv_heads, tc.head_dim,
                                      device="cpu")
    # WHEN both prefill with logits at every position
    jlogits, jcache = _jit(lambda p, l, c, i: js.serving_forward_stacked(p, l, jc, i, cache=c),
                           jp, jl, jcache, jnp.asarray(ids))
    tlogits, tcache = ts.serving_forward_stacked(tp, tl, tc, torch.from_numpy(ids), cache=tcache)
    # THEN the logits agree within the stated relative RMS error
    a, b = np.asarray(jlogits), tlogits.numpy()
    assert np.sqrt(np.mean((a - b) ** 2) / np.mean(a ** 2)) <= SIM_LOGIT_RMS
    # WHEN both decode greedy tokens from the last position
    first = jnp.argmax(jlogits[:, -1], axis=-1).astype(jnp.int32)[:, None]
    loop = js.make_stacked_decode_loop(jc, steps, donate=False)
    jtok, _ = _jit(loop, jp, jl, jcache, first)
    ttok, tcache = ts.make_stacked_decode_loop(tc, steps)(
        tp, tl, tcache, torch.from_numpy(np.array(first)).long())
    # THEN the tokens are equal
    np.testing.assert_array_equal(np.asarray(jtok), ttok.numpy())
    assert tcache.length == T + steps
