"""The port's serving path against the JAX package on the CPU.

Weights are made by the JAX package and carried into the port by
`fastforward_tpu_torch.serving.convert`, byte for byte, so both packages
compute the same function on the same bits.

The end-to-end comparison compiles the JAX prefill and decode loop with
``xla_allow_excess_precision=False``. By default XLA may keep f32 values
where the program rounds to bf16 (between RMSNorm and the activation
quantizer, for instance); the A4 activation grid has 16 levels, so such a
difference moves a quantized value now and then, and a random tiny model
amplifies it. With the flag off, XLA computes the function as written,
which is what the port computes eagerly.
"""

import dataclasses

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

EXACT = {"xla_allow_excess_precision": False}


def jax_to_flat(params, layers):
    """Flat {path: numpy} dict of a JAX ServingParams and stacked layers."""
    flat = {"params.embedding": np.asarray(params.embedding),
            "params.final_norm": np.asarray(params.final_norm)}

    def put(prefix, ql):
        for f in dataclasses.fields(ql):
            value = getattr(ql, f.name)
            if value is not None:
                flat[f"{prefix}.{f.name}"] = np.asarray(value)

    if params.lm_head is not None:
        put("params.lm_head", params.lm_head)
    for f in dataclasses.fields(layers):
        value = getattr(layers, f.name)
        if isinstance(value, je.QuantLinear):
            put(f"layers.{f.name}", value)
        else:
            flat[f"layers.{f.name}"] = np.asarray(value)
    return flat


def _bytes(a):
    return np.ascontiguousarray(a).tobytes()


@pytest.fixture(scope="module")
def jax_tiny():
    """JAX random_stacked_params(tiny, "w4a4_2l", group 32), unfused. Its A4
    layer weights are packed with pack_int4, not the vertical layout
    (stacked.py:219-247); both packages read those bytes as vertical
    nibbles, so parity is unaffected."""
    return js.random_stacked_params(JConfig.tiny(), "w4a4_2l", group_size=32, seed=0)


@pytest.mark.parametrize("fused", [False, True])
def test_convert_round_trip_byte_equal(jax_tiny, fused):
    # GIVEN the JAX tiny W4A4 weights, stacked or fused
    params, layers = jax_tiny
    if fused:
        layers = js.fuse_stacked_layers(layers)
    flat = jax_to_flat(params, layers)
    # WHEN carried into the port and back to numpy
    back = params_to_flat(*params_from_flat(flat, device="cpu"))
    # THEN every array is byte-equal and every static field survives
    assert set(back) == set(flat)
    for key, a in flat.items():
        assert _bytes(a) == _bytes(back[key]), key
        assert a.shape == back[key].shape, key


@pytest.mark.parametrize("mode", ["w4a4_2l", "w4a8_2l"])
def test_quantize_linear_and_quant_linear_bit_exact(mode):
    # GIVEN a dense weight quantized by both packages
    rs = np.random.RandomState(0)
    w = rs.randn(128, 48).astype(np.float32) * 0.05
    qj = je.quantize_linear(jnp.asarray(w), mode, group_size=32)
    qt = te.quantize_linear(torch.from_numpy(w), mode, group_size=32)
    for f in ("data", "scale", "mult"):
        np.testing.assert_array_equal(np.asarray(getattr(qj, f)), getattr(qt, f).numpy())
    assert qj.paired == qt.paired
    # WHEN applied to the same activations THEN the outputs are bit-equal
    x = rs.randn(2, 3, 128).astype(np.float32)
    xj, xt = jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    a = jax.jit(lambda q, x: q(x, out_dtype=jnp.float32))(qj, xj)
    b = qt(xt, out_dtype=torch.float32)
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_quant_linear_rejects_what_is_not_ported():
    ql = te.QuantLinear(torch.zeros(4, 4, dtype=torch.int8), torch.ones(4), mode="w8a8")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ql(torch.zeros(1, 4))
    with pytest.raises(NotImplementedError):
        te.quantize_linear(torch.zeros(8, 4), "w4a16")
    w = torch.randn(64, 8)
    ql = te.quantize_linear(w, "w4a4_2l", group_size=32)
    with pytest.raises(NotImplementedError, match="next slice"):
        ql(torch.zeros(257, 64, dtype=torch.bfloat16))


@pytest.fixture(scope="module", params=["w4a4_2l", "w4a8_2l"])
def tiny_models(request, jax_tiny):
    jc = JConfig.tiny()
    if request.param == "w4a4_2l":
        params, layers = jax_tiny
    else:
        params, layers = js.random_stacked_params(jc, "w4a8_2l", group_size=32, seed=0)
    layers = js.fuse_stacked_layers(layers)
    tp, tl = params_from_flat(jax_to_flat(params, layers), device="cpu")
    return jc, params, layers, TConfig.tiny(), tp, tl


def _margin(logits):
    top2 = np.sort(np.asarray(logits), axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


def test_tiny_prefill_and_greedy_decode_match_jax(tiny_models, monkeypatch):
    # GIVEN tiny Llama W4A4 (or W4A8) g32 (lm_head W4A8 with 2 groups: the
    # paired layout) in both packages, 2 prompts of 8 tokens, a 32-token slab
    jc, jp, jl, tc, tp, tl = tiny_models
    B, T, S, steps = 2, 8, 32, 8
    ids = np.random.RandomState(0).randint(0, jc.vocab_size, (B, T))
    jcache = js.StackedKVCache.create(jc.num_layers, B, S, jc.num_kv_heads, jc.head_dim)
    tcache = ts.StackedKVCache.create(tc.num_layers, B, S, tc.num_kv_heads, tc.head_dim,
                                      device="cpu")
    prefill = jax.jit(lambda p, l, c, i: js.serving_forward_stacked(
        p, l, jc, i, cache=c, logits_positions="last"))
    args = (jp, jl, jcache, jnp.asarray(ids))
    jlogits, jcache = prefill.lower(*args).compile(compiler_options=EXACT)(*args)
    tlogits, tcache = ts.serving_forward_stacked(tp, tl, tc, torch.from_numpy(ids),
                                                 cache=tcache, logits_positions="last")
    # THEN the last-position logits agree within 1e-3 of the largest logit
    jlogits = np.asarray(jlogits)
    assert tlogits.shape == jlogits.shape == (B, 1, jc.vocab_size)
    assert np.abs(jlogits - tlogits.numpy()).max() <= 1e-3 * np.abs(jlogits).max()
    assert tcache.length == int(jcache.length) == T

    # WHEN both decode 8 greedy tokens (JAX through its stacked-KV flow, the
    # port through its append and flash-decode wrappers and fused argmax head)
    first = jnp.argmax(jlogits[:, -1], axis=-1).astype(jnp.int32)[:, None]
    monkeypatch.setenv("FF_KV_STACKED", "force")
    loop = js.make_stacked_decode_loop(jc, steps, donate=False)
    largs = (jp, jl, jcache, first)
    jtok, _ = loop.lower(*largs).compile(compiler_options=EXACT)(*largs)
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
        pytest.fail(f"greedy tokens differ at step {step}: jax {jtok[:, step]} vs port "
                    f"{ttok[:, step]}; jax top-2 margin {_margin(np.asarray(ref)[:, -1])}")
    assert tcache.length == T + steps


def test_tiny_decode_unfused_layers_match_fused(jax_tiny):
    # the fused (qkv, gate/up) and per-projection stacked layers give the
    # same greedy tokens: N-axis concatenation is exact
    tc = TConfig.tiny()
    tp, tl_unfused = params_from_flat(jax_to_flat(*jax_tiny), device="cpu")
    tl_fused = ts.fuse_stacked_layers(tl_unfused)
    ids = torch.from_numpy(np.random.RandomState(1).randint(0, tc.vocab_size, (2, 6)))
    out = []
    for layers_t in (tl_unfused, tl_fused):
        cache = ts.StackedKVCache.create(tc.num_layers, 2, 16, tc.num_kv_heads, tc.head_dim,
                                         device="cpu")
        logits, cache = ts.serving_forward_stacked(tp, layers_t, tc, ids, cache=cache)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        toks, _ = ts.make_stacked_decode_loop(tc, 4)(tp, layers_t, cache, tok)
        out.append((logits, toks))
    torch.testing.assert_close(out[0][0], out[1][0], rtol=0, atol=0)
    assert torch.equal(out[0][1], out[1][1])


def test_no_cache_forward_and_limits(tiny_models):
    jc, jp, jl, tc, tp, tl = tiny_models
    ids = np.random.RandomState(2).randint(0, jc.vocab_size, (2, 5))
    fwd = jax.jit(lambda p, l, i: js.serving_forward_stacked(p, l, jc, i)[0])
    a = fwd.lower(jp, jl, jnp.asarray(ids)).compile(compiler_options=EXACT)(jp, jl, jnp.asarray(ids))
    b, cache = ts.serving_forward_stacked(tp, tl, tc, torch.from_numpy(ids))
    assert cache is None
    assert np.abs(np.asarray(a) - b.numpy()).max() <= 1e-3 * np.abs(np.asarray(a)).max()
    # prefill of more than 256 rows is the next slice of the port
    with pytest.raises(NotImplementedError, match="next slice"):
        ts.serving_forward_stacked(tp, tl, tc, torch.zeros((2, 129), dtype=torch.long))
    with pytest.raises(NotImplementedError):
        ts.random_stacked_params(tc, "w8a8", device="cpu")
