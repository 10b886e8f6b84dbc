"""The port's serving path against the JAX package on the CPU.

Weights are made by the JAX package and carried into the port by
`fastforward_tpu_torch.serving.convert`, byte for byte, so both packages
compute the same function on the same bits.

The JAX side runs with ``fastforward_tpu.serving.engine._on_tpu`` read as
true where a test crosses 256 rows: the port takes the JAX package's TPU
routing on every device, so its prefill projections dequantize and take a
dense product; the JAX kernels they reach run their own CPU paths.

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


@pytest.fixture
def tpu_routing(monkeypatch):
    """The JAX engine's TPU routing (dequant + dot prefill, stacked W4A8
    GEMV); each kernel it reaches runs its CPU path."""
    monkeypatch.setattr(je, "_on_tpu", lambda: True)


@pytest.fixture(scope="module")
def jax_tiny():
    """JAX random_stacked_params(tiny, "w4a4_2l", group 32), unfused. Its A4
    layer weights are packed with pack_int4, not the vertical layout
    (stacked.py:219-247); both packages read those bytes as vertical
    nibbles, so parity is unaffected."""
    return js.random_stacked_params(JConfig.tiny(), "w4a4_2l", group_size=32, seed=0)


@pytest.mark.parametrize("mode", ["w4a4_2l", "w4a8_2l"])
@pytest.mark.parametrize("fused", [False, True])
def test_convert_round_trip_byte_equal(jax_tiny, fused, mode):
    # GIVEN the JAX tiny W4A4 (or fused-capable paired W4A8) weights,
    # stacked or fused
    params, layers = jax_tiny if mode == "w4a4_2l" else js.random_stacked_params(
        JConfig.tiny(), mode, group_size=32, seed=0)
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


def test_quant_linear_rejects_what_is_not_ported(tpu_routing):
    ql = te.QuantLinear(torch.zeros(4, 4, dtype=torch.int8), torch.ones(4), mode="w8a8")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ql(torch.zeros(1, 4))
    with pytest.raises(NotImplementedError):
        te.quantize_linear(torch.zeros(8, 4), "w4a16")
    # more than 256 rows take the prefill dequant + dense product, as the
    # JAX package's TPU route does: within 1e-5 of the largest output (the
    # f32 sums run in another order)
    rs = np.random.RandomState(3)
    w = rs.randn(128, 24).astype(np.float32) * 0.05
    x = rs.randn(257, 128).astype(np.float32)
    for mode in ("w4a4_2l", "w4a8_2l"):
        qj = je.quantize_linear(jnp.asarray(w), mode, group_size=32)
        qt = te.quantize_linear(torch.from_numpy(w), mode, group_size=32)
        a = np.asarray(jax.jit(lambda q, x: q(x, out_dtype=jnp.float32))(
            qj, jnp.asarray(x).astype(jnp.bfloat16)))
        b = qt(torch.from_numpy(x).to(torch.bfloat16), out_dtype=torch.float32).numpy()
        assert np.abs(a - b).max() <= 1e-5 * np.abs(a).max(), mode
    # the unpaired (group-halves) W4A8 prefill dequant is not ported
    ql = te.quantize_linear(torch.from_numpy(w[:96]), "w4a8_2l", group_size=32)
    assert not ql.paired
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ql(torch.zeros(257, 96, dtype=torch.bfloat16))


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


def _rel_rms(a, b):
    """Relative RMS difference ||a - b|| / ||a||."""
    return float(np.sqrt(((a - b) ** 2).mean() / (a ** 2).mean()))


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
    # port through its append and flash-decode wrappers and fused argmax head;
    # in w4a8_2l both through the fused layer tail, JAX's on its TPU route)
    first = jnp.argmax(jlogits[:, -1], axis=-1).astype(jnp.int32)[:, None]
    monkeypatch.setenv("FF_KV_STACKED", "force")
    monkeypatch.setattr(js, "_serving_on_tpu", lambda: True)
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


def test_no_cache_forward_and_limits(tiny_models, tpu_routing):
    jc, jp, jl, tc, tp, tl = tiny_models
    fwd = jax.jit(lambda p, l, i: js.serving_forward_stacked(p, l, jc, i)[0])
    # 10 rows take the GEMVs: within 1e-3 of the largest logit
    ids = np.random.RandomState(2).randint(0, jc.vocab_size, (2, 5))
    a = fwd.lower(jp, jl, jnp.asarray(ids)).compile(compiler_options=EXACT)(
        jp, jl, jnp.asarray(ids))
    b, cache = ts.serving_forward_stacked(tp, tl, tc, torch.from_numpy(ids))
    assert cache is None
    assert np.abs(np.asarray(a) - b.numpy()).max() <= 1e-3 * np.abs(np.asarray(a)).max()
    # 258 rows take the prefill dequant + dense product. Its f32 sums run in
    # another order than XLA's dot; where that moves a bf16 projection output
    # by one ulp, a quantized activation level can move and the tiny random
    # model carries it to the later positions of that sequence. Held as a
    # relative RMS error of the logits within 2e-2.
    ids = np.random.RandomState(2).randint(0, jc.vocab_size, (2, 129))
    a = np.asarray(fwd.lower(jp, jl, jnp.asarray(ids)).compile(compiler_options=EXACT)(
        jp, jl, jnp.asarray(ids)))
    b = ts.serving_forward_stacked(tp, tl, tc, torch.from_numpy(ids))[0].numpy()
    assert _rel_rms(a, b) <= 2e-2
    with pytest.raises(NotImplementedError):
        ts.random_stacked_params(tc, "w8a8", device="cpu")


# Relative RMS error of the prefill logits, per mode. The port attends
# through flash_prefill (on the CPU its f32 reference); the JAX package off
# the TPU through its dense path, with bf16 K/V and bf16 softmax weights. On
# a random model the activation quantizer amplifies that difference, the
# 16-level A4 grid most (measured 0.238 for w4a4_2l, 0.030 for w4a8_2l).
WIDE_LOGITS_RMS = {"w4a4_2l": 0.35, "w4a8_2l": 0.06}


@pytest.fixture(scope="module", params=["w4a4_2l", "w4a8_2l"])
def wide_head_models(request):
    """A narrow Llama with head dim 128 (the flash-prefill branch), 2
    layers, groups of 64, built by the JAX package and fused."""
    jc = dataclasses.replace(JConfig.tiny(), hidden_size=256, intermediate_size=512,
                             num_heads=2, num_kv_heads=1, head_dim=128)
    params, layers = js.random_stacked_params(jc, request.param, group_size=64, seed=1)
    layers = js.fuse_stacked_layers(layers)
    tc = dataclasses.replace(TConfig.tiny(), hidden_size=256, intermediate_size=512,
                             num_heads=2, num_kv_heads=1, head_dim=128)
    tp, tl = params_from_flat(jax_to_flat(params, layers), device="cpu")
    return request.param, jc, params, layers, tc, tp, tl


def test_prefill_over_256_rows_and_greedy_decode_match_jax(wide_head_models, tpu_routing,
                                                           monkeypatch):
    # GIVEN 3 prompts of 96 tokens (288 prefill rows) on a 128-token slab
    mode, jc, jp, jl, tc, tp, tl = wide_head_models
    B, T, S, steps = 3, 96, 128, 4
    ids = np.random.RandomState(5).randint(0, jc.vocab_size, (B, T))
    jcache = js.StackedKVCache.create(jc.num_layers, B, S, jc.num_kv_heads, jc.head_dim)
    tcache = ts.StackedKVCache.create(tc.num_layers, B, S, tc.num_kv_heads, tc.head_dim,
                                      device="cpu")
    # WHEN both prefill with all-position logits: the projections and the
    # lm_head (288 rows) dequantize and take a dense product
    prefill = jax.jit(lambda p, l, c, i: js.serving_forward_stacked(p, l, jc, i, cache=c))
    args = (jp, jl, jcache, jnp.asarray(ids))
    jlogits, jcache = prefill.lower(*args).compile(compiler_options=EXACT)(*args)
    tlogits, tcache = ts.serving_forward_stacked(tp, tl, tc, torch.from_numpy(ids), cache=tcache)
    jlogits, tl_np = np.asarray(jlogits), tlogits.numpy()
    # THEN the logits agree within the stated RMS error; at position 0 the
    # attention sees one key, computes the same value in both, and the
    # logits agree within 1e-3 of the largest
    assert tlogits.shape == jlogits.shape == (B, T, jc.vocab_size)
    assert _rel_rms(jlogits, tl_np) <= WIDE_LOGITS_RMS[mode]
    assert np.abs(jlogits[:, 0] - tl_np[:, 0]).max() <= 1e-3 * np.abs(jlogits).max()
    assert tcache.length == int(jcache.length) == T

    # WHEN both decode greedy tokens from the last position (the W4A8 mode
    # through the stacked W4A8 GEMV and the fused layer tail in both
    # packages, JAX's on its TPU route)
    first = jnp.argmax(jlogits[:, -1], axis=-1).astype(jnp.int32)[:, None]
    monkeypatch.setenv("FF_KV_STACKED", "force")
    monkeypatch.setattr(js, "_serving_on_tpu", lambda: True)
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
