"""The port's per-layer serving path (`serving_forward`, `make_decode_loop`,
`random_serving_params`, `stack_serving_layers`) against the JAX package,
on the CPU.

Weights are made by the JAX package's `random_serving_params` (a narrow
Llama: hidden 256, 2 layers, head dim 128 so that the flash routes are
taken, 2 query heads per kv head, groups of 64) and carried into the port
by `params_from_flat` in its per-layer form, byte for byte. The JAX side
takes its TPU routing: ``engine._on_tpu`` reads as true (decode through
`flash_decode_select`, the two-level prefill through the dequant and a
dense product), and `matmul_w4a8` / `matmul_w4a16` go through the shims of
`tests/test_torch_quant_modes.py` (their own ``_on_tpu`` would send the
CPU into ``pallas_call``); every JAX kernel reached runs its CPU path. Its
jitted forward and decode loop are compiled with
``xla_allow_excess_precision=False``.

Greedy tokens are compared in all five modes at 16 prefill rows, and in
the two two-level modes at 288 (`GREEDY_CASES`); a prefill at per-row
(2-D) positions is held against both JAX forwards, cache bytes included,
in one mode (`JAX_2D_MODE`).

Tolerances. The logits are held to a relative RMS error per mode
(`LOGITS_RMS`), and are bit-equal in most cases at 16 prefill rows (the
GEMVs; the integer modes exactly). Three f32 sums run in another order
than XLA's: the attention oracles' (`flash_prefill_reference`, the dense
grouped attention), the dense product of 288 prefill rows, and the W4A16
GEMV's; where one rounds a bf16 output the other way, a quantized
activation level moves and the random model carries it on. Where the
logits differ, the decode starts both loops from JAX's cache (as
`tests/test_torch_quant_modes.py` does at 288 rows), so it compares the
loops and not the prefill's sums; then the greedy tokens are equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastforward_tpu.models.llama import LlamaConfig as JConfig
from fastforward_tpu.serving import engine as je
from fastforward_tpu.serving import kv_cache as jkv
from fastforward_tpu.serving import stacked as js
from fastforward_tpu_torch.models.llama import LlamaConfig as TConfig
from fastforward_tpu_torch.serving import engine as te
from fastforward_tpu_torch.serving import kv_cache as tkv
from fastforward_tpu_torch.serving import stacked as ts
from fastforward_tpu_torch.serving.convert import params_from_flat, params_to_flat
from tests.test_torch_batching import routes  # noqa: F401  (fixture)
from tests.test_torch_quant_modes import _jax_w4a8_tpu, _jax_w4a16_tpu
from tests.test_torch_serving import jax_to_flat

EXACT = {"xla_allow_excess_precision": False}
MODES = ["w4a8_2l", "w4a8", "w4a16", "w8a8", "w4a4_2l"]
_KW = dict(vocab_size=256, hidden_size=256, intermediate_size=512, num_layers=2,
           num_heads=2, num_kv_heads=1, head_dim=128, max_seq_len=512)
# Relative RMS error of the prefill logits (see the module docstring); the
# 16-level A4 grid of w4a4_2l would amplify a moved level most.
LOGITS_RMS = {"w4a4_2l": 0.1, "w4a8_2l": 0.03, "w4a8": 0.01, "w4a16": 0.01, "w8a8": 0.05}
# Greedy tokens against JAX: (mode, tokens per prompt) with 2 prompts. All
# five modes at 16 prefill rows; 288 rows for the two-level modes only, as
# the float-scale modes' 288-row prefill route is held against JAX by
# tests/test_torch_quant_modes.py and the attention route does not depend on
# the mode.
GREEDY_CASES = [(m, 8) for m in MODES] + [("w4a8_2l", 144), ("w4a4_2l", 144)]
# The mode whose per-row-position prefill is also held against JAX's two
# forwards: the route does not depend on the mode, and JAX's slab flow takes
# seconds to compile in each.
JAX_2D_MODE = "w8a8"


def jax_params_to_flat(params):
    """Flat {path: numpy} dict of a per-layer JAX ServingParams."""
    flat = {"params.embedding": np.asarray(params.embedding),
            "params.final_norm": np.asarray(params.final_norm)}

    def put(prefix, ql):
        for f in dataclasses.fields(ql):
            value = getattr(ql, f.name)
            if value is not None:
                flat[f"{prefix}.{f.name}"] = np.asarray(value)

    if params.lm_head is not None:
        put("params.lm_head", params.lm_head)
    for i, layer in enumerate(params.layers):
        for f in dataclasses.fields(layer):
            value = getattr(layer, f.name)
            if isinstance(value, je.QuantLinear):
                put(f"layers.{i}.{f.name}", value)
            else:
                flat[f"layers.{i}.{f.name}"] = np.asarray(value)
    return flat


def _bytes(a):
    return np.ascontiguousarray(a).tobytes()


def _exact(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=EXACT)(*args)


@pytest.fixture
def tpu_route(monkeypatch):
    """The JAX engine's TPU routing, its float-scale products through the
    CPU-runnable shims."""
    monkeypatch.setattr(je, "_on_tpu", lambda: True)
    monkeypatch.setattr(je, "matmul_w4a8", _jax_w4a8_tpu)
    monkeypatch.setattr(je, "matmul_w4a16", _jax_w4a16_tpu)


@pytest.fixture(scope="module", params=MODES)
def models(request):
    jc, tc = JConfig(**_KW, dtype=jnp.float32), TConfig(**_KW, dtype=torch.float32)
    jp = je.random_serving_params(jc, request.param, group_size=64, seed=3)
    tp, stacked = params_from_flat(jax_params_to_flat(jp), device="cpu")
    assert stacked is None and len(tp.layers) == jc.num_layers
    return request.param, jc, jp, tc, tp


def _port_cache(jcache):
    """The port's KVCache holding the bytes of a JAX KVCache."""
    def t(a):
        if a is None:
            return None
        if a.dtype == jnp.bfloat16:  # exact through f32
            return torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
        return torch.from_numpy(np.array(a))
    return tkv.KVCache(layers=tuple(tkv.LayerKVCache(t(l.k), t(l.v), t(l.k_scale), t(l.v_scale))
                                    for l in jcache.layers), length=int(jcache.length))


def _rel_rms(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2) / np.mean(a ** 2)))


# Compiled JAX decode loops by (mode, quantized): both prefill shapes decode
# 2 rows on a 160-token cache, so one compile serves both.
_LOOPS = {}


@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("models,T", GREEDY_CASES, indirect=["models"])
def test_greedy_tokens_match_jax(models, tpu_route, quantized, T):
    # GIVEN a 2-layer model of the mode in both packages, 2 prompts of T
    # tokens (16 or 288 prefill rows) on a 160-token KVCache (int8 or bf16)
    mode, jc, jp, tc, tp = models
    B, S, steps = 2, 160, 4
    ids = np.random.RandomState(B * T).randint(0, jc.vocab_size, (B, T))
    jcache = jkv.KVCache.create(jc.num_layers, B, S, jc.num_kv_heads, jc.head_dim,
                                quantized=quantized)
    tcache = tkv.KVCache.create(tc.num_layers, B, S, tc.num_kv_heads, tc.head_dim,
                                quantized=quantized, device="cpu")
    # WHEN both prefill, with logits at every position
    jlogits, jcache = _exact(lambda p, c, i: je.serving_forward(p, jc, i, c), jp, jcache,
                             jnp.asarray(ids))
    tlogits, tcache = te.serving_forward(tp, tc, torch.from_numpy(ids), tcache)
    jlogits, tl_np = np.asarray(jlogits), tlogits.numpy()
    assert tl_np.shape == jlogits.shape == (B, T, jc.vocab_size)
    assert tcache.length == int(jcache.length) == T
    # THEN the logits agree within the stated RMS error; where they differ,
    # the decode starts from JAX's cache in both
    assert _rel_rms(jlogits, tl_np) <= LOGITS_RMS[mode]
    if not np.array_equal(jlogits, tl_np):
        tcache = _port_cache(jcache)
    # WHEN both decode greedy tokens from the last position
    first = jnp.argmax(jlogits[:, -1], axis=-1).astype(jnp.int32)[:, None]
    if (mode, quantized) not in _LOOPS:
        _LOOPS[mode, quantized] = je.make_decode_loop(jc, steps).lower(
            jp, jcache, first).compile(compiler_options=EXACT)
    jtok, jcache = _LOOPS[mode, quantized](jp, jcache, first)
    ttok, tcache = te.make_decode_loop(tc, steps)(tp, tcache,
                                                  torch.from_numpy(np.array(first)).long())
    # THEN the tokens are equal
    np.testing.assert_array_equal(np.asarray(jtok), ttok.numpy())
    assert tcache.length == int(jcache.length) == T + steps


def test_no_cache_forward_and_logits_positions(models, tpu_route):
    # GIVEN 2 prompts of 6 tokens, no cache
    mode, jc, jp, tc, tp = models
    ids = np.random.RandomState(5).randint(0, jc.vocab_size, (2, 6))
    # WHEN both run the forward THEN the logits agree at every position
    # within the stated RMS error (dense grouped attention in both)
    a, jcache = _exact(lambda p, i: je.serving_forward(p, jc, i), jp, jnp.asarray(ids))
    b, tcache = te.serving_forward(tp, tc, torch.from_numpy(ids))
    assert jcache is None and tcache is None and b.shape == a.shape == (2, 6, jc.vocab_size)
    assert _rel_rms(np.asarray(a), b.numpy()) <= LOGITS_RMS[mode]
    # AND "last" and per-row logits positions select the same rows
    last, _ = te.serving_forward(tp, tc, torch.from_numpy(ids), logits_positions="last")
    rows, _ = te.serving_forward(tp, tc, torch.from_numpy(ids),
                                 logits_positions=torch.tensor([2, 5]))
    assert torch.equal(last[:, 0], b[:, -1])
    assert torch.equal(rows[:, 0], torch.stack([b[0, 2], b[1, 5]]))


def test_random_serving_params_layouts(models):
    # the port's random weights have the JAX function's shapes, dtypes and
    # layouts (unpaired two-level, the lm_head in the layers' mode)
    mode, jc, jp, tc, _ = models
    tp = te.random_serving_params(tc, mode, group_size=64, seed=0, device="cpu")
    assert len(tp.layers) == len(jp.layers)
    for name in ("q_proj", "o_proj", "down_proj"):
        a, b = getattr(jp.layers[1], name), getattr(tp.layers[1], name)
        for f in ("data", "scale", "mult"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None)
            if x is not None:
                assert tuple(x.shape) == tuple(y.shape) and str(x.dtype) == str(y.dtype)[6:]
        assert (a.mode, a.group_size, a.paired) == (b.mode, b.group_size, b.paired)
    assert (tp.lm_head.mode, tp.lm_head.paired) == (jp.lm_head.mode, jp.lm_head.paired)
    assert tp.embedding.dtype == torch.bfloat16


def test_stack_serving_layers_and_convert_match_jax(models):
    # GIVEN the JAX per-layer params carried into the port
    mode, jc, jp, tc, tp = models
    flat = jax_params_to_flat(jp)
    # THEN the per-layer form round-trips byte for byte
    back = params_to_flat(tp)
    assert set(back) == set(flat)
    for key, a in flat.items():
        assert _bytes(a) == _bytes(back[key]), key
    # AND stacking gives the JAX package's stacked layers, byte for byte
    jl = js.stack_serving_layers(jp)
    tl = ts.stack_serving_layers(tp)
    jflat, tflat = jax_to_flat(jp, jl), params_to_flat(dataclasses.replace(tp, layers=()), tl)
    jflat = {k: v for k, v in jflat.items() if k.startswith("layers.")}
    tflat = {k: v for k, v in tflat.items() if k.startswith("layers.")}
    assert set(jflat) == set(tflat)
    for key, a in jflat.items():
        assert _bytes(a) == _bytes(tflat[key]) and a.shape == tflat[key].shape, key


def test_per_layer_and_stacked_paths_give_the_same_tokens(models, routes, monkeypatch):
    # GIVEN the same weights per layer and stacked
    mode, jc, jp, tc, tp = models
    monkeypatch.setattr(je, "matmul_w4a8", _jax_w4a8_tpu)
    monkeypatch.setattr(je, "matmul_w4a16", _jax_w4a16_tpu)
    stacked = ts.stack_serving_layers(tp)
    B, T, S, steps = 2, 8, 64, 4
    ids = torch.from_numpy(np.random.RandomState(6).randint(0, tc.vocab_size, (B, T)))
    out = {}
    for quantized in (True, False):
        # WHEN each path prefills and decodes greedily
        pc = tkv.KVCache.create(tc.num_layers, B, S, tc.num_kv_heads, tc.head_dim,
                                quantized=quantized, device="cpu")
        logits, pc = te.serving_forward(tp, tc, ids, pc, logits_positions="last")
        first = torch.argmax(logits[:, -1], dim=-1)[:, None]
        toks, pc = te.make_decode_loop(tc, steps)(tp, pc, first)
        sc = ts.StackedKVCache.create(tc.num_layers, B, S, tc.num_kv_heads, tc.head_dim,
                                      quantized=quantized, device="cpu")
        slogits, sc = ts.serving_forward_stacked(tp, stacked, tc, ids, sc,
                                                 logits_positions="last")
        stoks, sc = ts.make_stacked_decode_loop(tc, steps)(tp, stacked, sc, first)
        # THEN both give the same logits, tokens and cache bytes
        assert torch.equal(logits, slogits) and torch.equal(toks, stoks)
        for l in range(tc.num_layers):
            assert torch.equal(pc.layer(l).k, sc.k[l]) and torch.equal(pc.layer(l).v, sc.v[l])
        out[quantized] = toks
    # AND the stacked bf16 cache gives the JAX stacked forward's tokens (one
    # mode: the bf16 branch does not depend on it)
    if mode != "w4a8_2l":
        return
    jl = js.stack_serving_layers(jp)
    jcache = js.StackedKVCache.create(jc.num_layers, B, S, jc.num_kv_heads, jc.head_dim,
                                      quantized=False)
    jlogits, jcache = _exact(lambda p, l, c, i: js.serving_forward_stacked(
        p, l, jc, i, cache=c, logits_positions="last"), jp, jl, jcache, jnp.asarray(ids.numpy()))
    jfirst = jnp.argmax(jlogits[:, -1], axis=-1).astype(jnp.int32)[:, None]
    loop = js.make_stacked_decode_loop(jc, steps, donate=False)
    jtok, _ = loop.lower(jp, jl, jcache, jfirst).compile(compiler_options=EXACT)(
        jp, jl, jcache, jfirst)
    np.testing.assert_array_equal(np.asarray(jtok), out[False].numpy())


def _tbytes(t):
    return t.contiguous().view(-1).view(torch.uint8).numpy().tobytes()


def test_stacked_prefill_with_per_row_positions_matches_per_layer(models, routes, monkeypatch):
    # GIVEN 2 prompts of 5 tokens at per-row (2-D) positions 0-4 and 9-13,
    # the same weights per layer and stacked in both packages
    mode, jc, jp, tc, tp = models
    monkeypatch.setattr(je, "matmul_w4a8", _jax_w4a8_tpu)
    monkeypatch.setattr(je, "matmul_w4a16", _jax_w4a16_tpu)
    stacked, jl = ts.stack_serving_layers(tp), js.stack_serving_layers(jp)
    B, T, S, L = 2, 5, 32, tc.num_layers
    ids = np.random.RandomState(7).randint(0, tc.vocab_size, (B, T))
    pos = np.asarray([[0, 1, 2, 3, 4], [9, 10, 11, 12, 13]], np.int32)
    shape = (L, B, S, tc.num_kv_heads, tc.head_dim)
    for quantized in (True, False):
        fields = ("k", "v", "k_scale", "v_scale") if quantized else ("k", "v")
        # WHEN the port's two forwards prefill, each row's block written at
        # its own start, attention dense (`stacked.py:486-492` sends 2-D
        # positions to the slab flow, `engine.py:638-641` to the dense path)
        pc = tkv.KVCache.create(*shape, quantized=quantized, device="cpu")
        sc = ts.StackedKVCache.create(*shape, quantized=quantized, device="cpu")
        a, pc = te.serving_forward(tp, tc, torch.from_numpy(ids), pc,
                                   positions=torch.from_numpy(pos))
        b, sc = ts.serving_forward_stacked(tp, stacked, tc, torch.from_numpy(ids), sc,
                                           positions=torch.from_numpy(pos))
        # THEN they agree bit for bit
        assert torch.equal(a, b) and a.shape == (B, T, tc.vocab_size)
        for l in range(L):
            for f in fields:
                assert torch.equal(getattr(pc.layer(l), f), getattr(sc, f)[l])
        if mode != JAX_2D_MODE:
            continue
        # WHEN the JAX package's two forwards do the same, jitted
        jpc = jkv.KVCache.create(*shape, quantized=quantized)
        ja, jpc = _exact(lambda p, c, i, q: je.serving_forward(p, jc, i, c, positions=q),
                         jp, jpc, jnp.asarray(ids), jnp.asarray(pos))
        jsc = js.StackedKVCache.create(*shape, quantized=quantized)
        jb, jsc = _exact(lambda p, l, c, i, q: js.serving_forward_stacked(
            p, l, jc, i, cache=c, positions=q), jp, jl, jsc, jnp.asarray(ids), jnp.asarray(pos))
        # THEN the port's logits are within the mode's RMS error of both
        for j in (ja, jb):
            assert _rel_rms(np.asarray(j), a.numpy()) <= LOGITS_RMS[mode]
        # AND every cache byte equals JAX's, per layer and stacked
        for l in range(L):
            for f in fields:
                mine = _tbytes(getattr(pc.layer(l), f))
                assert mine == _bytes(getattr(jpc.layers[l], f)), (l, f)
                assert mine == _bytes(getattr(jsc, f)[l]), (l, f)
