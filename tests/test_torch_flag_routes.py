"""The JAX package's last serving switches on the port, against the JAX
package on the CPU: ``FF_KV_STACKED``, ``FF_KV_WRITE``,
``FF_PREFILL_STACKED``, ``FF_BENCH_FLASH``, ``FF_FLASH_PREFILL`` (the KV
flow and the attention of both forwards, `serving/stacked.py`
`stacked_attention_route`, `layer_attention_route`) and ``FF_2L_PAIRED``
(the pack-time layout of two-level W4A8 weights).

Weights are made by the JAX package (a narrow Llama: hidden 256, 2 layers,
head dim 128 so that the flash routes are reached, 2 query heads per kv
head, groups of 64) and carried into the port by `serving/convert.py`, byte
for byte; the prompts come from a numpy seed. Each flag is set on both
sides. The JAX package reads its flags while it traces, so every setting
traces and compiles functions of its own (shared at module scope by the
tests that need the same setting, compiled with
``xla_allow_excess_precision=False``).

The JAX side takes its TPU routing, as the port does on every device:
``engine._on_tpu`` and ``stacked._serving_on_tpu`` read as true (as in
`tests/test_torch_serving.py`), and so does ``kernels.matmul._on_tpu``
where the two forwards import it to route attention (the slab flow, the
flash prefill); called from a kernel wrapper it keeps its answer, so every
JAX kernel reached runs its CPU path.

Held: the cache bytes after each prefill and decode step, bit-equal; the
greedy tokens, equal; the logits bit-equal on the flash routes and within
`tests/test_torch_serving.py`'s 1e-3 of the largest logit where both
sides attend densely (they are bit-equal there too on the runs made so
far).
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastforward_tpu import flags as jflags
from fastforward_tpu.kernels import matmul as jmm
from fastforward_tpu.models.llama import LlamaConfig as JConfig
from fastforward_tpu.serving import engine as je
from fastforward_tpu.serving import kv_cache as jkv
from fastforward_tpu.serving import stacked as js
from fastforward_tpu_torch import flags as tflags
from fastforward_tpu_torch.kernels import matmul as tmm
from fastforward_tpu_torch.kernels.packing import pack_int4
from fastforward_tpu_torch.models.llama import LlamaConfig as TConfig
from fastforward_tpu_torch.serving import engine as te
from fastforward_tpu_torch.serving import kv_cache as tkv
from fastforward_tpu_torch.serving import stacked as ts
from fastforward_tpu_torch.serving.convert import params_from_flat
from fastforward_tpu_torch.serving.paged import PagedKVCache
from tests.test_torch_serving import jax_to_flat
from tests.test_torch_serving_forward import jax_params_to_flat

EXACT = {"xla_allow_excess_precision": False}
_KW = dict(hidden_size=256, intermediate_size=512, num_heads=2, num_kv_heads=1, head_dim=128)
B, T, S, STEPS = 2, 8, 32, 3
DENSE_TOL = 1e-3  # tests/test_torch_serving.py: within 1e-3 of the largest logit
SWITCHES = ("FF_KV_STACKED", "FF_KV_WRITE", "FF_PREFILL_STACKED", "FF_BENCH_FLASH",
            "FF_FLASH_PREFILL", "FF_2L_PAIRED")
DEFAULTS = {"FF_KV_STACKED": "1", "FF_KV_WRITE": "kernel", "FF_PREFILL_STACKED": "1",
            "FF_BENCH_FLASH": "1", "FF_FLASH_PREFILL": "1", "FF_2L_PAIRED": "1"}
# the switches a trace of each kind reads (the decode flags do not branch a
# block's trace, the prefill flags not a token step's, in either package)
READS = {"prefill": ("FF_PREFILL_STACKED", "FF_FLASH_PREFILL", "FF_2L_PAIRED"),
         "step": ("FF_KV_STACKED", "FF_KV_WRITE", "FF_BENCH_FLASH", "FF_2L_PAIRED"),
         "loop": ("FF_KV_STACKED", "FF_KV_WRITE", "FF_BENCH_FLASH", "FF_2L_PAIRED")}
_COMPILED: dict = {}


@pytest.fixture(scope="module", autouse=True)
def tpu_routing():
    real = jmm._on_tpu
    routers = ("fastforward_tpu.serving.stacked", "fastforward_tpu.serving.engine")

    def routing_on_tpu():
        return sys._getframe(1).f_globals.get("__name__") in routers or real()

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmm, "_on_tpu", routing_on_tpu)
        mp.setattr(je, "_on_tpu", lambda: True)
        mp.setattr(js, "_serving_on_tpu", lambda: True)
        yield


def _set(monkeypatch, env):
    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)


def _jax(kind, tag, env, fn, *args):
    """``fn`` jitted, traced and compiled under ``env`` once a module for
    the switches a ``kind`` trace reads; the call's result."""
    key = (kind, tag, tuple(sorted((k, v) for k, v in env.items()
                                   if k in READS[kind] and v != DEFAULTS[k])))
    if key not in _COMPILED:
        _COMPILED[key] = jax.jit(fn).lower(*args).compile(compiler_options=EXACT)
    return _COMPILED[key](*args)


def _np(a):
    """numpy of a JAX array or a torch tensor; bf16 as its int16 bits."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else a


def _cache_arrays(c):
    if hasattr(c, "layers"):
        return [_np(getattr(lc, f)) for lc in c.layers for f in ("k", "v", "k_scale", "v_scale")]
    return [_np(a) for a in (c.k, c.v, c.k_scale, c.v_scale) if a is not None]


def _same_cache(jc, tc):
    a, b = _cache_arrays(jc), _cache_arrays(tc)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x.view(np.uint8), y.view(np.uint8))


def _same_logits(jl, tl, dense):
    jl, tl = _np(jl), _np(tl)
    assert jl.shape == tl.shape
    if dense:
        assert np.abs(jl - tl).max() <= DENSE_TOL * np.abs(jl).max()
    else:
        np.testing.assert_array_equal(jl, tl)


def _stacked_to_port(c):
    return ts.StackedKVCache(*(None if a is None else torch.from_numpy(np.array(a))
                               for a in (c.k, c.v, c.k_scale, c.v_scale)), length=int(c.length))


def _layers_to_port(c):
    return tkv.KVCache(layers=tuple(tkv.LayerKVCache(*(torch.from_numpy(np.array(a)) for a in (
        lc.k, lc.v, lc.k_scale, lc.v_scale))) for lc in c.layers), length=int(c.length))


def _build(heads, kv_heads, paired="1"):
    kw = dict(_KW, num_heads=heads, num_kv_heads=kv_heads)
    jc, tc = dataclasses.replace(JConfig.tiny(), **kw), dataclasses.replace(TConfig.tiny(), **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FF_2L_PAIRED", paired)
        jp, jl = js.random_stacked_params(jc, "w4a8_2l", group_size=64, seed=1)
        jl = js.fuse_stacked_layers(jl)
    tp, tl = params_from_flat(jax_to_flat(jp, jl), device="cpu")
    return jc, jp, jl, tc, tp, tl


@pytest.fixture(scope="module")
def model():
    return _build(2, 1)


def _ids():
    return np.random.RandomState(5).randint(0, JConfig.tiny().vocab_size, (B, T))


def _prefill(m, env, monkeypatch, quantized=True, tag="gqa"):
    """Both packages' prefill of the seeded prompts under ``env``:
    (JAX logits, JAX cache, port logits, port cache)."""
    jc, jp, jl, tc, tp, tl = m
    _set(monkeypatch, env)
    ids = _ids()
    jcache = js.StackedKVCache.create(jc.num_layers, B, S, jc.num_kv_heads, jc.head_dim,
                                      quantized=quantized)
    jlog, jcache = _jax("prefill", (tag, quantized), env, lambda p, l, c, i: (
        js.serving_forward_stacked(p, l, jc, i, cache=c, logits_positions="last")),
        jp, jl, jcache, jnp.asarray(ids))
    tcache = ts.StackedKVCache.create(tc.num_layers, B, S, tc.num_kv_heads, tc.head_dim,
                                      quantized=quantized, device="cpu")
    tlog, tcache = ts.serving_forward_stacked(tp, tl, tc, torch.from_numpy(ids), cache=tcache,
                                              logits_positions="last")
    return jlog, jcache, tlog, tcache


def _step_fn(jc):
    return lambda p, l, c, tok, pos: js.serving_forward_stacked(p, l, jc, tok, cache=c,
                                                                positions=pos)


@pytest.fixture(scope="module")
def prefilled(model):
    """JAX's int8 prefill cache under the defaults and its first tokens."""
    with pytest.MonkeyPatch.context() as mp:
        jlog, jcache, _, _ = _prefill(model, {}, mp)
    return jcache, np.array(jnp.argmax(jlog[:, -1], axis=-1), np.int32)[:, None]


# --- the readers --------------------------------------------------------------


@pytest.mark.parametrize("raw", [None, "1", "0", "force", "kernel", "mask", "scatter", "true",
                                 ""])
def test_readers_parse_as_the_jax_package(raw, monkeypatch):
    pairs = [(tflags.kv_stacked_mode, jflags.kv_stacked_mode, "FF_KV_STACKED"),
             (tflags.kv_write_mode, jflags.kv_write_mode, "FF_KV_WRITE"),
             (tflags.prefill_stacked, jflags.prefill_stacked, "FF_PREFILL_STACKED"),
             (tflags.use_flash_attention, jflags.use_flash_attention, "FF_BENCH_FLASH"),
             (tflags.use_flash_prefill, jflags.use_flash_prefill, "FF_FLASH_PREFILL"),
             (tflags.default_paired_layout, jflags.default_paired_layout, "FF_2L_PAIRED")]
    for port, ref, name in pairs:
        _set(monkeypatch, {} if raw is None else {name: raw})
        assert port() == ref(), name


# --- the routes ---------------------------------------------------------------

# (env, the stacked forward's route of an int8 token step, of an int8 block)
STACKED_ROUTES = [
    ({}, ("stacked", "select"), ("cache", "prefill")),
    ({"FF_KV_STACKED": "1"}, ("stacked", "select"), ("cache", "prefill")),
    ({"FF_KV_STACKED": "force"}, ("stacked", "select"), ("cache", "prefill")),
    ({"FF_KV_STACKED": "0"}, ("cache", "layer"), ("cache", "prefill")),
    ({"FF_KV_STACKED": "2"}, ("cache", "layer"), ("cache", "prefill")),
    ({"FF_KV_WRITE": "kernel"}, ("stacked", "select"), ("cache", "prefill")),
    ({"FF_KV_WRITE": "mask"}, ("mask", "layer"), ("cache", "prefill")),
    ({"FF_KV_WRITE": "scatter"}, ("scatter", "layer"), ("cache", "prefill")),
    ({"FF_KV_WRITE": "rows"}, ("scatter", "layer"), ("cache", "prefill")),
    ({"FF_KV_STACKED": "0", "FF_KV_WRITE": "mask"}, ("mask", "layer"), ("cache", "prefill")),
    ({"FF_PREFILL_STACKED": "0"}, ("stacked", "select"), ("rows", "prefill")),
    ({"FF_BENCH_FLASH": "0"}, ("cache", "dense"), ("cache", "prefill")),
    ({"FF_BENCH_FLASH": "0", "FF_KV_WRITE": "mask"}, ("mask", "dense"), ("cache", "prefill")),
    ({"FF_FLASH_PREFILL": "0"}, ("stacked", "select"), ("cache", "dense")),
]


@pytest.mark.parametrize("env,step,block", STACKED_ROUTES,
                         ids=[",".join(f"{k}={v}" for k, v in e.items()) or "defaults"
                              for e, _, _ in STACKED_ROUTES])
def test_stacked_routes(env, step, block, monkeypatch):
    _set(monkeypatch, env)
    cache = ts.StackedKVCache.create(2, B, S, 1, 128, device="cpu")
    bf16 = ts.StackedKVCache.create(2, B, S, 1, 128, quantized=False, device="cpu")
    flat, rows = torch.arange(T), torch.arange(T).expand(B, T)
    route = ts.stacked_attention_route

    def r(*a):
        return tuple(dataclasses.astuple(route(*a)))

    assert r(cache, 1, flat[:1], 2, 128) == step
    assert r(cache, T, flat, 2, 128) == block
    # below 2 query heads per kv head the slab flow attends densely
    assert r(cache, 1, flat[:1], 1, 128)[1] == ("dense" if step[1] == "layer" else step[1])
    # per-row positions: a block a sequence at a time, dense attention
    assert r(cache, T, rows, 2, 128) == ("rows", "dense")
    # a head dim that is no multiple of 128: no flash prefill
    assert r(cache, T, flat, 2, 64)[1] == "dense"
    # the bf16 cache: flash prefill under FF_FLASH_PREFILL, a dense token step
    assert r(bf16, T, flat, 2, 128) == ("cache", block[1])
    assert r(bf16, 1, flat[:1], 2, 128) == ("cache", "dense")
    # paged and no cache: no switch moves them
    pool = PagedKVCache.create(2, 4, B, 2, 1, 128, page_size=16, device="cpu")
    assert r(pool, 1, flat[:1], 2, 128) == ("paged", "paged")
    assert r(None, T, flat, 2, 128) == ("none", "dense")


@pytest.mark.parametrize("env,prefill,step", [
    ({}, "prefill", "select"),
    ({"FF_FLASH_PREFILL": "0"}, "dense", "select"),
    ({"FF_BENCH_FLASH": "0"}, "prefill", "dense"),
    ({"FF_KV_STACKED": "0", "FF_KV_WRITE": "mask", "FF_PREFILL_STACKED": "0"}, "prefill",
     "select"),
])
def test_layer_routes(env, prefill, step, monkeypatch):
    # the per-layer forward reads FF_FLASH_PREFILL and FF_BENCH_FLASH only
    _set(monkeypatch, env)
    cache = tkv.KVCache.create(2, B, S, 1, 64, quantized=True, device="cpu")
    flat = torch.arange(T)
    route = ts.layer_attention_route
    assert dataclasses.astuple(route(cache, T, flat, 2)) == ("cache", prefill)
    assert dataclasses.astuple(route(cache, 1, flat[:1], 2)) == ("cache", step)
    assert route(cache, 1, flat[:1], 1).attend == "dense"
    assert route(cache, T, flat.expand(B, T), 2).attend == "dense"
    bf16 = tkv.KVCache.create(2, B, S, 1, 64, device="cpu")
    assert route(bf16, 1, flat[:1], 2).attend == "dense"


# --- the stacked forward against JAX ---------------------------------------------

PREFILLS = [({}, True), ({"FF_PREFILL_STACKED": "1"}, True), ({"FF_PREFILL_STACKED": "0"}, True),
            ({"FF_FLASH_PREFILL": "1"}, True), ({"FF_FLASH_PREFILL": "0"}, True),
            ({}, False), ({"FF_FLASH_PREFILL": "0"}, False)]


@pytest.mark.parametrize("env,quantized", PREFILLS, ids=[
    ",".join([f"{k}={v}" for k, v in e.items()] + [["bf16", "int8"][q]]) for e, q in PREFILLS])
def test_prefill_matches_jax(model, env, quantized, monkeypatch):
    jlog, jcache, tlog, tcache = _prefill(model, env, monkeypatch, quantized)
    # THEN the cache bytes are JAX's and the logits too (dense attention
    # within the stated tolerance)
    _same_cache(jcache, tcache)
    _same_logits(jlog, tlog, dense=env.get("FF_FLASH_PREFILL") == "0")
    assert tcache.length == int(jcache.length) == T
    if quantized and env.get("FF_PREFILL_STACKED") == "0":
        # the slab flow's per-row write: the bytes of the carry's block write
        _, _, tlog1, tcache1 = _prefill(model, {}, monkeypatch, quantized)
        _same_cache(tcache1, tcache)
        torch.testing.assert_close(tlog1, tlog, rtol=0, atol=0)


DECODES = [{}, {"FF_KV_STACKED": "1"}, {"FF_KV_STACKED": "0"}, {"FF_KV_STACKED": "force"},
           {"FF_KV_WRITE": "kernel"}, {"FF_KV_WRITE": "mask"}, {"FF_KV_WRITE": "scatter"},
           {"FF_BENCH_FLASH": "1"}, {"FF_BENCH_FLASH": "0"}]


def _decode(m, jcache, first, env, monkeypatch, steps=STEPS, tag="gqa"):
    """``steps`` greedy steps in both packages from JAX's ``jcache`` under
    ``env``, the cache bytes and logits held at each step; the tokens."""
    jc, jp, jl, tc, tp, tl = m
    _set(monkeypatch, env)
    route = ts.stacked_attention_route(_stacked_to_port(jcache), 1, torch.arange(1),
                                       tc.num_heads // tc.num_kv_heads, tc.head_dim)
    tcache = _stacked_to_port(jcache)
    jtok, ttok = first, torch.from_numpy(first).long()
    jtoks, ttoks = [], []
    for i in range(steps):
        pos = np.asarray([T + i], np.int32)
        jlog, jcache = _jax("step", tag, env, _step_fn(jc), jp, jl, jcache, jnp.asarray(jtok),
                            jnp.asarray(pos))
        tlog, tcache = ts.serving_forward_stacked(tp, tl, tc, ttok, cache=tcache,
                                                  positions=torch.from_numpy(pos).long())
        _same_cache(jcache, tcache)
        _same_logits(jlog, tlog, dense=route.attend == "dense")
        jtok = np.array(jnp.argmax(jlog[:, -1], axis=-1), np.int32)[:, None]
        ttok = torch.argmax(tlog[:, -1], dim=-1)[:, None]
        jtoks.append(jtok[:, 0])
        ttoks.append(ttok[:, 0].numpy())
    np.testing.assert_array_equal(np.stack(jtoks, 1), np.stack(ttoks, 1))
    return route, np.stack(ttoks, 1)


@pytest.mark.parametrize("env", DECODES, ids=[",".join(f"{k}={v}" for k, v in e.items())
                                              or "defaults" for e in DECODES])
def test_decode_steps_match_jax(model, prefilled, env, monkeypatch):
    route, _ = _decode(model, *prefilled, env, monkeypatch)
    # the route the switches name, and the same tokens as the default route
    expect = {"0": ("cache", "layer"), "mask": ("mask", "layer"),
              "scatter": ("scatter", "layer")}
    value = env.get("FF_KV_STACKED", env.get("FF_KV_WRITE", env.get("FF_BENCH_FLASH")))
    if env.get("FF_BENCH_FLASH") == "0":
        assert dataclasses.astuple(route) == ("cache", "dense")
    else:
        assert dataclasses.astuple(route) == expect.get(value, ("stacked", "select"))


def test_force_is_one(model, prefilled, monkeypatch):
    # FF_KV_STACKED=force and =1 serve the same tokens through the same route
    # as the slab flow (=0) does
    out = {v: _decode(model, *prefilled, {"FF_KV_STACKED": v}, monkeypatch) for v in
           ("1", "force", "0")}
    assert out["1"][0] == out["force"][0] != out["0"][0]
    np.testing.assert_array_equal(out["1"][1], out["force"][1])
    np.testing.assert_array_equal(out["1"][1], out["0"][1])


@pytest.mark.parametrize("write", ["mask", "scatter"])
def test_out_of_range_token_write(model, prefilled, write, monkeypatch):
    # GIVEN a token step at position S (one past the slab) in both packages
    jc, jp, jl, tc, tp, tl = model
    jcache, first = prefilled
    env = {"FF_KV_WRITE": write}
    _set(monkeypatch, env)
    pos = np.asarray([S], np.int32)
    jout = _jax("step", "gqa", env, _step_fn(jc), jp, jl, jcache, jnp.asarray(first),
                jnp.asarray(pos))[1]
    tout = ts.serving_forward_stacked(tp, tl, tc, torch.from_numpy(first).long(),
                                      cache=_stacked_to_port(jcache),
                                      positions=torch.from_numpy(pos).long())[1]
    before = _cache_arrays(jcache)
    # THEN the port writes nothing; so does JAX's mask, while JAX's scatter
    # (dynamic_update_slice) clamps the write to row S - 1 of every layer
    # (ROADMAP.md Queue 3, "Differences inside the reference")
    for a, t in zip(before, _cache_arrays(tout)):
        np.testing.assert_array_equal(a, t)
    for a, j in zip(before, _cache_arrays(jout)):
        changed = np.nonzero((a != np.asarray(j)).reshape(*a.shape[:4], -1).any(-1))[3]
        assert set(changed.tolist()) == (set() if write == "mask" else {S - 1})


def test_slab_flow_attends_densely_below_two_query_heads(monkeypatch):
    # GIVEN as many query heads as kv heads, FF_KV_STACKED=0
    m = _build(2, 2)
    with pytest.MonkeyPatch.context() as mp:
        jlog, jcache, tlog, tcache = _prefill(m, {}, mp, tag="mha")
    _same_cache(jcache, tcache)
    first = np.array(jnp.argmax(jlog[:, -1], axis=-1), np.int32)[:, None]
    # THEN the slab flow's per-layer append, then dense attention, as JAX's
    route, _ = _decode(m, jcache, first, {"FF_KV_STACKED": "0"}, monkeypatch, steps=2, tag="mha")
    assert dataclasses.astuple(route) == ("cache", "dense")


# --- the per-layer forward against JAX -------------------------------------------

LAYER_ENVS = [{}, {"FF_FLASH_PREFILL": "0"}, {"FF_BENCH_FLASH": "0"}]


@pytest.fixture(scope="module")
def layer_model():
    kw = dict(_KW)
    jc, tc = dataclasses.replace(JConfig.tiny(), **kw), dataclasses.replace(TConfig.tiny(), **kw)
    jp = je.random_serving_params(jc, "w4a8_2l", group_size=64, seed=3)
    tp, _ = params_from_flat(jax_params_to_flat(jp), device="cpu")
    return jc, jp, tc, tp


@pytest.mark.parametrize("env", LAYER_ENVS, ids=["defaults", "FF_FLASH_PREFILL=0",
                                                 "FF_BENCH_FLASH=0"])
def test_layer_forward_matches_jax(layer_model, env, monkeypatch):
    jc, jp, tc, tp = layer_model
    _set(monkeypatch, env)
    ids = _ids()
    jcache = jkv.KVCache.create(jc.num_layers, B, S, jc.num_kv_heads, jc.head_dim, quantized=True)

    def fwd(p, c, i, pos):
        return je.serving_forward(p, jc, i, c, positions=pos)

    jlog, jcache = _jax("prefill", "layer", env, fwd, jp, jcache, jnp.asarray(ids),
                        jnp.arange(T, dtype=jnp.int32))
    tcache = tkv.KVCache.create(tc.num_layers, B, S, tc.num_kv_heads, tc.head_dim,
                                quantized=True, device="cpu")
    tlog, tcache = te.serving_forward(tp, tc, torch.from_numpy(ids), tcache)
    _same_cache(jcache, tcache)
    _same_logits(jlog, tlog, dense=env.get("FF_FLASH_PREFILL") == "0")
    tcache = _layers_to_port(jcache)
    jtok = np.array(jnp.argmax(jlog[:, -1], axis=-1), np.int32)[:, None]
    ttok = torch.from_numpy(jtok).long()
    for i in range(2):
        pos = np.asarray([T + i], np.int32)
        jlog, jcache = _jax("step", "layer", env, fwd, jp, jcache, jnp.asarray(jtok),
                            jnp.asarray(pos))
        tlog, tcache = te.serving_forward(tp, tc, ttok, tcache, positions=torch.from_numpy(pos))
        _same_cache(jcache, tcache)
        _same_logits(jlog, tlog, dense=env.get("FF_BENCH_FLASH") == "0")
        jtok = np.array(jnp.argmax(jlog[:, -1], axis=-1), np.int32)[:, None]
        ttok = torch.argmax(tlog[:, -1], dim=-1)[:, None]
        np.testing.assert_array_equal(jtok, ttok.numpy())


# --- FF_2L_PAIRED -----------------------------------------------------------------


@pytest.mark.parametrize("paired", ["1", "0"])
def test_pack_time_layout(paired, monkeypatch):
    # GIVEN a dense (256, 96) weight (4 groups of 64) and int8 activations
    _set(monkeypatch, {"FF_2L_PAIRED": paired})
    rs = np.random.RandomState(7)
    w = rs.randn(256, 96).astype(np.float32)
    x_q = rs.randint(-128, 128, (3, 256)).astype(np.int8)
    x_s = rs.rand(3).astype(np.float32) * 0.01 + 1e-3
    # WHEN both packages quantize it into two-level W4A8 storage
    jq = je.quantize_linear(jnp.asarray(w), "w4a8_2l", 64)
    tq = te.quantize_linear(torch.from_numpy(w), "w4a8_2l", 64)
    # THEN the layout follows the switch, and the bytes are JAX's
    assert jq.paired == tq.paired == (paired == "1")
    for f in ("data", "scale", "mult"):
        np.testing.assert_array_equal(np.asarray(getattr(jq, f)), getattr(tq, f).numpy())
    # the converter and the GEMV wrappers' paired=None defaults read it too
    packed, scale = pack_int4(torch.from_numpy(rs.randint(-8, 8, (256, 96)).astype(np.int8)),
                                  group_size=64), torch.from_numpy(rs.rand(4, 96).astype(np.float32))
    jconv = jmm.convert_two_level(jnp.asarray(packed.numpy()), jnp.asarray(scale.numpy()), 64)
    tconv = tmm.convert_two_level(packed, scale, 64)
    for a, b in zip(jconv, tconv):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    args = (x_q, x_s, np.array(jq.data), np.array(jq.mult), np.array(jq.scale))
    jy = jax.jit(lambda *a: jmm.matmul_w4a8_2l_gemv(*a, group_size=64, out_dtype=jnp.float32))(
        *args)
    ty = tmm.matmul_w4a8_2l_gemv(*(torch.from_numpy(a) for a in args), group_size=64,
                                 out_dtype=torch.float32)
    np.testing.assert_array_equal(np.asarray(jy), ty.numpy())
    jarg = jax.jit(lambda *a: jmm.matmul_w4a8_2l_gemv_argmax(*a, group_size=64))(*args)
    targ = tmm.matmul_w4a8_2l_gemv_argmax(*(torch.from_numpy(a) for a in args), group_size=64)
    np.testing.assert_array_equal(np.asarray(jarg), targ.numpy())


def test_random_stacked_params_layout(monkeypatch):
    # the port's generator under FF_2L_PAIRED=0: the same nibble values in
    # group halves, every two-level W4A8 projection and the lm_head unpaired
    tc = dataclasses.replace(TConfig.tiny(), **_KW)
    _set(monkeypatch, {})
    p1, l1 = ts.random_stacked_params(tc, "w4a8_2l", group_size=64, seed=2, device="cpu")
    _set(monkeypatch, {"FF_2L_PAIRED": "0"})
    p0, l0 = ts.random_stacked_params(tc, "w4a8_2l", group_size=64, seed=2, device="cpu")
    pairs = [(p1.lm_head, p0.lm_head)] + [(getattr(l1, f.name), getattr(l0, f.name))
                                          for f in dataclasses.fields(l1)
                                          if isinstance(getattr(l1, f.name), te.QuantLinear)]
    for a, b in pairs:
        assert a.paired and not b.paired
        assert torch.equal(te.repack_unpaired(a).data, b.data)
        assert torch.equal(a.mult, b.mult) and torch.equal(a.scale, b.scale)
    assert torch.equal(p1.embedding, p0.embedding)


def test_unpaired_model_serves_as_jax(monkeypatch):
    # GIVEN JAX's generator under FF_2L_PAIRED=0 (the same bytes, labelled
    # unpaired), fused, carried into the port
    m = _build(2, 1, paired="0")
    jc, jp, jl, tc, tp, tl = m
    assert not jl.qkv_proj.paired and not jp.lm_head.paired
    assert not tl.qkv_proj.paired and not tp.lm_head.paired
    # WHEN both prefill and decode greedily (fused argmax head: the unpaired
    # GEMV's logits and their argmax; each projection per layer through the
    # unpaired GEMV)
    jlog, jcache, tlog, tcache = _prefill(m, {"FF_2L_PAIRED": "0"}, monkeypatch, tag="unpaired")
    _same_cache(jcache, tcache)
    _same_logits(jlog, tlog, dense=False)
    first = np.array(jnp.argmax(jlog[:, -1], axis=-1), np.int32)[:, None]
    jtok, _ = _jax("loop", "unpaired", {"FF_2L_PAIRED": "0"},
                   lambda p, l, c, t: js.make_stacked_decode_loop(jc, STEPS, donate=False)(
                       p, l, c, t), jp, jl, jcache, jnp.asarray(first))
    ttok, tcache = ts.make_stacked_decode_loop(tc, STEPS)(tp, tl, _stacked_to_port(jcache),
                                                         torch.from_numpy(first).long())
    # THEN the bytes, logits and tokens are JAX's
    np.testing.assert_array_equal(np.asarray(jtok), ttok.numpy())
