"""The rest of the stacked configurations against the JAX package, on the
CPU: the pre-blocked W4A8 layout (``FF_2L_PREBLOCK``), the route choice of
the stacked W4A8 GEMV (``FF_2L_MANUAL``, ``FF_2L_SPLITW``), the sampled
stacked decode loop and its ``FF_FUSED_ARGMAX=0`` head, and
`unfuse_stacked_layers`.

Inputs are made by numpy from a seed and handed to both packages. The
kernels' plain versions are held against the JAX package's CPU routes bit
for bit. End to end, both packages decode from the same JAX prefill cache
(the JAX loop compiled with ``xla_allow_excess_precision=False`` on its TPU
routes, ``engine._on_tpu`` and ``stacked._serving_on_tpu`` read as true;
each kernel it reaches runs its CPU path); spies show which routes each
took.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastforward_tpu import flags as jflags
from fastforward_tpu.kernels import matmul as jm
from fastforward_tpu.kernels import packing as jpk
from fastforward_tpu.models.llama import LlamaConfig as JConfig
from fastforward_tpu.serving import engine as je
from fastforward_tpu.serving import stacked as js
from fastforward_tpu_torch import flags as tflags
from fastforward_tpu_torch.kernels import matmul as tm
from fastforward_tpu_torch.models.llama import LlamaConfig as TConfig
from fastforward_tpu_torch.serving import engine as te
from fastforward_tpu_torch.serving import stacked as ts
from fastforward_tpu_torch.serving.convert import params_from_flat, params_to_flat
from fastforward_tpu_torch.serving.sampling import SamplingParams
from tests.test_torch_serving import jax_to_flat

EXACT = {"xla_allow_excess_precision": False}
L = 3  # stacked layers


def _bytes(a):
    if isinstance(a, torch.Tensor):
        a = a.contiguous()
        return (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(a)).tobytes()


def _stacked(K, N, g, seed):
    rs = np.random.RandomState(seed)
    w = rs.randint(-128, 128, (L, K // 2, N)).astype(np.int8)
    m = rs.randint(1, 16, (L, K // g, N)).astype(np.int8)
    s = (rs.rand(L, N) * 1e-2 + 1e-4).astype(np.float32)
    return w, m, s


# --- Layout and the plain versions of the pre-blocked routes


@pytest.mark.parametrize("bn", [128, 256])
def test_preblock_stacked_bytes_equal_jax(bn):
    # GIVEN stacked packed weights (L, K//2, N) WHEN both packages pre-block
    # them THEN the (L, N//bn, K//2, bn) bytes are equal, and the port's
    # flat_layer restores each layer
    w, _, _ = _stacked(256, 512, 64, seed=bn)
    a = jm.preblock_stacked(jnp.asarray(w), bn)
    b = tm.preblock_stacked(torch.from_numpy(w), bn)
    assert tuple(b.shape) == a.shape == (L, 512 // bn, 128, bn)
    assert _bytes(a) == _bytes(b)
    for layer in range(L):
        assert torch.equal(tm.flat_layer(b, layer), torch.from_numpy(w[layer]))


def test_preblock_stacked_rejects_a_width_that_does_not_divide_n():
    with pytest.raises(ValueError, match="not divisible"):
        tm.preblock_stacked(torch.zeros((1, 8, 384), dtype=torch.int8), 256)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bn", [128, 64])
def test_preblocked_gemv_plain_version_equals_jax(out_dtype, bn):
    # GIVEN 3 layers of paired W4A8 weights, flat and pre-blocked
    M, K, N, g = 6, 512, 384, 64
    w, m, s = _stacked(K, N, g, seed=bn + 1)
    rs = np.random.RandomState(bn)
    x = rs.randn(M, K).astype(np.float32)
    qj, sj = jax.jit(jm.quantize_rowwise)(jnp.asarray(x))
    qt, st = torch.from_numpy(np.array(qj)), torch.from_numpy(np.array(sj))
    mp = jpk.pack_mult_nibbles(jnp.asarray(m))
    w4j = jm.preblock_stacked(jnp.asarray(w), bn)
    w4t = tm.preblock_stacked(torch.from_numpy(w), bn)
    mpt = torch.from_numpy(np.array(mp))
    for layer in range(L):
        # WHEN each layer's GEMV runs on the pre-blocked weights in both
        # packages, and on the flat weights in the port
        a = jm.matmul_w4a8_2l_gemv_stacked(qj, sj, w4j, mp, jnp.asarray(s), jnp.int32(layer),
                                           group_size=g, out_dtype=getattr(jnp, out_dtype))
        b = tm.matmul_w4a8_2l_gemv_stacked(qt, st, w4t, mpt, torch.from_numpy(s), layer,
                                           group_size=g, out_dtype=getattr(torch, out_dtype))
        flat = tm.matmul_w4a8_2l_gemv_stacked(qt, st, torch.from_numpy(w), mpt,
                                              torch.from_numpy(s), layer, group_size=g,
                                              out_dtype=getattr(torch, out_dtype))
        # THEN all three are bit-equal
        assert b.dtype == getattr(torch, out_dtype)
        assert _bytes(a) == _bytes(b)
        assert torch.equal(b, flat)


@pytest.mark.parametrize("bn", [128, 64])
def test_preblocked_dequant_plain_version_equals_jax(bn):
    # GIVEN 3 layers of paired W4A8 weights, flat and pre-blocked
    K, N, g = 512, 384, 64
    w, m, s = _stacked(K, N, g, seed=3 * bn)
    w4j = jm.preblock_stacked(jnp.asarray(w), bn)
    w4t = tm.preblock_stacked(torch.from_numpy(w), bn)
    for layer in range(L):
        # WHEN each layer is dequantized from the pre-blocked weights
        a = jm.dequantize_int4_paired_stacked(w4j, jnp.asarray(m), jnp.asarray(s),
                                              jnp.int32(layer), group_size=g)
        b = tm.dequantize_int4_paired_stacked(w4t, torch.from_numpy(m), torch.from_numpy(s),
                                              layer, group_size=g)
        flat = tm.dequantize_int4_paired_stacked(torch.from_numpy(w), torch.from_numpy(m),
                                                 torch.from_numpy(s), layer, group_size=g)
        # THEN the bf16 (K, N) weights equal JAX's and the flat form's
        assert b.dtype == torch.bfloat16 and tuple(b.shape) == (K, N)
        assert _bytes(a) == _bytes(b)
        assert torch.equal(b, flat)


# --- The route choice of the stacked W4A8 GEMV

ROUTES = [  # (pre-blocked, n_groups, K//2, FF_2L_MANUAL, FF_2L_SPLITW, route)
    (False, 32, 2048, 0, False, "w4a8_gemv_stacked"),
    (True, 32, 2048, 0, False, "w4a8_gemv_preblocked"),
    (False, 32, 2048, 1, False, "w4a8_gemv_stacked"),
    (True, 32, 2048, 1, False, "w4a8_gemv_preblocked"),
    (False, 32, 2048, 2, False, "w4a8_gemv_stacked"),
    (True, 32, 2048, 2, False, "w4a8_gemv_manual"),
    (False, 32, 2048, 8, False, "w4a8_gemv_stacked"),
    (True, 32, 2048, 8, False, "w4a8_gemv_manual"),
    (False, 32, 2048, 0, True, "w4a8_gemv_splitw"),
    (False, 112, 7168, 0, True, "w4a8_gemv_splitw"),
    (False, 6, 384, 0, True, "w4a8_gemv_stacked"),     # n_groups % 4 != 0
    (False, 2, 64, 0, True, "w4a8_gemv_stacked"),
    (True, 32, 2048, 0, True, "w4a8_gemv_preblocked"),  # split-W takes flat weights only
    (True, 32, 2048, 4, True, "w4a8_gemv_manual"),      # the manual stream comes first
    (False, 32, 2048, 4, True, "w4a8_gemv_splitw"),
]


@pytest.mark.parametrize("case", ROUTES)
def test_stacked_gemv_route_follows_jax_order(case):
    *args, route = case
    assert tm.stacked_gemv_route(*args) == route


FLAGS = [("two_level_preblock", "FF_2L_PREBLOCK", ["1", "0", "true"]),
         ("two_level_block_n", "FF_2L_BLOCK_N", ["128", "256"]),
         ("two_level_manual_bufs", "FF_2L_MANUAL", ["0", "2", "8"]),
         ("two_level_split_w", "FF_2L_SPLITW", ["1", "0", ""]),
         ("fused_argmax", "FF_FUSED_ARGMAX", ["1", "0", "yes"])]


@pytest.mark.parametrize("name,var,values", FLAGS, ids=[f[1] for f in FLAGS])
def test_new_flags_parse_like_jax(monkeypatch, name, var, values):
    # GIVEN the flag's variable unset or set WHEN both packages read it
    # THEN they agree
    monkeypatch.delenv(var, raising=False)
    assert getattr(tflags, name)() == getattr(jflags, name)()
    for value in values:
        monkeypatch.setenv(var, value)
        assert getattr(tflags, name)() == getattr(jflags, name)()


# --- A tiny model: fusing, greedy and sampled decoding


def _configs():
    kw = dict(vocab_size=256, hidden_size=256, intermediate_size=512, num_layers=L,
              num_heads=2, num_kv_heads=1, head_dim=128, max_seq_len=64)
    return JConfig(**kw, dtype=jnp.bfloat16), TConfig(**kw, dtype=torch.bfloat16)


@pytest.fixture(scope="module")
def tiny():
    """A narrow bf16 w4a8_2l Llama (g64, every projection N a multiple of
    128) in both packages: JAX params and unfused stacked layers, and the
    port's from the same bytes."""
    jc, tc = _configs()
    params, layers = js.random_stacked_params(jc, "w4a8_2l", group_size=64, seed=5)
    rs = np.random.RandomState(6)
    norms = {n: jnp.asarray((rs.rand(L, 256) + 0.5).astype(np.float32)).astype(jnp.bfloat16)
             for n in ("input_norm", "post_norm")}
    layers = dataclasses.replace(layers, **norms)
    tp, tl = params_from_flat(jax_to_flat(params, layers), device="cpu")
    return jc, params, layers, tc, tp, tl


@pytest.fixture(scope="module")
def preblocked(tiny):
    """Both packages' layers fused under FF_2L_PREBLOCK=1 FF_2L_BLOCK_N=128,
    and the JAX ones carried into the port."""
    jc, jp, jl, tc, tp, tl = tiny
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FF_2L_PREBLOCK", "1")
        mp.setenv("FF_2L_BLOCK_N", "128")
        jf = js.fuse_stacked_layers(jl)
        tf = ts.fuse_stacked_layers(tl)
    carried = params_from_flat(jax_to_flat(jp, jf), device="cpu")[1]
    return jf, tf, carried


def test_fuse_under_preblock_gives_jax_bytes(tiny, preblocked):
    # GIVEN both packages' fused layers under FF_2L_PREBLOCK=1
    # FF_2L_BLOCK_N=128
    jc, jp, jl, tc, tp, tl = tiny
    jf, tf, carried = preblocked
    for name in ("qkv_proj", "o_proj", "gateup_proj", "down_proj"):
        a, b, c = getattr(jf, name), getattr(tf, name), getattr(carried, name)
        # THEN every paired projection is pre-blocked (L, N//128, K//2, 128)
        # in both, with JAX's bytes, and carries through convert unchanged
        assert a.data.ndim == 4 and a.data.shape[3] == 128
        assert tuple(b.data.shape) == a.data.shape == tuple(c.data.shape)
        for f in ("data", "scale", "mult", "mult_packed"):
            assert _bytes(getattr(a, f)) == _bytes(getattr(b, f)) == _bytes(getattr(c, f)), f
    # AND the port's flat dict of the pre-blocked layers is JAX's, byte for byte
    flat = jax_to_flat(jp, jf)
    back = params_to_flat(tp, tf)
    assert set(back) == set(flat)
    for key, a in flat.items():
        assert _bytes(a) == np.ascontiguousarray(back[key]).tobytes(), key


def test_preblock_leaves_widths_that_do_not_divide(tiny, monkeypatch):
    # GIVEN a panel width that divides no projection's N (JAX: left flat)
    jc, jp, jl, tc, tp, tl = tiny
    monkeypatch.setenv("FF_2L_PREBLOCK", "1")
    monkeypatch.setenv("FF_2L_BLOCK_N", "768")
    jf, tf = js.fuse_stacked_layers(jl), ts.fuse_stacked_layers(tl)
    for name in ("qkv_proj", "o_proj", "gateup_proj", "down_proj"):
        assert getattr(jf, name).data.ndim == getattr(tf, name).data.dim() == 3


def _spy(monkeypatch, taken, module, name, key, four_d=False):
    fn = getattr(module, name)

    def call(*a, **k):
        if not four_d or a[2].ndim == 4:
            taken.add(key)
        return fn(*a, **k)
    monkeypatch.setattr(module, name, call)


def _jax_prefill(jc, jp, jl, ids, S=32):
    B = ids.shape[0]
    prefill = jax.jit(lambda p, l, c, i: js.serving_forward_stacked(
        p, l, jc, i, cache=c, logits_positions="last"))
    jcache = js.StackedKVCache.create(L, B, S, jc.num_kv_heads, jc.head_dim)
    args = (jp, jl, jcache, jnp.asarray(ids))
    jlogits, jcache = prefill.lower(*args).compile(compiler_options=EXACT)(*args)
    first = jnp.argmax(jlogits[:, -1], axis=-1).astype(jnp.int32)[:, None]
    return jcache, first


def _port_cache(jcache, T):
    return ts.StackedKVCache(*[torch.from_numpy(np.array(a)) for a in
                               (jcache.k, jcache.v, jcache.k_scale, jcache.v_scale)], length=T)


def _jax_routes(monkeypatch):
    monkeypatch.setattr(js, "_serving_on_tpu", lambda: True)
    monkeypatch.setattr(je, "_on_tpu", lambda: True)
    monkeypatch.setenv("FF_KV_STACKED", "force")


@pytest.fixture(scope="module")
def greedy(tiny, preblocked):
    """JAX's greedy tokens over its pre-blocked layers from its own prefill
    cache (B = 4, T = 8, 6 steps), with the routes both packages took."""
    jc, jp, jl, tc, tp, tl = tiny
    jf, tf, _ = preblocked
    B, T, steps = 4, 8, 6
    ids = np.random.RandomState(9).randint(0, jc.vocab_size, (B, T))
    with pytest.MonkeyPatch.context() as mp:
        jcache, first = _jax_prefill(jc, jp, jf, ids)
        taken = set()
        for key, name in (("head", "fused_norm_qkv_stacked"), ("o_gu", "fused_o_gu_stacked"),
                          ("tail", "fused_o_mlp_stacked")):
            _spy(mp, taken, jm, name, f"jax {key}")
        _spy(mp, taken, je, "matmul_w4a8_2l_gemv_stacked", "jax preblocked gemv", four_d=True)
        _jax_routes(mp)
        for var in ("FF_FUSED_QKV", "FF_FUSED_OGU", "FF_FUSED_LAYER", "FF_FUSED_ARGMAX"):
            mp.delenv(var, raising=False)
        loop = js.make_stacked_decode_loop(jc, steps, donate=False)
        largs = (jp, jf, jcache, first)
        jtok, _ = loop.lower(*largs).compile(compiler_options=EXACT)(*largs)
    return dict(ids=ids, T=T, steps=steps, jcache=jcache, first=first,
                tokens=np.asarray(jtok), taken=taken)


def test_preblocked_greedy_tokens_match_jax(tiny, preblocked, greedy, monkeypatch):
    # GIVEN the port's pre-blocked fused layers and JAX's prefill cache
    jc, jp, jl, tc, tp, tl = tiny
    jf, tf, _ = preblocked
    taken = set()
    for key, name in (("head", "fused_norm_qkv_stacked"), ("o_gu", "fused_o_gu_stacked"),
                      ("tail", "fused_o_mlp_stacked")):
        _spy(monkeypatch, taken, ts, name, f"port {key}")
    _spy(monkeypatch, taken, te, "matmul_w4a8_2l_gemv_stacked", "port preblocked gemv",
         four_d=True)
    for var in ("FF_FUSED_QKV", "FF_FUSED_OGU", "FF_FUSED_LAYER"):
        monkeypatch.setenv(var, "1")  # every fused route asked for
    # WHEN the port decodes greedily from the same cache
    ttok, tcache = ts.make_stacked_decode_loop(tc, greedy["steps"])(
        tp, tf, _port_cache(greedy["jcache"], greedy["T"]),
        torch.from_numpy(np.array(greedy["first"])).long())
    # THEN its tokens are JAX's, and both took the pre-blocked GEMV and no
    # fused route (4-D weights bypass them)
    np.testing.assert_array_equal(greedy["tokens"], ttok.numpy())
    assert tcache.length == greedy["T"] + greedy["steps"]
    assert greedy["taken"] == {"jax preblocked gemv"}
    assert taken == {"port preblocked gemv"}


def test_preblocked_prefill_takes_its_dequant_and_equals_flat(tiny, preblocked, monkeypatch):
    # GIVEN 320 prompt rows (past the GEMV's 256: the prefill dequant)
    jc, jp, jl, tc, tp, tl = tiny
    jf, tf, _ = preblocked
    flat = ts.fuse_stacked_layers(tl)
    ids = torch.from_numpy(np.random.RandomState(4).randint(0, tc.vocab_size, (2, 160)))
    seen = []
    fn = te.dequantize_int4_paired_stacked
    monkeypatch.setattr(te, "dequantize_int4_paired_stacked",
                        lambda w, *a, **k: seen.append(w.dim()) or fn(w, *a, **k))
    outs = []
    for layers in (tf, flat):
        cache = ts.StackedKVCache.create(L, 2, 192, tc.num_kv_heads, tc.head_dim, device="cpu")
        outs.append(ts.serving_forward_stacked(tp, layers, tc, ids, cache,
                                               logits_positions="last")[0])
    # THEN the pre-blocked layers dequantize 4-D weights, and the logits
    # are the flat layers' bit for bit
    assert seen == [4] * (4 * L) + [3] * (4 * L)
    assert torch.equal(outs[0], outs[1])


def test_fused_argmax_off_gives_the_same_tokens(tiny, preblocked, greedy, monkeypatch):
    # GIVEN FF_FUSED_ARGMAX=0 when the loop is made (f32 logits + argmax)
    jc, jp, jl, tc, tp, tl = tiny
    jf, tf, _ = preblocked
    heads = []
    fn = ts.matmul_w4a8_2l_gemv_argmax
    monkeypatch.setattr(ts, "matmul_w4a8_2l_gemv_argmax",
                        lambda *a, **k: heads.append(1) or fn(*a, **k))
    monkeypatch.setenv("FF_FUSED_ARGMAX", "0")
    loop = ts.make_stacked_decode_loop(tc, greedy["steps"])
    monkeypatch.delenv("FF_FUSED_ARGMAX")
    ttok, _ = loop(tp, tf, _port_cache(greedy["jcache"], greedy["T"]),
                   torch.from_numpy(np.array(greedy["first"])).long())
    # THEN no fused head ran, and the tokens are the fused head's (JAX's)
    assert heads == []
    np.testing.assert_array_equal(greedy["tokens"], ttok.numpy())


def test_sampled_loop_top_k_1_gives_greedy_tokens(tiny, preblocked, greedy):
    # GIVEN a sampled loop at temperature 0.8 and top_k 1
    jc, jp, jl, tc, tp, tl = tiny
    jf, tf, _ = preblocked
    loop = ts.make_stacked_decode_loop(tc, greedy["steps"],
                                       sampling=SamplingParams(temperature=0.8, top_k=1))
    ttok, _ = loop(tp, tf, _port_cache(greedy["jcache"], greedy["T"]),
                   torch.from_numpy(np.array(greedy["first"])).long(),
                   torch.Generator().manual_seed(0))
    # THEN it draws JAX's greedy tokens
    np.testing.assert_array_equal(greedy["tokens"], ttok.numpy())


def test_sampled_loop_draws_from_jax_top_k(tiny, preblocked, greedy, monkeypatch):
    # GIVEN a sampled loop at temperature 0.8 and top_k 8
    jc, jp, jl, tc, tp, tl = tiny
    jf, tf, _ = preblocked
    steps, k = greedy["steps"], 8
    params = SamplingParams(temperature=0.8, top_k=k)
    loop = ts.make_stacked_decode_loop(tc, steps, sampling=params)
    first = torch.from_numpy(np.array(greedy["first"])).long()
    ttok, _ = loop(tp, tf, _port_cache(greedy["jcache"], greedy["T"]), first,
                   torch.Generator().manual_seed(1))
    # WHEN JAX computes the logits of each step, fed the port's tokens
    _jax_routes(monkeypatch)
    step = jax.jit(lambda p, l, c, t: js.serving_forward_stacked(p, l, jc, t, cache=c))
    jcache, tok = greedy["jcache"], jnp.asarray(np.array(greedy["first"]))
    compiled = None
    for i in range(steps):
        args = (jp, jf, jcache, tok)
        compiled = compiled or step.lower(*args).compile(compiler_options=EXACT)
        logits, jcache = compiled(*args)
        top = np.argsort(-np.asarray(logits[:, -1]), axis=-1)[:, :k]
        # THEN each sampled token lies in JAX's top-k of those logits
        drawn = ttok[:, i].numpy()
        assert all(drawn[b] in top[b] for b in range(len(drawn))), (i, drawn, top)
        tok = jnp.asarray(drawn.astype(np.int32))[:, None]


def test_sampled_loop_needs_a_generator(tiny, preblocked, greedy):
    jc, jp, jl, tc, tp, tl = tiny
    jf, tf, _ = preblocked
    loop = ts.make_stacked_decode_loop(tc, 1, sampling=SamplingParams(temperature=0.8))
    with pytest.raises(ValueError, match="Generator"):
        loop(tp, tf, _port_cache(greedy["jcache"], greedy["T"]),
             torch.from_numpy(np.array(greedy["first"])).long(), None)


# --- unfuse_stacked_layers


def test_unfuse_bytes_equal_jax(tiny):
    # GIVEN both packages' fused flat layers
    jc, jp, jl, tc, tp, tl = tiny
    ju = js.unfuse_stacked_layers(js.fuse_stacked_layers(jl), jc)
    tu = ts.unfuse_stacked_layers(ts.fuse_stacked_layers(tl), tc)
    # WHEN unfused THEN every array of every projection is JAX's, byte for
    # byte, and equals the layers before fusing
    flat, back = jax_to_flat(jp, ju), params_to_flat(tp, tu)
    assert set(back) == set(flat)
    for key, a in flat.items():
        assert _bytes(a) == np.ascontiguousarray(back[key]).tobytes(), key
    before = params_to_flat(tp, tl)
    for key, a in before.items():
        if not key.endswith("mult_packed"):
            assert _bytes(a) == np.ascontiguousarray(back[key]).tobytes(), key


def test_jax_unfuse_cuts_the_bn_axis_of_preblocked_data(tiny, preblocked):
    # A difference inside the reference (ROADMAP.md Queue 3): JAX's
    # unfuse slices the last axis, which in the pre-blocked layout (L,
    # N//bn, K//2, bn) is bn, not N. GIVEN the pre-blocked fused layers
    jc, jp, jl, tc, tp, tl = tiny
    jf, tf, _ = preblocked
    # WHEN JAX unfuses them THEN q keeps every panel of the fused qkv and
    # k and v get no column at all: not the q/k/v projections
    ju = js.unfuse_stacked_layers(jf, jc)
    assert ju.q_proj.data.shape == jf.qkv_proj.data.shape
    assert ju.k_proj.data.shape[-1] == ju.v_proj.data.shape[-1] == 0
    assert ju.q_proj.scale.shape[-1] == jc.num_heads * jc.head_dim
    # AND the port refuses the 4-D data in place of copying it
    with pytest.raises(ValueError, match="pre-blocked"):
        ts.unfuse_stacked_layers(tf, tc)
