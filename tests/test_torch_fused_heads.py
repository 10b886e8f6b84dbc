"""The flag-gated fused decode routes of the stacked forward against the JAX
package, on the CPU: the fused layer head (``FF_FUSED_QKV``, W4A8 and A4)
and the fused o + gate/up head of the tail (``FF_FUSED_OGU``), with the
port's copies of the three serving flags.

The kernels' plain versions are held against the jitted JAX stacked
entries, which off the TPU run their oracles (`matmul.py:2145-2152`,
`:2559-2565`, `:2642-2648`), compiled with
``xla_allow_excess_precision=False``. XLA's CPU rsqrt is the CPU's
estimate instruction refined by two Newton steps, one ulp off the
correctly rounded value in about an eighth of its inputs; the port rounds
rsqrt correctly, as the card's ``__frsqrt_rn`` does. So the bit-for-bit
comparison traces the JAX oracles with a correctly rounded rsqrt, and a
second test shows that with XLA's own rsqrt only the rows whose inverse
norm it rounds otherwise differ.

End to end, both packages decode greedily from the same JAX prefill cache
with the flags set, the JAX loop compiled once per flag setting (a traced
function keeps the flags it read), its TPU routes taken
(``stacked._serving_on_tpu`` read as true); spies show that both took the
fused routes.
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
from fastforward_tpu.serving import stacked as js
from fastforward_tpu_torch import flags as tflags
from fastforward_tpu_torch.kernels import matmul as tm
from fastforward_tpu_torch.models.llama import LlamaConfig as TConfig
from fastforward_tpu_torch.serving import stacked as ts
from fastforward_tpu_torch.serving.convert import params_from_flat
from tests.test_torch_serving import jax_to_flat

EXACT = {"xla_allow_excess_precision": False}
L = 3  # stacked layers; the tests run layers 1 and 2


def _rounded_rsqrt(v):
    """rsqrt correctly rounded to float32, inside a jitted JAX function."""
    return jax.pure_callback(
        lambda a: (1.0 / np.sqrt(np.asarray(a, np.float64))).astype(np.float32),
        jax.ShapeDtypeStruct(v.shape, v.dtype), v, vmap_method="sequential")


@pytest.fixture
def rounded_rsqrt(monkeypatch):
    monkeypatch.setattr(jax.lax, "rsqrt", _rounded_rsqrt)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)


def _bf16(x):
    return jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


def _stacked(rs, K, N, g):
    """Stacked two-level weights (L, K//2, N), nibble-packed multipliers,
    column scales: (numpy arrays) as both packages take them."""
    w = rs.randint(-128, 128, (L, K // 2, N)).astype(np.int8)
    m = rs.randint(1, 16, (L, K // g, N)).astype(np.int8)
    s = (rs.rand(L, N) * 1e-2 + 1e-4).astype(np.float32)
    return [w, np.array(jpk.pack_mult_nibbles(jnp.asarray(m))), s]


# (name, JAX entry, port entry, K, N, group): the W4A8 head with 8 groups
# (the paired layout), the A4 head with 4
HEADS = [("w4a8", jm.fused_norm_qkv_stacked, tm.fused_norm_qkv_stacked, 256, 160, 32),
         ("a4", jm.fused_norm_qkv_stacked_a4, tm.fused_norm_qkv_stacked_a4, 256, 160, 64)]


def _head_case(M, K, N, g, seed):
    rs = np.random.RandomState(seed)
    ops = _stacked(rs, K, N, g)
    x = (rs.randn(M, K) * 3).astype(np.float32)
    norm = (rs.rand(L, K) + 0.5).astype(np.float32)
    return _bf16(x), _bf16(norm), ops


def _run_head(jfn, tfn, M, K, N, g, seed):
    """([(JAX out, port out)] on layers 1 and 2, x as f32)."""
    (xj, xt), (nj, nt), ops = _head_case(M, K, N, g, seed)
    f = jax.jit(lambda x, n, w, m, s, layer: jfn(x, n, w, m, s, layer, group_size=g))
    outs = []
    for layer in (1, 2):
        args = (xj, nj, *[jnp.asarray(a) for a in ops], jnp.int32(layer))
        a = f.lower(*args).compile(compiler_options=EXACT)(*args)
        b = tfn(xt, nt, *[torch.from_numpy(a) for a in ops], layer, group_size=g)
        assert b.dtype == torch.bfloat16 and tuple(b.shape) == (M, N)
        outs.append((_np(a), _np(b)))
    return outs, xt.float()


# (K1, H, inter, group): attention width equal to H, and twice H (each
# product's multipliers unpacked to its own group count)
OGU = [(256, 256, 384, 64), (512, 256, 256, 128)]


def _run_ogu(M, K1, H, inter, g, seed):
    """[((JAX x1, gu), (port x1, gu))] on layers 1 and 2."""
    rs = np.random.RandomState(seed)
    ops = _stacked(rs, K1, H, g) + _stacked(rs, H, 2 * inter, g)
    (aj, at), (rj, rt) = _bf16((rs.randn(M, K1) * 3).astype(np.float32)), \
        _bf16((rs.randn(M, H) * 3).astype(np.float32))
    nj, nt = _bf16((rs.rand(L, H) + 0.5).astype(np.float32))
    f = jax.jit(lambda a, r, n, *w: jm.fused_o_gu_stacked(a, r, n, *w[:6], w[6], group_size=g))
    outs = []
    for layer in (1, 2):
        args = (aj, rj, nj, *[jnp.asarray(a) for a in ops], jnp.int32(layer))
        x1, gu = f.lower(*args).compile(compiler_options=EXACT)(*args)
        tx1, tgu = tm.fused_o_gu_stacked(at, rt, nt, *[torch.from_numpy(a) for a in ops], layer,
                                         group_size=g)
        assert tx1.dtype == torch.float32 and tgu.dtype == torch.bfloat16
        assert tuple(tx1.shape) == (M, H) and tuple(tgu.shape) == (M, 2 * inter)
        outs.append(((_np(x1), _np(gu)), (tx1.numpy(), _np(tgu))))
    return outs


@pytest.mark.parametrize("M", [3, 8, 72])
@pytest.mark.parametrize("head", HEADS, ids=[h[0] for h in HEADS])
def test_fused_heads_bit_equal_to_jax(rounded_rsqrt, head, M):
    # GIVEN bf16 residual rows, stacked norm weights and qkv weights WHEN
    # both packages run the fused head on layers 1 and 2 THEN the bf16 qkv
    # outputs are bit-equal
    _, jfn, tfn, K, N, g = head
    outs, _ = _run_head(jfn, tfn, M, K, N, g, seed=M + K)
    for a, b in outs:
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("M", [3, 8, 72])
@pytest.mark.parametrize("shape", OGU, ids=["K1=H", "K1=2H"])
def test_fused_o_gu_bit_equal_to_jax(rounded_rsqrt, shape, M):
    # GIVEN attention output, residual and stacked o and gate/up weights
    # WHEN both packages run the o + gate/up head THEN x1 (f32) and gu
    # (bf16) are bit-equal
    for (jx1, jgu), (tx1, tgu) in _run_ogu(M, *shape, seed=M + shape[0]):
        np.testing.assert_array_equal(jx1, tx1)
        np.testing.assert_array_equal(jgu, tgu)


def _xla_rsqrt_off_rows(x, eps=1e-5):
    """Rows of f32 ``x`` whose inverse norm XLA's CPU rsqrt rounds unlike
    the port's (`matmul._rms_inverse`)."""
    f = jax.jit(lambda v: jax.lax.rsqrt(jnp.mean(v * v, axis=1) + eps))
    xla = np.asarray(f.lower(x.numpy()).compile(compiler_options=EXACT)(x.numpy()))
    return set(np.nonzero(xla != tm._rms_inverse(x, eps).numpy())[0].tolist())


@pytest.mark.parametrize("route", ["w4a8", "a4", "o_gu"])
def test_xla_rsqrt_moves_only_its_rows(route):
    # GIVEN 72 rows through the JAX oracles with XLA's own CPU rsqrt WHEN
    # compared with the port THEN every row that differs is one whose
    # inverse norm XLA rounds otherwise, and the outputs agree within rtol
    # 8e-3 of their largest value
    M = 72
    off, pairs = set(), []
    if route == "o_gu":
        for (jx1, jgu), (tx1, tgu) in _run_ogu(M, *OGU[0], seed=M + OGU[0][0]):
            np.testing.assert_array_equal(jx1, tx1)  # x1 precedes the norm
            off |= _xla_rsqrt_off_rows(torch.from_numpy(tx1))
            pairs.append((jgu, tgu))
    else:
        _, jfn, tfn, K, N, g = next(h for h in HEADS if h[0] == route)
        pairs, x = _run_head(jfn, tfn, M, K, N, g, seed=M + K)
        off = _xla_rsqrt_off_rows(x)
    assert off  # the CPU estimate is one ulp off in some of 72 rows
    for a, b in pairs:
        differ = set(np.nonzero((a != b).any(axis=1))[0].tolist())
        assert differ <= off
        assert np.abs(a - b).max() <= 8e-3 * np.abs(a).max()


@pytest.mark.parametrize("name", ["fused_qkv", "fused_ogu", "fused_layer"])
@pytest.mark.parametrize("value", [None, "1", "0", "true", ""])
def test_flags_parse_like_jax(monkeypatch, name, value):
    # GIVEN the flag's variable unset or set WHEN both packages read it
    # THEN they agree (unset: the default; only "1" turns a flag on)
    var = {"fused_qkv": "FF_FUSED_QKV", "fused_ogu": "FF_FUSED_OGU",
           "fused_layer": "FF_FUSED_LAYER"}[name]
    if value is None:
        monkeypatch.delenv(var, raising=False)
    else:
        monkeypatch.setenv(var, value)
    assert getattr(tflags, name)() == getattr(jflags, name)()
    assert getattr(tflags, name)() == (value == "1" if value is not None else name == "fused_layer")


# --- End to end: greedy decode through the fused routes


def _configs():
    kw = dict(vocab_size=256, hidden_size=256, intermediate_size=512, num_layers=L,
              num_heads=2, num_kv_heads=1, head_dim=128, max_seq_len=64)
    return JConfig(**kw, dtype=jnp.bfloat16), TConfig(**kw, dtype=torch.bfloat16)


@pytest.fixture(scope="module")
def models():
    """``models(mode)``: a narrow bf16 Llama (hidden 256 = 2 heads of 128, 3
    layers) in the mode, fused, with random norm weights, in both packages;
    built once per mode."""
    built = {}

    def get(mode):
        if mode not in built:
            built[mode] = _build_models(mode)
        return built[mode]
    return get


def _build_models(mode):
    jc, tc = _configs()
    params, layers = js.random_stacked_params(jc, mode, group_size=128 if mode == "w4a4_2l"
                                              else 64, seed=2)
    rs = np.random.RandomState(3)
    norms = {n: jnp.asarray((rs.rand(L, 256) + 0.5).astype(np.float32)).astype(jnp.bfloat16)
             for n in ("input_norm", "post_norm")}
    layers = js.fuse_stacked_layers(dataclasses.replace(layers, **norms))
    return jc, params, layers, tc, *params_from_flat(jax_to_flat(params, layers), device="cpu")


CASES = [  # (mode, batch, flags, the routes both packages must take)
    ("w4a4_2l", 8, {"FF_FUSED_QKV": "1"}, {"head_a4"}),
    ("w4a8_2l", 72, {"FF_FUSED_QKV": "1", "FF_FUSED_OGU": "1"}, {"head", "o_gu"}),
    ("w4a8_2l", 4, {"FF_FUSED_LAYER": "0", "FF_FUSED_OGU": "1"}, {"o_gu"}),
]


@pytest.mark.parametrize("case", CASES, ids=["a4-qkv", "w4a8-qkv-ogu-B72", "w4a8-ogu-B4"])
def test_fused_routes_greedy_tokens_match_jax(models, case, monkeypatch):
    mode, B, env, routes = case
    jc, jp, jl, tc, tp, tl = models(mode)
    T, S, steps = 8, 32, 4
    ids = np.random.RandomState(B).randint(0, jc.vocab_size, (B, T))
    # GIVEN one JAX prefill (no flag applies to it) and its cache in both packages
    prefill = jax.jit(lambda p, l, c, i: js.serving_forward_stacked(
        p, l, jc, i, cache=c, logits_positions="last"))
    jcache = js.StackedKVCache.create(L, B, S, jc.num_kv_heads, jc.head_dim)
    args = (jp, jl, jcache, jnp.asarray(ids))
    jlogits, jcache = prefill.lower(*args).compile(compiler_options=EXACT)(*args)
    tcache = ts.StackedKVCache(*[torch.from_numpy(np.array(a)) for a in
                                 (jcache.k, jcache.v, jcache.k_scale, jcache.v_scale)],
                               length=T)
    first = jnp.argmax(jlogits[:, -1], axis=-1).astype(jnp.int32)[:, None]

    # spies on both packages' fused entries
    taken = set()

    def spy(module, name, key):
        fn = getattr(module, name)

        def call(*a, **k):
            taken.add(key)
            return fn(*a, **k)
        monkeypatch.setattr(module, name, call)

    for key, name in (("head", "fused_norm_qkv_stacked"), ("head_a4", "fused_norm_qkv_stacked_a4"),
                      ("o_gu", "fused_o_gu_stacked"), ("tail", "fused_o_mlp_stacked")):
        spy(jm, name, f"jax {key}")
        spy(ts, name, f"port {key}")

    # WHEN both decode greedily with the flags set (the JAX loop traced
    # under them, on its TPU routes)
    for var in ("FF_FUSED_QKV", "FF_FUSED_OGU", "FF_FUSED_LAYER"):
        if var in env:
            monkeypatch.setenv(var, env[var])
        else:
            monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("FF_KV_STACKED", "force")
    monkeypatch.setattr(js, "_serving_on_tpu", lambda: True)
    loop = js.make_stacked_decode_loop(jc, steps, donate=False)
    largs = (jp, jl, jcache, first)
    jtok, _ = loop.lower(*largs).compile(compiler_options=EXACT)(*largs)
    ttok, tcache = ts.make_stacked_decode_loop(tc, steps)(
        tp, tl, tcache, torch.from_numpy(np.array(first)).long())
    # THEN the tokens are equal, and both took exactly the expected routes
    np.testing.assert_array_equal(np.asarray(jtok), ttok.numpy())
    assert tcache.length == T + steps
    assert taken == {f"{p} {r}" for p in ("jax", "port") for r in routes}
