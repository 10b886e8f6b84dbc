"""The port's per-layer KV cache and the kernels of its path against the
JAX package, on the CPU.

Inputs are made from a seed with numpy and handed to both packages.
Bit-equal: `LayerKVCache.append` (int8 and bf16, one token and a block,
1-D and per-row positions), `read`, `attention_mask`, the per-layer append
`kv_append_decode_int8` against the JAX kernel run with ``interpret=True``
(at starts inside the cache; a start at or past S against the JAX
masked-select oracle, which writes nothing, where the interpreted TPU
kernel's block index leaves the cache and it writes another row), the
unpaired (group-halves) two-level W4A8 GEMV's plain version against the
jitted JAX oracle, and `repack_unpaired`. Within 1e-5 of the largest
output (f32 attention whose sums run in another order): the plain
versions of `flash_decode_int8` and `flash_prefill` (bf16 K/V with None
scales, and int8) against the JAX oracles, with f32 queries.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastforward_tpu.kernels import attention as jatt
from fastforward_tpu.kernels import kv_update as jkvu
from fastforward_tpu.kernels import matmul as jm
from fastforward_tpu.kernels import packing as jpk
from fastforward_tpu.serving import engine as je
from fastforward_tpu.serving import kv_cache as jkv
from fastforward_tpu_torch.kernels import attention as tatt
from fastforward_tpu_torch.kernels import kv_update as tkvu
from fastforward_tpu_torch.kernels import matmul as tm
from fastforward_tpu_torch.serving import engine as te
from fastforward_tpu_torch.serving import kv_cache as tkv

ATTN_RTOL = 1e-5  # f32 attention, another summation order: share of the largest output
EXACT = {"xla_allow_excess_precision": False}


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(a, b):
    a = np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)
    b = b.float().numpy() if b.dtype == torch.bfloat16 else b.numpy()
    np.testing.assert_array_equal(a, b)


def _kv_state(B, H, S, D, seed, quantized):
    """A filled cache and new entries, as numpy."""
    rs = np.random.RandomState(seed)
    if quantized:
        cache = [rs.randint(-128, 128, (B, H, S, D)).astype(np.int8) for _ in range(2)]
        cache += [rs.rand(B, H, S).astype(np.float32) for _ in range(2)]
    else:
        cache = [rs.randn(B, H, S, D).astype(np.float32) for _ in range(2)]
    return cache


def _jax_layer(cache, quantized):
    if quantized:
        return jkv.LayerKVCache(*(jnp.asarray(a) for a in cache))
    return jkv.LayerKVCache(k=jnp.asarray(cache[0]).astype(jnp.bfloat16),
                            v=jnp.asarray(cache[1]).astype(jnp.bfloat16))


def _torch_layer(cache, quantized):
    if quantized:
        return tkv.LayerKVCache(*(_t(a) for a in cache))
    return tkv.LayerKVCache(k=_t(cache[0]).to(torch.bfloat16), v=_t(cache[1]).to(torch.bfloat16))


@pytest.mark.parametrize("starts", [(0, 255, 37), (0, 256, 300)])
def test_kv_append_decode_int8_matches_jax_kernel(starts):
    # GIVEN a (3, 2, 256, 128) int8 cache and one new token per sequence
    B, H, S, D = 3, 2, 256, 128
    kc, vc, ks, vs = _kv_state(B, H, S, D, seed=1, quantized=True)
    rs = np.random.RandomState(2)
    kn, vn = (rs.randint(-128, 128, (B, H, 1, D)).astype(np.int8) for _ in range(2))
    ksn, vsn = (rs.rand(B, H, 1).astype(np.float32) for _ in range(2))
    st = np.asarray(starts, np.int32)
    args = [jnp.asarray(a) for a in (kc, vc, ks, vs, kn, vn, ksn, vsn, st)]
    inside = all(0 <= s < S for s in starts)
    # WHEN the JAX kernel runs interpreted (or, past the cache, its oracle)
    # and the port appends in place
    ref = (jkvu.kv_append_decode_int8(*args, interpret=True) if inside
           else jkvu.kv_append_decode_reference(*args))
    out = [_t(a) for a in (kc, vc, ks, vs)]
    got = tkvu.kv_append_decode_int8(*out, _t(kn), _t(vn), _t(ksn), _t(vsn), _t(st))
    # THEN every buffer is bit-equal, written in place; past S nothing moved
    for a, b, c in zip(ref, got, out):
        assert b is c
        _eq(a, b)
    if not inside:
        np.testing.assert_array_equal(out[0][1].numpy(), kc[1])


@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("T", [1, 5])
@pytest.mark.parametrize("per_row", [False, True])
def test_layer_append_bit_equal(quantized, T, per_row):
    # GIVEN a filled layer cache (S = 64) and T new (k, v) entries per row
    B, H, S, D = 3, 2, 64, 16
    cache = _kv_state(B, H, S, D, seed=3 + T, quantized=quantized)
    rs = np.random.RandomState(4)
    kn, vn = (rs.randn(B, H, T, D).astype(np.float32) * 2 for _ in range(2))
    if per_row:  # one row at S - 1 (T = 1) or at the last fitting start, one past S
        first = [0, S - T, 7] if T > 1 else [0, S - 1, S + 2]
        pos = np.asarray(first, np.int32)[:, None] + np.arange(T, dtype=np.int32)[None, :]
    else:
        pos = np.arange(T, dtype=np.int32) + 11
    jl, tl = _jax_layer(cache, quantized), _torch_layer(cache, quantized)
    kj, vj = (jnp.asarray(a).astype(jnp.bfloat16) for a in (kn, vn))
    kt, vt = (_t(a).to(torch.bfloat16) for a in (kn, vn))
    # WHEN both append
    ja = jax.jit(lambda c, k, v, p: c.append(k, v, p))(jl, kj, vj, jnp.asarray(pos))
    ta = tl.append(kt, vt, _t(pos))
    # THEN the buffers are bit-equal, and the port wrote its own in place
    fields = ("k", "v", "k_scale", "v_scale") if quantized else ("k", "v")
    for f in fields:
        _eq(getattr(ja, f), getattr(ta, f))
        assert getattr(ta, f) is getattr(tl, f)
    assert ta.is_quantized == ja.is_quantized == quantized


def test_block_past_the_cache_raises_where_jax_clamps():
    # GIVEN a block of 5 rows from start 62 of a 64-row cache
    B, H, S, D, T = 1, 1, 64, 16, 5
    cache = _kv_state(B, H, S, D, seed=5, quantized=False)
    kn = np.ones((B, H, T, D), np.float32)
    pos = np.arange(T, dtype=np.int32) + 62
    # WHEN JAX appends THEN dynamic_update_slice clamps the block to start 59
    ja = _jax_layer(cache, False).append(jnp.asarray(kn).astype(jnp.bfloat16),
                                         jnp.asarray(kn).astype(jnp.bfloat16), jnp.asarray(pos))
    assert bool(jnp.all(ja.k[0, 0, 59:] == 1))
    # WHEN the port appends THEN it raises and leaves the cache as it was
    tl = _torch_layer(cache, False)
    before = tl.k.clone()
    with pytest.raises(ValueError, match="leaves the cache"):
        tl.append(_t(kn).to(torch.bfloat16), _t(kn).to(torch.bfloat16), _t(pos))
    assert torch.equal(tl.k, before)


def test_read_mask_and_create_match_jax():
    # read (dequantized) and the additive mask
    B, H, S, D = 2, 2, 32, 16
    cache = _kv_state(B, H, S, D, seed=6, quantized=True)
    jl, tl = _jax_layer(cache, True), _torch_layer(cache, True)
    for dtype in ("bfloat16", "float32"):
        for a, b in zip(jl.read(getattr(jnp, dtype)), tl.read(getattr(torch, dtype))):
            _eq(a, b)
    pos = np.asarray([[3, 4], [9, 10]], np.int32)
    _eq(jl.attention_mask(jnp.asarray(pos)), tl.attention_mask(_t(pos)))
    _eq(jl.attention_mask(jnp.asarray(pos[0])), tl.attention_mask(_t(pos[0])))
    # create: the JAX package's shapes and dtypes; layer, with_layers
    for quantized in (True, False):
        jc = jkv.KVCache.create(3, B, S, H, D, quantized=quantized)
        tc = tkv.KVCache.create(3, B, S, H, D, quantized=quantized, device="cpu")
        for a, b in zip(jc.layers, tc.layers):
            for f in ("k", "v", "k_scale", "v_scale"):
                x, y = getattr(a, f), getattr(b, f)
                assert (x is None) == (y is None)
                if x is not None:
                    assert tuple(x.shape) == tuple(y.shape)
                    assert str(x.dtype) == str(y.dtype).split(".")[1]
        assert (tc.max_len, tc.batch_size, tc.length) == (jc.max_len, jc.batch_size, 0)
        moved = tc.with_layers(tc.layers, advance=7)
        assert moved.length == 7 and moved.layer(2) is tc.layer(2)


class _SimQuantizer:
    """A simulation-tier KV quantizer on either package: dynamic symmetric
    8-bit per (batch, head, token) row, or static 4-bit per tensor (scale
    0.05); not a stub."""

    is_stub = False

    def __init__(self, pkg, kind):
        self.pkg, self.kind = pkg, kind

    def __call__(self, x):
        if self.kind == "dynamic":
            return self.pkg.quantize_dynamically(x, self.pkg.PerChannel((0, 1, 2)), num_bits=8,
                                                 symmetric=True)
        return self.pkg.quantize_per_tensor(x, 0.05, num_bits=4)


def _sim_append_parity(quantized, T, kind):
    """The port's append with a real quantizer against JAX's (jitted without
    excess precision), from the same cache and new rows."""
    from fastforward_tpu import quantization as jq
    from fastforward_tpu_torch import quantization as tq

    B, H, S, D = 3, 2, 32, 16
    cache = _kv_state(B, H, S, D, seed=7 + T, quantized=quantized)
    rs = np.random.RandomState(8)
    kn, vn = (rs.randn(B, H, T, D).astype(np.float32) for _ in range(2))
    pos = np.arange(T, dtype=np.int32) + 5
    jl, tl = _jax_layer(cache, quantized), _torch_layer(cache, quantized)
    jquant = _SimQuantizer(jq, kind)
    args = (jl, *(jnp.asarray(a).astype(jnp.bfloat16) for a in (kn, vn)), jnp.asarray(pos))
    ja = jax.jit(lambda c, k, v, p: c.append(k, v, p, quantizer=jquant)).lower(*args).compile(
        compiler_options=EXACT)(*args)
    ta = tl.append(*(_t(a).to(torch.bfloat16) for a in (kn, vn)), _t(pos),
                   quantizer=_SimQuantizer(tq, kind))
    for f in ("k", "v", "k_scale", "v_scale") if quantized else ("k", "v"):
        _eq(getattr(ja, f), getattr(ta, f))
    # the quantizer acted: without it the same append writes other values
    plain = _torch_layer(cache, quantized).append(*(_t(a).to(torch.bfloat16) for a in (kn, vn)),
                                                  _t(pos))
    assert not torch.equal(plain.k, ta.k)


def test_simulation_tier_quantizer_is_not_ported():
    # a stub changes nothing; a real quantizer gives JAX's append bit for bit
    B, H, S, D = 1, 1, 8, 16
    tl = _torch_layer(_kv_state(B, H, S, D, seed=7, quantized=False), False)
    k = torch.ones((B, H, 1, D), dtype=torch.bfloat16)

    class Stub:
        is_stub = True

    tl.append(k, k, torch.tensor([2]), quantizer=Stub())  # a stub changes nothing
    assert torch.equal(tl.k[0, 0, 2], k[0, 0, 0])
    # the decode step's int8 append (the fused quantize-append at T = 1)
    _sim_append_parity(True, 1, "dynamic")


@pytest.mark.parametrize("quantized,T,kind", [(True, 1, "static"), (True, 4, "dynamic"),
                                              (True, 4, "static"), (False, 1, "dynamic"),
                                              (False, 4, "static")])
def test_simulation_tier_quantizer_matches_jax(quantized, T, kind):
    _sim_append_parity(quantized, T, kind)


@pytest.mark.parametrize("G", [1, 4])
def test_flash_decode_int8_plain_matches_jax_oracle(G):
    # GIVEN an int8 cache of 300 rows, lengths from 1 to S, f32 queries
    B, Hkv, S, d = 4, 2, 300, 128
    k, v, ks, vs = _kv_state(B, Hkv, S, d, seed=8 + G, quantized=True)
    q = np.random.RandomState(9).randn(B, Hkv * G, d).astype(np.float32)
    lengths = np.asarray([1, 77, 256, S], np.int32)
    a = np.asarray(jatt.flash_decode_int8_reference(
        *(jnp.asarray(x) for x in (q, k, ks, v, vs, lengths))))
    b = tatt.flash_decode_int8(*(_t(x) for x in (q, k, ks, v, vs, lengths))).numpy()
    # THEN within ATTN_RTOL of the largest output
    assert b.shape == a.shape == (B, Hkv * G, d)
    assert np.abs(a - b).max() <= ATTN_RTOL * np.abs(a).max()


@pytest.mark.parametrize("quantized", [False, True])
def test_flash_prefill_reference_matches_jax(quantized):
    # GIVEN bf16 K/V without scales (or int8 with scales), ragged starts
    B, Hkv, G, T, S, d = 3, 2, 2, 24, 64, 128
    rs = np.random.RandomState(10)
    q = rs.randn(B, Hkv * G, T, d).astype(np.float32)
    starts = np.asarray([0, 17, 40], np.int32)
    if quantized:
        k, v, ks, vs = _kv_state(B, Hkv, S, d, seed=11, quantized=True)
        kv_j = [jnp.asarray(x) for x in (k, ks, v, vs)]
        kv_t = [_t(x) for x in (k, ks, v, vs)]
    else:
        k, v = (rs.randn(B, Hkv, S, d).astype(np.float32) for _ in range(2))
        kv_j = [jnp.asarray(k).astype(jnp.bfloat16), None, jnp.asarray(v).astype(jnp.bfloat16),
                None]
        kv_t = [_t(k).to(torch.bfloat16), None, _t(v).to(torch.bfloat16), None]
    # WHEN both oracles run (the port's wrapper takes its plain version on
    # the CPU)
    a = np.asarray(jatt.flash_prefill_reference(jnp.asarray(q), *kv_j, jnp.asarray(starts)))
    b = tatt.flash_prefill(_t(q), *kv_t, _t(starts)).numpy()
    # THEN within ATTN_RTOL of the largest output
    assert b.shape == a.shape == (B, Hkv * G, T, d)
    assert np.abs(a - b).max() <= ATTN_RTOL * np.abs(a).max()


@pytest.mark.parametrize("M", [1, 192])
@pytest.mark.parametrize("K,g", [(4096, 128), (384, 64)])
@pytest.mark.parametrize("out_dtype", ["bfloat16", "float32"])
def test_unpaired_w4a8_2l_gemv_bit_equal(M, K, g, out_dtype):
    # GIVEN group-halves offset-binary weights (an odd group count too)
    N = 36
    rs = np.random.RandomState(M + K + g)
    w = rs.randint(-128, 128, (K // 2, N)).astype(np.int8)
    m = rs.randint(1, 16, (K // g, N)).astype(np.int8)
    s = (rs.rand(N) * 1e-2).astype(np.float32)
    x = (rs.randn(M, K) * 3).astype(np.float32)
    qj, sj = jax.jit(jm.quantize_rowwise)(jnp.asarray(x).astype(jnp.bfloat16))
    qt, st = tm.quantize_rowwise(_t(x).to(torch.bfloat16))
    # WHEN the jitted JAX oracle and the port's GEMV (its plain version) run
    fn = jax.jit(lambda q, xs, w, m, s: jm.matmul_w4a8_2l_reference(
        q, xs, w, m, s, None, g, getattr(jnp, out_dtype), paired=False))
    a = fn.lower(qj, sj, *(jnp.asarray(z) for z in (w, m, s))).compile(
        compiler_options=EXACT)(qj, sj, *(jnp.asarray(z) for z in (w, m, s)))
    b = tm.matmul_w4a8_2l_gemv(qt, st, _t(w), _t(m), _t(s), g, getattr(torch, out_dtype),
                               paired=False)
    # THEN bit-equal; the argmax head's unpaired route gives the same ids
    _eq(a, b)
    ids = tm.matmul_w4a8_2l_gemv_argmax(qt, st, _t(w), _t(m), _t(s), g, paired=False)
    np.testing.assert_array_equal(
        ids.numpy(), np.asarray(jm.matmul_w4a8_2l_gemv_argmax(
            qj, sj, *(jnp.asarray(z) for z in (w, m, s)), g, paired=False)))


@pytest.mark.parametrize("stacked", [False, True])
def test_repack_unpaired_bit_equal(stacked):
    # GIVEN paired two-level weights (stacked over 2 layers or not)
    rs = np.random.RandomState(12)
    K, N, g = 256, 24, 32
    lead = (2,) if stacked else ()
    data = rs.randint(-128, 128, lead + (K // 2, N)).astype(np.int8)
    mult = rs.randint(1, 16, lead + (K // g, N)).astype(np.int8)
    scale = rs.rand(*lead, N).astype(np.float32)
    jq = je.QuantLinear(jnp.asarray(data), jnp.asarray(scale), mode="w4a8_2l", group_size=g,
                        mult=jnp.asarray(mult), paired=True)
    tq = te.QuantLinear(_t(data), _t(scale), mode="w4a8_2l", group_size=g, mult=_t(mult),
                        paired=True)
    # WHEN both repack THEN the bytes agree and the layout is group halves
    a, b = je.repack_unpaired(jq), te.repack_unpaired(tq)
    assert not b.paired and not a.paired and b.mult is tq.mult
    _eq(a.data, b.data)
    first = data[0] if stacked else data
    v = jpk.unpack_uint4_offset_paired(jnp.asarray(first), g)
    _eq(jpk.pack_uint4_offset(v, g), b.data[0] if stacked else b.data)
    assert te.repack_unpaired(b) is b
