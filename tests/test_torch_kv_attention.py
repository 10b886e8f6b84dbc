"""The port's INT8 KV quantization, KV append and flash decode against the
JAX package on the CPU.

Tolerances: `_quantize_kv` and the append are bit-exact (integer writes,
the same float ops); flash decode agrees within one bf16 ulp of the
largest output (rtol 8e-3): both compute an f32 softmax and round to bf16,
in another summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastforward_tpu.kernels import attention as ja
from fastforward_tpu.kernels import kv_update as jk
from fastforward_tpu.serving import kv_cache as jkv
from fastforward_tpu.serving import stacked as js
from fastforward_tpu_torch.kernels import attention as ta
from fastforward_tpu_torch.kernels import kv_update as tk
from fastforward_tpu_torch.serving import kv_cache as tkv
from fastforward_tpu_torch.serving import stacked as ts

RTOL = 8e-3


def _close(a, b, rtol=RTOL):
    a = np.asarray(jnp.asarray(a).astype(jnp.float32))
    b = b.float().numpy()
    assert np.abs(a - b).max() <= rtol * max(np.abs(a).max(), 1e-6)


def test_quantize_kv_bit_exact():
    # compared with the jitted JAX function: the serving path runs it under jit
    x = (np.random.RandomState(0).randn(2, 4, 5, 16) * 2).astype(np.float32)
    qj, sj = jax.jit(jkv._quantize_kv)(jnp.asarray(x).astype(jnp.bfloat16))
    qt, st = tkv._quantize_kv(torch.from_numpy(x).to(torch.bfloat16))
    np.testing.assert_array_equal(np.asarray(qj), qt.numpy())
    np.testing.assert_array_equal(np.asarray(sj), st.numpy())
    assert tkv.NEG_INF == jkv.NEG_INF


def _cache(L, B, Hkv, S, D, seed):
    rs = np.random.RandomState(seed)
    return (
        rs.randint(-128, 128, (L, B, Hkv, S, D)).astype(np.int8),
        rs.randint(-128, 128, (L, B, Hkv, S, D)).astype(np.int8),
        rs.rand(L, B, Hkv, S).astype(np.float32),
        rs.rand(L, B, Hkv, S).astype(np.float32),
    )


def test_kv_append_stacked_bit_exact():
    # GIVEN a stacked int8 cache and one new token per sequence (shapes the
    # JAX Pallas kernel takes: S % 128 == 0, D % 128 == 0)
    L, B, Hkv, S, D = 3, 2, 2, 128, 128
    cache = _cache(L, B, Hkv, S, D, seed=1)
    rs = np.random.RandomState(2)
    kn = rs.randint(-128, 128, (B, Hkv, 1, D)).astype(np.int8)
    vn = rs.randint(-128, 128, (B, Hkv, 1, D)).astype(np.int8)
    ksn = rs.rand(B, Hkv, 1).astype(np.float32)
    vsn = rs.rand(B, Hkv, 1).astype(np.float32)
    starts = np.array([5, 127], np.int32)
    new = (kn, vn, ksn, vsn, starts)
    for layer in (0, L - 1):
        # WHEN appended by the JAX kernel (interpret mode) and the port
        out_j = jk.kv_append_decode_int8_stacked(
            *map(jnp.asarray, cache), *map(jnp.asarray, new), jnp.int32(layer), interpret=True)
        out_t = tk.kv_append_decode_int8_stacked(
            *[torch.from_numpy(a.copy()) for a in cache],
            *[torch.from_numpy(a) for a in new], layer)
        # THEN every cache array is equal, other layers untouched
        for a, b in zip(out_j, out_t):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_kv_append_reference_skips_out_of_range_start():
    # the masked-select oracle writes nothing for a start outside [0, S)
    L, B, Hkv, S, D = 1, 2, 1, 8, 4
    kc, vc, ks, vs = _cache(L, B, Hkv, S, D, seed=3)
    kn = np.ones((B, Hkv, 1, D), np.int8)
    sc = np.ones((B, Hkv, 1), np.float32)
    starts = np.array([S, 2], np.int32)
    ref = jk.kv_append_decode_reference(kc[0], vc[0], ks[0], vs[0], kn, kn, sc, sc, starts)
    out = tk.kv_append_decode_reference(
        *[torch.from_numpy(a[0]) for a in (kc, vc, ks, vs)],
        torch.from_numpy(kn), torch.from_numpy(kn), torch.from_numpy(sc), torch.from_numpy(sc),
        torch.from_numpy(starts))
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(out[0][0].numpy(), kc[0][0])


def _decode_inputs(L, B, H, Hkv, S, d, seed):
    kc, vc, ks, vs = _cache(L, B, Hkv, S, d, seed)
    ks, vs = ks * 0.05, vs * 0.05
    q = np.random.RandomState(seed + 1).randn(B, H, d).astype(np.float32)
    lengths = np.random.RandomState(seed + 2).randint(1, S + 1, (B,)).astype(np.int32)
    lengths[0] = 1
    return q, kc, ks, vc, vs, lengths


@pytest.mark.parametrize("jax_fn", ["flash_decode_int8_stacked", "flash_decode_int8_stacked_ragged"])
def test_flash_decode_stacked_within_tolerance(jax_fn):
    # GIVEN a GQA decode query (G=4) over a stacked int8 cache, lengths 1..S
    L, B, H, Hkv, S, d = 2, 3, 8, 2, 64, 32
    q, kc, ks, vc, vs, lengths = _decode_inputs(L, B, H, Hkv, S, d, seed=4)
    qj = jnp.asarray(q).astype(jnp.bfloat16)
    qt = torch.from_numpy(q).to(torch.bfloat16)
    for layer in range(L):
        # WHEN attended by both packages (the one port kernel stands for
        # both JAX wrappers) THEN within one bf16 ulp of the largest output
        a = getattr(ja, jax_fn)(qj, *map(jnp.asarray, (kc, ks, vc, vs, lengths)),
                                layer=jnp.int32(layer))
        b = ta.flash_decode_int8_stacked(qt, *map(torch.from_numpy, (kc, ks, vc, vs, lengths)),
                                         layer)
        assert b.dtype == torch.bfloat16 and b.shape == (B, H, d)
        _close(a, b)


def test_flash_decode_select_lifts_a_per_layer_cache():
    L, B, H, Hkv, S, d = 1, 2, 4, 2, 32, 16
    q, kc, ks, vc, vs, lengths = _decode_inputs(L, B, H, Hkv, S, d, seed=6)
    qj = jnp.asarray(q).astype(jnp.bfloat16)
    a = js.flash_decode_select(qj, *map(jnp.asarray, (kc[0], ks[0], vc[0], vs[0])),
                               lengths=jnp.asarray(lengths), layer=None)
    b = ts.flash_decode_select(torch.from_numpy(q).to(torch.bfloat16),
                               *map(torch.from_numpy, (kc[0], ks[0], vc[0], vs[0])),
                               lengths=torch.from_numpy(lengths), layer=None)
    _close(a, b)
    _close(ja.flash_decode_int8_reference(qj, *map(jnp.asarray, (kc[0], ks[0], vc[0], vs[0],
                                                                   lengths))),
           ta.flash_decode_int8_reference(torch.from_numpy(q).to(torch.bfloat16),
                                          *map(torch.from_numpy, (kc[0], ks[0], vc[0], vs[0],
                                                                  lengths))))


def _bf16_ulp(a):
    """One bf16 ulp of each value of ``a`` (8 significant bits)."""
    mag = np.maximum(np.abs(a), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def _prefill_inputs(B, H, Hkv, T, S, d, int8_kv, seed):
    rs = np.random.RandomState(seed)
    q = rs.randn(B, H, T, d).astype(np.float32)
    if int8_kv:
        k = rs.randint(-128, 128, (B, Hkv, S, d)).astype(np.int8)
        v = rs.randint(-128, 128, (B, Hkv, S, d)).astype(np.int8)
        ks = (rs.rand(B, Hkv, S) * 0.02).astype(np.float32)
        vs = (rs.rand(B, Hkv, S) * 0.05).astype(np.float32)
        return q, k, ks, v, vs
    k = rs.randn(B, Hkv, S, d).astype(np.float32) * 0.3
    v = rs.randn(B, Hkv, S, d).astype(np.float32)
    return q, k, None, v, None


@pytest.mark.parametrize("int8_kv", [True, False])
@pytest.mark.parametrize("T", [8, 40, 128])
@pytest.mark.parametrize("G", [1, 2, 4])
def test_flash_prefill_matches_jax(G, T, int8_kv):
    # GIVEN causal prefill queries (head dim 128) over a cache of S = T + 24
    # rows, int8 with per-token scales or bf16, starting at 0 or later
    B, Hkv, d = 2, 2, 128
    H, S = Hkv * G, T + 24
    q, k, ks, v, vs = _prefill_inputs(B, H, Hkv, T, S, d, int8_kv, seed=G * T)
    for starts in (np.array([0, 0], np.int32), np.array([24, 7], np.int32)):
        for q_dtype in ("float32", "bfloat16"):
            qj = jnp.asarray(q).astype(getattr(jnp, q_dtype))
            qt = torch.from_numpy(q).to(getattr(torch, q_dtype))
            if int8_kv:
                kvj = [jnp.asarray(a) for a in (k, ks, v, vs)]
                kvt = [torch.from_numpy(a) for a in (k, ks, v, vs)]
            else:
                kj, vj = (jnp.asarray(a).astype(jnp.bfloat16) for a in (k, v))
                kt, vt = (torch.from_numpy(a).to(torch.bfloat16) for a in (k, v))
                kvj, kvt = [kj, None, vj, None], [kt, None, vt, None]
            # WHEN attended by both packages (JAX's flash_prefill runs its
            # reference off the TPU; so does the port's wrapper on the CPU)
            a = ja.flash_prefill(qj, *kvj, jnp.asarray(starts))
            b = ta.flash_prefill(qt, *kvt, torch.from_numpy(starts))
            ra = ja.flash_prefill_reference(qj, *kvj, jnp.asarray(starts))
            rb = ta.flash_prefill_reference(qt, *kvt, torch.from_numpy(starts))
            assert b.dtype == qt.dtype and tuple(b.shape) == (B, H, T, d)
            # THEN within atol 1e-5 in f32 (another summation order); in
            # bf16 within that and one bf16 ulp of the value (the two f32
            # results may round to neighbouring bf16 values)
            for x, y in ((a, b), (ra, rb)):
                x = np.asarray(x.astype(jnp.float32))
                y = y.float().numpy()
                if q_dtype == "float32":
                    np.testing.assert_allclose(y, x, rtol=0, atol=1e-5)
                else:
                    assert (np.abs(x - y) <= _bf16_ulp(x) + 1e-5).all()
