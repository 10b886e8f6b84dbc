"""The decode step's fused K/V quantize and append (`kv_quantize_append_stacked`,
`kv_quantize_append`, `paged_kv_quantize_append`) against the JAX package on
the CPU: their plain versions against the jitted JAX `_quantize_kv`
followed by the JAX append of each form (the Pallas kernels interpreted
where a start lies in the cache, their oracles at the edge starts, as the
port's append tests run them). Inputs from a numpy seed; k contiguous as
RoPE leaves it, v a view of a qkv row with its row stride, as the
projection leaves it. Bit-exact: the quantizer's float ops are the same
and the append is a copy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastforward_tpu.kernels import kv_update as jkvu
from fastforward_tpu.kernels import paged_attention as jpa
from fastforward_tpu.serving import kv_cache as jkv
from fastforward_tpu_torch.kernels import kv_update as tkvu
from fastforward_tpu_torch.kernels import paged_attention as tpa
from fastforward_tpu_torch.serving import kv_cache as tkv

_quantize = jax.jit(jkv._quantize_kv)
L, HKV, D = 2, 2, 128


def _token(B, seed):
    """(JAX k, JAX v, port k, port v): bf16 (B, Hkv, 1, D); the port's v a
    strided view of a (B, 1, Hq + 2 Hkv, D) qkv row, its k contiguous."""
    rs = np.random.RandomState(seed)
    qkv = (rs.randn(B, 1, 2 + 2 * HKV, D) * 3).astype(np.float32)
    qkv[0, 0, 2] = 0.0  # a zero row: the scale's 1e-8 floor
    qkv[1, 0, 2 + HKV, :7] = 0.5  # ties that round half to even
    t = torch.from_numpy(qkv).to(torch.bfloat16)
    k = t[:, :, 2:2 + HKV].transpose(1, 2).contiguous()
    v = t[:, :, 2 + HKV:].transpose(1, 2)
    assert not v.is_contiguous() and v.stride(0) == (2 + 2 * HKV) * D
    to_j = lambda a: jnp.asarray(a.float().numpy()).astype(jnp.bfloat16)  # noqa: E731
    return to_j(k), to_j(v), k, v


def _slab(B, S, seed):
    rs = np.random.RandomState(seed)
    return (rs.randint(-128, 128, (L, B, HKV, S, D)).astype(np.int8),
            rs.randint(-128, 128, (L, B, HKV, S, D)).astype(np.int8),
            rs.rand(L, B, HKV, S).astype(np.float32),
            rs.rand(L, B, HKV, S).astype(np.float32))


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_quantize_kv_is_the_serving_quantizer():
    # the kernels module holds the one quantizer the serving cache uses
    assert tkv._quantize_kv is tkvu.quantize_kv


@pytest.mark.parametrize("starts", [(5, 127, 0), (-1, 128, 64)])
def test_stacked_form_bit_equal_to_jax(starts):
    # GIVEN a stacked int8 slab (S = 128) and one token per sequence
    B, S = 3, 128
    cache = _slab(B, S, seed=1)
    kj, vj, kt, vt = _token(B, seed=2)
    st = np.asarray(starts, np.int32)
    inside = all(0 <= s < S for s in starts)
    for layer in (0, L - 1):
        # WHEN JAX quantizes (jitted) and appends (its kernel interpreted, or
        # past the slab its oracle) and the port runs its fused plain version
        (kq, ks), (vq, vs) = _quantize(kj), _quantize(vj)
        args = [jnp.asarray(a) for a in cache] + [kq, vq, ks, vs, jnp.asarray(st)]
        if inside:
            ref = jkvu.kv_append_decode_int8_stacked(*args, jnp.int32(layer), interpret=True)
        else:
            ref = jkvu.kv_append_decode_stacked_reference(*args, jnp.int32(layer))
        out = [torch.from_numpy(a.copy()) for a in cache]
        got = tkvu.kv_quantize_append_stacked(*out, kt, vt, torch.from_numpy(st), layer)
        # THEN every cache array is bit-equal, written in place
        for a, b, c in zip(ref, got, out):
            assert b is c
            _eq(a, b)


@pytest.mark.parametrize("starts", [(0, 255, 37), (0, 256, -1)])
def test_per_layer_form_bit_equal_to_jax(starts):
    # GIVEN one layer's (B, Hkv, 256, D) int8 cache
    B, S = 3, 256
    kc, vc, ks, vs = (a[0] for a in _slab(B, S, seed=3))
    kj, vj, kt, vt = _token(B, seed=4)
    st = np.asarray(starts, np.int32)
    (kq, ksn), (vq, vsn) = _quantize(kj), _quantize(vj)
    args = [jnp.asarray(a) for a in (kc, vc, ks, vs)] + [kq, vq, ksn, vsn, jnp.asarray(st)]
    inside = all(0 <= s < S for s in starts)
    ref = (jkvu.kv_append_decode_int8(*args, interpret=True) if inside
           else jkvu.kv_append_decode_reference(*args))
    out = [torch.from_numpy(a.copy()) for a in (kc, vc, ks, vs)]
    got = tkvu.kv_quantize_append(*out, kt, vt, torch.from_numpy(st))
    for a, b, c in zip(ref, got, out):
        assert b is c
        _eq(a, b)
    # AND through the per-layer cache's one-token write
    layer = tkv.LayerKVCache(*[torch.from_numpy(a.copy()) for a in (kc, vc, ks, vs)])
    layer.write(kt, vt, torch.from_numpy(st), torch.from_numpy(st))
    for a, b in zip(ref, (layer.k, layer.v, layer.k_scale, layer.v_scale)):
        _eq(a, b)


@pytest.mark.parametrize("page", [32, 128])
def test_paged_form_bit_equal_to_jax(page):
    # GIVEN a pool of 6 pages and a table with an allocated page, a -1
    # entry and positions at and beyond the table (pos // page >= MP)
    B, P, MP = 4, 6, 3
    rs = np.random.RandomState(page)
    pools = (rs.randint(-128, 128, (L, P, HKV, page, D)).astype(np.int8),
             rs.randint(-128, 128, (L, P, HKV, page, D)).astype(np.int8),
             rs.rand(L, P, HKV, page).astype(np.float32),
             rs.rand(L, P, HKV, page).astype(np.float32))
    table = np.array([[1, 2, -1], [3, -1, -1], [4, 5, -1], [-1, -1, -1]], np.int32)
    pos = np.array([page + 3, page + 1, 2 * page + 5, MP * page + 7], np.int32)
    kj, vj, kt, vt = _token(B, seed=5)
    (kq, ks), (vq, vs) = _quantize(kj), _quantize(vj)
    # WHEN JAX appends through its reference on the table its TPU wrapper
    # passes (max(table, 0): -1 is the trash page 0) and the port quantizes
    # and appends in one
    ref = jpa.paged_kv_append_reference(*[jnp.asarray(a) for a in pools], kq, vq, ks, vs,
                                        jnp.asarray(pos), jnp.maximum(jnp.asarray(table), 0), 1)
    out = [torch.from_numpy(a.copy()) for a in pools]
    got = tpa.paged_kv_quantize_append(*out, kt, vt, torch.from_numpy(pos),
                                       torch.from_numpy(table), 1)
    # THEN the pools are bit-equal, and the -1 entry wrote page 0
    for a, b, c in zip(ref, got, out):
        assert b is c
        _eq(a, b)
    assert torch.equal(out[0][1, 0, :, 1], torch.from_numpy(np.array(kq)[1, :, 0]))


def test_fused_forms_check_their_inputs():
    # on the card the wrappers take one token's bf16 or f32 k and v of the
    # cache's shape; a CPU cache runs the plain version whatever it is given
    kc = torch.zeros((1, 2, HKV, 8, D), dtype=torch.int8)
    with pytest.raises(ValueError, match="shape"):
        tkvu.require_token_kv(torch.zeros(2, HKV, 2, D), torch.zeros(2, HKV, 2, D), 2, HKV, D,
                              kc.device)
    with pytest.raises(ValueError, match="bf16 or f32"):
        tkvu.require_token_kv(torch.zeros(2, HKV, 1, D, dtype=torch.float16),
                              torch.zeros(2, HKV, 1, D, dtype=torch.float16), 2, HKV, D,
                              kc.device)
    v = torch.zeros(2, 1, 3 * HKV, D).transpose(1, 2)[:, :HKV]
    assert tkvu.token_strides(v) == (3 * HKV * D, D, 1)
