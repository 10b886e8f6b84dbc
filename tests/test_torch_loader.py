"""The port's checkpoint loader against the JAX package's, on the CPU.

An HF-layout Llama checkpoint (hidden 256, 2 layers, head dim 128, vocab
256) is written in f32 with ``safetensors.numpy``, its weights drawn from a
seed with numpy. Some rows are multiples of 0.5 on a grid whose scale is
exactly 1 (absmax 7 for int4, 127 for int8), so quantization meets exact
ties. The JAX loader quantizes on the host through its C++ library
(asserted loaded), which rounds ties away from zero; the port quantizes
with plain torch functions; the carried arrays must be byte-equal in
w8a8, w4a8 and w4a16. The port's safetensors reader is also held against
``safetensors.torch`` on a bf16/f16 checkpoint, with every ``safetensors``
module taken out of ``sys.modules``: none may come back while it reads.
"""

import hashlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastforward_tpu import native
from fastforward_tpu.models.llama import LlamaConfig as JConfig
from fastforward_tpu.serving import loader as jloader
from fastforward_tpu_torch.models.llama import LlamaConfig as TConfig
from fastforward_tpu_torch.serving import engine as te
from fastforward_tpu_torch.serving import loader as tloader
from fastforward_tpu_torch.serving.convert import params_to_flat
from tests.test_torch_serving_forward import jax_params_to_flat

_KW = dict(vocab_size=256, hidden_size=256, intermediate_size=512, num_layers=2,
           num_heads=2, num_kv_heads=1, head_dim=128, max_seq_len=512)


def _hf_weights(seed=0):
    """HF-layout f32 weights of the narrow config: (out, in) linears."""
    rs = np.random.RandomState(seed)
    h, inter, d = _KW["hidden_size"], _KW["intermediate_size"], _KW["head_dim"]
    nh, nkv = _KW["num_heads"], _KW["num_kv_heads"]

    def lin(n_out, n_in):
        return (rs.randn(n_out, n_in) * 0.05).astype(np.float32)

    w = {"model.embed_tokens.weight": lin(_KW["vocab_size"], h) * 10,
         "model.norm.weight": (1 + 0.1 * rs.randn(h)).astype(np.float32),
         "lm_head.weight": lin(_KW["vocab_size"], h)}
    for i in range(_KW["num_layers"]):
        p = f"model.layers.{i}."
        w.update({
            p + "self_attn.q_proj.weight": lin(nh * d, h),
            p + "self_attn.k_proj.weight": lin(nkv * d, h),
            p + "self_attn.v_proj.weight": lin(nkv * d, h),
            p + "self_attn.o_proj.weight": lin(h, nh * d),
            p + "mlp.gate_proj.weight": lin(inter, h),
            p + "mlp.up_proj.weight": lin(inter, h),
            p + "mlp.down_proj.weight": lin(h, inter),
            p + "input_layernorm.weight": (1 + 0.1 * rs.randn(h)).astype(np.float32),
            p + "post_attention_layernorm.weight": (1 + 0.1 * rs.randn(h)).astype(np.float32),
        })
    # exact ties: halves on a grid of scale 1 (int4: |w| <= 7 with 7 in each
    # group of 128; int8: |w| <= 127 with 127 in the column)
    q = w["model.layers.0.self_attn.q_proj.weight"]
    q[:8] = rs.randint(-14, 15, (8, h)) * 0.5
    q[:8, ::128] = 7.0
    k = w["model.layers.0.self_attn.k_proj.weight"]
    k[:8] = rs.randint(-254, 255, (8, h)) * 0.5
    k[:8, 0] = -127.0
    return w


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    from safetensors.numpy import save_file

    path = tmp_path_factory.mktemp("ckpt") / "model.safetensors"
    save_file(_hf_weights(), str(path))
    return str(path)


def test_ties_exist_and_the_rounding_is_half_away_from_zero():
    # the tie rows quantize differently under lround and np.round; the
    # port gives the C++ packer's bytes, not the numpy fallback's
    assert native.native_available()
    w = _hf_weights()
    q = np.ascontiguousarray(w["model.layers.0.self_attn.q_proj.weight"].T)
    k = np.ascontiguousarray(w["model.layers.0.self_attn.k_proj.weight"].T)
    packed, scales = native.quantize_pack_int4(q, 128)
    np_packed, _ = native._quantize_pack_int4_numpy(q, 128)
    assert (packed != np_packed).any()
    tp, ts_ = tloader.quantize_pack_int4(torch.from_numpy(q), 128)
    np.testing.assert_array_equal(tp.numpy(), packed)
    np.testing.assert_array_equal(ts_.numpy(), scales)
    q8, s8 = native.quantize_int8(k)
    t8, ts8 = tloader.quantize_int8(torch.from_numpy(k))
    np.testing.assert_array_equal(t8.numpy(), q8)
    np.testing.assert_array_equal(ts8.numpy(), s8)
    assert (q8 != np.clip(np.round(k / s8[None, :]), -128, 127).astype(np.int8)).any()
    # an all-zero group takes the scale 1e-8, as in C++
    z = torch.zeros((128, 4))
    assert torch.equal(tloader.quantize_pack_int4(z, 128)[1], torch.full((1, 4), 1e-8))


@pytest.mark.parametrize("mode", ["w8a8", "w4a8", "w4a16"])
def test_load_llama_bit_equal_to_jax(checkpoint, mode):
    # GIVEN the f32 checkpoint
    jc, tc = JConfig(**_KW, dtype=jnp.float32), TConfig(**_KW, dtype=torch.float32)
    # WHEN both loaders read it
    jp = jloader.load_llama(checkpoint, jc, mode=mode, group_size=128)
    tp = tloader.load_llama(checkpoint, tc, mode=mode, group_size=128, device="cpu")
    # THEN every carried array is byte-equal
    a, b = jax_params_to_flat(jp), params_to_flat(tp)
    assert set(a) == set(b)
    for key in a:
        assert np.ascontiguousarray(a[key]).tobytes() == np.ascontiguousarray(b[key]).tobytes(), key
    # AND the port serves the loaded params
    ids = torch.from_numpy(np.random.RandomState(1).randint(0, tc.vocab_size, (2, 4)))
    logits, _ = te.serving_forward(tp, tc, ids)
    assert logits.shape == (2, 4, tc.vocab_size) and torch.isfinite(logits).all()


@pytest.mark.parametrize("mode", ["w4a8_2l", "w4a4_2l"])
def test_two_level_modes_raise(checkpoint, mode):
    # the JAX loader builds a two-level QuantLinear without multipliers, which
    # fails when called; the port's loader refuses the mode
    with pytest.raises(ValueError, match="loader.py:44-55"):
        tloader.load_llama(checkpoint, TConfig(**_KW), mode=mode, device="cpu")
    jp = jloader.load_llama(checkpoint, JConfig(**_KW), mode=mode)
    assert jp.layers[0].q_proj.mult is None
    with pytest.raises(AttributeError):
        jp.layers[0].q_proj(jnp.ones((1, _KW["hidden_size"]), jnp.bfloat16))


def _digest(t):
    return hashlib.sha256(t.contiguous().view(-1).view(torch.uint8).numpy().tobytes()).hexdigest()


def test_reader_loads_bf16_without_the_safetensors_package(tmp_path, monkeypatch):
    # GIVEN a bf16 and f16 checkpoint in two shards written by safetensors.torch
    from safetensors.torch import load_file, save_file

    gen = torch.Generator().manual_seed(0)
    shard = {"model.embed_tokens.weight": torch.randn((64, 32), generator=gen).to(torch.bfloat16),
             "model.norm.weight": torch.randn((32,), generator=gen).to(torch.float16)}
    save_file(shard, str(tmp_path / "a.safetensors"))
    save_file({"lm_head.weight": torch.randn((64, 32), generator=gen).to(torch.bfloat16),
               "scalar": torch.tensor(3.5)}, str(tmp_path / "b.safetensors"))
    want = {**load_file(str(tmp_path / "a.safetensors")),
            **load_file(str(tmp_path / "b.safetensors"))}
    # WHEN the port's reader loads the directory with every safetensors
    # module taken out of sys.modules (put back after the test)
    for name in [m for m in sys.modules if m.split(".")[0] == "safetensors"]:
        monkeypatch.delitem(sys.modules, name)
    got = tloader.load_tensors(str(tmp_path))
    # THEN it imported no safetensors module, and every tensor's dtype,
    # shape and bytes are those safetensors.torch reads
    assert not [m for m in sys.modules if m.split(".")[0] == "safetensors"]
    assert set(got) == set(want)
    for name, t in want.items():
        g = got[name]
        assert (g.dtype, tuple(g.shape), _digest(g)) == (t.dtype, tuple(t.shape), _digest(t)), name


def test_writer_is_read_by_safetensors(tmp_path):
    # the port's writer gives files that safetensors.numpy reads back
    from safetensors.numpy import load_file

    gen = torch.Generator().manual_seed(1)
    t = {"a": torch.randn((3, 5), generator=gen), "b": torch.randn((7,), generator=gen).half(),
         "c": torch.randn((2, 2, 3), generator=gen).to(torch.bfloat16)}
    tloader.write_safetensors(str(tmp_path / "w.safetensors"), t)
    back = load_file(str(tmp_path / "w.safetensors"))
    np.testing.assert_array_equal(back["a"], t["a"].numpy())
    np.testing.assert_array_equal(back["b"], t["b"].numpy())
    assert back["c"].tobytes() == t["c"].view(torch.int16).numpy().tobytes()
    assert tloader.load_tensors(str(tmp_path))["c"].equal(t["c"])
