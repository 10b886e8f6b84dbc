"""The port's loader and per-layer forward on a fabricated HF Llama checkpoint.

`fabricate_hf_checkpoint` (`fastforward_tpu/testing/hf_golden.py:39`)
builds a random HF Llama ("tiny": hidden 64, 2 layers, 4 heads of 16, 2 kv
heads, vocab 256) with the `transformers` package and writes it with
``save_pretrained`` (config.json and model.safetensors); nothing is
downloaded. It is built once for the module, and `our_config` (`:78`) is
mapped field by field onto the port's `LlamaConfig`.

Held, in w8a8, w4a8 and w4a16 (groups of 32: the tiny widths are 64 and
128):
- the port's `load_llama` (``device="cpu"``) gives the JAX `load_llama`'s
  bytes on the same files;
- the port's `serving_forward` logits (no cache, 2 prompts of 8 tokens)
  are within the relative RMS error of `tests/test_torch_serving_forward.py`
  (`LOGITS_RMS`) of JAX's `serving_forward` (jitted, its TPU routing with
  the float-scale shims);
- both are within a relative RMS error of HF's own fp32 logits
  (`torch_logits`, `:112`), stated per mode in `HF_RMS`: the port's first
  check against a real model implementation. The error is the quantizer's
  (weights, int8 activations, bf16 storage), not the forward's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastforward_tpu.serving import engine as je
from fastforward_tpu.serving import loader as jloader
from fastforward_tpu.testing.hf_golden import fabricate_hf_checkpoint, our_config, torch_logits
from fastforward_tpu_torch.models.llama import LlamaConfig as TConfig
from fastforward_tpu_torch.serving import engine as te
from fastforward_tpu_torch.serving import loader as tloader
from fastforward_tpu_torch.serving.convert import params_to_flat
from tests.test_torch_quant_modes import _jax_w4a8_tpu, _jax_w4a16_tpu
from tests.test_torch_serving_forward import EXACT, LOGITS_RMS, _rel_rms, jax_params_to_flat

MODES = ["w8a8", "w4a8", "w4a16"]
GROUP = 32
# Relative RMS error against HF's fp32 logits, per mode (measured on the
# CPU, both packages: w8a8 0.0147, w4a8 0.173, w4a16 0.174); the bound is
# about 1.5 times the measured error
HF_RMS = {"w8a8": 0.025, "w4a8": 0.26, "w4a16": 0.26}


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    path = tmp_path_factory.mktemp("hf_tiny")
    model, hf_cfg = fabricate_hf_checkpoint(str(path), "tiny")
    jc = our_config(hf_cfg)
    tc = TConfig(**{f.name: getattr(jc, f.name) for f in dataclasses.fields(TConfig)
                    if f.name != "dtype"})
    ids = np.random.RandomState(0).randint(0, hf_cfg.vocab_size, (2, 8))
    return str(path), jc, tc, ids, torch_logits(model, ids)


@pytest.fixture
def tpu_route(monkeypatch):
    monkeypatch.setattr(je, "_on_tpu", lambda: True)
    monkeypatch.setattr(je, "matmul_w4a8", _jax_w4a8_tpu)
    monkeypatch.setattr(je, "matmul_w4a16", _jax_w4a16_tpu)


def test_config_maps_onto_the_port():
    # GIVEN the tiny HF dims WHEN mapped THEN the port's config holds them
    from transformers import LlamaConfig as HFConfig

    from fastforward_tpu.testing.hf_golden import LLAMA_DIMS

    hf = HFConfig(**LLAMA_DIMS["tiny"], max_position_embeddings=512, rope_theta=500000.0)
    jc = our_config(hf)
    tc = TConfig(**{f.name: getattr(jc, f.name) for f in dataclasses.fields(TConfig)
                    if f.name != "dtype"})
    assert (tc.hidden_size, tc.num_layers, tc.num_heads, tc.num_kv_heads, tc.head_dim,
            tc.vocab_size, tc.tie_embeddings) == (64, 2, 4, 2, 16, 256, False)
    assert tc.dtype == torch.bfloat16 and jc.dtype == jnp.bfloat16


@pytest.mark.parametrize("mode", MODES)
def test_hf_checkpoint_loads_and_serves_as_jax_and_hf(checkpoint, tpu_route, mode):
    path, jc, tc, ids, hf = checkpoint
    # GIVEN the fabricated checkpoint WHEN both loaders read it
    jp = jloader.load_llama(path, jc, mode=mode, group_size=GROUP)
    tp = tloader.load_llama(path, tc, mode=mode, group_size=GROUP, device="cpu")
    # THEN every carried array is byte-equal
    a, b = jax_params_to_flat(jp), params_to_flat(tp)
    assert set(a) == set(b)
    for key in a:
        assert np.ascontiguousarray(a[key]).tobytes() == np.ascontiguousarray(b[key]).tobytes(), key
    # WHEN both serve 2 prompts of 8 tokens without a cache
    jl = jax.jit(lambda p, i: je.serving_forward(p, jc, i)[0]).lower(
        jp, jnp.asarray(ids)).compile(compiler_options=EXACT)(jp, jnp.asarray(ids))
    tl, _ = te.serving_forward(tp, tc, torch.from_numpy(ids))
    jl, tl = np.asarray(jl, np.float32), tl.float().numpy()
    assert tl.shape == jl.shape == hf.shape == (2, 8, tc.vocab_size)
    # THEN the port is within the mode's RMS error of JAX, and both within
    # the stated error of HF's fp32 logits
    assert _rel_rms(jl, tl) <= LOGITS_RMS[mode]
    assert _rel_rms(hf, tl) <= HF_RMS[mode]
    assert _rel_rms(hf, jl) <= HF_RMS[mode]
