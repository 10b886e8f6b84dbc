"""The port's Llama configuration, RoPE, RMSNorm, grouped attention and
device rules against the JAX package on the CPU.

Tolerance for RoPE, RMSNorm and attention: one bf16 ulp of the largest
output (rtol 8e-3); they round f32 math to bf16, and the two frameworks
may order a reduction or evaluate a transcendental differently.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastforward_tpu.models import llama as jl
from fastforward_tpu.serving import engine as je
from fastforward_tpu_torch import resolve_device
from fastforward_tpu_torch.models import llama as tl
from fastforward_tpu_torch.serving import engine as te
from fastforward_tpu_torch.serving import stacked as ts

RTOL = 8e-3


def _close(a, b):
    a = np.asarray(jnp.asarray(a).astype(jnp.float32))
    b = b.float().numpy()
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= RTOL * max(np.abs(a).max(), 1e-6)


def _bf(x):
    return jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


@pytest.mark.parametrize("preset", ["llama3_8b", "llama32_1b", "llama3_70b", "tiny"])
def test_config_presets_match(preset):
    a = dataclasses.asdict(getattr(jl.LlamaConfig, preset)())
    b = dataclasses.asdict(getattr(tl.LlamaConfig, preset)())
    assert str(a.pop("dtype")).split(".")[-1].rstrip("'>") == str(b.pop("dtype")).split(".")[-1]
    assert a == b


@pytest.mark.parametrize("per_row", [False, True])
def test_rope_within_tolerance(per_row):
    cfg_j, cfg_t = jl.LlamaConfig.tiny(), tl.LlamaConfig.tiny()
    np.testing.assert_allclose(np.asarray(jl.rope_frequencies(cfg_j)),
                               tl.rope_frequencies(cfg_t).numpy(), rtol=1e-6)
    x = np.random.RandomState(0).randn(2, 4, 6, 16).astype(np.float32)
    pos = np.arange(6) + 5
    if per_row:
        pos = np.stack([pos, pos + 100])
    xj, xt = _bf(x)
    a = jax.jit(lambda x, p: jl.apply_rope(x, p, jl.rope_frequencies(cfg_j)))(xj, jnp.asarray(pos))
    b = tl.apply_rope(xt, torch.from_numpy(pos), tl.rope_frequencies(cfg_t))
    _close(a, b)


def test_rms_norm_within_tolerance():
    rs = np.random.RandomState(1)
    xj, xt = _bf((rs.randn(3, 5, 64) * 4).astype(np.float32))
    wj, wt = _bf((1 + 0.1 * rs.randn(64)).astype(np.float32))
    a = jax.jit(je._rms_norm, static_argnums=2)(xj, wj, 1e-5)
    b = te._rms_norm(xt, wt, 1e-5)
    assert b.dtype == torch.bfloat16
    _close(a, b)


@pytest.mark.parametrize("H,Hkv", [(4, 2), (4, 4)])
def test_attention_grouped_within_tolerance(H, Hkv):
    rs = np.random.RandomState(2)
    B, T, S, d = 2, 5, 9, 16
    qj, qt = _bf(rs.randn(B, H, T, d).astype(np.float32))
    kj, kt = _bf(rs.randn(B, Hkv, S, d).astype(np.float32))
    vj, vt = _bf(rs.randn(B, Hkv, S, d).astype(np.float32))
    pos = np.arange(T) + 4
    mask = np.where(np.arange(S)[None, None, None, :] <= pos[None, None, :, None], 0.0, -1e30)
    mask = mask.astype(np.float32)
    a = jax.jit(je._attention_grouped)(qj, kj, vj, jnp.asarray(mask))
    b = te._attention_grouped(qt, kt, vt, torch.from_numpy(mask))
    _close(a, b)


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    # GIVEN a host without CUDA
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    # THEN the default device raises, and the CPU is taken only when asked
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError):
        ts.random_stacked_params(tl.LlamaConfig.tiny(), "w4a4_2l", group_size=32)
    with pytest.raises(RuntimeError):
        ts.StackedKVCache.create(2, 1, 8, 2, 16)
    assert resolve_device("cpu") == torch.device("cpu")
    cache = ts.StackedKVCache.create(2, 1, 8, 2, 16, device="cpu")
    assert cache.k.device.type == "cpu" and cache.is_quantized and cache.max_len == 8
