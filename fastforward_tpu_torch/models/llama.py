"""Llama-family models as `torch.nn.Module`s (`fastforward_tpu/models/llama.py`).

The configuration and RoPE, and the decoder: `LlamaAttention` (GQA by
repeating the K/V heads, RoPE, `ops.scaled_dot_product_attention`, an
optional per-layer `serving.kv_cache.LayerKVCache`), its quantized
counterpart `QuantizedLlamaAttention` (SDPA intermediate and KV-cache
quantizer slots), `LlamaMLP`, `LlamaBlock`, `LlamaForCausalLM`, and
`RMSNorm` in NNX's order of operations.

Every projection's output passes through ``_dq`` (dequantized where a
quantizer made it a `QuantizedTensor`), as in the JAX model, so the same
module runs unconverted, converted with `nn.quantize_model` (stubs), or
configured. Weights are in torch's layouts ((out, in) projections) and
come from a seeded `torch.Generator`: projections N(0, 1 / in) (the
variance of NNX's default LeCun normal), the embedding N(0, 1), norms one.
`nn.convert.load_nnx_params` carries an NNX model's weights in instead.
"""

import dataclasses
from typing import Optional

import torch

from fastforward_tpu_torch import ops
from fastforward_tpu_torch.device import resolve_device
from fastforward_tpu_torch.kernels.matmul import _rms_inverse
from fastforward_tpu_torch.nn.layers import QuantizedRMSNorm
from fastforward_tpu_torch.nn.quantized_module import QuantizedModule, register_quantized_module
from fastforward_tpu_torch.nn.quantizer import QuantizerStub
from fastforward_tpu_torch.quantization.quantized_array import dequantize_if_quantized as _dq


@dataclasses.dataclass
class LlamaConfig:
    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    rope_theta: float = 500000.0
    rms_norm_eps: float = 1e-5
    max_seq_len: int = 8192
    tie_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def llama3_8b() -> "LlamaConfig":
        return LlamaConfig()

    @staticmethod
    def llama32_1b() -> "LlamaConfig":
        return LlamaConfig(
            hidden_size=2048, intermediate_size=8192, num_layers=16,
            num_heads=32, num_kv_heads=8, head_dim=64, tie_embeddings=True,
        )

    @staticmethod
    def llama3_70b() -> "LlamaConfig":
        return LlamaConfig(
            hidden_size=8192, intermediate_size=28672, num_layers=80,
            num_heads=64, num_kv_heads=8,
        )

    @staticmethod
    def tiny() -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=2,
            num_heads=4, num_kv_heads=2, head_dim=16, max_seq_len=128,
            dtype=torch.float32,
        )


def rope_frequencies(config: LlamaConfig, device=None) -> torch.Tensor:
    """Inverse frequencies (head_dim/2,) f32."""
    dim = config.head_dim
    exponent = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / (config.rope_theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, inv_freq: torch.Tensor) -> torch.Tensor:
    """Rotate ``x`` (B, H, T, D) by position-dependent angles (rotate-half
    convention). ``positions``: (B, T) or (T,)."""
    if positions.dim() == 1:
        positions = positions[None, :]
    angles = positions[:, None, :, None].float() * inv_freq  # (B, 1, T, D/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --- modules -------------------------------------------------------------------


def _linear(k: int, n: int, dtype, dev, gen, bias: bool = False) -> torch.nn.Linear:
    """An (n, k) `torch.nn.Linear` with N(0, 1 / k) weights from ``gen``
    (zero bias), made without torch's own initialization."""
    lin = torch.nn.utils.skip_init(torch.nn.Linear, k, n, bias=bias, device=dev, dtype=dtype)
    with torch.no_grad():
        lin.weight.copy_(torch.randn((n, k), generator=gen, device=dev) / k ** 0.5)
        if bias:
            lin.bias.zero_()
    return lin


class RMSNorm(torch.nn.RMSNorm):
    """`torch.nn.RMSNorm` computing `nnx.RMSNorm`'s operations
    (`flax/nnx/nn/normalization.py` `_compute_stats`, `_normalize`): the mean
    of squares in f32 (the sum in XLA's CPU order times f32(1/n)) and its
    rsqrt rounded correctly (`_rms_inverse`), times the weight in f32, then
    the input times that, rounded once to the promoted dtype. torch's own
    rounds x * rsqrt(.) first and multiplies by the weight after. Converted
    by `quantize_model` to `nn.QuantizedRMSNorm`, as NNX's to JAX's."""

    def forward(self, x):
        eps = self.eps if self.eps is not None else torch.finfo(x.dtype).eps
        xf = x.float()
        out = xf * (_rms_inverse(xf, eps)[..., None] * self.weight.float())
        return out.to(torch.promote_types(x.dtype, self.weight.dtype))


register_quantized_module(RMSNorm, QuantizedRMSNorm)


def _rms_norm(config: LlamaConfig, dev) -> RMSNorm:
    return RMSNorm(config.hidden_size, eps=config.rms_norm_eps, device=dev, dtype=config.dtype)


class LlamaAttention(torch.nn.Module):
    def __init__(self, config: LlamaConfig, device=None, generator=None):
        super().__init__()
        dev, gen = _placement(device, generator)
        h, d, dt = config.hidden_size, config.head_dim, config.dtype
        self.num_heads = config.num_heads
        self.num_kv_heads = config.num_kv_heads
        self.head_dim = d
        self.q_proj = _linear(h, config.num_heads * d, dt, dev, gen)
        self.k_proj = _linear(h, config.num_kv_heads * d, dt, dev, gen)
        self.v_proj = _linear(h, config.num_kv_heads * d, dt, dev, gen)
        self.o_proj = _linear(config.num_heads * d, h, dt, dev, gen)
        self.register_buffer("_inv_freq", rope_frequencies(config, device=dev), persistent=False)

    def _sdpa_quantizers(self) -> dict:
        # Overridden by the quantized counterpart; read on every call so that
        # quantizer replacement (config rules, estimators) is always seen.
        return {}

    @property
    def kv_quantizer(self):
        return getattr(self, "kv_cache_quantizer", None)

    def _split(self, t: torch.Tensor, n: int) -> torch.Tensor:
        B, T = t.shape[0], t.shape[1]
        return t.reshape(B, T, n, self.head_dim).transpose(1, 2)

    def forward(self, x, positions, layer_cache=None, mask=None):
        """Returns (out, new_layer_cache). ``layer_cache`` is a
        `serving.kv_cache.LayerKVCache` or None (full self-attention)."""
        q = self._split(_dq(self.q_proj(x)), self.num_heads)
        k = self._split(_dq(self.k_proj(x)), self.num_kv_heads)
        v = self._split(_dq(self.v_proj(x)), self.num_kv_heads)

        q = apply_rope(q, positions, self._inv_freq)
        k = apply_rope(k, positions, self._inv_freq)

        if layer_cache is not None:
            layer_cache = layer_cache.append(k, v, positions, quantizer=self.kv_quantizer)
            # the cache's dtype (bf16 for an int8 cache) promoted to the
            # query's, as jnp's products promote
            k, v = (t.to(q.dtype) for t in layer_cache.read())
            attn_mask = layer_cache.attention_mask(positions, mask)
            is_causal = False
        else:
            attn_mask = mask
            is_causal = mask is None

        # GQA: expand kv heads to query heads.
        groups = self.num_heads // self.num_kv_heads
        if groups > 1:
            k = torch.repeat_interleave(k, groups, dim=1)
            v = torch.repeat_interleave(v, groups, dim=1)

        out = ops.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, is_causal=is_causal,
            strict_quantization=False, **self._sdpa_quantizers(),
        )
        B, T = x.shape[0], x.shape[1]
        out = out.transpose(1, 2).reshape(B, T, -1)
        return _dq(self.o_proj(out)), layer_cache


class QuantizedLlamaAttention(QuantizedModule, LlamaAttention):
    """Adds SDPA intermediate quantizer slots and the KV-cache quantizer slot."""

    def __init_quantization__(self):
        super().__init_quantization__()
        self.attn_scores_quantizer = QuantizerStub("activation/attn_scores")
        self.attn_weights_quantizer = QuantizerStub("activation/attn_weights")
        self.kv_cache_quantizer = QuantizerStub("activation/kv_cache")

    def _sdpa_quantizers(self) -> dict:
        return dict(
            attn_scores_quantizer=self.attn_scores_quantizer,
            attn_weights_quantizer=self.attn_weights_quantizer,
        )


class LlamaMLP(torch.nn.Module):
    def __init__(self, config: LlamaConfig, device=None, generator=None):
        super().__init__()
        dev, gen = _placement(device, generator)
        h, inter, dt = config.hidden_size, config.intermediate_size, config.dtype
        self.gate_proj = _linear(h, inter, dt, dev, gen)
        self.up_proj = _linear(h, inter, dt, dev, gen)
        self.down_proj = _linear(inter, h, dt, dev, gen)

    def forward(self, x):
        gate = ops.silu(_dq(self.gate_proj(x)), strict_quantization=False)
        h = _dq(gate) * _dq(self.up_proj(x))
        return _dq(self.down_proj(h))


class LlamaBlock(torch.nn.Module):
    def __init__(self, config: LlamaConfig, device=None, generator=None):
        super().__init__()
        dev, gen = _placement(device, generator)
        self.input_layernorm = _rms_norm(config, dev)
        self.self_attn = LlamaAttention(config, dev, gen)
        self.post_attention_layernorm = _rms_norm(config, dev)
        self.mlp = LlamaMLP(config, dev, gen)

    def forward(self, x, positions, layer_cache=None, mask=None):
        attn_out, layer_cache = self.self_attn(
            _dq(self.input_layernorm(x)), positions, layer_cache, mask
        )
        x = x + attn_out
        x = x + self.mlp(_dq(self.post_attention_layernorm(x)))
        return x, layer_cache


class LlamaForCausalLM(torch.nn.Module):
    """The decoder with its embedding, final norm and lm_head (none with
    tied embeddings), built on ``device`` (default: the GPU) from
    ``generator`` (default: a generator on that device seeded with 0)."""

    def __init__(self, config: LlamaConfig, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev, gen = _placement(device, generator)
        self.config = config
        self.embed_tokens = torch.nn.utils.skip_init(
            torch.nn.Embedding, config.vocab_size, config.hidden_size, device=dev,
            dtype=config.dtype)
        with torch.no_grad():
            self.embed_tokens.weight.copy_(
                torch.randn((config.vocab_size, config.hidden_size), generator=gen, device=dev))
        self.layers = torch.nn.ModuleList(
            [LlamaBlock(config, dev, gen) for _ in range(config.num_layers)])
        self.norm = _rms_norm(config, dev)
        if config.tie_embeddings:
            self.lm_head = None
        else:
            self.lm_head = _linear(config.hidden_size, config.vocab_size, config.dtype, dev, gen)

    def forward(self, input_ids, positions=None, cache=None, mask=None):
        """Returns (logits, new_cache). ``cache`` is a `serving.KVCache` or None."""
        T = input_ids.shape[-1]
        if positions is None:
            positions = torch.arange(T, device=input_ids.device)
            if cache is not None:
                positions = positions + cache.length
        x = _dq(self.embed_tokens(input_ids))

        new_layers = []
        for i, block in enumerate(self.layers):
            layer_cache = None if cache is None else cache.layer(i)
            x, layer_cache = block(x, positions, layer_cache, mask)
            new_layers.append(layer_cache)

        x = _dq(self.norm(x))
        if self.lm_head is not None:
            logits = _dq(self.lm_head(x))
        else:
            logits = x @ _dq(self.embed_tokens.weight).T

        if cache is not None:
            cache = cache.with_layers(new_layers, advance=T)
        return logits, cache


def _placement(device, generator):
    """(device, generator): the device resolved (None: the GPU) and a
    generator on it, seeded with 0 unless one is given; raises when the
    given generator lies on another device."""
    dev = resolve_device(device)
    if generator is None:
        return dev, torch.Generator(device=dev).manual_seed(0)
    gdev = generator.device
    if gdev.type != dev.type or (dev.index is not None and gdev.index not in (None, dev.index)):
        raise ValueError(f"the generator lies on {gdev}, the module is built on {dev}")
    return dev, generator
