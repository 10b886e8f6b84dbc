"""GPT-2 as `torch.nn.Module`s (`fastforward_tpu/models/gpt2.py`, the
repository's BASELINE config 2: W8A8 per-channel calibration target).

A decoder whose projections are all `torch.nn.Linear` (so `quantize_model`
converts the whole network and a W8A8 configuration sends each one through
the dispatcher onto row 19), attention through the quantizer-parameterized
`ops.scaled_dot_product_attention`, GELU through `ops.gelu` (tanh form), and
an LM head tied to the token embedding (``x @ wte^T``: no `Linear`, so it
never reaches row 19).

Norms are `torch.nn.LayerNorm`: on the CPU in f32 it is within a few f32
ulps of `nnx.LayerNorm` (XLA reduces the mean and mean of squares in its
own order; NNX's order of operations written out in torch is no closer).

Weights are in torch's layouts and come from a seeded `torch.Generator`, as
NNX initializes them: projections N(0, 1 / in) (the variance of LeCun
normal), zero biases, embeddings N(0, 1 / hidden), norms one and zero.
`nn.convert.load_nnx_params` carries an NNX model's weights in instead.
"""

import dataclasses
from typing import Optional

import torch

from fastforward_tpu_torch import ops
from fastforward_tpu_torch.models.llama import _linear, _placement
from fastforward_tpu_torch.nn.quantized_module import QuantizedModule
from fastforward_tpu_torch.nn.quantizer import QuantizerStub
from fastforward_tpu_torch.quantization.quantized_array import dequantize_if_quantized as _dq

__all__ = ["GPT2Config", "GPT2Attention", "QuantizedGPT2Attention", "GPT2Block", "GPT2LMHead"]


@dataclasses.dataclass
class GPT2Config:
    vocab_size: int = 50257
    max_position_embeddings: int = 1024
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: Optional[int] = None
    layer_norm_epsilon: float = 1e-5
    dtype: torch.dtype = torch.float32

    @property
    def ffn_dim(self) -> int:
        return self.intermediate_size or 4 * self.hidden_size

    @staticmethod
    def small() -> "GPT2Config":
        return GPT2Config()

    @staticmethod
    def tiny() -> "GPT2Config":
        return GPT2Config(
            vocab_size=256, max_position_embeddings=64, hidden_size=32,
            num_layers=2, num_heads=2,
        )


def _layer_norm(config: GPT2Config, dev) -> torch.nn.LayerNorm:
    return torch.nn.LayerNorm(config.hidden_size, eps=config.layer_norm_epsilon, device=dev,
                              dtype=config.dtype)


def _embedding(n: int, h: int, dtype, dev, gen) -> torch.nn.Embedding:
    emb = torch.nn.utils.skip_init(torch.nn.Embedding, n, h, device=dev, dtype=dtype)
    with torch.no_grad():
        emb.weight.copy_(torch.randn((n, h), generator=gen, device=dev) / h ** 0.5)
    return emb


class GPT2Attention(torch.nn.Module):
    def __init__(self, config: GPT2Config, device=None, generator=None):
        super().__init__()
        dev, gen = _placement(device, generator)
        h, dt = config.hidden_size, config.dtype
        self.num_heads = config.num_heads
        self.head_dim = h // config.num_heads
        self.c_attn = _linear(h, 3 * h, dt, dev, gen, bias=True)
        self.c_proj = _linear(h, h, dt, dev, gen, bias=True)

    def _sdpa_quantizers(self) -> dict:
        # Overridden by the quantized counterpart; read on every call so that
        # quantizer replacement (config rules, estimators) is always seen.
        return {}

    def forward(self, x, attn_mask=None):
        B, T, H = x.shape[0], x.shape[1], self.num_heads
        q, k, v = torch.split(_dq(self.c_attn(x)), x.shape[-1], dim=-1)

        def heads(t):
            return t.reshape(B, T, H, self.head_dim).transpose(1, 2)

        out = ops.scaled_dot_product_attention(
            heads(q), heads(k), heads(v), attn_mask=attn_mask, is_causal=True,
            strict_quantization=False, **self._sdpa_quantizers(),
        )
        out = out.transpose(1, 2).reshape(B, T, -1)
        return self.c_proj(out)


class QuantizedGPT2Attention(QuantizedModule, GPT2Attention):
    """Adds the SDPA intermediate quantizer slots (scores, weights) and an
    output slot."""

    def __init_quantization__(self):
        super().__init_quantization__()
        self.attn_scores_quantizer = QuantizerStub("activation/attn_scores")
        self.attn_weights_quantizer = QuantizerStub("activation/attn_weights")
        self.attn_output_quantizer = QuantizerStub(output_quantizer=True)

    def _sdpa_quantizers(self) -> dict:
        return dict(
            attn_scores_quantizer=self.attn_scores_quantizer,
            attn_weights_quantizer=self.attn_weights_quantizer,
        )


class GPT2Block(torch.nn.Module):
    def __init__(self, config: GPT2Config, device=None, generator=None):
        super().__init__()
        dev, gen = _placement(device, generator)
        h, dt = config.hidden_size, config.dtype
        self.ln_1 = _layer_norm(config, dev)
        self.attn = GPT2Attention(config, dev, gen)
        self.ln_2 = _layer_norm(config, dev)
        self.fc_in = _linear(h, config.ffn_dim, dt, dev, gen, bias=True)
        self.fc_out = _linear(config.ffn_dim, h, dt, dev, gen, bias=True)

    def forward(self, x, attn_mask=None):
        x = x + _dq(self.attn(_dq(self.ln_1(x)), attn_mask))
        h = _dq(self.fc_in(_dq(self.ln_2(x))))
        h = ops.gelu(h, approximate="tanh", strict_quantization=False)
        return x + _dq(self.fc_out(_dq(h)))


class GPT2LMHead(torch.nn.Module):
    """GPT-2 with an LM head tied to the token embedding, built on
    ``device`` (default: the GPU) from ``generator`` (default: a generator
    on that device seeded with 0)."""

    def __init__(self, config: GPT2Config, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev, gen = _placement(device, generator)
        self.config = config
        h, dt = config.hidden_size, config.dtype
        self.wte = _embedding(config.vocab_size, h, dt, dev, gen)
        self.wpe = _embedding(config.max_position_embeddings, h, dt, dev, gen)
        self.blocks = torch.nn.ModuleList(
            [GPT2Block(config, dev, gen) for _ in range(config.num_layers)])
        self.ln_f = _layer_norm(config, dev)

    def forward(self, input_ids, attn_mask=None):
        T = input_ids.shape[-1]
        pos = torch.arange(T, device=input_ids.device)
        x = _dq(self.wte(input_ids)) + _dq(self.wpe(pos))
        for block in self.blocks:
            x = block(x, attn_mask)
        x = _dq(self.ln_f(x))
        # tied LM head: logits = x @ wte^T
        return x @ _dq(self.wte.weight).T
