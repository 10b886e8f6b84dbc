"""Llama configuration and RoPE, ported from `fastforward_tpu/models/llama.py:27-90`.

The module classes of the JAX package wait for a later slice; serving
needs only the configuration and the rotary embedding.
"""

import dataclasses

import torch


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
