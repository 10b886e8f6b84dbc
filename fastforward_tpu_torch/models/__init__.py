from fastforward_tpu_torch.models.llama import (
    LlamaAttention,
    LlamaBlock,
    LlamaConfig,
    LlamaForCausalLM,
    LlamaMLP,
    QuantizedLlamaAttention,
    apply_rope,
    rope_frequencies,
)
from fastforward_tpu_torch.models.mlp import MLP

__all__ = [
    "MLP",
    "LlamaConfig",
    "LlamaForCausalLM",
    "LlamaBlock",
    "LlamaAttention",
    "LlamaMLP",
    "QuantizedLlamaAttention",
    "apply_rope",
    "rope_frequencies",
]
