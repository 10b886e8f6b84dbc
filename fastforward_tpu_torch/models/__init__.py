from fastforward_tpu_torch.models.gpt2 import (
    GPT2Attention,
    GPT2Block,
    GPT2Config,
    GPT2LMHead,
    QuantizedGPT2Attention,
)
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
    "GPT2Config",
    "GPT2LMHead",
    "GPT2Block",
    "GPT2Attention",
    "QuantizedGPT2Attention",
    "LlamaConfig",
    "LlamaForCausalLM",
    "LlamaBlock",
    "LlamaAttention",
    "LlamaMLP",
    "QuantizedLlamaAttention",
    "apply_rope",
    "rope_frequencies",
]
