from fastforward_tpu_torch.models.llama import LlamaConfig, apply_rope, rope_frequencies

__all__ = ["LlamaConfig", "apply_rope", "rope_frequencies"]
