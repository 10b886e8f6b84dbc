"""HF-checkpoint golden-reference fixtures for real-weights tests
(`fastforward_tpu/testing/hf_golden.py`).

No real checkpoint is in the repository, so a checkpoint is fabricated in
the genuine HF on-disk format with ``save_pretrained``, the HF torch
implementation's fp32 logits serve as golden, and the eval set is sampled
from the model itself (low-perplexity data for that model, so
quantization-induced perplexity deltas are meaningful). The fabricating
functions import ``transformers`` inside their bodies; the port's models
are built from the HF tensors by `llama_from_tensors` and `gpt2_from_hf`.
"""

import dataclasses

import numpy as np
import torch

from fastforward_tpu_torch.device import resolve_device

LLAMA_DIMS = {
    "tiny": dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                 num_attention_heads=4, num_key_value_heads=2,
                 vocab_size=256),
    "small": dict(hidden_size=256, intermediate_size=768,
                  num_hidden_layers=4, num_attention_heads=8,
                  num_key_value_heads=4, vocab_size=2048),
}

GPT2_DIMS = {
    # GPT-2's architecture at test scale (BASELINE config 2 names GPT-2-small)
    "tiny": dict(n_embd=96, n_layer=2, n_head=4, vocab_size=512,
                 n_positions=128),
    "small": dict(n_embd=192, n_layer=4, n_head=8, vocab_size=1024,
                  n_positions=256),
}


def fabricate_hf_checkpoint(out_dir: str, size: str = "small"):
    """Create a real-format HF Llama checkpoint; returns (torch_model, cfg)
    (JAX: `fabricate_hf_checkpoint`)."""
    from transformers import LlamaConfig as HFLlamaConfig
    from transformers import LlamaForCausalLM as HFLlama

    hf_cfg = HFLlamaConfig(
        **LLAMA_DIMS[size], max_position_embeddings=512, rms_norm_eps=1e-5,
        rope_theta=500000.0, tie_word_embeddings=False,
        attention_bias=False, mlp_bias=False,
    )
    torch.manual_seed(0)
    model = HFLlama(hf_cfg)
    model.eval()
    # scale the output projection up so that the logits have a usable range
    # (the default init gives near-uniform logits on random data)
    with torch.no_grad():
        model.lm_head.weight.mul_(3.0)
    model.save_pretrained(out_dir, safe_serialization=True)
    return model, hf_cfg


def fabricate_gpt2_model(size: str = "tiny"):
    """Random-init HF GPT-2 (torch, fp32, eval mode); returns (model, cfg)
    (JAX: `fabricate_gpt2_model`)."""
    from transformers import GPT2Config as HFGPT2Config
    from transformers import GPT2LMHeadModel

    hf_cfg = HFGPT2Config(
        **GPT2_DIMS[size], resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0,
    )
    torch.manual_seed(0)
    model = GPT2LMHeadModel(hf_cfg)
    model.eval()
    with torch.no_grad():
        model.lm_head.weight.mul_(3.0)
    return model, hf_cfg


def our_config(hf_cfg):
    """The port's `LlamaConfig` of an HF Llama config (JAX: `our_config`)."""
    from fastforward_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig(
        vocab_size=hf_cfg.vocab_size,
        hidden_size=hf_cfg.hidden_size,
        intermediate_size=hf_cfg.intermediate_size,
        num_layers=hf_cfg.num_hidden_layers,
        num_heads=hf_cfg.num_attention_heads,
        num_kv_heads=hf_cfg.num_key_value_heads,
        head_dim=hf_cfg.hidden_size // hf_cfg.num_attention_heads,
        rope_theta=hf_cfg.rope_theta,
        rms_norm_eps=hf_cfg.rms_norm_eps,
        max_seq_len=hf_cfg.max_position_embeddings,
        tie_embeddings=bool(hf_cfg.tie_word_embeddings),
    )


def our_gpt2_config(hf_cfg):
    """The port's `GPT2Config` (float32) of an HF GPT-2 config (JAX:
    `our_gpt2_config`)."""
    from fastforward_tpu_torch.models.gpt2 import GPT2Config

    return GPT2Config(
        vocab_size=hf_cfg.vocab_size,
        max_position_embeddings=hf_cfg.n_positions,
        hidden_size=hf_cfg.n_embd,
        num_layers=hf_cfg.n_layer,
        num_heads=hf_cfg.n_head,
        layer_norm_epsilon=hf_cfg.layer_norm_epsilon,
        dtype=torch.float32,
    )


def torch_logits(model, ids: np.ndarray) -> np.ndarray:
    """An HF model's float32 logits of ``ids`` (JAX: `torch_logits`)."""
    with torch.no_grad():
        return model(torch.from_numpy(ids)).logits.float().numpy()


def sample_eval_set(model, vocab: int, n_seqs: int, seq_len: int,
                    seed: int = 1) -> np.ndarray:
    """Sequences sampled from the HF model: its own 'natural language',
    low-perplexity for it (JAX: `sample_eval_set`)."""
    torch.manual_seed(seed)
    prompts = torch.randint(0, vocab, (n_seqs, 4))
    with torch.no_grad():
        out = model.generate(
            prompts, max_new_tokens=seq_len - 4, do_sample=True,
            temperature=0.9, top_k=50, pad_token_id=0,
        )
    return out.numpy()


def ppl_torch(model, ids: np.ndarray) -> float:
    """An HF model's perplexity over ``ids`` (JAX: `ppl_torch`)."""
    import torch.nn.functional as F

    with torch.no_grad():
        logits = model(torch.from_numpy(ids)).logits.float()
    lp = F.log_softmax(logits[:, :-1], dim=-1)
    tgt = torch.from_numpy(ids[:, 1:])
    nll = -lp.gather(-1, tgt.unsqueeze(-1)).squeeze(-1)
    return float(nll.mean().exp())


def _f32(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.detach().float()
    return torch.from_numpy(np.asarray(value, np.float32))


def llama_from_tensors(tensors, config, device=None):
    """The port's float32 `LlamaForCausalLM` on ``device`` (default: the
    GPU) holding HF Llama tensors (name → tensor or array; a ``model.``
    prefix optional). torch's Linear layout is HF's, so no weight is
    transposed (JAX: `nnx_model_from_tensors`)."""
    from fastforward_tpu_torch.models.llama import LlamaForCausalLM

    dev = resolve_device(device)
    model = LlamaForCausalLM(dataclasses.replace(config, dtype=torch.float32), device=dev)

    def t(name):
        key = f"model.{name}" if f"model.{name}" in tensors else name
        return _f32(tensors[key])

    names = {model.embed_tokens.weight: "embed_tokens.weight", model.norm.weight: "norm.weight"}
    if model.lm_head is not None:
        names[model.lm_head.weight] = "lm_head.weight"
    for i, block in enumerate(model.layers):
        p = f"layers.{i}."
        names[block.input_layernorm.weight] = p + "input_layernorm.weight"
        names[block.post_attention_layernorm.weight] = p + "post_attention_layernorm.weight"
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
            names[getattr(block.self_attn, proj).weight] = f"{p}self_attn.{proj}.weight"
        for proj in ("gate_proj", "up_proj", "down_proj"):
            names[getattr(block.mlp, proj).weight] = f"{p}mlp.{proj}.weight"
    with torch.no_grad():
        for param, name in names.items():
            param.copy_(t(name))
    return model


def gpt2_from_hf(torch_model, config, device=None):
    """The port's `GPT2LMHead` on ``device`` (default: the GPU) holding an
    HF GPT-2's weights. HF stores its projections as `Conv1D` (in, out);
    torch's Linear is (out, in), so those are transposed (JAX:
    `nnx_gpt2_from_hf`)."""
    from fastforward_tpu_torch.models.gpt2 import GPT2LMHead

    dev = resolve_device(device)
    sd = {k: v.detach().float() for k, v in torch_model.state_dict().items()}
    model = GPT2LMHead(config, device=dev)
    names = {model.wte.weight: "transformer.wte.weight", model.wpe.weight: "transformer.wpe.weight",
             model.ln_f.weight: "transformer.ln_f.weight", model.ln_f.bias: "transformer.ln_f.bias"}
    conv1d = set()
    for i, block in enumerate(model.blocks):
        p = f"transformer.h.{i}."
        for ours, theirs in ((block.ln_1, "ln_1"), (block.ln_2, "ln_2")):
            names[ours.weight] = p + theirs + ".weight"
            names[ours.bias] = p + theirs + ".bias"
        for ours, theirs in ((block.attn.c_attn, "attn.c_attn"), (block.attn.c_proj, "attn.c_proj"),
                             (block.fc_in, "mlp.c_fc"), (block.fc_out, "mlp.c_proj")):
            names[ours.weight] = p + theirs + ".weight"
            names[ours.bias] = p + theirs + ".bias"
            conv1d.add(ours.weight)
    with torch.no_grad():
        for param, name in names.items():
            value = sd[name]
            param.copy_(value.t() if param in conv1d else value)
    return model


def ppl(forward, ids: np.ndarray, device=None) -> float:
    """Perplexity of a logits-returning callable over token ids, the ids on
    ``device`` (default: the GPU) (JAX: `ppl_jax`)."""
    from fastforward_tpu_torch.utils.evaluation import evaluate_perplexity

    return float(evaluate_perplexity(forward, [torch.as_tensor(ids, device=resolve_device(device))]))
