"""Serving path of the port: frozen quantized weights (two-level int4,
W8A8, W4A8, W4A16), the per-layer forward over a bf16 or INT8 `KVCache`
and its greedy decode loop, the checkpoint loader, the stacked forward over
a bf16 or INT8 KV cache (slab or paged pool) with its fused, flat or
pre-blocked layers (`fuse_stacked_layers`, `unfuse_stacked_layers`),
greedy and sampled decoding, the continuous-batching engine, the
quantized MoE block (`serving.moe`), and `freeze_llama`, the bridge from
a simulation-tier `models.LlamaForCausalLM` to frozen serving params."""

from fastforward_tpu_torch.serving.batching import (
    ContinuousBatchingEngine,
    EngineStats,
    Request,
)
from fastforward_tpu_torch.serving.engine import (
    freeze_llama,
    make_decode_loop,
    random_serving_params,
    repack_unpaired,
    serving_forward,
)
from fastforward_tpu_torch.serving.kv_cache import KVCache, LayerKVCache
from fastforward_tpu_torch.serving.loader import load_llama
from fastforward_tpu_torch.serving.paged import PageAllocator, PagedKVCache
from fastforward_tpu_torch.serving.sampling import SamplingParams
from fastforward_tpu_torch.serving.stacked import (
    StackedKVCache,
    fuse_stacked_layers,
    make_stacked_decode_loop,
    random_stacked_params,
    serving_forward_stacked,
    stack_serving_layers,
    unfuse_stacked_layers,
)

__all__ = [
    "ContinuousBatchingEngine",
    "EngineStats",
    "KVCache",
    "LayerKVCache",
    "PageAllocator",
    "PagedKVCache",
    "Request",
    "SamplingParams",
    "StackedKVCache",
    "freeze_llama",
    "fuse_stacked_layers",
    "load_llama",
    "make_decode_loop",
    "make_stacked_decode_loop",
    "random_serving_params",
    "random_stacked_params",
    "repack_unpaired",
    "serving_forward",
    "serving_forward_stacked",
    "stack_serving_layers",
    "unfuse_stacked_layers",
]
