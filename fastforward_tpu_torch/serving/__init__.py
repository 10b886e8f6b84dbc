"""Serving path of the port: frozen two-level int4 weights, the stacked
forward over an INT8 KV cache (slab or paged pool), greedy and sampled
decoding, and the continuous-batching engine."""

from fastforward_tpu_torch.serving.batching import (
    ContinuousBatchingEngine,
    EngineStats,
    Request,
)
from fastforward_tpu_torch.serving.paged import PageAllocator, PagedKVCache
from fastforward_tpu_torch.serving.sampling import SamplingParams
from fastforward_tpu_torch.serving.stacked import (
    StackedKVCache,
    fuse_stacked_layers,
    make_stacked_decode_loop,
    random_stacked_params,
    serving_forward_stacked,
)

__all__ = [
    "ContinuousBatchingEngine",
    "EngineStats",
    "PageAllocator",
    "PagedKVCache",
    "Request",
    "SamplingParams",
    "StackedKVCache",
    "fuse_stacked_layers",
    "make_stacked_decode_loop",
    "random_stacked_params",
    "serving_forward_stacked",
]
