"""Serving path of the port: frozen two-level int4 weights, the stacked
forward over an INT8 KV cache, and greedy decoding."""

from fastforward_tpu_torch.serving.stacked import (
    StackedKVCache,
    fuse_stacked_layers,
    make_stacked_decode_loop,
    random_stacked_params,
    serving_forward_stacked,
)

__all__ = [
    "StackedKVCache",
    "fuse_stacked_layers",
    "make_stacked_decode_loop",
    "random_stacked_params",
    "serving_forward_stacked",
]
