"""Shared helpers, ported from `fastforward_tpu/utils/`: tensor coercion
and qualified names (`common`), dataclass and logging helpers, the asset
cache, `sqnr`, YAML serialization of granularities, the quantization-state
and params checkpoints, perplexity evaluation and profiling."""
