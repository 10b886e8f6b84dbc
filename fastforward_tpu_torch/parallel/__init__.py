"""Parallel serving of the port over `torch.distributed`
(`fastforward_tpu/parallel/`): device meshes, the multi-host (dcn, data,
model) mesh, Megatron tensor parallelism of the stacked forward (each rank
its shard, one all_reduce after o_proj and one after the MLP) and of the
per-layer forward as JAX's GSPMD placement computes it, ring attention
over a sequence-sharded dim, a GPipe pipeline over a stage dim, and the
multi-device dry run. Expert parallelism is `serving.moe.expert_parallel_moe`."""

from fastforward_tpu_torch.parallel.context import context_parallel_attention, ring_attention
from fastforward_tpu_torch.parallel.dryrun import dryrun_multichip
from fastforward_tpu_torch.parallel.mesh import make_mesh
from fastforward_tpu_torch.parallel.multihost import (
    host_local_batch_slice,
    initialize_distributed,
    make_hybrid_mesh,
)
from fastforward_tpu_torch.parallel.pipeline import pipeline_forward, pipeline_stage_loop
from fastforward_tpu_torch.parallel.sharding import (
    batch_axes,
    serving_param_spec,
    shard_kv_cache,
    shard_serving_params,
    sharded_serving_forward,
)
from fastforward_tpu_torch.parallel.tp_serving import (
    make_tp_decode_loop,
    make_tp_decode_step,
    shard_for_tp,
)

__all__ = [
    "batch_axes",
    "context_parallel_attention",
    "dryrun_multichip",
    "host_local_batch_slice",
    "initialize_distributed",
    "make_hybrid_mesh",
    "make_mesh",
    "make_tp_decode_loop",
    "make_tp_decode_step",
    "pipeline_forward",
    "pipeline_stage_loop",
    "ring_attention",
    "serving_param_spec",
    "shard_for_tp",
    "shard_kv_cache",
    "shard_serving_params",
    "sharded_serving_forward",
]
