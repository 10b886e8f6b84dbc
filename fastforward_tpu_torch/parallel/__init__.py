"""Parallel serving of the port over `torch.distributed`
(`fastforward_tpu/parallel/`): device meshes, the multi-host (dcn, data,
model) mesh, Megatron tensor parallelism of the stacked forward (each rank
its shard, one all_reduce after o_proj and one after the MLP) and of the
per-layer forward as JAX's GSPMD placement computes it. Expert
parallelism is `serving.moe.expert_parallel_moe`."""

from fastforward_tpu_torch.parallel.mesh import make_mesh
from fastforward_tpu_torch.parallel.multihost import (
    host_local_batch_slice,
    initialize_distributed,
    make_hybrid_mesh,
)
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
    "host_local_batch_slice",
    "initialize_distributed",
    "make_hybrid_mesh",
    "make_mesh",
    "make_tp_decode_loop",
    "make_tp_decode_step",
    "serving_param_spec",
    "shard_for_tp",
    "shard_kv_cache",
    "shard_serving_params",
    "sharded_serving_forward",
]
