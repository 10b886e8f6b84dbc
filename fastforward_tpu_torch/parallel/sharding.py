"""Tensor-parallel sharding of the per-layer serving params
(`fastforward_tpu/parallel/sharding.py`).

The JAX package places the per-layer `ServingParams` and `KVCache` on a
mesh for GSPMD, which then computes the single-device function over the
shards: Megatron TP over the ``model`` axis (column-parallel
q/k/v/gate/up, row-parallel o/down, the lm_head column-parallel), the KV
cache over kv heads, the batch over the data axes. Here a rank cuts its
shard of those tensors (`shard_serving_params`, `shard_kv_cache`), and
`sharded_serving_forward` runs the per-layer forward on it so that it
computes that same function: a row-parallel projection quantizes each
activation row by the whole row's amax (an ``all_reduce`` MAX over the
``model`` group) and sums the f32 partial products before the output's one
rounding; the lm_head's logits are gathered over the group.

Scales shard with their blocks (`sharding.py:24`): per-column w8 scales
replicate under a row split; per-group w4 scales (and two-level
multipliers) split with K under a row split, with N under a column split.
"""

import dataclasses

from fastforward_tpu_torch.parallel.mesh import shard_tree, take_shard
from fastforward_tpu_torch.serving.engine import (
    QuantLinear,
    ServingLayer,
    ServingParams,
    repack_unpaired,
    serving_forward,
)
from fastforward_tpu_torch.serving.kv_cache import KVCache, LayerKVCache

__all__ = ["ql_spec", "fit_row_parallel", "serving_param_spec", "shard_serving_params", "batch_axes", "shard_kv_cache",
           "sharded_serving_forward"]

_COL = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")


def ql_spec(ql: QuantLinear, col_parallel: bool, lead: tuple = ()) -> QuantLinear:
    """The spec of a `QuantLinear`'s tensors (`sharding.py:24`, and
    `tp_serving.py:28` with ``lead`` (None,) for the stacked layers' L
    axis). Column-parallel: data, per-group scales and two-level multipliers
    split N, per-column (w8) scales with it. Row-parallel: data, per-group
    scales and multipliers split K, per-column scales replicated.
    ``mult_packed`` and ``in_scale`` replicate (stacked shards pack their
    multipliers again)."""
    data = lead + ((None, "model") if col_parallel else ("model", None))
    per_column = ql.scale.dim() == len(lead) + 1
    scale = (lead + ("model",) if col_parallel else None) if per_column else data
    return dataclasses.replace(ql, data=data, scale=scale,
                               mult=None if ql.mult is None else data,
                               mult_packed=None, in_scale=None)


def _layer_sharding(layer: ServingLayer) -> ServingLayer:
    return dataclasses.replace(layer, input_norm=None, post_norm=None, **{
        f.name: ql_spec(getattr(layer, f.name), f.name in _COL)
        for f in dataclasses.fields(layer) if isinstance(getattr(layer, f.name), QuantLinear)})


def serving_param_spec(params: ServingParams) -> ServingParams:
    """The spec tree of ``params`` (`sharding.py:60`): the same structure
    with a spec tuple (one entry a dim: None or a mesh dim name) or None
    (replicated) in place of each tensor."""
    return ServingParams(
        embedding=None, layers=tuple(_layer_sharding(l) for l in params.layers),
        final_norm=None,
        lm_head=None if params.lm_head is None else ql_spec(params.lm_head, True),
    )


def fit_row_parallel(ql: QuantLinear, tp: int) -> QuantLinear:
    """A row-parallel weight ready to split over ``tp`` shards
    (`tp_serving.py:46`): a paired two-level weight whose K shard would
    hold an odd group count goes to the group-halves layout (the paired
    nibble layout cannot split mid-pair; `repack_unpaired`, bit-exact)."""
    if ql.mode == "w4a8_2l" and ql.paired:
        n_groups = ql.mult.shape[-2]
        if n_groups % tp or (n_groups // tp) % 2:
            return repack_unpaired(ql)
    return ql


def _check_row_groups(ql: QuantLinear, tp: int) -> None:
    """Every shard of a row-parallel per-group weight holds whole groups
    (`sharding.py:39`, JAX's error); two-level multipliers count as the
    per-group scales do."""
    groups = ql.mult if ql.mult is not None else ql.scale if ql.scale.dim() == 2 else None
    if groups is not None and groups.shape[0] % tp:
        raise ValueError(
            f"Cannot row-shard per-group quantized weight: {groups.shape[0]} "
            f"groups (group_size={ql.group_size}) do not divide over "
            f"tp={tp} shards. Use a group size g with (K/tp) % g == 0."
        )


def _fit_row(ql: QuantLinear, tp: int) -> QuantLinear:
    _check_row_groups(ql, tp)
    return fit_row_parallel(ql, tp)


def shard_serving_params(params: ServingParams, mesh) -> ServingParams:
    """This rank's shard of ``params`` under Megatron TP (`sharding.py:95`),
    cut from the whole tensors every rank holds."""
    tp = mesh.size(mesh.mesh_dim_names.index("model"))
    layers = tuple(dataclasses.replace(l, o_proj=_fit_row(l.o_proj, tp),
                                       down_proj=_fit_row(l.down_proj, tp))
                   for l in params.layers)
    params = dataclasses.replace(params, layers=layers)
    return shard_tree(params, serving_param_spec(params), mesh)


def batch_axes(mesh):
    """The mesh dims the batch splits over (`sharding.py:121`): ("dcn",
    "data") on a hybrid multi-host mesh, "data" on one host."""
    return ("dcn", "data") if "dcn" in mesh.mesh_dim_names else "data"


def shard_kv_cache(cache: KVCache, mesh) -> KVCache:
    """This rank's shard of the per-layer cache (`sharding.py:129`): batch
    over the data dims, kv heads over "model"."""
    b = batch_axes(mesh)
    kv, sc = (b, "model", None, None), (b, "model", None)

    def layer(lc: LayerKVCache) -> LayerKVCache:
        return LayerKVCache(
            k=take_shard(lc.k, kv, mesh), v=take_shard(lc.v, kv, mesh),
            k_scale=None if lc.k_scale is None else take_shard(lc.k_scale, sc, mesh),
            v_scale=None if lc.v_scale is None else take_shard(lc.v_scale, sc, mesh),
        )

    return KVCache(layers=tuple(layer(lc) for lc in cache.layers), length=cache.length)


def sharded_serving_forward(params: ServingParams, config, input_ids, mesh, cache=None,
                            positions=None, logits_positions="all"):
    """The per-layer forward on this rank's shards (`shard_serving_params`,
    `shard_kv_cache`) as GSPMD computes it over JAX's placement: the
    single-device function of ``input_ids`` (B, T), whose batch rows this
    rank takes by the data dims. Returns (f32 logits of this rank's rows,
    all of the vocabulary; new cache shard)."""
    tp = mesh.size(mesh.mesh_dim_names.index("model"))
    local = dataclasses.replace(config, num_heads=config.num_heads // tp,
                                num_kv_heads=config.num_kv_heads // tp)
    if config.num_heads % tp or config.num_kv_heads % tp:
        raise ValueError(f"heads {config.num_heads}/{config.num_kv_heads} must divide over "
                         f"tp={tp}")
    ids = take_shard(input_ids, (batch_axes(mesh), None), mesh)
    return serving_forward(params, local, ids, cache, positions, logits_positions,
                           tp_group=mesh.get_group("model"))
