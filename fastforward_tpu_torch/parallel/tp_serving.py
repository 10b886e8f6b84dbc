"""Tensor-parallel serving over `torch.distributed`
(`fastforward_tpu/parallel/tp_serving.py`).

The JAX package runs the stacked forward under `shard_map`: each device
holds its shard of the weights and the KV cache and runs the same kernels
on it, and the two row-parallel projections of a layer sum over the
``model`` axis (Megatron TP). Here each rank of a `DeviceMesh`
(`parallel/mesh.py`) is one such device: the layout below cuts a rank's
shard from the whole tensors (`shard_for_tp`), and the stacked forward
runs on it with the mesh's ``model`` group (`serving_forward_stacked`'s
``tp_group``: one ``all_reduce`` after o_proj and one after the MLP).

Layout (stacked leaves, leading L axis; one entry a dim, as a JAX
``PartitionSpec``):
  column-parallel q/k/v/gate/up: data (L, K/2, N) → (None, None, "model"),
  scales and multipliers with N; row-parallel o/down: data → (None,
  "model", None), per-group scales and the multipliers with K, per-column
  scales replicated. KV cache: kv heads over "model", batch over the data
  axis; a paged pool's pages over the data axis (each data shard's table
  holds page ids local to its part of the pool). Embedding, norms and the
  lm_head replicated.

Each shard quantizes its own activation rows (o_proj's and down_proj's
inputs are the rank's K shard): a per-shard grid, part of TP's numerics
(`tests/parallel/test_tp_serving.py:323`).
"""

import dataclasses
from typing import Optional

import torch

from fastforward_tpu_torch.kernels.packing import pack_mult_nibbles
from fastforward_tpu_torch.models.llama import LlamaConfig
from fastforward_tpu_torch.parallel.mesh import shard_tree
from fastforward_tpu_torch.parallel.sharding import fit_row_parallel, ql_spec
from fastforward_tpu_torch.serving.engine import QuantLinear, ServingLayer
from fastforward_tpu_torch.serving.paged import PagedKVCache
from fastforward_tpu_torch.serving.sampling import SamplingParams, sample_logits
from fastforward_tpu_torch.serving.stacked import (
    FusedServingLayer,
    StackedKVCache,
    serving_forward_stacked,
    unfuse_stacked_layers,
)

__all__ = ["shard_for_tp", "make_tp_decode_step", "make_tp_decode_loop",
           "normalize_stacked_for_tp", "stacked_layer_specs", "cache_specs", "paged_cache_specs"]


def stacked_layer_specs(stacked: ServingLayer) -> ServingLayer:
    """The spec tree of (unfused) stacked layers (`tp_serving.py:64`)."""
    col = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")
    return dataclasses.replace(stacked, input_norm=None, post_norm=None, **{
        name: ql_spec(getattr(stacked, name), name in col, lead=(None,))
        for name in col + ("o_proj", "down_proj")})


def cache_specs(cache: StackedKVCache, data_axis: str = "data") -> StackedKVCache:
    """KV heads over "model", batch over ``data_axis`` (`tp_serving.py:93`)."""
    kv = (None, data_axis, "model", None, None)
    sc = (None, data_axis, "model", None)
    return StackedKVCache(k=kv, v=kv, k_scale=None if cache.k_scale is None else sc,
                          v_scale=None if cache.v_scale is None else sc)


def paged_cache_specs(cache: PagedKVCache, data_axis: str = "data") -> PagedKVCache:
    """A paged pool under TP (+DP) (`tp_serving.py:103`): kv heads over
    "model" (a rank holds its heads of every page of its part), pages over
    ``data_axis`` (each data shard runs its own allocator over local page
    ids), the tables' rows over ``data_axis``."""
    kv, sc = (None, data_axis, "model", None, None), (None, data_axis, "model", None)
    return PagedKVCache(k=kv, v=kv, k_scale=sc, v_scale=sc, table=(data_axis, None))


def normalize_stacked_for_tp(stacked: ServingLayer, tp: int) -> ServingLayer:
    """o_proj and down_proj ready to split K (`tp_serving.py:46`,
    `sharding.fit_row_parallel`)."""
    return dataclasses.replace(stacked, o_proj=fit_row_parallel(stacked.o_proj, tp),
                               down_proj=fit_row_parallel(stacked.down_proj, tp))


def _ensure_unfused(stacked, config: Optional[LlamaConfig] = None):
    """Column-parallel TP splits q/k/v and gate/up one by one (a plain N
    split of the fused qkv would put q columns on k/v shards): fused layers
    are unfused, exactly (`tp_serving.py:126`)."""
    if not isinstance(stacked, FusedServingLayer):
        return stacked
    if config is None:
        raise ValueError(
            "fused stacked layers need `config` to unfuse for TP; pass "
            "config= or call serving.stacked.unfuse_stacked_layers first"
        )
    return unfuse_stacked_layers(stacked, config)


def _cache_specs(cache, data_axis):
    if isinstance(cache, PagedKVCache):
        return paged_cache_specs(cache, data_axis)
    return cache_specs(cache, data_axis)


def _tp(mesh) -> int:
    return mesh.size(mesh.mesh_dim_names.index("model"))


def _pack_local(whole: ServingLayer, local: ServingLayer) -> ServingLayer:
    """Each shard's multipliers nibble-packed again where the whole layer's
    were (the stacked GEMVs read them so)."""
    def pack(w, q):
        packed = None if w.mult_packed is None else pack_mult_nibbles(q.mult).contiguous()
        return dataclasses.replace(q, mult_packed=packed)

    return dataclasses.replace(local, **{
        f.name: pack(getattr(whole, f.name), getattr(local, f.name))
        for f in dataclasses.fields(local) if isinstance(getattr(local, f.name), QuantLinear)})


def shard_for_tp(params, stacked, cache, mesh, data_axis: str = "data",
                 config: Optional[LlamaConfig] = None):
    """This rank's (params, stacked layers, cache) under the TP layout
    (`tp_serving.py:145`), cut from the whole tensors every rank holds.
    Fused layers are unfused first (pass ``config``, `_ensure_unfused`)."""
    stacked = normalize_stacked_for_tp(_ensure_unfused(stacked, config), _tp(mesh))
    local = _pack_local(stacked, shard_tree(stacked, stacked_layer_specs(stacked), mesh))
    return params, local, shard_tree(cache, _cache_specs(cache, data_axis), mesh)


def _local_config(config: LlamaConfig, tp: int) -> LlamaConfig:
    if config.num_kv_heads % tp != 0:
        raise ValueError(f"num_kv_heads={config.num_kv_heads} must divide over tp={tp}")
    return dataclasses.replace(config, num_heads=config.num_heads // tp,
                               num_kv_heads=config.num_kv_heads // tp)


def make_tp_decode_step(config: LlamaConfig, mesh, stacked, params, cache,
                        data_axis: str = "data"):
    """The TP decode step (`tp_serving.py:174`): ``step(params, stacked,
    cache, tokens, positions)`` → (logits, cache) on this rank's shards
    (`shard_for_tp`): ``tokens`` its batch rows (B / data, T), ``positions``
    (T,). ``data_axis``: the mesh dim of the batch, "data" on one host,
    "dcn" on the hybrid mesh (`parallel/multihost.py`), where the weights
    replicate over hosts and a step crosses no host. Raises for kv heads
    that do not divide over the model dim, with JAX's error."""
    local_config = _local_config(config, _tp(mesh))
    group = mesh.get_group("model")

    def step(params, stacked, cache, tokens, positions):
        return serving_forward_stacked(params, stacked, local_config, tokens, cache=cache,
                                       positions=positions, tp_group=group)

    return step


def make_tp_decode_loop(config: LlamaConfig, mesh, stacked, params, cache, num_steps: int,
                        data_axis: str = "data", sampling: Optional[SamplingParams] = None):
    """The multi-step TP decode loop (`tp_serving.py:224`) on this rank's
    shards, as `make_stacked_decode_loop`: greedy (the fused-argmax head
    under ``FF_FUSED_ARGMAX``, read here) ``loop(params, stacked, cache,
    token)`` or sampled ``loop(params, stacked, cache, token, generator)``,
    each → (tokens (B / data, num_steps), cache). The sampled loop draws
    one seed from ``generator`` (the same on every rank) and gives each
    data shard its own stream from it and the shard's index, as JAX folds
    the data index into its key: every model rank of a data shard draws the
    same tokens."""
    from fastforward_tpu_torch import flags

    local_config = _local_config(config, _tp(mesh))
    group = mesh.get_group("model")
    sampling = sampling or SamplingParams(temperature=0.0)

    if sampling.is_greedy:
        fused_argmax = flags.fused_argmax()

        def loop(params, stacked, cache, token):
            out = []
            for _ in range(num_steps):
                tok, cache = serving_forward_stacked(params, stacked, local_config, token, cache,
                                                     greedy_head=fused_argmax, tp_group=group)
                if not fused_argmax:
                    tok = torch.argmax(tok[:, -1], dim=-1)
                token = tok.to(token.dtype)[:, None]
                out.append(token[:, 0])
            return torch.stack(out, dim=1), cache

        return loop

    def loop_sampled(params, stacked, cache, token, generator):
        if generator is None:
            raise ValueError("stochastic sampling requires a torch.Generator")
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                                 device=generator.device))
        shard = mesh.get_local_rank(data_axis)
        gen = torch.Generator(device=token.device).manual_seed(seed + shard)
        out = []
        for _ in range(num_steps):
            logits, cache = serving_forward_stacked(params, stacked, local_config, token, cache,
                                                    tp_group=group)
            token = sample_logits(logits[:, -1], sampling, gen).to(token.dtype)[:, None]
            out.append(token[:, 0])
        return torch.stack(out, dim=1), cache

    return loop_sampled
