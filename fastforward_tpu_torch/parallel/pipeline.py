"""Pipeline parallelism: GPipe microbatching over a mesh dim
(`fastforward_tpu/parallel/pipeline.py`).

Layers are stacked along a leading axis and cut per stage into contiguous
blocks (`mesh.take_shard` over the dim ``stage``); stage s runs its block
on each microbatch in turn, receiving it from stage s - 1 and sending the
result to stage s + 1 (`transport.send_next`, `transport.recv_prev`), the
fill-drain schedule of ``M + S - 1`` ticks for M microbatches over S
stages. The stacked layers are any tree of dataclasses, tuples, lists and
dicts whose tensors share the leading layer axis, e.g. a stacked
`QuantLinear` (data, scale and mult stacked, the multipliers cut with
their weights).

The JAX loop runs ``stage_fn`` on every tick, bubbles included, and
discards a bubble's result (`pipeline.py:60-61`); here a stage computes
only its M real microbatches and the last stage sends nothing back to the
first. The results are the same: each stage applies L/S layers to each
microbatch once, so a rank launches (L/S) x M times what one layer
launches (a w4a8_2l `QuantLinear` of up to 256 rows a microbatch: one row-5
GEMV, ``w4a8_gemv``). The last stage's (M, mb, ...) outputs go to every
rank by a broadcast, which is JAX's ``psum`` of the buffer that only the
last stage filled.
"""

import dataclasses
from typing import Any, Callable

import torch
import torch.distributed as dist

from fastforward_tpu_torch.parallel.mesh import take_shard
from fastforward_tpu_torch.parallel.transport import broadcast_from, recv_prev, send_next

__all__ = ["pipeline_stage_loop", "pipeline_forward"]


def _tree_map(fn, tree):
    """``fn`` over every tensor of a tree of dataclasses, tuples, lists and
    dicts; other leaves are kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: _tree_map(fn, getattr(tree, f.name))
                                            for f in dataclasses.fields(tree) if f.init})
    return tree


def _first_leaf(tree) -> torch.Tensor:
    found = []
    _tree_map(lambda t: found.append(t) or t, tree)
    if not found:
        raise ValueError("the stacked layers hold no tensor")
    return found[0]


def pipeline_stage_loop(stage_params: Any, x_microbatches: torch.Tensor,
                        stage_fn: Callable[[Any, torch.Tensor], torch.Tensor], group) -> torch.Tensor:
    """The fill-drain schedule of this rank's stage over the ranks of
    ``group`` (`pipeline.py:26`). ``x_microbatches``: (M, mb, ...), the full
    input on every rank (stage 0 reads it). ``stage_fn(stage_params, h)``
    must keep h's shape and dtype. Returns the (M, mb, ...) outputs on every
    rank."""
    S, s = dist.get_world_size(group), dist.get_rank(group)
    M = x_microbatches.shape[0]
    out = torch.empty_like(x_microbatches)
    pending = None
    for m in range(M):
        h = x_microbatches[m] if s == 0 else recv_prev(x_microbatches[m], group)
        y = stage_fn(stage_params, h)
        if y.shape != h.shape or y.dtype != h.dtype:
            raise ValueError(f"stage_fn changed the activation from {tuple(h.shape)} {h.dtype} to "
                             f"{tuple(y.shape)} {y.dtype}")
        if s == S - 1:
            out[m] = y
            continue
        if pending is not None:
            pending[0].wait()
        pending = send_next(y, group)
    if pending is not None:
        pending[0].wait()
    return out if S == 1 else broadcast_from(out, S - 1, group)


def pipeline_forward(mesh, stacked_layers: Any, x: torch.Tensor,
                     layer_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                     axis_name: str = "stage", n_microbatches: int = 4) -> torch.Tensor:
    """Pipeline-parallel forward of depth-stacked layers over the mesh dim
    ``axis_name`` (`pipeline.py:82`). ``stacked_layers``: a tree whose
    tensors all lead with the layer axis L, L divisible by the stage count;
    stage s holds layers [s L/S, (s + 1) L/S). ``x``: (B, ...), B divisible
    by ``n_microbatches``. ``layer_fn(layer, h)`` applies one layer. Returns
    the (B, ...) output on every rank; raises JAX's ValueErrors."""
    S = mesh.size(mesh.mesh_dim_names.index(axis_name))
    B = x.shape[0]
    if B % n_microbatches != 0:
        raise ValueError(f"batch {B} not divisible by {n_microbatches} microbatches")
    L = _first_leaf(stacked_layers).shape[0]
    if L % S != 0:
        raise ValueError(f"{L} layers not divisible by {S} stages")
    stage_layers = _tree_map(
        lambda t: take_shard(t, (axis_name,) + (None,) * (t.dim() - 1), mesh), stacked_layers)

    def stage_fn(layers, h):
        for i in range(L // S):
            h = layer_fn(_tree_map(lambda t: t[i], layers), h)
        return h

    xm = x.reshape(n_microbatches, B // n_microbatches, *x.shape[1:])
    out = pipeline_stage_loop(stage_layers, xm, stage_fn, mesh.get_group(axis_name))
    return out.reshape(B, *out.shape[2:])
