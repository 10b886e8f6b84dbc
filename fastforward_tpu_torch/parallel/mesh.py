"""Device meshes over `torch.distributed` (`fastforward_tpu/parallel/mesh.py`).

The JAX package builds a `jax.sharding.Mesh` over its devices and lets
GSPMD or `shard_map` place the work. Here a mesh is a
`torch.distributed.device_mesh.DeviceMesh` over the ranks of the default
process group, one device a rank, with a name for each dim; the dims'
process groups carry the collectives (`DeviceMesh.get_group`).

The process group is the caller's: `parallel.multihost.initialize_distributed`
or `torch.distributed.init_process_group` with the backend of their choice
(``nccl`` with one card a rank, ``gloo`` for CPU ranks or for ranks that
share one card). Nothing here switches the backend.
"""

import math
from typing import Optional

import torch.distributed as dist

__all__ = ["make_mesh", "axis_sizes_for", "take_shard", "shard_tree"]


def axis_sizes_for(axis_sizes: dict, n: int) -> dict:
    """``axis_sizes`` with a single ``-1`` inferred so that the sizes
    multiply to ``n``; raises ValueError where they do not."""
    names, sizes = list(axis_sizes), list(axis_sizes.values())
    if sizes.count(-1) == 1:
        known = math.prod(s for s in sizes if s != -1)
        sizes[sizes.index(-1)] = n // known
    if math.prod(sizes) != n:
        raise ValueError(f"mesh axes {dict(zip(names, sizes))} do not cover {n} devices")
    return dict(zip(names, sizes))


def make_mesh(axis_sizes: Optional[dict] = None, *, device_type: str = "cuda"):
    """A `DeviceMesh` from {axis_name: size} over every rank of the default
    process group (`mesh.py:15`), ranks in row-major order. Defaults to a
    pure model-parallel mesh ``{"data": 1, "model": world}``; one ``-1``
    axis is inferred. ``device_type``: "cuda" (the default) or "cpu"."""
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    sizes = axis_sizes_for(axis_sizes or {"data": 1, "model": n}, n)
    return init_device_mesh(device_type, tuple(sizes.values()),
                            mesh_dim_names=tuple(sizes))


def _coordinate(mesh, axes) -> tuple:
    """(this rank's index, count) along the mesh dims ``axes`` (a name or a
    tuple of names, outer first)."""
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    idx, count = 0, 1
    for a in names:
        n = mesh.size(mesh.mesh_dim_names.index(a))
        idx, count = idx * n + mesh.get_local_rank(a), count * n
    return idx, count


def take_shard(t, spec, mesh):
    """This rank's block of ``t`` under ``spec``, one entry a dim (as a
    JAX ``PartitionSpec``): None keeps the dim whole, a mesh dim name (or
    a tuple of names) splits it evenly over those dims; a view where the
    split allows. Raises ValueError for a dim that does not divide."""
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        idx, count = _coordinate(mesh, axes)
        size = t.shape[dim]
        if size % count:
            raise ValueError(f"dim {dim} of size {size} does not split over {count} shards "
                             f"({axes})")
        per = size // count
        t = t.narrow(dim, idx * per, per)
    return t.contiguous()


def shard_tree(tree, specs, mesh):
    """`take_shard` over a tree of dataclasses, tuples and tensors whose
    twin ``specs`` holds a spec tuple (or None: replicated) where ``tree``
    holds a tensor; other fields are kept."""
    import dataclasses

    import torch

    if isinstance(tree, torch.Tensor):
        return tree if specs is None else take_shard(tree, specs, mesh)
    if isinstance(tree, tuple):
        return tuple(shard_tree(t, s, mesh) for t, s in zip(tree, specs))
    if dataclasses.is_dataclass(tree) and specs is not None:
        fields = {}
        for f in dataclasses.fields(tree):
            v = getattr(tree, f.name)
            if isinstance(v, (torch.Tensor, tuple)) or dataclasses.is_dataclass(v):
                fields[f.name] = shard_tree(v, getattr(specs, f.name), mesh)
        return dataclasses.replace(tree, **fields)
    return tree
