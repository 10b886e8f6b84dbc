"""Multi-host serving over `torch.distributed`: (dcn, data, model) meshes
(`fastforward_tpu/parallel/multihost.py`).

One process a device. The outer ``dcn`` dim spans hosts (data parallel
only: the batch splits over it and the weights are replicated); the inner
dims span the devices of one host (``model``: tensor parallelism of the
quantized weights, `parallel/tp_serving.py`). A decode step then needs no
collective across hosts: each host decodes its share of the batch.
"""

import os
from typing import Optional

import torch.distributed as dist

from fastforward_tpu_torch.parallel.mesh import axis_sizes_for

__all__ = ["initialize_distributed", "make_hybrid_mesh", "host_local_batch_slice"]


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, backend: str = "nccl") -> None:
    """`torch.distributed.init_process_group` for multi-host serving
    (`multihost.py:46`): ``coordinator_address`` ("host:port"),
    ``num_processes`` and ``process_id``, each by default from the
    ``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK`` environment.
    ``backend``: "nccl" (one card a process) or "gloo". No-op if a process
    group exists already."""

    if dist.is_initialized():
        return
    if coordinator_address is None:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    if num_processes is None:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None:
        process_id = int(os.environ["RANK"])
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def make_hybrid_mesh(ici_axes: Optional[dict] = None, dcn_axis: str = "dcn", *,
                     num_hosts: Optional[int] = None, device_type: str = "cuda"):
    """A (dcn, *ici) `DeviceMesh` (`multihost.py:76`): the outer dim the
    hosts, the inner dims one host's devices. ``num_hosts`` defaults to
    the world size over the processes a host (``LOCAL_WORLD_SIZE``, as
    torchrun sets it; one host without it); a host's processes are
    consecutive ranks (host-major), so every row of the outer dim is one
    host's devices and only the outer dim crosses hosts. ``ici_axes``:
    {axis_name: size} over a host's devices (one ``-1`` inferred), by
    default ``{"model": devices a host}``."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    hosts = num_hosts if num_hosts is not None else \
        world // int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world % hosts:
        raise ValueError(f"unequal devices per host: {world} processes over {hosts} hosts")
    local = world // hosts
    ici = ici_axes if ici_axes is not None else {"model": local}
    try:
        sizes = axis_sizes_for(ici, local)
    except ValueError:
        raise ValueError(f"ici axes {ici} do not cover {local} local devices") from None
    return init_device_mesh(device_type, (hosts, *sizes.values()),
                            mesh_dim_names=(dcn_axis, *sizes))


def host_local_batch_slice(global_batch: int, mesh, dcn_axis: str = "dcn") -> slice:
    """The slice of a batch split over ``dcn_axis`` that this process's host
    owns (`multihost.py:118`): ``global_batch / hosts`` rows."""
    n = mesh.size(mesh.mesh_dim_names.index(dcn_axis))
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} hosts")
    per = global_batch // n
    i = mesh.get_local_rank(dcn_axis)
    return slice(i * per, (i + 1) * per)
