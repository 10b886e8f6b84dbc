"""Ring hops, sends and gathers of the ring-attention and pipeline schedules
over `torch.distributed`, by backend.

The JAX package moves a block one hop along a mesh axis with
``jax.lax.ppermute`` and gathers with ``out_specs``. Here the block moves by
point-to-point ops inside the dim's process group:

- NCCL: send/recv of the device tensors themselves (posted together by
  ``dist.batch_isend_irecv``); a failed op raises.
- gloo: takes send/recv and all_gather of CPU tensors only (PyTorch's
  backend table), which is how two ranks share the one card of a machine
  (NCCL refuses two ranks a device). A CUDA tensor is then staged through
  host memory explicitly: copied to the host, sent, received into a host
  buffer and copied back to its device. The choice is made by backend, not
  by a failure, and is logged once a process (`host_staged`).

A CPU tensor moves as it is under either backend.
"""

import logging

import torch
import torch.distributed as dist

__all__ = ["host_staged", "ring_shift", "send_next", "recv_prev", "broadcast_from",
           "all_gather_cat"]

_LOG = logging.getLogger(__name__)
_LOGGED = []


def host_staged(t: torch.Tensor, group) -> bool:
    """True where ``t`` crosses ``group`` through host memory: a device
    tensor under gloo. Logs the first such choice of the process."""
    staged = t.device.type != "cpu" and dist.get_backend(group) == "gloo"
    if staged and not _LOGGED:
        _LOGGED.append(True)
        _LOG.info("gloo takes no send/recv of %s tensors: ring hops and gathers stage "
                  "through host memory", t.device.type)
    return staged


def _peer(group, offset: int) -> int:
    """The global rank ``offset`` places along the ring of ``group``."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    return dist.get_global_rank(group, (r + offset) % n)


def _wire(t: torch.Tensor, staged: bool) -> torch.Tensor:
    return t.detach().to("cpu").contiguous() if staged else t.contiguous()


def ring_shift(tensors, group) -> list:
    """Each of ``tensors`` goes to the next rank of ``group`` (rank + 1 mod
    n) and the previous rank's arrive in their place: ``ppermute`` with the
    permutation [(i, (i + 1) % n)]. Every send and receive is posted before
    any is waited on, so a ring of any size, even or odd, cannot deadlock.
    One rank: the tensors themselves."""
    if dist.get_world_size(group) == 1:
        return list(tensors)
    staged = host_staged(tensors[0], group)
    nxt, prv = _peer(group, 1), _peer(group, -1)
    ops, bufs = [], []
    for t in tensors:
        wire = _wire(t, staged)
        buf = torch.empty_like(wire)
        ops += [dist.P2POp(dist.isend, wire, nxt, group), dist.P2POp(dist.irecv, buf, prv, group)]
        bufs.append(buf)
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return [b.to(t.device) if staged else b for b, t in zip(bufs, tensors)]


def send_next(t: torch.Tensor, group):
    """Send ``t`` to the next rank of ``group``, not waiting; returns (the
    work to wait on, the tensor on the wire, to be kept until then)."""
    wire = _wire(t, host_staged(t, group))
    return dist.isend(wire, _peer(group, 1), group), wire


def recv_prev(like: torch.Tensor, group) -> torch.Tensor:
    """A tensor of ``like``'s shape, dtype and device received from the
    previous rank of ``group``."""
    staged = host_staged(like, group)
    buf = torch.empty(like.shape, dtype=like.dtype, device="cpu" if staged else like.device)
    dist.recv(buf, _peer(group, -1), group)
    return buf.to(like.device) if staged else buf


def broadcast_from(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """``t`` of rank ``src`` of ``group`` on every rank (``t`` elsewhere
    gives the shape, dtype and device)."""
    staged = host_staged(t, group)
    wire = _wire(t, staged)
    dist.broadcast(wire, dist.get_global_rank(group, src), group)
    return wire.to(t.device) if staged else wire


def all_gather_cat(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' ``t`` of ``group`` concatenated along ``dim``, in rank
    order, on every rank."""
    staged = host_staged(t, group)
    wire = _wire(t, staged)
    parts = [torch.empty_like(wire) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, wire, group)
    out = torch.cat(parts, dim=dim)
    return out.to(t.device) if staged else out
