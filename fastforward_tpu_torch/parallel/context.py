"""Context (sequence) parallelism: ring attention over a mesh dim
(`fastforward_tpu/parallel/context.py`).

Each rank of the dim's process group holds (B, H, T_local, D) q/k/v, the
positions ``rank * T_local + arange(T_local)`` of the global sequence. For
``world`` steps it attends its q to the K/V block it holds, merges that
block into its running (max, sum, output) state with the online-softmax
rule, and passes K and V one hop around the ring (to rank + 1, from
rank - 1; `transport.ring_shift`). The numerics are JAX's: scores in f32
times ``scale``, masked with ``NEG_INF``, rows that see no key give p = 0,
P cast to V's dtype before P·V, the accumulator in f32 and
``o / max(l, 1e-30)`` cast to q's dtype.

Two things differ from the JAX loop and change no value: the block's
source rank is computed, ``(rank - step) mod world``, where JAX passes it
around the ring with K and V; and the last step sends nothing (JAX's last
``ppermute`` feeds a carry it discards).

Under gloo a CUDA block crosses host memory at every hop
(`transport.host_staged`, logged); under NCCL it moves on the device.
"""

import math
from typing import Optional

import torch
import torch.distributed as dist

from fastforward_tpu_torch.parallel.mesh import take_shard
from fastforward_tpu_torch.parallel.transport import all_gather_cat, ring_shift

__all__ = ["NEG_INF", "ring_attention", "context_parallel_attention"]

NEG_INF = -1e30


def _block_attend(q, k, v, q_pos, kv_pos, causal, scale):
    """Partial attention of the local q against one K/V block (`context.py:32`):
    (m, l, o), the running max (B, H, Tq, 1), the sum of exponentials and
    the unnormalized f32 output (B, H, Tq, D)."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        mask = kv_pos[None, :] <= q_pos[:, None]
        scores = torch.where(mask[None, None], scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    # a row that sees no key of the block: exp(NEG_INF - NEG_INF) would be 1
    p = torch.exp(scores - torch.clamp(m, min=NEG_INF / 2))
    p = torch.where(m <= NEG_INF / 2, 0.0, p)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype), v).float()
    return m, l, o


def _merge(state, new):
    """The online-softmax merge of two partial states (`context.py:54`)."""
    m0, l0, o0 = state
    m1, l1, o1 = new
    m = torch.maximum(m0, m1)
    a0, a1 = torch.exp(m0 - m), torch.exp(m1 - m)
    return m, l0 * a0 + l1 * a1, o0 * a0 + o1 * a1


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group,
                   causal: bool = True, scale: Optional[float] = None) -> torch.Tensor:
    """Ring attention on sequence-sharded (B, H, T_local, D) q/k/v over the
    ranks of ``group`` (`context.py:63`); this rank holds positions
    [rank * T_local, (rank + 1) * T_local). Returns this rank's
    (B, H, T_local, D) output in q's dtype."""
    steps, idx = dist.get_world_size(group), dist.get_rank(group)
    B, H, T, D = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    ar = torch.arange(T, device=q.device)
    q_pos = idx * T + ar
    state = (torch.full((B, H, T, 1), NEG_INF, dtype=torch.float32, device=q.device),
             torch.zeros((B, H, T, 1), dtype=torch.float32, device=q.device),
             torch.zeros((B, H, T, D), dtype=torch.float32, device=q.device))
    for step in range(steps):
        src = (idx - step) % steps
        state = _merge(state, _block_attend(q, k, v, q_pos, src * T + ar, causal, scale))
        if step + 1 < steps:
            k, v = ring_shift([k, v], group)
    _, l, o = state
    return (o / torch.clamp(l, min=1e-30)).to(q.dtype)


def context_parallel_attention(mesh, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               axis_name: str = "sp", causal: bool = True) -> torch.Tensor:
    """Ring attention over the mesh dim ``axis_name`` (`context.py:108`):
    takes the full (B, H, T, D) q/k/v on every rank, cuts this rank's T
    slice as `mesh.take_shard` does, and returns the full (B, H, T, D)
    output on every rank (the global array of JAX's ``out_specs``).
    Raises JAX's ValueError where T does not divide by the dim's size."""
    n = mesh.size(mesh.mesh_dim_names.index(axis_name))
    T = q.shape[2]
    if T % n:
        raise ValueError(f"context_parallel_attention maps array axis 2 (of size {T}) to mesh "
                         f"axis '{axis_name}' (of size {n}), but {n} does not evenly divide {T}")
    spec = (None, None, axis_name, None)
    group = mesh.get_group(axis_name)
    local = ring_attention(*(take_shard(t, spec, mesh) for t in (q, k, v)), group,
                           causal=causal)
    return all_gather_cat(local, 2, group)
