"""Quantized Mixture-of-Experts block with expert parallelism
(`fastforward_tpu/serving/moe.py`).

Experts are SwiGLU MLPs whose weights live in frozen low-bit `QuantLinear`
storage stacked along a leading expert axis; each expert runs the mode's
projection kernels through `QuantLinear.__call__` (row 5 for w4a8_2l, 19
for w8a8, 16 and 17 for w4a8 and w4a16; above 256 tokens the prefill
dequant and a dense product). Under expert
parallelism each rank holds ``E / ep`` experts of that axis and the routed
combine is one ``all_reduce`` sum over its process group.

Routing is dense-masked, as in the JAX package: every rank computes its
local experts over all tokens and weights each token's output by the
router's top-k choice (zero where the expert was not chosen).
"""

import dataclasses
import math

import torch
import torch.distributed as dist

from fastforward_tpu_torch.device import resolve_device
from fastforward_tpu_torch.serving.engine import QuantLinear, quantize_linear


@dataclasses.dataclass
class MoEBlock:
    """Router + E stacked quantized SwiGLU experts (`moe.py:27`).

    ``gate_up``/``down`` are `QuantLinear`s whose tensors carry a leading
    expert axis (E, ...); ``router`` is (hidden, E) bf16."""

    router: torch.Tensor
    gate_up: QuantLinear
    down: QuantLinear
    top_k: int = 2

    @property
    def num_experts(self) -> int:
        return self.router.shape[-1]


def _stack(qls) -> QuantLinear:
    first = qls[0]
    return QuantLinear(
        data=torch.stack([q.data for q in qls]), scale=torch.stack([q.scale for q in qls]),
        mode=first.mode, group_size=first.group_size,
        mult=None if first.mult is None else torch.stack([q.mult for q in qls]),
        paired=first.paired,
    )


def make_moe_block(gen: torch.Generator, hidden: int, intermediate: int, num_experts: int,
                   mode: str = "w4a8_2l", group_size: int = 128, top_k: int = 2,
                   device=None) -> MoEBlock:
    """Random-init MoE block with frozen quantized experts (`moe.py:45`):
    a bf16 router of normals times 0.02, and per expert the normals of a
    (K, N) weight over sqrt(K) quantized in ``mode`` (group g, or K where K
    is no multiple of g). ``gen`` is a generator on ``device`` (None: the
    GPU)."""
    dev = resolve_device(device)
    router = torch.randn((hidden, num_experts), generator=gen, device=dev).to(torch.bfloat16)
    router = router * 0.02

    def stack_ql(K, N):
        g = group_size if K % group_size == 0 else K
        return _stack([
            quantize_linear(torch.randn((K, N), generator=gen, device=dev) / math.sqrt(K), mode, g)
            for _ in range(num_experts)])

    return MoEBlock(router=router, gate_up=stack_ql(hidden, 2 * intermediate),
                    down=stack_ql(intermediate, hidden), top_k=top_k)


def _expert_slice(ql: QuantLinear, e) -> QuantLinear:
    """Expert ``e``'s `QuantLinear` (`moe.py:85`), or the experts of the
    slice ``e``: views, nothing copied."""
    return QuantLinear(
        data=ql.data[e], scale=ql.scale[e], mode=ql.mode, group_size=ql.group_size,
        mult=None if ql.mult is None else ql.mult[e], paired=ql.paired,
    )


def route(x2: torch.Tensor, router: torch.Tensor, top_k: int):
    """(top-k expert ids (T, k) int64, their weights (T, k) f32): the router
    in f32, the k largest logits in `jax.lax.top_k`'s order (descending; a
    tie to the lower index, by a stable sort), a softmax over them."""
    logits = x2.float() @ router.float()
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :top_k], idx[:, :top_k]
    return idx, torch.softmax(vals, dim=-1)


def moe_forward(x: torch.Tensor, block: MoEBlock, group=None,
                out_dtype=torch.bfloat16) -> torch.Tensor:
    """Top-k routed forward (`moe.py:96`). x: (..., hidden) → (..., hidden).

    ``group``: a `torch.distributed` process group over which the expert
    axis of ``block`` is split (this rank holds experts rank * E_local
    onwards, `expert_shard`); the local outputs are summed with one
    ``all_reduce``. Routing runs over the global expert count (the router
    is replicated)."""
    lead = x.shape[:-1]
    H = x.shape[-1]
    xt = x.reshape(-1, H)
    top_idx, top_w = route(xt, block.router, block.top_k)
    E_local = block.gate_up.data.shape[0]
    if group is None:
        offset = 0
        if E_local != block.num_experts:
            raise ValueError(f"{E_local} local experts of {block.num_experts} without a group")
    else:
        offset = dist.get_rank(group) * E_local
    acc = torch.zeros((xt.shape[0], H), dtype=torch.float32, device=x.device)
    for e in range(E_local):
        gate_up = _expert_slice(block.gate_up, e)(xt, out_dtype=torch.bfloat16)
        inter = gate_up.shape[-1] // 2
        gated = torch.nn.functional.silu(gate_up[..., :inter].float())
        y = _expert_slice(block.down, e)(
            (gated * gate_up[..., inter:].float()).to(torch.bfloat16), out_dtype=torch.float32)
        w_tok = torch.where(top_idx == offset + e, top_w, 0.0).sum(dim=-1)
        acc = acc + y * w_tok[:, None]
    if group is not None:
        dist.all_reduce(acc, group=group)
    return acc.to(out_dtype).reshape(*lead, H)


def expert_shard(block: MoEBlock, rank: int, ep: int) -> MoEBlock:
    """Rank ``rank``'s block of ``ep``-way expert parallelism: experts
    ``rank * E / ep`` onwards (`moe.py:143`'s ``P(axis_name)`` split of the
    expert axis), the router replicated."""
    E = block.num_experts
    if E % ep:
        raise ValueError(f"{E} experts do not split over {ep} ranks")
    n = E // ep
    mine = slice(rank * n, (rank + 1) * n)
    return MoEBlock(router=block.router, gate_up=_expert_slice(block.gate_up, mine),
                    down=_expert_slice(block.down, mine), top_k=block.top_k)


def expert_parallel_moe(mesh, block: MoEBlock, x: torch.Tensor, axis_name: str = "expert",
                        out_dtype=torch.bfloat16) -> torch.Tensor:
    """Experts split over the mesh dim ``axis_name`` of a `DeviceMesh`
    (`moe.py:143`), tokens and router replicated, the output combined by
    ``all_reduce``: this rank's shard of ``block`` (all E experts, as every
    rank holds them before the split) runs `moe_forward` over the dim's
    process group."""
    group = mesh.get_group(axis_name)
    rank, ep = dist.get_rank(group), dist.get_world_size(group)
    return moe_forward(x, expert_shard(block, rank, ep), group=group, out_dtype=out_dtype)
