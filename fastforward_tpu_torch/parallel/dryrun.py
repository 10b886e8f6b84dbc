"""The multi-device dry run (`__graft_entry__.py:48` ``dryrun_multichip``).

`dryrun_multichip` runs inside every rank of an initialised process group
(one rank a device) and drives each parallel path of the port once at the
sizes of the JAX package's flagship config (`__graft_entry__.py:16-24`),
asserting JAX's shapes:

- the w8a8 serve step on the hybrid (dcn, data, model) mesh (the per-layer
  forward on this rank's shards, `parallel/sharding.py`);
- the TP decode step (w4a8_2l g32) on a stacked slab and on a paged pool,
  and the TP decode loop of 3 steps (`parallel/tp_serving.py`);
- ring attention over an ``sp`` dim of every rank (`parallel/context.py`);
- a GPipe pipeline of 4 w4a8_2l g128 `QuantLinear` layers over 2 stages
  (`parallel/pipeline.py`; 1 stage at an odd world);
- a w4a8_2l MoE block with its experts over an ``expert`` dim of every rank
  (`serving.moe.expert_parallel_moe`);
- the QAT training step (`__graft_entry__.py:178-231`): a two-layer MLP
  (32 → 64 → 32) through `quantize_model`, 8-bit weight and activation
  quantizers placed by two `QuantizationConfig` rules, every range (-3, 3),
  and one SGD step at lr 1e-3 on the global batch's MSE, the batch split
  over the ``data`` dim and the gradients averaged over every rank
  (`qat_model`, `qat_step`).

Each rank returns the gathered global shapes and the QAT loss; rank 0
prints one summary line, as JAX's does. A CUDA run takes head dim 128 and
hidden 1,024 (8 x 128) where the flagship has 32 and 256: the flash-decode
kernel takes head dim 128 only. Weights are the port's random generators',
not JAX's bits.
"""

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from fastforward_tpu_torch.device import resolve_device
from fastforward_tpu_torch.models.llama import LlamaConfig
from fastforward_tpu_torch.parallel.context import context_parallel_attention
from fastforward_tpu_torch.parallel.mesh import make_mesh, take_shard
from fastforward_tpu_torch.parallel.multihost import make_hybrid_mesh
from fastforward_tpu_torch.parallel.pipeline import pipeline_forward
from fastforward_tpu_torch.parallel.sharding import (
    batch_axes,
    shard_kv_cache,
    shard_serving_params,
    sharded_serving_forward,
)
from fastforward_tpu_torch.parallel.tp_serving import (
    make_tp_decode_loop,
    make_tp_decode_step,
    shard_for_tp,
)
from fastforward_tpu_torch.parallel.transport import all_gather_cat

__all__ = ["flagship_config", "dryrun_multichip", "qat_model", "qat_step"]


def flagship_config(head_dim: int = 32) -> LlamaConfig:
    """The dry run's config (`__graft_entry__.py:16`): GQA, RoPE, SwiGLU at
    small widths; ``head_dim`` 32 as JAX's, hidden = 8 heads x head_dim."""
    return LlamaConfig(vocab_size=512, hidden_size=8 * head_dim, intermediate_size=512,
                       num_layers=2, num_heads=8, num_kv_heads=4, head_dim=head_dim,
                       max_seq_len=128, dtype=torch.bfloat16)


def _global_rows(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The global array of a batch split over the mesh dims ``axes`` and
    replicated over the others: every rank's rows gathered over the world,
    one rank kept for each coordinate along ``axes``."""
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    every = all_gather_cat(t[None], 0, dist.group.WORLD)
    coords = np.arange(dist.get_world_size()).reshape(tuple(mesh.shape))
    keep = coords
    for d, name in enumerate(mesh.mesh_dim_names):
        if name not in names:
            keep = np.take(keep, [0], axis=d)
    return torch.cat([every[int(r)] for r in keep.reshape(-1)], dim=0)


class QatMLP(torch.nn.Module):
    """The dry run's QAT model (`__graft_entry__.py:184-194`): fc1 (32 → 64),
    ReLU on its dequantized output, fc2 (64 → 32), the output dequantized."""

    def __init__(self, device=None, generator=None):
        super().__init__()
        from fastforward_tpu_torch.models.llama import _linear, _placement

        dev, gen = _placement(device, generator)
        self.fc1 = _linear(32, 64, torch.float32, dev, gen, bias=True)
        self.fc2 = _linear(64, 32, torch.float32, dev, gen, bias=True)

    def forward(self, x):
        from fastforward_tpu_torch.quantization.quantized_array import dequantize_if_quantized

        h = torch.relu(dequantize_if_quantized(self.fc1(x)))
        return dequantize_if_quantized(self.fc2(h))


def qat_model(device=None, generator=None) -> QatMLP:
    """`QatMLP` on ``device`` (default: the GPU) converted by
    `quantize_model`, with 8-bit `LinearQuantizer`s placed by JAX's two
    rules (parameters symmetric, activations asymmetric) and every range set
    to (-3, 3)."""
    from fastforward_tpu_torch import nn as ffnn
    from fastforward_tpu_torch.quant_init import QuantizationConfig

    model = QatMLP(device, generator)
    ffnn.quantize_model(model)
    cfg = QuantizationConfig()
    cfg.add_rule("**/[quantizer:parameter]", ffnn.LinearQuantizer, num_bits=8, symmetric=True)
    cfg.add_rule("**/[quantizer:activation]", ffnn.LinearQuantizer, num_bits=8,
                 symmetric=False)
    cfg.initialize(model)
    dev = model.fc1.weight.device
    for _, q in ffnn.named_quantizers(model):
        if isinstance(q, ffnn.LinearQuantizer):
            q.quantization_range = (torch.tensor(-3.0, device=dev), torch.tensor(3.0, device=dev))
    return model


def qat_step(model: torch.nn.Module, x: torch.Tensor, y: torch.Tensor, lr: float = 1e-3,
             group=None) -> float:
    """One SGD step (lr ``lr``) on the MSE of ``model(x)`` against ``y``,
    without strict quantization. ``x``, ``y``: this rank's equal share of
    the global batch; the gradients (and the reported loss) are averaged
    over ``group`` (default: the world, where a process group exists), so
    every rank takes the global batch's step. Every parameter that requires
    a gradient is updated, as JAX differentiates every float leaf of the
    NNX state: weights, biases, the quantizers' scales and learnable
    offsets. Returns the global loss."""
    from fastforward_tpu_torch import flags

    params = [p for p in model.parameters() if p.requires_grad]
    opt = torch.optim.SGD(params, lr=lr)
    opt.zero_grad()
    with flags.strict_quantization(False):
        loss = torch.mean((model(x) - y) ** 2)
    loss.backward()
    loss = loss.detach()
    if dist.is_available() and dist.is_initialized():
        n = dist.get_world_size(group)
        for t in [p.grad for p in params] + [loss]:
            dist.all_reduce(t, group=group)
            t.div_(n)
    opt.step()
    return float(loss)


def dryrun_multichip(device=None) -> dict:
    """One pass over every parallel path on the ranks of the default process
    group (see the module docstring); ``device``: None for the GPU, or
    "cpu" (gloo CPU ranks). Returns the global shapes; raises on a wrong
    one."""
    from fastforward_tpu_torch.serving.engine import QuantLinear, quantize_linear
    from fastforward_tpu_torch.serving.engine import random_serving_params
    from fastforward_tpu_torch.serving.kv_cache import KVCache
    from fastforward_tpu_torch.serving.moe import expert_parallel_moe, make_moe_block
    from fastforward_tpu_torch.serving.paged import PagedKVCache
    from fastforward_tpu_torch.serving.stacked import StackedKVCache, random_stacked_params

    dev = resolve_device(device)
    n = dist.get_world_size()
    data_size = 2 if n % 2 == 0 and n >= 4 else 1
    # the hybrid (dcn, data, model) mesh of one host, as JAX's one process
    mesh = make_hybrid_mesh({"data": data_size, "model": n // data_size}, num_hosts=1,
                            device_type=dev.type)
    tp = mesh.size(mesh.mesh_dim_names.index("model"))
    config = flagship_config(128 if dev.type == "cuda" else 32)
    L, kv, hd, V = config.num_layers, config.num_kv_heads, config.head_dim, config.vocab_size
    if kv % tp:
        raise ValueError("kv heads must divide TP size")
    shapes = {"mesh": dict(zip(mesh.mesh_dim_names, mesh.shape))}

    # --- serve step: w8a8 weights over "model", the batch over (dcn, data),
    # the sharded INT8 cache
    params = shard_serving_params(random_serving_params(config, "w8a8", seed=0, device=dev), mesh)
    batch = 2 * data_size
    cache = shard_kv_cache(KVCache.create(L, batch, 32, kv, hd, quantized=True, device=dev), mesh)
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, V, (batch, 8))).to(dev)
    logits, cache = sharded_serving_forward(params, config, ids, mesh, cache)
    shapes["serve"] = _expect(_global_rows(logits, mesh, batch_axes(mesh)), (batch, 8, V), "serve")
    del params, cache

    # --- TP decode step (two-level W4A8, explicit all_reduce over "model",
    # the batch over "data")
    params2l, stacked = random_stacked_params(config, "w4a8_2l", group_size=32, seed=1,
                                              device=dev)
    tokens = torch.from_numpy(np.random.RandomState(3).randint(0, V, (batch, 1))).to(dev)
    local_tokens = take_shard(tokens, ("data", None), mesh)

    def slab():
        return StackedKVCache.create(L, batch, 32, kv, hd, quantized=True, device=dev)

    p2, s2, c2 = shard_for_tp(params2l, stacked, slab(), mesh, config=config)
    step = make_tp_decode_step(config, mesh, stacked, params2l, slab())
    tp_logits, _ = step(p2, s2, c2, local_tokens, torch.tensor([0], device=dev))
    shapes["tp"] = _expect(_global_rows(tp_logits, mesh, "data"), (batch, 1, V), "tp step")

    # --- paged KV under TP: pool heads over "model", pages over "data"
    # (each data shard its own allocator over local page ids)
    per = batch // data_size
    paged = PagedKVCache.create(L, data_size * 2 * per, batch, 2, kv, hd, page_size=16,
                                device=dev)
    table = np.asarray([[2 * (b % per), 2 * (b % per) + 1] for b in range(batch)], np.int32)
    paged = dataclasses.replace(paged, table=torch.from_numpy(table).to(dev), length=4)
    p3, s3, c3 = shard_for_tp(params2l, stacked, paged, mesh, config=config)
    paged_step = make_tp_decode_step(config, mesh, stacked, params2l, paged)
    paged_logits, paged_cache = paged_step(p3, s3, c3, local_tokens,
                                           torch.tensor([4], device=dev))
    shapes["paged"] = _expect(_global_rows(paged_logits, mesh, "data"), (batch, 1, V), "paged")
    _expect(paged_cache.k, (L, 2 * per, kv // tp, 16, hd), "paged pool shard")
    shapes["pool"] = tuple(paged.k.shape)

    # --- TP decode loop: 3 greedy steps (the fused-argmax head)
    p4, s4, c4 = shard_for_tp(params2l, stacked, slab(), mesh, config=config)
    loop = make_tp_decode_loop(config, mesh, stacked, params2l, slab(), num_steps=3)
    tp_tokens, _ = loop(p4, s4, c4, local_tokens)
    shapes["loop"] = _expect(_global_rows(tp_tokens, mesh, "data"), (batch, 3), "tp loop")
    del params2l, stacked, p2, s2, c2, p3, s3, c3, p4, s4, c4

    # --- SP: ring attention over a sequence-sharded dim of every rank
    gen = torch.Generator().manual_seed(7)
    qkv = [torch.randn((2, 4, 8 * n, 32), generator=gen).to(dev, torch.bfloat16)
           for _ in range(3)]
    sp_out = context_parallel_attention(make_mesh({"sp": n}, device_type=dev.type), *qkv, "sp")
    shapes["sp"] = _expect(sp_out, tuple(qkv[0].shape), "sp")

    # --- PP: a GPipe pipeline of quantized layers over 2 stages (pairs of
    # ranks, each pair the same pipeline)
    stages = 2 if n % 2 == 0 else 1
    pp_mesh = make_mesh({"rep": n // stages, "stage": stages}, device_type=dev.type)
    gen = torch.Generator().manual_seed(8)
    qls = [quantize_linear((torch.randn((256, 256), generator=gen) / 16.0).to(dev), "w4a8_2l",
                           group_size=128) for _ in range(4)]
    layers = QuantLinear(data=torch.stack([q.data for q in qls]),
                         scale=torch.stack([q.scale for q in qls]), mode="w4a8_2l",
                         group_size=128, mult=torch.stack([q.mult for q in qls]),
                         paired=qls[0].paired)
    x_pp = torch.randn((8, 256), generator=torch.Generator().manual_seed(9)).to(dev)
    pp_out = pipeline_forward(pp_mesh, layers, x_pp,
                              lambda ql, h: ql(h, out_dtype=torch.float32), n_microbatches=4)
    shapes["pp"] = _expect(pp_out, tuple(x_pp.shape), "pp")

    # --- EP: a quantized MoE block, experts over an "expert" dim
    gen = torch.Generator(device=dev).manual_seed(10)
    moe = make_moe_block(gen, 64, 128, 2 * n, "w4a8_2l", 64, top_k=2, device=dev)
    x_ep = torch.randn((4, 64), generator=gen, device=dev).to(torch.bfloat16)
    ep_out = expert_parallel_moe(make_mesh({"expert": n}, device_type=dev.type), moe, x_ep)
    shapes["ep"] = _expect(ep_out, tuple(x_ep.shape), "ep")

    # --- QAT: one data-parallel SGD step through the simulation tier, the
    # global batch split over "data"
    model = qat_model(dev, torch.Generator(device=dev).manual_seed(0))
    x = torch.from_numpy(np.random.RandomState(1).randn(batch, 32).astype(np.float32)).to(dev)
    y = torch.from_numpy(np.random.RandomState(2).randn(batch, 32).astype(np.float32)).to(dev)
    shapes["qat_loss"] = qat_step(model, take_shard(x, ("data", None), mesh),
                                  take_shard(y, ("data", None), mesh))
    if not np.isfinite(shapes["qat_loss"]):
        raise AssertionError(f"dryrun_multichip qat: loss {shapes['qat_loss']}")

    shapes["line"] = (
        f"dryrun_multichip OK: mesh={shapes['mesh']}, serve logits {shapes['serve']}, "
        f"paged-tp logits {shapes['paged']} (pool {shapes['pool']}), tp-decode-loop tokens "
        f"{shapes['loop']}, qat loss {shapes['qat_loss']:.4f}, "
        f"sp {shapes['sp']}, pp {shapes['pp']}, ep {shapes['ep']}")
    if dist.get_rank() == 0:
        print(shapes["line"], flush=True)
    return shapes


def _expect(t: torch.Tensor, shape: tuple, what: str) -> tuple:
    if tuple(t.shape) != tuple(shape):
        raise AssertionError(f"dryrun_multichip {what}: shape {tuple(t.shape)} != {shape}")
    return tuple(shape)
