"""Layer-stacked serving forward, ported from `fastforward_tpu/serving/stacked.py`.

All decoder layers share one shape, so their frozen weights stack along a
leading L axis (`stack_serving_layers` stacks per-layer params) and the
forward is a Python loop over the layer index (the JAX package's
`lax.scan`). The KV cache is one stacked (L, B, Hkv, S, D) int8 or bf16
tensor or a paged int8 pool (`serving/paged.py`), written in place: the
prefill writes a block per layer, the int8 decode step appends one row
through the KV-append kernel and attends with the flash-decode kernel
(their paged forms for a pool); a bf16 cache takes its rows by slice
assignment and its decode attends densely, as on the JAX package's TPU
route.

Ported branches (`stacked.py:378-909`), taken under the JAX package's TPU
routing with its default flags: the paged decode step (`:568-589`), the
stacked-KV decode step (`:590-608`), the stacked prefill (`:609-649`) with
the flash-prefill kernel over the just-written cache where the head dim is
a multiple of 128 and the positions are 1-D (plain grouped attention
otherwise, as the JAX package's TPU route does), the bf16 cache
(`:718-735`: flash prefill over bf16 K/V on the same condition), the
no-cache forward, and the fused W4A8 layer
tail (`:744-778`: one call for o_proj through down at B·T <= 64, paired
``w4a8_2l`` only; the float-scale modes take a kernel per projection), and,
under the port's copies of the JAX flags (`fastforward_tpu_torch.flags`,
off by default), the fused layer head (`:509-551`) and the fused o +
gate/up head of the tail (`:779-816`). Under ``FF_2L_PREBLOCK=1``
(read at fuse time) `fuse_stacked_layers` pre-blocks the paired W4A8
weights into panels (`_with_packed_mult`, `:120-146`); their 4-D data
then takes the pre-blocked GEMV and dequant routes and bypasses every
fused route, as in the JAX package. The decode loop is greedy
(``FF_FUSED_ARGMAX``) or sampled (`make_stacked_decode_loop`), and
`unfuse_stacked_layers` splits fused flat layers back. The
paged step always calls the paged append kernel (any page and head dim)
and the paged flash-decode kernel (any page of a multiple of 4 tokens,
1, 2, 4 or 8 query heads per kv head), also where the JAX package's TPU
tile limits send a shape to its reference; only a head dim other than
128, which the flash-decode kernel cannot run, calls the plain attention
by name. ``tp_group`` runs a rank's tensor-parallel shard
(`parallel/tp_serving.py`), as JAX's ``tp_axis`` does.

The JAX slab flow (per-layer cache slabs as scan inputs and outputs) and
the dense attention routes are taken under the JAX package's switches,
read on every call (`stacked_attention_route`): ``FF_KV_STACKED`` other
than "1" or "force", ``FF_KV_WRITE`` other than "kernel" or
``FF_BENCH_FLASH=0`` send a one-token int8 step through the slab flow
(`:650-698`): the layer's own append (the per-layer quantize-and-append
kernel; under ``FF_KV_WRITE=mask`` or any other value a plain-torch select
over S or per-row write), then the per-layer flash decode
(`flash_decode_int8`, `:693-698`) at 2 or more query heads per kv head,
dense attention otherwise or under ``FF_BENCH_FLASH=0``.
``FF_PREFILL_STACKED=0`` writes an int8 prefill's block a sequence at a
time (`:486-493`, the slab flow's per-row ``dynamic_update_slice``):
eagerly the same bytes as the carry's one block write, and no memory of
its own (the JAX carry saves XLA scan temporaries the port never makes).
``FF_FLASH_PREFILL=0`` attends a prefill densely over the layer's
dequantized int8 or bf16 cache (`:634`, `:700-737`). On a slab the
layer's view of the stacked cache is written in place, so the slab flow
is the same loop over the layers.

One decoder layer (`decoder_layer`) and its attention routing
(`layer_attention`) serve this forward and the per-layer
`engine.serving_forward` alike; each forward picks its `AttentionRoute`
once a call by its own JAX conditions (`engine.py:600-646` for the per-layer
one: the one-token int8 append's kernel, the group condition of the flash
decode, the plain prefill at a head dim that is no multiple of 128, no
``FF_KV_WRITE``).
"""

import dataclasses
import functools
import math
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from fastforward_tpu_torch import flags
from fastforward_tpu_torch.device import resolve_device
from fastforward_tpu_torch.kernels.attention import (
    flash_decode_int8,
    flash_decode_int8_stacked,
    flash_prefill,
    flash_prefill_reference,
)
from fastforward_tpu_torch.kernels.kv_update import (
    kv_append_decode_reference,
    kv_quantize_append_stacked,
    quantize_kv,
)
from fastforward_tpu_torch.kernels.matmul import (
    fused_norm_qkv_stacked,
    fused_norm_qkv_stacked_a4,
    fused_o_gu_stacked,
    fused_o_mlp_stacked,
    matmul_w4a8_2l_gemv_argmax,
    paired_default,
    preblock_stacked,
    quantize_rowwise,
)
from fastforward_tpu_torch.kernels.paged_attention import (
    paged_flash_decode_int8,
    paged_flash_decode_reference,
    paged_kv_quantize_append,
)
from fastforward_tpu_torch.kernels.packing import (
    pack_int4,
    pack_int4_vertical,
    pack_mult_nibbles,
    pack_uint4_offset_paired,
    pack_uint4_offset,
)
from fastforward_tpu_torch.models.llama import LlamaConfig, apply_rope, rope_frequencies
from fastforward_tpu_torch.serving.engine import (
    PORTED_MODES,
    SIM_MODES,
    QuantLinear,
    ServingLayer,
    ServingParams,
    _attention_grouped,
    _rms_norm,
)
from fastforward_tpu_torch.serving.kv_cache import (
    LayerKVCache,
    causal_mask,
    row_starts,
    write_rows,
)
from fastforward_tpu_torch.serving.paged import PagedKVCache
from fastforward_tpu_torch.serving.sampling import SamplingParams, sample_logits

# Largest B·T the fused layer tail serves (`stacked.py:744-749`), and the
# fused o + gate/up head of the tail (`stacked.py:782`).
FUSED_TAIL_MAX_ROWS = 64
FUSED_OGU_MAX_ROWS = 256


@dataclasses.dataclass
class StackedKVCache:
    """Whole-model KV cache (L, B, n_kv, S, D): int8 with f32 scales
    (L, B, n_kv, S), or ``dtype`` (bf16) without scales (`stacked.py:30`).
    ``length`` is a host integer."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None
    length: int = 0

    @staticmethod
    def create(num_layers, batch_size, max_len, num_kv_heads, head_dim,
               dtype=torch.bfloat16, quantized=True, device=None):
        dev = resolve_device(device)
        shape = (num_layers, batch_size, num_kv_heads, max_len, head_dim)
        if not quantized:
            return StackedKVCache(k=torch.zeros(shape, dtype=dtype, device=dev),
                                  v=torch.zeros(shape, dtype=dtype, device=dev))
        return StackedKVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=dev),
            v=torch.zeros(shape, dtype=torch.int8, device=dev),
            k_scale=torch.zeros(shape[:4], dtype=torch.float32, device=dev),
            v_scale=torch.zeros(shape[:4], dtype=torch.float32, device=dev),
        )

    @property
    def is_quantized(self) -> bool:
        return self.k.dtype == torch.int8

    @property
    def max_len(self) -> int:
        return self.k.shape[3]


@dataclasses.dataclass
class FusedServingLayer:
    """Stacked layer with q/k/v fused into one projection and gate/up into
    another, concatenated along N (`stacked.py:72`)."""

    qkv_proj: QuantLinear
    o_proj: QuantLinear
    gateup_proj: QuantLinear
    down_proj: QuantLinear
    input_norm: torch.Tensor
    post_norm: torch.Tensor


def _concat_ql(qls) -> QuantLinear:
    """Concatenate QuantLinears along the output (N) axis (`stacked.py:96`)."""
    first = qls[0]
    assert all(q.mode == first.mode and q.group_size == first.group_size for q in qls)
    assert all(q.paired == first.paired for q in qls)
    mult = None
    if first.mult is not None:
        mult = torch.cat([q.mult for q in qls], dim=-1)
    in_scale = None
    if all(q.in_scale is not None for q in qls):
        in_scale = functools.reduce(torch.maximum, [q.in_scale for q in qls])
    return QuantLinear(
        torch.cat([q.data for q in qls], dim=-1),
        torch.cat([q.scale for q in qls], dim=-1),
        mode=first.mode, group_size=first.group_size, mult=mult,
        paired=first.paired, in_scale=in_scale,
    )


def _with_packed_mult(ql: QuantLinear) -> QuantLinear:
    """Attach the nibble-packed multipliers the stacked decode GEMV reads
    (`stacked.py:120`); under ``FF_2L_PREBLOCK=1`` (read here, at fuse
    time) also pre-block paired ``w4a8_2l`` weights into panels of
    ``FF_2L_BLOCK_N`` columns where that width divides N (`:132-145`). The
    layout is carried by the data's rank from then on: 4-D weights take the
    pre-blocked GEMV and dequant routes and bypass the fused routes."""
    if ql.mult is not None and ql.mult_packed is None:
        ql = dataclasses.replace(ql, mult_packed=pack_mult_nibbles(ql.mult))
    if flags.two_level_preblock() and ql.mode == "w4a8_2l" and ql.paired and ql.data.dim() == 3:
        bn = flags.two_level_block_n()
        if ql.data.shape[2] % bn == 0:
            ql = dataclasses.replace(ql, data=preblock_stacked(ql.data, bn))
    return ql


def fuse_stacked_layers(stacked: ServingLayer) -> FusedServingLayer:
    """Fuse a stacked ServingLayer into a FusedServingLayer (`stacked.py:149`)."""
    return FusedServingLayer(
        qkv_proj=_with_packed_mult(
            _concat_ql([stacked.q_proj, stacked.k_proj, stacked.v_proj])
        ),
        o_proj=_with_packed_mult(stacked.o_proj),
        gateup_proj=_with_packed_mult(_concat_ql([stacked.gate_proj, stacked.up_proj])),
        down_proj=_with_packed_mult(stacked.down_proj),
        input_norm=stacked.input_norm,
        post_norm=stacked.post_norm,
    )


def unfuse_stacked_layers(fused: FusedServingLayer, config: LlamaConfig) -> ServingLayer:
    """Inverse of `fuse_stacked_layers` (`stacked.py:165`): q/k/v and
    gate/up split back into their own projections by slicing the N axis
    of every per-column array (packed nibbles, scales and multipliers are
    independent per column); the nibble-packed multipliers are dropped, as
    in the JAX package. Flat layouts only: pre-blocked (L, N//bn, K//2, bn)
    data raises ValueError, where the JAX slice of the last axis would cut
    the bn axis instead of N (`ROADMAP.md` Queue 3)."""
    nh, nkv, d = config.num_heads, config.num_kv_heads, config.head_dim
    inter = config.intermediate_size
    for name in ("qkv_proj", "o_proj", "gateup_proj", "down_proj"):
        if getattr(fused, name).data.dim() == 4:
            raise ValueError(f"unfuse_stacked_layers takes flat (L, K//2, N) weights; {name} is "
                             "pre-blocked (FF_2L_PREBLOCK)")

    def split(ql, sizes):
        outs, n0 = [], 0
        for n in sizes:
            def sl(a, n0=n0, n=n):
                return None if a is None else a[..., n0:n0 + n].contiguous()
            outs.append(dataclasses.replace(ql, data=sl(ql.data), scale=sl(ql.scale),
                                            mult=sl(ql.mult), mult_packed=None))
            n0 += n
        return outs

    q, k, v = split(fused.qkv_proj, [nh * d, nkv * d, nkv * d])
    gate, up = split(fused.gateup_proj, [inter, inter])
    return ServingLayer(
        q_proj=q, k_proj=k, v_proj=v, o_proj=dataclasses.replace(fused.o_proj, mult_packed=None),
        gate_proj=gate, up_proj=up,
        down_proj=dataclasses.replace(fused.down_proj, mult_packed=None),
        input_norm=fused.input_norm, post_norm=fused.post_norm,
    )


def stack_serving_layers(params: ServingParams) -> ServingLayer:
    """Stack per-layer weights along a new leading axis (`stacked.py:67`):
    every tensor of the layers' `ServingLayer`s, each `QuantLinear` field
    included; its static fields (mode, group size, layout) must agree."""

    def stack_ql(qls):
        first = qls[0]
        for f in ("mode", "group_size", "paired"):
            if any(getattr(q, f) != getattr(first, f) for q in qls):
                raise ValueError(f"stack_serving_layers: the layers' {f} differ")
        fields = {}
        for f in ("data", "scale", "mult", "mult_packed", "in_scale"):
            vals = [getattr(q, f) for q in qls]
            if any((v is None) != (vals[0] is None) for v in vals):
                raise ValueError(f"stack_serving_layers: {f} is set in some layers only")
            fields[f] = None if vals[0] is None else torch.stack(vals)
        return QuantLinear(fields["data"], fields["scale"], mode=first.mode,
                           group_size=first.group_size, mult=fields["mult"],
                           paired=first.paired, mult_packed=fields["mult_packed"],
                           in_scale=fields["in_scale"])

    out = {}
    for f in dataclasses.fields(ServingLayer):
        vals = [getattr(layer, f.name) for layer in params.layers]
        out[f.name] = stack_ql(vals) if isinstance(vals[0], QuantLinear) else torch.stack(vals)
    return ServingLayer(**out)


def _rand_nibbles(gen, shape, device):
    return torch.randint(-8, 8, shape, generator=gen, dtype=torch.int8, device=device)


def random_stacked_params(config: LlamaConfig, mode: str = "w4a4_2l",
                          group_size: int = 128, seed: int = 0, device=None):
    """Random (params, stacked_layers) built directly in stacked form
    (`stacked.py:206`), on ``device`` (default: the GPU) from a
    ``torch.Generator`` seeded with ``seed``.

    Same layouts and distributions as the JAX package, not the same bits:
    w8a8 int8 weights uniform in [-127, 127] with per-column scales
    0.02/sqrt(K); w4a8 and w4a16 uniform int4 grid values (`pack_int4`)
    with per-group scales 0.25/sqrt(K); the two-level modes uniform int4
    values, multipliers uniform in [1, 15], s_col = 0.25/sqrt(K)/8; the sim
    tier dense bf16 weights N(0, 1)/sqrt(K) with sim_w8's per-column scales
    0.02/sqrt(K) or sim_w4's per-group 0.25/sqrt(K) (g = K where K % g !=
    0); embedding N(0, 0.02^2) in bf16, unit norms. Two-level W4A8 weights
    (layers and lm_head) pack adjacent groups in pairs where ``FF_2L_PAIRED``
    (read here) is on and the group count is even, else group halves: the
    same nibble values either way, one layout or the other. Layer weights are made
    one layer at a time so no int8 (or f32) copy of the whole stack exists
    besides the result. The lm_head is in the layers' mode, except that
    both two-level modes take a two-level W4A8 head.
    """
    if mode not in PORTED_MODES:
        raise ValueError(f"unknown mode {mode}")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    h, inter = config.hidden_size, config.intermediate_size
    nh, nkv, d = config.num_heads, config.num_kv_heads, config.head_dim
    L = config.num_layers
    two_level = mode in ("w4a4_2l", "w4a8_2l")

    def groups(K):
        return group_size if K % group_size == 0 else K

    def packed(K, N, g, layout):
        if layout == "vertical":
            return pack_int4_vertical(_rand_nibbles(gen, (K, N), dev))
        pack = {"paired": pack_uint4_offset_paired, "halves": pack_uint4_offset,
                "int4": pack_int4}[layout]
        return pack(_rand_nibbles(gen, (K, N), dev), group_size=g)

    def float_scale(shape, K):
        return torch.full(shape, (0.02 if mode in ("w8a8", "sim_w8") else 0.25) / math.sqrt(K),
                          dtype=torch.float32, device=dev)

    def dense(K, N):
        return (torch.randn((K, N), generator=gen, device=dev).to(torch.bfloat16)
                / math.sqrt(K))

    def sim_ql(K, N, lead):
        """A sim-tier projection: ``lead`` (L,) for stacked layers, () for the head."""
        g = groups(K)
        data = torch.empty((*lead, K, N), dtype=torch.bfloat16, device=dev)
        for w in data.view(-1, K, N):
            w.copy_(dense(K, N))
        if mode == "sim_w8":
            return QuantLinear(data, float_scale((*lead, N), K), mode=mode)
        return QuantLinear(data, float_scale((*lead, K // g, N), K), mode=mode, group_size=g)

    def ql(K, N):
        g = groups(K)
        if mode in SIM_MODES:
            return sim_ql(K, N, (L,))
        if mode == "w8a8":
            data = torch.randint(-127, 128, (L, K, N), generator=gen, dtype=torch.int8, device=dev)
            return QuantLinear(data, float_scale((L, N), K), mode=mode)
        data = torch.empty((L, K // 2, N), dtype=torch.int8, device=dev)
        if not two_level:
            for l in range(L):
                data[l] = packed(K, N, g, "int4")
            return QuantLinear(data, float_scale((L, K // g, N), K), mode=mode, group_size=g)
        paired = mode == "w4a8_2l" and paired_default(K // g)
        layout = "vertical" if mode == "w4a4_2l" else ("paired" if paired else "halves")
        for l in range(L):
            data[l] = packed(K, N, g, layout)
        mult = torch.randint(1, 16, (L, K // g, N), generator=gen, dtype=torch.int8, device=dev)
        s_col = torch.full((L, N), 0.25 / math.sqrt(K) / 8.0, dtype=torch.float32, device=dev)
        return QuantLinear(data, s_col, mode=mode, group_size=g, mult=mult, paired=paired)

    stacked = ServingLayer(
        q_proj=ql(h, nh * d),
        k_proj=ql(h, nkv * d),
        v_proj=ql(h, nkv * d),
        o_proj=ql(nh * d, h),
        gate_proj=ql(h, inter),
        up_proj=ql(h, inter),
        down_proj=ql(inter, h),
        input_norm=torch.ones((L, h), dtype=torch.bfloat16, device=dev),
        post_norm=torch.ones((L, h), dtype=torch.bfloat16, device=dev),
    )

    lm_head = None
    if not config.tie_embeddings:
        K, N = h, config.vocab_size
        g = groups(K)
        if mode in SIM_MODES:
            lm_head = sim_ql(K, N, ())
        elif mode == "w8a8":
            lm_head = QuantLinear(
                torch.randint(-127, 128, (K, N), generator=gen, dtype=torch.int8, device=dev),
                float_scale((N,), K), mode=mode,
            )
        elif not two_level:
            lm_head = QuantLinear(packed(K, N, g, "int4"), float_scale((K // g, N), K),
                                  mode=mode, group_size=g)
        else:
            paired = paired_default(K // g)
            lm_head = QuantLinear(
                packed(K, N, g, "paired" if paired else "halves"),
                torch.full((N,), 0.25 / math.sqrt(K) / 8.0, dtype=torch.float32, device=dev),
                mode="w4a8_2l", group_size=g,
                mult=torch.randint(1, 16, (K // g, N), generator=gen, dtype=torch.int8,
                                   device=dev),
                paired=paired,
            )
    embedding = (
        torch.randn((config.vocab_size, h), generator=gen, device=dev) * 0.02
    ).to(torch.bfloat16)
    params = ServingParams(
        embedding=embedding,
        layers=(),  # stacked form only
        final_norm=torch.ones((h,), dtype=torch.bfloat16, device=dev),
        lm_head=lm_head,
    )
    return params, stacked


def flash_decode_select(q3, kc, ks, vc, vs, lengths, layer):
    """The one flash-decode dispatch (`stacked.py:304`). The JAX package
    picks among ragged, bucketed and whole-slab kernels by slab size; they
    compute one function, and the port's single kernel reads only the live
    blocks in every regime. A per-layer (B, Hkv, S, d) cache (the per-layer
    forward's) is lifted to the same kernel at L = 1, layer 0, as the JAX
    dispatch lifts it (`stacked.py:333-335`), and counted under
    ``flash_decode_layer``."""
    if kc.dim() == 4:
        return flash_decode_int8_stacked(q3, kc[None], ks[None], vc[None], vs[None], lengths, 0,
                                         count="flash_decode_layer")
    return flash_decode_int8_stacked(q3, kc, ks, vc, vs, lengths=lengths, layer=layer)


@dataclasses.dataclass
class LayerWeights:
    """One decoder layer's weights as `decoder_layer` reads them: a
    per-layer `ServingLayer` (``index`` None), or layer ``index`` of stacked
    layers, unfused or fused (`FusedServingLayer`), whose projections take
    the index into their kernels (`QuantLinear.call_layer`)."""

    layer: object
    index: Optional[int] = None

    def proj(self, name: str, t: torch.Tensor, **kw) -> torch.Tensor:
        ql = getattr(self.layer, name)
        return ql(t, **kw) if self.index is None else ql.call_layer(t, self.index, **kw)

    def norm(self, name: str) -> torch.Tensor:
        w = getattr(self.layer, name)
        return w if self.index is None else w[self.index]

    def qkv(self, h: torch.Tensor, q_width: int, kv_width: int):
        if isinstance(self.layer, FusedServingLayer):
            qkv = self.proj("qkv_proj", h)
            return (qkv[..., :q_width], qkv[..., q_width:q_width + kv_width],
                    qkv[..., q_width + kv_width:])
        return tuple(self.proj(n, h) for n in ("q_proj", "k_proj", "v_proj"))

    def gate_up(self, h: torch.Tensor):
        if isinstance(self.layer, FusedServingLayer):
            gateup = self.proj("gateup_proj", h)
            inter = gateup.shape[-1] // 2
            return gateup[..., :inter], gateup[..., inter:]
        return self.proj("gate_proj", h), self.proj("up_proj", h)


@dataclasses.dataclass(frozen=True)
class AttentionRoute:
    """How a forward call's layers write their K/V into the cache and
    attend, chosen once a call under the JAX package's conditions (TPU
    routing; `stacked_attention_route`, `layer_attention_route`) and taken
    by `layer_attention` in every layer.

    ``write``: "none" (no cache); "paged", the paged quantize-and-append
    kernel; "stacked", the stacked one at the layer; "cache",
    `LayerKVCache.write` on the layer's slab (an int8 token through the
    per-layer quantize-and-append kernel, a block at once); "rows", the same
    with a block written a sequence at a time; "mask" and "scatter", an int8
    token quantized and written in plain torch, by a select over the slab's
    S rows or by a write at each row's start (both write nothing outside
    [0, S)).
    ``attend``: "dense", masked grouped attention over this step's K/V or
    the layer's dequantized cache; "paged", the paged flash decode;
    "select", `flash_decode_select`; "layer", the per-layer flash decode
    (`flash_decode_int8`); "prefill", `flash_prefill` over the layer's
    cache (its plain version by name at a head dim that is no multiple of
    128)."""

    write: str
    attend: str


NO_CACHE = AttentionRoute("none", "dense")


def stacked_attention_route(cache, T: int, positions: torch.Tensor, groups: int,
                            d: int) -> AttentionRoute:
    """The stacked forward's route (`stacked.py:450-493`, `:566-742`),
    reading ``FF_KV_WRITE``, ``FF_KV_STACKED``, ``FF_PREFILL_STACKED``,
    ``FF_BENCH_FLASH`` and ``FF_FLASH_PREFILL`` now. An int8 token step
    takes the stacked append and `flash_decode_select` (the stacked KV
    carry) under the defaults; ``FF_KV_STACKED`` other than "1" or "force"
    (the TPU test read as true makes the two one), ``FF_KV_WRITE`` other
    than "kernel" or ``FF_BENCH_FLASH=0`` take the slab flow: the write
    ``FF_KV_WRITE`` names, then the per-layer flash decode at 2 or more
    query heads per kv head under ``FF_BENCH_FLASH``, dense attention
    otherwise. An int8 prefill writes its block at once with 1-D positions
    under ``FF_PREFILL_STACKED`` (the carry), else a sequence at a time;
    every prefill with 1-D positions at a head dim that is a multiple of
    128 takes `flash_prefill` under ``FF_FLASH_PREFILL``, dense attention
    otherwise."""
    if cache is None:
        return NO_CACHE
    if isinstance(cache, PagedKVCache):
        return AttentionRoute("paged", "paged")
    flat = positions.dim() == 1
    prefill = "prefill" if flat and flags.use_flash_prefill() and d % 128 == 0 else "dense"
    if not cache.is_quantized:
        return AttentionRoute("cache", prefill if T > 1 else "dense")
    if T > 1:
        return AttentionRoute("cache" if flat and flags.prefill_stacked() else "rows", prefill)
    kv_write = flags.kv_write_mode()
    flash = flags.use_flash_attention()
    if kv_write == "kernel" and flash and flags.kv_stacked_mode() in ("1", "force"):
        return AttentionRoute("stacked", "select")
    return AttentionRoute({"kernel": "cache", "mask": "mask"}.get(kv_write, "scatter"),
                          "layer" if groups >= 2 and flash else "dense")


def layer_attention_route(cache, T: int, positions: torch.Tensor, groups: int) -> AttentionRoute:
    """The per-layer forward's route (`engine.py:600-646`), reading
    ``FF_FLASH_PREFILL`` and ``FF_BENCH_FLASH`` now: the cache's own write;
    a prefill with 1-D positions through `flash_prefill` under
    ``FF_FLASH_PREFILL`` (at any head dim: no TPU term in the JAX
    condition), an int8 token step with at least 2 query heads per kv head
    through `flash_decode_select` under ``FF_BENCH_FLASH``; dense attention
    otherwise. ``FF_KV_WRITE`` is the stacked forward's only, as in JAX."""
    if cache is None:
        return NO_CACHE
    if T > 1 and positions.dim() == 1 and flags.use_flash_prefill():
        return AttentionRoute("cache", "prefill")
    if (T == 1 and cache.layer(0).is_quantized and groups >= 2
            and flags.use_flash_attention()):
        return AttentionRoute("cache", "select")
    return AttentionRoute("cache", "dense")


def _append_plain(lc: LayerKVCache, k, v, starts, how: str) -> None:
    """The slab flow's one-token int8 append in plain torch, in place
    (`stacked.py:653-687`): k, v quantized by `quantize_kv`, then "mask" a
    select over the S rows (`kv_append_decode_reference`, the K/V bytes and
    the first scale column) or "scatter" a write at each row's start
    (`write_rows`). A start outside [0, S) writes nothing in both; JAX's
    scatter (``dynamic_update_slice``) would clamp it to row 0 or S - 1
    (`ROADMAP.md` Queue 3)."""
    (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
    bufs = (lc.k, lc.v, lc.k_scale, lc.v_scale)
    if how == "mask":
        for buf, new in zip(bufs, kv_append_decode_reference(*bufs, kq, vq, ks, vs, starts)):
            buf.copy_(new)
        return
    for buf, new in zip(bufs, (kq, vq, ks, vs)):
        write_rows(buf, new, starts)


def layer_attention(q, k, v, cache, layer, positions, starts, rows, mask,
                    route: AttentionRoute):
    """One decoder layer's attention with this step's q (B, H, T, d) and
    k, v (B, Hkv, T, d) by ``route`` (`AttentionRoute`, chosen once a call
    by the forward: `stacked_attention_route`, `layer_attention_route`);
    both forwards call it (`engine.py:600-646`, `stacked.py:566-742`).

    ``cache`` None: dense grouped attention over k, v under ``mask``.
    Otherwise k, v are written into the cache in place (rows from
    ``starts`` / ``rows``, see `LayerKVCache.write`) and the step attends
    over it; ``cache`` is a per-layer `LayerKVCache`, or a `StackedKVCache`
    or `PagedKVCache` at layer ``layer``:
    - paged (one-token steps): the paged append kernel (the K/V quantizer
      fused into it: `paged_kv_quantize_append`), then the paged
      flash-decode kernel (its plain version by name at a head dim other
      than 128);
    - int8, one token: the append kernel with the K/V quantizer fused into
      it (stacked, or per layer under its own count), or the slab flow's
      plain-torch mask or scatter write; then `flash_decode_select` (the
      stacked decode step; the per-layer forward at 2 or more query heads
      per kv head), the per-layer `flash_decode_int8` (the stacked slab
      flow), or dense attention;
    - a block: `flash_prefill` over the layer's just-written int8 or bf16
      K/V (a per-layer cache at a head dim that is no multiple of 128
      takes its plain version by name, as JAX's `flash_prefill` does,
      `attention.py:998`), or dense attention;
    - dense: grouped attention over the layer's (dequantized) cache under
      ``mask``.
    """
    d = q.shape[3]
    if cache is None:
        return _attention_grouped(q, k, v, mask)
    if route.write == "paged":
        kc, vc, ks, vs = cache.k, cache.v, cache.k_scale, cache.v_scale
        paged_kv_quantize_append(kc, vc, ks, vs, k, v, starts, cache.table, layer)
        q3 = q[:, :, 0, :].contiguous()
        if d == 128:
            attn = paged_flash_decode_int8(q3, kc, ks, vc, vs, cache.table, starts + 1, layer)
        else:
            attn = paged_flash_decode_reference(q3, kc[layer], ks[layer], vc[layer], vs[layer],
                                                cache.table, starts + 1)
        return attn[:, :, None, :]
    if isinstance(cache, LayerKVCache):
        lc = cache
    else:
        lc = LayerKVCache(cache.k[layer], cache.v[layer],
                          *(None if s is None else s[layer] for s in (cache.k_scale, cache.v_scale)))
    if route.write == "stacked":
        kv_quantize_append_stacked(cache.k, cache.v, cache.k_scale, cache.v_scale, k, v, starts,
                                   layer)
    elif route.write in ("mask", "scatter"):
        _append_plain(lc, k, v, starts, route.write)
    else:
        lc.write(k, v, starts, rows, per_row=route.write == "rows")
    if route.attend == "select":
        return flash_decode_select(q[:, :, 0, :].contiguous(), cache.k, cache.k_scale, cache.v,
                                   cache.v_scale, lengths=starts + 1, layer=layer)[:, :, None, :]
    if route.attend == "layer":
        return flash_decode_int8(q[:, :, 0, :].contiguous(), lc.k, lc.k_scale, lc.v, lc.v_scale,
                                 starts + 1)[:, :, None, :]
    if route.attend == "prefill":
        k_all, v_all = lc.k, lc.v
        if not lc.is_quantized:
            k_all, v_all = k_all.to(q.dtype), v_all.to(q.dtype)
        prefill = flash_prefill if d % 128 == 0 else flash_prefill_reference
        return prefill(q.contiguous(), k_all, lc.k_scale, v_all, lc.v_scale, starts)
    k_all, v_all = lc.read(dtype=q.dtype)
    return _attention_grouped(q, k_all.to(q.dtype), v_all.to(q.dtype), mask)


def tp_all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``group`` (JAX's ``psum`` over the
    model axis): bf16 partials are summed in f32 and rounded once, as XLA's
    CPU all-reduce of bf16 does (a ring of bf16 adds rounds at every hop);
    others in their own dtype."""
    acc = t.float() if t.dtype == torch.bfloat16 else t.clone()
    dist.all_reduce(acc, group=group)
    return acc.to(t.dtype)


def _row_parallel(weights: LayerWeights, name: str, t: torch.Tensor, tp_group, tp_exact: bool):
    """A row-parallel projection of this rank's K shard ``t``, summed over
    ``tp_group``. Megatron (`tp_exact` False, JAX's shard_map TP): each
    shard quantizes its rows by their own amax, and the bf16 outputs are
    summed (`tp_all_reduce`). The single-device function (`tp_exact`, the
    GSPMD placement of `parallel/sharding.py`): every shard quantizes by the
    whole row's amax (an all_reduce MAX), and the f32 partial products are
    summed before the output's one rounding."""
    if tp_group is None:
        return weights.proj(name, t)
    if not tp_exact:
        return tp_all_reduce(weights.proj(name, t), tp_group)
    amax = t.float().abs().amax(dim=-1)
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=tp_group)
    out = weights.proj(name, t, out_dtype=torch.float32, row_amax=amax)
    dist.all_reduce(out, group=tp_group)
    return out.to(t.dtype)


def decoder_layer(x, weights: LayerWeights, config: LlamaConfig, positions, inv_freq, cache,
                  starts, rows, mask, route: AttentionRoute, fused_head: bool = False,
                  tail: Optional[str] = None, tp_group=None, tp_exact: bool = False):
    """One decoder layer (`engine.py:592-652`, `stacked.py:495-816`), for
    both forwards: RMSNorm, the q/k/v projections, RoPE, `layer_attention`
    over ``cache`` (at ``weights.index`` for a stacked cache), o_proj and
    the residual, RMSNorm, the gated MLP and the residual; ``route`` is the
    forward's `AttentionRoute`. The fused routes
    of stacked `FusedServingLayer`s at one token (`serving_forward_stacked`
    picks them): ``fused_head``, the input RMSNorm and the qkv projection as
    one kernel (paired W4A8 or W4A4); ``tail`` "fused_tail", o_proj through
    down_proj as one kernel, or "fused_ogu", o_proj through gate/up as one
    kernel with SiLU and down_proj after it (paired W4A8). ``tp_group``:
    this rank holds a tensor-parallel shard (its heads, its MLP columns,
    its K rows of o_proj and down_proj; ``config`` the local head counts),
    and o_proj's and the MLP's outputs are summed over the group
    (`_row_parallel`): with ``tp_exact`` (the per-layer `serving_forward`)
    as the single-device function, else (`serving_forward_stacked`) as
    JAX's shard_map TP."""
    B, T, _ = x.shape
    nh, nkv, d = config.num_heads, config.num_kv_heads, config.head_dim
    eps = config.rms_norm_eps
    if fused_head:
        qp = weights.layer.qkv_proj
        head = fused_norm_qkv_stacked_a4 if qp.mode == "w4a4_2l" else fused_norm_qkv_stacked
        qkv = head(x[:, 0, :].contiguous(), weights.layer.input_norm, qp.data, qp.mult_packed,
                   qp.scale, weights.index, group_size=qp.group_size, eps=eps)[:, None, :]
        qkv = (qkv[..., :nh * d], qkv[..., nh * d:(nh + nkv) * d], qkv[..., (nh + nkv) * d:])
    else:
        qkv = weights.qkv(_rms_norm(x, weights.norm("input_norm"), eps), nh * d, nkv * d)
    q, k, v = (t.reshape(B, T, n, d).transpose(1, 2) for t, n in zip(qkv, (nh, nkv, nkv)))
    q = apply_rope(q, positions, inv_freq)
    k = apply_rope(k, positions, inv_freq)
    attn = layer_attention(q, k, v, cache, weights.index, positions, starts, rows, mask, route)
    attn = attn.transpose(1, 2).reshape(B, T, nh * d)
    layer, l = weights.layer, weights.index
    if tail == "fused_tail":
        o, gu, dn = layer.o_proj, layer.gateup_proj, layer.down_proj
        return fused_o_mlp_stacked(
            attn[:, 0, :], x[:, 0, :].contiguous(), layer.post_norm,
            o.data, o.mult_packed, o.scale, gu.data, gu.mult_packed, gu.scale,
            dn.data, dn.mult_packed, dn.scale, l, group_size=o.group_size, eps=eps,
        )[:, None, :]
    if tail == "fused_ogu":
        o, gup = layer.o_proj, layer.gateup_proj
        x1, gu = fused_o_gu_stacked(
            attn[:, 0, :], x[:, 0, :].contiguous(), layer.post_norm,
            o.data, o.mult_packed, o.scale, gup.data, gup.mult_packed, gup.scale,
            l, group_size=o.group_size, eps=eps,
        )
        inter = gu.shape[-1] // 2
        gate, up = gu[:, :inter].float(), gu[:, inter:].float()
        # jax.nn.silu written out: F.silu rounds otherwise in float32
        gated = (gate * torch.sigmoid(gate) * up).to(x.dtype)
        mlp_out = weights.proj("down_proj", gated[:, None, :])
        return (x1[:, None, :] + mlp_out.float()).to(x.dtype)
    x = x + _row_parallel(weights, "o_proj", attn, tp_group, tp_exact)
    h = _rms_norm(x, weights.norm("post_norm"), eps)
    gate, up = weights.gate_up(h)
    return x + _row_parallel(weights, "down_proj", F.silu(gate.float()).to(x.dtype) * up,
                             tp_group, tp_exact)


def serving_forward_stacked(
    params: ServingParams,
    stacked_layers,
    config: LlamaConfig,
    input_ids: torch.Tensor,
    cache: Optional[StackedKVCache] = None,
    positions: Optional[torch.Tensor] = None,
    greedy_head: bool = False,
    logits_positions: str = "all",
    tp_group=None,
):
    """Forward over the stacked layers; returns (logits, new_cache), or
    (token ids (B,) int32, new_cache) with ``greedy_head`` (`stacked.py:378`).

    Runs where its tensors are. With an int8 cache, a one-token step
    appends through the KV-append kernel and attends through the
    flash-decode kernel (through the page table for a `PagedKVCache`, which
    takes one-token steps only); a longer step (prefill) writes its block
    of the cache and attends over it through the flash-prefill kernel
    (1-D positions and a head dim that is a multiple of 128; plain grouped
    attention otherwise). A bf16 cache takes its rows as they are; its
    prefill runs the same flash-prefill kernel over bf16 K/V, its decode
    step dense grouped attention. These are the default routes of
    `stacked_attention_route`; ``FF_KV_STACKED``, ``FF_KV_WRITE``,
    ``FF_PREFILL_STACKED``, ``FF_BENCH_FLASH`` and ``FF_FLASH_PREFILL``
    (read on each call) take the slab flow's writes and per-layer flash
    decode or dense attention in their place. The cache tensors are updated in place;
    the returned cache shares them. A one-token step
    of at most 64 rows over fused paired W4A8 layers runs the layer tail
    (o_proj through down) as one fused kernel (``FF_FUSED_LAYER``, on by
    default). Off by default (`fastforward_tpu_torch.flags`, read on each
    call): ``FF_FUSED_QKV=1``, the fused layer head of a one-token step over
    fused paired W4A8 or W4A4 layers; ``FF_FUSED_OGU=1``, o_proj through
    gate/up as one kernel where the fused tail is not taken, up to 256 rows
    of paired W4A8.
    ``greedy_head`` with T == 1 and a two-level W4A8 lm_head runs the fused
    GEMV + argmax kernel, so the logits never reach device memory; another
    lm_head (w8a8, w4a8, w4a16) computes f32 logits and takes their argmax
    (`stacked.py:903-908`).
    ``tp_group`` (JAX's ``tp_axis``, `stacked.py:385`): the layers, the
    cache and ``config`` are this rank's tensor-parallel shard
    (`parallel/tp_serving.py`); o_proj's and the MLP's outputs are summed
    over the group, and the fused head and tail are not taken (`:511`,
    `:750`, `:783`). The lm_head is replicated.
    """
    B, T = input_ids.shape
    dev = input_ids.device
    inv_freq = rope_frequencies(config, device=dev)
    eps = config.rms_norm_eps

    if positions is None:
        positions = torch.arange(T, device=dev) + (cache.length if cache is not None else 0)

    x = params.embedding[input_ids]
    if isinstance(cache, PagedKVCache) and T != 1:
        raise ValueError(
            "PagedKVCache supports decode-shaped (T == 1) forwards; prefill goes "
            "through a contiguous cache + scatter_prefill_to_pages"
        )
    starts = rows = None
    if cache is not None:
        starts = row_starts(positions, B)
        rows = starts if T == 1 else starts.tolist()
    mask = causal_mask(positions, T if cache is None else cache.max_len)
    route = stacked_attention_route(cache, T, positions, config.num_heads // config.num_kv_heads,
                                    config.head_dim)

    layer = stacked_layers
    fused = T == 1 and isinstance(layer, FusedServingLayer) and tp_group is None
    qp, o = layer.qkv_proj if fused else None, layer.o_proj
    fused_head = (
        fused
        and ((qp.mode == "w4a8_2l" and qp.paired) or qp.mode == "w4a4_2l")
        and qp.mult_packed is not None
        and qp.in_scale is None
        and qp.data.dim() == 3
        and flags.fused_qkv()
    )
    paired_o = (fused and o.mode == "w4a8_2l" and o.paired and o.mult_packed is not None
                and o.in_scale is None and o.data.dim() == 3)
    tail = None
    if (paired_o and B * T <= FUSED_TAIL_MAX_ROWS
            and all(p.mult_packed is not None and p.data.dim() == 3
                    for p in (layer.gateup_proj, layer.down_proj))
            and flags.fused_layer()):
        tail = "fused_tail"
    elif paired_o and B * T <= FUSED_OGU_MAX_ROWS and layer.gateup_proj.data.dim() == 3 \
            and flags.fused_ogu():
        tail = "fused_ogu"
    for l in range(config.num_layers):
        x = decoder_layer(x, LayerWeights(layer, l), config, positions, inv_freq, cache, starts,
                          rows, mask, route, fused_head=fused_head, tail=tail, tp_group=tp_group)

    new_cache = None
    if cache is not None:
        new_cache = dataclasses.replace(cache, length=cache.length + T)

    x = _rms_norm(x, params.final_norm, eps)
    if isinstance(logits_positions, str):
        if logits_positions == "last":
            x = x[:, -1:, :]
    else:
        x = torch.take_along_dim(
            x, torch.as_tensor(logits_positions, device=dev)[:, None, None], dim=1
        )
    lm = params.lm_head
    if greedy_head and T == 1 and lm is not None and lm.mode == "w4a8_2l":
        x_q, x_s = quantize_rowwise(x.reshape(B, -1))
        tok = matmul_w4a8_2l_gemv_argmax(
            x_q, x_s, lm.data, lm.mult, lm.scale,
            group_size=lm.group_size, paired=lm.paired,
        )
        return tok, new_cache
    if lm is not None:
        logits = lm(x, out_dtype=torch.float32)
    else:
        logits = torch.einsum("bth,vh->btv", x, params.embedding).float()
    if greedy_head:
        return torch.argmax(logits[:, -1], dim=-1).to(torch.int32), new_cache
    return logits, new_cache


def make_stacked_decode_loop(config: LlamaConfig, num_steps: int, sampling=None):
    """Decode loop over the stacked forward (`stacked.py:912`); the cache is
    updated in place.

    Greedy by default: ``loop(params, stacked_layers, cache, token (B, 1))``
    → ``(tokens (B, num_steps), cache)``. Under ``FF_FUSED_ARGMAX`` (on by
    default, read here, when the loop is made) each step runs the greedy
    head (the fused GEMV + argmax kernel for a two-level W4A8 lm_head);
    with it off, f32 logits and their argmax (`:928-954`). With a
    `SamplingParams` of ``temperature > 0`` the loop takes a trailing
    ``torch.Generator`` and draws each token from the last position's f32
    logits through `sample_logits` (`:956-968`):
    ``loop(params, stacked_layers, cache, token, generator)``."""
    sampling = sampling or SamplingParams(temperature=0.0)

    if sampling.is_greedy:
        fused_argmax = flags.fused_argmax()

        def loop(params, stacked_layers, cache, token):
            out = []
            for _ in range(num_steps):
                tok, cache = serving_forward_stacked(
                    params, stacked_layers, config, token, cache, greedy_head=fused_argmax,
                )
                if not fused_argmax:
                    tok = torch.argmax(tok[:, -1], dim=-1)
                token = tok.to(token.dtype)[:, None]
                out.append(token[:, 0])
            return torch.stack(out, dim=1), cache

        return loop

    def loop_sampled(params, stacked_layers, cache, token, generator):
        out = []
        for _ in range(num_steps):
            logits, cache = serving_forward_stacked(params, stacked_layers, config, token, cache)
            token = sample_logits(logits[:, -1], sampling, generator).to(token.dtype)[:, None]
            out.append(token[:, 0])
        return torch.stack(out, dim=1), cache

    return loop_sampled
