"""Layer-stacked serving forward, ported from `fastforward_tpu/serving/stacked.py`.

All decoder layers share one shape, so their frozen weights stack along a
leading L axis and the forward is a Python loop over the layer index (the
JAX package's `lax.scan`). The KV cache is one stacked (L, B, Hkv, S, D)
int8 tensor or a paged pool (`serving/paged.py`), written in place: the
prefill writes a block per layer, the decode step appends one row through
the KV-append kernel and attends with the flash-decode kernel (their paged
forms for a pool).

Ported branches (`stacked.py:378-909`), taken under the JAX package's TPU
routing with its default flags: the paged decode step (`:568-589`), the
stacked-KV decode step (`:590-608`), the stacked prefill (`:609-649`) with
the flash-prefill kernel over the just-written cache where the head dim is
a multiple of 128 (plain grouped attention otherwise, as the JAX
package's TPU route does), the no-cache forward, and the fused W4A8 layer
tail (`:744-778`: one call for o_proj through down at B·T <= 64). The
paged step always calls the paged append kernel (any page and head dim)
and the paged flash-decode kernel (any page of a multiple of 4 tokens,
1, 2, 4 or 8 query heads per kv head), also where the JAX package's TPU
tile limits send a shape to its reference; only a head dim other than
128, which the flash-decode kernel cannot run, calls the plain attention
by name. Tensor parallelism and the fused layer head (off by default)
are not ported.
"""

import dataclasses
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from fastforward_tpu_torch.device import resolve_device
from fastforward_tpu_torch.kernels.attention import flash_decode_int8_stacked, flash_prefill
from fastforward_tpu_torch.kernels.kv_update import kv_append_decode_int8_stacked
from fastforward_tpu_torch.kernels.matmul import (
    fused_o_mlp_stacked,
    matmul_w4a8_2l_gemv_argmax,
    quantize_rowwise,
)
from fastforward_tpu_torch.kernels.paged_attention import (
    paged_flash_decode_int8,
    paged_flash_decode_reference,
    paged_kv_append_decode_int8,
)
from fastforward_tpu_torch.kernels.packing import (
    pack_int4_vertical,
    pack_mult_nibbles,
    pack_uint4_offset_paired,
    pack_uint4_offset,
)
from fastforward_tpu_torch.models.llama import LlamaConfig, apply_rope, rope_frequencies
from fastforward_tpu_torch.serving.engine import (
    PORTED_MODES,
    QuantLinear,
    ServingLayer,
    ServingParams,
    _attention_grouped,
    _rms_norm,
)
from fastforward_tpu_torch.serving.kv_cache import NEG_INF, _quantize_kv
from fastforward_tpu_torch.serving.paged import PagedKVCache

# Largest B·T the fused layer tail serves (`stacked.py:744-749`).
FUSED_TAIL_MAX_ROWS = 64


@dataclasses.dataclass
class StackedKVCache:
    """Whole-model INT8 KV cache (L, B, n_kv, S, D) with f32 scales
    (L, B, n_kv, S) (`stacked.py:30`). ``length`` is a host integer."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor
    v_scale: torch.Tensor
    length: int = 0

    @staticmethod
    def create(num_layers, batch_size, max_len, num_kv_heads, head_dim,
               quantized=True, device=None):
        if not quantized:
            raise NotImplementedError(
                "the bf16 KV cache is not ported yet (ROADMAP.md, Queue 1 item 4)"
            )
        dev = resolve_device(device)
        shape = (num_layers, batch_size, num_kv_heads, max_len, head_dim)
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
    (`stacked.py:120`)."""
    if ql.mult is not None and ql.mult_packed is None:
        ql = dataclasses.replace(ql, mult_packed=pack_mult_nibbles(ql.mult))
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


def _rand_nibbles(gen, shape, device):
    return torch.randint(-8, 8, shape, generator=gen, dtype=torch.int8, device=device)


def random_stacked_params(config: LlamaConfig, mode: str = "w4a4_2l",
                          group_size: int = 128, seed: int = 0, device=None):
    """Random (params, stacked_layers) built directly in stacked form
    (`stacked.py:206`), on ``device`` (default: the GPU) from a
    ``torch.Generator`` seeded with ``seed``.

    Same layouts and distributions as the JAX package (uniform int4 grid
    values, multipliers uniform in [1, 15], s_col = 0.25/sqrt(K)/8,
    embedding N(0, 0.02^2) in bf16, unit norms), not the same bits. Layer
    weights are packed one layer at a time so no int8 copy of the whole
    stack exists besides the result. The lm_head is two-level W4A8 in both
    modes.
    """
    if mode not in PORTED_MODES:
        raise NotImplementedError(
            f"random_stacked_params mode {mode!r} is not ported yet (ROADMAP.md, Queue 1 item 5)"
        )
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    h, inter = config.hidden_size, config.intermediate_size
    nh, nkv, d = config.num_heads, config.num_kv_heads, config.head_dim
    L = config.num_layers

    def groups(K):
        return group_size if K % group_size == 0 else K

    def packed(K, N, g, layout):
        if layout == "vertical":
            return pack_int4_vertical(_rand_nibbles(gen, (K, N), dev))
        pack = pack_uint4_offset_paired if layout == "paired" else pack_uint4_offset
        return pack(_rand_nibbles(gen, (K, N), dev), group_size=g)

    def ql(K, N):
        g = groups(K)
        paired = mode == "w4a8_2l" and (K // g) % 2 == 0
        layout = "vertical" if mode == "w4a4_2l" else ("paired" if paired else "halves")
        data = torch.empty((L, K // 2, N), dtype=torch.int8, device=dev)
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
        paired = (K // g) % 2 == 0
        lm_head = QuantLinear(
            packed(K, N, g, "paired" if paired else "halves"),
            torch.full((N,), 0.25 / math.sqrt(K) / 8.0, dtype=torch.float32, device=dev),
            mode="w4a8_2l", group_size=g,
            mult=torch.randint(1, 16, (K // g, N), generator=gen, dtype=torch.int8, device=dev),
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
    blocks in every regime. A per-layer (B, Hkv, S, d) cache is lifted to
    one layer."""
    if kc.dim() == 4:
        kc, ks, vc, vs = kc[None], ks[None], vc[None], vs[None]
        layer = 0
    return flash_decode_int8_stacked(q3, kc, ks, vc, vs, lengths=lengths, layer=layer)


def serving_forward_stacked(
    params: ServingParams,
    stacked_layers,
    config: LlamaConfig,
    input_ids: torch.Tensor,
    cache: Optional[StackedKVCache] = None,
    positions: Optional[torch.Tensor] = None,
    greedy_head: bool = False,
    logits_positions: str = "all",
):
    """Forward over the stacked layers; returns (logits, new_cache), or
    (token ids (B,) int32, new_cache) with ``greedy_head`` (`stacked.py:378`).

    Runs where its tensors are. With a cache, a one-token step appends
    through the KV-append kernel and attends through the flash-decode
    kernel (through the page table for a `PagedKVCache`, which takes
    one-token steps only); a longer step (prefill) writes its block of the
    cache and attends over it through the flash-prefill kernel (head dim a
    multiple of 128; plain grouped attention otherwise). The cache tensors
    are updated in place; the returned cache shares them. A one-token step
    of at most 64 rows over fused paired W4A8 layers runs the layer tail
    (o_proj through down) as one fused kernel.
    ``greedy_head`` with T == 1 and a W4A8 lm_head runs the fused
    GEMV + argmax kernel, so the logits never reach device memory.
    """
    B, T = input_ids.shape
    dev = input_ids.device
    nh, nkv, d = config.num_heads, config.num_kv_heads, config.head_dim
    inv_freq = rope_frequencies(config, device=dev)
    eps = config.rms_norm_eps

    start0 = None  # first cache row this step writes, as a host int
    if positions is None:
        start0 = cache.length if cache is not None else 0
        positions = torch.arange(T, device=dev) + start0

    x = params.embedding[input_ids]
    pos2 = positions if positions.dim() == 2 else positions[None, :]

    paged = isinstance(cache, PagedKVCache)
    if paged and T != 1:
        raise ValueError(
            "PagedKVCache supports decode-shaped (T == 1) forwards; prefill goes "
            "through a contiguous cache + scatter_prefill_to_pages"
        )
    if cache is not None:
        if not cache.is_quantized:
            raise NotImplementedError("only the INT8 stacked KV cache is ported")
        if T > 1 and positions.dim() != 1:
            raise NotImplementedError(
                "prefill with per-row positions takes the slab flow, not ported yet"
            )
        starts = (positions[:, 0] if positions.dim() == 2
                  else positions[0].expand(B)).to(torch.int32).contiguous()
        kc, vc, ks, vs = cache.k, cache.v, cache.k_scale, cache.v_scale
    if cache is not None and T > 1 and start0 is None:
        start0 = int(positions[0])
    flash = cache is not None and T > 1 and d % 128 == 0
    if cache is None or (T > 1 and not flash):
        s_idx = torch.arange(T if cache is None else cache.max_len, device=dev)
        mask = torch.where(
            s_idx[None, None, None, :] <= pos2[:, None, :, None], 0.0, NEG_INF
        ).float()

    def split_heads(t, n):
        return t.reshape(B, T, n, d).transpose(1, 2)

    layer = stacked_layers
    fused = isinstance(layer, FusedServingLayer)
    groups = nh // nkv
    o = layer.o_proj
    fused_tail = (
        T == 1
        and B * T <= FUSED_TAIL_MAX_ROWS
        and fused
        and o.mode == "w4a8_2l"
        and o.paired
        and o.in_scale is None
        and all(p.mult_packed is not None and p.data.dim() == 3
                for p in (o, layer.gateup_proj, layer.down_proj))
    )
    for l in range(config.num_layers):
        h = _rms_norm(x, layer.input_norm[l], eps)
        if fused:
            qkv = layer.qkv_proj.call_layer(h, l)
            q = split_heads(qkv[..., : nh * d], nh)
            k = split_heads(qkv[..., nh * d: (nh + nkv) * d], nkv)
            v = split_heads(qkv[..., (nh + nkv) * d:], nkv)
        else:
            q = split_heads(layer.q_proj.call_layer(h, l), nh)
            k = split_heads(layer.k_proj.call_layer(h, l), nkv)
            v = split_heads(layer.v_proj.call_layer(h, l), nkv)
        q = apply_rope(q, positions, inv_freq)
        k = apply_rope(k, positions, inv_freq)

        if cache is None:
            attn = _attention_grouped(q, k, v, mask)
        elif paged:
            kq8, ksc = _quantize_kv(k)
            vq8, vsc = _quantize_kv(v)
            paged_kv_append_decode_int8(kc, vc, ks, vs, kq8.contiguous(), vq8.contiguous(),
                                        ksc.contiguous(), vsc.contiguous(), starts,
                                        cache.table, l)
            q3 = q[:, :, 0, :].contiguous()
            if d == 128:
                attn = paged_flash_decode_int8(q3, kc, ks, vc, vs, cache.table, starts + 1, l)
            else:
                attn = paged_flash_decode_reference(q3, kc[l], ks[l], vc[l], vs[l], cache.table,
                                                    starts + 1)
            attn = attn[:, :, None, :]
        elif T == 1:
            kq8, ksc = _quantize_kv(k)
            vq8, vsc = _quantize_kv(v)
            kv_append_decode_int8_stacked(
                kc, vc, ks, vs, kq8.contiguous(), vq8.contiguous(),
                ksc.contiguous(), vsc.contiguous(), starts, l,
            )
            attn = flash_decode_select(
                q[:, :, 0, :].contiguous(), kc, ks, vc, vs, lengths=starts + 1, layer=l,
            )[:, :, None, :]
        else:
            kq8, ksc = _quantize_kv(k)
            vq8, vsc = _quantize_kv(v)
            kc[l, :, :, start0:start0 + T] = kq8
            vc[l, :, :, start0:start0 + T] = vq8
            ks[l, :, :, start0:start0 + T] = ksc
            vs[l, :, :, start0:start0 + T] = vsc
            if flash:
                attn = flash_prefill(q.contiguous(), kc[l], ks[l], vc[l], vs[l], starts)
            else:
                k_all = (kc[l].float() * ks[l][..., None]).to(x.dtype)
                v_all = (vc[l].float() * vs[l][..., None]).to(x.dtype)
                attn = _attention_grouped(q, k_all, v_all, mask)
        attn = attn.transpose(1, 2).reshape(B, T, nh * d)
        if fused_tail:
            gu, dn = layer.gateup_proj, layer.down_proj
            x = fused_o_mlp_stacked(
                attn[:, 0, :], x[:, 0, :].contiguous(), layer.post_norm,
                o.data, o.mult_packed, o.scale, gu.data, gu.mult_packed, gu.scale,
                dn.data, dn.mult_packed, dn.scale, l, group_size=o.group_size, eps=eps,
            )[:, None, :]
            continue
        x = x + layer.o_proj.call_layer(attn, l)

        h = _rms_norm(x, layer.post_norm[l], eps)
        if fused:
            gateup = layer.gateup_proj.call_layer(h, l)
            inter = gateup.shape[-1] // 2
            gate, up = gateup[..., :inter], gateup[..., inter:]
            gated = F.silu(gate.float()).to(x.dtype)
            mlp_out = layer.down_proj.call_layer(gated * up, l)
        else:
            gated = F.silu(layer.gate_proj.call_layer(h, l).float()).to(x.dtype)
            mlp_out = layer.down_proj.call_layer(gated * layer.up_proj.call_layer(h, l), l)
        x = x + mlp_out

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


def make_stacked_decode_loop(config: LlamaConfig, num_steps: int):
    """Greedy decode loop over the stacked forward (`stacked.py:912`):
    ``loop(params, stacked_layers, cache, token (B, 1))`` →
    ``(tokens (B, num_steps), cache)``. Each step runs the fused
    GEMV + argmax head; the cache is updated in place."""

    def loop(params, stacked_layers, cache, token):
        out = []
        for _ in range(num_steps):
            tok, cache = serving_forward_stacked(
                params, stacked_layers, config, token, cache, greedy_head=True,
            )
            token = tok.to(token.dtype)[:, None]
            out.append(token[:, 0])
        return torch.stack(out, dim=1), cache

    return loop
