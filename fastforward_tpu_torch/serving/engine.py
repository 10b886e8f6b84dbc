"""Frozen quantized linear layers, the per-layer serving forward and its
greedy decode loop, ported from `fastforward_tpu/serving/engine.py`.

The port serves bench.py's modes: the two two-level int4 modes ``w4a4_2l``
(decoder projections) and ``w4a8_2l`` (the lm_head of both, and the
decoder projections of ``FF_BENCH_MODE=w4a8_2l``), and the float-scale
modes ``w8a8``, ``w4a8`` and ``w4a16`` (``FF_BENCH_MODE=w8a8|w4a8|w4a16``,
lm_head in the layers' mode). The routing is the JAX package's TPU
routing on every device (its ``_on_tpu()`` read as true): up to
`GEMV_MAX_M` rows take the decode GEMVs (W8A8: its GEMM at any size); more
rows (prefill) dequantize the weight to bf16 and take a dense product with
f32 accumulation. Only the kernel wrappers look at the device. The
baseline tier's ``sim_w8`` and ``sim_w4`` (bench.py's baseline) keep dense
bf16 weights and quantize-dequantize them in f32 on every use before one
bf16 product (`sim_weight`), as the JAX package does outside any kernel;
`quantize_linear` and `random_serving_params` take the packed modes only,
as the JAX functions do.

`serving_forward` runs a per-layer `ServingParams` (a tuple of
`ServingLayer`) over a per-layer `KVCache` (`serving/kv_cache.py`), int8
or bf16, with the JAX package's TPU routing of attention
(`engine.py:600-646`): a one-token step over an int8 cache with at least
2 query heads per kv head goes through `flash_decode_select` (the
flash-decode kernel at L = 1); a prefill with 1-D positions through
`flash_prefill` (its kernel at a head dim that is a multiple of 128, its
plain version by name otherwise); everything else through dense grouped
attention over the dequantized cache, as do the decode step under
``FF_BENCH_FLASH=0`` and the prefill under ``FF_FLASH_PREFILL=0`` (read
on each call, `serving/stacked.py` `layer_attention_route`). Its layer is
`serving/stacked.py`'s `decoder_layer`, which the layer-stacked forward
runs too.
"""

import dataclasses
import math
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from fastforward_tpu_torch.kernels.matmul import (
    GEMV_MAX_M,
    convert_two_level,
    convert_two_level_a4,
    dequantize_int4,
    dequantize_int4_paired_stacked,
    dequantize_int4_vertical,
    dequantize_int4_vertical_stacked,
    flat_layer,
    matmul_w4a4_2l_gemv,
    matmul_w4a4_2l_gemv_stacked,
    matmul_w4a8,
    matmul_w4a8_2l_gemv,
    matmul_w4a8_2l_gemv_stacked,
    matmul_w4a16,
    matmul_w8a8,
    paired_default,
    prefill_product,
    quantize_rowwise,
    quantize_rowwise_a4,
)
from fastforward_tpu_torch.kernels.packing import (
    pack_int4,
    pack_int4_vertical,
    pack_uint4_offset,
    unpack_uint4_offset_paired,
)
from fastforward_tpu_torch.device import resolve_device
from fastforward_tpu_torch.models.llama import LlamaConfig, rope_frequencies
from fastforward_tpu_torch.serving.kv_cache import KVCache, causal_mask, row_starts

PACKED_MODES = ("w4a4_2l", "w4a8_2l", "w8a8", "w4a8", "w4a16")
SIM_MODES = ("sim_w8", "sim_w4")
PORTED_MODES = PACKED_MODES + SIM_MODES


def sim_weight(data: torch.Tensor, scale: torch.Tensor, mode: str,
               group_size: int) -> torch.Tensor:
    """The fake-quantized f32 weight of the sim tier (`engine.py:144-158`):
    dense ``data`` (K, N) in f32, ``w / scale`` (a true division), rounded
    half to even, clipped to [-128, 127] (``sim_w8``, scale (N,) per column)
    or [-8, 7] (``sim_w4``, scale (K//g, N) per group), times the scale."""
    w = data.float()
    if mode == "sim_w8":
        q = torch.clamp(torch.round(w / scale[None, :]), -128, 127)
        return q * scale[None, :]
    K = w.shape[0]
    wg = w.reshape(K // group_size, group_size, -1)
    q = torch.clamp(torch.round(wg / scale[:, None, :]), -8, 7)
    return (q * scale[:, None, :]).reshape(K, -1)


def quantize_static(x2: torch.Tensor, scale: torch.Tensor):
    """Static symmetric int8 activation quantization on a calibrated
    per-tensor grid (`engine.py:278`): (x_q int8, the scale per row), the
    contract of `quantize_rowwise`. The scale is a runtime value, so XLA
    keeps the division (no reciprocal multiply), and so does the port."""
    sc = scale.float().reshape(())
    x_q = torch.clamp(torch.round(x2.float() / sc), -127, 127).to(torch.int8)
    return x_q, sc.reshape(1).expand(x2.shape[0]).contiguous()


@dataclasses.dataclass
class QuantLinear:
    """Frozen quantized linear weights, layout (in, out) (`engine.py:54`).

    ``data`` int8 (K, N) for w8a8, packed int8 (K//2, N) for the int4
    modes, or (L, ...) stacked; ``scale`` per column (N,) for w8a8 and the
    two-level modes (their ``s_col``), per group (K//g, N) for w4a8 and
    w4a16; ``mult`` two-level per-group multipliers (K//g, N) int8;
    ``mult_packed`` their nibble-packed form for the stacked decode GEMVs;
    ``paired`` the two-level W4A8 adjacent-group layout; ``in_scale`` a
    calibrated per-tensor input scale ((L,) stacked) for the int8-activation
    modes, in place of the dynamic per-row one.
    """

    data: torch.Tensor
    scale: torch.Tensor
    mode: str = "w4a4_2l"
    group_size: int = 128
    mult: Optional[torch.Tensor] = None
    paired: bool = False
    mult_packed: Optional[torch.Tensor] = None
    in_scale: Optional[torch.Tensor] = None

    def _check(self) -> None:
        if self.mode not in PORTED_MODES:
            raise ValueError(f"unknown mode {self.mode}")

    def _quantize_input(self, x2, in_scale, row_amax=None):
        if in_scale is not None:
            return quantize_static(x2, in_scale)
        return quantize_rowwise(x2, row_amax)

    def __call__(self, x: torch.Tensor, out_dtype=torch.bfloat16,
                 row_amax: Optional[torch.Tensor] = None) -> torch.Tensor:
        """y = x @ W with the mode's kernel (`engine.py:85`). x: (..., K).
        ``row_amax`` (rows of x,): the absolute maximum each activation row
        is quantized by, in place of its own (a row-parallel shard of the
        sharded forward, `parallel/sharding.py`)."""
        self._check()
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        if row_amax is not None:
            row_amax = row_amax.reshape(-1)
        decode = x2.shape[0] <= GEMV_MAX_M
        g = self.group_size
        if self.mode == "w8a8":
            x_q, x_s = self._quantize_input(x2, self.in_scale, row_amax)
            out = matmul_w8a8(x_q, x_s, self.data, self.scale, out_dtype=out_dtype)
        elif self.mode == "w4a8":
            x_q, x_s = self._quantize_input(x2, self.in_scale, row_amax)
            out = matmul_w4a8(x_q, x_s, self.data, self.scale, group_size=g, out_dtype=out_dtype)
        elif self.mode == "w4a16":
            out = matmul_w4a16(x2.to(torch.bfloat16), self.data, self.scale, group_size=g,
                               out_dtype=out_dtype)
        elif self.mode in SIM_MODES:
            # the plain large product JAX computes outside any kernel: bf16 in, bf16 out
            w = sim_weight(self.data, self.scale, self.mode, g).to(torch.bfloat16)
            out = torch.matmul(x2.to(torch.bfloat16), w).to(out_dtype)
        elif self.mode == "w4a8_2l":
            x_q, x_s = self._quantize_input(x2, self.in_scale, row_amax)
            if decode:
                out = matmul_w4a8_2l_gemv(
                    x_q, x_s, self.data, self.mult, self.scale,
                    group_size=g, out_dtype=out_dtype, paired=self.paired,
                )
            else:
                s_eff = self.mult.float() * self.scale[None, :]
                w = dequantize_int4(self.data, s_eff, g, offset_binary=True, paired=self.paired)
                out = prefill_product(x_q, x_s, w, out_dtype)
        else:
            x_q, x_s = quantize_rowwise_a4(x2, row_amax)
            if decode:
                out = matmul_w4a4_2l_gemv(
                    x_q, x_s, self.data, self.mult, self.scale,
                    group_size=g, out_dtype=out_dtype,
                )
            else:
                s_eff = self.mult.float() * self.scale[None, :]
                w = dequantize_int4_vertical(self.data, s_eff, g)
                out = prefill_product(x_q, x_s, w, out_dtype)
        return out.reshape(*lead, -1)

    def call_layer(self, x: torch.Tensor, layer: int, out_dtype=torch.bfloat16) -> torch.Tensor:
        """y = x @ W[layer] for stacked (L, ...) weights (`engine.py:163`).

        For the two-level modes the layer index goes into the kernels, so no
        per-layer weight slice is copied: the stacked GEMVs up to
        `GEMV_MAX_M` rows, the stacked dequant before the prefill product
        above, on flat or (paired W4A8) pre-blocked weights alike. Other
        cases (the float-scale modes among them) apply `__call__` to the
        layer's views, which copy nothing either, or to a pre-blocked
        layer restored to the flat form. A stacked ``in_scale`` (L,) is
        indexed by the layer.
        """
        self._check()
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        decode = x2.shape[0] <= GEMV_MAX_M
        paired_a8 = self.mode == "w4a8_2l" and self.paired
        g = self.group_size
        in_scale = self.in_scale
        if in_scale is not None and in_scale.dim() >= 1 \
                and in_scale.shape[0] == self.data.shape[0]:
            in_scale = in_scale[layer]
        if decode and paired_a8 and self.mult_packed is not None:
            x_q, x_s = self._quantize_input(x2, in_scale)
            out = matmul_w4a8_2l_gemv_stacked(
                x_q, x_s, self.data, self.mult_packed, self.scale, layer,
                group_size=g, out_dtype=out_dtype,
            )
        elif decode and self.mode == "w4a4_2l" and self.mult_packed is not None:
            x_q, x_s = quantize_rowwise_a4(x2)
            out = matmul_w4a4_2l_gemv_stacked(
                x_q, x_s, self.data, self.mult_packed, self.scale, layer,
                group_size=g, out_dtype=out_dtype,
            )
        elif not decode and self.mode == "w4a4_2l" and self.mult is not None:
            x_q, x_s = quantize_rowwise_a4(x2)
            w = dequantize_int4_vertical_stacked(self.data, self.mult, self.scale, layer,
                                                 group_size=g)
            out = prefill_product(x_q, x_s, w, out_dtype)
        elif not decode and paired_a8 and self.mult is not None:
            x_q, x_s = self._quantize_input(x2, in_scale)
            w = dequantize_int4_paired_stacked(self.data, self.mult, self.scale, layer,
                                               group_size=g)
            out = prefill_product(x_q, x_s, w, out_dtype)
        else:
            # a pre-blocked (L, N//bn, K//2, bn) layer restored to its flat
            # (K//2, N) form (`engine.py:262-267`)
            data = flat_layer(self.data, layer) if self.data.dim() == 4 else self.data[layer]
            sliced = QuantLinear(
                data, self.scale[layer], mode=self.mode, group_size=g,
                mult=None if self.mult is None else self.mult[layer], paired=self.paired,
                in_scale=in_scale,
            )
            return sliced(x, out_dtype=out_dtype)
        return out.reshape(*lead, -1)


def quantize_linear(w: torch.Tensor, mode: str, group_size: int = 128,
                    scale: Optional[torch.Tensor] = None) -> QuantLinear:
    """Quantize a dense (K, N) weight into frozen storage (`engine.py:289`);
    symmetric min-max scales (per column for w8a8, per group for the int4
    modes) unless ``scale`` is given (a view of any strides; stored
    contiguous, as the card's kernels read it). ``w4a8_2l`` packs adjacent
    groups in pairs where ``FF_2L_PAIRED`` (read here) is on and the group
    count is even, else in group halves."""
    if mode not in PACKED_MODES:
        raise ValueError(f"unknown mode {mode}")
    w = w.float()
    K, N = w.shape
    if mode == "w8a8":
        if scale is None:
            scale = torch.clamp(w.abs().amax(dim=0) / 127.0, min=1e-8)
        scale = scale.float().reshape(N).contiguous()
        q = torch.clamp(torch.round(w / scale[None, :]), -128, 127).to(torch.int8)
        return QuantLinear(q, scale, mode=mode)
    g = group_size if K % group_size == 0 else K
    wg = w.reshape(K // g, g, N)
    if scale is None:
        scale = torch.clamp(wg.abs().amax(dim=1) / 7.0, min=1e-8)
    scale = scale.float().reshape(K // g, N).contiguous()
    q = torch.clamp(torch.round(wg / scale[:, None, :]), -8, 7).to(torch.int8)
    packed = pack_int4(q.reshape(K, N), group_size=g)
    if mode == "w4a8_2l":
        paired = paired_default(K // g)
        packed, mult, s_col = convert_two_level(packed, scale, g, paired=paired)
        return QuantLinear(packed, s_col, mode=mode, group_size=g, mult=mult, paired=paired)
    if mode == "w4a4_2l":
        packed, mult, s_col = convert_two_level_a4(packed, scale, g)
        return QuantLinear(packed, s_col, mode=mode, group_size=g, mult=mult, paired=False)
    return QuantLinear(packed, scale, mode=mode, group_size=g)


@dataclasses.dataclass
class ServingLayer:
    q_proj: QuantLinear
    k_proj: QuantLinear
    v_proj: QuantLinear
    o_proj: QuantLinear
    gate_proj: QuantLinear
    up_proj: QuantLinear
    down_proj: QuantLinear
    input_norm: torch.Tensor
    post_norm: torch.Tensor


@dataclasses.dataclass
class ServingParams:
    embedding: torch.Tensor  # (vocab, hidden) bf16
    layers: tuple
    final_norm: torch.Tensor
    lm_head: Optional[QuantLinear]  # None => tied embeddings


def _scale_from_quantizer(module, w_shape, mode: str, group_size: int):
    """Frozen-storage scales from an initialized symmetric `LinearQuantizer`
    on ``module``'s weight, where its granularity matches the serving mode's
    layout (`engine.py:331`); else None. ``w_shape`` is the JAX layout (K,
    N) of the (N, K) torch weight: w8a8 takes one scale per output channel
    (torch's ``PerChannel(0)``) or one per tensor, the int4 modes a
    ``PerBlock`` whose tile is g along the in-features, (1, g) in torch's
    layout and (g, 1) in JAX's, reordered into JAX's (K // g, N)."""
    from fastforward_tpu_torch.nn.linear_quantizer import LinearQuantizer
    from fastforward_tpu_torch.quantization.granularity import PerBlock, PerChannel

    q = getattr(module, "weight_quantizer", None)
    if not isinstance(q, LinearQuantizer) or q.scale is None or q.offset is not None:
        return None
    K, N = w_shape
    scale = q.scale.detach().reshape(-1)
    gran = q.granularity
    if mode == "w8a8":
        if q.num_bits != 8:
            return None
        if isinstance(gran, PerChannel) and gran.channel_dims == (0,) and scale.numel() == N:
            return scale
        if scale.numel() == 1:
            return scale.expand(N)
        return None
    if q.num_bits != 4:
        return None
    g = group_size if K % group_size == 0 else K
    if isinstance(gran, PerBlock) and tuple(gran.tile_size((N, K))) == (1, g):
        return scale.reshape(N, K // g).t()
    return None


def _input_scale_from_quantizer(module):
    """The calibrated static activation scale of an initialized symmetric
    per-tensor 8-bit input `LinearQuantizer` on ``module`` (`engine.py:370`),
    f32 0-d; else None."""
    from fastforward_tpu_torch.nn.linear_quantizer import LinearQuantizer
    from fastforward_tpu_torch.quantization.granularity import PerTensor

    q = getattr(module, "input_quantizer", None)
    if not isinstance(q, LinearQuantizer) or q.scale is None:
        return None
    if q.offset is not None or q.num_bits != 8:
        return None
    if not isinstance(q.granularity, PerTensor):
        return None
    return q.scale.detach().float().reshape(())


@torch.no_grad()
def freeze_llama(model, mode: str = "w4a8", group_size: int = 128,
                 static_activations: bool = False) -> ServingParams:
    """Convert a `models.llama.LlamaForCausalLM` into frozen serving params
    (`engine.py:401`), on the model's device.

    Where the model was calibrated or GPTQ'd in the simulation tier (its
    QuantizedLinear weight quantizers hold symmetric grids of a granularity
    that matches the mode's layout, `_scale_from_quantizer`), those scales
    carry over, and the frozen weights dequantize to the simulated grid bit
    for bit. Each (N, K) torch weight is frozen in JAX's (K, N) layout.

    ``static_activations``: also lift calibrated *input* quantizer ranges
    (symmetric per-tensor 8-bit `LinearQuantizer`s) into
    `QuantLinear.in_scale`; activations then quantize on that static grid
    instead of a dynamic per-row one. Layers whose input quantizer is
    absent or uninitialized stay dynamic.

    The lm_head takes fresh min-max scales in the layers' mode (``w4a8_2l``
    for ``w4a4_2l``), as the JAX function's head policy does.
    """

    def ql(module):
        w = module.weight.detach().t().contiguous()
        scale = _scale_from_quantizer(module, tuple(w.shape), mode, group_size)
        out = quantize_linear(w, mode, group_size, scale=scale)
        if static_activations:
            in_scale = _input_scale_from_quantizer(module)
            if in_scale is not None:
                out = dataclasses.replace(out, in_scale=in_scale)
        return out

    layers = []
    for block in model.layers:
        attn, mlp = block.self_attn, block.mlp
        layers.append(
            ServingLayer(
                q_proj=ql(attn.q_proj),
                k_proj=ql(attn.k_proj),
                v_proj=ql(attn.v_proj),
                o_proj=ql(attn.o_proj),
                gate_proj=ql(mlp.gate_proj),
                up_proj=ql(mlp.up_proj),
                down_proj=ql(mlp.down_proj),
                input_norm=block.input_layernorm.weight.detach().to(torch.bfloat16),
                post_norm=block.post_attention_layernorm.weight.detach().to(torch.bfloat16),
            )
        )
    lm_head = None
    if model.lm_head is not None:
        # A4 applies to the decoder matmuls only: the lm_head keeps A8
        head_mode = "w4a8_2l" if mode == "w4a4_2l" else mode
        lm_head = quantize_linear(model.lm_head.weight.detach().t().contiguous(), head_mode,
                                  group_size)
    return ServingParams(
        embedding=model.embed_tokens.weight.detach().to(torch.bfloat16),
        layers=tuple(layers),
        final_norm=model.norm.weight.detach().to(torch.bfloat16),
        lm_head=lm_head,
    )


def _rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in f32, cast back to x's dtype BEFORE the weight multiply
    (`engine.py:526`)."""
    dt = x.dtype
    xf = x.float()
    out = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return out.to(dt) * weight


def _attention(q, k, v, mask):
    """(B, H, T, D) attention with an additive mask; f32 softmax."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bhtd,bhsd->bhts", q, k).float() * scale
    if mask is not None:
        scores = scores + mask
    weights = F.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhts,bhsd->bhtd", weights, v)


def _attention_grouped(q, k, v, mask):
    """GQA attention without repeating K/V (`engine.py:543`): q (B, H, T, d)
    against k/v (B, Hkv, S, d) through a grouped einsum."""
    B, H, T, d = q.shape
    Hkv = k.shape[1]
    g = H // Hkv
    if g == 1:
        return _attention(q, k, v, mask)
    scale = 1.0 / math.sqrt(d)
    q5 = q.reshape(B, Hkv, g, T, d)
    scores = torch.einsum("bkgtd,bksd->bkgts", q5, k).float() * scale
    if mask is not None:
        scores = scores + mask[:, :, None]
    weights = F.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgts,bksd->bkgtd", weights, v)
    return out.reshape(B, H, T, d)


def random_serving_params(config: LlamaConfig, mode: str = "w4a8", group_size: int = 128,
                          seed: int = 0, device=None) -> ServingParams:
    """Random per-layer serving params (`engine.py:461`), built layer by
    layer on ``device`` (default: the GPU) from a ``torch.Generator``
    seeded with ``seed``.

    The JAX function's layouts, dtypes and distributions, not its bits:
    w8a8 int8 weights uniform in [-127, 127] with per-column scales
    0.02/sqrt(K); the int4 modes uniform int4 values in `pack_int4`'s
    group halves (w4a4_2l: the vertical layout) with per-group scales
    0.25/sqrt(K) (w4a8, w4a16), or multipliers uniform in [1, 15] and
    s_col = 0.25/sqrt(K)/8 (the two-level modes, unpaired: the JAX
    function packs with `pack_int4` and leaves ``paired`` False, so the
    two-level kernels read the bytes as offset-binary group halves);
    embedding N(0, 0.02^2) in bf16, unit norms. The lm_head is in the
    layers' mode, a two-level W4A8 head for w4a4_2l.
    """
    if mode not in PACKED_MODES:
        # the JAX function has no sim branch (its int4 branch would pack them)
        raise ValueError(f"random_serving_params takes the packed modes {PACKED_MODES}, "
                         f"not {mode!r}")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    h, inter = config.hidden_size, config.intermediate_size
    nh, nkv, d = config.num_heads, config.num_kv_heads, config.head_dim

    def randint(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, dtype=torch.int8, device=dev)

    def ql(K, N, mode=mode):
        if mode == "w8a8":
            return QuantLinear(randint(-127, 128, (K, N)),
                               torch.full((N,), 0.02 / math.sqrt(K), device=dev), mode="w8a8")
        g = group_size if K % group_size == 0 else K
        q = randint(-8, 8, (K, N))
        packed = pack_int4_vertical(q) if mode == "w4a4_2l" else pack_int4(q, group_size=g)
        if mode in ("w4a8_2l", "w4a4_2l"):
            mult = randint(1, 16, (K // g, N))
            s_col = torch.full((N,), 0.25 / math.sqrt(K) / 8.0, device=dev)
            return QuantLinear(packed, s_col, mode=mode, group_size=g, mult=mult)
        scale = torch.full((K // g, N), 0.25 / math.sqrt(K), device=dev)
        return QuantLinear(packed, scale, mode=mode, group_size=g)

    layers = tuple(
        ServingLayer(
            q_proj=ql(h, nh * d), k_proj=ql(h, nkv * d), v_proj=ql(h, nkv * d),
            o_proj=ql(nh * d, h), gate_proj=ql(h, inter), up_proj=ql(h, inter),
            down_proj=ql(inter, h),
            input_norm=torch.ones((h,), dtype=torch.bfloat16, device=dev),
            post_norm=torch.ones((h,), dtype=torch.bfloat16, device=dev),
        )
        for _ in range(config.num_layers)
    )
    embedding = (torch.randn((config.vocab_size, h), generator=gen, device=dev) * 0.02
                 ).to(torch.bfloat16)
    head_mode = "w4a8_2l" if mode == "w4a4_2l" else mode
    return ServingParams(
        embedding=embedding,
        layers=layers,
        final_norm=torch.ones((h,), dtype=torch.bfloat16, device=dev),
        lm_head=None if config.tie_embeddings else ql(h, config.vocab_size, head_mode),
    )


def serving_forward(params: ServingParams, config: LlamaConfig, input_ids: torch.Tensor,
                    cache: Optional[KVCache] = None, positions: Optional[torch.Tensor] = None,
                    logits_positions="all", tp_group=None):
    """One forward pass over per-layer params (`engine.py:564`); returns
    (f32 logits, new cache).

    ``positions``: (T,) or (B, T) absolute positions, by default the T
    positions after ``cache.length``. ``logits_positions``: "all", "last"
    (the (B, T, vocab) logits of a prefill are never made) or a (B,)
    position per row. The cache's tensors are written in place; the
    returned cache shares them and is ``length + T`` long.

    ``tp_group``: the params, the cache and ``config`` are this rank's
    tensor-parallel shard (`parallel/sharding.py`), and the forward computes
    the single-device function, as JAX's GSPMD placement of the same params
    does: a row-parallel projection quantizes by the whole row's amax and
    sums its f32 partial products over the group; the column-parallel
    lm_head's logits are gathered over the group. (Megatron TP, each shard
    quantizing by its own rows' amax, is the stacked forward's.)
    """
    # the layer and its attention routing are shared with the stacked
    # forward, which imports this module
    from fastforward_tpu_torch.serving.stacked import (
        LayerWeights,
        decoder_layer,
        layer_attention_route,
    )

    B, T = input_ids.shape
    dev = input_ids.device
    inv_freq = rope_frequencies(config, device=dev)
    if positions is None:
        positions = torch.arange(T, device=dev) + (cache.length if cache is not None else 0)
    x = params.embedding[input_ids]
    starts = rows = None
    if cache is not None:
        starts = row_starts(positions, B)
        rows = starts if T == 1 else starts.tolist()
    mask = causal_mask(positions, T if cache is None else cache.max_len)
    route = layer_attention_route(cache, T, positions, config.num_heads // config.num_kv_heads)
    for i, layer in enumerate(params.layers):
        x = decoder_layer(x, LayerWeights(layer), config, positions, inv_freq,
                          None if cache is None else cache.layer(i), starts, rows, mask, route,
                          tp_group=tp_group, tp_exact=True)

    x = _rms_norm(x, params.final_norm, config.rms_norm_eps)
    if isinstance(logits_positions, str):
        if logits_positions == "last":
            x = x[:, -1:, :]
    else:
        x = torch.take_along_dim(
            x, torch.as_tensor(logits_positions, device=dev)[:, None, None], dim=1
        )
    if params.lm_head is not None:
        logits = params.lm_head(x, out_dtype=torch.float32)
        if tp_group is not None:
            parts = [torch.empty_like(logits) for _ in range(dist.get_world_size(tp_group))]
            dist.all_gather(parts, logits.contiguous(), group=tp_group)
            logits = torch.cat(parts, dim=-1)
    else:
        logits = torch.einsum("bth,vh->btv", x, params.embedding).float()
    if cache is not None:
        cache = cache.with_layers(cache.layers, advance=T)
    return logits, cache


def make_decode_loop(config: LlamaConfig, num_steps: int):
    """Greedy decode loop (`engine.py:672`): ``loop(params, cache, token
    (B, 1))`` → ``(tokens (B, num_steps), cache)``. Each step takes the
    argmax of the last position's f32 logits (the first maximum, as
    ``jnp.argmax``); the cache is written in place."""

    def loop(params: ServingParams, cache: KVCache, token: torch.Tensor):
        out = []
        for _ in range(num_steps):
            logits, cache = serving_forward(params, config, token, cache)
            token = torch.argmax(logits[:, -1], dim=-1).to(token.dtype)[:, None]
            out.append(token[:, 0])
        return torch.stack(out, dim=1), cache

    return loop


def repack_unpaired(ql: QuantLinear) -> QuantLinear:
    """A paired two-level `QuantLinear` in the group-halves layout
    (`engine.py:690`): a relabeling of the same nibbles, bit-exact. As in
    the JAX function, the result keeps data, scale, mode, group size and
    multipliers only."""
    if not ql.paired:
        return ql
    g = ql.group_size

    def conv(d2):
        return pack_uint4_offset(unpack_uint4_offset_paired(d2, g), g)

    data = torch.stack([conv(d) for d in ql.data]) if ql.data.dim() == 3 else conv(ql.data)
    return QuantLinear(data, ql.scale, mode=ql.mode, group_size=g, mult=ql.mult, paired=False)
