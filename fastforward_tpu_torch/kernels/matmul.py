"""Two-level int4 GEMVs, the prefill dequant and the fused W4A8 layer
tail, ported from `fastforward_tpu/kernels/matmul.py`.

Each wrapper dispatches on the device of its tensors: a CPU tensor runs
the plain PyTorch version beside it (the port of the JAX oracle), a CUDA
tensor launches the hand-written kernel (`csrc/a4_gemv.cu`,
`csrc/w4a8_gemv.cu`, `csrc/dequant.cu`, `csrc/fused_tail.cu`) or raises. There is no fallback
from one to the other.

The activation quantizers divide by a constant as a multiplication by its
float32 reciprocal (``amax * (1.0 / 127.0)``): XLA compiles
``amax / 127.0`` to that inside a jitted program, which is how the JAX
serving path runs them, so they agree bit for bit with the jitted JAX
quantizers. The weight converters run eagerly in the JAX package (at load
time) and keep the true division.

The plain versions compute the integer dot in float64: every partial sum
is an integer of magnitude below 2**53, so it is exact, and converting
the float64 result to float32 rounds exactly as int32 → float32 does.
"""

import functools
from typing import Optional

import torch

from fastforward_tpu_torch.kernels import _build
from fastforward_tpu_torch.kernels.packing import (
    pack_int4_vertical,
    pack_mult_nibbles,
    pack_uint4_offset,
    pack_uint4_offset_paired,
    unpack_int4,
    unpack_int4_vertical,
    unpack_mult_nibbles,
    unpack_uint4_offset,
    unpack_uint4_offset_paired,
)

# Largest row count the decode GEMVs serve (`matmul.py:309`); more rows take
# the prefill path: dequantize to bf16, then a dense product.
GEMV_MAX_M = 256

# Activation rows and columns one GEMV block covers (csrc/common.cuh kBM, kBN).
_BLOCK_M, _BLOCK_N = 8, 128
# Columns per (max, index) pair of the argmax epilogue (csrc/common.cuh kEpiTile).
_ARGMAX_TILE = 1024
# Byte rows of packed weight one GEMV split may stage (shared memory cap).
_SPLIT_ROWS = 2048
# Blocks a GEMV launch aims to put on the card (132 SMs, a few each).
_TARGET_BLOCKS = 512


def _paired_default(n_groups: int) -> bool:
    return n_groups % 2 == 0


def quantize_rowwise(x: torch.Tensor):
    """Symmetric per-row int8 quantization: (x_q int8, scale (M,) f32)
    (`matmul.py:1896`)."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1) * (1.0 / 127.0), min=1e-8)
    x_q = torch.clamp(torch.round(xf / scale[..., None]), -128, 127)
    return x_q.to(torch.int8), scale


def quantize_rowwise_a4(x: torch.Tensor):
    """Symmetric per-row int4 quantization: (x_q int8 in [-8, 7], scale)
    (`matmul.py:1282`)."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1) * (1.0 / 7.0), min=1e-8)
    x_q = torch.clamp(torch.round(xf / scale[..., None]), -8, 7)
    return x_q.to(torch.int8), scale


def _two_level(w_packed, w_scale, group_size):
    n_groups, N = w_scale.shape
    K = w_packed.shape[0] * 2
    s = w_scale.float()
    s_col = torch.clamp(s.amax(dim=0) / 15.0, min=1e-12)
    m = torch.clamp(torch.round(s / s_col[None, :]), 1, 15)
    s_eff = m * s_col[None, :]
    v = unpack_int4(w_packed, group_size).float().reshape(n_groups, group_size, N)
    w = v * s[:, None, :]
    v2 = torch.clamp(torch.round(w / s_eff[:, None, :]), -8, 7).to(torch.int8)
    return v2.reshape(K, N), m.to(torch.int8), s_col


def convert_two_level(w_packed, w_scale, group_size: int = 128,
                      paired: Optional[bool] = None):
    """Requantize float-per-group W4 (`pack_int4`) onto the two-level grid:
    ``(packed', mult, s_col)`` with offset-binary nibbles, paired by default
    for an even group count (`matmul.py:410`)."""
    if paired is None:
        paired = _paired_default(w_scale.shape[0])
    v2, m, s_col = _two_level(w_packed, w_scale, group_size)
    pack = pack_uint4_offset_paired if paired else pack_uint4_offset
    return pack(v2, group_size=group_size), m, s_col


def convert_two_level_a4(w_packed, w_scale, group_size: int = 128):
    """Two-level requantization into the W4A4 vertical layout (`matmul.py:1290`)."""
    v2, m, s_col = _two_level(w_packed, w_scale, group_size)
    return pack_int4_vertical(v2), m, s_col


def _int_dot(x_q: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """Exact integer product (M, K) @ (K, N), returned as float32 of the
    int32 result."""
    return (x_q.double() @ w8.double()).float()


def _epilogue(acc, s_col, x_scale, bias, out_dtype):
    out = acc * s_col[None, :] * x_scale[:, None]
    if bias is not None:
        out = out + bias
    return out.to(out_dtype)


def matmul_w4a8_2l_reference(x_q, x_scale, w_packed, mult, s_col, bias=None,
                             group_size: int = 128, out_dtype=torch.bfloat16,
                             paired: Optional[bool] = None):
    """Oracle: integer math end to end, one float scaling (`matmul.py:444`)."""
    M, K = x_q.shape
    N = w_packed.shape[1]
    n_groups = K // group_size
    if paired is None:
        paired = _paired_default(n_groups)
    unpack = unpack_uint4_offset_paired if paired else unpack_uint4_offset
    v = unpack(w_packed, group_size).reshape(n_groups, group_size, N)
    w8 = (v.to(torch.int32) * mult.to(torch.int32)[:, None, :]).reshape(K, N)
    return _epilogue(_int_dot(x_q, w8), s_col, x_scale, bias, out_dtype)


def matmul_w4a4_2l_reference(x_q, x_scale, w_packed, mult, s_col, bias=None,
                             group_size: int = 128, out_dtype=torch.bfloat16):
    """Oracle for the W4A4 GEMV (`matmul.py:1317`): ``w_packed`` vertical."""
    M, K = x_q.shape
    N = w_packed.shape[1]
    n_groups = K // group_size
    v = unpack_int4_vertical(w_packed).reshape(n_groups, group_size, N)
    w8 = (v.to(torch.int32) * mult.to(torch.int32)[:, None, :]).reshape(K, N)
    return _epilogue(_int_dot(x_q, w8), s_col, x_scale, bias, out_dtype)


def gemv_split(M: int, N: int, n_units: int, rows_per_unit: int) -> int:
    """Number of K splits for a GEMV launch: enough blocks to fill the card,
    few enough byte rows per split for its shared memory."""
    tiles = -(-M // _BLOCK_M) * -(-N // _BLOCK_N)
    want = -(-_TARGET_BLOCKS // tiles)
    need = -(-n_units * rows_per_unit // _SPLIT_ROWS)
    n_split = min(n_units, max(want, need))
    per = -(-n_units // n_split)
    return -(-n_units // per)


def _check_gemv(x_q, x_scale, K, N, group_size):
    dev = x_q.device
    M = x_q.shape[0]
    _build.require(x_q, "x_q", torch.int8, (M, K))
    _build.require(x_scale, "x_scale", torch.float32, (M,), dev)
    if M < 1 or N % 4 != 0 or K % group_size != 0:
        raise ValueError(f"GEMV needs M >= 1, N % 4 == 0, K % group == 0 (M={M}, N={N}, K={K})")


def matmul_w4a4_2l_gemv_stacked(x_q, x_scale, w_packed, mult, s_col, layer,
                                group_size: int = 128, out_dtype=torch.bfloat16):
    """W4A4 decode GEMV over stacked weights (`matmul.py:1406`).

    ``x_q`` int4-valued int8 (M, K); ``w_packed`` (L, K//2, N) vertical;
    ``mult`` (L, ceil(n_groups/8), N) int32 nibble-packed; ``s_col`` (L, N).
    Bit-exact against `matmul_w4a4_2l_reference` on layer ``layer``.
    """
    layer = int(layer)
    M, K = x_q.shape
    L, Kh, N = w_packed.shape
    n_groups = K // group_size
    if x_q.device.type == "cpu":
        ml = unpack_mult_nibbles(mult[layer], n_groups)
        return matmul_w4a4_2l_reference(
            x_q, x_scale, w_packed[layer], ml, s_col[layer], None, group_size, out_dtype,
        )
    dev = x_q.device
    _check_gemv(x_q, x_scale, K, N, group_size)
    n_pack = mult.shape[1]
    _build.require(w_packed, "w_packed", torch.int8, (L, K // 2, N), dev)
    _build.require(mult, "mult", torch.int32, (L, n_pack, N), dev)
    _build.require(s_col, "s_col", torch.float32, (L, N), dev)
    if out_dtype != torch.bfloat16 or group_size % 8 != 0 or n_pack * 8 < n_groups \
            or not 0 <= layer < L:
        raise ValueError(
            f"A4 GEMV kernel needs bf16 out, group % 8 == 0, a full multiplier "
            f"pack and a valid layer (out={out_dtype}, group={group_size}, layer={layer})"
        )
    n_split = gemv_split(M, N, n_groups, group_size // 2)
    partial = torch.empty((n_split, M, N), dtype=torch.int32, device=dev)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
    err = _build.lib("a4_gemv").ff_a4_gemv(
        x_q.data_ptr(), x_scale.data_ptr(), w_packed.data_ptr(), mult.data_ptr(),
        s_col.data_ptr(), partial.data_ptr(), out.data_ptr(),
        M, K, N, L, layer, group_size, n_pack, n_split, _build.stream_ptr(dev),
    )
    _build.launch_counts["a4_gemv"] += 1
    _build.check(err, "a4_gemv")
    return out


def matmul_w4a4_2l_gemv(x_q, x_scale, w_packed, mult, s_col, group_size: int = 128,
                        out_dtype=torch.bfloat16):
    """Non-stacked W4A4 GEMV (`matmul.py:1487`): the stacked kernel at L=1."""
    if x_q.device.type == "cpu":
        return matmul_w4a4_2l_reference(
            x_q, x_scale, w_packed, mult, s_col, None, group_size, out_dtype,
        )
    return matmul_w4a4_2l_gemv_stacked(
        x_q, x_scale, w_packed[None], pack_mult_nibbles(mult)[None].contiguous(),
        s_col[None].float().contiguous(), 0, group_size, out_dtype,
    )


def _check_paired(x_q, x_scale, w_packed, mult, s_col, group_size, paired):
    M, K = x_q.shape
    N = w_packed.shape[1]
    dev = x_q.device
    _check_gemv(x_q, x_scale, K, N, group_size)
    _build.require(w_packed, "w_packed", torch.int8, (K // 2, N), dev)
    _build.require(mult, "mult", torch.int8, (K // group_size, N), dev)
    _build.require(s_col, "s_col", torch.float32, (N,), dev)
    if not paired or K % (2 * group_size) != 0 or group_size % 4 != 0:
        raise NotImplementedError(
            "the W4A8 GEMV kernel takes the paired layout (even group count, "
            "group % 4 == 0) only"
        )
    return M, K, N, gemv_split(M, N, K // (2 * group_size), group_size)


def matmul_w4a8_2l_gemv(x_q, x_scale, w_packed, mult, s_col, group_size: int = 128,
                        out_dtype=torch.bfloat16, paired: Optional[bool] = None):
    """Two-level W4A8 GEMV (`matmul.py:571`); f32 or bf16 out."""
    M, K = x_q.shape
    if paired is None:
        paired = _paired_default(K // group_size)
    if x_q.device.type == "cpu":
        return matmul_w4a8_2l_reference(
            x_q, x_scale, w_packed, mult, s_col, None, group_size, out_dtype, paired=paired,
        )
    M, K, N, n_split = _check_paired(x_q, x_scale, w_packed, mult, s_col, group_size, paired)
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"W4A8 GEMV kernel writes f32 or bf16, not {out_dtype}")
    dev = x_q.device
    partial = torch.empty((n_split, M, N), dtype=torch.int32, device=dev)
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    err = _build.lib("w4a8_gemv").ff_w4a8_gemv(
        x_q.data_ptr(), x_scale.data_ptr(), w_packed.data_ptr(), mult.data_ptr(),
        s_col.data_ptr(), partial.data_ptr(), out.data_ptr(),
        M, K, N, group_size, n_split, 0 if out_dtype == torch.float32 else 1,
        _build.stream_ptr(dev),
    )
    _build.launch_counts["w4a8_gemv"] += 1
    _build.check(err, "w4a8_gemv")
    return out


def matmul_w4a8_2l_gemv_argmax(x_q, x_scale, w_packed, mult, s_col,
                               group_size: int = 128, paired: Optional[bool] = None):
    """Greedy lm_head (`matmul.py:708`): int32 argmax over N per row of the
    two-level W4A8 logits — the ids of ``torch.argmax`` over the f32
    logits (first occurrence wins ties, a NaN counts as the maximum)."""
    M, K = x_q.shape
    if paired is None:
        paired = _paired_default(K // group_size)
    if x_q.device.type == "cpu":
        logits = matmul_w4a8_2l_reference(
            x_q, x_scale, w_packed, mult, s_col, None, group_size, torch.float32,
            paired=paired,
        )
        return torch.argmax(logits, dim=-1).to(torch.int32)
    M, K, N, n_split = _check_paired(x_q, x_scale, w_packed, mult, s_col, group_size, paired)
    dev = x_q.device
    n_tiles = -(-N // _ARGMAX_TILE)
    partial = torch.empty((n_split, M, N), dtype=torch.int32, device=dev)
    pair_val = torch.empty((M, n_tiles), dtype=torch.float32, device=dev)
    pair_idx = torch.empty((M, n_tiles), dtype=torch.int32, device=dev)
    idx = torch.empty((M,), dtype=torch.int32, device=dev)
    err = _build.lib("w4a8_gemv").ff_w4a8_gemv_argmax(
        x_q.data_ptr(), x_scale.data_ptr(), w_packed.data_ptr(), mult.data_ptr(),
        s_col.data_ptr(), partial.data_ptr(), pair_val.data_ptr(), pair_idx.data_ptr(),
        idx.data_ptr(), M, K, N, group_size, n_split, _build.stream_ptr(dev),
    )
    _build.launch_counts["w4a8_gemv"] += 1
    _build.check(err, "w4a8_gemv_argmax")
    return idx


def matmul_w4a8_2l_gemv_stacked(x_q, x_scale, w_packed, mult, s_col, layer,
                                group_size: int = 128, out_dtype=torch.bfloat16):
    """Two-level W4A8 decode GEMV over stacked weights (`matmul.py:1023`).

    ``w_packed`` (L, K//2, N) paired offset-binary; ``mult`` (L,
    ceil(n_groups/8), N) int32 nibble-packed; ``s_col`` (L, N). Bit-exact
    against `matmul_w4a8_2l_reference` (paired) on layer ``layer``.
    """
    layer = int(layer)
    M, K = x_q.shape
    L, Kh, N = w_packed.shape
    n_groups = K // group_size
    if x_q.device.type == "cpu":
        return matmul_w4a8_2l_reference(
            x_q, x_scale, w_packed[layer], unpack_mult_nibbles(mult[layer], n_groups),
            s_col[layer], None, group_size, out_dtype, paired=True,
        )
    dev = x_q.device
    _check_gemv(x_q, x_scale, K, N, group_size)
    n_pack = mult.shape[1]
    _build.require(w_packed, "w_packed", torch.int8, (L, K // 2, N), dev)
    _build.require(mult, "mult", torch.int32, (L, n_pack, N), dev)
    _build.require(s_col, "s_col", torch.float32, (L, N), dev)
    if K % (2 * group_size) != 0 or group_size % 4 != 0:
        raise NotImplementedError(
            "the stacked W4A8 GEMV kernel takes the paired layout (even group count, "
            "group % 4 == 0) only"
        )
    if out_dtype not in (torch.float32, torch.bfloat16) or n_pack * 8 < n_groups \
            or not 0 <= layer < L:
        raise ValueError(
            f"stacked W4A8 GEMV kernel needs f32 or bf16 out, a full multiplier pack and "
            f"a valid layer (out={out_dtype}, layer={layer})"
        )
    n_split = gemv_split(M, N, K // (2 * group_size), group_size)
    partial = torch.empty((n_split, M, N), dtype=torch.int32, device=dev)
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    err = _build.lib("w4a8_gemv").ff_w4a8_gemv_stacked(
        x_q.data_ptr(), x_scale.data_ptr(), w_packed.data_ptr(), mult.data_ptr(),
        s_col.data_ptr(), partial.data_ptr(), out.data_ptr(), M, K, N, L, layer,
        group_size, n_pack, n_split, 0 if out_dtype == torch.float32 else 1,
        _build.stream_ptr(dev),
    )
    _build.launch_counts["w4a8_gemv_stacked"] += 1
    _build.check(err, "w4a8_gemv_stacked")
    return out


def dequantize_int4_vertical_reference(w_packed, s_eff, group_size: int = 128,
                                       out_dtype=torch.bfloat16):
    """Oracle: vertical-layout int4 (K//2, N) to dense (K, N) with per-group
    scales ``s_eff`` (K//g, N): ``v * s_eff`` in f32, rounded once
    (`matmul.py:1511`)."""
    K, N = w_packed.shape[0] * 2, w_packed.shape[1]
    v = unpack_int4_vertical(w_packed).reshape(K // group_size, group_size, N)
    return (v.float() * s_eff.float()[:, None, :]).reshape(K, N).to(out_dtype)


def dequantize_int4_paired_reference(w_packed, w_scale, group_size: int = 128):
    """Oracle of `dequantize_int4`'s paired branch (`matmul.py:1579-1585`):
    paired offset-binary int4 to dense bf16 with per-group scales."""
    K, N = w_packed.shape[0] * 2, w_packed.shape[1]
    v = unpack_uint4_offset_paired(w_packed, group_size).reshape(K // group_size, group_size, N)
    return (v.float() * w_scale.float()[:, None, :]).reshape(K, N).to(torch.bfloat16)


def _dequant(entry, count, w_packed, mult, scale, layer, group_size, paired):
    """Launch `csrc/dequant.cu` on layer ``layer`` of (L, K//2, N) weights:
    with ``mult`` (L, K//g, N) int8 and ``scale`` = s_col (L, N), or with
    ``mult`` None and ``scale`` = s_eff (K//g, N) at L = 1."""
    layer = int(layer)
    L, K2, N = w_packed.shape
    K = 2 * K2
    dev = w_packed.device
    _build.require(w_packed, "w_packed", torch.int8, (L, K2, N))
    if mult is None:
        _build.require(scale, "s_eff", torch.float32, (K // group_size, N), dev)
    else:
        _build.require(mult, "mult", torch.int8, (L, K // group_size, N), dev)
        _build.require(scale, "s_col", torch.float32, (L, N), dev)
    unit = 2 * group_size if paired else group_size
    if group_size % 2 != 0 or K % unit != 0 or not 0 <= layer < L:
        raise ValueError(
            f"dequant kernel needs an even group, K divisible by {unit} and a valid layer "
            f"(K={K}, group={group_size}, layer={layer})"
        )
    out = torch.empty((K, N), dtype=torch.bfloat16, device=dev)
    err = getattr(_build.lib("dequant"), entry)(
        w_packed.data_ptr(), None if mult is None else mult.data_ptr(), scale.data_ptr(),
        out.data_ptr(), K, N, L, layer, group_size, _build.stream_ptr(dev),
    )
    _build.launch_counts[count] += 1
    _build.check(err, count)
    return out


def dequantize_int4_vertical(w_packed, s_eff, group_size: int = 128, out_dtype=torch.bfloat16):
    """Vertical-layout int4 to dense bf16 (`matmul.py:1511`): the stacked
    kernel at L = 1 with the per-group scales given."""
    if w_packed.device.type == "cpu":
        return dequantize_int4_vertical_reference(w_packed, s_eff, group_size, out_dtype)
    if out_dtype != torch.bfloat16:
        raise ValueError(f"the dequant kernel writes bf16, not {out_dtype}")
    return _dequant("ff_dequant_vertical", "dequant_vertical", w_packed[None], None, s_eff, 0,
                    group_size, paired=False)


def dequantize_int4(w_packed, w_scale, group_size: int = 128, offset_binary: bool = False,
                    paired: bool = False):
    """Packed int4 to dense bf16 (`matmul.py:1561`); the paired layout only,
    through the stacked paired kernel at L = 1."""
    if not paired:
        raise NotImplementedError(
            "dequantize_int4 of the group-halves layouts is not ported yet "
            "(ROADMAP.md, Queue 2 item 13)"
        )
    if w_packed.device.type == "cpu":
        return dequantize_int4_paired_reference(w_packed, w_scale, group_size)
    return _dequant("ff_dequant_paired", "dequant_paired", w_packed[None], None, w_scale, 0,
                    group_size, paired=True)


def dequantize_int4_vertical_stacked(w_packed, mult, s_col, layer, group_size: int = 512):
    """Layer ``layer`` of stacked vertical W4A4 weights to dense bf16
    (`matmul.py:1736`): ``w_packed`` (L, K//2, N), ``mult`` (L, K//g, N)
    int8, ``s_col`` (L, N); s_eff = f32(mult) * s_col. Bit-exact against the
    JAX package's CPU path (see `csrc/dequant.cu` on the TPU kernel's)."""
    layer = int(layer)
    if w_packed.device.type == "cpu":
        s_eff = mult[layer].float() * s_col[layer].float()[None, :]
        return dequantize_int4_vertical_reference(w_packed[layer], s_eff, group_size)
    return _dequant("ff_dequant_vertical", "dequant_vertical", w_packed, mult, s_col, layer,
                    group_size, paired=False)


def dequantize_int4_paired_stacked(w_packed, mult, s_col, layer, group_size: int = 128):
    """Layer ``layer`` of stacked paired W4A8 weights to dense bf16
    (`matmul.py:1650`, flat layout): shapes as in
    `dequantize_int4_vertical_stacked`."""
    layer = int(layer)
    if w_packed.device.type == "cpu":
        s_eff = mult[layer].float() * s_col[layer].float()[None, :]
        return dequantize_int4_paired_reference(w_packed[layer], s_eff, group_size)
    return _dequant("ff_dequant_paired", "dequant_paired", w_packed, mult, s_col, layer,
                    group_size, paired=True)


# --- Fused W4A8 layer tail (`matmul.py:1909-2049`, `:2263-2433`) -------------


def _fused_o_mlp_parts(attn, x_res, norm_w, o_w, o_m, o_s, gu_w, gu_m, gu_s, dn_w, dn_m, dn_s,
                       group_size: int = 128, eps: float = 1e-5):
    """The oracle's steps with their intermediates: (y, x1, hq, s_h, x2,
    s_g), all f32 but the int8 hq and x2. Per-layer operands, multipliers
    unpacked (K//g, N) int8."""
    x_q, x_s = quantize_rowwise(attn)
    o_out = matmul_w4a8_2l_reference(x_q, x_s, o_w, o_m, o_s, None, group_size, torch.float32,
                                     paired=True)
    x1 = x_res.float() + o_out
    inv = torch.rsqrt(torch.mean(x1 * x1, dim=1, keepdim=True) + eps)
    h = x1 * inv * norm_w[None, :].float()
    h_q, h_s = quantize_rowwise(h)
    gu = matmul_w4a8_2l_reference(h_q, h_s, gu_w, gu_m, gu_s, None, group_size, torch.float32,
                                  paired=True)
    gu = gu.to(torch.bfloat16).float()  # the kernel stages gate/up through bf16
    inter = gu.shape[1] // 2
    gate, up = gu[:, :inter], gu[:, inter:]
    gated = gate * torch.sigmoid(gate) * up
    g_q, g_s = quantize_rowwise(gated)
    dn = matmul_w4a8_2l_reference(g_q, g_s, dn_w, dn_m, dn_s, None, group_size, torch.float32,
                                  paired=True)
    return x1 + dn, x1, h_q, h_s, g_q, g_s


def fused_o_mlp_reference(attn, x_res, norm_w, o_w, o_m, o_s, gu_w, gu_m, gu_s, dn_w, dn_m,
                          dn_s, group_size: int = 128, eps: float = 1e-5):
    """Oracle of the fused layer tail (`matmul.py:2263`), per-layer operands:
    f32 residual chain, dynamic int8 activation quantization at each
    product's input, two-level W4A8 products (paired), gate/up rounded
    through bf16. Returns (M, H) f32."""
    return _fused_o_mlp_parts(attn, x_res, norm_w, o_w, o_m, o_s, gu_w, gu_m, gu_s, dn_w, dn_m,
                              dn_s, group_size, eps)[0]


def _fused_o_mlp_layer(norm_w, o_w, o_mp, o_sc, gu_w, gu_mp, gu_sc, dn_w, dn_mp, dn_sc, layer,
                       group_size):
    """Layer ``layer`` of the stacked operands, multipliers unpacked (each
    to its own K's group count: the JAX CPU path unpacks gate/up's with
    o_proj's, which holds only where the attention width equals H)."""
    def groups(w):
        return w.shape[1] * 2 // group_size
    return (norm_w[layer], o_w[layer], unpack_mult_nibbles(o_mp[layer], groups(o_w)),
            o_sc[layer], gu_w[layer], unpack_mult_nibbles(gu_mp[layer], groups(gu_w)),
            gu_sc[layer], dn_w[layer], unpack_mult_nibbles(dn_mp[layer], groups(dn_w)),
            dn_sc[layer])


@functools.lru_cache(maxsize=64)
def _fused_o_mlp_layout(M, K1, H, I, g):
    """K splits of the three products and the scratch layout of one fused
    tail launch: (splits, byte sizes, byte offsets, total bytes), each
    region 256-byte aligned, in the argument order of `ff_fused_o_mlp`."""
    splits = tuple(gemv_split(M, N, K // (2 * g), g) for K, N in ((K1, H), (H, 2 * I), (I, H)))
    n_chunks = -(-max(H, I) // 128)
    sizes = {"partial": 4 * max(s * M * N for s, N in zip(splits, (H, 2 * I, H))),
             "x1": 4 * M * H, "hq": M * H, "gated": 4 * M * I, "x2": M * I,
             "red_a": 4 * M * n_chunks, "red_b": 4 * M * n_chunks, "scales": 4 * 2 * M}
    offsets, total = {}, 0
    for name, size in sizes.items():
        offsets[name] = total
        total += -(-size // 256) * 256
    return splits, sizes, offsets, total


def _fused_o_mlp_launch(attn, x_res, norm_w, o_w, o_mp, o_sc, gu_w, gu_mp, gu_sc, dn_w, dn_mp,
                        dn_sc, layer, group_size, eps):
    """Launch `csrc/fused_tail.cu`; returns (y in attn's dtype, scratch
    views x1, hq, s_h, x2, s_g)."""
    layer = int(layer)
    M, K1 = attn.shape
    L, _, H = o_w.shape
    N_GU = gu_w.shape[2]
    I = N_GU // 2
    dev = attn.device
    g = group_size
    _build.require(attn, "attn", attn.dtype, (M, K1), dev)
    _build.require(x_res, "x_res", torch.bfloat16, (M, H), dev)
    _build.require(norm_w, "norm_w", torch.bfloat16, (L, H), dev)
    for name, w, mp, sc, K, N in (("o", o_w, o_mp, o_sc, K1, H), ("gu", gu_w, gu_mp, gu_sc, H, N_GU),
                                  ("dn", dn_w, dn_mp, dn_sc, I, H)):
        _build.require(w, f"{name}_w", torch.int8, (L, K // 2, N), dev)
        _build.require(mp, f"{name}_mp", torch.int32, (L, mp.shape[1], N), dev)
        _build.require(sc, f"{name}_sc", torch.float32, (L, N), dev)
        if K % (2 * g) != 0 or mp.shape[1] * 8 < K // g:
            raise ValueError(f"fused tail: {name} needs K % (2 * group) == 0 and a full "
                             f"multiplier pack (K={K}, group={g})")
    if attn.dtype not in (torch.float32, torch.bfloat16) or g % 4 != 0 or H % 4 != 0 \
            or I % 4 != 0 or not 0 <= layer < L or M < 1:
        raise ValueError(
            f"fused tail kernel needs f32 or bf16 attn, group % 4 == 0, H and inter "
            f"divisible by 4 and a valid layer (attn={attn.dtype}, group={g}, H={H}, I={I}, "
            f"layer={layer})"
        )
    x_q, x_s = quantize_rowwise(attn)
    splits, sizes, offsets, total = _fused_o_mlp_layout(M, K1, H, I, g)
    scratch = torch.empty((total,), dtype=torch.uint8, device=dev)
    ptr = {name: scratch.data_ptr() + off for name, off in offsets.items()}
    out = torch.empty((M, H), dtype=attn.dtype, device=dev)
    err = _build.lib("fused_tail").ff_fused_o_mlp(
        x_q.data_ptr(), x_s.data_ptr(), x_res.data_ptr(), norm_w.data_ptr(),
        o_w.data_ptr(), o_mp.data_ptr(), o_sc.data_ptr(), gu_w.data_ptr(), gu_mp.data_ptr(),
        gu_sc.data_ptr(), dn_w.data_ptr(), dn_mp.data_ptr(), dn_sc.data_ptr(),
        *ptr.values(), out.data_ptr(),
        M, K1, H, I, L, layer, g, o_mp.shape[1], gu_mp.shape[1], dn_mp.shape[1], *splits,
        float(eps), int(attn.dtype == torch.bfloat16), _build.stream_ptr(dev),
    )
    _build.launch_counts["fused_o_mlp"] += 1
    _build.check(err, "fused_o_mlp")

    def view(name, dtype, shape):
        n = sizes[name]
        return scratch[offsets[name]:offsets[name] + n].view(dtype).view(shape)

    return (out, view("x1", torch.float32, (M, H)), view("hq", torch.int8, (M, H)),
            view("scales", torch.float32, (2, M))[0], view("x2", torch.int8, (M, I)),
            view("scales", torch.float32, (2, M))[1])


def fused_o_mlp_stacked(attn, x_res, norm_w, o_w, o_mp, o_sc, gu_w, gu_mp, gu_sc, dn_w, dn_mp,
                        dn_sc, layer, group_size: int = 128, eps: float = 1e-5):
    """The W4A8 layer tail in one call (`matmul.py:2298`):
    ``y = x1 + down(silu-mlp(rmsnorm(x1)))`` with ``x1 = x_res +
    o_proj(attn)``, on layer ``layer`` of stacked paired two-level weights
    (L, K//2, N) with nibble-packed multipliers and column scales (L, N).
    attn (M, K1); x_res (M, H) bf16; norm_w (L, H) bf16. Returns (M, H) in
    attn's dtype. On the card `csrc/fused_tail.cu`: x1 bit-equal to the
    oracle, the int8 hq and x2 within one level where the IEEE rsqrt and
    exp round differently, y within 8e-3 of its largest value."""
    if attn.device.type == "cpu":
        return fused_o_mlp_reference(
            attn.float(), x_res.float(),
            *_fused_o_mlp_layer(norm_w, o_w, o_mp, o_sc, gu_w, gu_mp, gu_sc, dn_w, dn_mp,
                                dn_sc, layer, group_size),
            group_size, eps,
        ).to(attn.dtype)
    return _fused_o_mlp_launch(attn, x_res, norm_w, o_w, o_mp, o_sc, gu_w, gu_mp, gu_sc, dn_w,
                               dn_mp, dn_sc, layer, group_size, eps)[0]
