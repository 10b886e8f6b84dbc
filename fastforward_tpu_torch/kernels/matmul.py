"""Two-level int4 GEMVs and the prefill dequant, ported from
`fastforward_tpu/kernels/matmul.py`.

Each wrapper dispatches on the device of its tensors: a CPU tensor runs
the plain PyTorch version beside it (the port of the JAX oracle), a CUDA
tensor launches the hand-written kernel (`csrc/a4_gemv.cu`,
`csrc/w4a8_gemv.cu`, `csrc/dequant.cu`) or raises. There is no fallback
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
