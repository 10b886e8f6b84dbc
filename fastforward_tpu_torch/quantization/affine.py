"""Affine quantization numerics (`fastforward_tpu/quantization/affine.py`).

The simulation tier: tiled affine quantize / dequantize in plain PyTorch
with hand-derived LSQ-style gradients (the JAX package's three
``jax.custom_vjp``s become `torch.autograd.Function`s), and the range math
that turns (min, max) ranges into (scale, offset).

The math runs in the interleaved grid/tile view (`tiling.apply_per_tile`):
reshapes, no transpose. Each elementwise step rounds to the data's dtype
(a bf16 tensor's quotient is rounded to bf16 before the offset is taken
off), as XLA computes it without excess precision. Where jitted XLA turns a
division by a constant into a product by its reciprocal (the range's
``/ 127``, ``/ 128``, ``/ (2^b - 1)``), the port multiplies by the same f32
reciprocal, so that a dynamic quantization's scales and grid values are
XLA's bits.

Gradients (`affine.py:158-217`): quantize owns them all. The data gets the
clipped straight-through gradient (zero where the grid value was clipped);
the scale the LSQ gradient, ``round(x) - x`` inside the grid's range and
``threshold + offset`` outside, times the incoming gradient; the offset
``scale * g`` outside the range and zero inside; scale and offset summed
per tile. Dequantize passes the gradient through to its data and gives its
parameters zeros; dynamic quantization passes it through to its data.
"""

import functools
import math
from typing import Sequence

import torch

from fastforward_tpu_torch.exceptions import QuantizationError
from fastforward_tpu_torch.quantization import tiling

TileOrShape = tiling.TileOrShape

__all__ = [
    "integer_minimum",
    "integer_maximum",
    "quantization_range",
    "parameters_for_range",
    "can_support_bitwidth",
    "quantize_by_tile",
    "dequantize_by_tile",
    "quantize_dynamic_by_tile",
]

_EPS32 = torch.finfo(torch.float32).eps


def integer_minimum(num_bits: float) -> float:
    """Minimum of the signed integer grid."""
    return -(2.0 ** (num_bits - 1))


def integer_maximum(num_bits: float) -> float:
    """Maximum of the signed integer grid."""
    return -integer_minimum(num_bits) - 1


def quantization_range(scale, offset, num_bits: float):
    """The (min, max) real range representable by (scale, offset)."""
    offset = 0.0 if offset is None else offset
    return (integer_minimum(num_bits) + offset) * scale, (integer_maximum(num_bits) + offset) * scale


def _div_const(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as jitted XLA computes a division by a constant: ``x``
    times the f32 reciprocal of ``c``."""
    return x * torch.tensor(1.0 / c, dtype=torch.float32).item() if x.dtype == torch.float32 \
        else x / c


def parameters_for_range(min_range, max_range, num_bits: float, symmetric: bool,
                         allow_one_sided: bool):
    """Affine (scale, offset) best representing [min_range, max_range]
    (`affine.py:63`), in f32. A non-negative global minimum with
    ``allow_one_sided`` makes the symmetric case one-sided (the asymmetric
    range from 0, the offset pinned to the integer minimum). ``offset`` is
    None in the symmetric two-sided case."""
    min_range = torch.as_tensor(min_range).to(torch.float32)
    max_range = torch.as_tensor(max_range).to(torch.float32)
    int_min, int_max = integer_minimum(num_bits), integer_maximum(num_bits)

    def asym(mn, mx):
        scale = torch.clamp(_div_const(mx - mn, 2.0 ** num_bits - 1), min=_EPS32)
        return scale, mn / scale - int_min

    one_sided = bool(min_range.min() >= 0) and allow_one_sided
    if symmetric and one_sided:
        return asym(torch.zeros_like(min_range), max_range)
    if symmetric:
        return torch.maximum(_div_const(min_range.abs(), abs(int_min)),
                             _div_const(max_range.abs(), abs(int_max))), None
    return asym(min_range, max_range)


@functools.lru_cache(maxsize=32)
def can_support_bitwidth(dtype: torch.dtype, num_bits: float) -> bool:
    """True if ``dtype`` stores ``num_bits``-bit signed grid values
    losslessly (mantissa bits + 2 for a float)."""
    if dtype.is_floating_point:
        mantissa = round(-math.log2(torch.finfo(dtype).eps))
        return mantissa + 2 >= num_bits
    if dtype in (torch.int8, torch.int16, torch.int32, torch.int64, torch.uint8):
        return torch.iinfo(dtype).bits >= num_bits
    return False


def _check_output_dtype(dtype: torch.dtype, num_bits: float) -> None:
    if not can_support_bitwidth(dtype, num_bits):
        raise QuantizationError(
            f"Provided dtype ({dtype}) is not enough to store {num_bits} bits quantized values."
        )


def _tile_sum(elem: torch.Tensor, data_shape: Sequence[int], tile: tuple) -> torch.Tensor:
    """An elementwise (data-shaped) tensor summed per tile → flat (num_tiles,)."""
    tiled = elem.reshape(tiling.interleaved_shape(data_shape, tile))
    return tiled.sum(dim=tuple(range(1, tiled.dim(), 2))).reshape(-1)


def _compute_dtype(dtype: torch.dtype) -> torch.dtype:
    return dtype if dtype.is_floating_point else torch.float32


def _grid_bound(q: torch.Tensor, qmin: float, qmax: float) -> torch.Tensor:
    """The grid bound each clipped value was clipped to (qmin below, else
    qmax), in q's dtype."""
    return torch.where(q < qmin, torch.tensor(qmin, dtype=q.dtype),
                       torch.tensor(qmax, dtype=q.dtype))


# --- static affine quantize (LSQ/STE gradient) ------------------------------


class _QuantizeByTile(torch.autograd.Function):
    """``clamp(round(x / s - round(o)), qmin, qmax)`` per tile
    (`affine.py:158`), with the hand-derived backward (`affine.py:181`)."""

    @staticmethod
    def forward(ctx, data, scale, offset, tile, num_bits, output_dtype):
        qmin, qmax = integer_minimum(num_bits), integer_maximum(num_bits)

        def op(d, s, o):
            return torch.clamp(torch.round(d / s - torch.round(o)), qmin, qmax)

        q = tiling.apply_per_tile(op, data, scale, offset, tile_size=tile).to(output_dtype)
        ctx.save_for_backward(data, scale, offset)
        ctx.tile, ctx.num_bits = tile, num_bits
        if not q.is_floating_point():
            ctx.mark_non_differentiable(q)
        return q

    @staticmethod
    def backward(ctx, g):
        data, scale, offset = ctx.saved_tensors
        tile = ctx.tile
        qmin, qmax = integer_minimum(ctx.num_bits), integer_maximum(ctx.num_bits)
        shape = data.shape
        sview = tiling.param_view(scale, shape, tile)
        oview = torch.round(tiling.param_view(offset, shape, tile))
        dview = data.reshape(tiling.interleaved_shape(shape, tile))
        gview = g.to(dview.dtype).reshape(dview.shape)

        pre_round = dview / sview - oview
        q = torch.round(pre_round)
        clip = (q < qmin) | (q > qmax)
        zero = torch.zeros((), dtype=gview.dtype)

        dinput = torch.where(clip, zero, gview).reshape(shape)
        doffset = _tile_sum(torch.where(clip, sview * gview, zero).reshape(shape), shape, tile)
        clip_val = _grid_bound(q, qmin, qmax) + oview
        dscale_elem = (torch.where(clip, clip_val, q - pre_round) * gview).reshape(shape)
        dscale = _tile_sum(dscale_elem, shape, tile)
        return (dinput.to(data.dtype), dscale.reshape(scale.shape).to(scale.dtype),
                doffset.reshape(offset.shape).to(offset.dtype), None, None, None)


def _param(value, dtype: torch.dtype, device, n: int) -> torch.Tensor:
    """A per-tile parameter as a flat (n,) tensor of ``dtype`` (one value
    broadcast to every tile), differentiable where ``value`` is."""
    t = value.to(dtype) if torch.is_tensor(value) else torch.tensor(value, dtype=dtype,
                                                                      device=device)
    t = t.reshape(-1)
    return t.expand(n) if t.numel() == 1 and n > 1 else t


def quantize_by_tile(data: torch.Tensor, scale, offset=None, *,
                     tile_size: TileOrShape = "data_shape", num_bits: float = 8,
                     output_dtype=None) -> torch.Tensor:
    """Grid values ``round(x / scale - round(offset))`` clamped to the signed
    ``num_bits`` range, one (scale, offset) per tile (`affine.py:226`), in
    ``output_dtype`` (default: the data's floating dtype, the simulation
    tier; an integer dtype for the execution tier)."""
    tile = tiling.resolve_tile_size(tile_size, data.shape)
    n = tiling.num_tiles(data.shape, tile)
    compute = _compute_dtype(data.dtype)
    out_dtype = output_dtype if output_dtype is not None else compute
    _check_output_dtype(out_dtype, num_bits)
    scale = _param(scale, compute, data.device, n)
    if scale.shape != (n,):
        raise ValueError(f"scale has {scale.numel()} elements but data/tile layout implies {n} "
                         "tiles")
    offset = torch.zeros_like(scale) if offset is None else _param(offset, compute, data.device, n)
    return _QuantizeByTile.apply(data.to(compute), scale, offset, tile, float(num_bits), out_dtype)


# --- dequantize (identity backward) -----------------------------------------


class _DequantizeByTile(torch.autograd.Function):
    """``(q + round(o)) * s`` per tile (`affine.py:269`); the gradient
    passes through to the data, the parameters get zeros (`affine.py:283`)."""

    @staticmethod
    def forward(ctx, data, scale, offset, tile, output_dtype):
        def op(d, s, o):
            return (d.to(s.dtype) + torch.round(o)) * s

        ctx.data_dtype = data.dtype
        ctx.save_for_backward(scale, offset)
        return tiling.apply_per_tile(op, data, scale, offset, tile_size=tile).to(output_dtype)

    @staticmethod
    def backward(ctx, g):
        scale, offset = ctx.saved_tensors
        dinput = g.to(ctx.data_dtype) if ctx.data_dtype.is_floating_point else None
        return dinput, torch.zeros_like(scale), torch.zeros_like(offset), None, None


def dequantize_by_tile(data: torch.Tensor, scale, offset=None, *,
                       tile_size: TileOrShape = "data_shape", output_dtype=None) -> torch.Tensor:
    """Grid values back to reals, ``(data + round(offset)) * scale`` per tile
    (`affine.py:298`), computed in the scale's floating dtype (f32 for a
    Python number) and returned in ``output_dtype`` (default: that dtype)."""
    tile = tiling.resolve_tile_size(tile_size, data.shape)
    n = tiling.num_tiles(data.shape, tile)
    floating = torch.is_tensor(scale) and scale.is_floating_point()
    param_dtype = scale.dtype if floating else torch.float32
    scale = _param(scale, param_dtype, data.device, n)
    offset = torch.zeros_like(scale) if offset is None else _param(offset, param_dtype,
                                                                   data.device, n)
    out_dtype = output_dtype if output_dtype is not None else param_dtype
    return _DequantizeByTile.apply(data, scale, offset, tile, out_dtype)


# --- dynamic quantization ----------------------------------------------------


class _QuantizeDynamicByTile(torch.autograd.Function):
    """Per-tile min/max → (scale, offset) → grid values (`affine.py:332`);
    the gradient passes straight through to the data (`affine.py:362`)."""

    @staticmethod
    def forward(ctx, data, tile, num_bits, symmetric, allow_one_sided, output_dtype):
        qmin, qmax = integer_minimum(num_bits), integer_maximum(num_bits)
        tiled = data.reshape(tiling.interleaved_shape(data.shape, tile))
        axes = tuple(range(1, tiled.dim(), 2))
        scale, offset = parameters_for_range(tiled.amin(dim=axes).reshape(-1),
                                             tiled.amax(dim=axes).reshape(-1), num_bits,
                                             symmetric=symmetric, allow_one_sided=allow_one_sided)
        offset = torch.round(torch.zeros_like(scale) if offset is None else offset)
        if data.is_floating_point():
            scale = scale.to(data.dtype)
        offset = offset.to(scale.dtype)

        def op(d, s, o):
            return torch.clamp(torch.round(d / s - o), qmin, qmax)

        q = tiling.apply_per_tile(op, data.to(scale.dtype), scale, offset, tile_size=tile)
        q = q.to(output_dtype)
        ctx.data_dtype = data.dtype
        ctx.mark_non_differentiable(scale, offset)
        if not q.is_floating_point():
            ctx.mark_non_differentiable(q)
        return q, scale, offset

    @staticmethod
    def backward(ctx, gq, gscale, goffset):
        return gq.to(ctx.data_dtype), None, None, None, None, None


def quantize_dynamic_by_tile(data: torch.Tensor, *, tile_size: TileOrShape = "data_shape",
                             num_bits: float = 8, symmetric: bool = False,
                             allow_one_sided: bool = True, output_dtype=None):
    """Dynamic quantization (`affine.py:373`): per-tile min/max → (scale,
    offset) → grid values. Returns ``(grid_values, scale, offset)``; the
    gradient is straight-through on the data."""
    if data.numel() == 0:
        raise QuantizationError(
            f"Cannot dynamically quantize an empty tensor of shape {tuple(data.shape)}")
    tile = tiling.resolve_tile_size(tile_size, data.shape)
    compute = _compute_dtype(data.dtype)
    out_dtype = output_dtype if output_dtype is not None else compute
    _check_output_dtype(out_dtype, num_bits)
    return _QuantizeDynamicByTile.apply(data.to(compute), tile, float(num_bits), bool(symmetric),
                                        bool(allow_one_sided), out_dtype)
