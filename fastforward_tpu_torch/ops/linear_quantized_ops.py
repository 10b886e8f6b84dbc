"""Grid-preserving kernels for affine QuantizedTensors
(`fastforward_tpu/ops/linear_quantized_ops.py`).

Operations that run directly on the integer grid without dequantizing:
shape ops on per-tensor and per-channel quantized data, multiplication and
division by a scalar (which rescale the grid), concatenation of tensors
sharing a grid, symmetric negation, `positive` and zero padding.

They register into the dispatcher at DEFAULT priority, so they win over the
dequantize fallback whenever their predicates match. A per-channel
tensor's channel dim is whichever dim its granularity names; in torch's
(out, in) weight layout that is dim 0.
"""

from typing import Any, Optional, Sequence

import torch

from fastforward_tpu_torch import dispatcher
from fastforward_tpu_torch.dispatcher import Predicate
from fastforward_tpu_torch.quantization.affine_function import (
    AffineQuantizationFunction,
    StaticAffineQuantParams,
)
from fastforward_tpu_torch.quantization.granularity import PerChannel, PerTensor
from fastforward_tpu_torch.quantization.quantized_array import QuantizedTensor


def _affine_params(value: Any) -> Optional[StaticAffineQuantParams]:
    if not isinstance(value, QuantizedTensor):
        return None
    ctx = value.quantization_context
    if ctx.quantization_fn is not AffineQuantizationFunction:
        return None
    params = ctx.quantization_params
    if not isinstance(params, StaticAffineQuantParams):
        return None
    return params


def is_affine(value: Any) -> bool:
    """Predicate: value is an affine-quantized tensor."""
    return _affine_params(value) is not None


def is_affine_per_tensor(value: Any) -> bool:
    params = _affine_params(value)
    return params is not None and isinstance(params.granularity, PerTensor)


def is_affine_per_channel(value: Any) -> bool:
    params = _affine_params(value)
    return params is not None and isinstance(params.granularity, PerChannel)


affine = Predicate(lambda x, *a, **k: is_affine(x), name="affine")
affine_per_tensor = Predicate(lambda x, *a, **k: is_affine_per_tensor(x), name="affine_per_tensor")


def _requantize_output(result: QuantizedTensor, output_quantizer: Any) -> Any:
    if output_quantizer is None or getattr(output_quantizer, "is_stub", False):
        return result
    return output_quantizer(result.dequantize())


# --- shape ops on per-tensor quantized data ----------------------------------


@dispatcher.register("reshape", predicate=affine_per_tensor)
def _reshape_per_tensor(input: QuantizedTensor, shape, *, output_quantizer=None):
    out = input.with_data(torch.reshape(input.raw_data, tuple(shape)))
    return _requantize_output(out, output_quantizer)


@dispatcher.register("permute", predicate=affine_per_tensor)
def _permute_per_tensor(input: QuantizedTensor, dims, *, output_quantizer=None):
    out = input.with_data(torch.permute(input.raw_data, tuple(dims)))
    return _requantize_output(out, output_quantizer)


@dispatcher.register("transpose", predicate=affine_per_tensor)
def _transpose_per_tensor(input: QuantizedTensor, dim0: int, dim1: int, *,
                          output_quantizer=None):
    out = input.with_data(torch.transpose(input.raw_data, dim0, dim1))
    return _requantize_output(out, output_quantizer)


# --- scalar multiplication: rescale the grid ---------------------------------


def _is_scalar(v: Any) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


@dispatcher.register(
    "mul",
    predicate=Predicate(
        lambda input, other, *a, **k: is_affine(input) and _is_scalar(other)
        and _affine_params(input).offset is None,
        name="affine_scalar_mul",
    ),
)
def _mul_scalar(input: QuantizedTensor, other: float, *, output_quantizer=None):
    """q stays, scale *= |s|; for a negative s the grid values flip sign
    (symmetric grids only: with an offset the rescaled grid no longer
    matches)."""
    params = _affine_params(input)
    if other >= 0:
        new = input.with_context(
            input.quantization_context.with_changes(scale=params.scale * other)
        )
    else:
        new = QuantizedTensor(
            -input.raw_data,
            input.quantization_context.with_changes(scale=params.scale * (-other)),
        )
    return _requantize_output(new, output_quantizer)


# --- concatenation of grid-compatible tensors ---------------------------------


def _grids_match(tensors: Sequence[Any]) -> bool:
    if not tensors or not all(is_affine_per_tensor(t) for t in tensors):
        return False
    first = _affine_params(tensors[0])
    for t in tensors[1:]:
        p = _affine_params(t)
        if p.num_bits != first.num_bits:
            return False
        if p.scale is not first.scale and not _concrete_equal(p.scale, first.scale):
            return False
        if (p.offset is None) != (first.offset is None):
            return False
        if p.offset is not None and p.offset is not first.offset and not _concrete_equal(
            p.offset, first.offset
        ):
            return False
    return True


def _flat(value) -> torch.Tensor:
    """A scale or offset as a flat tensor (f32 for a Python number)."""
    if isinstance(value, torch.Tensor):
        return value.reshape(-1)
    return torch.tensor(value, dtype=torch.float32).reshape(-1)


def _concrete_equal(a, b) -> bool:
    try:
        return bool(torch.equal(torch.as_tensor(a), torch.as_tensor(b)))
    except Exception:
        return False


@dispatcher.register(
    "cat",
    predicate=Predicate(lambda tensors, *a, **k: _grids_match(tensors), name="cat_same_grid"),
)
def _cat_same_grid(tensors: Sequence[QuantizedTensor], dim: int = 0, *, output_quantizer=None):
    """Concatenate raw grids when all inputs share one quantization grid."""
    data = torch.cat([t.raw_data for t in tensors], dim=dim)
    out = tensors[0].with_data(data)
    return _requantize_output(out, output_quantizer)


# --- per-channel shape ops ----------------------------------------------------
#
# Scale and offset are a flat (num_channels,) vector (one tile per channel
# index), so any permutation of the dims leaves the vector as it is: only
# the granularity's channel dim is remapped.


def _single_channel_dim(value: Any) -> Optional[int]:
    params = _affine_params(value)
    if params is None or not isinstance(params.granularity, PerChannel):
        return None
    dims = params.granularity.channel_dims
    return dims[0] if len(dims) == 1 else None


affine_per_channel = Predicate(
    lambda x, *a, **k: _single_channel_dim(x) is not None, name="affine_per_channel"
)


def _with_channel_dim(value: QuantizedTensor, data, new_dim: int) -> QuantizedTensor:
    ctx = value.quantization_context.with_changes(granularity=PerChannel(new_dim))
    return QuantizedTensor(data, ctx)


@dispatcher.register("permute", predicate=affine_per_channel)
def _permute_per_channel(input: QuantizedTensor, dims, *, output_quantizer=None):
    dims = tuple(dims)
    channel = _single_channel_dim(input)
    out = _with_channel_dim(input, torch.permute(input.raw_data, dims), dims.index(channel))
    return _requantize_output(out, output_quantizer)


@dispatcher.register("transpose", predicate=affine_per_channel)
def _transpose_per_channel(
    input: QuantizedTensor, dim0: int, dim1: int, *, output_quantizer=None
):
    channel = _single_channel_dim(input)
    ndim = input.raw_data.dim()
    dim0, dim1 = dim0 % ndim, dim1 % ndim
    new_channel = channel
    if channel == dim0:
        new_channel = dim1
    elif channel == dim1:
        new_channel = dim0
    out = _with_channel_dim(input, torch.transpose(input.raw_data, dim0, dim1), new_channel)
    return _requantize_output(out, output_quantizer)


def _channel_cat_compatible(tensors: Sequence[Any], dim: Any) -> bool:
    if not tensors or not isinstance(dim, int):
        return False
    channels = [_single_channel_dim(t) for t in tensors]
    if any(c is None for c in channels) or len(set(channels)) != 1:
        return False
    if channels[0] != dim % tensors[0].raw_data.dim():
        return False
    first = _affine_params(tensors[0])
    for t in tensors[1:]:
        p = _affine_params(t)
        if p.num_bits != first.num_bits:
            return False
        if (p.offset is None) != (first.offset is None):
            return False
    return True


@dispatcher.register(
    "cat",
    predicate=Predicate(
        lambda tensors, dim=0, *a, **k: _channel_cat_compatible(tensors, dim),
        name="cat_per_channel_dim",
    ),
)
def _cat_per_channel(tensors: Sequence[QuantizedTensor], dim: int = 0, *, output_quantizer=None):
    """Concatenate per-channel-quantized tensors along the channel dim: the
    grids stay exact because each channel keeps its own (scale, offset)."""
    first = _affine_params(tensors[0])
    data = torch.cat([t.raw_data for t in tensors], dim=dim)
    scale = torch.cat([_flat(_affine_params(t).scale) for t in tensors])
    changes = {"scale": scale}
    if first.offset is not None:
        changes["offset"] = torch.cat([_flat(_affine_params(t).offset) for t in tensors])
    out = QuantizedTensor(data, tensors[0].quantization_context.with_changes(**changes))
    return _requantize_output(out, output_quantizer)


# --- sign / scalar-division ops ------------------------------------------------


def _int_bounds(num_bits: int) -> tuple[int, int]:
    return -(2 ** (num_bits - 1)), 2 ** (num_bits - 1) - 1


def _symmetric_affine(value: Any) -> bool:
    params = _affine_params(value)
    return params is not None and params.offset is None


@dispatcher.register(
    "negative",
    predicate=Predicate(
        lambda input, *a, **k: _symmetric_affine(input), name="affine_symmetric_neg"
    ),
)
def _neg_symmetric(input: QuantizedTensor, *, output_quantizer=None):
    """Negate on the grid: ``-q`` at the same scale. Exact but at the
    ``int_min`` grid point, which saturates to ``int_max``."""
    params = _affine_params(input)
    lo, hi = _int_bounds(params.num_bits)
    q = input.raw_data
    if not q.is_floating_point():
        negated = torch.clamp(-q.to(torch.int32), lo, hi).to(q.dtype)
    else:
        # The simulation tier stores grid values in float; the clamp keeps
        # the result a valid b-bit grid.
        negated = torch.clamp(-q, lo, hi)
    return _requantize_output(input.with_data(negated), output_quantizer)


@dispatcher.register(
    "positive",
    predicate=Predicate(lambda input, *a, **k: is_affine(input), name="affine_pos"),
)
def _pos(input: QuantizedTensor, *, output_quantizer=None):
    return _requantize_output(input, output_quantizer)


@dispatcher.register(
    "div",
    predicate=Predicate(
        lambda input, other, *a, **k: _symmetric_affine(input)
        and _is_scalar(other) and other != 0,
        name="affine_scalar_div",
    ),
)
def _div_scalar(input: QuantizedTensor, other: float, *, output_quantizer=None):
    """q / s == q at scale / s (symmetric grids only, as scalar mul)."""
    return _mul_scalar(input, 1.0 / other, output_quantizer=output_quantizer)


@dispatcher.register(
    "mul",
    predicate=Predicate(
        lambda input, other, *a, **k: _is_scalar(input)
        and _symmetric_affine(other),
        name="affine_scalar_rmul",
    ),
)
def _rmul_scalar(input: float, other: QuantizedTensor, *, output_quantizer=None):
    return _mul_scalar(other, input, output_quantizer=output_quantizer)


# --- zero-exact padding ---------------------------------------------------------


@dispatcher.register(
    "pad",
    predicate=Predicate(
        lambda input, pad, mode="constant", value=None, *a, **k: (
            is_affine_per_tensor(input)
            and _symmetric_affine(input)
            and mode == "constant"
            and (value is None or value == 0.0)
        ),
        name="affine_pad_zero",
    ),
)
def _pad_zero(input: QuantizedTensor, pad, mode="constant", value=None, *,
              output_quantizer=None):
    """Constant-0 padding on a symmetric grid: real 0.0 is exactly grid 0,
    so the pad happens on the raw integers (torch's ``pad`` list: pairs
    from the last dim back)."""
    out = input.with_data(torch.nn.functional.pad(input.raw_data, tuple(pad)))
    return _requantize_output(out, output_quantizer)
