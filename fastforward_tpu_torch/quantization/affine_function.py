"""Affine quantization function, its parameter dataclasses and the
convenience constructors (`fastforward_tpu/quantization/affine_function.py`).

Parameters are tensors (or Python numbers) and configuration fields; the
quantized result is a `QuantizedTensor` whose context carries static
parameters (a dynamic quantization's inferred scale and offset included).
"""

import dataclasses
from typing import Any, Callable, Optional, Sequence, Union

import torch

from fastforward_tpu_torch import flags
from fastforward_tpu_torch.exceptions import ExportError
from fastforward_tpu_torch.quantization import affine, granularity as granularities
from fastforward_tpu_torch.quantization.function import (
    QuantizationContext,
    QuantizationFunction,
    QuantizationParameters,
    register_parameters,
    static_field,
)
from fastforward_tpu_torch.quantization.quantized_array import QuantizedTensor

Granularity = granularities.Granularity
ScaleOrFloat = Union[torch.Tensor, float]


@register_parameters
@dataclasses.dataclass
class StaticAffineQuantParams(QuantizationParameters):
    """Parameters for static affine quantization."""

    scale: ScaleOrFloat
    offset: Optional[ScaleOrFloat]
    num_bits: int = static_field(default=8)
    granularity: Granularity = static_field(default_factory=granularities.PerTensor)
    quantized_dtype: Any = static_field(default=None)
    dequantize_dtype: Any = static_field(default=None)


@register_parameters
@dataclasses.dataclass
class DynamicAffineQuantParams(QuantizationParameters):
    """Parameters for dynamic affine quantization."""

    num_bits: int = static_field(default=8)
    granularity: Granularity = static_field(default_factory=granularities.PerTensor)
    symmetric: bool = static_field(default=False)
    allow_one_sided: bool = static_field(default=True)
    quantized_dtype: Any = static_field(default=None)
    dequantize_dtype: Any = static_field(default=None)
    parameter_inference_fn: Optional[Callable] = static_field(default=None)


class AffineQuantizationFunction(QuantizationFunction):
    """Standard affine quantization: q = clamp(round(x/s - round(o)))."""

    @classmethod
    def quantize(cls, data: torch.Tensor, params):
        # Re-quantization: an already-quantized input moves onto this
        # quantizer's grid via its real values (chained quantizers are common
        # between layers — the producer's output quantizer feeds the
        # consumer's input quantizer).
        if isinstance(data, QuantizedTensor):
            data = data.dequantize()
        if flags.get_export_mode():
            return cls._export_quantize(data, params)
        if isinstance(params, StaticAffineQuantParams):
            return cls._static_quantize(data, params)
        if isinstance(params, DynamicAffineQuantParams):
            return cls._dynamic_quantize(data, params)
        raise TypeError(f"Unsupported type for argument 'params': '{type(params)}'")

    @classmethod
    def _export_quantize(cls, data: torch.Tensor, params) -> torch.Tensor:
        """Quantize-then-dequantize, returning a plain tensor (the QDQ form
        of an export graph)."""
        if not isinstance(params, StaticAffineQuantParams):
            raise ExportError("Export supports only static affine quantization.")
        tile_size = params.granularity.tile_size(data.shape)
        q = affine.quantize_by_tile(
            data,
            params.scale,
            params.offset,
            tile_size=tile_size,
            num_bits=params.num_bits,
            output_dtype=params.quantized_dtype or data.dtype,
        )
        return affine.dequantize_by_tile(
            q,
            params.scale,
            params.offset,
            tile_size=tile_size,
            output_dtype=params.dequantize_dtype or data.dtype,
        )

    @classmethod
    def _static_quantize(cls, data: torch.Tensor, params: StaticAffineQuantParams):
        tile_size = params.granularity.tile_size(data.shape)
        q = affine.quantize_by_tile(
            data,
            params.scale,
            params.offset,
            tile_size=tile_size,
            num_bits=params.num_bits,
            output_dtype=params.quantized_dtype or data.dtype,
        )
        params = params.with_changes(dequantize_dtype=params.dequantize_dtype or data.dtype)
        return QuantizedTensor(q, QuantizationContext(cls, params))

    @classmethod
    def _dynamic_quantize(cls, data: torch.Tensor, params: DynamicAffineQuantParams):
        if params.parameter_inference_fn is not None:
            scale, offset = params.parameter_inference_fn(params, data)
            static_params = _static_from_dynamic(
                params, scale, offset, dequantize_dtype=params.dequantize_dtype or data.dtype
            )
            return cls._static_quantize(data, static_params)

        tile_size = params.granularity.tile_size(data.shape)
        q, scale, offset = affine.quantize_dynamic_by_tile(
            data,
            tile_size=tile_size,
            num_bits=params.num_bits,
            symmetric=params.symmetric,
            allow_one_sided=params.allow_one_sided,
            output_dtype=params.quantized_dtype or data.dtype,
        )
        static_params = _static_from_dynamic(
            params, scale, offset, dequantize_dtype=params.dequantize_dtype or data.dtype
        )
        return QuantizedTensor(q, QuantizationContext(cls, static_params))

    @classmethod
    def dequantize(cls, data: torch.Tensor, params) -> torch.Tensor:
        if isinstance(params, DynamicAffineQuantParams):
            raise TypeError("Cannot dequantize a QuantizedTensor with dynamic parameters.")
        tile_size = params.granularity.tile_size(data.shape)
        return affine.dequantize_by_tile(
            data,
            params.scale,
            params.offset,
            tile_size=tile_size,
            output_dtype=params.dequantize_dtype,
        )


def _static_from_dynamic(
    params: DynamicAffineQuantParams,
    scale: torch.Tensor,
    offset: Optional[torch.Tensor],
    **changes: Any,
) -> StaticAffineQuantParams:
    """Convert dynamic params + inferred (scale, offset) to static params."""
    static_fields = {f.name for f in dataclasses.fields(StaticAffineQuantParams)}
    args = {
        f.name: getattr(params, f.name)
        for f in dataclasses.fields(params)
        if f.name in static_fields
    }
    args["scale"] = scale
    args["offset"] = offset
    args.update(changes)
    return StaticAffineQuantParams(**args)


# --- convenience constructors


def quantization_context(
    scale: ScaleOrFloat,
    offset: Optional[ScaleOrFloat] = None,
    *,
    num_bits: int = 8,
    granularity: Optional[Granularity] = None,
    quantized_dtype: Any = None,
    dequantize_dtype: Any = None,
) -> QuantizationContext:
    """Build a static affine QuantizationContext."""
    params = StaticAffineQuantParams(
        scale=scale,
        offset=offset,
        num_bits=num_bits,
        granularity=granularity or granularities.PerTensor(),
        quantized_dtype=quantized_dtype,
        dequantize_dtype=dequantize_dtype,
    )
    return QuantizationContext(AffineQuantizationFunction, params)


def dynamic_quantization_context(
    *,
    num_bits: int = 8,
    granularity: Optional[Granularity] = None,
    symmetric: bool = False,
    allow_one_sided: bool = True,
    quantized_dtype: Any = None,
    dequantize_dtype: Any = None,
) -> QuantizationContext:
    """Build a dynamic affine QuantizationContext."""
    params = DynamicAffineQuantParams(
        num_bits=num_bits,
        granularity=granularity or granularities.PerTensor(),
        symmetric=symmetric,
        allow_one_sided=allow_one_sided,
        quantized_dtype=quantized_dtype,
        dequantize_dtype=dequantize_dtype,
    )
    return QuantizationContext(AffineQuantizationFunction, params)


def quantize_per_granularity(
    data: torch.Tensor,
    granularity: Granularity,
    scale: ScaleOrFloat,
    offset: Optional[ScaleOrFloat] = None,
    *,
    num_bits: int = 8,
    quantized_dtype: Any = None,
) -> QuantizedTensor:
    """Statically quantize ``data`` using an explicit granularity."""
    context = quantization_context(
        scale, offset, num_bits=num_bits, granularity=granularity,
        quantized_dtype=quantized_dtype,
    )
    return context.quantize(data)


def quantize_per_tensor(
    data: torch.Tensor,
    scale: ScaleOrFloat,
    offset: Optional[ScaleOrFloat] = None,
    *,
    num_bits: int = 8,
    quantized_dtype: Any = None,
) -> QuantizedTensor:
    """Statically quantize ``data`` with one (scale, offset)."""
    return quantize_per_granularity(
        data, granularities.PerTensor(), scale, offset,
        num_bits=num_bits, quantized_dtype=quantized_dtype,
    )


def quantize_per_channel(
    data: torch.Tensor,
    channel_dim: int | Sequence[int],
    scale: ScaleOrFloat,
    offset: Optional[ScaleOrFloat] = None,
    *,
    num_bits: int = 8,
    quantized_dtype: Any = None,
) -> QuantizedTensor:
    """Statically quantize ``data`` per index of ``channel_dim``."""
    return quantize_per_granularity(
        data, granularities.PerChannel(channel_dim), scale, offset,
        num_bits=num_bits, quantized_dtype=quantized_dtype,
    )


def quantize_by_tile(
    data: torch.Tensor,
    tile_size: Sequence[int],
    scale: ScaleOrFloat,
    offset: Optional[ScaleOrFloat] = None,
    *,
    num_bits: int = 8,
    quantized_dtype: Any = None,
) -> QuantizedTensor:
    """Statically quantize ``data`` per tile of ``tile_size``."""
    return quantize_per_granularity(
        data, granularities.PerTile(tuple(tile_size)), scale, offset,
        num_bits=num_bits, quantized_dtype=quantized_dtype,
    )


def quantize_per_block(
    data: torch.Tensor,
    block_dims: int | Sequence[int],
    block_sizes: int | Sequence[int],
    scale: ScaleOrFloat,
    offset: Optional[ScaleOrFloat] = None,
    *,
    per_channel_dims: int | Sequence[int] = (),
    num_bits: int = 8,
    quantized_dtype: Any = None,
) -> QuantizedTensor:
    """Statically quantize ``data`` per block (`granularity.PerBlock`)."""
    gran = granularities.PerBlock(block_dims, block_sizes, per_channel_dims)
    return quantize_per_granularity(
        data, gran, scale, offset, num_bits=num_bits, quantized_dtype=quantized_dtype,
    )


def quantize_dynamically(
    data: torch.Tensor,
    granularity: Optional[Granularity] = None,
    *,
    num_bits: int = 8,
    symmetric: bool = False,
    allow_one_sided: bool = True,
    quantized_dtype: Any = None,
) -> QuantizedTensor:
    """Dynamically quantize with per-call min/max parameter inference."""
    context = dynamic_quantization_context(
        num_bits=num_bits,
        granularity=granularity,
        symmetric=symmetric,
        allow_one_sided=allow_one_sided,
        quantized_dtype=quantized_dtype,
    )
    return context.quantize(data)
