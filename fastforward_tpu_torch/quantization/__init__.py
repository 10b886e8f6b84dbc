"""The simulation tier's core, ported from `fastforward_tpu/quantization/`:
tiling, granularities, the quantization-function framework, `QuantizedTensor`,
affine quantization with its LSQ/STE gradients, straight-through
estimators, random quantized tensors and per-module strict quantization; ``freeze``
(baking weight quantizers into their parameters) and
``quantizer_annotations`` (the operator that fed each quantizer), which
import ``nn/`` and so are imported from their modules, not here."""

from fastforward_tpu_torch.quantization import affine, granularity, tiling
from fastforward_tpu_torch.quantization.affine import (
    dequantize_by_tile,
    integer_maximum,
    integer_minimum,
    parameters_for_range,
    quantization_range,
    quantize_by_tile,
    quantize_dynamic_by_tile,
)
from fastforward_tpu_torch.quantization.affine_function import (
    AffineQuantizationFunction,
    DynamicAffineQuantParams,
    StaticAffineQuantParams,
    dynamic_quantization_context,
    quantization_context,
    quantize_by_tile as quantize_by_tile_array,
    quantize_dynamically,
    quantize_per_block,
    quantize_per_channel,
    quantize_per_granularity,
    quantize_per_tensor,
)
from fastforward_tpu_torch.quantization.function import (
    QuantizationContext,
    QuantizationFunction,
    QuantizationParameters,
    create_quantization_function,
    register_parameters,
    static_field,
)
from fastforward_tpu_torch.quantization.granularity import (
    Granularity,
    PerBlock,
    PerChannel,
    PerTensor,
    PerTile,
    granularity_from_sizes,
    is_per_block,
    is_per_channel,
    is_per_tensor,
)
from fastforward_tpu_torch.quantization.quantized_array import (
    QuantizedTensor,
    apply_quantized,
    dequantize_if_quantized,
    is_quantized,
)
from fastforward_tpu_torch.quantization.ste import round_ste, ste

__all__ = [
    "affine",
    "granularity",
    "tiling",
    "AffineQuantizationFunction",
    "DynamicAffineQuantParams",
    "StaticAffineQuantParams",
    "QuantizationContext",
    "QuantizationFunction",
    "QuantizationParameters",
    "QuantizedTensor",
    "Granularity",
    "PerBlock",
    "PerChannel",
    "PerTensor",
    "PerTile",
]
