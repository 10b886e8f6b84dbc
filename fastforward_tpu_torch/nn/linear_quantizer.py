"""Static and dynamic affine quantizer modules
(`fastforward_tpu/nn/linear_quantizer.py`).

Lazy parameters: scale and offset are None until `quantization_range` is
assigned, then `nn.Parameter`s; using the quantizer before that raises.
"""

from typing import Any, Optional

import torch

from fastforward_tpu_torch.exceptions import QuantizationError
from fastforward_tpu_torch.nn.quantizer import Quantizer
from fastforward_tpu_torch.quantization import affine
from fastforward_tpu_torch.quantization.affine_function import (
    AffineQuantizationFunction,
    DynamicAffineQuantParams,
    StaticAffineQuantParams,
)
from fastforward_tpu_torch.quantization.function import QuantizationContext
from fastforward_tpu_torch.quantization.granularity import Granularity, PerTensor


def _range_tensor(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.detach().to(torch.float32).reshape(-1)
    return torch.as_tensor(value, dtype=torch.float32).reshape(-1)


class LinearQuantizer(Quantizer):
    """Static affine quantizer with a learnable scale (and offset if
    asymmetric):
      - symmetric (two-sided): offset is None;
      - symmetric one-sided: offset is a fixed (non-learnable) constant;
      - asymmetric: offset is a learnable parameter.
    """

    def __init__(
        self,
        num_bits: int,
        *,
        granularity: Optional[Granularity] = None,
        symmetric: bool = True,
        allow_one_sided: bool = True,
        quantized_dtype: Any = None,
    ):
        super().__init__()
        self.num_bits = num_bits
        self.granularity = granularity or PerTensor()
        self.symmetric = symmetric
        self.allow_one_sided = allow_one_sided
        self.quantized_dtype = quantized_dtype
        self.register_parameter("scale", None)
        self.register_parameter("offset", None)
        self._one_sided = False

    # -- the range-settable protocol ------------------------------------------

    @property
    def has_uninitialized_params(self) -> bool:
        return self.scale is None

    @property
    def quantization_range(self):
        """The (min, max) range currently represented. Raises if lazy."""
        if self.scale is None:
            raise QuantizationError(
                "Quantizer range was not set; assign quantization_range or run "
                "range estimation first."
            )
        return affine.quantization_range(self.scale, self.offset, self.num_bits)

    @quantization_range.setter
    def quantization_range(self, range_: tuple) -> None:
        min_range, max_range = (_range_tensor(r) for r in range_)
        scale, offset = affine.parameters_for_range(
            min_range,
            max_range,
            self.num_bits,
            symmetric=self.symmetric,
            allow_one_sided=self.allow_one_sided,
        )
        self.scale = torch.nn.Parameter(scale)
        if offset is None:
            self.offset = None
            self._one_sided = False
        else:
            # One-sided (unsigned) offsets are constants, asymmetric offsets
            # learnable parameters.
            self._one_sided = bool(self.symmetric)
            self.offset = torch.nn.Parameter(offset, requires_grad=not self._one_sided)

    def operator_for_range(self, min_range, max_range, data_shape):
        """A quantization context for a candidate range (used by range
        searches)."""
        scale, offset = affine.parameters_for_range(
            _range_tensor(min_range),
            _range_tensor(max_range),
            self.num_bits,
            symmetric=self.symmetric,
            allow_one_sided=self.allow_one_sided,
        )
        params = StaticAffineQuantParams(
            scale=scale,
            offset=offset,
            num_bits=self.num_bits,
            granularity=self.granularity,
            quantized_dtype=self.quantized_dtype,
        )
        return QuantizationContext(AffineQuantizationFunction, params)

    # -- quantization --------------------------------------------------------

    def quant_context(self) -> QuantizationContext:
        if self.scale is None:
            raise QuantizationError(
                "LinearQuantizer has uninitialized parameters; set "
                "quantization_range (or run range estimation) before use."
            )
        params = StaticAffineQuantParams(
            scale=self.scale,
            offset=self.offset,
            num_bits=self.num_bits,
            granularity=self.granularity,
            quantized_dtype=self.quantized_dtype,
        )
        return QuantizationContext(AffineQuantizationFunction, params)

    def quantize(self, data: torch.Tensor):
        return self.quant_context().quantize(data)

    def extra_repr(self) -> str:
        return (
            f"num_bits={self.num_bits}, granularity={self.granularity}, "
            f"symmetric={self.symmetric}"
        )


class DynamicLinearQuantizer(Quantizer):
    """Per-call min/max dynamic affine quantizer (no learned state)."""

    def __init__(
        self,
        num_bits: int,
        *,
        granularity: Optional[Granularity] = None,
        symmetric: bool = False,
        allow_one_sided: bool = True,
        quantized_dtype: Any = None,
    ):
        super().__init__()
        self.num_bits = num_bits
        self.granularity = granularity or PerTensor()
        self.symmetric = symmetric
        self.allow_one_sided = allow_one_sided
        self.quantized_dtype = quantized_dtype

    def quantize(self, data: torch.Tensor):
        params = DynamicAffineQuantParams(
            num_bits=self.num_bits,
            granularity=self.granularity,
            symmetric=self.symmetric,
            allow_one_sided=self.allow_one_sided,
            quantized_dtype=self.quantized_dtype,
        )
        return AffineQuantizationFunction.quantize(data, params)
