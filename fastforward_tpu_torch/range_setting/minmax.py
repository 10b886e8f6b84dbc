"""Min-max range estimators (`fastforward_tpu/range_setting/minmax.py`).

`SmoothedMinMaxEstimator` (an EMA of per-tile min/max) and
`RunningMinMaxEstimator` (running min/max over batches), with the
`smoothed_minmax` / `running_minmax` aliases. A batch's reductions are two
torch reductions over the quantizer's tile view of the data.
"""

from typing import Any, Optional

import torch

from fastforward_tpu_torch.quantization import tiling
from fastforward_tpu_torch.range_setting.common import (
    SimpleEstimatorStep,
    _StepEstimator,
)


def _tile_min_max(data: Any, granularity) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tile (min, max) of ``data`` (a `QuantizedTensor` dequantized
    first), flat in tile order, detached from autograd."""
    from fastforward_tpu_torch.quantization.quantized_array import QuantizedTensor

    if isinstance(data, QuantizedTensor):
        data = data.dequantize()
    data = data.detach()
    tile = tiling.resolve_tile_size(granularity.tile_size(tuple(data.shape)), tuple(data.shape))
    tiled = data.reshape(tiling.interleaved_shape(tuple(data.shape), tile))
    axes = tuple(range(1, tiled.dim(), 2))
    return torch.amin(tiled, dim=axes).reshape(-1), torch.amax(tiled, dim=axes).reshape(-1)


class SmoothedMinMaxEstimatorStep(SimpleEstimatorStep):
    """EMA of per-tile min/max: ``running = γ·running + (1-γ)·batch``."""

    def __init__(self, quantizer, gamma: float = 0.9, disable_quantization: bool = False):
        super().__init__(quantizer, disable_quantization)
        self.gamma = gamma
        self._min: Optional[torch.Tensor] = None
        self._max: Optional[torch.Tensor] = None

    def estimate_step(self, data: Any) -> None:
        batch_min, batch_max = _tile_min_max(data, self.quantizer.granularity)
        if self._min is None:
            self._min, self._max = batch_min, batch_max
        else:
            g = self.gamma
            self._min = g * self._min + (1 - g) * batch_min
            self._max = g * self._max + (1 - g) * batch_max
        self.quantizer.quantization_range = (self._min, self._max)


class RunningMinMaxEstimatorStep(SimpleEstimatorStep):
    """Global min/max across all observed batches."""

    def __init__(self, quantizer, disable_quantization: bool = False):
        super().__init__(quantizer, disable_quantization)
        self._min: Optional[torch.Tensor] = None
        self._max: Optional[torch.Tensor] = None

    def estimate_step(self, data: Any) -> None:
        batch_min, batch_max = _tile_min_max(data, self.quantizer.granularity)
        if self._min is None:
            self._min, self._max = batch_min, batch_max
        else:
            self._min = torch.minimum(self._min, batch_min)
            self._max = torch.maximum(self._max, batch_max)
        self.quantizer.quantization_range = (self._min, self._max)


class SmoothedMinMaxRangeEstimator(_StepEstimator):
    def __init__(self, gamma: float = 0.9, disable_quantization: bool = False):
        super().__init__(
            SmoothedMinMaxEstimatorStep,
            gamma=gamma,
            disable_quantization=disable_quantization,
        )


class RunningMinMaxRangeEstimator(_StepEstimator):
    def __init__(self, disable_quantization: bool = False):
        super().__init__(
            RunningMinMaxEstimatorStep, disable_quantization=disable_quantization
        )


smoothed_minmax = SmoothedMinMaxRangeEstimator
running_minmax = RunningMinMaxRangeEstimator
