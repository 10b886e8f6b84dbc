"""MSE / minimum-error grid range estimator
(`fastforward_tpu/range_setting/min_error.py`).

A candidate grid of uniformly shrunk ranges, each candidate's per-tile
error accumulated across calibration batches, and the per-tile argmin
picked at cleanup; `min_error_grid` / `mse_grid` aliases.

The JAX package vmaps the candidate sweep, which holds every candidate's
quantized copy of the batch at once (100 x the batch: 5.8 GB at an 8 x 128
x 14,336 f32 activation). The port loops over the candidates, one at a
time: above the batch it holds one candidate's quantized and dequantized
copies and their squared difference (about 3 x the batch's f32 bytes) and
the (candidates, tiles) error table.
"""

from typing import Any, Callable, Optional

import torch

from fastforward_tpu_torch.forward_override import OverrideHandle
from fastforward_tpu_torch.nn.quantizer import Quantizer
from fastforward_tpu_torch.quantization import tiling
from fastforward_tpu_torch.range_setting.common import RangeEstimator, SimpleEstimatorStep
from fastforward_tpu_torch.range_setting.minmax import _tile_min_max


def mse_error(original: torch.Tensor, quantized: torch.Tensor, tile_size) -> torch.Tensor:
    """Per-tile mean squared error, flat in tile order."""
    diff = (original - quantized) ** 2
    tiled = diff.reshape(tiling.interleaved_shape(tuple(diff.shape), tile_size))
    axes = tuple(range(1, tiled.dim(), 2))
    return torch.mean(tiled, dim=axes).reshape(-1)


def uniform_search_grid(num_candidates: int = 100, min_fraction: float = 0.1,
                        device=None) -> torch.Tensor:
    """Candidate shrink factors in [min_fraction, 1], f32: the f64 grid
    rounded once (``jnp.linspace`` computes in f32, within one f32 ulp of
    it)."""
    return torch.linspace(min_fraction, 1.0, num_candidates, dtype=torch.float64,
                          device=device).float()


class MinErrorEstimatorStep(SimpleEstimatorStep):
    """Accumulates each candidate range's per-tile error over the batches;
    `finalize` sets the quantizer to the best candidate of each tile."""

    def __init__(
        self,
        quantizer: Quantizer,
        num_candidates: int = 100,
        error_fn: Optional[Callable] = None,
        disable_quantization: bool = False,
    ):
        super().__init__(quantizer, disable_quantization)
        self.num_candidates = num_candidates
        self.fractions: Optional[torch.Tensor] = None
        self.error_fn = error_fn or mse_error
        self._min: Optional[torch.Tensor] = None
        self._max: Optional[torch.Tensor] = None
        self._errors: Optional[torch.Tensor] = None  # (num_candidates, num_tiles)

    def estimate_step(self, data: Any) -> None:
        from fastforward_tpu_torch.quantization.quantized_array import QuantizedTensor

        if isinstance(data, QuantizedTensor):
            data = data.dequantize()
        data = data.detach()
        if self.fractions is None:
            self.fractions = uniform_search_grid(self.num_candidates, device=data.device)

        batch_min, batch_max = _tile_min_max(data, self.quantizer.granularity)
        self._min = batch_min if self._min is None else torch.minimum(self._min, batch_min)
        self._max = batch_max if self._max is None else torch.maximum(self._max, batch_max)

        tile = tiling.resolve_tile_size(
            self.quantizer.granularity.tile_size(tuple(data.shape)), tuple(data.shape)
        )

        def candidate_error(fraction):
            ctx = self.quantizer.operator_for_range(
                self._min * fraction, self._max * fraction, tuple(data.shape)
            )
            q = ctx.quantize(data)
            dq = q.dequantize() if isinstance(q, QuantizedTensor) else q
            return self.error_fn(data, dq, tile)

        errors = torch.stack([candidate_error(f) for f in self.fractions])
        self._errors = errors if self._errors is None else self._errors + errors

    def __call__(self, context, overridden_fn, args, kwargs):
        self.estimate_step(args[0])
        # The best range is only known at finalize(); until then the
        # quantizer may be uninitialized — pass data through unquantized.
        if self.disable_quantization or getattr(
            self.quantizer, "has_uninitialized_params", False
        ):
            return args[0]
        return overridden_fn(*args, **kwargs)

    def finalize(self) -> None:
        if self._errors is None:
            return
        best = torch.argmin(self._errors, dim=0)  # per tile, the first minimum
        fraction = self.fractions[best]
        self.quantizer.quantization_range = (self._min * fraction, self._max * fraction)


class MinErrorGridRangeEstimator(RangeEstimator):
    def __init__(
        self,
        num_candidates: int = 100,
        error_fn: Optional[Callable] = None,
        disable_quantization: bool = False,
    ):
        self.num_candidates = num_candidates
        self.error_fn = error_fn
        self.disable_quantization = disable_quantization
        self._steps: list[MinErrorEstimatorStep] = []

    def prepare(self, quantizer: Quantizer) -> OverrideHandle:
        step = MinErrorEstimatorStep(
            quantizer,
            num_candidates=self.num_candidates,
            error_fn=self.error_fn,
            disable_quantization=self.disable_quantization,
        )
        self._steps.append(step)
        return quantizer.register_override(step)

    def cleanup(self, handles: list[OverrideHandle]) -> None:
        for step in self._steps:
            step.finalize()
        self._steps.clear()
        super().cleanup(handles)


min_error_grid = MinErrorGridRangeEstimator
mse_grid = MinErrorGridRangeEstimator
