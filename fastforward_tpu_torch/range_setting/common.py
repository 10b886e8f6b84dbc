"""Range estimation framework (`fastforward_tpu/range_setting/common.py`).

The `RangeSettable` / `SupportsRangeBasedOperator` protocols, the
`RangeEstimator` ABC, `SimpleEstimatorStep` (an estimator attached to a
quantizer as an override of its quantize) and the `estimate_ranges`
context manager.
"""

import abc
import contextlib
from typing import Any, Callable, Iterator, Protocol, runtime_checkable

from fastforward_tpu_torch.forward_override import OverrideHandle
from fastforward_tpu_torch.nn.quantized_module import named_quantizers
from fastforward_tpu_torch.nn.quantizer import Quantizer, QuantizerStub


@runtime_checkable
class RangeSettable(Protocol):
    """A quantizer whose range can be read/written."""

    granularity: Any

    @property
    def quantization_range(self) -> tuple: ...

    @quantization_range.setter
    def quantization_range(self, value: tuple) -> None: ...


@runtime_checkable
class SupportsRangeBasedOperator(Protocol):
    """A quantizer that can produce a quantization operator for a candidate
    range without mutating its state (used by grid search)."""

    def operator_for_range(self, min_range, max_range, data_shape) -> Any: ...


class RangeEstimator(abc.ABC):
    """Per-quantizer range estimation strategy.

    `split_module` selects the quantizers to estimate; `prepare` attaches the
    estimation step to one quantizer; `cleanup` detaches it.
    """

    def split_module(self, model: Any) -> Iterator[Quantizer]:
        for _, quantizer in named_quantizers(model):
            if isinstance(quantizer, QuantizerStub):
                continue
            if isinstance(quantizer, RangeSettable):
                yield quantizer

    @abc.abstractmethod
    def prepare(self, quantizer: Quantizer) -> OverrideHandle: ...

    def cleanup(self, handles: list[OverrideHandle]) -> None:
        for handle in handles:
            handle.remove()


class SimpleEstimatorStep(abc.ABC):
    """An estimator step installed as a quantizer override: observes the data,
    updates the quantizer's range, then runs the (possibly disabled)
    quantization.
    """

    def __init__(self, quantizer: Quantizer, disable_quantization: bool = False):
        self.quantizer = quantizer
        self.disable_quantization = disable_quantization

    @abc.abstractmethod
    def estimate_step(self, data: Any) -> None:
        """Observe one batch and update ``self.quantizer``'s range."""

    def __call__(self, context, overridden_fn, args, kwargs):
        data = args[0]
        self.estimate_step(data)
        if self.disable_quantization:
            return data
        return overridden_fn(*args, **kwargs)


class _StepEstimator(RangeEstimator):
    """RangeEstimator installing a `SimpleEstimatorStep` per quantizer."""

    def __init__(self, step_cls: type[SimpleEstimatorStep], **step_kwargs: Any):
        self._step_cls = step_cls
        self._step_kwargs = step_kwargs

    def make_step(self, quantizer: Quantizer) -> SimpleEstimatorStep:
        """The step this estimator installs on ``quantizer``; what consumers
        that are not modules (the fx autoquant plan) call."""
        return self._step_cls(quantizer, **self._step_kwargs)

    def prepare(self, quantizer: Quantizer) -> OverrideHandle:
        return quantizer.register_override(self.make_step(quantizer))


def step_factory(estimator: Any = None):
    """Any estimator spec as ``callable(quantizer) -> step``: None (running
    min-max), a `SimpleEstimatorStep` subclass, or a step estimator's class
    or instance (`running_minmax`, `smoothed_minmax`). The one step API of
    the module path and the fx plan (`autoquant_fx`)."""
    if estimator is None:
        from fastforward_tpu_torch.range_setting.minmax import RunningMinMaxEstimatorStep

        return RunningMinMaxEstimatorStep
    if isinstance(estimator, type) and issubclass(estimator, SimpleEstimatorStep):
        return estimator
    inst = estimator() if isinstance(estimator, type) else estimator
    if isinstance(inst, _StepEstimator):
        return inst.make_step
    raise TypeError(f"unsupported estimator {estimator!r}")


@contextlib.contextmanager
def estimate_ranges(
    model: Any,
    estimator: Callable[..., RangeEstimator] | RangeEstimator,
    **estimator_kwargs: Any,
) -> Iterator[RangeEstimator]:
    """Attach a range estimator to every quantizer of ``model`` for the
    duration of the context; run calibration batches inside.

        with ff.estimate_ranges(model, ff.range_setting.smoothed_minmax):
            for batch in data:
                model(batch)
    """
    if not isinstance(estimator, RangeEstimator):
        estimator = estimator(**estimator_kwargs)
    handles: list[OverrideHandle] = []
    try:
        for quantizer in estimator.split_module(model):
            handles.append(estimator.prepare(quantizer))
        yield estimator
    finally:
        estimator.cleanup(handles)
