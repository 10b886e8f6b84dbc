"""Operator-metadata annotation for quantizers
(`fastforward_tpu/quantization/quantizer_annotations.py`).

One sample forward records, for each quantizer, the quantized operator that
ran last before it (``quant_metadata.producing_operator``): every operator
reports itself through `ops.optable.OP_OBSERVERS`, and an override on each
quantizer reads the last report.
"""

import contextlib
from contextvars import ContextVar
from typing import Any, Iterator, Optional

from fastforward_tpu_torch.nn.quantized_module import named_quantizers
from fastforward_tpu_torch.nn.quantizer import Quantizer, QuantizerMetadata
from fastforward_tpu_torch.ops import optable as _optable

_LAST_OP: ContextVar[Optional[str]] = ContextVar("annotation_last_op", default=None)
_ACTIVE: ContextVar[bool] = ContextVar("annotation_active", default=False)


def record_op(op_name: str) -> None:
    """Called by the op layer when an operator executes (annotation mode)."""
    if _ACTIVE.get():
        _LAST_OP.set(op_name)


if record_op not in _optable.OP_OBSERVERS:
    _optable.OP_OBSERVERS.append(record_op)


class _AnnotationOverride:
    def __init__(self, quantizer: Quantizer):
        self.quantizer = quantizer

    def __call__(self, context, overridden_fn, args, kwargs):
        op = _LAST_OP.get()
        if op is not None and self.quantizer.quant_metadata is not None:
            self.quantizer.quant_metadata = self.quantizer.quant_metadata.with_extras(
                producing_operator=op
            )
        elif op is not None:
            meta = QuantizerMetadata()
            meta.producing_operator = op  # type: ignore[attr-defined]
            self.quantizer.quant_metadata = meta
        return overridden_fn(*args, **kwargs)


@contextlib.contextmanager
def _annotation_mode() -> Iterator[None]:
    token = _ACTIVE.set(True)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def annotate_operator_metadata(model: Any, *sample_args: Any, **sample_kwargs: Any) -> None:
    """Run one forward and tag each quantizer's metadata with the operator
    that fed it (``quant_metadata.producing_operator``)."""
    from fastforward_tpu_torch import flags

    handles = []
    for _, quantizer in named_quantizers(model, remove_duplicate=True):
        handles.append(quantizer.register_override(_AnnotationOverride(quantizer)))
    try:
        with _annotation_mode(), flags.strict_quantization(False):
            model(*sample_args, **sample_kwargs)
    finally:
        for handle in handles:
            handle.remove()
