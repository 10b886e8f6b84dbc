"""Model-wide quantization enable/disable (`fastforward_tpu/overrides.py`).

`disable_quantization` attaches a short-circuiting override to every
quantizer of a model and also sets ``strict_quantization(False)`` for the
context, so a disabled model runs like the unquantized original;
`enable_quantization` turns them back on inside such a context.
"""

import contextlib
from typing import Any, Iterator

from fastforward_tpu_torch import flags
from fastforward_tpu_torch.forward_override import OverrideHandle
from fastforward_tpu_torch.nn.quantized_module import named_quantizers


class DisableQuantizationOverride:
    """Override that bypasses quantization (identity) while disabled."""

    def __init__(self) -> None:
        self._quantization_enabled = False
        self._handles: list[OverrideHandle] = []

    def __call__(self, context, overridden_fn, args, kwargs):
        if self._quantization_enabled:
            return overridden_fn(*args, **kwargs)
        return args[0]

    @contextlib.contextmanager
    def enable_quantization(self) -> Iterator[None]:
        prev = self._quantization_enabled
        self._quantization_enabled = True
        try:
            yield
        finally:
            self._quantization_enabled = prev

    def attach_to(self, model: Any) -> "DisableQuantizationOverride":
        for _, quantizer in named_quantizers(model):
            self._handles.append(quantizer.register_override(self))
        return self

    def detach(self) -> None:
        for handle in self._handles:
            handle.remove()
        self._handles.clear()


@contextlib.contextmanager
def disable_quantization(model: Any) -> Iterator[None]:
    """Disable all quantizers of ``model`` within the context; the strict
    quantization flag is False there too."""
    override = DisableQuantizationOverride().attach_to(model)
    try:
        with flags.strict_quantization(False):
            yield
    finally:
        override.detach()


@contextlib.contextmanager
def enable_quantization(model: Any) -> Iterator[None]:
    """Re-enable quantization inside a `disable_quantization` scope (the
    strict flag is left as it is)."""
    with contextlib.ExitStack() as stack:
        for _, quantizer in named_quantizers(model):
            for handle in getattr(quantizer, "_overrides", []):
                if isinstance(handle.override, DisableQuantizationOverride):
                    stack.enter_context(handle.override.enable_quantization())
        yield
