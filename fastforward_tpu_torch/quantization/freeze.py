"""Freeze quantized parameters (`fastforward_tpu/quantization/freeze.py`).

`freeze_parameters` bakes each weight and bias quantizer's quantization into
the stored parameter (quantize, then dequantize, once) and short-circuits
the quantizer afterwards, so later forwards skip that work and run the
dense fallback on the baked weights. The result stays in the simulation
tier (dequantized weights, the reference's semantics).
"""

from typing import Any

import torch

from fastforward_tpu_torch.forward_override import OverrideHandle
from fastforward_tpu_torch.nn.quantized_module import QuantizedModule
from fastforward_tpu_torch.nn.quantizer import QuantizerStub
from fastforward_tpu_torch.quantization.quantized_array import QuantizedTensor


class _FrozenPassthrough:
    """Override that skips quantization (the data is already on the grid)."""

    def __call__(self, context, overridden_fn, args, kwargs):
        return args[0]


def freeze_parameters(model: Any) -> list[OverrideHandle]:
    """Quantize-dequantize every weight and bias parameter once, store the
    result back into its module, and disable the matching quantizers.

    Returns the override handles (remove them to unfreeze; the baked
    parameters stay).
    """
    handles: list[OverrideHandle] = []
    for module in list(model.modules()):
        if not isinstance(module, QuantizedModule):
            continue
        for attr, qname in (("weight", "weight_quantizer"), ("bias", "bias_quantizer")):
            quantizer = getattr(module, qname, None)
            param = getattr(module, attr, None)
            if quantizer is None or isinstance(quantizer, QuantizerStub):
                continue
            if param is None or not isinstance(param, torch.nn.Parameter):
                continue
            if getattr(quantizer, "has_uninitialized_params", False):
                continue
            with torch.no_grad():
                out = quantizer(param)
                baked = out.dequantize() if isinstance(out, QuantizedTensor) else out
            setattr(module, attr, torch.nn.Parameter(baked, requires_grad=param.requires_grad))
            handles.append(quantizer.register_override(_FrozenPassthrough()))
    return handles


def unfreeze(handles: list[OverrideHandle]) -> None:
    for handle in handles:
        handle.remove()
