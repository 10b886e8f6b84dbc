"""Quantizer initialization helpers for tests
(`fastforward_tpu/testing/initialization.py`)."""

from typing import Optional

import torch

from fastforward_tpu_torch.nn.linear_quantizer import LinearQuantizer
from fastforward_tpu_torch.nn.quantized_module import QuantizedModule
from fastforward_tpu_torch.quantization.granularity import Granularity


def initialize_quantizers_to_linear_quantizer(
    model: torch.nn.Module,
    num_bits: int = 8,
    granularity: Optional[Granularity] = None,
    symmetric: bool = False,
    default_range: tuple = (-4.0, 4.0),
) -> None:
    """Replace every quantizer of the model's `QuantizedModule`s with a
    `LinearQuantizer` whose range is ``default_range``, keeping each slot's
    metadata; its scale and offset on the module's device (reference
    `testing/initialization.py:16`)."""
    for module in list(model.modules()):
        if not isinstance(module, QuantizedModule):
            continue
        dev = next((t.device for t in (*module.parameters(), *module.buffers())), None)
        for name, q in list(module.named_quantizers()):
            lq = LinearQuantizer(num_bits=num_bits, granularity=granularity, symmetric=symmetric)
            lq.quantization_range = default_range
            if q.quant_metadata is not None:
                lq.quant_metadata = q.quant_metadata
            setattr(module, name, lq.to(dev) if dev is not None else lq)
