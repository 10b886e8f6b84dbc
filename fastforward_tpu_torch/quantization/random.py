"""Random quantized tensors for tests and prototyping
(`fastforward_tpu/quantization/random.py`)."""

from typing import Any, Optional

import torch

from fastforward_tpu_torch.device import resolve_device
from fastforward_tpu_torch.quantization.affine_function import quantize_per_granularity
from fastforward_tpu_torch.quantization.granularity import Granularity, PerTensor
from fastforward_tpu_torch.quantization.quantized_array import QuantizedTensor


def random_quantized(shape: tuple, *, generator: Optional[torch.Generator] = None,
                     num_bits: int = 8, granularity: Optional[Granularity] = None,
                     scale: float = 0.02, offset: Optional[float] = None,
                     quantized_dtype: Any = None, device=None) -> QuantizedTensor:
    """A `QuantizedTensor` of on-grid data: f32 normals from ``generator``
    (a ``torch.Generator`` on ``device``; None: a fresh one seeded 0)
    quantized with one ``scale`` (and ``offset``) per tile of
    ``granularity`` (default per tensor). ``device``: None for the GPU."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    granularity = granularity or PerTensor()
    data = torch.randn(shape, generator=generator, dtype=torch.float32, device=dev)
    n = granularity.parameter_dimensionality(shape)
    scale_t = torch.full((n,), scale, dtype=torch.float32, device=dev)
    offset_t = None if offset is None else torch.full((n,), offset, dtype=torch.float32,
                                                      device=dev)
    return quantize_per_granularity(data, granularity, scale_t, offset_t, num_bits=num_bits,
                                    quantized_dtype=quantized_dtype)
