"""Quantization quality metrics (`fastforward_tpu/utils/metrics.py`)."""

import torch


def sqnr(original, quantized, eps: float = 1e-20) -> torch.Tensor:
    """Signal-to-quantization-noise ratio in dB, in float32; a
    `QuantizedTensor` on either side is dequantized first."""
    from fastforward_tpu_torch.quantization.quantized_array import QuantizedTensor

    if isinstance(quantized, QuantizedTensor):
        quantized = quantized.dequantize()
    if isinstance(original, QuantizedTensor):
        original = original.dequantize()
    original = torch.as_tensor(original).float()
    quantized = torch.as_tensor(quantized).float().to(original.device)
    signal = torch.mean(original ** 2)
    noise = torch.mean((original - quantized) ** 2)
    return 10.0 * torch.log10(signal / (noise + eps))
