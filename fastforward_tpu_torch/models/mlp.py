"""The 2-layer MLP of the JAX package's per-tensor INT8 parity milestone
(`fastforward_tpu/models/mlp.py`)."""

import torch

from fastforward_tpu_torch.models.llama import _linear, _placement


class MLP(torch.nn.Module):
    """fc1, ReLU, fc2 (with biases); weights N(0, 1 / in) from a seeded
    generator on ``device`` (default: the GPU), biases zero."""

    def __init__(self, din: int = 128, dhidden: int = 512, dout: int = 128, device=None,
                 generator=None):
        super().__init__()
        dev, gen = _placement(device, generator)
        self.fc1 = _linear(din, dhidden, torch.float32, dev, gen, bias=True)
        self.fc2 = _linear(dhidden, dout, torch.float32, dev, gen, bias=True)

    def forward(self, x):
        from fastforward_tpu_torch import ops
        from fastforward_tpu_torch.quantization.quantized_array import QuantizedTensor

        h = self.fc1(x)
        if isinstance(h, QuantizedTensor):
            h = ops.relu(h, strict_quantization=False)
        else:
            h = torch.relu(h)
        return self.fc2(h)
