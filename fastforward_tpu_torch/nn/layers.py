"""Quantized counterparts of `torch.nn` layers (`fastforward_tpu/nn/layers.py`).

Each counterpart installs input / weight / bias / output `QuantizerStub`s
in `__init_quantization__` and routes its forward through
`fastforward_tpu_torch.ops`. They register against `torch.nn.Linear`,
`Conv1d/2d/3d`, `Embedding`, `LayerNorm`, `RMSNorm`, `Sequential`, `ReLU`,
`SiLU`, `Dropout` and this module's `Einsum`, so a model built from them
converts with `quantize_model` unchanged. Class names are the JAX package's,
with torch's rank suffix for the convolutions.

`Einsum` mirrors ``flax.nnx.Einsum`` (an einsum string, kernel and bias
shapes), which has no `torch.nn` counterpart, so that `QuantizedEinsum` has
a module to convert.
"""

import math
from typing import Any, Optional, Sequence

import torch

from fastforward_tpu_torch import ops
from fastforward_tpu_torch.nn.quantized_module import QuantizedModule
from fastforward_tpu_torch.nn.quantizer import QuantizerStub
from fastforward_tpu_torch.quantization.quantized_array import QuantizedTensor


def _install_stubs(module: torch.nn.Module, *slots: str) -> None:
    for slot in slots:
        setattr(module, f"{slot}_quantizer", QuantizerStub(**{f"{slot}_quantizer": True}))


def _quantized_param(module: torch.nn.Module, name: str, slot: str):
    param = getattr(module, name)
    return None if param is None else getattr(module, slot)(param)


class Einsum(torch.nn.Module):
    """``einsum(einsum_str, x, weight) (+ bias)``: a learnable kernel of
    ``kernel_shape`` contracted with the input by an einsum string of two
    operands, and a bias of ``bias_shape`` broadcast over the output dims
    the kernel keeps (`flax.nnx.Einsum`)."""

    def __init__(self, einsum_str: str, kernel_shape: Sequence[int],
                 bias_shape: Optional[Sequence[int]] = None, *, dtype=None, device=None):
        super().__init__()
        self.einsum_str = einsum_str.replace(" ", "")
        kw = dict(dtype=dtype, device=device)
        self.weight = torch.nn.Parameter(torch.empty(tuple(kernel_shape), **kw))
        if bias_shape is None:
            self.register_parameter("bias", None)
        else:
            self.bias = torch.nn.Parameter(torch.zeros(tuple(bias_shape), **kw))
        fan_in = max(1, self.weight.numel() // max(1, self.weight.shape[-1]))
        with torch.no_grad():
            self.weight.normal_(0.0, 1.0 / math.sqrt(fan_in))

    def _bias_shape(self, out_ndim: int) -> tuple:
        """The bias's shape broadcast to the output: a kept kernel dim's
        size where the output has that subscript, else 1."""
        lhs, out = self.einsum_str.split("->")
        rhs = lhs.split(",")[1]
        letters = out.replace("...", "")
        lead = out_ndim - len(letters)
        shape, i = [], 0
        for part in out.split("..."):
            if i:
                shape += [1] * lead
            shape += [self.weight.shape[rhs.index(c)] if c in rhs else 1 for c in part]
            i += 1
        return tuple(shape)

    def forward(self, x):
        y = torch.einsum(self.einsum_str, x, self.weight)
        if self.bias is not None:
            y = y + self.bias.reshape(self._bias_shape(y.dim()))
        return y


class QuantizedLinear(QuantizedModule, torch.nn.Linear):
    """Quantized `torch.nn.Linear`: ``ops.linear(x, weight, bias)`` with the
    weight in torch's (out, in) layout."""

    def __init_quantization__(self) -> None:
        super().__init_quantization__()
        _install_stubs(self, "input", "weight", "bias", "output")

    def forward(self, x):
        x = self.input_quantizer(x)
        weight = self.weight_quantizer(self.weight)
        bias = _quantized_param(self, "bias", "bias_quantizer")
        return ops.linear(x, weight, bias, output_quantizer=self.output_quantizer)


class QuantizedEinsum(QuantizedModule, Einsum):
    def __init_quantization__(self) -> None:
        super().__init_quantization__()
        _install_stubs(self, "input", "weight", "bias", "output")

    def forward(self, x):
        x = self.input_quantizer(x)
        weight = self.weight_quantizer(self.weight)
        bias = _quantized_param(self, "bias", "bias_quantizer")
        return ops.einsum_linear(self.einsum_str, x, weight, bias,
                                 output_quantizer=self.output_quantizer)


class _QuantizedConvNd(QuantizedModule):
    """The convolutions' forward (N, C, spatial... inputs; torch's weight
    layout). A padding mode other than zeros pads through `ops.pad` first,
    as `torch.nn.Conv2d` pads through `F.pad`."""

    def __init_quantization__(self) -> None:
        super().__init_quantization__()
        _install_stubs(self, "input", "weight", "bias", "output")

    def forward(self, x):
        x = self.input_quantizer(x)
        weight = self.weight_quantizer(self.weight)
        bias = _quantized_param(self, "bias", "bias_quantizer")
        padding = self.padding
        if self.padding_mode != "zeros":
            x = ops.pad(x, self._reversed_padding_repeated_twice, mode=self.padding_mode)
            padding = 0
        op = {1: ops.conv1d, 2: ops.conv2d, 3: ops.conv3d}[len(self.kernel_size)]
        return op(x, weight, bias, stride=self.stride, padding=padding, dilation=self.dilation,
                  groups=self.groups, output_quantizer=self.output_quantizer)


class QuantizedConv1d(_QuantizedConvNd, torch.nn.Conv1d):
    """Quantized `torch.nn.Conv1d`."""


class QuantizedConv2d(_QuantizedConvNd, torch.nn.Conv2d):
    """Quantized `torch.nn.Conv2d`."""


class QuantizedConv3d(_QuantizedConvNd, torch.nn.Conv3d):
    """Quantized `torch.nn.Conv3d`."""


class QuantizedEmbed(QuantizedModule, torch.nn.Embedding):
    """Quantized `torch.nn.Embedding`."""

    def __init_quantization__(self) -> None:
        super().__init_quantization__()
        _install_stubs(self, "weight", "output")

    def forward(self, x):
        table = self.weight_quantizer(self.weight)
        return ops.embedding(x, table, self.padding_idx, self.max_norm,
                             output_quantizer=self.output_quantizer)


class QuantizedLayerNorm(QuantizedModule, torch.nn.LayerNorm):
    """Quantized `torch.nn.LayerNorm`."""

    def __init_quantization__(self) -> None:
        super().__init_quantization__()
        _install_stubs(self, "input", "weight", "bias", "output")

    def forward(self, x):
        x = self.input_quantizer(x)
        weight = _quantized_param(self, "weight", "weight_quantizer")
        bias = _quantized_param(self, "bias", "bias_quantizer")
        return ops.layer_norm(x, self.normalized_shape, weight, bias, eps=self.eps,
                              output_quantizer=self.output_quantizer)


class QuantizedRMSNorm(QuantizedModule, torch.nn.RMSNorm):
    """Quantized `torch.nn.RMSNorm` over the last dim (``eps=None`` is the
    input dtype's machine epsilon, as torch's)."""

    def __init_quantization__(self) -> None:
        super().__init_quantization__()
        if len(self.normalized_shape) != 1:
            raise ValueError(f"QuantizedRMSNorm normalizes the last dim only, not "
                             f"{tuple(self.normalized_shape)}")
        _install_stubs(self, "input", "weight", "output")

    def forward(self, x):
        x = self.input_quantizer(x)
        weight = _quantized_param(self, "weight", "weight_quantizer")
        eps = self.eps if self.eps is not None else torch.finfo(x.dtype).eps
        return ops.rms_norm(x, weight, eps=eps, output_quantizer=self.output_quantizer)


class QuantizedSequential(QuantizedModule, torch.nn.Sequential):
    """Container counterpart: no quantizers of its own; the registration
    marks the container as quantized so `quantize_model` converts it
    rather than giving it a surrogate. ModuleList and ModuleDict take
    surrogates."""

    def __init_quantization__(self) -> None:
        super().__init_quantization__()


class QuantizedRelu(QuantizedModule, torch.nn.ReLU):
    """Quantized `torch.nn.ReLU`, with its own input and output quantizer
    slots; converted from a ReLU, or built directly."""

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        super().__init__(*args, **kwargs)
        self.__init_quantization__()

    def __init_quantization__(self) -> None:
        super().__init_quantization__()
        _install_stubs(self, "input", "output")

    def forward(self, x):
        x = self.input_quantizer(x)
        return ops.relu(x, output_quantizer=self.output_quantizer)


class QuantizedSilu(QuantizedModule, torch.nn.SiLU):
    """Quantized `torch.nn.SiLU`."""

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        super().__init__(*args, **kwargs)
        self.__init_quantization__()

    def __init_quantization__(self) -> None:
        super().__init_quantization__()
        _install_stubs(self, "input", "output")

    def forward(self, x):
        x = self.input_quantizer(x)
        return ops.silu(x, output_quantizer=self.output_quantizer)


class QuantizedDropout(QuantizedModule, torch.nn.Dropout):
    """Dropout passes quantized data through when inactive; when active it
    dequantizes (dropping and rescaling grid values leaves the grid)."""

    def __init_quantization__(self) -> None:
        super().__init_quantization__()
        _install_stubs(self, "output")

    def forward(self, x):
        if isinstance(x, QuantizedTensor):
            if self.training and self.p > 0.0:
                return super().forward(x.dequantize())
            return x
        return super().forward(x)
