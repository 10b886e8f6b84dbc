"""The quantized operator library (`fastforward_tpu/ops/operators.py`).

Each function body is the plain PyTorch dense version (the fallback tier);
the `@quantized_op` decorator adds dispatch, strict checks, dequantization
and the ``output_quantizer`` slot. Every operator keeps its JAX name.

Conventions are PyTorch's, where the JAX package documents three
TPU-native deviations:
  - `linear` takes ``weight`` in torch's (out_features, in_features)
    layout and computes ``input @ weight.T + bias``;
  - convolutions take N, C, spatial... inputs and torch's weight layouts,
    with `torch.nn.functional`'s signatures (`conv_transpose*` is torch's
    transposed convolution, honouring ``output_padding`` and ``groups``);
  - `dropout` draws from an optional ``generator=`` (the default generator
    when None).
Pooling, `interpolate` and `unfold` take N, C, spatial... inputs too.
"""

from typing import Any, Optional, Sequence

import torch
import torch.nn.functional as F

from fastforward_tpu_torch.ops.optable import quantized_op

Tensor = torch.Tensor


# --- matmul family -----------------------------------------------------------


@quantized_op(quantized=("input", "weight"), maybe_quantized=("bias",),
              aliases=("torch.nn.functional.linear",))
def linear(input: Tensor, weight: Tensor, bias: Optional[Tensor] = None) -> Tensor:
    """``input @ weight.T (+ bias)``; weight is (out_features, in_features)."""
    return F.linear(input, weight, bias)


@quantized_op(quantized=("input", "other"), aliases=("torch.matmul", "torch.Tensor.matmul"))
def matmul(input: Tensor, other: Tensor) -> Tensor:
    return torch.matmul(input, other)


@quantized_op(quantized=("input", "mat2"), aliases=("torch.mm", "torch.Tensor.mm"))
def mm(input: Tensor, mat2: Tensor) -> Tensor:
    return torch.mm(input, mat2)


@quantized_op(quantized=("input", "mat2"), aliases=("torch.bmm", "torch.Tensor.bmm"))
def bmm(input: Tensor, mat2: Tensor) -> Tensor:
    return torch.bmm(input, mat2)


@quantized_op(quantized=("input",), aliases=("torch.einsum",))
def einsum(equation: str, input: Tensor, other: Optional[Tensor] = None) -> Tensor:
    """One- or two-operand einsum."""
    if other is None:
        return torch.einsum(equation, input)
    return torch.einsum(equation, input, other)


@quantized_op(quantized=("input",), aliases=("torch.nn.functional.log_softmax",
                                             "torch.log_softmax", "torch.Tensor.log_softmax"))
def log_softmax(input: Tensor, dim: int = -1, dtype: Any = None) -> Tensor:
    return F.log_softmax(input, dim=dim, dtype=dtype)


@quantized_op(quantized=("input", "weight"), maybe_quantized=("bias",))
def einsum_linear(equation: str, input: Tensor, weight: Tensor,
                  bias: Optional[Tensor] = None) -> Tensor:
    """Generalized projection via einsum (used by fused attention layers)."""
    out = torch.einsum(equation, input, weight)
    if bias is not None:
        out = out + bias
    return out


# --- convolutions (N, C, spatial...) -------------------------------------------


@quantized_op(quantized=("input", "weight"), maybe_quantized=("bias",),
              aliases=("torch.nn.functional.conv1d",))
def conv1d(input, weight, bias=None, stride=1, padding=0, dilation=1, groups=1):
    """NCL input, (out, in / groups, L) weight."""
    return F.conv1d(input, weight, bias, stride, padding, dilation, groups)


@quantized_op(quantized=("input", "weight"), maybe_quantized=("bias",),
              aliases=("torch.nn.functional.conv2d",))
def conv2d(input, weight, bias=None, stride=1, padding=0, dilation=1, groups=1):
    """NCHW input, (out, in / groups, H, W) weight."""
    return F.conv2d(input, weight, bias, stride, padding, dilation, groups)


@quantized_op(quantized=("input", "weight"), maybe_quantized=("bias",),
              aliases=("torch.nn.functional.conv3d",))
def conv3d(input, weight, bias=None, stride=1, padding=0, dilation=1, groups=1):
    return F.conv3d(input, weight, bias, stride, padding, dilation, groups)


@quantized_op(quantized=("input", "weight"), maybe_quantized=("bias",),
              aliases=("torch.nn.functional.conv_transpose1d",))
def conv_transpose1d(input, weight, bias=None, stride=1, padding=0, output_padding=0, groups=1,
                     dilation=1):
    """NCL input, (in, out / groups, L) weight."""
    return F.conv_transpose1d(input, weight, bias, stride, padding, output_padding, groups,
                              dilation)


@quantized_op(quantized=("input", "weight"), maybe_quantized=("bias",),
              aliases=("torch.nn.functional.conv_transpose2d",))
def conv_transpose2d(input, weight, bias=None, stride=1, padding=0, output_padding=0, groups=1,
                     dilation=1):
    return F.conv_transpose2d(input, weight, bias, stride, padding, output_padding, groups,
                              dilation)


@quantized_op(quantized=("input", "weight"), maybe_quantized=("bias",),
              aliases=("torch.nn.functional.conv_transpose3d",))
def conv_transpose3d(input, weight, bias=None, stride=1, padding=0, output_padding=0, groups=1,
                     dilation=1):
    return F.conv_transpose3d(input, weight, bias, stride, padding, output_padding, groups,
                              dilation)


# --- activations / normalization --------------------------------------------


@quantized_op(quantized=("input",), aliases=("torch.nn.functional.softmax", "torch.softmax",
                                             "torch.Tensor.softmax"))
def softmax(input: Tensor, dim: int = -1, dtype: Any = None) -> Tensor:
    return F.softmax(input, dim=dim, dtype=dtype)


@quantized_op(quantized=("input",), aliases=("torch.nn.functional.relu", "torch.relu",
                                             "torch.Tensor.relu"))
def relu(input: Tensor) -> Tensor:
    return torch.relu(input)


@quantized_op(quantized=("input",), aliases=("torch.sigmoid", "torch.Tensor.sigmoid"))
def sigmoid(input: Tensor) -> Tensor:
    return torch.sigmoid(input)


@quantized_op(quantized=("input",), aliases=("torch.nn.functional.silu",))
def silu(input: Tensor) -> Tensor:
    return F.silu(input)


@quantized_op(quantized=("input",), aliases=("torch.nn.functional.gelu",))
def gelu(input: Tensor, approximate: str = "none") -> Tensor:
    return F.gelu(input, approximate=approximate)


@quantized_op(quantized=("input",), aliases=("torch.tanh", "torch.Tensor.tanh"))
def tanh(input: Tensor) -> Tensor:
    return torch.tanh(input)


@quantized_op(quantized=("input",), maybe_quantized=("weight", "bias"),
              aliases=("torch.nn.functional.layer_norm",))
def layer_norm(
    input: Tensor,
    normalized_shape: Sequence[int],
    weight: Optional[Tensor] = None,
    bias: Optional[Tensor] = None,
    eps: float = 1e-5,
) -> Tensor:
    return F.layer_norm(input, tuple(normalized_shape), weight, bias, eps)


@quantized_op(quantized=("input",), maybe_quantized=("weight",))
def rms_norm(input: Tensor, weight: Optional[Tensor] = None, eps: float = 1e-6) -> Tensor:
    """RMSNorm over the last dim: computed in f32, cast back to the input's
    dtype, then times ``weight``."""
    dtype = input.dtype
    x = input.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = (x * torch.rsqrt(var + eps)).to(dtype)
    if weight is not None:
        out = out * weight
    return out


@quantized_op(quantized=("weight",), aliases=("torch.nn.functional.embedding",))
def embedding(
    input: Tensor,
    weight: Tensor,
    padding_idx: Optional[int] = None,
    max_norm: Optional[float] = None,
) -> Tensor:
    return F.embedding(input, weight, padding_idx, max_norm)


# --- elementwise binary ------------------------------------------------------


@quantized_op(quantized=("input",), maybe_quantized=("other",),
              aliases=("torch.add", "torch.Tensor.add"))
def add(input, other, alpha=1):
    return input + alpha * other if alpha != 1 else input + other


@quantized_op(quantized=("input",), maybe_quantized=("other",),
              aliases=("torch.sub", "torch.subtract", "torch.Tensor.sub"))
def sub(input, other, alpha=1):
    return input - alpha * other if alpha != 1 else input - other


@quantized_op(quantized=("input",), maybe_quantized=("other",),
              aliases=("torch.mul", "torch.multiply", "torch.Tensor.mul"))
def mul(input, other):
    return input * other


@quantized_op(quantized=("input",), maybe_quantized=("other",),
              aliases=("torch.div", "torch.divide", "torch.true_divide", "torch.Tensor.div"))
def div(input, other):
    return input / other


@quantized_op(quantized=("input",), maybe_quantized=("exponent",),
              aliases=("torch.pow", "torch.Tensor.pow"))
def pow(input, exponent):
    return input**exponent


@quantized_op(quantized=("input",), maybe_quantized=("other",),
              aliases=("torch.floor_divide", "torch.Tensor.floor_divide"))
def floor_divide(input, other):
    return torch.floor_divide(input, other)


@quantized_op(quantized=("input",), maybe_quantized=("other",),
              aliases=("torch.remainder", "torch.Tensor.remainder"))
def remainder(input, other):
    return torch.remainder(input, other)


@quantized_op(quantized=("input",), aliases=("torch.negative", "torch.neg", "torch.Tensor.neg",
                                             "torch.Tensor.negative"))
def negative(input):
    return -input


@quantized_op(quantized=("input",), aliases=("torch.positive",))
def positive(input):
    return +input


@quantized_op(quantized=("input",), aliases=("torch.sum", "torch.Tensor.sum"))
def sum(input, dim: Optional[int] = None):
    return torch.sum(input) if dim is None else torch.sum(input, dim)


@quantized_op(quantized=("input",), aliases=("torch.cumsum", "torch.Tensor.cumsum"))
def cumsum(input, dim: int):
    return torch.cumsum(input, dim)


# --- bitwise (operate on integer grids) -------------------------------------


@quantized_op(quantized=("input",), aliases=("torch.bitwise_not",))
def bitwise_not(input):
    return torch.bitwise_not(input)


@quantized_op(quantized=("input",), maybe_quantized=("other",), aliases=("torch.bitwise_and",))
def bitwise_and(input, other):
    return torch.bitwise_and(input, other)


@quantized_op(quantized=("input",), maybe_quantized=("other",), aliases=("torch.bitwise_or",))
def bitwise_or(input, other):
    return torch.bitwise_or(input, other)


@quantized_op(quantized=("input",), maybe_quantized=("other",), aliases=("torch.bitwise_xor",))
def bitwise_xor(input, other):
    return torch.bitwise_xor(input, other)


@quantized_op(quantized=("input",), maybe_quantized=("other",),
              aliases=("torch.bitwise_left_shift",))
def bitwise_left_shift(input, other):
    return torch.bitwise_left_shift(input, other)


@quantized_op(quantized=("input",), maybe_quantized=("other",),
              aliases=("torch.bitwise_right_shift",))
def bitwise_right_shift(input, other):
    return torch.bitwise_right_shift(input, other)


# --- shape / layout ----------------------------------------------------------


@quantized_op(quantized=("input",), aliases=("torch.permute",))
def permute(input, dims: Sequence[int]):
    return torch.permute(input, tuple(dims))


@quantized_op(quantized=("input",), aliases=("torch.transpose",))
def transpose(input, dim0: int, dim1: int):
    return torch.transpose(input, dim0, dim1)


@quantized_op(quantized=("input",), aliases=("torch.reshape",))
def reshape(input, shape: Sequence[int]):
    return torch.reshape(input, tuple(shape))


@quantized_op(quantized=("tensors",), aliases=("torch.cat", "torch.concat", "torch.concatenate"))
def cat(tensors: Sequence[Tensor], dim: int = 0):
    return torch.cat(list(tensors), dim=dim)


@quantized_op(quantized=("input", "source"), aliases=("torch.index_add",))
def index_add(input, dim: int, index: Tensor, source: Tensor, alpha: float = 1):
    return torch.index_add(input, dim, index, source, alpha=alpha)


@quantized_op(quantized=("input",), aliases=("torch.nn.functional.pad",))
def pad(input, pad: Sequence[int], mode: str = "constant", value: Optional[float] = None):
    """torch's pad list: (before, after) pairs from the last dim back."""
    if mode == "constant":
        return F.pad(input, tuple(pad), mode="constant", value=value or 0)
    return F.pad(input, tuple(pad), mode=mode)


# --- pooling / resampling (N, C, spatial...) -------------------------------------


@quantized_op(quantized=("input",), aliases=("torch.nn.functional.avg_pool1d",))
def avg_pool1d(input, kernel_size, stride=None, padding=0, ceil_mode=False,
               count_include_pad=True):
    return F.avg_pool1d(input, kernel_size, stride, padding, ceil_mode, count_include_pad)


@quantized_op(quantized=("input",), aliases=("torch.nn.functional.avg_pool2d",))
def avg_pool2d(input, kernel_size, stride=None, padding=0, ceil_mode=False,
               count_include_pad=True):
    return F.avg_pool2d(input, kernel_size, stride, padding, ceil_mode, count_include_pad)


@quantized_op(quantized=("input",), aliases=("torch.nn.functional.avg_pool3d",))
def avg_pool3d(input, kernel_size, stride=None, padding=0, ceil_mode=False,
               count_include_pad=True):
    return F.avg_pool3d(input, kernel_size, stride, padding, ceil_mode, count_include_pad)


@quantized_op(quantized=("input",), aliases=("torch.nn.functional.max_pool2d",))
def max_pool2d(input, kernel_size, stride=None, padding=0, dilation=1, ceil_mode=False):
    return F.max_pool2d(input, kernel_size, stride, padding, dilation, ceil_mode)


@quantized_op(quantized=("input",), aliases=("torch.nn.functional.interpolate",))
def interpolate(
    input,
    size=None,
    scale_factor=None,
    mode: str = "nearest",
    align_corners=None,
    recompute_scale_factor=None,
    antialias: bool = False,
):
    return F.interpolate(input, size, scale_factor, mode, align_corners, recompute_scale_factor,
                         antialias)


@quantized_op(quantized=("input",), aliases=("torch.nn.functional.unfold",))
def unfold(input, kernel_size, dilation=1, padding=0, stride=1):
    """Sliding patches (im2col): NCHW input → (N, C * kh * kw, L)."""
    return F.unfold(input, kernel_size, dilation, padding, stride)


# --- dropout / constructors --------------------------------------------------


@quantized_op(quantized=("input",), aliases=("torch.nn.functional.dropout",))
def dropout(input, p: float = 0.5, training: bool = True, *,
            generator: Optional[torch.Generator] = None):
    """Inverted dropout: each element kept with probability ``1 - p`` (a
    uniform draw from ``generator`` below it) and scaled by ``1 / (1 - p)``."""
    if not training or p == 0.0:
        return input
    keep = torch.rand(input.shape, generator=generator, device=input.device) < (1.0 - p)
    return torch.where(keep, input / (1.0 - p), torch.zeros((), dtype=input.dtype,
                                                            device=input.device))


@quantized_op(quantized=("input",), aliases=("torch.ones_like",))
def ones_like(input, dtype=None):
    return torch.ones_like(input, dtype=dtype)


@quantized_op(quantized=("input",), aliases=("torch.zeros_like",))
def zeros_like(input, dtype=None):
    return torch.zeros_like(input, dtype=dtype)


@quantized_op(quantized=("input",), aliases=("torch.full_like",))
def full_like(input, fill_value, dtype=None):
    return torch.full_like(input, fill_value, dtype=dtype)


@quantized_op(quantized=("input",), aliases=("torch.empty_like",))
def empty_like(input, dtype=None):
    return torch.empty_like(input, dtype=dtype)
