"""Dispatcher registrations of the execution-tier kernels
(`fastforward_tpu/kernels/dispatch.py`).

When a `QuantizedTensor` with true int8 storage reaches `ops.linear`, the
dispatcher routes it to the W8A8 GEMM (row 19, `csrc/w8a8_gemm.cu`) in place
of the dequantize fallback. The predicate takes an int8, 2-D, symmetric
static affine weight quantized per channel on its output dim: torch's
(out, in) layout makes that ``PerChannel(0)``, where the JAX package's
(in, out) kernel has ``PerChannel(1)``. The activations are quantized per
row on the fly (`quantize_rowwise`). Packed int4 weights live in
`serving.engine.QuantLinear`, which calls the W4 kernels directly.

The registration is live once `fastforward_tpu_torch.kernels` is imported,
as the JAX package's is once `fastforward_tpu.kernels` is.
"""

from typing import Any, Optional

import torch

from fastforward_tpu_torch import dispatcher
from fastforward_tpu_torch.dispatcher import Predicate
from fastforward_tpu_torch.kernels.matmul import matmul_w8a8, quantize_rowwise
from fastforward_tpu_torch.quantization.affine_function import StaticAffineQuantParams
from fastforward_tpu_torch.quantization.granularity import PerChannel
from fastforward_tpu_torch.quantization.quantized_array import QuantizedTensor


def _int8_per_channel_weight(value: Any) -> bool:
    if not isinstance(value, QuantizedTensor):
        return False
    if value.raw_data.dtype != torch.int8 or value.ndim != 2:
        return False
    params = value.quant_args()
    if not isinstance(params, StaticAffineQuantParams) or params.offset is not None:
        return False
    return isinstance(params.granularity, PerChannel) and params.granularity.channel_dims == (0,)


def _linear_w8a8_predicate(input: Any, weight: Any, bias: Any = None, **kwargs: Any) -> bool:
    if not _int8_per_channel_weight(weight):
        return False
    # input: a dense tensor or a QuantizedTensor (dense → dynamic quantization)
    x = input.dequantize() if isinstance(input, QuantizedTensor) else input
    return hasattr(x, "ndim") and x.ndim >= 2


@dispatcher.register(
    "linear", predicate=Predicate(_linear_w8a8_predicate, name="w8a8_int8_weight")
)
def _linear_w8a8_kernel(input: Any, weight: QuantizedTensor, bias: Optional[Any] = None,
                        *, output_quantizer: Any = None) -> Any:
    """``input @ weight.T (+ bias)`` through `matmul_w8a8`: x quantized per
    row, the int8 weight as row 19's contiguous (K, N) operand (a transposed
    copy each call), bf16 out for a bf16 x and f32 otherwise. On a CUDA
    weight it launches the kernel or raises (a CPU x, a shape the kernel
    refuses)."""
    x = input.dequantize() if isinstance(input, QuantizedTensor) else input
    w = weight.raw_data
    if w.device.type == "cuda" and x.device != w.device:
        raise ValueError(f"W8A8 linear: x is on {x.device}, the int8 weight on {w.device}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    x_q, x_scale = quantize_rowwise(x2)
    w_scale = torch.as_tensor(weight.quant_args().scale, dtype=torch.float32,
                              device=w.device).reshape(-1)
    out = matmul_w8a8(
        x_q, x_scale, w.t().contiguous(), w_scale,
        bias=None if bias is None else (
            bias.dequantize() if isinstance(bias, QuantizedTensor) else bias
        ),
        out_dtype=torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32,
    )
    out = out.reshape(*lead, -1)
    if output_quantizer is not None and not getattr(output_quantizer, "is_stub", False):
        return output_quantizer(out)
    return out
