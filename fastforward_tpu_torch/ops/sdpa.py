"""Quantized scaled-dot-product attention (`fastforward_tpu/ops/sdpa.py`).

A quantizer slot for every intermediate (scaled query and key, attention
scores, mask, masked scores, attention weights, dropout output), plus an
f32-upcast context for the softmax. The signature is
`torch.nn.functional.scaled_dot_product_attention`'s, with the quantizer
slots, ``neg_inf`` and a dropout ``generator=`` as keywords.

The JAX module's docstring says the execution tier overrides this op
through the dispatcher; the JAX package registers no kernel for it, and
neither does the port.
"""

import contextlib
import math
from contextvars import ContextVar
from typing import Any, Optional

import torch

from fastforward_tpu_torch.ops.optable import _is_stub, quantized_op
from fastforward_tpu_torch.quantization.quantized_array import QuantizedTensor

_UPCAST = ContextVar("sdpa_upcast", default=True)


@contextlib.contextmanager
def sdpa_upcast(enabled: bool = True):
    """Context controlling the f32 upcast of the softmax."""
    token = _UPCAST.set(enabled)
    try:
        yield
    finally:
        _UPCAST.reset(token)


def _maybe(quantizer: Optional[Any], value: torch.Tensor) -> torch.Tensor:
    if _is_stub(quantizer):
        return value
    out = quantizer(value)
    if isinstance(out, QuantizedTensor):
        return out.dequantize()
    return out


@quantized_op(
    name="scaled_dot_product_attention",
    quantized=("query", "key", "value"),
    maybe_quantized=("attn_mask",),
    aliases=("torch.nn.functional.scaled_dot_product_attention",),
)
def scaled_dot_product_attention(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    attn_mask: Optional[torch.Tensor] = None,
    dropout_p: float = 0.0,
    is_causal: bool = False,
    scale: Optional[float] = None,
    enable_gqa: bool = False,
    *,
    neg_inf: Optional[float] = None,
    generator: Optional[torch.Generator] = None,
    scaled_query_quantizer: Any = None,
    scaled_key_quantizer: Any = None,
    attn_scores_quantizer: Any = None,
    attn_mask_quantizer: Any = None,
    masked_scores_quantizer: Any = None,
    attn_weights_quantizer: Any = None,
    dropout_quantizer: Any = None,
) -> torch.Tensor:
    """The math attention with a hook after each intermediate. Shapes:
    (..., seq, head_dim), seq at dim -2.

    ``enable_gqa``: key/value heads (dim -3) are repeat-interleaved up to
    the query head count; refused under strict quantization (the repeated
    tensors are plain).

    ``neg_inf``: a finite stand-in for the -inf mask fill, for a
    masked-scores quantizer whose range cannot hold -inf.
    """
    if enable_gqa:
        from fastforward_tpu_torch.exceptions import QuantizationError
        from fastforward_tpu_torch.flags import get_strict_quantization

        if get_strict_quantization():
            raise QuantizationError(
                "Strict quantization currently not supported when "
                "enable_gqa=True"
            )
        groups = query.shape[-3] // key.shape[-3]
        key = torch.repeat_interleave(key, groups, dim=-3)
        value = torch.repeat_interleave(value, groups, dim=-3)
    fill = -math.inf if neg_inf is None else neg_inf
    head_dim = query.shape[-1]
    scale_factor = scale if scale is not None else 1.0 / math.sqrt(head_dim)
    # The scaling is split between q and k, so the intermediate quantizers
    # see the values that reach the product.
    sqrt_scale = math.sqrt(scale_factor)

    q = _maybe(scaled_query_quantizer, query * sqrt_scale)
    k = _maybe(scaled_key_quantizer, key * sqrt_scale)

    scores = torch.matmul(q, k.transpose(-1, -2))
    scores = _maybe(attn_scores_quantizer, scores)

    if is_causal:
        q_len, k_len = scores.shape[-2], scores.shape[-1]
        causal = torch.ones((q_len, k_len), dtype=torch.bool, device=scores.device).tril(
            k_len - q_len)
        scores = scores.masked_fill(~causal, fill)

    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            scores = scores.masked_fill(~attn_mask, fill)
        else:
            scores = scores + _maybe(attn_mask_quantizer, attn_mask)
        scores = _maybe(masked_scores_quantizer, scores)

    if _UPCAST.get():
        weights = torch.softmax(scores.float(), dim=-1).to(query.dtype)
    else:
        weights = torch.softmax(scores, dim=-1)
    weights = _maybe(attn_weights_quantizer, weights)

    if dropout_p > 0.0:
        keep = torch.rand(weights.shape, generator=generator,
                          device=weights.device) < (1.0 - dropout_p)
        weights = torch.where(keep, weights / (1.0 - dropout_p),
                              torch.zeros((), dtype=weights.dtype, device=weights.device))
        weights = _maybe(dropout_quantizer, weights)

    return torch.matmul(weights, value)
