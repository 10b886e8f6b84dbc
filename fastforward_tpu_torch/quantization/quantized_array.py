"""`QuantizedTensor`: integer-grid data and its quantization context
(`fastforward_tpu/quantization/quantized_array.py`, ``QuantizedArray``).

A plain class holding a tensor of grid values and the
`QuantizationContext` (function and parameters) that gives them meaning,
as the JAX ``QuantizedArray`` is; it is not a ``torch.Tensor`` subclass.
Its API is JAX's: ``raw_data``, ``quant_args()``, ``dequantize()``,
``shape``, ``ndim``, ``size``, ``dtype`` (the dtype it represents) and
``quantized_dtype`` (the storage dtype).

Implicit conversion to an array (``numpy.asarray``, the counterpart of
``__jax_array__``) dequantizes, and under strict quantization raises
`QuantizationError` instead. The Python operators (``+ - * / @``, unary
``-``) route through the quantized operators of `fastforward_tpu_torch.ops`,
the reflected ones with the operands in their written order (``1 - qt`` is
``ops.sub(1, qt)``). ``__torch_function__`` does the same for torch
functions: one whose qualified name is an alias of an operator
(`ops.optable.torch_alias`: ``torch.nn.functional.linear``,
``torch.matmul``, ``torch.Tensor.add`` for ``x + qt``, ...) runs that
operator; any other gets the implicit conversion: `QuantizationError` under
strict quantization, else the function on the dequantized arguments.

Operator syntax asks autoquant's `operator_site` for an output quantizer,
as the JAX ``_binop`` does (`fastforward_tpu/autoquant.py:218-239`): inside
an autoquant context ``qt + y`` is a call site, recorded in discovery and
given its site's quantizer in apply mode; outside one the hook returns
``(None, False)`` and the operator runs as called. A plain tensor on the
left (``x * qt``, which torch hands to ``__torch_function__`` as
``torch.Tensor.mul``) is no site, as in JAX, where the plain array's own
operator converts the QuantizedArray implicitly.
"""

from typing import Any

import numpy as np
import torch

from fastforward_tpu_torch.quantization.function import QuantizationContext

__all__ = ["QuantizedTensor", "is_quantized", "dequantize_if_quantized", "apply_quantized"]


class QuantizedTensor:
    """A tensor of quantized (integer-grid) data with its quantization
    context."""

    __slots__ = ("_data", "_context")

    def __init__(self, data: torch.Tensor, context: QuantizationContext):
        self._data = data
        self._context = context

    # -- metadata ----------------------------------------------------------

    @property
    def shape(self) -> tuple:
        return tuple(self._data.shape)

    @property
    def ndim(self) -> int:
        return self._data.dim()

    @property
    def size(self) -> int:
        return self._data.numel()

    @property
    def dtype(self) -> torch.dtype:
        """The dequantized dtype (what this tensor represents)."""
        dd = getattr(self._context.quantization_params, "dequantize_dtype", None)
        if dd is not None:
            return dd
        return self._data.dtype if self._data.is_floating_point() else torch.float32

    @property
    def quantized_dtype(self) -> torch.dtype:
        """The storage dtype of the raw grid values."""
        return self._data.dtype

    @property
    def raw_data(self) -> torch.Tensor:
        """The raw integer-grid values."""
        return self._data

    @property
    def quantization_context(self) -> QuantizationContext:
        return self._context

    def quant_args(self):
        """The quantization parameters."""
        return self._context.quantization_params

    # -- conversion --------------------------------------------------------

    def dequantize(self) -> torch.Tensor:
        """The real-valued tensor."""
        return self._context.dequantize(self._data)

    def with_data(self, data: torch.Tensor) -> "QuantizedTensor":
        """Same quantization context, new raw data (shape-compatible)."""
        return QuantizedTensor(data, self._context)

    def with_context(self, context: QuantizationContext) -> "QuantizedTensor":
        return QuantizedTensor(self._data, context)

    def __array__(self, dtype=None, copy=None) -> np.ndarray:
        """The dequantized values where this tensor is converted implicitly
        (`quantized_array.py:110` ``__jax_array__``); raises under strict
        quantization."""
        from fastforward_tpu_torch import flags
        from fastforward_tpu_torch.exceptions import QuantizationError

        if flags.get_strict_quantization():
            raise QuantizationError(
                "A QuantizedTensor reached a non-quantized operation, which would "
                "implicitly dequantize it. Use the quantized operators, call "
                ".dequantize() explicitly, or disable strict quantization."
            )
        out = self.dequantize().detach().cpu()
        out = (out.float() if out.dtype == torch.bfloat16 else out).numpy()
        return out if dtype is None else out.astype(dtype)

    # -- Python operators and torch functions → the quantized operators ----

    def _binop(self, name: str, other: Any, reverse: bool = False):
        from fastforward_tpu_torch import ops
        from fastforward_tpu_torch.autoquant import operator_site

        fn = getattr(ops, name)
        quantizer, active = operator_site(name)
        args = (other, self) if reverse else (self, other)
        if active and quantizer is not None:
            return fn(*args, output_quantizer=quantizer)
        return fn(*args)

    def __add__(self, other):
        return self._binop("add", other)

    def __radd__(self, other):
        return self._binop("add", other, reverse=True)

    def __sub__(self, other):
        return self._binop("sub", other)

    def __rsub__(self, other):
        return self._binop("sub", other, reverse=True)

    def __mul__(self, other):
        return self._binop("mul", other)

    def __rmul__(self, other):
        return self._binop("mul", other, reverse=True)

    def __truediv__(self, other):
        return self._binop("div", other)

    def __matmul__(self, other):
        return self._binop("matmul", other)

    def __neg__(self):
        from fastforward_tpu_torch import ops

        return ops.negative(self)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        """A torch function called with a QuantizedTensor among its
        arguments: its quantized operator where its qualified name is an
        alias of one, else the implicit conversion."""
        from fastforward_tpu_torch import flags, ops  # noqa: F401  (fills the table)
        from fastforward_tpu_torch.exceptions import QuantizationError
        from fastforward_tpu_torch.ops import optable

        kwargs = kwargs or {}
        spec = optable.torch_alias(func)
        if spec is not None:
            op_kwargs = optable.operator_kwargs(spec, kwargs)
            if op_kwargs is not None:
                return spec.wrapper(*args, **op_kwargs)
        if flags.get_strict_quantization():
            name = getattr(func, "__qualname__", None) or getattr(func, "__name__", repr(func))
            raise QuantizationError(
                f"A QuantizedTensor reached {name}, which is no quantized operator and would "
                "implicitly dequantize it. Use the quantized operators, call .dequantize() "
                "explicitly, or disable strict quantization."
            )
        return func(*optable._dequantize_tree(args),
                    **{k: optable._dequantize_tree(v) for k, v in kwargs.items()})

    def __repr__(self) -> str:
        num_bits = getattr(self._context.quantization_params, "num_bits", "?")
        return (f"QuantizedTensor(shape={self.shape}, num_bits={num_bits}, "
                f"storage={self._data.dtype}, fn={self._context.quantization_fn.__name__})")


def is_quantized(value: Any) -> bool:
    return isinstance(value, QuantizedTensor)


def dequantize_if_quantized(value: Any) -> Any:
    """A `QuantizedTensor` dequantized; anything else as it is."""
    return value.dequantize() if isinstance(value, QuantizedTensor) else value


def apply_quantized(fn, *args: Any, **kwargs: Any) -> Any:
    """``fn`` after dequantizing every `QuantizedTensor` of args and kwargs."""
    args = tuple(dequantize_if_quantized(a) for a in args)
    kwargs = {k: dequantize_if_quantized(v) for k, v in kwargs.items()}
    return fn(*args, **kwargs)
