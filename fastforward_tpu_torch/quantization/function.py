"""Generic quantization-function framework
(`fastforward_tpu/quantization/function.py`).

`QuantizationParameters` dataclasses, the `QuantizationFunction` pair of
(quantize, dequantize) classmethods, and the `QuantizationContext` that
binds a function to concrete parameters and attaches itself to data as a
`QuantizedTensor`.

The JAX package registers the parameter dataclasses as pytrees, their
tensor fields children and the fields marked by ``static_field()`` aux
data. PyTorch needs no registration: ``static_field`` keeps the mark in
the field's metadata, and ``register_parameters`` returns the class as it
is; both stay so that the two packages declare parameters alike.
"""

import dataclasses
from typing import Any, Callable, Generic, TypeVar

import torch

from fastforward_tpu_torch import flags

Params = TypeVar("Params", bound="QuantizationParameters")


def static_field(**kwargs: Any) -> Any:
    """A dataclass field marked static (configuration, not a tensor)."""
    metadata = dict(kwargs.pop("metadata", ()) or {})
    metadata["static"] = True
    return dataclasses.field(metadata=metadata, **kwargs)


def _fields_dict(obj) -> dict:
    """The dataclass fields of ``obj`` by name, values not copied."""
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


class QuantizationParameters:
    """Base class of quantization parameter dataclasses
    (`function.py:39`); subclasses are ``@dataclasses.dataclass``."""

    def with_changes(self: Params, **changes: Any) -> Params:
        """A copy with ``changes`` applied (tensors not copied)."""
        return dataclasses.replace(self, **changes)

    def _apply(self: Params, fn: Callable[[Any], Any]) -> Params:
        """``fn`` over every tensor field (e.g. ``.to(device)``)."""
        return type(self)(**{k: fn(v) if isinstance(v, torch.Tensor) else v
                             for k, v in _fields_dict(self).items()})


def register_parameters(cls: type) -> type:
    """Class decorator of a `QuantizationParameters` dataclass
    (`function.py:77`); returns ``cls``."""
    return cls


class QuantizationFunction(Generic[Params]):
    """A (quantize, dequantize) pair parameterized by a `Params` dataclass,
    as classmethods of a stateless class (`function.py:83`)."""

    @classmethod
    def quantize(cls, data: torch.Tensor, params: Params):
        raise NotImplementedError

    @classmethod
    def dequantize(cls, data: torch.Tensor, params: Params) -> torch.Tensor:
        raise NotImplementedError


@dataclasses.dataclass
class QuantizationContext(Generic[Params]):
    """A `QuantizationFunction` bound to concrete parameters
    (`function.py:100`)."""

    quantization_fn: type = static_field()
    quantization_params: Any = dataclasses.field()

    def attach(self, data: torch.Tensor):
        """``data`` (already on the integer grid) as a `QuantizedTensor`; under
        export mode the dequantized plain tensor instead."""
        from fastforward_tpu_torch.quantization.quantized_array import QuantizedTensor

        if flags.get_export_mode():
            return self.dequantize(data)
        return QuantizedTensor(data, self)

    def quantize(self, data: torch.Tensor):
        return self.quantization_fn.quantize(data, self.quantization_params)

    def dequantize(self, data: torch.Tensor) -> torch.Tensor:
        return self.quantization_fn.dequantize(data, self.quantization_params)

    def with_changes(self, **changes: Any) -> "QuantizationContext":
        return QuantizationContext(self.quantization_fn,
                                   self.quantization_params.with_changes(**changes))


def create_quantization_function(name: str, quantize: Callable[..., torch.Tensor],
                                 dequantize: Callable[..., torch.Tensor],
                                 static_params: tuple = ()) -> type:
    """A `QuantizationFunction` subclass and its parameter dataclass built
    from plain ``quantize(data, **params)`` / ``dequantize(data, **params)``
    callables by signature inspection (`function.py:143`); the names in
    ``static_params`` become static fields."""
    import inspect

    sig = inspect.signature(quantize)
    fields = []
    for pname in (p for p in sig.parameters if p != "data"):
        default = sig.parameters[pname].default
        has_default = default is not inspect.Parameter.empty
        kw = {"default": default} if has_default else {}
        fld = static_field(**kw) if pname in static_params else dataclasses.field(**kw)
        fields.append((pname, Any, fld))

    params_cls = dataclasses.make_dataclass(f"{name}Params", fields,
                                            bases=(QuantizationParameters,))

    class GeneratedFunction(QuantizationFunction):
        @classmethod
        def quantize(cls, data, params):
            return QuantizationContext(cls, params).attach(quantize(data, **_fields_dict(params)))

        @classmethod
        def dequantize(cls, data, params):
            return dequantize(data, **_fields_dict(params))

    GeneratedFunction.__name__ = name
    GeneratedFunction.Params = params_cls
    return GeneratedFunction
