"""Operator table: the single source of truth for quantized operators
(`fastforward_tpu/ops/optable.py`).

Each operator is a plain function whose body is the dense fallback; the
`@quantized_op` decorator wraps it with, in order, (1) dispatcher lookup,
(2) the strict-quantization checks, (3) the dense fallback on dequantized
arguments and (4) the ``output_quantizer`` slot. PyTorch runs eagerly, so
all four run on every call (the JAX package resolves them while `jax.jit`
traces).

The table is introspectable (`OPERATOR_TABLE`). An operator's aliases are
the qualified names of the torch functions it stands for
(``torch.matmul``, ``torch.nn.functional.linear``, ``torch.Tensor.add``,
...); `torch_alias` resolves a torch function object to its operator, which
is how `QuantizedTensor.__torch_function__` routes a torch call.
"""

import dataclasses
import functools
import importlib
import inspect
from contextvars import ContextVar
from typing import Any, Callable, Optional, Sequence

from fastforward_tpu_torch import dispatcher, flags
from fastforward_tpu_torch.exceptions import QuantizationError
from fastforward_tpu_torch.quantization.quantized_array import QuantizedTensor

__all__ = ["OperatorSpec", "OPERATOR_TABLE", "quantized_op", "get_operator", "resolve_operator",
           "torch_alias"]


@dataclasses.dataclass(frozen=True)
class OperatorSpec:
    """Metadata for one quantized operator.

    - ``quantized``: parameter names that must be QuantizedTensor under
      strict quantization.
    - ``maybe_quantized``: parameters that may be quantized (dequantized if
      so, never required).
    - ``dense_fn``: the dense (simulation-tier) implementation.
    - ``aliases``: qualified names of the torch functions resolving to this
      op.
    """

    name: str
    quantized: tuple[str, ...]
    maybe_quantized: tuple[str, ...]
    dense_fn: Callable[..., Any]
    wrapper: Callable[..., Any]
    aliases: tuple[str, ...] = ()
    num_outputs: int = 1


OPERATOR_TABLE: dict[str, OperatorSpec] = {}
_ALIASES: dict[str, str] = {}

# True while executing inside a quantized-op body.
IN_QUANTIZED_OP: ContextVar[bool] = ContextVar("in_quantized_op", default=False)

# Observers notified with the op name whenever a quantized operator runs
# (used by quantizer annotation).
OP_OBSERVERS: list[Callable[[str], None]] = []

# Keyword arguments torch's functions pass on to ``__torch_function__`` that
# the operators do not take, with the value at which dropping them changes
# nothing (``_stacklevel`` never changes the result).
_NEUTRAL_TORCH_KWARGS = {"inplace": False, "norm_type": 2.0, "scale_grad_by_freq": False,
                         "sparse": False, "out": None, "rounding_mode": None, "keepdim": False,
                         "return_indices": False}


def get_operator(name: str) -> Optional[OperatorSpec]:
    if name in OPERATOR_TABLE:
        return OPERATOR_TABLE[name]
    if name in _ALIASES:
        return OPERATOR_TABLE[_ALIASES[name]]
    return None


def resolve_operator(fn: Callable[..., Any]) -> Optional[OperatorSpec]:
    """The operator spec whose dense function or wrapper is ``fn``."""
    for spec in OPERATOR_TABLE.values():
        if spec.dense_fn is fn or spec.wrapper is fn:
            return spec
    return None


def _resolve_qualified(name: str) -> Any:
    """The object a qualified name like ``torch.nn.functional.linear`` or
    ``torch.Tensor.add`` names, or None."""
    parts = name.split(".")
    for i in range(len(parts) - 1, 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:i]))
        except ImportError:
            continue
        for attr in parts[i:]:
            obj = getattr(obj, attr, None)
            if obj is None:
                return None
        return obj
    return None


# torch function object -> the name of the operator an alias names it for
_TORCH_FUNCTIONS: dict[Any, str] = {}


def torch_alias(func: Any) -> Optional[OperatorSpec]:
    """The operator whose aliases name the torch function ``func``, or
    None."""
    name = _TORCH_FUNCTIONS.get(func)
    return None if name is None else OPERATOR_TABLE[name]


def operator_kwargs(spec: OperatorSpec, kwargs: dict) -> Optional[dict]:
    """``kwargs`` of a torch call as the operator takes them: torch-only
    keywords at their neutral values dropped; None when one has another
    value (the operator cannot compute that call)."""
    params = inspect.signature(spec.dense_fn).parameters
    out = {}
    for k, v in kwargs.items():
        if k in params:
            out[k] = v
        elif k == "_stacklevel":
            continue
        elif k in _NEUTRAL_TORCH_KWARGS and v == _NEUTRAL_TORCH_KWARGS[k]:
            continue
        else:
            return None
    return out


def _is_stub(quantizer: Any) -> bool:
    return quantizer is None or getattr(quantizer, "is_stub", False)


def _check_strict(
    name: str,
    bound: inspect.BoundArguments,
    quantized: Sequence[str],
    output_quantizer: Any,
) -> None:
    """Strict-quantization guards: raise QuantizationError when the op
    would silently produce or consume unquantized data."""
    if _is_stub(output_quantizer):
        raise QuantizationError(
            f"'{name}' requires an output quantizer under strict quantization. "
            "Pass output_quantizer=..., or disable strict quantization "
            "(fastforward_tpu_torch.flags.strict_quantization(False))."
        )
    for pname in quantized:
        if pname not in bound.arguments:
            continue
        value = bound.arguments[pname]
        if value is None:
            continue
        if isinstance(value, (list, tuple)):
            ok = all(isinstance(v, QuantizedTensor) for v in value)
        else:
            ok = isinstance(value, QuantizedTensor)
        if not ok:
            raise QuantizationError(
                f"Argument '{pname}' of '{name}' must be quantized under strict "
                "quantization, but received an unquantized value. Quantize the "
                "input or disable strict quantization."
            )


def _dequantize_tree(value: Any) -> Any:
    if isinstance(value, QuantizedTensor):
        return value.dequantize()
    if isinstance(value, (list, tuple)):
        return type(value)(_dequantize_tree(v) for v in value)
    return value


def quantized_op(
    name: Optional[str] = None,
    *,
    quantized: Sequence[str] = (),
    maybe_quantized: Sequence[str] = (),
    aliases: Sequence[str] = (),
    num_outputs: int = 1,
) -> Callable[[Callable[..., Any]], Callable[..., Any]]:
    """Declare a quantized operator.

    The decorated function body is the dense fallback. The returned wrapper
    adds, in order:

    1. dispatcher lookup — the first registered kernel whose predicate
       matches the (possibly quantized) arguments runs instead;
    2. strict-quantization checks;
    3. dequantize-and-run-dense fallback;
    4. re-quantization through ``output_quantizer``.
    """

    def decorator(fn: Callable[..., Any]) -> Callable[..., Any]:
        op_name = name or fn.__name__
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def wrapper(
            *args: Any,
            output_quantizer: Any = None,
            strict_quantization: Optional[bool] = None,
            **kwargs: Any,
        ) -> Any:
            for observer in OP_OBSERVERS:
                observer(op_name)
            token = IN_QUANTIZED_OP.set(True)
            try:
                return _invoke(args, output_quantizer, strict_quantization, kwargs)
            finally:
                IN_QUANTIZED_OP.reset(token)

        def _invoke(args, output_quantizer, strict_quantization, kwargs):
            strict = (
                flags.get_strict_quantization()
                if strict_quantization is None
                else strict_quantization
            )

            # 1. Dispatcher: a registered kernel takes over the whole op,
            # output quantization included.
            kernel = dispatcher.dispatch(op_name, *args, **kwargs)
            if kernel is not None:
                return kernel(*args, output_quantizer=output_quantizer, **kwargs)

            bound = sig.bind(*args, **kwargs)

            # 2. Strict guards.
            if strict:
                _check_strict(op_name, bound, quantized, output_quantizer)

            # 3. Dense fallback on dequantized inputs.
            dense_args = {k: _dequantize_tree(v) for k, v in bound.arguments.items()}
            bound.arguments.update(dense_args)
            result = fn(*bound.args, **bound.kwargs)

            # 4. Output re-quantization.
            if not _is_stub(output_quantizer):
                return output_quantizer(result)
            return result

        wrapper.__signature__ = _extend_signature(sig)  # type: ignore[attr-defined]
        spec = OperatorSpec(
            name=op_name,
            quantized=tuple(quantized),
            maybe_quantized=tuple(maybe_quantized),
            dense_fn=fn,
            wrapper=wrapper,
            aliases=tuple(aliases),
            num_outputs=num_outputs,
        )
        OPERATOR_TABLE[op_name] = spec
        for alias in aliases:
            _ALIASES[alias] = op_name
            obj = _resolve_qualified(alias)
            if obj is not None:
                _TORCH_FUNCTIONS[obj] = op_name
        wrapper.spec = spec  # type: ignore[attr-defined]
        return wrapper

    return decorator


def _extend_signature(sig: inspect.Signature) -> inspect.Signature:
    params = list(sig.parameters.values())
    params.append(
        inspect.Parameter("output_quantizer", inspect.Parameter.KEYWORD_ONLY, default=None)
    )
    params.append(
        inspect.Parameter("strict_quantization", inspect.Parameter.KEYWORD_ONLY, default=None)
    )
    return sig.replace(parameters=params)
