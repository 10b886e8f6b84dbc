"""QuantizedModule system: conversion of `torch.nn` models to their quantized
counterparts (`fastforward_tpu/nn/quantized_module.py`).

Subclass auto-registration into a global module map, conversion in place by
``__class__`` reassignment (parameters, buffers and hooks stay the same
objects), `quantize_model`, pass-through surrogates, `named_quantizers` and
`summarize_quantizers`.

A quantized counterpart subclasses `QuantizedModule` and a `torch.nn`
module type, and registers itself against the nearest `torch.nn` base that
is not quantized; conversion walks the module tree and swaps classes.
Quantizer paths join module names with ``.``, as ``named_modules`` does (the
JAX package joins NNX attribute paths with ``/``).
"""

import contextlib
from contextvars import ContextVar
from typing import Any, Callable, Iterator, Optional

import torch

from fastforward_tpu_torch.exceptions import QuantizationError
from fastforward_tpu_torch.nn.quantizer import Quantizer, QuantizerStub

# Sentinel: map a module type to SKIP_QUANTIZATION to leave it untouched.
SKIP_QUANTIZATION = object()

_QUANTIZED_MODULE_MAP: dict[type, type] = {}


class QuantizedModule(torch.nn.Module):
    """Mixin marking a module as the quantized counterpart of a base type.

    Subclasses inherit from both `QuantizedModule` and a `torch.nn` module
    type; they implement `__init_quantization__` to create their quantizer
    slots (as `QuantizerStub`s) and a ``forward`` that routes through
    `fastforward_tpu_torch.ops`.
    """

    def __init_subclass__(cls, **kwargs: Any) -> None:
        super().__init_subclass__(**kwargs)
        # Auto-register against the nearest non-quantized torch.nn base.
        for base in cls.__mro__[1:]:
            if base in (QuantizedModule, torch.nn.Module, object):
                continue
            if issubclass(base, QuantizedModule):
                continue
            if issubclass(base, torch.nn.Module):
                _QUANTIZED_MODULE_MAP.setdefault(base, cls)
                break

    def __init_quantization__(self) -> None:
        """Create quantizer stubs. Subclasses extend."""
        self._quantization_initialized = True

    # -- quantizer iteration ------------------------------------------------

    def named_quantizers(
        self, prefix: str = "", recurse: bool = False
    ) -> Iterator[tuple[str, Quantizer]]:
        if recurse:
            yield from named_quantizers(self, prefix=prefix)
            return
        for name, value in self._modules.items():
            if isinstance(value, Quantizer):
                yield (f"{prefix}{name}" if prefix else name), value

    @property
    def quantizers(self) -> list[Quantizer]:
        return [q for _, q in self.named_quantizers()]


def quantized_module_map() -> dict[type, type]:
    """The global {module type -> quantized counterpart} map, narrowed by an
    active `filter_quantized_module_map` context."""
    mapping = dict(_QUANTIZED_MODULE_MAP)
    for predicate in _MAP_FILTERS.get():
        mapping = {b: q for b, q in mapping.items() if predicate(b, q)}
    return mapping


_MAP_FILTERS: "ContextVar[tuple]" = ContextVar("quantized_module_map_filters", default=())


@contextlib.contextmanager
def filter_quantized_module_map(
    predicate: Callable[[type, type], bool],
) -> Iterator[None]:
    """Scope `quantized_module_map` (and so `quantize_model`) to entries
    passing ``predicate(base_type, quantized_type)``, without unregistering
    the others."""
    token = _MAP_FILTERS.set(_MAP_FILTERS.get() + (predicate,))
    try:
        yield
    finally:
        _MAP_FILTERS.reset(token)


def register_quantized_module(
    base: type, quantized: Optional[type] = None
) -> Any:
    """Register (or decorate) a quantized counterpart for ``base``."""
    if quantized is None:

        def decorator(cls: type) -> type:
            _QUANTIZED_MODULE_MAP[base] = cls
            return cls

        return decorator
    _QUANTIZED_MODULE_MAP[base] = quantized
    return quantized


def _has_direct_params(module: torch.nn.Module) -> bool:
    return any(True for _ in module.parameters(recurse=False)) or any(
        True for _ in module.buffers(recurse=False))


_SURROGATES: dict[type, type] = {}


def surrogate_quantized_module(base: type) -> type:
    """A pass-through QuantizedModule subclass for ``base``: it adds no
    quantizers, only marks the module as converted."""
    if base in _SURROGATES:
        return _SURROGATES[base]
    surrogate = type(f"Quantized{base.__name__}", (QuantizedModule, base), {})
    # Surrogates do not claim the global map slot of their base type.
    if _QUANTIZED_MODULE_MAP.get(base) is surrogate:
        del _QUANTIZED_MODULE_MAP[base]
    _SURROGATES[base] = surrogate
    return surrogate


def surrogate_quantized_modules(
    model: torch.nn.Module,
    *,
    extra_conversion: Optional[dict[type, type]] = None,
    ignore_global_module_map: bool = False,
) -> dict[type, type]:
    """Conversion dict of pass-through surrogates for every submodule type of
    ``model`` without a quantized counterpart; pass it as
    ``extra_conversion`` to `quantize_model` so that conversion always
    succeeds."""
    known: dict[type, type] = {} if ignore_global_module_map else dict(
        quantized_module_map()
    )
    if extra_conversion:
        known.update(extra_conversion)
    out: dict[type, type] = {}
    for module in model.modules():
        t = type(module)
        if isinstance(module, (QuantizedModule, Quantizer)):
            continue
        if t in known or t in out:
            continue
        out[t] = surrogate_quantized_module(t)
    return out


def check_quantizable(
    model: torch.nn.Module, module_map: dict[type, type], allow_surrogates: bool
) -> None:
    """Raise QuantizationError listing module types with parameters that
    have no quantized counterpart."""
    missing: set[str] = set()
    for module in model.modules():
        t = type(module)
        if isinstance(module, (QuantizedModule, Quantizer)):
            continue
        if t in module_map:
            continue
        if not _has_direct_params(module) and allow_surrogates:
            continue
        missing.add(f"{t.__module__}.{t.__qualname__}")
    if missing:
        raise QuantizationError(
            "No quantized counterpart registered for module types with "
            f"parameters: {sorted(missing)}. Register one with "
            "register_quantized_module(...), pass extra_conversion={...}, or "
            "map them to SKIP_QUANTIZATION."
        )


def quantize_model(
    model: torch.nn.Module,
    *,
    extra_conversion: Optional[dict[type, Any]] = None,
    skip_quantized_modules: bool = True,
    allow_surrogates: bool = True,
    _quantize_self: bool = True,
) -> torch.nn.Module:
    """Convert ``model`` (in place) to its quantized form.

    Every submodule whose type has a registered counterpart gets its class
    swapped and `__init_quantization__` called (installing `QuantizerStub`
    slots); parameter-free modules without a counterpart get pass-through
    surrogates. Returns the model for chaining.
    """
    module_map = quantized_module_map()
    if extra_conversion:
        module_map.update({k: v for k, v in extra_conversion.items()})

    check_quantizable(model, module_map, allow_surrogates)

    for module in list(model.modules()):
        if module is model and not _quantize_self:
            continue
        if isinstance(module, Quantizer):
            continue
        if isinstance(module, QuantizedModule):
            if skip_quantized_modules:
                continue
        t = type(module)
        target = module_map.get(t)
        if target is SKIP_QUANTIZATION:
            continue
        if target is None:
            if isinstance(module, QuantizedModule):
                continue
            target = surrogate_quantized_module(t)
        module.__class__ = target
        module.__init_quantization__()
    return model


# --- quantizer iteration over whole models -----------------------------------


def named_quantizers(
    model: torch.nn.Module, prefix: str = "", remove_duplicate: bool = False
) -> Iterator[tuple[str, Quantizer]]:
    """Yield (path, quantizer) for every Quantizer in the module tree.

    Unlike ``named_modules``, a quantizer shared between several slots is
    yielded at every path unless ``remove_duplicate``.
    """
    seen: set[int] = set()

    def walk(obj: torch.nn.Module, path: tuple[str, ...], on_path: set[int]):
        if id(obj) in on_path:
            return  # cycle guard
        if isinstance(obj, Quantizer):
            if remove_duplicate:
                if id(obj) in seen:
                    return
                seen.add(id(obj))
            name = ".".join(path)
            yield (f"{prefix}{name}" if prefix else name), obj
            return
        next_on_path = on_path | {id(obj)}
        for key, value in obj._modules.items():
            if value is not None:
                yield from walk(value, path + (key,), next_on_path)

    yield from walk(model, (), set())


def summarize_quantizers(model: torch.nn.Module) -> str:
    """Human-readable table of quantizer slots and their state."""
    lines = []
    for name, q in named_quantizers(model):
        if isinstance(q, QuantizerStub):
            state = "stub"
        elif getattr(q, "has_uninitialized_params", False):
            state = f"{type(q).__name__} (uninitialized)"
        else:
            state = type(q).__name__
            extra = q.extra_repr()
            if extra:
                state += f"({extra})"
        lines.append(f"{name}: {state}")
    return "\n".join(lines)
