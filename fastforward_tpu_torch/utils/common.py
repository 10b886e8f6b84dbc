"""Small shared helpers (`fastforward_tpu/utils/common.py`).

The JAX names coerce to arrays; here they coerce to tensors on an explicit
``device`` (default: the GPU, as every entry point of the port), and the
reference's torch names (`ensure_tensor`, `tensor_or_none`,
`maybe_tensor_apply`) are aliases of them.
"""

import enum
import importlib
import types
from typing import Any, Callable, Optional

import torch

from fastforward_tpu_torch.device import resolve_device


def ensure_array(value: Any, dtype: Optional[torch.dtype] = None, device=None) -> torch.Tensor:
    """``value`` (a scalar, sequence, array or tensor) as a tensor on
    ``device`` (reference `ensure_tensor`)."""
    return torch.as_tensor(value, dtype=dtype, device=resolve_device(device))


def array_or_none(value: Any, dtype: Optional[torch.dtype] = None,
                  device=None) -> Optional[torch.Tensor]:
    """`ensure_array`, with None passed through (reference `tensor_or_none`)."""
    return None if value is None else ensure_array(value, dtype, device)


def maybe_array_apply(fn: Callable[[torch.Tensor], Any], value: Any) -> Any:
    """``fn(value)`` if ``value`` is a tensor, else ``value`` (reference
    `maybe_tensor_apply`)."""
    if isinstance(value, torch.Tensor):
        return fn(value)
    return value


ensure_tensor = ensure_array
tensor_or_none = array_or_none
maybe_tensor_apply = maybe_array_apply


def fully_qualified_name(obj: Any) -> str:
    """module.QualName of a class or callable (reference `_import.py:12`)."""
    t = obj if isinstance(obj, type) else type(obj)
    if callable(obj) and hasattr(obj, "__qualname__"):
        t = obj
    return f"{t.__module__}.{t.__qualname__}"


def import_by_name(name: str) -> Any:
    """Resolve a qualified name (reference `QualifiedNameReference`)."""
    mod_name, _, attr = name.rpartition(".")
    return getattr(importlib.import_module(mod_name), attr)


class MethodType(enum.Enum):
    """How a name is bound on a class or module (reference `type_common.py:25`)."""

    METHOD = enum.auto()
    CLASS_METHOD = enum.auto()
    STATIC_METHOD = enum.auto()
    NO_METHOD = enum.auto()


def method_type(cls_or_module: Any, method_name: str) -> MethodType:
    """Classify ``method_name`` on a class or module.

    Module-level functions report STATIC_METHOD (no implicit first argument);
    a missing name or a non-callable attribute reports NO_METHOD.
    """
    if not isinstance(cls_or_module, (type, types.ModuleType)):
        raise ValueError("'cls_or_module' must be a module or class")
    attr = cls_or_module.__dict__.get(method_name)
    if isinstance(cls_or_module, type):
        if isinstance(attr, classmethod):
            return MethodType.CLASS_METHOD
        if isinstance(attr, staticmethod):
            return MethodType.STATIC_METHOD
        if isinstance(attr, types.FunctionType):
            return MethodType.METHOD
        return MethodType.NO_METHOD
    if isinstance(attr, types.FunctionType):
        return MethodType.STATIC_METHOD
    return MethodType.NO_METHOD


class classproperty:
    """Read-only property on the class (reference `_utils/classproperty.py`)."""

    def __init__(self, fget: Callable[[type], Any]):
        self.fget = fget

    def __get__(self, obj: Any, owner: Optional[type] = None) -> Any:
        return self.fget(owner if owner is not None else type(obj))
