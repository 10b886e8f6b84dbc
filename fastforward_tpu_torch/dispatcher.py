"""Predicate-based quantized-op dispatcher (`fastforward_tpu/dispatcher.py`).

A name-keyed registry of (predicate, kernel) pairs with composable
predicates and three priority levels, and registration as a function, a
decorator or a context manager. The choice order is JAX's: priority bands
in order, the newest registration first within a band. The JAX package
scans the predicates while ``jax.jit`` traces; PyTorch runs eagerly, so
here the scan runs on every `dispatch` call.
"""

import contextlib
import enum
from typing import Any, Callable, Iterator, Optional

__all__ = [
    "Predicate",
    "DispatcherPriority",
    "register",
    "dispatch",
    "dispatcher_context",
]


class Predicate:
    """Composable predicate over op call args: supports ``&``, ``|``, ``~``.
    """

    def __init__(self, fn: Callable[..., bool], name: Optional[str] = None):
        self._fn = fn
        self._name = name or getattr(fn, "__name__", "predicate")

    def __call__(self, *args: Any, **kwargs: Any) -> bool:
        return bool(self._fn(*args, **kwargs))

    def __and__(self, other: "Predicate") -> "Predicate":
        return Predicate(
            lambda *a, **k: self(*a, **k) and other(*a, **k),
            name=f"({self._name} & {other._name})",
        )

    def __or__(self, other: "Predicate") -> "Predicate":
        return Predicate(
            lambda *a, **k: self(*a, **k) or other(*a, **k),
            name=f"({self._name} | {other._name})",
        )

    def __invert__(self) -> "Predicate":
        return Predicate(lambda *a, **k: not self(*a, **k), name=f"~{self._name}")

    def __repr__(self) -> str:
        return f"Predicate({self._name})"


def predicate(fn: Callable[..., bool]) -> Predicate:
    """Decorator turning a plain callable into a composable Predicate."""
    return Predicate(fn)


class DispatcherPriority(enum.IntEnum):
    """Lower value = higher priority."""

    DEFAULT = 0
    FALLBACK = 1
    NOT_IMPLEMENTED_FALLBACK = 2


class DispatcherItem:
    __slots__ = ("kernel", "predicate", "priority")

    def __init__(
        self,
        kernel: Callable[..., Any],
        predicate: Optional[Predicate],
        priority: DispatcherPriority,
    ):
        self.kernel = kernel
        self.predicate = predicate
        self.priority = priority

    def matches(self, *args: Any, **kwargs: Any) -> bool:
        if self.predicate is None:
            return True
        try:
            return self.predicate(*args, **kwargs)
        except TypeError:
            # Signature mismatch between predicate and call site → no match.
            return False


_DISPATCHER: dict[str, list[DispatcherItem]] = {}


def _insert(name: str, item: DispatcherItem) -> None:
    items = _DISPATCHER.setdefault(name, [])
    # Stable insert: newest first within a priority band, bands ordered by
    # priority: the last registration wins.
    idx = 0
    for idx, existing in enumerate(items):
        if existing.priority >= item.priority:
            break
    else:
        idx = len(items)
    items.insert(idx, item)


class _RegistrationHandle:
    """Removable registration; also usable as a context manager."""

    def __init__(self, name: str, item: DispatcherItem):
        self._name = name
        self._item = item

    def remove(self) -> None:
        items = _DISPATCHER.get(self._name, [])
        if self._item in items:
            items.remove(self._item)

    def __enter__(self) -> "_RegistrationHandle":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.remove()


def register(
    name: str,
    kernel: Optional[Callable[..., Any]] = None,
    *,
    predicate: Optional[Predicate] = None,
    priority: DispatcherPriority = DispatcherPriority.DEFAULT,
) -> Any:
    """Register ``kernel`` for op ``name``.

    Usable directly, as a decorator, or as a context manager (the returned
    handle removes the registration on exit).
    """
    if kernel is None:

        def decorator(fn: Callable[..., Any]) -> Callable[..., Any]:
            register(name, fn, predicate=predicate, priority=priority)
            return fn

        return decorator

    item = DispatcherItem(kernel, predicate, priority)
    _insert(name, item)
    return _RegistrationHandle(name, item)


@contextlib.contextmanager
def dispatcher_context(
    name: str,
    kernel: Callable[..., Any],
    *,
    predicate: Optional[Predicate] = None,
    priority: DispatcherPriority = DispatcherPriority.DEFAULT,
) -> Iterator[None]:
    """Temporarily register a kernel for the duration of the context."""
    handle = register(name, kernel, predicate=predicate, priority=priority)
    try:
        yield
    finally:
        handle.remove()


def dispatch(name: str, *args: Any, **kwargs: Any) -> Optional[Callable[..., Any]]:
    """Return the first registered kernel whose predicate passes, or None.
    """
    for item in _DISPATCHER.get(name, ()):
        if item.matches(*args, **kwargs):
            return item.kernel
    return None


def registered_kernels(name: str) -> list[DispatcherItem]:
    return list(_DISPATCHER.get(name, ()))
