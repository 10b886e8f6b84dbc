"""Stackable function-override machinery (`fastforward_tpu/forward_override.py`).

Wraps a module's function, ``nn.Module.forward`` or a quantizer's quantize,
in a stack of overrides. Each override receives a context (the module),
the function it overrides (the next override down the stack, or the
original function) and the call's arguments. A module mixes in
`OverrideMixin` and runs ``apply_overrides(self, self._forward)(*args)``
in its ``forward``. Used by range estimators, quantization disabling and
freezing.
"""

import weakref
from typing import Any, Callable, Optional, Protocol


class OverrideFn(Protocol):
    def __call__(
        self,
        context: Any,
        overridden_fn: Callable[..., Any],
        args: tuple[Any, ...],
        kwargs: dict[str, Any],
    ) -> Any: ...


class OverrideHandle:
    """Handle to a registered override; removing it detaches the override.

    Also usable as a context manager.
    """

    def __init__(self, owner: Any, override: OverrideFn):
        self._owner = weakref.ref(owner)
        self.override = override
        self.enabled = True

    def remove(self) -> None:
        owner = self._owner()
        if owner is not None:
            owner._remove_override_handle(self)
        self.enabled = False

    def __enter__(self) -> "OverrideHandle":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.remove()


class OverrideMixin:
    """Mixin providing an override stack for a callable module.

    The wrapped function is produced by `apply_overrides`; overrides apply
    top-of-stack first (most recently registered runs outermost).
    """

    __slots__ = ()

    def _override_handles(self) -> list[OverrideHandle]:
        if not hasattr(self, "_overrides"):
            object.__setattr__(self, "_overrides", [])
        return self._overrides  # type: ignore[attr-defined]

    def register_override(self, override: OverrideFn) -> OverrideHandle:
        handle = OverrideHandle(self, override)
        self._override_handles().append(handle)
        return handle

    def _remove_override_handle(self, handle: OverrideHandle) -> None:
        handles = self._override_handles()
        if handle in handles:
            handles.remove(handle)

    @property
    def has_overrides(self) -> bool:
        return bool(self._override_handles())


def apply_overrides(
    context: Any,
    base_fn: Callable[..., Any],
    handles: Optional[list[OverrideHandle]] = None,
) -> Callable[..., Any]:
    """Build the wrapped callable: overrides chain outermost-last-registered.
    """
    if handles is None:
        handles = getattr(context, "_overrides", [])

    fn = base_fn
    for handle in handles:
        if not handle.enabled:
            continue
        fn = _bind(handle.override, context, fn)
    return fn


def _bind(override: OverrideFn, context: Any, inner: Callable[..., Any]) -> Callable[..., Any]:
    def wrapped(*args: Any, **kwargs: Any) -> Any:
        return override(context, inner, args, kwargs)

    return wrapped
