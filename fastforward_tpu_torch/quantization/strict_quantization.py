"""Per-module strict-quantization scoping
(`fastforward_tpu/quantization/strict_quantization.py`).

Sets the strict-quantization flag to a module's own value for the duration
of each of its forwards, whatever the surrounding context: a forward
pre-hook sets the flag and a forward hook (``always_call``, so also when the
forward raises) puts the previous value back. The flag is a ContextVar, so
nested and recursive calls unwind in order.
"""

from typing import Any

import torch

from fastforward_tpu_torch import flags


class ModuleStrictQuantHandle:
    """Handle of a per-module strict-quantization override; ``remove()``
    (or leaving it as a context manager) takes the hooks off."""

    def __init__(self, module: torch.nn.Module, value: bool):
        self._module = module
        self._value = bool(value)
        tokens = []
        var = flags._FLAGS["strict_quantization"]

        def pre_hook(mod, args):
            tokens.append(var.set(self._value))

        def post_hook(mod, args, output):
            var.reset(tokens.pop())

        self._handles = (module.register_forward_pre_hook(pre_hook),
                         module.register_forward_hook(post_hook, always_call=True))

    def remove(self) -> None:
        for h in self._handles:
            h.remove()

    def __enter__(self) -> "ModuleStrictQuantHandle":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.remove()


def strict_quantization_for_module(module: torch.nn.Module,
                                   value: bool = True) -> ModuleStrictQuantHandle:
    """Force strict quantization on or off for ``module``'s forwards; usable
    as a context manager:

        with strict_quantization_for_module(model.decoder, False):
            model(x)
    """
    return ModuleStrictQuantHandle(module, value)
