"""Straight-through estimators (`fastforward_tpu/quantization/ste.py`).

The forward value is the function's, the gradient flows straight through
to the first argument: ``x + (f(x) - x).detach()``, the PyTorch form of
JAX's ``x + stop_gradient(f(x) - x)``.
"""

from typing import Callable

import torch


def ste(func: Callable[..., torch.Tensor]) -> Callable[..., torch.Tensor]:
    """``func`` with an identity gradient to its first argument."""

    def wrapper(data: torch.Tensor, *args, **kwargs) -> torch.Tensor:
        return data + (func(data, *args, **kwargs) - data).detach()

    wrapper.__name__ = f"{getattr(func, '__name__', 'fn')}_ste"
    return wrapper


def round_ste(data: torch.Tensor) -> torch.Tensor:
    """Round half to even with a straight-through (identity) gradient."""
    return data + (torch.round(data) - data).detach()
