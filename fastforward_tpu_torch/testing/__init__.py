"""Testing utilities (`fastforward_tpu/testing/`): the `sqnr` metric,
quantizer initialization, PRNG seeding, rounding-boundary checks, string
comparison and in-memory packages. `hf_golden` (HF-format fixtures, which
import ``transformers`` inside their functions) is imported from its
module."""

import difflib
import textwrap

import numpy as np
import torch

from fastforward_tpu_torch.device import resolve_device
from fastforward_tpu_torch.testing.initialization import initialize_quantizers_to_linear_quantizer
from fastforward_tpu_torch.testing.package_mock import PackageMock
from fastforward_tpu_torch.utils.metrics import sqnr

__all__ = [
    "sqnr",
    "initialize_quantizers_to_linear_quantizer",
    "seed_prngs",
    "is_close_to_rounding",
    "dedent_strip",
    "assert_strings_match_verbose",
    "PackageMock",
]


def dedent_strip(s: str) -> str:
    """Dedent + strip a triple-quoted block (reference `testing/string.py:8`)."""
    return textwrap.dedent(s).strip()


def assert_strings_match_verbose(actual: str, expected: str) -> None:
    """Assert string equality with a line-level diff on mismatch
    (reference `testing/string.py:13`)."""
    if actual == expected:
        return
    diff = "\n".join(
        difflib.unified_diff(
            expected.splitlines(), actual.splitlines(),
            fromfile="expected", tofile="actual", lineterm="",
        )
    )
    raise AssertionError(f"strings do not match:\n{diff}")


def seed_prngs(seed: int = 0xF0F0, device=None) -> torch.Generator:
    """Seed numpy and return a `torch.Generator` seeded with ``seed`` on
    ``device`` (default: the GPU), where the JAX function returns a PRNG
    key (reference `testing/__init__.py:22`)."""
    np.random.seed(seed)
    return torch.Generator(device=resolve_device(device)).manual_seed(seed)


def is_close_to_rounding(data, scale=1.0, eps: float = 1e-4) -> torch.Tensor:
    """True where data / scale lies within eps of a rounding boundary
    (a half-integer), to exclude unstable comparisons in tests (reference
    `testing/__init__.py:13`)."""
    x = torch.as_tensor(data) / scale
    frac = torch.abs(x - torch.floor(x) - 0.5)
    return frac < eps
