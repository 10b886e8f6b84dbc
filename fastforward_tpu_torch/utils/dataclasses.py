"""Dataclass helpers (`fastforward_tpu/utils/dataclasses.py`)."""

import dataclasses
from typing import Any


def nocopy_asdict(obj: Any) -> dict[str, Any]:
    """Like `dataclasses.asdict`, but the values are neither copied nor
    recursed into: tensor fields are passed by reference (reference
    `dataclasses.py:9`)."""
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
