"""Operator spec serialization (`fastforward_tpu/ops/spec.py`).

The decorated functions are the source of truth; the YAML view of the
reference's operator spec is generated from the table. PyYAML is imported
inside the functions that write YAML, so importing the port loads no yaml.
"""

import inspect
from typing import Any

from fastforward_tpu_torch.ops.optable import OPERATOR_TABLE, OperatorSpec


def _signature_string(spec: OperatorSpec) -> str:
    sig = inspect.signature(spec.dense_fn)
    parts = []
    for name, param in sig.parameters.items():
        if name in spec.quantized:
            kind = "Quantized"
        elif name in spec.maybe_quantized:
            kind = "MaybeQuantized"
        else:
            kind = "Any"
        if param.default is inspect.Parameter.empty:
            parts.append(f"{name}: {kind}")
        else:
            parts.append(f"{name}: {kind} = {param.default!r}")
    return f"{spec.name}({', '.join(parts)}) -> Quantized"


def operator_table_to_yaml() -> str:
    """Render the live operator table in the reference's YAML shape."""
    import yaml

    entries: list[dict[str, Any]] = []
    for spec in OPERATOR_TABLE.values():
        entry: dict[str, Any] = {
            "op": _signature_string(spec),
            "fallback": f"{spec.dense_fn.__module__}.{spec.dense_fn.__name__}",
        }
        if spec.aliases:
            entry["aliases"] = list(spec.aliases)
        entries.append(entry)
    return yaml.safe_dump(entries, sort_keys=False)


def write_operator_yaml(path: str) -> None:
    import fastforward_tpu_torch.ops  # noqa: F401  — populate the table

    with open(path, "w") as f:
        f.write(operator_table_to_yaml())
