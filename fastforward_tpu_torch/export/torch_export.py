"""Model export: a `torch.export` program and its encodings
(`fastforward_tpu/export/stablehlo.py`, where the JAX package writes a
StableHLO program).

The forward is exported under `flags.export_mode(True)` and non-strict
quantization, so every quantizer emits quantize-dequantized plain tensors
and the exported program is plain aten ops: no `QuantizedTensor`, no
dispatcher and no kernel of the port in it. It is written as
``<name>.pt2`` (`torch.export.save`; `torch.export.load` reads it back),
beside ``<name>.graph.txt`` (the exported graph's Python code) and
``<name>.encodings.json`` (the quantizers' encodings in the schema asked
for).
"""

import json
import os
from typing import Any, Optional

import torch

from fastforward_tpu_torch import flags
from fastforward_tpu_torch.export.encodings import (
    SCHEMA_HANDLERS,
    LPBQProcessor,
    QuantizerEncoding,
    V2SchemaHandler,
)
from fastforward_tpu_torch.nn.linear_quantizer import LinearQuantizer
from fastforward_tpu_torch.nn.quantized_module import named_quantizers
from fastforward_tpu_torch.nn.quantizer import QuantizerStub

__all__ = ["collect_encodings", "export", "export_modules"]


def collect_encodings(model: torch.nn.Module) -> list[QuantizerEncoding]:
    """The calibrated `LinearQuantizer`s of ``model`` as schema-ready
    entries, named by their ``/``-joined paths (the JAX package's names)."""
    out = []
    seen: set[int] = set()
    for name, q in named_quantizers(model):
        if isinstance(q, QuantizerStub) or id(q) in seen:
            continue
        seen.add(id(q))
        if not isinstance(q, LinearQuantizer) or q.scale is None:
            continue
        meta = getattr(q, "quant_metadata", None)
        out.append(QuantizerEncoding(
            name=name.replace(".", "/"),
            num_bits=q.num_bits,
            scale=q.scale.detach().cpu().numpy(),
            offset=None if q.offset is None else q.offset.detach().cpu().numpy(),
            granularity=q.granularity,
            symmetric=q.symmetric,
            data_shape=getattr(meta, "input_shape", None) if meta else None,
            producing_operator=getattr(meta, "producing_operator", None) if meta else None,
        ))
    return out


class _ExportForward(torch.nn.Module):
    """``model``'s forward under export mode and non-strict quantization."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model

    def forward(self, *args, **kwargs):
        with flags.export_mode(True), flags.strict_quantization(False):
            return self.model(*args, **kwargs)


def export(
    model: torch.nn.Module,
    sample_args: tuple,
    output_dir: str,
    name: str = "model",
    schema: str = "v1",
    lpbq: Optional[LPBQProcessor] = None,
    sample_kwargs: Optional[dict] = None,
    annotate: bool = True,
) -> dict[str, str]:
    """Export ``model`` to ``<output_dir>/<name>.pt2``,
    ``<name>.graph.txt`` and ``<name>.encodings.json``; returns the paths
    (keys ``program``, ``graph``, ``encodings``).

    With ``annotate``, one sample forward first tags each quantizer with the
    operator that fed it, so that the encodings carry it (``"op"``)."""
    os.makedirs(output_dir, exist_ok=True)
    sample_kwargs = sample_kwargs or {}
    if annotate:
        from fastforward_tpu_torch.quantization.quantizer_annotations import (
            annotate_operator_metadata,
        )

        with torch.no_grad():
            annotate_operator_metadata(model, *sample_args, **sample_kwargs)

    with torch.no_grad():
        program = torch.export.export(_ExportForward(model), tuple(sample_args),
                                      dict(sample_kwargs), strict=False)
    paths = {k: os.path.join(output_dir, f"{name}.{ext}") for k, ext in (
        ("program", "pt2"), ("graph", "graph.txt"), ("encodings", "encodings.json"))}
    torch.export.save(program, paths["program"])
    with open(paths["graph"], "w") as f:
        f.write(program.graph_module.code)

    handler_cls = SCHEMA_HANDLERS[schema]
    handler = handler_cls(lpbq) if handler_cls is V2SchemaHandler else handler_cls()
    with open(paths["encodings"], "w") as f:
        json.dump(handler.encode(collect_encodings(model)), f, indent=2)
    return paths


def export_modules(
    model: torch.nn.Module,
    sample_args: tuple,
    query: str,
    output_dir: str,
    schema: str = "v1",
    context: Optional[dict] = None,
) -> dict[str, dict[str, str]]:
    """Export each module matching the mpath ``query`` on its own, with its
    real input captured from a sample forward (through an override on its
    input quantizer); a matched module without an input quantizer, or one
    the forward does not reach, is skipped."""
    from fastforward_tpu_torch import mpath

    items = list(mpath.search(query, model, context=context))
    captured: dict[str, Any] = {}
    handles = []
    for item in items:
        quantizer = getattr(item.module, "input_quantizer", None)
        if quantizer is None:
            continue

        def recorder(ctx, inner, args, kwargs, _name=item.full_name):
            captured.setdefault(_name, args[0])
            return inner(*args, **kwargs)

        handles.append(quantizer.register_override(recorder))
    try:
        with torch.no_grad(), flags.strict_quantization(False):
            model(*sample_args)
    finally:
        for h in handles:
            h.remove()

    results = {}
    for item in items:
        if item.full_name not in captured:
            continue
        tag = item.full_name.replace("/", "_")
        results[item.full_name] = export(item.module, (captured[item.full_name],),
                                         os.path.join(output_dir, tag), name=tag, schema=schema)
    return results
