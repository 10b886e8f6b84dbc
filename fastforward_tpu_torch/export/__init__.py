"""Export (`fastforward_tpu/export/`): encodings schemas, the staged export
pipeline, and the `torch.export` program (the JAX package's StableHLO)."""

from fastforward_tpu_torch.export.encodings import (
    LegacySchemaHandler,
    LPBQProcessor,
    QuantizerEncoding,
    V1SchemaHandler,
    V2SchemaHandler,
)
from fastforward_tpu_torch.export.pipeline import (
    ExportContext,
    Pipeline,
    PipelineRegistry,
    build_default_registry,
    run_export_pipeline,
)
from fastforward_tpu_torch.export.torch_export import collect_encodings, export, export_modules

__all__ = [
    "export",
    "export_modules",
    "run_export_pipeline",
    "Pipeline",
    "PipelineRegistry",
    "ExportContext",
    "build_default_registry",
    "collect_encodings",
    "QuantizerEncoding",
    "LegacySchemaHandler",
    "V1SchemaHandler",
    "V2SchemaHandler",
    "LPBQProcessor",
]
