"""PyTorch/CUDA port of `fastforward_tpu`.

The JAX package stays the reference; every module here keeps the name and
public functions of its JAX counterpart so each can be held against it.
Plain tensor code is PyTorch; each Pallas kernel on the ported path is a
CUDA kernel written by hand for Hopper (`csrc/`), built with nvcc at first
use. This package imports neither JAX nor `fastforward_tpu`.

Entry points run on the GPU unless the caller passes ``device="cpu"``;
kernel wrappers dispatch by the device of the tensor they are given.

The top level exports what `fastforward_tpu/__init__.py` exports, under
its names: the dispatcher, the flags, the quantization core, the
exceptions; its lazy submodules (``testing`` and ``native`` among them),
submodule aliases and lazy names through the same module ``__getattr__``.
Where the port's object has another name, the JAX name points at it:
``QuantizedArray`` and ``QuantizedTensor`` are both `QuantizedTensor`, and
``JaxprQuantizationPlan`` is the fx pass's `FxQuantizationPlan`. The
port's own exports stay: `resolve_device`, `QuantizationConfig`,
`find_quantizers`, `estimate_ranges`, `range_setting`, `mpath`,
`autoquantize`, `trace_quantization_sites`, the module graph's
`trace_modules`, `GraphModule` and `run_scheduled`, and the `export`
package (as in the JAX package, ``export.export`` is the function).
"""

from fastforward_tpu_torch import dispatcher, exceptions, export, flags, mpath, range_setting
from fastforward_tpu_torch.autoquant import autoquantize
from fastforward_tpu_torch.autoquant_fx import trace_quantization_sites
from fastforward_tpu_torch.device import resolve_device
from fastforward_tpu_torch.dispatcher import (
    DispatcherPriority,
    Predicate,
    dispatch,
    predicate,
    register,
)
from fastforward_tpu_torch.exceptions import AutoquantError, ExportError, QuantizationError
from fastforward_tpu_torch.flags import (
    export_mode,
    get_export_mode,
    get_strict_quantization,
    get_use_kernels,
    set_export_mode,
    set_strict_quantization,
    set_use_kernels,
    strict_quantization,
    use_kernels,
)
from fastforward_tpu_torch.graph import GraphModule, run_scheduled, trace_modules
from fastforward_tpu_torch.quant_init import QuantizationConfig, find_quantizers
from fastforward_tpu_torch.quantization import (
    AffineQuantizationFunction,
    DynamicAffineQuantParams,
    Granularity,
    PerBlock,
    PerChannel,
    PerTensor,
    PerTile,
    QuantizationContext,
    QuantizationFunction,
    QuantizationParameters,
    StaticAffineQuantParams,
    granularity_from_sizes,
    is_quantized,
    quantize_dynamically,
    quantize_per_block,
    quantize_per_channel,
    quantize_per_granularity,
    quantize_per_tensor,
)
from fastforward_tpu_torch.quantization import QuantizedTensor as QuantizedArray
from fastforward_tpu_torch.range_setting import estimate_ranges

__all__ = [
    "dispatcher",
    "exceptions",
    "flags",
    "DispatcherPriority",
    "Predicate",
    "dispatch",
    "predicate",
    "register",
    "QuantizedArray",
    "QuantizationContext",
    "QuantizationFunction",
    "QuantizationParameters",
    "AffineQuantizationFunction",
    "StaticAffineQuantParams",
    "DynamicAffineQuantParams",
    "Granularity",
    "PerTensor",
    "PerChannel",
    "PerBlock",
    "PerTile",
    "granularity_from_sizes",
    "is_quantized",
    "quantize_per_tensor",
    "quantize_per_channel",
    "quantize_per_block",
    "quantize_per_granularity",
    "quantize_dynamically",
    "QuantizationError",
    "ExportError",
    "AutoquantError",
    "strict_quantization",
    "export_mode",
    "use_kernels",
    "trace_quantization_sites",
    "JaxprQuantizationPlan",
    # the port's own
    "resolve_device",
    "QuantizationConfig",
    "find_quantizers",
    "estimate_ranges",
    "range_setting",
    "mpath",
    "autoquantize",
    "trace_modules",
    "GraphModule",
    "run_scheduled",
    "export",
]

_LAZY_SUBMODULES = {
    "ops", "nn", "mpath", "range_setting", "kernels", "models",
    "parallel", "serving", "export", "algorithms", "quant_init", "testing",
    "overrides", "autoquant", "native",
}

# Submodule aliases of the reference namespace layout (`fastforward.affine`,
# `fastforward.granularity`, ...), as the JAX package has them.
_SUBMODULE_ALIASES = {
    "affine": "fastforward_tpu_torch.quantization.affine_function",
    "granularity": "fastforward_tpu_torch.quantization.granularity",
    "random": "fastforward_tpu_torch.quantization.random",
    "logging_utils": "fastforward_tpu_torch.utils.logging_utils",
    "dataclasses": "fastforward_tpu_torch.utils.dataclasses",
    "type_common": "fastforward_tpu_torch.utils.common",
}

version = "0.1.0"
__version__ = version

# Top-level convenience names resolved lazily from heavier subsystems.
_LAZY_NAMES = {
    "quantize_model": ("fastforward_tpu_torch.nn", "quantize_model"),
    "surrogate_quantized_module": ("fastforward_tpu_torch.nn", "surrogate_quantized_module"),
    "named_quantizers": ("fastforward_tpu_torch.nn", "named_quantizers"),
    "summarize_quantizers": ("fastforward_tpu_torch.nn", "summarize_quantizers"),
    "estimate_ranges": ("fastforward_tpu_torch.range_setting", "estimate_ranges"),
    "find_quantizers": ("fastforward_tpu_torch.quant_init", "find_quantizers"),
    "QuantizationConfig": ("fastforward_tpu_torch.quant_init", "QuantizationConfig"),
    "disable_quantization": ("fastforward_tpu_torch.overrides", "disable_quantization"),
    "enable_quantization": ("fastforward_tpu_torch.overrides", "enable_quantization"),
    "sqnr": ("fastforward_tpu_torch.utils.metrics", "sqnr"),
    "autoquantize": ("fastforward_tpu_torch.autoquant", "autoquantize"),
    "PatternRule": ("fastforward_tpu_torch.autoquant", "PatternRule"),
    "trace_quantization_sites": (
        "fastforward_tpu_torch.autoquant_fx", "trace_quantization_sites",
    ),
    "JaxprQuantizationPlan": ("fastforward_tpu_torch.autoquant_fx", "FxQuantizationPlan"),
    "freeze_parameters": ("fastforward_tpu_torch.quantization.freeze", "freeze_parameters"),
    "strict_quantization_for_module": (
        "fastforward_tpu_torch.quantization.strict_quantization",
        "strict_quantization_for_module",
    ),
    "annotate_operator_metadata": (
        "fastforward_tpu_torch.quantization.quantizer_annotations",
        "annotate_operator_metadata",
    ),
    "random_quantized": ("fastforward_tpu_torch.quantization.random", "random_quantized"),
    "QuantizedTensor": ("fastforward_tpu_torch.quantization.quantized_array", "QuantizedTensor"),
    "quantized_module_map": ("fastforward_tpu_torch.nn", "quantized_module_map"),
    "surrogate_quantized_modules": ("fastforward_tpu_torch.nn", "surrogate_quantized_modules"),
    "sdpa_upcast": ("fastforward_tpu_torch.ops.sdpa", "sdpa_upcast"),
    "layerwise_optimize": ("fastforward_tpu_torch.algorithms", "layerwise_optimize"),
    "gptq": ("fastforward_tpu_torch.algorithms", "gptq"),
}


def __getattr__(name):
    import importlib

    if name in _LAZY_SUBMODULES:
        return importlib.import_module(f"fastforward_tpu_torch.{name}")
    if name in _SUBMODULE_ALIASES:
        return importlib.import_module(_SUBMODULE_ALIASES[name])
    if name in _LAZY_NAMES:
        module_name, attr = _LAZY_NAMES[name]
        return getattr(importlib.import_module(module_name), attr)
    raise AttributeError(f"module 'fastforward_tpu_torch' has no attribute {name!r}")
