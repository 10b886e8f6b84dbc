"""PyTorch/CUDA port of `fastforward_tpu`.

The JAX package stays the reference; every module here keeps the name and
public functions of its JAX counterpart so each can be held against it.
Plain tensor code is PyTorch; each Pallas kernel on the ported path is a
CUDA kernel written by hand for Hopper (`csrc/`), built with nvcc at first
use. This package imports neither JAX nor `fastforward_tpu`.

Entry points run on the GPU unless the caller passes ``device="cpu"``;
kernel wrappers dispatch by the device of the tensor they are given.

The top level exports, under the JAX package's names, the simulation
tier's API ported so far: `QuantizationConfig`, `find_quantizers`,
`estimate_ranges`, `range_setting` and `mpath`; `autoquantize`, the fx
pass's `trace_quantization_sites`, the module graph's `trace_modules`,
`GraphModule` and `run_scheduled`, and the `export` package (as in the
JAX package, ``export.export`` is the function).
"""

from fastforward_tpu_torch import export, mpath, range_setting
from fastforward_tpu_torch.autoquant import autoquantize
from fastforward_tpu_torch.autoquant_fx import trace_quantization_sites
from fastforward_tpu_torch.device import resolve_device
from fastforward_tpu_torch.graph import GraphModule, run_scheduled, trace_modules
from fastforward_tpu_torch.quant_init import QuantizationConfig, find_quantizers
from fastforward_tpu_torch.range_setting import estimate_ranges

__all__ = [
    "resolve_device",
    "QuantizationConfig",
    "find_quantizers",
    "estimate_ranges",
    "range_setting",
    "mpath",
    "autoquantize",
    "trace_quantization_sites",
    "trace_modules",
    "GraphModule",
    "run_scheduled",
    "export",
]
