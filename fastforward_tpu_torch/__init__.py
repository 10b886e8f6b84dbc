"""PyTorch/CUDA port of `fastforward_tpu`.

The JAX package stays the reference; every module here keeps the name and
public functions of its JAX counterpart so each can be held against it.
Plain tensor code is PyTorch; each Pallas kernel on the ported path is a
CUDA kernel written by hand for Hopper (`csrc/`), built with nvcc at first
use. This package imports neither JAX nor `fastforward_tpu`.

Entry points run on the GPU unless the caller passes ``device="cpu"``;
kernel wrappers dispatch by the device of the tensor they are given.

The top level exports, under the JAX package's names, the simulation
tier's configuration API ported so far: `QuantizationConfig`,
`find_quantizers`, `estimate_ranges`, `range_setting` and `mpath`.
"""

from fastforward_tpu_torch import mpath, range_setting
from fastforward_tpu_torch.device import resolve_device
from fastforward_tpu_torch.quant_init import QuantizationConfig, find_quantizers
from fastforward_tpu_torch.range_setting import estimate_ranges

__all__ = [
    "resolve_device",
    "QuantizationConfig",
    "find_quantizers",
    "estimate_ranges",
    "range_setting",
    "mpath",
]
