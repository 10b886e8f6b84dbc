"""Load-time quantize and pack of dense weights (`fastforward_tpu/native.py`).

The JAX package does this on the host through its C++ library
(`native/ffq_native.cc`, bound by ctypes) with a numpy fallback. The port
needs no host library: `quantize_pack_int4` and `quantize_int8` take and
return numpy arrays as the JAX functions do, and compute through the
loader's packers (`serving/loader.py` `quantize_pack_int4`,
`quantize_int8`) on ``device`` (default: the GPU). Their bytes are the C++
library's: a float32 absmax, a true float32 division by 7 or 127 (1e-8
for an all-zero group or column), then ties rounded away from zero
(``std::lround``), for float32 and bfloat16 inputs alike. (The JAX
module sends bfloat16 weights, and int8 of anything but float32, to its
numpy fallback, which rounds ties to even; its C++ entries round them away
from zero.)
"""

import numpy as np
import torch

from fastforward_tpu_torch.device import resolve_device
from fastforward_tpu_torch.serving import loader


def native_available() -> bool:
    """True: the port's packers are torch functions and need no host
    library to be built or loaded."""
    return True


def _as_f32_tensor(w: np.ndarray, dev: torch.device) -> torch.Tensor:
    """``w`` as float32 on ``dev``: numpy's bfloat16 (ml_dtypes) through its
    words, widened exactly; any other dtype as the JAX module converts it."""
    if w.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.array(w).view(np.int16))
        return bits.view(torch.bfloat16).to(dev).float()
    return torch.from_numpy(np.array(w, np.float32)).to(dev)


def quantize_pack_int4(w: np.ndarray, group_size: int = 128, device=None):
    """Per-group symmetric int4 quantize + pack of a (K, N) weight: (packed
    (K//2, N) int8 in `kernels.packing.pack_int4`'s layout, scales
    (K//group_size, N) float32)."""
    K, _ = w.shape
    if K % group_size != 0:
        raise ValueError(f"K={K} not divisible by group_size={group_size}")
    packed, scales = loader.quantize_pack_int4(_as_f32_tensor(w, resolve_device(device)),
                                               group_size)
    return packed.cpu().numpy(), scales.cpu().numpy()


def quantize_int8(w: np.ndarray, device=None):
    """Per-output-channel symmetric int8 quantize of a (K, N) weight: (q
    (K, N) int8, scales (N,) float32)."""
    q, scales = loader.quantize_int8(_as_f32_tensor(w, resolve_device(device)))
    return q.cpu().numpy(), scales.cpu().numpy()
