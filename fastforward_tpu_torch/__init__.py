"""PyTorch/CUDA port of the `fastforward_tpu` execution tier.

The JAX package stays the reference; every module here keeps the name and
public functions of its JAX counterpart so each can be held against it.
Plain tensor code is PyTorch; each Pallas kernel on the ported path is a
CUDA kernel written by hand for Hopper (`csrc/`), built with nvcc at first
use. This package imports neither JAX nor `fastforward_tpu`.

Entry points run on the GPU unless the caller passes ``device="cpu"``;
kernel wrappers dispatch by the device of the tensor they are given.
"""

from fastforward_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
