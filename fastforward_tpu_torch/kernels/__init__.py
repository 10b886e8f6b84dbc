"""Kernels of the port: packing, two-level int4 GEMVs, KV append and flash
decode. Each CUDA wrapper keeps its plain PyTorch version beside it and
counts its launches in `launch_counts`."""

from fastforward_tpu_torch.kernels._build import launch_counts, reset_launch_counts

__all__ = ["launch_counts", "reset_launch_counts"]
