"""Kernels of the port: packing, the two-level int4 GEMVs, the
float-scale W8A8 GEMM and W4A8 / W4A16 GEMVs, the prefill dequant, the
fused W4A8 layer tail, KV append and flash attention over the slab, one
layer's cache and the paged pool; importing the package registers the W8A8
GEMM for `ops.linear` on an int8 per-channel weight (`dispatch.py`). Each CUDA wrapper keeps its plain
PyTorch version beside it and counts its launches in `launch_counts`.
The exported names are the JAX package's (`fastforward_tpu/kernels`)."""

from fastforward_tpu_torch.kernels._build import launch_counts, reset_launch_counts
from fastforward_tpu_torch.kernels.attention import flash_decode_int8, flash_decode_int8_reference
from fastforward_tpu_torch.kernels.matmul import (
    convert_two_level,
    dequantize_int4,
    matmul_w4_gemv,
    matmul_w4a8,
    matmul_w4a8_2l_gemv,
    matmul_w4a8_2l_gemv_stacked,
    matmul_w4a8_2l_reference,
    matmul_w4a8_gemv,
    matmul_w4a8_reference,
    matmul_w4a16,
    matmul_w4a16_reference,
    matmul_w8a8,
    matmul_w8a8_reference,
    preblock_stacked,
    quantize_rowwise,
)
from fastforward_tpu_torch.kernels.packing import (
    pack_int4,
    pack_uint4_offset,
    unpack_int4,
    unpack_uint4_offset,
)
from fastforward_tpu_torch.kernels import dispatch as _dispatch  # noqa: F401  (registers kernels)

__all__ = [
    "launch_counts",
    "reset_launch_counts",
    "matmul_w8a8",
    "matmul_w8a8_reference",
    "matmul_w4a8",
    "matmul_w4a8_gemv",
    "dequantize_int4",
    "matmul_w4_gemv",
    "matmul_w4a8_reference",
    "matmul_w4a16",
    "matmul_w4a16_reference",
    "quantize_rowwise",
    "convert_two_level",
    "matmul_w4a8_2l_gemv",
    "matmul_w4a8_2l_gemv_stacked",
    "matmul_w4a8_2l_reference",
    "preblock_stacked",
    "pack_int4",
    "pack_uint4_offset",
    "flash_decode_int8",
    "flash_decode_int8_reference",
    "unpack_int4",
    "unpack_uint4_offset",
]
