"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface. At first use it is
compiled by its own ``nvcc`` process for ``sm_90a`` into a shared library
under ``build/fastforward_tpu_torch/`` (next to the package, listed in
``.gitignore``), keyed on a hash of the source and the flags, and loaded
with ``ctypes``. All sources are compiled in parallel. Nothing here runs
at import time, so the package imports on a host without nvcc or a GPU.

Every pointer and the stream go to C as ``c_void_p``; every C entry point
returns the ``cudaGetLastError()`` value of its launches, and `check`
raises when it is not 0.

`launch_counts` holds one integer per kernel; a wrapper adds one where it
launches its kernel and nowhere else, so a run can show which kernels the
main path went through.
"""

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "fastforward_tpu_torch"

SOURCES = ("a4_gemv", "w4a8_gemv", "kv_append", "flash_decode", "dequant", "flash_prefill",
           "fused_tail", "w8a8_gemm", "w4a8_halves", "w4_gemv", "fused_head", "w4a16_gemm",
           "probe_int4")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float

# C signatures: every entry point returns int (a cudaError_t).
SIGNATURES = {
    "a4_gemv": {
        # x, xs, w, mult_packed, s_col, xf (staged activations), partial (or
        # NULL), out, M, K, N, L, layer, group, n_pack, n_split, depth,
        # out_kind (0 f32, 1 bf16), stream (the tensor-core tile)
        "ff_a4_gemv": [P] * 8 + [I] * 10 + [P],
        # the same arguments at any other group (the any-group route on the
        # same tensor cores; xf, n_split and depth of matmul.rows_plan)
        "ff_a4_gemv_any": [P] * 8 + [I] * 10 + [P],
    },
    "w4a8_gemv": {
        # x, xs, w, mult, s_col, xf (staged activations), partial (or NULL),
        # out, M, K, N, group, n_split, depth, out_kind (0 f32, 1 bf16),
        # stream; paired and group-halves layouts (the tensor-core tile)
        "ff_w4a8_gemv": [P] * 8 + [I] * 7 + [P],
        "ff_w4a8_gemv_unpaired": [P] * 8 + [I] * 7 + [P],
        # x, xs, w, mult, s_col, xf, partial (or NULL), pair_val, pair_idx,
        # idx_out, M, K, N, group, n_split, depth, stream (the tile with the
        # argmax epilogue)
        "ff_w4a8_gemv_argmax": [P] * 10 + [I] * 6 + [P],
        # x, xs, w, mult_packed, s_col, xf, partial (or NULL), out, M, K, N,
        # L, layer, group, n_pack, n_split, out_kind, bn (0: flat), depth,
        # stream: the stacked GEMV's six routes on the tensor-core tile's
        # ring of `depth` stages
        **{f"ff_w4a8_gemv_{route}": [P] * 8 + [I] * 11 + [P]
           for route in ("stacked", "preblocked", "manual", "splitw", "dotraw", "concat")},
        # any other group (the any-group route; xf, n_split and depth of
        # matmul.rows_plan): ff_w4a8_gemv's arguments, paired and group
        # halves, and ff_w4a8_gemv_stacked's (the stacked GEMV's every route)
        "ff_w4a8_gemv_any": [P] * 8 + [I] * 7 + [P],
        "ff_w4a8_gemv_unpaired_any": [P] * 8 + [I] * 7 + [P],
        "ff_w4a8_gemv_stacked_any": [P] * 8 + [I] * 11 + [P],
    },
    "w4a8_halves": {
        # x, xs, w, w_scale, out, xp (x in byte-row order, or NULL), M, K,
        # N, group, out_bf16, nt, row_blocks, n_split, fold, depth, stream
        # (int8 wgmma; the plan of matmul.w4a8_plan)
        "ff_w4a8_gemv_halves": [P] * 6 + [I] * 10 + [P],
    },
    "kv_append": {
        # kc, vc, ks, vs, k_new, v_new, ks_new, vs_new, starts,
        # L, B, Hkv, S, D, layer, stream
        "ff_kv_append": [P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, P],
        # kc, vc, ks, vs, k_new, v_new, ks_new, vs_new, positions, table,
        # L, P, B, Hkv, page, MP, D, layer, stream
        "ff_paged_kv_append": [P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, P],
        # kc, vc, ks, vs, k, v (bf16 or f32, strided), starts, L, B, Hkv, S,
        # D, layer, k strides (b, h, d), v strides, in_bf16, stream
        "ff_kv_quantize_append": [P] * 7 + [I] * 13 + [P],
        # kc, vc, ks, vs, k, v, positions, table, L, P, B, Hkv, page, MP, D,
        # layer, k strides, v strides, in_bf16, stream
        "ff_paged_kv_quantize_append": [P] * 8 + [I] * 15 + [P],
    },
    "flash_decode": {
        # q, k, ks, v, vs, lengths, out, L, B, H, Hkv, S, D, layer,
        # sm_scale, stream
        "ff_flash_decode": [P, P, P, P, P, P, P, I, I, I, I, I, I, I, F, P],
        # q, k, ks, v, vs, table, lengths, out, L, P, B, H, Hkv, page, MP,
        # D, layer, sm_scale, stream
        "ff_paged_flash_decode": [P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, F, P],
    },
    "dequant": {
        # w, mult (or NULL), scale, out, K, N, L, layer, group, stream
        "ff_dequant_vertical": [P, P, P, P, I, I, I, I, I, P],
        "ff_dequant_paired": [P, P, P, P, I, I, I, I, I, P],
        # ... group, bn, stream: pre-blocked (L, N/bn, K/2, bn) weights
        "ff_dequant_paired_preblocked": [P, P, P, P, I, I, I, I, I, I, P],
        # ... group, offset_binary, stream
        "ff_dequant_halves": [P, P, P, P, I, I, I, I, I, I, P],
    },
    "flash_prefill": {
        # q, k, ks, v, vs, starts, out, B, H, Hkv, T, S, D, sm_scale, stream
        "ff_flash_prefill": [P, P, P, P, P, P, P, I, I, I, I, I, I, F, P],
        # q, k, v, starts, out, B, H, Hkv, T, S, D, sm_scale, stream
        "ff_flash_prefill_bf16": [P, P, P, P, P, I, I, I, I, I, I, F, P],
    },
    "fused_tail": {
        # attn, x_res, norm_w, o_w, o_m, o_s, gu_w, gu_m, gu_s, dn_w, dn_m,
        # dn_s, scratch xs, scales, x1, hq, x2, xf_o, xf_gu, xf_dn, partial
        # (matmul.tail_plan's regions), out, M, K1, H, I, layer, group,
        # n_pack_o, n_pack_gu, n_pack_dn, split_o, split_gu, split_dn,
        # depth_o, depth_gu, depth_dn, eps, attn_bf16, out_bf16, stream
        "ff_fused_o_mlp": [P] * 22 + [I] * 15 + [F, I, I, P],
        # attn, x_res, norm_w, o_w, o_m, o_s, gu_w, gu_m, gu_s, scratch xs,
        # scales, hq, xf_o, xf_gu, partial, x1, gu, M, K1, H, N_GU, layer,
        # group, n_pack_o, n_pack_gu, split_o, split_gu, depth_o, depth_gu,
        # eps, attn_bf16, stream
        "ff_fused_o_gu": [P] * 17 + [I] * 12 + [F, I, P],
        # the same on the any-group route (any other group): the scratch
        # regions of matmul.tail_plan(..., route="any"), with xq (M, K1)
        # int8 after x1 (the tail) or after scales (the head)
        "ff_fused_o_mlp_any": [P] * 23 + [I] * 15 + [F, I, I, P],
        "ff_fused_o_gu_any": [P] * 18 + [I] * 12 + [F, I, P],
    },
    "fused_head": {
        # x, norm_w, w, mult_packed, s_col, hq, hs, xf (staged activations,
        # written by the prologue), partial (or NULL), out, M, K, N, layer,
        # group, n_pack, n_split, depth, inv_k, eps, out_bf16, stream (the
        # tensor-core tile: paired layout, and vertical for the A4 head)
        **{f"ff_fused_norm_qkv{sfx}": [P] * 10 + [I] * 8 + [F, F, I, P] for sfx in ("", "_a4")},
        # the same arguments at any other group: the prologue, then the
        # any-group route on hq (xf, n_split and depth of matmul.rows_plan)
        **{f"ff_fused_norm_qkv{sfx}_any": [P] * 10 + [I] * 8 + [F, F, I, P]
           for sfx in ("", "_a4")},
    },
    "w8a8_gemm": {
        # x, xs, w, ws, bias (or NULL), out, M, K, N, out_bf16, nt, n_split,
        # depth, group_m, stream (int8 wgmma; the plan of matmul.w8a8_plan)
        "ff_w8a8_gemm": [P] * 6 + [I] * 8 + [P],
    },
    "w4_gemv": {
        # x, w, w_scale, out, xp (x in byte-row order, or NULL), M, K, N,
        # group, n_split, depth, out_bf16, stream (wgmma; the plan of
        # matmul.w4_plan)
        "ff_w4_gemv": [P] * 5 + [I] * 7 + [P],
        # M, depth, n_split: the clusters the card runs at once
        "ff_w4_gemv_clusters": [I, I, I],
    },
    "w4a16_gemm": {
        # x, w, w_scale, bias (or NULL), out, xp (x in byte-row order, or
        # NULL), M, K, N, group, out_bf16, stream
        "ff_w4a16_gemm": [P] * 6 + [I] * 5 + [P],
    },
    "probe_int4": {
        # x, w, out, R, K, N, panels, rounds, int4, inst, stream
        "ff_probe_int4": [P, P, P, I, I, I, I, I, I, I, P],
    },
}

launch_counts: "collections.Counter[str]" = collections.Counter()

_libs: dict = {}
_lock = threading.Lock()
build_log: dict = {}


def reset_launch_counts() -> None:
    launch_counts.clear()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if cand and os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build_all() -> dict:
    """Compile every source that has no library yet, one nvcc each, all in
    parallel. Returns {name: seconds} for the sources built now."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {n: p for n, p in ((n, _lib_path(n)) for n in SOURCES) if not p.exists()}
    if not todo:
        return {}
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name, out in todo.items():
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    times, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        build_log[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name} (rc {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return times


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        if name in _libs:
            return _libs[name]
        path = _lib_path(name)
        if not path.exists():
            build_all()
        handle = ctypes.CDLL(str(path))
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(handle, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _libs[name] = handle
        return handle


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None,
            device=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` (and
    ``shape``/``device`` when given)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
