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
           "fused_tail")

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
        # x, xs, w, mult_packed, s_col, partial, out, M, K, N, L, layer,
        # group, n_pack, n_split, stream
        "ff_a4_gemv": [P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, P],
    },
    "w4a8_gemv": {
        # x, xs, w, mult, s_col, partial, out, M, K, N, group, n_split,
        # out_kind (0 f32, 1 bf16), stream
        "ff_w4a8_gemv": [P, P, P, P, P, P, P, I, I, I, I, I, I, P],
        # x, xs, w, mult, s_col, partial, pair_val, pair_idx, idx_out,
        # M, K, N, group, n_split, stream
        "ff_w4a8_gemv_argmax": [P, P, P, P, P, P, P, P, P, I, I, I, I, I, P],
        # x, xs, w, mult_packed, s_col, partial, out, M, K, N, L, layer,
        # group, n_pack, n_split, out_kind, stream
        "ff_w4a8_gemv_stacked": [P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, P],
    },
    "kv_append": {
        # kc, vc, ks, vs, k_new, v_new, ks_new, vs_new, starts,
        # L, B, Hkv, S, D, layer, stream
        "ff_kv_append": [P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, P],
        # kc, vc, ks, vs, k_new, v_new, ks_new, vs_new, positions, table,
        # L, P, B, Hkv, page, MP, D, layer, stream
        "ff_paged_kv_append": [P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, P],
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
    },
    "flash_prefill": {
        # q, k, ks, v, vs, starts, out, B, H, Hkv, T, S, D, sm_scale, stream
        "ff_flash_prefill": [P, P, P, P, P, P, P, I, I, I, I, I, I, F, P],
    },
    "fused_tail": {
        # xq, xs, x_res, norm_w, o_w, o_m, o_s, gu_w, gu_m, gu_s, dn_w, dn_m,
        # dn_s, partial, x1, hq, gated, x2, red_a, red_b, scales, out, M, K1,
        # H, I, L, layer, group, n_pack_o, n_pack_gu, n_pack_dn, split_o,
        # split_gu, split_dn, eps, out_bf16, stream
        "ff_fused_o_mlp": [P] * 22 + [I] * 13 + [F, I, P],
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
