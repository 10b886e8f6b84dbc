"""Checkpoint loading, ported from `fastforward_tpu/serving/loader.py`:
HF-layout Llama safetensors to per-layer `ServingParams`.

`load_tensors` reads the safetensors format itself (an 8-byte
little-endian header length, a JSON header of dtype, shape and byte
offsets, then the raw bytes), float (F64, F32, F16, BF16), integer (I64,
I32, I16, I8, U8) and BOOL, with `torch.frombuffer`; `write_safetensors`
writes it: the ``safetensors`` package is not needed. HF stores a linear weight as
(out, in); the serving layout is (in, out), transposed on load.

The JAX loader quantizes on the host through its C++ library
(`native/ffq_native.cc`). Here each weight goes to ``device`` (default:
the GPU) and is quantized there by plain torch functions that give the
C++ packer's bytes: float32 absmax over the group (int4) or the column
(int8), ``absmax / 7`` or ``/ 127`` as a true float32 division (1e-8 for
an all-zero group or column), ``w / scale`` likewise, then rounding half
away from zero (``std::lround``; ``torch.round`` rounds half to even, as
the JAX package's numpy fallback does, and would differ on exact ties).

Modes: ``w8a8``, ``w4a8`` and ``w4a16``. The JAX loader's two-level modes
build a `QuantLinear` without multipliers (`loader.py:44-55`) that cannot
run; here they raise.
"""

import json
import os
import struct
from typing import Dict, Iterator, Optional

import torch

from fastforward_tpu_torch.device import resolve_device
from fastforward_tpu_torch.kernels.packing import pack_int4
from fastforward_tpu_torch.models.llama import LlamaConfig
from fastforward_tpu_torch.serving.engine import QuantLinear, ServingLayer, ServingParams

LOADER_MODES = ("w8a8", "w4a8", "w4a16")

_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
           "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
           "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}


def _iter_safetensor_files(path: str) -> Iterator[str]:
    if os.path.isfile(path):
        yield path
        return
    for name in sorted(os.listdir(path)):
        if name.endswith(".safetensors"):
            yield os.path.join(path, name)


def read_safetensors(file: str) -> Dict[str, torch.Tensor]:
    """The tensors of one safetensors file, as CPU tensors."""
    with open(file, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        base = 8 + n
        out = {}
        for name, info in header.items():
            if name == "__metadata__":
                continue
            if info["dtype"] not in _DTYPES:
                raise ValueError(f"{file}: {name} has dtype {info['dtype']}, not one of "
                                 f"{sorted(_DTYPES)}")
            begin, end = info["data_offsets"]
            buf = bytearray(end - begin)
            f.seek(base + begin)
            if f.readinto(buf) != len(buf):
                raise ValueError(f"{file}: {name} runs past the end of the file")
            t = torch.frombuffer(buf, dtype=_DTYPES[info["dtype"]]) if buf else \
                torch.empty(0, dtype=_DTYPES[info["dtype"]])
            out[name] = t.reshape(info["shape"])
    return out


def write_safetensors(file: str, tensors: Dict[str, torch.Tensor]) -> None:
    """Write CPU or GPU tensors of those dtypes as one safetensors file."""
    names = {v: k for k, v in _DTYPES.items()}
    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(file, "wb") as f:
        f.write(struct.pack("<Q", len(raw)) + raw)
        for t in tensors.values():
            f.write(t.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())


def load_tensors(path: str) -> Dict[str, torch.Tensor]:
    """All tensors of a safetensors file or of a directory of shards."""
    tensors: Dict[str, torch.Tensor] = {}
    for file in _iter_safetensor_files(path):
        tensors.update(read_safetensors(file))
    if not tensors:
        raise FileNotFoundError(f"no safetensors found at {path}")
    return tensors


def _round_half_away(y: torch.Tensor) -> torch.Tensor:
    """``std::lround`` of float32 values, as float32: ``y - trunc(y)`` is
    exact, so the tie test is exact too."""
    t = torch.trunc(y)
    return t + torch.where((y - t).abs() >= 0.5, torch.sign(y), torch.zeros_like(y))


def _absmax_scale(amax: torch.Tensor, levels: float) -> torch.Tensor:
    """``amax / levels`` as a true float32 division (PyTorch's CUDA
    division by a Python number may multiply by its reciprocal), 1e-8
    where 0."""
    div = torch.full_like(amax, levels)
    return torch.where(amax > 0, amax / div, torch.full_like(amax, 1e-8))


def quantize_int8(w: torch.Tensor):
    """Per-column symmetric int8 of a (K, N) float32 weight: (q (K, N)
    int8, scales (N,) f32), the bytes of `native.quantize_int8`."""
    scales = _absmax_scale(w.abs().amax(dim=0), 127.0)
    q = torch.clamp(_round_half_away(w / scales[None, :]), -128, 127).to(torch.int8)
    return q, scales


def quantize_pack_int4(w: torch.Tensor, group_size: int = 128):
    """Per-group symmetric int4 of a (K, N) float32 weight, packed: (packed
    (K//2, N) int8 in `pack_int4`'s group halves, scales (K//g, N) f32),
    the bytes of `native.quantize_pack_int4`."""
    K, N = w.shape
    if K % group_size != 0:
        raise ValueError(f"K={K} not divisible by group_size={group_size}")
    wg = w.reshape(K // group_size, group_size, N)
    scales = _absmax_scale(wg.abs().amax(dim=1), 7.0)
    q = torch.clamp(_round_half_away(wg / scales[:, None, :]), -8, 7).to(torch.int8)
    return pack_int4(q.reshape(K, N), group_size), scales


def _quantize(w: torch.Tensor, mode: str, group_size: int) -> QuantLinear:
    """An (in, out) weight, any float dtype, to frozen storage on its device
    (`loader.py:44`)."""
    w = w.float().contiguous()
    K = w.shape[0]
    if mode == "w8a8":
        return QuantLinear(*quantize_int8(w), mode="w8a8")
    g = group_size if K % group_size == 0 else K
    packed, scales = quantize_pack_int4(w, g)
    return QuantLinear(packed, scales, mode=mode, group_size=g)


def load_llama(path: str, config: LlamaConfig, mode: str = "w4a8", group_size: int = 128,
               prefix: str = "model.", device=None) -> ServingParams:
    """Per-layer `ServingParams` from an HF-layout Llama checkpoint
    (`loader.py:58`), quantized on ``device`` (default: the GPU)."""
    if mode not in LOADER_MODES:
        raise ValueError(
            f"load_llama serves {LOADER_MODES}, not {mode!r}: the JAX loader's two-level "
            "modes build a QuantLinear without multipliers that cannot run "
            "(fastforward_tpu/serving/loader.py:44-55)"
        )
    dev = resolve_device(device)
    tensors = load_tensors(path)

    def t(name: str) -> torch.Tensor:
        key = f"{prefix}{name}" if f"{prefix}{name}" in tensors else name
        return tensors[key]

    def linear(name: str) -> QuantLinear:
        # HF (out, in) -> (in, out)
        return _quantize(t(name).to(dev).t(), mode, group_size)

    def bf16(name: str) -> torch.Tensor:
        return t(name).to(dev).to(torch.bfloat16)

    layers = []
    for i in range(config.num_layers):
        p = f"layers.{i}."
        layers.append(ServingLayer(
            q_proj=linear(p + "self_attn.q_proj.weight"),
            k_proj=linear(p + "self_attn.k_proj.weight"),
            v_proj=linear(p + "self_attn.v_proj.weight"),
            o_proj=linear(p + "self_attn.o_proj.weight"),
            gate_proj=linear(p + "mlp.gate_proj.weight"),
            up_proj=linear(p + "mlp.up_proj.weight"),
            down_proj=linear(p + "mlp.down_proj.weight"),
            input_norm=bf16(p + "input_layernorm.weight"),
            post_norm=bf16(p + "post_attention_layernorm.weight"),
        ))
    lm_head: Optional[QuantLinear] = None
    if not config.tie_embeddings and "lm_head.weight" in tensors:
        lm_head = _quantize(tensors["lm_head.weight"].to(dev).t(), mode, group_size)
    return ServingParams(
        embedding=bf16("embed_tokens.weight"),
        layers=tuple(layers),
        final_norm=bf16("norm.weight"),
        lm_head=lm_head,
    )
