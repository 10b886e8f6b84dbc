"""Flash-decode attention over the INT8 KV cache, ported from
`fastforward_tpu/kernels/attention.py`.

`flash_decode_int8_stacked` stands for both stacked JAX wrappers, the
whole-slab `flash_decode_int8_stacked` (:271) and the length-aware
`flash_decode_int8_stacked_ragged` (:635): they compute one function, and
the CUDA kernel (`csrc/flash_decode.cu`) always reads only the live blocks.
"""

import math
from typing import Optional

import torch

from fastforward_tpu_torch.kernels import _build

NEG_INF = -1e30


def flash_decode_int8_reference(q, k, k_scale, v, v_scale, lengths,
                                scale: Optional[float] = None):
    """Oracle (`attention.py:42`): q (B, H, d); k/v (B, Hkv, S, d) int8 with
    scales (B, Hkv, S); lengths (B,). Output in q's dtype."""
    B, H, d = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    groups = H // Hkv
    sm_scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kf = k.float() * k_scale[..., None]
    vf = v.float() * v_scale[..., None]
    kf = torch.repeat_interleave(kf, groups, dim=1)
    vf = torch.repeat_interleave(vf, groups, dim=1)
    scores = torch.einsum("bhd,bhsd->bhs", q.float(), kf) * sm_scale
    mask = torch.arange(S, device=q.device)[None, None, :] < lengths[:, None, None]
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    weights = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhs,bhsd->bhd", weights, vf)
    return out.to(q.dtype)


def flash_decode_int8_stacked(q, k, k_scale, v, v_scale, lengths, layer,
                              scale: Optional[float] = None):
    """Flash decode over layer ``layer`` of the stacked cache:
    q (B, H, d) bf16; k/v (L, B, Hkv, S, d) int8; scales (L, B, Hkv, S) f32;
    lengths (B,) int32. Reads ceil(len/256) blocks per sequence."""
    layer = int(layer)
    if q.device.type == "cpu":
        return flash_decode_int8_reference(
            q, k[layer], k_scale[layer], v[layer], v_scale[layer], lengths, scale,
        )
    B, H, d = q.shape
    L, _, Hkv, S, _ = k.shape
    dev = q.device
    _build.require(q, "q", torch.bfloat16, (B, H, d), dev)
    _build.require(k, "k", torch.int8, (L, B, Hkv, S, d), dev)
    _build.require(v, "v", torch.int8, (L, B, Hkv, S, d), dev)
    _build.require(k_scale, "k_scale", torch.float32, (L, B, Hkv, S), dev)
    _build.require(v_scale, "v_scale", torch.float32, (L, B, Hkv, S), dev)
    _build.require(lengths, "lengths", torch.int32, (B,), dev)
    if d != 128 or H % Hkv != 0 or H // Hkv not in (1, 2, 4, 8) or not 0 <= layer < L:
        raise ValueError(
            f"flash decode kernel needs head dim 128 and H/Hkv in (1, 2, 4, 8) "
            f"(d={d}, H={H}, Hkv={Hkv}, layer={layer})"
        )
    sm_scale = float(scale if scale is not None else 1.0 / math.sqrt(d))
    out = torch.empty((B, H, d), dtype=torch.bfloat16, device=dev)
    err = _build.lib("flash_decode").ff_flash_decode(
        q.data_ptr(), k.data_ptr(), k_scale.data_ptr(), v.data_ptr(), v_scale.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), L, B, H, Hkv, S, d, layer, sm_scale,
        _build.stream_ptr(dev),
    )
    _build.launch_counts["flash_decode"] += 1
    _build.check(err, "flash_decode")
    return out
