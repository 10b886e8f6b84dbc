"""Decode-step KV-cache append, ported from `fastforward_tpu/kernels/kv_update.py`:
the stacked append (:100) and the per-layer one (:219), both through
`csrc/kv_append.cu` (a per-layer cache is layer 0 of one). The decode step
itself calls the fused forms, `kv_quantize_append_stacked` and
`kv_quantize_append`: the token's bf16 k and v quantized by `quantize_kv`
(JAX: `serving/kv_cache.py:24`) and appended in one launch of the same
source, counted under the same names.

The JAX functions are pure and return new caches; here the append writes
the cache tensors in place (they are the serving loop's only copy) and
returns them, so call sites read the same either way.
"""

import torch

from fastforward_tpu_torch.kernels import _build


def quantize_kv(x: torch.Tensor):
    """Symmetric per-(batch, head, token) int8 quantization of (B, H, T, D)
    (`serving/kv_cache.py:24`): returns (int8 values, f32 scales (B, H, T))."""
    amax = x.float().abs().amax(dim=-1, keepdim=True)
    # XLA compiles the division by 127 inside jit to this multiply by the
    # float32 reciprocal; written out so the scales agree bit for bit.
    scale = torch.clamp(amax * (1.0 / 127.0), min=1e-8)
    q = torch.clamp(torch.round(x / scale), -128, 127).to(torch.int8)
    return q, scale.squeeze(-1)


def kv_append_decode_reference(kc, vc, ks, vs, k_new, v_new, ks_new, vs_new, starts):
    """Masked-select oracle (`kv_update.py:32`): write row ``starts[b]`` of S.

    kc/vc (B, Hkv, S, D) int8; ks/vs (B, Hkv, S) f32; k_new/v_new
    (B, Hkv, 1, D); ks_new/vs_new (B, Hkv, 1); starts (B,). Returns new
    tensors.
    """
    S = kc.shape[2]
    sel = torch.arange(S, device=kc.device)[None, :] == starts[:, None].long()
    sel4 = sel[:, None, :, None]
    sel3 = sel[:, None, :]
    return (
        torch.where(sel4, k_new.to(kc.dtype), kc),
        torch.where(sel4, v_new.to(vc.dtype), vc),
        torch.where(sel3, ks_new.to(ks.dtype), ks),
        torch.where(sel3, vs_new.to(vs.dtype), vs),
    )


def kv_append_decode_stacked_reference(kc, vc, ks, vs, k_new, v_new, ks_new, vs_new,
                                       starts, layer):
    """Oracle for the stacked append (`kv_update.py:50`): layer ``layer`` of
    (L, ...) arrays is replaced by its appended copy, in place."""
    layer = int(layer)
    upd = kv_append_decode_reference(
        kc[layer], vc[layer], ks[layer], vs[layer], k_new, v_new, ks_new, vs_new, starts,
    )
    for dst, src in zip((kc, vc, ks, vs), upd):
        dst[layer] = src
    return kc, vc, ks, vs


def _append(kc, vc, ks, vs, k_new, v_new, ks_new, vs_new, starts, layer, count):
    """Launch `csrc/kv_append.cu` on layer ``layer`` of (L, B, Hkv, S, D)
    CUDA tensors, counted under ``count``."""
    layer = int(layer)
    L, B, Hkv, S, D = kc.shape
    dev = kc.device
    _build.require(kc, "kc", torch.int8, (L, B, Hkv, S, D), dev)
    _build.require(vc, "vc", torch.int8, (L, B, Hkv, S, D), dev)
    _build.require(ks, "ks", torch.float32, (L, B, Hkv, S), dev)
    _build.require(vs, "vs", torch.float32, (L, B, Hkv, S), dev)
    _build.require(k_new, "k_new", torch.int8, (B, Hkv, 1, D), dev)
    _build.require(v_new, "v_new", torch.int8, (B, Hkv, 1, D), dev)
    _build.require(ks_new, "ks_new", torch.float32, (B, Hkv, 1), dev)
    _build.require(vs_new, "vs_new", torch.float32, (B, Hkv, 1), dev)
    _build.require(starts, "starts", torch.int32, (B,), dev)
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} outside [0, {L})")
    err = _build.lib("kv_append").ff_kv_append(
        kc.data_ptr(), vc.data_ptr(), ks.data_ptr(), vs.data_ptr(),
        k_new.data_ptr(), v_new.data_ptr(), ks_new.data_ptr(), vs_new.data_ptr(),
        starts.data_ptr(), L, B, Hkv, S, D, layer, _build.stream_ptr(dev),
    )
    _build.launch_counts[count] += 1
    _build.check(err, count)


def kv_append_decode_int8_stacked(kc, vc, ks, vs, k_new, v_new, ks_new, vs_new,
                                  starts, layer):
    """Layer-indexed in-place append into the stacked (L, B, Hkv, S, D)
    int8 cache (`kv_update.py:100`). Returns ``(kc, vc, ks, vs)``, written
    in place."""
    if kc.device.type == "cpu":
        return kv_append_decode_stacked_reference(
            kc, vc, ks, vs, k_new, v_new, ks_new, vs_new, starts, layer,
        )
    _append(kc, vc, ks, vs, k_new, v_new, ks_new, vs_new, starts, layer, "kv_append")
    return kc, vc, ks, vs


def kv_append_decode_int8(kc, vc, ks, vs, k_new, v_new, ks_new, vs_new, starts):
    """In-place append into one layer's (B, Hkv, S, D) int8 cache
    (`kv_update.py:219`): row ``starts[b]`` of each sequence takes
    ``k_new``/``v_new`` (B, Hkv, 1, D) int8 and their scales (B, Hkv, 1)
    f32; a start outside [0, S) writes nothing, as the masked-select oracle
    does. Returns ``(kc, vc, ks, vs)``, written in place. On the card the
    stacked kernel at L = 1, layer 0, counted under ``kv_append_layer``."""
    if kc.device.type == "cpu":
        kv_append_decode_stacked_reference(kc[None], vc[None], ks[None], vs[None], k_new, v_new,
                                           ks_new, vs_new, starts, 0)
    else:
        _append(kc[None], vc[None], ks[None], vs[None], k_new, v_new, ks_new, vs_new, starts, 0,
                "kv_append_layer")
    return kc, vc, ks, vs


def require_token_kv(k, v, B, Hkv, D, dev) -> None:
    """Raise unless k and v are one decode token's (B, Hkv, 1, D) CUDA
    tensors of one dtype, bf16 or f32; any strides."""
    for name, t in (("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype not in (torch.bfloat16, torch.float32) or t.dtype != k.dtype:
            raise ValueError(f"{name} must be bf16 or f32, as k is, got {t.dtype}")
        if tuple(t.shape) != (B, Hkv, 1, D):
            raise ValueError(f"{name} must have shape {(B, Hkv, 1, D)}, got {tuple(t.shape)}")
    if not 1 <= D <= 1024:
        raise ValueError(f"the fused append takes a head dim of 1-1024, got {D}")


def token_strides(t: torch.Tensor) -> tuple:
    """Element strides (b, h, d) of a (B, Hkv, 1, D) tensor, as the fused
    append's kernels read it."""
    return t.stride(0), t.stride(1), t.stride(3)


def _quantize_append(kc, vc, ks, vs, k, v, starts, layer, count):
    """Launch `csrc/kv_append.cu`'s fused entry on layer ``layer`` of
    (L, B, Hkv, S, D) CUDA tensors, counted under ``count``."""
    layer = int(layer)
    L, B, Hkv, S, D = kc.shape
    dev = kc.device
    _build.require(kc, "kc", torch.int8, (L, B, Hkv, S, D), dev)
    _build.require(vc, "vc", torch.int8, (L, B, Hkv, S, D), dev)
    _build.require(ks, "ks", torch.float32, (L, B, Hkv, S), dev)
    _build.require(vs, "vs", torch.float32, (L, B, Hkv, S), dev)
    require_token_kv(k, v, B, Hkv, D, dev)
    _build.require(starts, "starts", torch.int32, (B,), dev)
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} outside [0, {L})")
    err = _build.lib("kv_append").ff_kv_quantize_append(
        kc.data_ptr(), vc.data_ptr(), ks.data_ptr(), vs.data_ptr(), k.data_ptr(), v.data_ptr(),
        starts.data_ptr(), L, B, Hkv, S, D, layer, *token_strides(k), *token_strides(v),
        int(k.dtype == torch.bfloat16), _build.stream_ptr(dev),
    )
    _build.launch_counts[count] += 1
    _build.check(err, count)


def kv_quantize_append_stacked_reference(kc, vc, ks, vs, k, v, starts, layer):
    """Plain version of `kv_quantize_append_stacked` (any device):
    `quantize_kv` of k and v, then `kv_append_decode_stacked_reference`."""
    (kq, ksn), (vq, vsn) = quantize_kv(k), quantize_kv(v)
    return kv_append_decode_stacked_reference(kc, vc, ks, vs, kq, vq, ksn, vsn, starts, layer)


def kv_quantize_append_reference(kc, vc, ks, vs, k, v, starts):
    """Plain version of `kv_quantize_append` on one layer's cache, in place."""
    kv_quantize_append_stacked_reference(kc[None], vc[None], ks[None], vs[None], k, v, starts, 0)
    return kc, vc, ks, vs


def kv_quantize_append_stacked(kc, vc, ks, vs, k, v, starts, layer):
    """The decode step's K/V quantizer and stacked append in one: k, v
    (B, Hkv, 1, D) bf16 (or f32, any strides) quantized as `quantize_kv`
    does and written in place at row ``starts[b]`` of layer ``layer`` (none
    outside [0, S)). Returns ``(kc, vc, ks, vs)``. On the card
    `csrc/kv_append.cu` (`ff_kv_quantize_append`), bit-exact against
    `kv_quantize_append_stacked_reference`, counted under ``kv_append``."""
    if kc.device.type == "cpu":
        return kv_quantize_append_stacked_reference(kc, vc, ks, vs, k, v, starts, layer)
    _quantize_append(kc, vc, ks, vs, k, v, starts, layer, "kv_append")
    return kc, vc, ks, vs


def kv_quantize_append(kc, vc, ks, vs, k, v, starts):
    """`kv_quantize_append_stacked` on one layer's (B, Hkv, S, D) int8
    cache: the per-layer decode step's quantize and append (plain version
    `kv_quantize_append_reference`). On the card the fused entry at L = 1,
    layer 0, counted under ``kv_append_layer``."""
    if kc.device.type == "cpu":
        return kv_quantize_append_reference(kc, vc, ks, vs, k, v, starts)
    _quantize_append(kc[None], vc[None], ks[None], vs[None], k, v, starts, 0, "kv_append_layer")
    return kc, vc, ks, vs
