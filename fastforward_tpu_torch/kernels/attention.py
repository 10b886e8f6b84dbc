"""Flash attention over the INT8 KV cache, ported from
`fastforward_tpu/kernels/attention.py`.

`flash_decode_int8_stacked` stands for both stacked JAX wrappers, the
whole-slab `flash_decode_int8_stacked` (:271) and the length-aware
`flash_decode_int8_stacked_ragged` (:635): they compute one function, and
the CUDA kernel (`csrc/flash_decode.cu`) always reads only the live blocks.
`flash_decode_int8` (:721) is the same kernel over one layer's cache.
`flash_prefill` (:971) is the blocked causal prefill attention
(`csrc/flash_prefill.cu`, wgmma fed by TMA) over an int8 or a bf16 cache,
reading only the key tiles at or below each query tile's causal frontier;
`prefill_plan` mirrors its grid and tiles.
"""

import math
from typing import NamedTuple, Optional

import torch

from fastforward_tpu_torch.kernels import _build
from fastforward_tpu_torch.kernels.matmul import H100_SMS, _aligned16

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


def check_kv_alignment(k, v):
    """Raise unless the int8 K and V tensors start on 16 bytes: the flash
    decode kernel copies their rows into shared memory 16 bytes at a time."""
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("flash decode kernel needs K and V starting on 16-byte boundaries")


def _flash_decode(q, k, k_scale, v, v_scale, lengths, layer, scale, count):
    """Launch `csrc/flash_decode.cu` on layer ``layer`` of (L, B, Hkv, S, d)
    CUDA tensors, counted under ``count``."""
    layer = int(layer)
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
    check_kv_alignment(k, v)
    sm_scale = float(scale if scale is not None else 1.0 / math.sqrt(d))
    out = torch.empty((B, H, d), dtype=torch.bfloat16, device=dev)
    err = _build.lib("flash_decode").ff_flash_decode(
        q.data_ptr(), k.data_ptr(), k_scale.data_ptr(), v.data_ptr(), v_scale.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), L, B, H, Hkv, S, d, layer, sm_scale,
        _build.stream_ptr(dev),
    )
    _build.launch_counts[count] += 1
    _build.check(err, count)
    return out


def flash_decode_int8_stacked(q, k, k_scale, v, v_scale, lengths, layer,
                              scale: Optional[float] = None, count: str = "flash_decode"):
    """Flash decode over layer ``layer`` of the stacked cache:
    q (B, H, d) bf16; k/v (L, B, Hkv, S, d) int8; scales (L, B, Hkv, S) f32;
    lengths (B,) int32. Reads the live tokens only, in chunks of 64.
    Launches are counted under ``count``."""
    layer = int(layer)
    if q.device.type == "cpu":
        return flash_decode_int8_reference(
            q, k[layer], k_scale[layer], v[layer], v_scale[layer], lengths, scale,
        )
    return _flash_decode(q, k, k_scale, v, v_scale, lengths, layer, scale, count)


def flash_decode_int8(q, k, k_scale, v, v_scale, lengths, scale: Optional[float] = None):
    """Flash decode over one layer's int8 cache (`attention.py:721`): q
    (B, H, d) bf16; k/v (B, Hkv, S, d) int8; scales (B, Hkv, S) f32;
    lengths (B,) int32. The JAX TPU route's own choice (`:742`) sends fewer
    than 2 query heads per kv head, or a head dim that is no multiple of
    128, to `flash_decode_int8_reference`; so does this wrapper, by name. On
    the card otherwise the stacked kernel at L = 1, layer 0, counted under
    ``flash_decode_layer``."""
    H, d, Hkv = q.shape[1], q.shape[2], k.shape[1]
    if q.device.type == "cpu" or H // Hkv < 2 or d % 128 != 0:
        return flash_decode_int8_reference(q, k, k_scale, v, v_scale, lengths, scale)
    return _flash_decode(q, k[None], k_scale[None], v[None], v_scale[None], lengths, 0, scale,
                         "flash_decode_layer")


def flash_prefill_reference(q, k, k_scale, v, v_scale, starts, scale: Optional[float] = None):
    """Oracle (`attention.py:848`): dense causal attention with the (T, S)
    score matrix in f32. q (B, H, T, d); k/v (B, Hkv, S, d) int8 with
    scales (B, Hkv, S), or bf16 with None scales; starts (B,): query row t
    sits at position starts[b] + t and sees keys s <= starts[b] + t.
    Output in q's dtype."""
    B, H, T, d = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    groups = H // Hkv
    sm_scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kf, vf = k.float(), v.float()
    if k_scale is not None:
        kf = kf * k_scale[..., None]
    if v_scale is not None:
        vf = vf * v_scale[..., None]
    if groups > 1:
        kf = torch.repeat_interleave(kf, groups, dim=1)
        vf = torch.repeat_interleave(vf, groups, dim=1)
    scores = torch.einsum("bhtd,bhsd->bhts", q.float(), kf) * sm_scale
    pos = starts[:, None].long() + torch.arange(T, device=q.device)[None, :]
    valid = torch.arange(S, device=q.device)[None, None, None, :] <= pos[:, None, :, None]
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    weights = torch.softmax(scores, dim=-1)
    return torch.einsum("bhts,bhsd->bhtd", weights, vf).to(q.dtype)


# The prefill kernel's tiles (csrc/flash_prefill.cu): a work item is 128
# query rows (the G heads x 128 / G positions of a position tile), two
# consumer warpgroups of 64; keys in tiles of 64; one persistent block an
# SM (`H100_SMS`; the kernel asks the card).
PREFILL_ROWS, PREFILL_WG_ROWS, PREFILL_KEYS = 128, 64, 64


class PrefillPlan(NamedTuple):
    """The grid of the flash prefill kernel for (B, H, Hkv, T, S): ``P``
    positions a work item, ``pw`` positions and ``gw`` heads a warpgroup,
    ``n_pt`` position tiles, ``items`` work items and ``grid`` persistent
    blocks (block z takes items z, z + grid, ...)."""
    B: int
    Hkv: int
    G: int
    T: int
    S: int
    P: int
    pw: int
    gw: int
    n_pt: int
    items: int
    grid: int

    def item(self, i: int):
        """(b, kv head, position tile) of item ``i``: (b, h) in order, the
        position tiles in snake order (reversed for odd (b, h))."""
        bh, pt = divmod(i, self.n_pt)
        if bh % 2:
            pt = self.n_pt - 1 - pt
        return bh // self.Hkv, bh % self.Hkv, pt

    def block_items(self, z: int):
        return list(range(z, self.items, self.grid))

    def key_tiles(self, start: int, last: int) -> int:
        """Key tiles up to the frontier ``start + last``, within S."""
        return min(-(-self.S // PREFILL_KEYS), (start + last) // PREFILL_KEYS + 1)

    def item_tiles(self, i: int, start: int) -> int:
        """The key tiles the producer streams for item ``i`` (its last
        position's frontier)."""
        pt = self.item(i)[2]
        return self.key_tiles(start, min((pt + 1) * self.P, self.T) - 1)

    def wg_rows(self, i: int, wg: int):
        """[(head, position)] of warpgroup ``wg``'s 64 rows of item ``i`` in
        row order (head-major; positions past T included: they read zeros
        and are not stored)."""
        b, h, pt = self.item(i)
        p_off = PREFILL_WG_ROWS * wg if self.P > PREFILL_WG_ROWS else 0
        h_off = 0 if self.P > PREFILL_WG_ROWS else wg * self.gw
        return [(h * self.G + h_off + r // self.pw, pt * self.P + p_off + r % self.pw)
                for r in range(PREFILL_WG_ROWS)]

    def wg_tiles(self, i: int, wg: int, start: int):
        """(tiles warpgroup ``wg`` computes, tiles it leaves unmasked) of
        item ``i``: none where its first position is past T."""
        t0 = self.wg_rows(i, wg)[0][1]
        if t0 >= self.T:
            return 0, 0
        n = self.key_tiles(start, min(t0 + self.pw, self.T) - 1)
        return n, min((start + t0 + 1) // PREFILL_KEYS, self.S // PREFILL_KEYS)


def prefill_plan(B: int, H: int, Hkv: int, T: int, S: int, sms: int = H100_SMS) -> PrefillPlan:
    """The flash prefill kernel's work items and grid (C ``launch``)."""
    if H % Hkv or H // Hkv not in (1, 2, 4, 8) or min(B, T, S) < 1:
        raise ValueError(f"no flash prefill plan for H={H}, Hkv={Hkv}, T={T}, S={S}")
    G = H // Hkv
    P = PREFILL_ROWS // G
    pw = min(P, PREFILL_WG_ROWS)
    n_pt = -(-T // P)
    items = B * Hkv * n_pt
    return PrefillPlan(B, Hkv, G, T, S, P, pw, PREFILL_WG_ROWS // pw, n_pt, items,
                       min(items, sms))


def flash_prefill(q, k, k_scale, v, v_scale, starts, scale: Optional[float] = None):
    """Blocked causal prefill attention (`attention.py:971`) over one
    layer's cache: q (B, H, T, 128) bf16; k/v (B, Hkv, S, 128) int8 with
    f32 scales (B, Hkv, S), or bf16 with None scales (counted under
    ``flash_prefill_bf16``); starts (B,) int32; H / Hkv in (1, 2, 4, 8).
    On CUDA `csrc/flash_prefill.cu` (wgmma; grid and tiles as
    `prefill_plan`). Within 8e-3 of the largest output of
    `flash_prefill_reference`."""
    if q.device.type == "cpu":
        return flash_prefill_reference(q, k, k_scale, v, v_scale, starts, scale)
    B, H, T, d = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    dev = q.device
    bf16_kv = k.dtype == torch.bfloat16
    if bf16_kv != (k_scale is None) or bf16_kv != (v_scale is None):
        raise ValueError("flash prefill kernel takes int8 K/V with f32 scales or bf16 K/V "
                         f"without (k {k.dtype}, scales {k_scale is not None})")
    kv_dtype = torch.bfloat16 if bf16_kv else torch.int8
    _build.require(q, "q", torch.bfloat16, (B, H, T, d), dev)
    _build.require(k, "k", kv_dtype, (B, Hkv, S, d), dev)
    _build.require(v, "v", kv_dtype, (B, Hkv, S, d), dev)
    if not bf16_kv:
        _build.require(k_scale, "k_scale", torch.float32, (B, Hkv, S), dev)
        _build.require(v_scale, "v_scale", torch.float32, (B, Hkv, S), dev)
    _build.require(starts, "starts", torch.int32, (B,), dev)
    if d != 128 or H % Hkv != 0 or H // Hkv not in (1, 2, 4, 8) or T < 1 or S < 1:
        raise ValueError(
            f"flash prefill kernel needs head dim 128, H/Hkv in (1, 2, 4, 8) and T, S >= 1 "
            f"(d={d}, H={H}, Hkv={Hkv}, T={T}, S={S})"
        )
    sm_scale = float(scale if scale is not None else 1.0 / math.sqrt(d))
    # the kernel reaches q, k, v and out through TMA tensor maps
    q, k, v = _aligned16(q), _aligned16(k), _aligned16(v)
    out = torch.empty_like(q)
    lib = _build.lib("flash_prefill")
    if bf16_kv:
        err = lib.ff_flash_prefill_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), starts.data_ptr(), out.data_ptr(),
            B, H, Hkv, T, S, d, sm_scale, _build.stream_ptr(dev),
        )
        name = "flash_prefill_bf16"
    else:
        err = lib.ff_flash_prefill(
            q.data_ptr(), k.data_ptr(), k_scale.data_ptr(), v.data_ptr(), v_scale.data_ptr(),
            starts.data_ptr(), out.data_ptr(), B, H, Hkv, T, S, d, sm_scale,
            _build.stream_ptr(dev),
        )
        name = "flash_prefill"
    _build.launch_counts[name] += 1
    _build.check(err, name)
    return out
