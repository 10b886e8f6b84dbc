"""Decode attention and KV append through a page table, ported from
`fastforward_tpu/kernels/paged_attention.py`.

Pool layout: k/v (L, P, Hkv, page, d) int8, scales (L, P, Hkv, page) f32;
table (B, MP) int32, -1 for unallocated. A logical page covers the same
token span in all L layers.

`paged_flash_decode_int8` runs `csrc/flash_decode.cu`'s kernel with token
t of sequence b read from page ``table[b, t // page]``; `paged_kv_append_decode_int8`
runs `csrc/kv_append.cu`'s append with the page lookup. On a CPU tensor
each runs its plain version. A page id of -1 addresses page 0, the trash
page, as the JAX wrappers' ``max(table, 0)`` makes it (the JAX append
reference on the raw table wraps -1 to page P - 1: ROADMAP.md Queue 3). A
page index ``pos // page`` at or beyond MP addresses page 0 as in the JAX
reference, where the TPU append kernel reads the next sequence's table
entry. Page ids must lie in [-1, P): `PageAllocator.table_array` checks
that on the host.
"""

import math
from typing import Optional

import torch

from fastforward_tpu_torch.kernels import _build
from fastforward_tpu_torch.kernels.kv_update import quantize_kv, require_token_kv, token_strides
from fastforward_tpu_torch.kernels.attention import (
    check_kv_alignment,
    flash_decode_int8_reference,
)


def gather_pages(pool: torch.Tensor, table_row: torch.Tensor) -> torch.Tensor:
    """(P, Hkv, page, ...) pool + (MP,) table row → contiguous
    (Hkv, MP*page, ...) (`paged_attention.py:37`); -1 reads page 0."""
    pages = pool[torch.clamp(table_row.long(), min=0)]   # (MP, Hkv, page, ...)
    pages = pages.movedim(1, 0)                           # (Hkv, MP, page, ...)
    return pages.reshape(pages.shape[0], -1, *pages.shape[3:])


def paged_flash_decode_reference(q, k_pool_l, ks_pool_l, v_pool_l, vs_pool_l, table, lengths,
                                 scale: Optional[float] = None):
    """Oracle (`paged_attention.py:44`): gather each sequence's pages into a
    contiguous view, then the dense flash-decode reference. Pools are one
    layer's: (P, Hkv, page, d) and (P, Hkv, page)."""
    def gather(pool):
        return torch.stack([gather_pages(pool, t) for t in table])
    return flash_decode_int8_reference(
        q, gather(k_pool_l), gather(ks_pool_l), gather(v_pool_l), gather(vs_pool_l), lengths,
        scale,
    )


def paged_flash_decode_int8(q, k_pool, k_scale, v_pool, v_scale, table, lengths, layer,
                            scale: Optional[float] = None):
    """Length-aware decode attention through the page table
    (`paged_attention.py:156`): q (B, H, 128) bf16; pools of layer
    ``layer``; lengths (B,) int32. Reads min(len, MP * page) tokens per
    sequence, each from its page; the reference attends over all MP pages,
    masked by length, which is the same function. Within 8e-3 of the largest output of
    `paged_flash_decode_reference`; on the card the same summation order
    as `flash_decode_int8_stacked` over the same tokens."""
    layer = int(layer)
    if q.device.type == "cpu":
        return paged_flash_decode_reference(
            q, k_pool[layer], k_scale[layer], v_pool[layer], v_scale[layer], table, lengths,
            scale,
        )
    B, H, d = q.shape
    L, P, Hkv, page, _ = k_pool.shape
    MP = table.shape[1]
    dev = q.device
    _build.require(q, "q", torch.bfloat16, (B, H, d), dev)
    _build.require(k_pool, "k_pool", torch.int8, (L, P, Hkv, page, d), dev)
    _build.require(v_pool, "v_pool", torch.int8, (L, P, Hkv, page, d), dev)
    _build.require(k_scale, "k_scale", torch.float32, (L, P, Hkv, page), dev)
    _build.require(v_scale, "v_scale", torch.float32, (L, P, Hkv, page), dev)
    _build.require(table, "table", torch.int32, (B, MP), dev)
    _build.require(lengths, "lengths", torch.int32, (B,), dev)
    if d != 128 or H % Hkv != 0 or H // Hkv not in (1, 2, 4, 8) or page % 4 != 0 \
            or not 0 <= layer < L:
        raise ValueError(
            f"paged flash decode kernel needs head dim 128, H/Hkv in (1, 2, 4, 8) and a page "
            f"of a multiple of 4 tokens (d={d}, H={H}, Hkv={Hkv}, page={page}, layer={layer})"
        )
    check_kv_alignment(k_pool, v_pool)
    sm_scale = float(scale if scale is not None else 1.0 / math.sqrt(d))
    out = torch.empty((B, H, d), dtype=torch.bfloat16, device=dev)
    err = _build.lib("flash_decode").ff_paged_flash_decode(
        q.data_ptr(), k_pool.data_ptr(), k_scale.data_ptr(), v_pool.data_ptr(),
        v_scale.data_ptr(), table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        L, P, B, H, Hkv, page, MP, d, layer, sm_scale, _build.stream_ptr(dev),
    )
    _build.launch_counts["paged_flash_decode"] += 1
    _build.check(err, "paged_flash_decode")
    return out


def paged_page_ids(positions: torch.Tensor, table: torch.Tensor, page: int) -> torch.Tensor:
    """Physical page of each sequence's row ``positions[b]``:
    ``table[b, pos // page]`` (`paged_attention.py:240-241`), with -1 (the
    wrappers' ``max(table, 0)``) and a page index at or beyond MP (the
    reference's clamp of ``dynamic_update_slice``) both giving page 0."""
    MP = table.shape[1]
    idx = positions.long() // page
    inside = (idx >= 0) & (idx < MP)
    ids = torch.gather(table.long(), 1, torch.clamp(idx, 0, MP - 1)[:, None])[:, 0]
    return torch.where(inside, torch.clamp(ids, min=0), torch.zeros_like(ids))


def paged_kv_append_reference(k_pool, v_pool, ks_pool, vs_pool, k_new, v_new, ks_new, vs_new,
                              positions, table, layer):
    """Oracle (`paged_attention.py:229`, on the table the JAX wrapper
    passes): write row ``positions[b]`` of each sequence into its page of
    layer ``layer`` (`paged_page_ids`), in place; returns the pools.
    k_new/v_new (B, Hkv, 1, d); ks_new/vs_new (B, Hkv, 1). Rows land in
    batch order, so of two sequences that share a page row the later wins,
    as in the reference's loop."""
    layer = int(layer)
    page = k_pool.shape[3]
    pids = paged_page_ids(positions, table, page).tolist()
    offs = (positions.long() % page).tolist()
    for b, (pid, off) in enumerate(zip(pids, offs)):
        pid = min(pid, k_pool.shape[1] - 1)
        k_pool[layer, pid, :, off] = k_new[b, :, 0].to(k_pool.dtype)
        v_pool[layer, pid, :, off] = v_new[b, :, 0].to(v_pool.dtype)
        ks_pool[layer, pid, :, off] = ks_new[b, :, 0].to(ks_pool.dtype)
        vs_pool[layer, pid, :, off] = vs_new[b, :, 0].to(vs_pool.dtype)
    return k_pool, v_pool, ks_pool, vs_pool


def paged_kv_append_decode_int8(k_pool, v_pool, ks_pool, vs_pool, k_new, v_new, ks_new, vs_new,
                                positions, table, layer):
    """In-place decode append into the paged pool (`paged_attention.py:293`):
    one int8 row and one f32 scale per (sequence, kv head) at page
    ``table[b, pos // page]``, row ``pos % page`` of layer ``layer``.
    Returns the pools, written in place. Bit-exact: a copy."""
    if k_pool.device.type == "cpu":
        return paged_kv_append_reference(k_pool, v_pool, ks_pool, vs_pool, k_new, v_new,
                                         ks_new, vs_new, positions, table, layer)
    layer = int(layer)
    L, P, Hkv, page, D = k_pool.shape
    B, MP = table.shape
    dev = k_pool.device
    _build.require(k_pool, "k_pool", torch.int8, (L, P, Hkv, page, D), dev)
    _build.require(v_pool, "v_pool", torch.int8, (L, P, Hkv, page, D), dev)
    _build.require(ks_pool, "ks_pool", torch.float32, (L, P, Hkv, page), dev)
    _build.require(vs_pool, "vs_pool", torch.float32, (L, P, Hkv, page), dev)
    _build.require(k_new, "k_new", torch.int8, (B, Hkv, 1, D), dev)
    _build.require(v_new, "v_new", torch.int8, (B, Hkv, 1, D), dev)
    _build.require(ks_new, "ks_new", torch.float32, (B, Hkv, 1), dev)
    _build.require(vs_new, "vs_new", torch.float32, (B, Hkv, 1), dev)
    _build.require(positions, "positions", torch.int32, (B,), dev)
    _build.require(table, "table", torch.int32, (B, MP), dev)
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} outside [0, {L})")
    err = _build.lib("kv_append").ff_paged_kv_append(
        k_pool.data_ptr(), v_pool.data_ptr(), ks_pool.data_ptr(), vs_pool.data_ptr(),
        k_new.data_ptr(), v_new.data_ptr(), ks_new.data_ptr(), vs_new.data_ptr(),
        positions.data_ptr(), table.data_ptr(), L, P, B, Hkv, page, MP, D, layer,
        _build.stream_ptr(dev),
    )
    _build.launch_counts["paged_kv_append"] += 1
    _build.check(err, "paged_kv_append")
    return k_pool, v_pool, ks_pool, vs_pool


def paged_kv_quantize_append_reference(k_pool, v_pool, ks_pool, vs_pool, k, v, positions, table,
                                       layer):
    """Plain version of `paged_kv_quantize_append` (any device):
    `quantize_kv` of k and v, then `paged_kv_append_reference`."""
    (kq, ksn), (vq, vsn) = quantize_kv(k), quantize_kv(v)
    return paged_kv_append_reference(k_pool, v_pool, ks_pool, vs_pool, kq, vq, ksn, vsn,
                                     positions, table, layer)


def paged_kv_quantize_append(k_pool, v_pool, ks_pool, vs_pool, k, v, positions, table, layer):
    """The decode step's K/V quantizer and paged append in one: k, v
    (B, Hkv, 1, d) bf16 (or f32, any strides) quantized as `quantize_kv`
    does and written in place at row ``pos % page`` of page ``table[b, pos
    // page]`` of layer ``layer`` (page 0 for a page id of -1 or an index at
    or beyond MP). Returns the pools. On the card `csrc/kv_append.cu`
    (`ff_paged_kv_quantize_append`), bit-exact against
    `paged_kv_quantize_append_reference`, counted under ``paged_kv_append``."""
    if k_pool.device.type == "cpu":
        return paged_kv_quantize_append_reference(k_pool, v_pool, ks_pool, vs_pool, k, v,
                                                  positions, table, layer)
    layer = int(layer)
    L, P, Hkv, page, D = k_pool.shape
    B, MP = table.shape
    dev = k_pool.device
    _build.require(k_pool, "k_pool", torch.int8, (L, P, Hkv, page, D), dev)
    _build.require(v_pool, "v_pool", torch.int8, (L, P, Hkv, page, D), dev)
    _build.require(ks_pool, "ks_pool", torch.float32, (L, P, Hkv, page), dev)
    _build.require(vs_pool, "vs_pool", torch.float32, (L, P, Hkv, page), dev)
    require_token_kv(k, v, B, Hkv, D, dev)
    _build.require(positions, "positions", torch.int32, (B,), dev)
    _build.require(table, "table", torch.int32, (B, MP), dev)
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} outside [0, {L})")
    err = _build.lib("kv_append").ff_paged_kv_quantize_append(
        k_pool.data_ptr(), v_pool.data_ptr(), ks_pool.data_ptr(), vs_pool.data_ptr(),
        k.data_ptr(), v.data_ptr(), positions.data_ptr(), table.data_ptr(), L, P, B, Hkv, page,
        MP, D, layer, *token_strides(k), *token_strides(v), int(k.dtype == torch.bfloat16),
        _build.stream_ptr(dev),
    )
    _build.launch_counts["paged_kv_append"] += 1
    _build.check(err, "paged_kv_append")
    return k_pool, v_pool, ks_pool, vs_pool
