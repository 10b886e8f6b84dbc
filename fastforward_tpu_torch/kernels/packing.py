"""INT4 packing layouts, ported from `fastforward_tpu/kernels/packing.py:19-167`.

Two int4 grid values share one int8 byte. The layouts are the JAX
package's at-rest formats, byte for byte, so weights carry over unchanged:

- `pack_int4`: within every K-group of ``2*half`` rows, byte row ``i``
  holds row ``i`` (low nibble) and row ``i + half`` (high nibble);
- `pack_uint4_offset`: the same layout with offset-binary nibbles
  ``u = v + 8``;
- `pack_uint4_offset_paired`: offset-binary, pairing adjacent groups
  (byte row ``i`` of pair ``p``: rows ``2p*g + i`` and ``(2p+1)*g + i``);
- `pack_int4_vertical`: byte row ``r`` holds rows ``2r`` and ``2r + 1``,
  two's complement (the W4A4 layout);
- `pack_mult_nibbles`: two-level multipliers, 8 groups per int32.

Sign extension and wrapping are written out in int32/int64 arithmetic so
the result never depends on how a narrow integer shift overflows.
"""

import torch


def _wrap_int8(v: torch.Tensor) -> torch.Tensor:
    """Two's-complement wrap of integers in [0, 255] (or any range) to int8."""
    return ((v.to(torch.int32) + 128) % 256 - 128).to(torch.int8)


def _sext4(nib: torch.Tensor) -> torch.Tensor:
    """Sign-extend 4-bit patterns in [0, 15] to [-8, 7]."""
    return (nib ^ 8) - 8


def _check_k(K: int, group_size: int) -> None:
    if K % group_size != 0:
        raise ValueError(f"K={K} not divisible by group_size={group_size}")


def pack_int4(w: torch.Tensor, group_size: int = 128) -> torch.Tensor:
    """Pack int4 grid values (range [-8, 7]) along axis 0: (K, N) → (K//2, N) int8."""
    K, N = w.shape
    _check_k(K, group_size)
    half = group_size // 2
    w = w.to(torch.int32).reshape(K // group_size, group_size, N)
    packed = (w[:, :half] & 0xF) | ((w[:, half:] & 0xF) << 4)
    return _wrap_int8(packed.reshape(K // 2, N))


def pack_uint4_offset(w: torch.Tensor, group_size: int = 128) -> torch.Tensor:
    """`pack_int4`'s layout with offset-binary nibbles u = v + 8 ∈ [0, 15]."""
    K, N = w.shape
    _check_k(K, group_size)
    half = group_size // 2
    u = (w.to(torch.int32) + 8).reshape(K // group_size, group_size, N)
    packed = u[:, :half] | (u[:, half:] << 4)
    return _wrap_int8(packed.reshape(K // 2, N))


def pack_uint4_offset_paired(w: torch.Tensor, group_size: int = 128) -> torch.Tensor:
    """Offset-binary packing pairing adjacent groups (even group count)."""
    K, N = w.shape
    if K % (2 * group_size) != 0:
        raise ValueError(
            f"K={K} needs an even number of groups of {group_size} for paired packing"
        )
    u = (w.to(torch.int32) + 8).reshape(K // (2 * group_size), 2, group_size, N)
    packed = u[:, 0] | (u[:, 1] << 4)
    return _wrap_int8(packed.reshape(K // 2, N))


def unpack_uint4_offset_paired(packed: torch.Tensor, group_size: int = 128) -> torch.Tensor:
    """Inverse of `pack_uint4_offset_paired`: (K//2, N) → (K, N) int8."""
    K2, N = packed.shape
    p = packed.to(torch.int32).reshape(K2 // group_size, group_size, N)
    low = (p & 0xF) - 8
    high = ((p >> 4) & 0xF) - 8
    return torch.stack([low, high], dim=1).reshape(2 * K2, N).to(torch.int8)


def unpack_uint4_offset(packed: torch.Tensor, group_size: int = 128) -> torch.Tensor:
    """Inverse of `pack_uint4_offset`: (K//2, N) → (K, N) int8 in [-8, 7]."""
    K2, N = packed.shape
    half = group_size // 2
    p = packed.to(torch.int32).reshape(K2 // half, half, N)
    low = (p & 0xF) - 8
    high = ((p >> 4) & 0xF) - 8
    return torch.cat([low, high], dim=1).reshape(2 * K2, N).to(torch.int8)


def unpack_int4(packed: torch.Tensor, group_size: int = 128) -> torch.Tensor:
    """Inverse of `pack_int4`: (K//2, N) int8 → (K, N) int8 in [-8, 7]."""
    K2, N = packed.shape
    half = group_size // 2
    p = packed.to(torch.int32).reshape(K2 // half, half, N)
    low = _sext4(p & 0xF)
    high = p >> 4  # arithmetic shift of the sign-extended byte
    return torch.cat([low, high], dim=1).reshape(2 * K2, N).to(torch.int8)


def pack_mult_nibbles(mult: torch.Tensor) -> torch.Tensor:
    """Pack multipliers in [1, 15] 8-per-int32 along the group axis:
    (..., n_groups, N) → (..., ceil(n_groups/8), N) int32.

    Group g lands in nibble ``g % 8`` of word ``g // 8``; padding groups
    encode 1. A multiplier of 15 in nibble 7 sets the sign bit, so the word
    is summed in int64 and wrapped to int32 explicitly.
    """
    ng = mult.shape[-2]
    pad = (-ng) % 8
    if pad:
        ones = torch.ones(
            (*mult.shape[:-2], pad, mult.shape[-1]), dtype=mult.dtype, device=mult.device
        )
        mult = torch.cat([mult, ones], dim=-2)
    g8 = mult.reshape(*mult.shape[:-2], -1, 8, mult.shape[-1]).to(torch.int64)
    shifts = (torch.arange(8, dtype=torch.int64, device=mult.device) * 4).reshape(
        *([1] * (g8.dim() - 2)), 8, 1
    )
    words = torch.sum(g8 << shifts, dim=-2)
    return ((words + 2**31) % 2**32 - 2**31).to(torch.int32)


def unpack_mult_nibbles(packed: torch.Tensor, n_groups: int) -> torch.Tensor:
    """Inverse of `pack_mult_nibbles` (drops padding groups); int32 out."""
    words = packed[..., :, None, :].to(torch.int32)
    shifts = (torch.arange(8, dtype=torch.int32, device=packed.device) * 4).reshape(
        *([1] * (packed.dim() - 1)), 8, 1
    )
    nib = (words >> shifts) & 0xF
    out = nib.reshape(*packed.shape[:-2], -1, packed.shape[-1])
    return out[..., :n_groups, :]


def pack_int4_vertical(w: torch.Tensor) -> torch.Tensor:
    """W4A4 layout: byte row ``r`` holds row ``2r`` (low nibble) and row
    ``2r + 1`` (high nibble), two's complement. (K, N) → (K//2, N) int8."""
    K, N = w.shape
    if K % 2 != 0:
        raise ValueError(f"K={K} must be even")
    w = w.to(torch.int32).reshape(K // 2, 2, N)
    return _wrap_int8((w[:, 0] & 0xF) | ((w[:, 1] & 0xF) << 4))


def unpack_int4_vertical(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of `pack_int4_vertical`: (K//2, N) → (K, N) int8."""
    p = packed.to(torch.int32)
    lo = _sext4(p & 0xF)
    hi = p >> 4
    return torch.stack([lo, hi], dim=1).reshape(packed.shape[0] * 2, packed.shape[1]).to(
        torch.int8
    )
