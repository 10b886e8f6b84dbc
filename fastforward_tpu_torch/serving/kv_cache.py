"""Per-layer KV cache, ported from `fastforward_tpu/serving/kv_cache.py`.

`KVCache` holds one `LayerKVCache` per decoder layer: k/v (B, n_kv, S, d)
in bf16 (the default) or int8 with scales (B, n_kv, S). ``length`` is a
host integer.

The JAX cache is a pure pytree; here an append writes the layer's tensors
in place (they are the serving loop's only copy) and returns a cache that
shares them, so call sites read as in the JAX package. A one-token int8
append quantizes and writes in one `kv_quantize_append` (`csrc/kv_append.cu`
on the card); a longer block is quantized by `_quantize_kv` and written by
slice assignment; a bf16 cache takes the new rows as they are. A one-token
write outside [0, S) writes nothing, as the JAX masked select and its
kernel's oracle do. A block of T > 1 rows that would leave [0, S) raises:
JAX's ``dynamic_update_slice`` would clamp it back inside the cache and
write rows other than the positions name. A simulation-tier quantizer
given to `append` quantize-dequantizes the new K/V before that write
(`kv_cache.py:59-65`).
"""

import dataclasses
from typing import Optional, Sequence

import torch

from fastforward_tpu_torch.device import resolve_device
from fastforward_tpu_torch.kernels.kv_update import kv_quantize_append
from fastforward_tpu_torch.kernels.kv_update import quantize_kv as _quantize_kv

NEG_INF = -1e30


def write_rows(buf: torch.Tensor, new: torch.Tensor, starts, per_row: bool = False) -> None:
    """Write ``new`` (B, H, T, ...) into ``buf`` (B, H, S, ...) at rows
    ``starts[b]`` .. ``starts[b] + T - 1`` of each sequence, in place, cast
    to buf's dtype. T = 1: ``starts`` a (B,) tensor; a start outside
    [0, S) writes nothing (no host synchronization). T > 1: ``starts`` a
    list of host ints (or a tensor); raises where a block would leave
    [0, S); one slice assignment where every row starts at the same
    position, unless ``per_row`` (one assignment a sequence, as the JAX slab
    flow's per-row ``dynamic_update_slice``: the same bytes)."""
    B, S, T = buf.shape[0], buf.shape[2], new.shape[2]
    new = new.to(buf.dtype)
    if T == 1:
        valid = (starts >= 0) & (starts < S)
        rows = torch.clamp(starts, 0, S - 1).long()
        bidx = torch.arange(B, device=buf.device)
        row = new[:, :, 0]
        keep = valid.view(B, *([1] * (row.dim() - 1)))
        buf[bidx, :, rows] = torch.where(keep, row, buf[bidx, :, rows])
        return
    host = [int(s) for s in (starts.tolist() if torch.is_tensor(starts) else starts)]
    bad = [s for s in host if s < 0 or s + T > S]
    if bad:
        raise ValueError(f"a block of {T} rows from start {bad[0]} leaves the cache of {S} "
                         "rows (JAX would clamp it back inside and write other rows)")
    if not per_row and all(s == host[0] for s in host):
        buf[:, :, host[0]:host[0] + T] = new
        return
    for b, s in enumerate(host):
        buf[b, :, s:s + T] = new[b]


def row_starts(positions: torch.Tensor, B: int) -> torch.Tensor:
    """The first position of each of the B rows, int32 (B,): positions
    (T,) (every row the same) or (B, T)."""
    first = positions[0].expand(B) if positions.dim() == 1 else positions[:, 0]
    return first.to(torch.int32).contiguous()


def causal_mask(positions: torch.Tensor, S: int) -> torch.Tensor:
    """Additive f32 mask (B or 1, 1, T, S): a query at position p sees slots
    s <= p (causality and the unwritten tail of a cache at once)."""
    if positions.dim() == 1:
        positions = positions[None, :]
    s = torch.arange(S, device=positions.device)
    return torch.where(s[None, None, None, :] <= positions[:, None, :, None], 0.0, NEG_INF).float()


@dataclasses.dataclass
class LayerKVCache:
    """One layer's cache: k/v (B, n_kv, S, d); k_scale/v_scale (B, n_kv, S)
    when int8 (`kv_cache.py:34`)."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def is_quantized(self) -> bool:
        return self.k.dtype == torch.int8

    @property
    def max_len(self) -> int:
        return self.k.shape[2]

    def append(self, k_new: torch.Tensor, v_new: torch.Tensor, positions: torch.Tensor,
               quantizer=None) -> "LayerKVCache":
        """Write (B, n_kv, T, d) entries at the per-row offsets of
        ``positions`` ((T,) or (B, T) absolute positions; a row writes from
        its first), in place; returns a cache sharing the tensors. A
        simulation-tier ``quantizer`` that is no stub (``is_stub`` false;
        true or absent is a stub, as the JAX check reads it) is applied to
        k_new and v_new first, a `QuantizedTensor` result dequantized
        (`kv_cache.py:59-65`); the write below then takes that QDQ'd K/V."""
        if quantizer is not None and not getattr(quantizer, "is_stub", True):
            from fastforward_tpu_torch.quantization.quantized_array import dequantize_if_quantized

            k_new = dequantize_if_quantized(quantizer(k_new))
            v_new = dequantize_if_quantized(quantizer(v_new))
        starts = row_starts(positions, k_new.shape[0])
        return self.write(k_new, v_new, starts, starts if k_new.shape[2] == 1 else starts.tolist())

    def write(self, k_new: torch.Tensor, v_new: torch.Tensor, starts: torch.Tensor,
              rows, per_row: bool = False) -> "LayerKVCache":
        """`append` at the rows' first positions ``starts`` ((B,) int32);
        ``rows`` is ``starts`` itself for one token and the same starts as
        host ints for a block, so that a forward reads them from the device
        once and not in every layer. ``per_row``: a block is written a
        sequence at a time (`write_rows`)."""
        T = k_new.shape[2]
        if not self.is_quantized:
            write_rows(self.k, k_new, rows, per_row)
            write_rows(self.v, v_new, rows, per_row)
            return LayerKVCache(k=self.k, v=self.v)
        if T == 1:
            kv_quantize_append(self.k, self.v, self.k_scale, self.v_scale, k_new, v_new, starts)
        else:
            kq8, ks = _quantize_kv(k_new)
            vq8, vs = _quantize_kv(v_new)
            for buf, new in ((self.k, kq8), (self.v, vq8), (self.k_scale, ks),
                             (self.v_scale, vs)):
                write_rows(buf, new, rows, per_row)
        return LayerKVCache(k=self.k, v=self.v, k_scale=self.k_scale, v_scale=self.v_scale)

    def read(self, dtype=None):
        """Full-cache (B, n_kv, S, d) views, dequantized (to ``dtype``,
        default bf16) if int8."""
        if not self.is_quantized:
            return self.k, self.v
        dtype = dtype or torch.bfloat16
        k = self.k.float() * self.k_scale[..., None].float()
        v = self.v.float() * self.v_scale[..., None].float()
        return k.to(dtype), v.to(dtype)

    def attention_mask(self, positions: torch.Tensor, extra_mask=None) -> torch.Tensor:
        """Additive f32 mask (B or 1, 1, T, S): a query at position p sees
        cache slots s <= p (causality and the unwritten tail at once)."""
        mask = causal_mask(positions, self.max_len)
        if extra_mask is not None:
            mask = mask + extra_mask
        return mask


@dataclasses.dataclass
class KVCache:
    """Whole-model cache: one `LayerKVCache` per layer and the current
    length, a host integer (`kv_cache.py:152`)."""

    layers: tuple
    length: int = 0

    @staticmethod
    def create(num_layers: int, batch_size: int, max_len: int, num_kv_heads: int,
               head_dim: int, dtype=torch.bfloat16, quantized: bool = False,
               scale_dtype=torch.float32, device=None) -> "KVCache":
        """Zeroed per-layer buffers on ``device`` (default: the GPU): int8
        with ``scale_dtype`` scales when ``quantized``, else ``dtype``. The
        card's append and flash-decode kernels take f32 scales."""
        dev = resolve_device(device)
        shape = (batch_size, num_kv_heads, max_len, head_dim)
        layers = []
        for _ in range(num_layers):
            if quantized:
                layers.append(LayerKVCache(
                    k=torch.zeros(shape, dtype=torch.int8, device=dev),
                    v=torch.zeros(shape, dtype=torch.int8, device=dev),
                    k_scale=torch.zeros(shape[:3], dtype=scale_dtype, device=dev),
                    v_scale=torch.zeros(shape[:3], dtype=scale_dtype, device=dev),
                ))
            else:
                layers.append(LayerKVCache(k=torch.zeros(shape, dtype=dtype, device=dev),
                                           v=torch.zeros(shape, dtype=dtype, device=dev)))
        return KVCache(layers=tuple(layers), length=0)

    def layer(self, i: int) -> LayerKVCache:
        return self.layers[i]

    def with_layers(self, layers: Sequence[LayerKVCache], advance: int = 0) -> "KVCache":
        return KVCache(layers=tuple(layers), length=self.length + advance)

    @property
    def max_len(self) -> int:
        return self.layers[0].max_len

    @property
    def batch_size(self) -> int:
        return self.layers[0].k.shape[0]
