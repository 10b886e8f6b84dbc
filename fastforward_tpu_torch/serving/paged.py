"""Paged INT8 KV cache: pool, page table and host-side allocator, ported
from `fastforward_tpu/serving/paged.py`.

A pool of fixed-size pages shared by all sequences takes the place of the
slab's (B, max_len) rows, so device memory scales with the live token
count. The decode step appends and attends through the page table
(`kernels/paged_attention.py`); admission copies a prefilled contiguous
cache row into the slot's pages (`scatter_prefill_to_pages`).

Page 0 is the trash page: an unallocated table entry (-1) reads and
writes page 0, which the engine never hands to a sequence.
"""

import dataclasses

import numpy as np
import torch

from fastforward_tpu_torch.device import resolve_device


@dataclasses.dataclass
class PagedKVCache:
    """Pool-backed KV cache (`paged.py:23`).

    k/v: (L, P, Hkv, page, d) int8; scales (L, P, Hkv, page) f32;
    table: (B, MP) int32 page ids (-1 = unallocated). One logical page
    covers the same token span across all L layers. ``length`` is a host
    integer (a uniform-decode convenience counter).
    """

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor
    v_scale: torch.Tensor
    table: torch.Tensor
    length: int = 0

    @staticmethod
    def create(num_layers, num_pages, batch_size, max_pages_per_seq, num_kv_heads,
               head_dim, page_size=256, device=None):
        dev = resolve_device(device)
        shape = (num_layers, num_pages, num_kv_heads, page_size, head_dim)
        return PagedKVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=dev),
            v=torch.zeros(shape, dtype=torch.int8, device=dev),
            k_scale=torch.zeros(shape[:4], dtype=torch.float32, device=dev),
            v_scale=torch.zeros(shape[:4], dtype=torch.float32, device=dev),
            table=torch.full((batch_size, max_pages_per_seq), -1, dtype=torch.int32, device=dev),
        )

    @property
    def page_size(self) -> int:
        return self.k.shape[3]

    @property
    def num_pages(self) -> int:
        return self.k.shape[1]

    @property
    def max_pages_per_seq(self) -> int:
        return self.table.shape[1]

    @property
    def is_quantized(self) -> bool:
        return True

    @property
    def max_len(self) -> int:
        return self.page_size * self.max_pages_per_seq


class PageAllocator:
    """Host-side free-list allocator for one pool (`paged.py:72`). The
    device sees only the (B, MP) table the host builds; `ensure` allocates
    the pages a sequence length needs before the decode step runs."""

    def __init__(self, num_pages: int, max_pages_per_seq: int, batch_size: int):
        self.num_pages = num_pages
        self.free = list(range(num_pages))
        self.pages: list[list[int]] = [[] for _ in range(batch_size)]
        self.max_pages_per_seq = max_pages_per_seq
        self.batch_size = batch_size

    @property
    def num_free(self) -> int:
        return len(self.free)

    def ensure(self, slot: int, n_tokens: int, page_size: int) -> bool:
        """Allocate pages so ``slot`` holds ``n_tokens``; False when the pool
        or the slot's table row is exhausted. A failure returns the pages
        this call took (pages the slot held before stay) (`paged.py:92-112`)."""
        need = -(-n_tokens // page_size)
        if need > self.max_pages_per_seq:
            return False
        grown = 0
        while len(self.pages[slot]) < need:
            if not self.free:
                for _ in range(grown):
                    self.free.append(self.pages[slot].pop())
                return False
            self.pages[slot].append(self.free.pop())
            grown += 1
        return True

    def release(self, slot: int) -> None:
        self.free.extend(self.pages[slot])
        self.pages[slot] = []

    def table_array(self, device=None) -> torch.Tensor:
        """The (B, MP) int32 table, built on the host and copied to
        ``device`` (default: the GPU). Raises on a page id outside
        [-1, num_pages): the kernels read the ids unchecked."""
        t = np.full((self.batch_size, self.max_pages_per_seq), -1, np.int32)
        for b, pages in enumerate(self.pages):
            t[b, : len(pages)] = pages
        if t.size and (t.min() < -1 or t.max() >= self.num_pages):
            raise ValueError(
                f"page table holds ids outside [-1, {self.num_pages}): "
                f"{int(t.min())}..{int(t.max())}"
            )
        return torch.from_numpy(t).to(resolve_device(device))


def scatter_prefill_to_pages(cache: PagedKVCache, small_k, small_v, small_ks, small_vs,
                             row: int, slot_pages: list) -> PagedKVCache:
    """Copy row ``row`` of a prefilled contiguous cache ((L, B, Hkv, S, d)
    slab form) into the pool pages ``slot_pages`` (`paged.py:127`), in
    place; pages past the end of the row stay as they are. Returns the
    cache. Admission-time plain copies."""
    page = cache.page_size
    S = small_k.shape[3]
    for i, pid in enumerate(slot_pages):
        s0 = i * page
        if s0 >= S:
            break
        s0 = min(s0, S - page)  # dynamic_slice clamps a window that runs past the row
        cache.k[:, pid] = small_k[:, row, :, s0:s0 + page]
        cache.v[:, pid] = small_v[:, row, :, s0:s0 + page]
        cache.k_scale[:, pid] = small_ks[:, row, :, s0:s0 + page]
        cache.v_scale[:, pid] = small_vs[:, row, :, s0:s0 + page]
    return cache
