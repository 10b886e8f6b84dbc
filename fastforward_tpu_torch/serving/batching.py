"""Continuous batching engine, ported from `fastforward_tpu/serving/batching.py`.

A host-side scheduler multiplexes many generation requests onto one
fixed-shape decode step:

  - the decode step always runs the full (max_batch) slot array with
    per-slot positions; finished or empty slots decode tokens the host
    ignores;
  - sampling config is per-request data ((B,) temperature / top-k / top-p
    tensors through `sample_logits_per_row`);
  - admission is batched and length-bucketed: pending requests are grouped,
    prompts padded to a power-of-two bucket and prefilled together, then
    their KV rows are copied into free slots of the shared cache (the slab
    rows, or the slot's pages of a paged pool);
  - per-slot state (position, budget, generated tokens) lives on the host;
    device state is the KV cache.

The JAX engine's jitted closures (`batching.py:204-359`) are plain methods
here that update the cache in place. ``decode_seconds`` and
``prefill_seconds`` are host wall time up to the token read-back, which
synchronises, as the JAX engine measures them.
"""

import dataclasses
import itertools
import time
from typing import Any, Optional

import numpy as np
import torch

from fastforward_tpu_torch.device import resolve_device
from fastforward_tpu_torch.models.llama import LlamaConfig
from fastforward_tpu_torch.serving.paged import (
    PageAllocator,
    PagedKVCache,
    scatter_prefill_to_pages,
)
from fastforward_tpu_torch.serving.sampling import SamplingParams, sample_logits_per_row
from fastforward_tpu_torch.serving.stacked import StackedKVCache, serving_forward_stacked


@dataclasses.dataclass
class EngineStats:
    """Scheduling counters (`batching.py:44`). Occupancy is the fraction of
    decode slot-steps that computed a live request's token:
    ``useful_tokens / (max_batch * decode_steps)``."""

    decode_steps: int = 0          # device decode steps executed (all slots)
    decode_calls: int = 0          # burst/step launches
    useful_tokens: int = 0         # tokens delivered to live requests
    overrun_tokens: int = 0        # decoded for finished slots, discarded
    prefills: int = 0              # prefill forwards (incl. chunks)
    prefill_tokens: int = 0        # prompt tokens prefilled (bucket-padded)
    prefill_chunks: int = 0        # chunked-prefill chunk forwards
    admitted: int = 0              # requests admitted into slots
    preempt_truncated: int = 0     # overflow -> finished early
    preempt_requeued: int = 0      # overflow/pool-dry -> requeued
    pool_dry_requeues: int = 0     # paged admissions bounced on a dry pool
    decode_seconds: float = 0.0    # wall inside decode calls
    prefill_seconds: float = 0.0   # wall inside prefill calls

    _slot_steps: int = 0           # max_batch * decode_steps accumulator

    @property
    def occupancy(self) -> float:
        return self.useful_tokens / max(1, self._slot_steps)

    @property
    def device_seconds(self) -> float:
        return self.decode_seconds + self.prefill_seconds


@dataclasses.dataclass
class Request:
    request_id: int
    prompt: list
    max_new_tokens: int
    eos_token: Optional[int] = None
    sampling: Optional[SamplingParams] = None
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False
    # Set when the slot's KV row filled before max_new_tokens was reached
    # and the engine's overflow policy is "truncate".
    truncated: bool = False


def _bucket(n: int, floor: int = 16) -> int:
    b = floor
    while b < n:
        b *= 2
    return b


class ContinuousBatchingEngine:
    # Admission-transient KV budget: the bucketed group prefill allocates an
    # (nb, small_len) slab transient; the group is capped so that transient
    # stays within it. Groups beyond the cap admit on a later call.
    _ADMIT_KV_BUDGET = 1 << 30

    def __init__(
        self,
        config: LlamaConfig,
        params: Any,
        stacked_layers: Any,
        *,
        max_batch: int = 8,
        max_len: int = 1024,
        sampling: Optional[SamplingParams] = None,
        seed: int = 0,
        prefill_chunk: int = 256,
        decode_between_chunks: int = 4,
        cache_overflow: str = "truncate",
        paged: bool = False,
        page_size: int = 256,
        num_pages: Optional[int] = None,
        device=None,
    ):
        """``prefill_chunk``: prompts longer than this are prefilled in
        chunks, with ``decode_between_chunks`` decode steps for the active
        slots between chunks. ``cache_overflow``: "truncate" finishes a
        request whose KV row would overflow ``max_len`` (marked
        ``truncated``); "requeue" re-submits prompt + generated as a fresh
        request. ``paged``: a pool of ``num_pages`` pages of ``page_size``
        tokens (page 0 reserved) instead of the (max_batch, max_len) slab.
        ``device=None`` means the GPU; the weights must lie there too."""
        if cache_overflow not in ("truncate", "requeue"):
            raise ValueError(f"unknown cache_overflow policy {cache_overflow}")
        self.device = resolve_device(device)
        self.config = config
        self.params = params
        self.stacked = stacked_layers
        self.max_batch = max_batch
        self.max_len = max_len
        self.prefill_chunk = prefill_chunk
        self.decode_between_chunks = decode_between_chunks
        self.cache_overflow = cache_overflow
        # engine-wide default; per-request `Request.sampling` overrides
        self.sampling = sampling or SamplingParams(temperature=0.0)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)

        self.paged = paged
        self._alloc = None
        if paged:
            if max_len % page_size != 0:
                raise ValueError(
                    f"max_len {max_len} must be a multiple of page_size {page_size} for the "
                    f"paged cache"
                )
            mp = max_len // page_size
            if num_pages is None:
                num_pages = max_batch * mp + 1  # full coverage; pass less to cap pool memory
            self.cache = PagedKVCache.create(
                num_layers=config.num_layers, num_pages=num_pages, batch_size=max_batch,
                max_pages_per_seq=mp, num_kv_heads=config.num_kv_heads,
                head_dim=config.head_dim, page_size=page_size, device=self.device,
            )
            self._alloc = PageAllocator(num_pages, mp, max_batch)
            # Page 0 is the trash page: unallocated table entries (-1) and
            # retired slots that keep decoding address it.
            self._alloc.free.remove(0)
        else:
            self.cache = StackedKVCache.create(
                num_layers=config.num_layers, batch_size=max_batch, max_len=max_len,
                num_kv_heads=config.num_kv_heads, head_dim=config.head_dim,
                device=self.device,
            )

        # Host-side slot state.
        self.slot_request: list = [None] * max_batch
        self.slot_pos = np.zeros((max_batch,), np.int32)
        self.slot_token = np.zeros((max_batch,), np.int32)
        self.slot_temp = np.zeros((max_batch,), np.float32)
        self.slot_topk = np.zeros((max_batch,), np.int32)
        self.slot_topp = np.ones((max_batch,), np.float32)
        self._ids = itertools.count()
        self._pending: list = []
        self._done: dict = {}
        self.stats = EngineStats()

    # -- device calls (the JAX engine's jitted closures) -------------------

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _sampling_tensors(self, temps, top_ks, top_ps):
        return self._dev(temps), self._dev(top_ks), self._dev(top_ps)

    def _decode_step(self, tokens, positions, temps, top_ks, top_ps):
        """One decode step: logits, then per-row sampling (`batching.py:204`)."""
        logits, self.cache = serving_forward_stacked(
            self.params, self.stacked, self.config, tokens, cache=self.cache, positions=positions,
        )
        return sample_logits_per_row(logits[:, -1], temps, top_ks, top_ps, self._gen)

    def _decode_burst_greedy(self, n_steps, tokens, positions):
        """All-greedy burst through the fused GEMV + argmax head
        (`batching.py:217`); returns (n_steps, B) int32 on the device."""
        toks = []
        for _ in range(n_steps):
            tok, self.cache = serving_forward_stacked(
                self.params, self.stacked, self.config, tokens, cache=self.cache,
                positions=positions, greedy_head=True,
            )
            toks.append(tok)
            tokens, positions = tok.long()[:, None], positions + 1
        return torch.stack(toks)

    def _decode_burst(self, tokens, positions, temps, top_ks, top_ps, n_steps):
        """``n_steps`` sampled decode steps (`batching.py:244`)."""
        toks = []
        for _ in range(n_steps):
            tok = self._decode_step(tokens, positions, temps, top_ks, top_ps)
            toks.append(tok)
            tokens, positions = tok.long()[:, None], positions + 1
        return torch.stack(toks)

    def _prefill_batch(self, small, ids, lengths, temps, top_ks, top_ps):
        """Bucketed batch prefill (`batching.py:270`): ids (nb, T_bucket)
        zero-padded; each row's first token from the logits at length - 1."""
        logits, _ = serving_forward_stacked(
            self.params, self.stacked, self.config, ids, cache=small,
            logits_positions=lengths - 1,
        )
        return sample_logits_per_row(logits[:, 0], temps, top_ks, top_ps, self._gen)

    def _prefill_chunk(self, small, ids_chunk, offset, sel_pos, temps, top_ks, top_ps):
        """One chunk of a chunked prefill (`batching.py:286`): appends KV at
        ``offset`` and samples a candidate next token at per-row ``sel_pos``."""
        C = ids_chunk.shape[1]
        logits, _ = serving_forward_stacked(
            self.params, self.stacked, self.config, ids_chunk, cache=small,
            positions=torch.arange(C, device=self.device) + offset, logits_positions=sel_pos,
        )
        return sample_logits_per_row(logits[:, 0], temps, top_ks, top_ps, self._gen)

    def _scatter_rows(self, small: StackedKVCache, n_rows: int, slots: list) -> None:
        """Copy rows 0..n_rows-1 of the admission cache into the slab rows
        ``slots``: the bucket prefix along S (`batching.py:327`)."""
        idx = torch.as_tensor(slots, dtype=torch.long, device=self.device)
        s_len = small.k.shape[3]
        for big, part in ((self.cache.k, small.k), (self.cache.v, small.v),
                          (self.cache.k_scale, small.k_scale),
                          (self.cache.v_scale, small.v_scale)):
            big[:, idx, :, :s_len] = part[:, :n_rows]

    # -- public API ---------------------------------------------------------

    def submit(self, prompt: list, max_new_tokens: int = 32, eos_token: Optional[int] = None,
               sampling: Optional[SamplingParams] = None) -> int:
        if len(prompt) >= self.max_len:
            raise ValueError(
                f"prompt length {len(prompt)} >= engine max_len {self.max_len}; raise max_len "
                f"or truncate the prompt"
            )
        if self.paged:
            # a prompt that can never fit the pool would stall admission forever
            page = self.cache.page_size
            need = -(-(len(prompt) + 1) // page)
            pool = self.cache.num_pages - 1  # page 0 is the trash page
            if need > pool:
                raise ValueError(
                    f"prompt needs {need} pages but the pool only has {pool} allocatable "
                    f"pages; raise num_pages"
                )
        request = Request(next(self._ids), list(prompt), max_new_tokens, eos_token, sampling)
        self._pending.append(request)
        return request.request_id

    @property
    def num_active(self) -> int:
        return sum(r is not None for r in self.slot_request)

    def _retire(self, slot: int, request: Request) -> None:
        request.done = True
        self._done[request.request_id] = request
        self.slot_request[slot] = None
        if self.paged:
            self._alloc.release(slot)

    def step(self) -> None:
        """Admit pending requests into free slots, then one decode step."""
        self._admit()
        self._preempt_overflowing(1)
        if self.num_active == 0:
            return
        t0 = time.perf_counter()
        next_tokens = self._decode_step(
            self._dev(self.slot_token[:, None]).long(), self._dev(self.slot_pos[:, None]),
            *self._sampling_tensors(self.slot_temp, self.slot_topk, self.slot_topp),
        ).cpu().numpy()
        self.stats.decode_seconds += time.perf_counter() - t0
        self.stats.decode_calls += 1
        self.stats.decode_steps += 1
        self.stats._slot_steps += self.max_batch
        self.stats.overrun_tokens += self.max_batch - self.num_active

        for slot, request in enumerate(self.slot_request):
            if request is None:
                continue
            token = int(next_tokens[slot])
            request.generated.append(token)
            self.stats.useful_tokens += 1
            self.slot_pos[slot] += 1
            self.slot_token[slot] = token
            if (len(request.generated) >= request.max_new_tokens
                    or (request.eos_token is not None and token == request.eos_token)):
                self._retire(slot, request)

    def step_burst(self, n: int) -> None:
        """Admit, then run ``n`` decode steps back to back with one token
        read-back. Slots whose request finishes mid-burst keep decoding;
        the host discards the overrun tokens."""
        self._admit()
        self._run_burst(n)

    def _run_burst(self, n: int) -> None:
        """``n`` decode steps for the active slots (no admission; also
        keeps decode moving between prefill chunks)."""
        self._preempt_overflowing(n)
        if self.num_active == 0:
            return
        all_greedy = all(self.slot_temp[slot] == 0.0
                         for slot, r in enumerate(self.slot_request) if r is not None)
        tokens = self._dev(self.slot_token[:, None]).long()
        positions = self._dev(self.slot_pos[:, None])
        t0 = time.perf_counter()
        if all_greedy:
            toks = self._decode_burst_greedy(n, tokens, positions)
        else:
            toks = self._decode_burst(
                tokens, positions,
                *self._sampling_tensors(self.slot_temp, self.slot_topk, self.slot_topp), n,
            )
        toks = toks.cpu().numpy()  # (n, B)
        self.stats.decode_seconds += time.perf_counter() - t0
        self.stats.decode_calls += 1
        self.stats.decode_steps += n
        self.stats._slot_steps += self.max_batch * n
        useful_before = self.stats.useful_tokens
        for slot, request in enumerate(self.slot_request):
            if request is None:
                continue
            for i in range(toks.shape[0]):
                token = int(toks[i, slot])
                request.generated.append(token)
                self.stats.useful_tokens += 1
                self.slot_pos[slot] += 1
                self.slot_token[slot] = token
                if (len(request.generated) >= request.max_new_tokens
                        or (request.eos_token is not None and token == request.eos_token)):
                    # the device already finished the burst's appends into
                    # this slot's pages; its position follows the device
                    self._retire(slot, request)
                    self.slot_pos[slot] += toks.shape[0] - 1 - i
                    break
        self.stats.overrun_tokens += n * self.max_batch - (self.stats.useful_tokens - useful_before)

    def run_until_complete(self, max_steps: int = 100_000, burst: int = 1) -> dict:
        steps = 0
        while (self._pending or self.num_active) and steps < max_steps:
            if self.num_active == 0 and self._pending:
                # nothing active can retire and release resources, so a
                # failed admission here would never unstick itself
                self._admit()
                if self.num_active == 0:
                    raise RuntimeError(
                        f"{len(self._pending)} pending request(s) cannot be admitted and no "
                        f"slot is active — the engine cannot make progress (pool too small "
                        f"for the request?)"
                    )
            if burst > 1:
                self.step_burst(burst)
            else:
                self.step()
            steps += 1
        return {rid: r.generated for rid, r in self._done.items()}

    # -- internals ----------------------------------------------------------

    def _sampling_of(self, request: Request) -> SamplingParams:
        return request.sampling or self.sampling

    def _preempt_overflowing(self, n_steps: int) -> None:
        """Preempt requests whose KV row would overflow ``max_len`` within
        the next ``n_steps`` appends (`batching.py:535`); a paged slot also
        grows its pages to cover the burst, and a dry pool preempts it the
        same way. "truncate" finishes the request early; "requeue" frees the
        slot and re-submits prompt + generated."""
        table_dirty = False
        for slot, request in enumerate(self.slot_request):
            if request is None:
                continue
            fits = int(self.slot_pos[slot]) + n_steps < self.max_len
            if fits and self.paged:
                fits = self._alloc.ensure(slot, int(self.slot_pos[slot]) + n_steps,
                                          self.cache.page_size)
                table_dirty = True
            if fits:
                continue
            self.slot_request[slot] = None
            if self.paged:
                self._alloc.release(slot)
                table_dirty = True
            if self.cache_overflow == "requeue" and (
                len(request.prompt) + len(request.generated) < self.max_len - n_steps
            ):
                request.prompt = list(request.prompt) + list(request.generated)
                self._pending.append(request)
                self.stats.preempt_requeued += 1
            else:
                request.done = True
                request.truncated = True
                self._done[request.request_id] = request
                self.stats.preempt_truncated += 1
        if self.paged and table_dirty:
            self.cache.table = self._alloc.table_array(self.device)

    def _admit_cap(self, max_prompt: int) -> int:
        """Most requests one slab admission group may hold: the bucketed
        group ``_bucket(n, floor=1)`` that the prefill allocates stays within
        ``_ADMIT_KV_BUDGET``."""
        cfg = self.config
        sl = min(self.max_len, -(-min(_bucket(max_prompt), self.max_len) // 256) * 256)
        per_row = (2 * cfg.num_layers * cfg.num_kv_heads * sl * cfg.head_dim
                   * (1 + 4 / cfg.head_dim))  # int8 kv + f32 scales
        rows = max(1, int(self._ADMIT_KV_BUDGET // max(1.0, per_row)))
        return 1 << (rows.bit_length() - 1)  # the largest bucket within the budget

    def _admit(self) -> None:
        free = [s for s in range(self.max_batch) if self.slot_request[s] is None]
        if not free or not self._pending:
            return
        batch = self._pending[: len(free)]
        if not self.paged:
            batch = batch[: self._admit_cap(max(len(r.prompt) for r in batch))]
        else:
            # only the FIFO prefix whose pages fit the pool right now
            page = self.cache.page_size
            budget = self._alloc.num_free
            take = []
            for r in batch:
                need = -(-(len(r.prompt) + 1) // page)
                if need > budget:
                    break
                budget -= need
                take.append(r)
            batch = take
            if not batch:
                return
        del self._pending[: len(batch)]

        # one bucketed batch prefill for the whole admission group
        max_prompt = max(len(r.prompt) for r in batch)
        t_bucket = min(_bucket(max_prompt), self.max_len)
        nb = _bucket(len(batch), floor=1)
        ids = np.zeros((nb, t_bucket), np.int64)
        lengths = np.ones((nb,), np.int64)
        temps = np.zeros((nb,), np.float32)
        top_ks = np.zeros((nb,), np.int32)
        top_ps = np.ones((nb,), np.float32)
        for i, r in enumerate(batch):
            ids[i, : len(r.prompt)] = r.prompt
            lengths[i] = len(r.prompt)
            sp = self._sampling_of(r)
            temps[i], top_ks[i], top_ps[i] = sp.temperature, sp.top_k, sp.top_p
        sampling = self._sampling_tensors(temps, top_ks, top_ps)

        if self.paged:
            # the transient holds the prompt bucket, rounded up to a page
            page = self.cache.page_size
            small_len = -(-t_bucket // page) * page
        else:
            # the bucket prefix, rounded to flash prefill's 256 blocking
            small_len = min(self.max_len, -(-t_bucket // 256) * 256)
        small = StackedKVCache.create(
            num_layers=self.config.num_layers, batch_size=nb, max_len=small_len,
            num_kv_heads=self.config.num_kv_heads, head_dim=self.config.head_dim,
            device=self.device,
        )
        if t_bucket > self.prefill_chunk:
            # chunked prefill, with decode for the active slots between chunks
            chunk = self.prefill_chunk
            first_tokens = np.zeros((nb,), np.int32)
            for off in range(0, t_bucket, chunk):
                sel = np.clip(lengths - 1 - off, 0, chunk - 1)
                t0 = time.perf_counter()
                toks = self._prefill_chunk(
                    small, self._dev(ids[:, off:off + chunk]), off, self._dev(sel), *sampling,
                ).cpu().numpy()
                self.stats.prefill_seconds += time.perf_counter() - t0
                self.stats.prefills += 1
                self.stats.prefill_chunks += 1
                self.stats.prefill_tokens += nb * chunk
                ends_here = (lengths - 1 >= off) & (lengths - 1 < off + chunk)
                first_tokens = np.where(ends_here, toks, first_tokens)
                if off + chunk < t_bucket and self.num_active > 0:
                    self._run_burst(self.decode_between_chunks)
        else:
            t0 = time.perf_counter()
            first_tokens = self._prefill_batch(
                small, self._dev(ids), self._dev(lengths), *sampling,
            ).cpu().numpy()
            self.stats.prefill_seconds += time.perf_counter() - t0
            self.stats.prefills += 1
            self.stats.prefill_tokens += nb * t_bucket

        if not self.paged:
            # one batched KV copy for the whole admission group
            self._scatter_rows(small, len(batch), free[: len(batch)])
        for i, r in enumerate(batch):
            slot = free[i]
            if self.paged:
                if not self._alloc.ensure(slot, len(r.prompt) + 1, self.cache.page_size):
                    # pool dry: requeue at the front; a later retirement
                    # releases pages and re-admits it
                    self._pending.insert(0, r)
                    self.stats.pool_dry_requeues += 1
                    continue
                scatter_prefill_to_pages(self.cache, small.k, small.v, small.k_scale,
                                         small.v_scale, i, self._alloc.pages[slot])
            token = int(first_tokens[i])
            r.generated.append(token)
            self.slot_request[slot] = r
            self.stats.admitted += 1
            self.slot_pos[slot] = len(r.prompt)
            self.slot_token[slot] = token
            sp = self._sampling_of(r)
            self.slot_temp[slot], self.slot_topk[slot], self.slot_topp[slot] = (
                sp.temperature, sp.top_k, sp.top_p)
        if self.paged:
            # one table upload for the group (the JAX engine re-uploads per row)
            self.cache.table = self._alloc.table_array(self.device)
