"""GPU smoke run of the PyTorch/CUDA port (`fastforward_tpu_torch`).

    python3 chip_smoke.py [--out DIR]

Needs one NVIDIA GPU (built for the H100, sm_90a) and nvcc. Four phases,
each raising on failure:

1. build  — compile every CUDA kernel of the port from `csrc/` (one nvcc
   per source, in parallel) and print the build time;
2. kernels — run each kernel and its plain PyTorch version on the card at
   the Llama-3-8B shapes of the serving and engine phases and hold them
   together (GEMVs, argmax ids, the dequant and the KV appends bit-equal;
   flash decode, paged flash decode and flash prefill within rtol 8e-3 of
   the largest output; the fused layer tail with x1 bit-equal, its int8
   activations within one level in a stated share of elements and its
   output within rtol 8e-3); print median times, device times and bounds;
3. serve  — Llama-3-8B at full width and depth (32 layers), random weights
   from the port's own `random_stacked_params`, INT8 KV on a 512-token
   slab, greedy decoding. Three runs, each with its launch counts set to
   0 before it and asserted exactly after it:
   (a) bench.py's default: W4A4 at group 512 (lm_head W4A8), 192 prompts
       of 128 tokens, then 32 tokens each;
   (b) bench.py's FF_BENCH_MODE=w4a8_2l: W4A8 at group 128, same shape;
   (c) W4A4 g512, 8 prompts of 32 tokens: the prefill of at most 256
       rows, through the A4 GEMV.
   Each prints prefill ms, decode tok/s, peak memory and profiles of one
   decode step and one prefill. Then, at depth 2 for (a) and (b), the
   kernel path is compared with the plain path on the card;
4. engine — bench.py's continuous-batching workload (measure_engine with
   FF_BENCH_MODE=w4a8_2l FF_BENCH_ENGINE_PAGED=1 FF_BENCH_ENGINE_SAT=1,
   one pass): Llama-3-8B w4a8_2l g128 at full depth, 32 slots on the paged
   INT8 pool (39 pages of 256 tokens), 64 requests of 16-96 prompt tokens
   and 32 new tokens each, bursts of 8. Launch counts asserted exactly
   from the engine's own counters; the same trace through a slab engine
   gives the same tokens, request by request; at depth 2 the paged decode
   at 32 rows (paged append, paged flash decode, fused layer tail) is
   compared with the plain path.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. Exits non-zero, printing no
result, when CUDA is absent or the package cannot be imported. ``--out``
also writes the log there.
"""

import collections
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
INT8_OPS_PER_S = 1979e12       # H100 SXM dense int8
BF16_OPS_PER_S = 989e12        # H100 SXM dense bf16 tensor cores
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
FLASH_RTOL = 8e-3              # one bf16 ulp, relative to the largest output
# Kernel path vs plain path at depth 2: relative RMS error of the logits
# (see compare_paths). Measured on an H100 at the prefill: 0.144 (w4a4_2l)
# and 0.0099 (w4a8_2l); the limits leave room for other weights and inputs.
LOGIT_RMS = {"w4a4_2l": 0.3, "w4a8_2l": 0.03}

# The fused layer tail's int8 activations (hq, x2) may sit one level from
# the plain version's where the IEEE rsqrt and the row sums round unlike
# PyTorch's; at most this share of their elements may (the counts measured
# on an H100 are in PERF.md's kernel findings).
TAIL_LEVEL_SHARE = 1e-3

PROJ = {"qkv": (4096, 6144), "o": (4096, 4096), "gate_up": (4096, 28672),
        "down": (14336, 4096)}   # (K, N) of one fused Llama-3-8B layer
BATCH, PROMPT, STEPS, SLAB = 192, 128, 32, 512   # bench.py's shape
# bench.py's engine workload (measure_engine, FF_BENCH_ENGINE_PAGED=1,
# FF_BENCH_ENGINE_SAT=1) at max_batch 32: 2 x 32 requests, pool of
# int(32 * 2 * 0.6) + 1 pages of 256 tokens, bursts of 8
ENGINE_SLOTS, ENGINE_MAXLEN, ENGINE_PAGE, ENGINE_BURST = 32, 512, 256, 8
ENGINE_PAGES = int(ENGINE_SLOTS * 2 * 0.6) + 1
ENGINE_PROMPTS = (16, 32, 64, 96)

_LOG = []


def log(*args):
    line = " ".join(str(a) for a in args)
    _LOG.append(line)
    print(line, flush=True)


def median_ms(fn, n=20):
    """Median time of ``fn`` over ``n`` calls (CUDA events around each
    call, synchronized: host launch included)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _profile(fn, n):
    """(wall ms per call, [(device ms per call, launches per call, kernel
    name)] sorted by time) of ``n`` calls of ``fn`` under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    rows = [(getattr(e, "self_device_time_total", 0) / n / 1e3, e.count / n, e.key)
            for e in prof.key_averages()]
    return wall_ms, sorted((r for r in rows if r[0] > 0), reverse=True)


def device_ms(fn, n=20):
    """Kernel time on the card per call of ``fn`` (the sum of the device
    time of every kernel launched), or None when the profiler records none."""
    fn()
    total = sum(r[0] for r in _profile(fn, n)[1])
    return total if total > 0 else None


def fmt_ms(v):
    return "not measured" if v is None else f"{v:.4f} ms"


def max_err(a, b):
    """Largest absolute difference of two tensors (0.0 when bit-equal and finite)."""
    return (a.double() - b.double()).abs().max().item()


def bound(nbytes, ops, ops_per_s):
    """(bytes ms, operations ms): the least time for the bytes at the
    memory rate and for the operations at the peak rate of their type."""
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / ops_per_s


def measure(name, label, kern, plain, nbytes, ops, ops_per_s, check, library=None):
    """Check ``kern`` against ``plain`` with ``check(out, ref) -> (ok, err)``,
    time both, log one line; returns the row."""
    out, ref = kern(), plain()
    torch.cuda.synchronize()
    ok, err = check(out, ref)
    if not ok:
        raise AssertionError(f"{name} {label}: kernel disagrees with its plain version (err {err})")
    ms, pms, dms = median_ms(kern), median_ms(plain), device_ms(kern)
    bb, bo = bound(nbytes, ops, ops_per_s)
    lib = median_ms(library) if library is not None else None
    log(f"{name} {label}: {ms:.4f} ms, device {fmt_ms(dms)} (plain {pms:.3f} ms, bound "
        f"{max(bb, bo):.4f} ms{'' if lib is None else f', library {lib:.4f} ms'}), err {err:.3g}")
    return dict(ms=ms, device_ms=dms, plain_ms=pms, bytes_ms=bb, ops_ms=bo, max_abs_err=err,
                library_ms=lib)


def bit_equal(out, ref):
    return torch.equal(out, ref), max_err(out, ref)


def within_rtol(out, ref):
    err = (out.float() - ref.float()).abs().max().item()
    return err <= FLASH_RTOL * ref.float().abs().max().item(), err


def add_rows(rows):
    """One row summing the times and bounds of ``rows`` (the four
    projections of a layer)."""
    total = {k: sum(r[k] for r in rows) for k in ("ms", "plain_ms", "bytes_ms", "ops_ms")}
    dms = [r["device_ms"] for r in rows]
    total["device_ms"] = None if None in dms else sum(dms)
    total["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    total["library_ms"] = None
    return total


def phase_build():
    from fastforward_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    times = _build.build_all()
    for name in _build.SOURCES:
        _build.lib(name)
    log(f"build: {time.perf_counter() - t0:.1f} s ({', '.join(f'{k} {v:.1f} s' for k, v in times.items()) or 'cached'})")
    for name, text in _build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")


def phase_kernels(dev):
    from fastforward_tpu_torch.kernels import attention as att
    from fastforward_tpu_torch.kernels import kv_update as kvu
    from fastforward_tpu_torch.kernels import matmul as mm
    from fastforward_tpu_torch.kernels.packing import pack_mult_nibbles, unpack_mult_nibbles

    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    rows = {}
    L = 2  # stacked weights and caches: layer 1 of 2

    def randint(lo, hi, shape, dtype=torch.int8):
        return torch.randint(lo, hi, shape, generator=gen, dtype=dtype, device=dev)

    def stacked(K, N, g):
        w = randint(-128, 128, (L, K // 2, N))
        mult = randint(1, 16, (L, K // g, N))
        s_col = (torch.rand((L, N), generator=gen, device=dev) * 1e-3).contiguous()
        return w, mult, s_col

    def act(M, K):
        return torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)

    # --- A4 GEMV (w4a4_2l decode), g512: M = 8, bench batch 192, 256 (the
    # largest GEMV prefill); the JSON row is one decode layer at M = 192
    g = 512
    for M in (8, BATCH, 256):
        per = []
        for pname, (K, N) in PROJ.items():
            w, mult, s_col = stacked(K, N, g)
            mp = pack_mult_nibbles(mult).contiguous()
            x_q, x_s = mm.quantize_rowwise_a4(act(M, K))
            nbytes = K * N // 2 + mp[1].numel() * 4 + N * 4 + M * K + M * 4 + M * N * 2
            per.append(measure(
                "a4_gemv", f"{pname} M={M} K={K} N={N}",
                lambda: mm.matmul_w4a4_2l_gemv_stacked(x_q, x_s, w, mp, s_col, 1, group_size=g),
                lambda: mm.matmul_w4a4_2l_reference(x_q, x_s, w[1], unpack_mult_nibbles(mp[1], K // g),
                                                    s_col[1], None, g),
                nbytes, 2 * M * K * N, INT8_OPS_PER_S, bit_equal))
        if M == BATCH:
            rows["a4_gemv"] = add_rows(per)

    # --- W4A8 two-level GEMV (w4a8_2l decode), stacked, g128, M = 192
    g = 128
    per = []
    for pname, (K, N) in PROJ.items():
        w, mult, s_col = stacked(K, N, g)
        mp = pack_mult_nibbles(mult).contiguous()
        x_q, x_s = mm.quantize_rowwise(act(BATCH, K))
        M = BATCH
        nbytes = K * N // 2 + mp[1].numel() * 4 + N * 4 + M * K + M * 4 + M * N * 2
        per.append(measure(
            "w4a8_gemv_stacked", f"{pname} M={M} K={K} N={N}",
            lambda: mm.matmul_w4a8_2l_gemv_stacked(x_q, x_s, w, mp, s_col, 1, group_size=g),
            lambda: mm.matmul_w4a8_2l_reference(x_q, x_s, w[1], unpack_mult_nibbles(mp[1], K // g),
                                                s_col[1], None, g, paired=True),
            nbytes, 2 * M * K * N, INT8_OPS_PER_S, bit_equal))
    rows["w4a8_gemv_stacked"] = add_rows(per)

    # --- Prefill dequant: vertical (w4a4_2l, g512) and paired (w4a8_2l,
    # g128), the four projections of a layer
    for name, layout, g in (("dequant_vertical", "vertical", 512), ("dequant_paired", "paired", 128)):
        kern_fn = getattr(mm, f"dequantize_int4_{layout}_stacked")
        plain_fn = getattr(mm, f"dequantize_int4_{layout}_reference")
        per = []
        for pname, (K, N) in PROJ.items():
            w, mult, s_col = stacked(K, N, g)
            nbytes = K * N // 2 + (K // g) * N + N * 4 + K * N * 2
            per.append(measure(
                name, f"{pname} K={K} N={N} g={g}",
                lambda: kern_fn(w, mult, s_col, 1, group_size=g),
                lambda: plain_fn(w[1], mult[1].float() * s_col[1][None, :], g),
                nbytes, K * N, F32_OPS_PER_S, bit_equal))
        rows[name] = add_rows(per)

    # --- W4A8 two-level lm_head, paired, N = 128256, g512: M = 8 and 192,
    # f32 and bf16 logits and the argmax head; the JSON row is the argmax
    # head at M = 192 (the decode step's)
    K, N, g = 4096, 128256, 512
    w = randint(-128, 128, (K // 2, N))
    mult = randint(1, 16, (K // g, N))
    s_col = torch.rand((N,), generator=gen, device=dev) * 1e-3
    for M in (8, BATCH):
        x_q, x_s = mm.quantize_rowwise(act(M, K))
        nbytes = K * N // 2 + K // g * N + N * 4 + M * K + M * 4
        errs = []
        for out_dtype in (torch.float32, torch.bfloat16):
            r = measure(
                "w4a8_gemv", f"lm_head {out_dtype} M={M}",
                lambda: mm.matmul_w4a8_2l_gemv(x_q, x_s, w, mult, s_col, g, out_dtype, paired=True),
                lambda: mm.matmul_w4a8_2l_reference(x_q, x_s, w, mult, s_col, None, g, out_dtype,
                                                    paired=True),
                nbytes + M * N * (4 if out_dtype == torch.float32 else 2), 2 * M * K * N,
                INT8_OPS_PER_S, bit_equal)
            errs.append(r["max_abs_err"])
        r = measure(
            "w4a8_gemv", f"lm_head argmax M={M}",
            lambda: mm.matmul_w4a8_2l_gemv_argmax(x_q, x_s, w, mult, s_col, g, paired=True),
            lambda: torch.argmax(mm.matmul_w4a8_2l_reference(
                x_q, x_s, w, mult, s_col, None, g, torch.float32, paired=True), dim=-1).to(torch.int32),
            nbytes + M * 4, 2 * M * K * N, INT8_OPS_PER_S, bit_equal)
        if M == BATCH:
            r["max_abs_err"] = max(errs + [r["max_abs_err"]])
            rows["w4a8_gemv"] = r

    # --- KV append and flash decode: Hkv=8, G=4, d=128, S=512, layer 1 of
    # 2; B=8 with lengths 1..300, and the bench decode (B=192, lengths
    # 129..160); the JSON rows are the bench decode's
    Hkv, G, d, S = 8, 4, 128, SLAB
    H = Hkv * G
    for B, lo, hi in ((8, 1, 301), (BATCH, PROMPT + 1, PROMPT + STEPS + 1)):
        kc = randint(-128, 128, (L, B, Hkv, S, d))
        vc = randint(-128, 128, (L, B, Hkv, S, d))
        ks = torch.rand((L, B, Hkv, S), generator=gen, device=dev) * 0.05
        vs = torch.rand((L, B, Hkv, S), generator=gen, device=dev) * 0.05
        kn, vn = randint(-128, 128, (B, Hkv, 1, d)), randint(-128, 128, (B, Hkv, 1, d))
        ksn = torch.rand((B, Hkv, 1), generator=gen, device=dev)
        vsn = torch.rand((B, Hkv, 1), generator=gen, device=dev)
        lengths = torch.randint(lo, hi, (B,), generator=gen, device=dev, dtype=torch.int32)
        lengths[0], lengths[1] = lo, hi - 1
        starts = (lengths - 1).contiguous()
        bufs = [t.clone() for t in (kc, vc, ks, vs)]

        def append_check(out, ref):
            return all(torch.equal(a, r) for a, r in zip(out, ref)), \
                max(max_err(a, r) for a, r in zip(out, ref))

        # the kernel and the plain version each write their own copy of the cache
        ref_bufs = [t.clone() for t in (kc, vc, ks, vs)]
        r_app = measure(
            "kv_append", f"B={B} Hkv={Hkv} d={d} S={S}",
            lambda: kvu.kv_append_decode_int8_stacked(*bufs, kn, vn, ksn, vsn, starts, 1),
            lambda: kvu.kv_append_decode_stacked_reference(*ref_bufs, kn, vn, ksn, vsn, starts, 1),
            2 * 2 * B * Hkv * (d + 4) + B * 4, 0, INT8_OPS_PER_S, append_check)
        q = torch.randn((B, H, d), generator=gen, device=dev).to(torch.bfloat16)
        live = int(lengths.sum().item())
        kd = (kc[1].float() * ks[1][..., None]).to(torch.bfloat16)
        vd = (vc[1].float() * vs[1][..., None]).to(torch.bfloat16)
        amask = (torch.arange(S, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
        r_dec = measure(
            "flash_decode", f"B={B} H={H} Hkv={Hkv} d={d} S={S} lengths {lo}..{hi - 1}",
            lambda: att.flash_decode_int8_stacked(q, kc, ks, vc, vs, lengths, 1),
            lambda: att.flash_decode_int8_reference(q, kc[1], ks[1], vc[1], vs[1], lengths),
            live * Hkv * 2 * (d + 4) + 2 * B * H * d * 2 + B * 4, 4 * live * G * d * Hkv,
            F32_OPS_PER_S, within_rtol,
            library=lambda: torch.nn.functional.scaled_dot_product_attention(
                q[:, :, None, :], kd, vd, attn_mask=amask, enable_gqa=True))
        del kc, vc, kd, vd, bufs, ref_bufs
        if B == BATCH:
            rows["kv_append"], rows["flash_decode"] = r_app, r_dec

    # --- Flash prefill: bench.py's prefill (B=192, T=128, starts 0) and a
    # ragged chunk (T=77, starts 0..300) over one layer of a 512-token slab
    for B, T, smax in ((BATCH, PROMPT, 0), (16, 77, 300)):
        k = randint(-128, 128, (B, Hkv, S, d))
        v = randint(-128, 128, (B, Hkv, S, d))
        ks = torch.rand((B, Hkv, S), generator=gen, device=dev) * 0.02
        vs = torch.rand((B, Hkv, S), generator=gen, device=dev) * 0.05
        q = torch.randn((B, H, T, d), generator=gen, device=dev).to(torch.bfloat16)
        starts = torch.randint(0, smax + 1, (B,), generator=gen, device=dev, dtype=torch.int32)
        pos = starts[:, None].long() + torch.arange(T, device=dev)[None, :]        # (B, T)
        seen = torch.clamp(pos + 1, max=S)                                           # keys per row
        live_rows = int(torch.clamp(starts.long() + T, max=S).sum().item())
        nbytes = 2 * B * H * T * d * 2 + live_rows * Hkv * 2 * (d + 4) + B * 4
        ops = 4 * H * d * int(seen.sum().item())
        kd = (k.float() * ks[..., None]).to(torch.bfloat16)
        vd = (v.float() * vs[..., None]).to(torch.bfloat16)
        cmask = (torch.arange(S, device=dev)[None, None, :] <= pos[:, :, None])[:, None]
        r = measure(
            "flash_prefill", f"B={B} H={H} Hkv={Hkv} T={T} S={S} starts 0..{smax}",
            lambda: att.flash_prefill(q, k, ks, v, vs, starts),
            lambda: att.flash_prefill_reference(q, k, ks, v, vs, starts),
            nbytes, ops, BF16_OPS_PER_S, within_rtol,
            library=lambda: torch.nn.functional.scaled_dot_product_attention(
                q, kd, vd, attn_mask=cmask, enable_gqa=True))
        del k, v, kd, vd
        if B == BATCH:
            rows["flash_prefill"] = r
    torch.cuda.empty_cache()
    rows.update(_paged_kernels(dev, gen, randint))
    rows.update(_fused_tail_kernel(dev, gen, randint))
    torch.cuda.empty_cache()
    return rows


def _paged_kernels(dev, gen, randint):
    """Paged append and paged flash decode at the engine's decode: B = 32
    sequences, a pool of 39 pages of 256 tokens, one page each from a
    shuffled list, lengths 17..160, and two rows that walk both table
    columns (300 and 512 tokens, a second page each); layer 1 of 2."""
    from fastforward_tpu_torch.kernels import paged_attention as pa

    L, Hkv, G, d = 2, 8, 4, 128
    B, P, page, MP = ENGINE_SLOTS, ENGINE_PAGES, ENGINE_PAGE, ENGINE_MAXLEN // ENGINE_PAGE
    pools = [randint(-128, 128, (L, P, Hkv, page, d)) for _ in range(2)]
    pools += [torch.rand((L, P, Hkv, page), generator=gen, device=dev) * 0.05 for _ in range(2)]
    table = torch.full((B, MP), -1, dtype=torch.int32, device=dev)
    perm = (torch.randperm(P - 1, generator=gen, device=dev) + 1).to(torch.int32)
    table[:, 0] = perm[:B]
    table[4:6, 1] = perm[B:B + 2]
    lengths = torch.randint(17, 161, (B,), generator=gen, device=dev, dtype=torch.int32)
    lengths[0], lengths[1], lengths[4], lengths[5] = 17, 160, 300, MP * page
    rows = {}

    # append: row 2's table is all -1 (a retired slot: page 0), row 3 sits
    # past the table (pos // page >= MP: page 0 too, another row of it)
    pos = (lengths - 1).clone()
    table_a = table.clone()
    table_a[2] = -1
    pos[2], pos[3] = 5, MP * page + 9
    new = [randint(-128, 128, (B, Hkv, 1, d)) for _ in range(2)]
    new += [torch.rand((B, Hkv, 1), generator=gen, device=dev) for _ in range(2)]
    bufs = [t.clone() for t in pools]
    ref_bufs = [t.clone() for t in pools]

    def append_check(out, ref):
        return all(torch.equal(a, r) for a, r in zip(out, ref)), \
            max(max_err(a, r) for a, r in zip(out, ref))

    rows["paged_kv_append"] = measure(
        "paged_kv_append",
        f"B={B} P={P} page={page} Hkv={Hkv} d={d} (a -1 row, a row past the table, "
        "two rows on their second page)",
        lambda: pa.paged_kv_append_decode_int8(*bufs, *new, pos, table_a, 1),
        lambda: pa.paged_kv_append_reference(*ref_bufs, *new, pos, table_a, 1),
        2 * 2 * B * Hkv * (d + 4) + B * 4 + B * MP * 4, 0, INT8_OPS_PER_S, append_check)
    del bufs, ref_bufs

    # flash decode over the shuffled pages
    k, v, ks, vs = pools
    q = torch.randn((B, Hkv * G, d), generator=gen, device=dev).to(torch.bfloat16)
    live = int(lengths.sum().item())

    def gathered(pool):
        return torch.stack([pa.gather_pages(pool[1], t) for t in table])
    kd = (gathered(k).float() * gathered(ks)[..., None]).to(torch.bfloat16)
    vd = (gathered(v).float() * gathered(vs)[..., None]).to(torch.bfloat16)
    S = MP * page
    amask = (torch.arange(S, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
    rows["paged_flash_decode"] = measure(
        "paged_flash_decode",
        f"B={B} H={Hkv * G} Hkv={Hkv} d={d} page={page} lengths 17..160, 300, {MP * page}",
        lambda: pa.paged_flash_decode_int8(q, k, ks, v, vs, table, lengths, 1),
        lambda: pa.paged_flash_decode_reference(q, k[1], ks[1], v[1], vs[1], table, lengths),
        live * Hkv * 2 * (d + 4) + 2 * B * Hkv * G * d * 2 + B * 4 + B * MP * 4,
        4 * live * G * d * Hkv, F32_OPS_PER_S, within_rtol,
        library=lambda: torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None, :], kd, vd, attn_mask=amask, enable_gqa=True))
    return rows


def _fused_tail_kernel(dev, gen, randint):
    """The fused W4A8 layer tail at the 8B widths, M = 8, 32 and 64 rows
    (the JSON row: M = 32, the engine's decode); layer 1 of 2. Beside it,
    for information only, the port's unfused route on the same inputs."""
    from fastforward_tpu_torch.kernels import matmul as mm
    from fastforward_tpu_torch.kernels.packing import pack_mult_nibbles
    from fastforward_tpu_torch.serving.engine import _rms_norm

    L, H, inter, g, eps = 2, 4096, 14336, 128, 1e-5
    ops, nbytes_w = [], 0
    for K, N in ((H, H), (H, 2 * inter), (inter, H)):
        w = randint(-128, 128, (L, K // 2, N))
        mp = pack_mult_nibbles(randint(1, 16, (L, K // g, N))).contiguous()
        sc = torch.rand((L, N), generator=gen, device=dev) * (4.0 / K)
        ops += [w, mp, sc]
        nbytes_w += K * N // 2 + mp[1].numel() * 4 + N * 4
    norm = (torch.rand((L, H), generator=gen, device=dev) + 0.5).to(torch.bfloat16)
    rows = {}
    for M in (8, ENGINE_SLOTS, 64):
        attn = torch.randn((M, H), generator=gen, device=dev).to(torch.bfloat16)
        x_res = torch.randn((M, H), generator=gen, device=dev).to(torch.bfloat16)
        layer_ops = mm._fused_o_mlp_layer(norm, *ops, 1, g)
        diffs = {}

        def check(out, ref, _diffs=diffs):
            y, x1, hq, hs, x2, gs = ref
            ok = torch.equal(out[1], x1)
            for name, a, b in (("hq", out[2], hq), ("x2", out[4], x2)):
                d = (a.int() - b.int()).abs()
                _diffs[name] = (int(d.count_nonzero().item()), a.numel())
                ok = ok and d.max().item() <= 1 and _diffs[name][0] <= TAIL_LEVEL_SHARE * a.numel()
            ok_y, err = within_rtol(out[0], y)
            return ok and ok_y, err

        def unfused(attn=attn, x_res=x_res):
            o_w, o_mp, o_sc, gu_w, gu_mp, gu_sc, dn_w, dn_mp, dn_sc = ops
            x = x_res + mm.matmul_w4a8_2l_gemv_stacked(*mm.quantize_rowwise(attn), o_w, o_mp, o_sc,
                                                       1, group_size=g)
            gu = mm.matmul_w4a8_2l_gemv_stacked(*mm.quantize_rowwise(_rms_norm(x, norm[1], eps)),
                                                gu_w, gu_mp, gu_sc, 1, group_size=g)
            gated = torch.nn.functional.silu(gu[:, :inter].float()).to(x.dtype) * gu[:, inter:]
            return x + mm.matmul_w4a8_2l_gemv_stacked(*mm.quantize_rowwise(gated), dn_w, dn_mp,
                                                      dn_sc, 1, group_size=g)

        r = measure(
            "fused_o_mlp", f"M={M} H={H} inter={inter} g={g}",
            lambda attn=attn, x_res=x_res: mm._fused_o_mlp_launch(attn, x_res, norm, *ops, 1, g, eps),
            lambda attn=attn, x_res=x_res: mm._fused_o_mlp_parts(attn.float(), x_res.float(),
                                                                 *layer_ops, group_size=g, eps=eps),
            nbytes_w + H * 2 + M * H * 2 * 3, 2 * M * (H * H + H * 2 * inter + inter * H),
            INT8_OPS_PER_S, check)
        r["unfused_ms"] = median_ms(unfused)
        r["level_diffs"] = dict(diffs)
        log(f"fused_o_mlp M={M}: x1 bit-equal; int8 elements one level off: "
            + ", ".join(f"{k} {n} of {t}" for k, (n, t) in diffs.items())
            + f"; unfused route (3 stacked GEMVs + torch glue) {r['unfused_ms']:.4f} ms")
        if M == ENGINE_SLOTS:
            rows["fused_o_mlp"] = r
    return rows


def _plain_versions():
    """(patch target, plain version, check) of every kernel wrapper the
    serving path calls, under the name that `engine`/`stacked` import."""
    from fastforward_tpu_torch.kernels import attention as att
    from fastforward_tpu_torch.kernels import kv_update as kvu
    from fastforward_tpu_torch.kernels import matmul as mm
    from fastforward_tpu_torch.kernels import paged_attention as pa
    from fastforward_tpu_torch.kernels.packing import unpack_mult_nibbles

    def a4(x_q, x_s, w, mp, s_col, layer, group_size, out_dtype=torch.bfloat16):
        n_groups = x_q.shape[1] // group_size
        return mm.matmul_w4a4_2l_reference(
            x_q, x_s, w[layer], unpack_mult_nibbles(mp[layer], n_groups), s_col[layer], None,
            group_size, out_dtype)

    def w4a8_stacked(x_q, x_s, w, mp, s_col, layer, group_size, out_dtype=torch.bfloat16):
        n_groups = x_q.shape[1] // group_size
        return mm.matmul_w4a8_2l_reference(
            x_q, x_s, w[layer], unpack_mult_nibbles(mp[layer], n_groups), s_col[layer], None,
            group_size, out_dtype, paired=True)

    def w4a8(x_q, x_s, w, mult, s_col, group_size, out_dtype, paired):
        return mm.matmul_w4a8_2l_reference(x_q, x_s, w, mult, s_col, None, group_size,
                                           out_dtype, paired=paired)

    def argmax(x_q, x_s, w, mult, s_col, group_size, paired):
        return torch.argmax(w4a8(x_q, x_s, w, mult, s_col, group_size, torch.float32, paired),
                            dim=-1).to(torch.int32)

    def dequant(reference):
        def plain(w, mult, s_col, layer, group_size):
            return reference(w[layer], mult[layer].float() * s_col[layer][None, :], group_size)
        return plain

    def dequant_paired(w, s_eff, group_size, offset_binary, paired):
        return mm.dequantize_int4_paired_reference(w, s_eff, group_size)

    def flash(q, k, ks, v, vs, lengths, layer):
        return att.flash_decode_int8_reference(q, k[layer], ks[layer], v[layer], vs[layer], lengths)

    def paged_flash(q, k, ks, v, vs, table, lengths, layer):
        return pa.paged_flash_decode_reference(q, k[layer], ks[layer], v[layer], vs[layer], table,
                                               lengths)

    def fused_tail(attn, x_res, norm_w, *weights, group_size, eps):
        *w, layer = weights
        return mm.fused_o_mlp_reference(
            attn.float(), x_res.float(), *mm._fused_o_mlp_layer(norm_w, *w, layer, group_size),
            group_size, eps).to(attn.dtype)

    eng, stk = "fastforward_tpu_torch.serving.engine", "fastforward_tpu_torch.serving.stacked"
    return [
        (f"{eng}.matmul_w4a4_2l_gemv_stacked", a4, bit_equal),
        (f"{eng}.matmul_w4a8_2l_gemv_stacked", w4a8_stacked, bit_equal),
        (f"{eng}.matmul_w4a8_2l_gemv", w4a8, bit_equal),
        (f"{eng}.dequantize_int4_vertical_stacked", dequant(mm.dequantize_int4_vertical_reference),
         bit_equal),
        (f"{eng}.dequantize_int4_paired_stacked", dequant(mm.dequantize_int4_paired_reference),
         bit_equal),
        (f"{eng}.dequantize_int4_vertical", mm.dequantize_int4_vertical_reference, bit_equal),
        (f"{eng}.dequantize_int4", dequant_paired, bit_equal),
        (f"{stk}.matmul_w4a8_2l_gemv_argmax", argmax, bit_equal),
        (f"{stk}.kv_append_decode_int8_stacked", kvu.kv_append_decode_stacked_reference, None),
        (f"{stk}.flash_decode_int8_stacked", flash, within_rtol),
        (f"{stk}.flash_prefill", att.flash_prefill_reference, within_rtol),
        (f"{stk}.paged_kv_append_decode_int8", pa.paged_kv_append_reference, None),
        (f"{stk}.paged_flash_decode_int8", paged_flash, within_rtol),
        (f"{stk}.fused_o_mlp_stacked", fused_tail, within_rtol),
    ]


def _plain_patches():
    """Swap every kernel wrapper the serving path calls for its plain
    PyTorch version."""
    return [mock.patch(target, plain) for target, plain, _ in _plain_versions()]


def _checked_patches(checked):
    """Run every kernel wrapper the serving path calls and also its plain
    version on the same inputs; raise where they disagree, count the
    checked calls in ``checked`` and return the kernel's result."""
    import importlib

    patches = []
    for target, plain, check in _plain_versions():
        module, name = target.rsplit(".", 1)
        kernel = getattr(importlib.import_module(module), name)

        def run(*args, _kernel=kernel, _plain=plain, _check=check, _name=name, **kwargs):
            if _check is None:  # a KV append writes in place: the plain version
                layer = args[-1]  # appends to a copy of the layer
                copy = [t[layer:layer + 1].clone() for t in args[:4]]
                out = _kernel(*args, **kwargs)
                ref = _plain(*copy, *args[4:-1], 0)
                ok, err = bit_equal(torch.cat([t[layer:layer + 1].flatten().view(torch.uint8)
                                               for t in out]),
                                    torch.cat([t.flatten().view(torch.uint8) for t in ref]))
            else:
                out = _kernel(*args, **kwargs)
                ok, err = _check(out, _plain(*args, **kwargs))
            if not ok:
                raise AssertionError(f"{_name} on the serving path: kernel disagrees with its "
                                     f"plain version (err {err})")
            checked[_name] += 1
            return out

        patches.append(mock.patch(target, run))
    return patches


def _model(config, mode, g, seed, dev):
    from fastforward_tpu_torch.serving import fuse_stacked_layers, random_stacked_params

    params, layers = random_stacked_params(config, mode=mode, group_size=g, seed=seed, device=dev)
    return params, fuse_stacked_layers(layers)


def _new_cache(config, B, dev, S=SLAB):
    from fastforward_tpu_torch.serving import StackedKVCache

    return StackedKVCache.create(config.num_layers, B, S, config.num_kv_heads,
                                 config.head_dim, device=dev)


def _to_pages(slab, config, dev):
    """The prefilled slab rows (S = one page) copied into a pool of the
    engine's size, one page per sequence from a fixed shuffled list."""
    from fastforward_tpu_torch.serving import PagedKVCache
    from fastforward_tpu_torch.serving.paged import scatter_prefill_to_pages

    B = slab.k.shape[1]
    pool = PagedKVCache.create(config.num_layers, ENGINE_PAGES, B, ENGINE_MAXLEN // ENGINE_PAGE,
                               config.num_kv_heads, config.head_dim, page_size=ENGINE_PAGE,
                               device=dev)
    pages = torch.randperm(ENGINE_PAGES - 1, generator=torch.Generator().manual_seed(5))[:B] + 1
    for b, pid in enumerate(pages.tolist()):
        scatter_prefill_to_pages(pool, slab.k, slab.v, slab.k_scale, slab.v_scale, b, [pid])
    pool.table[:, 0] = pages.to(torch.int32).to(dev)
    pool.length = slab.length
    return pool


def _serve(config, params, layers, ids, steps, dev):
    """Prefill (last-position logits) + ``steps`` greedy tokens; returns
    (logits, first token, tokens, cache, prefill ms, decode s)."""
    from fastforward_tpu_torch.serving import make_stacked_decode_loop, serving_forward_stacked

    cache = _new_cache(config, ids.shape[0], dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = serving_forward_stacked(params, layers, config, ids, cache=cache,
                                            logits_positions="last")
    first = torch.argmax(logits[:, -1], dim=-1).to(ids.dtype)[:, None]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    tokens, cache = make_stacked_decode_loop(config, steps)(params, layers, cache, first)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return logits, first, tokens, cache, (t1 - t0) * 1e3, (t2 - t1)


# substrings of the device names of the port's CUDA kernels
PORT_KERNELS = ("gemv_partial_kernel", "gemv_epilogue_kernel", "argmax_reduce_kernel",
                "kv_append_kernel", "flash_decode_kernel", "dequant_kernel",
                "flash_prefill_kernel", "fused_tail_kernel")


def _report_profile(what, wall_ms, rows, top=10):
    busy = sum(r[0] for r in rows)
    ours = sum(r[0] for r in rows if any(k in r[2] for k in PORT_KERNELS))
    log(f"{what} (profiled): wall {wall_ms:.2f} ms, device busy {busy:.3f} ms "
        f"({100 * busy / wall_ms:.1f}%), {sum(r[1] for r in rows):.0f} kernels; port kernels "
        f"{ours:.3f} ms, other kernels {busy - ours:.3f} ms")
    for ms, count, name in rows[:top]:
        log(f"  {ms:9.4f} ms  x{count:6.0f}  {name[:90]}")


def profile_steps(config, params, layers, cache, token, ids):
    """Profile one decode step (mean of 3, rewriting the last 3 rows of the
    slab) and one prefill (on a fresh cache)."""
    from fastforward_tpu_torch.serving import serving_forward_stacked

    state = {"cache": cache, "token": token}
    cache.length -= 3

    def step():
        tok, state["cache"] = serving_forward_stacked(params, layers, config, state["token"],
                                                      state["cache"], greedy_head=True)
        state["token"] = tok.to(token.dtype)[:, None]

    _report_profile("decode step", *_profile(step, 3))
    fresh = _new_cache(config, ids.shape[0], ids.device)
    _report_profile("prefill", *_profile(
        lambda: serving_forward_stacked(params, layers, config, ids, cache=fresh,
                                        logits_positions="last"), 1))


def serve_run(label, config, mode, g, B, T, steps, dev, expect):
    """One main-path run: warm-up, then the measured run with the launch
    counts set to 0 before it and asserted equal to ``expect`` after it."""
    from fastforward_tpu_torch.kernels import launch_counts, reset_launch_counts

    t0 = time.perf_counter()
    params, layers = _model(config, mode, g, 0, dev)
    torch.cuda.synchronize()
    log(f"serve {label}: Llama-3-8B {mode} g{g}, {config.num_layers} layers, weights on the card "
        f"in {time.perf_counter() - t0:.1f} s")
    ids = torch.randint(0, config.vocab_size, (B, T), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(7))
    _serve(config, params, layers, ids, 2, dev)  # warm-up: no first-call costs below
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    logits, first, tokens, cache, prefill_ms, decode_s = _serve(config, params, layers, ids,
                                                                steps, dev)
    counts = dict(launch_counts)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    log(f"serve {label}: prefill {B}x{T} {prefill_ms:.1f} ms; decode {B}x{steps} tokens in "
        f"{decode_s:.3f} s = {B * steps / decode_s:.1f} tok/s; peak memory {peak:.2f} GiB")
    log(f"serve {label}: launches {counts}")
    if counts != expect:
        raise AssertionError(f"{label}: launch counts {counts} != expected {expect}")
    if tuple(logits.shape) != (B, 1, config.vocab_size) or not torch.isfinite(logits).all():
        raise AssertionError(f"{label}: prefill logits are not finite (B, 1, vocab)")
    if tuple(tokens.shape) != (B, steps) or not ((tokens >= 0) & (tokens < config.vocab_size)).all():
        raise AssertionError(f"{label}: decoded tokens out of range: {tokens.shape}")
    if cache.length != T + steps:
        raise AssertionError(f"{label}: cache length {cache.length} != {T + steps}")
    profile_steps(config, params, layers, cache, tokens[:, -1:], ids)
    del params, layers, cache
    torch.cuda.empty_cache()
    return dict(counts=counts, prefill_ms=prefill_ms, tok_s=B * steps / decode_s, peak_gib=peak)


def _margin(logits):
    top2 = torch.topk(logits.float(), 2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


def _rel_rms(a, b):
    """Relative RMS difference ||a - b|| / ||b||."""
    a, b = a.double(), b.double()
    return ((a - b).pow(2).mean() / b.pow(2).mean()).sqrt().item()


def compare_paths(config, mode, g, dev, batch=BATCH, paged=False):
    """Kernel path against plain path on the card at full width and depth
    2, bench.py's shape: prefill logits, then one decode step from the same
    token (its logits, and the greedy head's token). Returns the names of
    the kernels the kernel path launched. ``paged``: ``batch`` prompts
    prefilled into one page each of a slab, copied into a pool of the
    engine's size, and the decode step through the page table.

    On the kernel path every kernel call is also held against its plain
    version on the same inputs (bit-equal; flash attention within
    FLASH_RTOL). End to end, the flash kernels' bf16 roundings (one bf16
    ulp on about a third of the attention outputs) move the quantized
    activations of a random model, the 16-level A4 grid most, so the logits
    are held to LOGIT_RMS[mode] and a greedy token may differ only in a row
    whose plain top-2 margin is at most twice that row's logit error.
    """
    from fastforward_tpu_torch.serving import serving_forward_stacked

    small = dataclasses.replace(config, num_layers=2)
    params, layers = _model(small, mode, g, 1, dev)
    ids = torch.randint(0, small.vocab_size, (batch, PROMPT), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(11))
    label = f"{mode}{' paged' if paged else ''}"

    def run(patches, token=None):
        for p in patches:
            p.start()
        try:
            cache = _new_cache(small, batch, dev, ENGINE_PAGE if paged else SLAB)
            logits, cache = serving_forward_stacked(params, layers, small, ids, cache=cache,
                                                    logits_positions="last")
            if paged:
                cache = _to_pages(cache, small, dev)
            if token is None:
                token = torch.argmax(logits[:, -1], dim=-1).to(ids.dtype)[:, None]
            step_logits, _ = serving_forward_stacked(params, layers, small, token, cache)
            step_tok, _ = serving_forward_stacked(params, layers, small, token, cache,
                                                  greedy_head=True)  # rewrites the same row
        finally:
            for p in patches:
                p.stop()
        return logits, token, step_logits, step_tok

    from fastforward_tpu_torch.kernels import launch_counts, reset_launch_counts

    p_logits, p_first, p_step, p_tok = run(_plain_patches())
    checked = collections.Counter()
    reset_launch_counts()
    k_logits, _, k_step, k_tok = run(_checked_patches(checked), p_first)
    launched = set(launch_counts)
    log(f"serve {label} depth 2: kernel calls held against their plain versions on the same "
        f"inputs: {dict(checked)}; kernels launched {sorted(launched)}")
    k_first = torch.argmax(k_logits[:, -1], dim=-1).to(ids.dtype)[:, None]
    for what, k, p, kt, pt in (("prefill", k_logits, p_logits, k_first[:, 0], p_first[:, 0]),
                               ("decode step", k_step, p_step, k_tok, p_tok)):
        k, p = k[:, -1].float(), p[:, -1].float()
        rms, err = _rel_rms(k, p), (k - p).abs().amax(dim=-1)
        margin = torch.topk(p, 2, dim=-1).values
        margin = margin[:, 0] - margin[:, 1]
        differ = (kt.long() != pt.long()).nonzero().flatten().tolist()
        log(f"serve {label} depth 2 kernel vs plain, {what}: logits relative RMS error {rms:.4g} "
            f"(limit {LOGIT_RMS[mode]}), max err {err.max().item():.4g} of "
            f"{p.abs().max().item():.4g}; {len(differ)} of {len(kt)} greedy tokens differ")
        for b in differ:
            log(f"  row {b}: kernel {int(kt[b])} plain {int(pt[b])}, plain top-2 margin "
                f"{margin[b].item():.4g}, row logit error {err[b].item():.4g}")
        if not rms <= LOGIT_RMS[mode]:
            raise AssertionError(f"{label} {what}: logits of the kernel path differ from the plain path")
        wrong = [b for b in differ if margin[b].item() > 2 * err[b].item()]
        if wrong:
            raise AssertionError(f"{label} {what}: greedy tokens differ where the plain margin "
                                 f"exceeds twice the logit error: rows {wrong}")
    del params, layers
    torch.cuda.empty_cache()
    return launched


def phase_serve(dev):
    from fastforward_tpu_torch.models.llama import LlamaConfig

    config = LlamaConfig.llama3_8b()
    L = config.num_layers
    shared = {"flash_prefill": L, "kv_append": L * STEPS, "flash_decode": L * STEPS,
              "w4a8_gemv": 1 + STEPS}
    runs = {
        "a": serve_run("(a)", config, "w4a4_2l", 512, BATCH, PROMPT, STEPS, dev,
                       {"dequant_vertical": 4 * L, "a4_gemv": 4 * L * STEPS, **shared}),
        "b": serve_run("(b)", config, "w4a8_2l", 128, BATCH, PROMPT, STEPS, dev,
                       {"dequant_paired": 4 * L, "w4a8_gemv_stacked": 4 * L * STEPS, **shared}),
        "c": serve_run("(c)", config, "w4a4_2l", 512, 8, 32, STEPS, dev,
                       {"a4_gemv": 4 * L * (STEPS + 1), **shared}),
    }
    for mode, g, run in (("w4a4_2l", 512, "a"), ("w4a8_2l", 128, "b")):
        launched = compare_paths(config, mode, g, dev)
        if launched != set(runs[run]["counts"]):
            raise AssertionError(f"{mode}: the checked run launched {sorted(launched)}, the main "
                                 f"path {sorted(runs[run]['counts'])}")
    return runs


def _engine_trace(vocab_size):
    """bench.py measure_engine's requests: 2 x 32 prompts, lengths drawn
    from (16, 32, 64, 96) with np.random.RandomState(0)."""
    rng = np.random.RandomState(0)
    trace = []
    for _ in range(2 * ENGINE_SLOTS):
        plen = int(rng.choice(ENGINE_PROMPTS))
        trace.append(rng.randint(0, vocab_size, (plen,)).tolist())
    return trace


def engine_run(label, config, params, layers, trace, dev, paged):
    """bench.py's saturated engine trace, one pass: every request queued up
    front, bursts of 8 until all are done. Launch counts set to 0 just
    before and read just after. Returns (engine, tokens per request, launch
    counts, summary)."""
    from fastforward_tpu_torch.kernels import launch_counts, reset_launch_counts
    from fastforward_tpu_torch.serving import ContinuousBatchingEngine, EngineStats

    kw = dict(paged=True, page_size=ENGINE_PAGE, num_pages=ENGINE_PAGES) if paged else {}
    eng = ContinuousBatchingEngine(config, params, layers, max_batch=ENGINE_SLOTS,
                                   max_len=ENGINE_MAXLEN, device=dev, **kw)
    for plen in ENGINE_PROMPTS:  # warm-up: one request per prompt length, as bench.py
        eng.submit(list(range(1, plen + 1)), max_new_tokens=ENGINE_BURST)
        eng.run_until_complete(burst=ENGINE_BURST)
    eng.stats = EngineStats()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new_tokens=STEPS) for p in trace]
    while eng._pending or eng.num_active:
        eng.step_burst(ENGINE_BURST)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(launch_counts)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    tokens = [eng._done[r].generated for r in rids]
    st = eng.stats
    total = sum(len(t) for t in tokens)
    summary = dict(
        tok_s=total / wall, wall_seconds=wall, peak_gib=peak, occupancy=st.occupancy,
        decode_steps=st.decode_steps, decode_calls=st.decode_calls,
        useful_tokens=st.useful_tokens, overrun_tokens=st.overrun_tokens, prefills=st.prefills,
        prefill_chunks=st.prefill_chunks, admitted=st.admitted,
        preempt_truncated=st.preempt_truncated, preempt_requeued=st.preempt_requeued,
        device_seconds=st.device_seconds, host_fraction=1 - st.device_seconds / wall)
    log(f"engine {label}: {len(trace)} requests, {total} tokens in {wall:.3f} s = "
        f"{total / wall:.1f} tok/s; peak memory {peak:.2f} GiB")
    log(f"engine {label} stats: " + json.dumps({k: v for k, v in summary.items()
                                                if k not in ("tok_s", "peak_gib")}))
    log(f"engine {label}: launches {counts}")
    bad = [i for i, t in enumerate(tokens)
           if len(t) != STEPS or not all(0 <= x < config.vocab_size for x in t)]
    if bad or st.admitted != len(trace):
        raise AssertionError(f"engine {label}: requests {bad[:8]} did not complete in range")
    L = config.num_layers
    decode = ("paged_kv_append", "paged_flash_decode") if paged else ("kv_append", "flash_decode")
    other = ("kv_append", "flash_decode") if paged else ("paged_kv_append", "paged_flash_decode")
    expect = {**{k: L * st.decode_steps for k in decode + ("fused_o_mlp",)},
              **{k: 0 for k in other}, "flash_prefill": L * st.prefills,
              "w4a8_gemv": st.decode_steps + st.prefills}
    wrong = {k: (counts.get(k, 0), v) for k, v in expect.items() if counts.get(k, 0) != v}
    allowed = set(expect) | {"w4a8_gemv_stacked", "dequant_paired"}
    if wrong or not set(counts) <= allowed or counts.get("w4a8_gemv_stacked", 0) < L * st.decode_steps:
        raise AssertionError(f"engine {label}: launch counts (got, expected) {wrong}; {counts}")
    return eng, tokens, counts, summary


def profile_burst(eng, trace):
    """Device-busy share of one 8-step decode burst at 32 live slots."""
    for p in trace[:ENGINE_SLOTS]:
        eng.submit(p, max_new_tokens=ENGINE_BURST + 1)
    eng._admit()
    wall, rows = _profile(lambda: eng._run_burst(ENGINE_BURST), 1)
    busy = sum(r[0] for r in rows)
    _report_profile(f"engine decode burst ({ENGINE_BURST} steps)", wall, rows)
    eng.run_until_complete(burst=ENGINE_BURST)
    return dict(step_wall_ms=wall / ENGINE_BURST, step_busy_ms=busy / ENGINE_BURST,
                busy_share=busy / wall)


def phase_engine(dev):
    """The continuous-batching engine on bench.py's engine workload: paged,
    then the same trace on the slab (the same tokens), then the depth-2
    paged decode held against the plain path."""
    from fastforward_tpu_torch.models.llama import LlamaConfig

    config = LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    params, layers = _model(config, "w4a8_2l", 128, 0, dev)
    torch.cuda.synchronize()
    log(f"engine: Llama-3-8B w4a8_2l g128, {config.num_layers} layers, weights on the card in "
        f"{time.perf_counter() - t0:.1f} s; {ENGINE_SLOTS} slots, max_len {ENGINE_MAXLEN}, "
        f"{ENGINE_PAGES} pages of {ENGINE_PAGE}")
    trace = _engine_trace(config.vocab_size)
    eng, paged_tokens, counts, paged = engine_run("paged", config, params, layers, trace, dev,
                                                  paged=True)
    paged["burst"] = profile_burst(eng, trace)
    b = paged["burst"]
    log(f"engine paged decode step: wall {b['step_wall_ms']:.2f} ms, device busy "
        f"{b['step_busy_ms']:.3f} ms ({100 * b['busy_share']:.1f}%)")
    del eng
    torch.cuda.empty_cache()
    eng, slab_tokens, slab_counts, slab = engine_run("slab", config, params, layers, trace, dev,
                                                     paged=False)
    slab["burst"] = profile_burst(eng, trace)
    b = slab["burst"]
    log(f"engine slab decode step: wall {b['step_wall_ms']:.2f} ms, device busy "
        f"{b['step_busy_ms']:.3f} ms ({100 * b['busy_share']:.1f}%)")
    del eng
    differ = [i for i, (a, c) in enumerate(zip(paged_tokens, slab_tokens)) if a != c]
    log(f"engine: paged vs slab tokens, {len(trace) - len(differ)} of {len(trace)} requests "
        f"identical")
    if differ:
        raise AssertionError(f"engine: paged and slab tokens differ in requests {differ[:8]}")
    del params, layers
    torch.cuda.empty_cache()
    launched = compare_paths(config, "w4a8_2l", 128, dev, batch=ENGINE_SLOTS, paged=True)
    if launched != set(counts):
        raise AssertionError(f"paged: the checked run launched {sorted(launched)}, the engine "
                             f"{sorted(counts)}")
    return dict(counts=counts, paged=paged, slab=slab, slab_counts=slab_counts)


SOURCES = {
    "a4_gemv": ("fastforward_tpu_torch/csrc/a4_gemv.cu",
                "fastforward_tpu/kernels/matmul.py:1406"),
    "w4a8_gemv": ("fastforward_tpu_torch/csrc/w4a8_gemv.cu",
                  "fastforward_tpu/kernels/matmul.py:708 (and :571)"),
    "kv_append": ("fastforward_tpu_torch/csrc/kv_append.cu",
                  "fastforward_tpu/kernels/kv_update.py:100"),
    "flash_decode": ("fastforward_tpu_torch/csrc/flash_decode.cu",
                     "fastforward_tpu/kernels/attention.py:635 (and :271)"),
    "dequant_vertical": ("fastforward_tpu_torch/csrc/dequant.cu",
                         "fastforward_tpu/kernels/matmul.py:1736"),
    "dequant_paired": ("fastforward_tpu_torch/csrc/dequant.cu",
                       "fastforward_tpu/kernels/matmul.py:1650"),
    "w4a8_gemv_stacked": ("fastforward_tpu_torch/csrc/w4a8_gemv.cu",
                          "fastforward_tpu/kernels/matmul.py:1023"),
    "flash_prefill": ("fastforward_tpu_torch/csrc/flash_prefill.cu",
                      "fastforward_tpu/kernels/attention.py:971"),
    "paged_kv_append": ("fastforward_tpu_torch/csrc/kv_append.cu",
                        "fastforward_tpu/kernels/paged_attention.py:293"),
    "paged_flash_decode": ("fastforward_tpu_torch/csrc/flash_decode.cu",
                           "fastforward_tpu/kernels/paged_attention.py:156"),
    "fused_o_mlp": ("fastforward_tpu_torch/csrc/fused_tail.cu",
                    "fastforward_tpu/kernels/matmul.py:2298"),
}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import fastforward_tpu_torch  # noqa: F401  (fails outside the repository)

    out_dir = sys.argv[sys.argv.index("--out") + 1] if "--out" in sys.argv else None
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "unknown"
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; {card}")
    t_all = time.perf_counter()
    phase_build()
    rows = phase_kernels(dev)
    runs = phase_serve(dev)
    runs["engine"] = phase_engine(dev)
    log(f"total {time.perf_counter() - t_all:.1f} s")
    kernels = []
    for name, (src, replaces) in SOURCES.items():
        r = rows[name]
        launches = (runs["a"]["counts"].get(name) or runs["b"]["counts"].get(name)
                    or runs["engine"]["counts"].get(name, 0))
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces, launches=launches,
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=max(r["bytes_ms"], r["ops_ms"]),
            bound_by="bytes" if r["bytes_ms"] >= r["ops_ms"] else "operations",
            library_ms=r["library_ms"],
        ))
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "chip_smoke.log"), "w") as f:
            f.write("\n".join(_LOG + [json.dumps({"kernels": kernels, "runs": runs})]) + "\n")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
