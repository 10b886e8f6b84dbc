"""GPU smoke run of the PyTorch/CUDA port (`fastforward_tpu_torch`).

    python3 chip_smoke.py [--out DIR]

Needs one NVIDIA GPU (built for the H100, sm_90a) and nvcc. Three phases,
each raising on failure:

1. build  — compile every CUDA kernel of the port from `csrc/` (one nvcc
   per source, in parallel) and print the build time;
2. kernels — run each kernel and its plain PyTorch version on the card at
   the Llama-3-8B shapes of the serving phase and hold them together
   (GEMVs, argmax ids, the dequant and the KV append bit-equal; flash
   decode and flash prefill within rtol 8e-3 of the largest output);
   print median times, device times and bounds;
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
   kernel path is compared with the plain path on the card.

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

PROJ = {"qkv": (4096, 6144), "o": (4096, 4096), "gate_up": (4096, 28672),
        "down": (14336, 4096)}   # (K, N) of one fused Llama-3-8B layer
BATCH, PROMPT, STEPS, SLAB = 192, 128, 32, 512   # bench.py's shape

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
    return rows


def _plain_versions():
    """(patch target, plain version, check) of every kernel wrapper the
    serving path calls, under the name that `engine`/`stacked` import."""
    from fastforward_tpu_torch.kernels import attention as att
    from fastforward_tpu_torch.kernels import kv_update as kvu
    from fastforward_tpu_torch.kernels import matmul as mm
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
            if _check is None:  # the KV append writes in place: the plain version
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


def _new_cache(config, B, dev):
    from fastforward_tpu_torch.serving import StackedKVCache

    return StackedKVCache.create(config.num_layers, B, SLAB, config.num_kv_heads,
                                 config.head_dim, device=dev)


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
                "flash_prefill_kernel")


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


def compare_paths(config, mode, g, dev):
    """Kernel path against plain path on the card at full width and depth
    2, bench.py's shape: prefill logits, then one decode step from the same
    token (its logits, and the greedy head's token). Returns the names of
    the kernels the kernel path launched.

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
    ids = torch.randint(0, small.vocab_size, (BATCH, PROMPT), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(11))

    def run(patches, token=None):
        for p in patches:
            p.start()
        try:
            cache = _new_cache(small, BATCH, dev)
            logits, cache = serving_forward_stacked(params, layers, small, ids, cache=cache,
                                                    logits_positions="last")
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
    log(f"serve {mode} depth 2: kernel calls held against their plain versions on the same "
        f"inputs: {dict(checked)}; kernels launched {sorted(launched)}")
    k_first = torch.argmax(k_logits[:, -1], dim=-1).to(ids.dtype)[:, None]
    for what, k, p, kt, pt in (("prefill", k_logits, p_logits, k_first[:, 0], p_first[:, 0]),
                               ("decode step", k_step, p_step, k_tok, p_tok)):
        k, p = k[:, -1].float(), p[:, -1].float()
        rms, err = _rel_rms(k, p), (k - p).abs().amax(dim=-1)
        margin = torch.topk(p, 2, dim=-1).values
        margin = margin[:, 0] - margin[:, 1]
        differ = (kt.long() != pt.long()).nonzero().flatten().tolist()
        log(f"serve {mode} depth 2 kernel vs plain, {what}: logits relative RMS error {rms:.4g} "
            f"(limit {LOGIT_RMS[mode]}), max err {err.max().item():.4g} of "
            f"{p.abs().max().item():.4g}; {len(differ)} of {len(kt)} greedy tokens differ")
        for b in differ:
            log(f"  row {b}: kernel {int(kt[b])} plain {int(pt[b])}, plain top-2 margin "
                f"{margin[b].item():.4g}, row logit error {err[b].item():.4g}")
        if not rms <= LOGIT_RMS[mode]:
            raise AssertionError(f"{mode} {what}: logits of the kernel path differ from the plain path")
        wrong = [b for b in differ if margin[b].item() > 2 * err[b].item()]
        if wrong:
            raise AssertionError(f"{mode} {what}: greedy tokens differ where the plain margin "
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
    log(f"total {time.perf_counter() - t_all:.1f} s")
    kernels = []
    for name, (src, replaces) in SOURCES.items():
        r = rows[name]
        launches = runs["a"]["counts"].get(name) or runs["b"]["counts"].get(name, 0)
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
