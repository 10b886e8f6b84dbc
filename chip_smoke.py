"""GPU smoke run of the PyTorch/CUDA port (`fastforward_tpu_torch`).

    python3 chip_smoke.py

Needs one NVIDIA GPU (built for the H100, sm_90a) and nvcc. Three phases,
each raising on failure:

1. build  — compile every CUDA kernel of the port from `csrc/` (one nvcc
   per source, in parallel) and print the build time;
2. kernels — run each kernel and its plain PyTorch version on the card at
   the Llama-3-8B shapes of the serving phase and hold them together
   (GEMV outputs, argmax ids and the KV append bit-equal; flash decode
   within rtol 8e-3 of the largest output); print median times;
3. serve  — Llama-3-8B at full width and depth (32 layers), W4A4 at group
   512 with a W4A8 lm_head, random weights from the port's own
   `random_stacked_params`: 8 requests of 32-token prompts, then 32
   greedy tokens each on a 512-token INT8 KV slab. Asserts the launch
   count of every kernel, then compares the kernel path with the plain
   path on the card at depth 2.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. Exits non-zero, printing no
result, when CUDA is absent or the package cannot be imported.
"""

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from unittest import mock

import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
INT8_OPS_PER_S = 1979e12       # H100 SXM dense int8
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
FLASH_RTOL = 8e-3              # one bf16 ulp, relative to the largest output


def log(*args):
    print(*args, flush=True)


def median_ms(fn, n=20):
    """Median device time of ``fn`` over ``n`` runs (CUDA events, synchronized)."""
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


def device_ms(fn, n=20):
    """Kernel time on the card per call of ``fn`` (torch.profiler, CUDA
    activity only: the sum of the device time of every kernel launched),
    or None when the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total_us = sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages())
    return total_us / n / 1e3 if total_us > 0 else None


def fmt_ms(v):
    return "not measured" if v is None else f"{v:.4f} ms"


def max_err(a, b):
    """Largest absolute difference of two tensors (0.0 when bit-equal and finite)."""
    return (a.double() - b.double()).abs().max().item()


def bound(nbytes, ops, ops_per_s):
    """(bytes ms, operations ms): the least time for the bytes at the
    memory rate and for the operations at the peak rate of their type."""
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / ops_per_s


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

    def randint(lo, hi, shape, dtype):
        return torch.randint(lo, hi, shape, generator=gen, dtype=dtype, device=dev)

    # --- A4 GEMV: the four projections of a Llama-3-8B layer, stacked L=2, layer 1
    g, L = 512, 2
    shapes = {"qkv": (4096, 6144), "o": (4096, 4096), "gate_up": (4096, 28672),
              "down": (14336, 4096)}
    decode_sum = dict(ms=0.0, plain_ms=0.0, bytes_ms=0.0, ops_ms=0.0, max_abs_err=0.0)
    for M in (8, 256):
        for pname, (K, N) in shapes.items():
            w = randint(-128, 128, (L, K // 2, N), torch.int8)
            mult = randint(1, 16, (L, K // g, N), torch.int8)
            mp = pack_mult_nibbles(mult).contiguous()
            s_col = (torch.rand((L, N), generator=gen, device=dev) * 1e-3).contiguous()
            x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
            x_q, x_s = mm.quantize_rowwise_a4(x)
            kern = lambda: mm.matmul_w4a4_2l_gemv_stacked(x_q, x_s, w, mp, s_col, 1, group_size=g)
            plain = lambda: mm.matmul_w4a4_2l_reference(
                x_q, x_s, w[1], unpack_mult_nibbles(mp[1], K // g), s_col[1], None, g)
            out, ref = kern(), plain()
            torch.cuda.synchronize()
            decode_sum["max_abs_err"] = max(decode_sum["max_abs_err"], max_err(out, ref))
            if not torch.equal(out, ref):
                raise AssertionError(f"a4_gemv {pname} M={M}: not bit-equal "
                                     f"(max err {max_err(out, ref)})")
            ms, pms, dms = median_ms(kern), median_ms(plain), device_ms(kern)
            nbytes = K * N // 2 + mp[1].numel() * 4 + N * 4 + M * K + M * 4 + M * N * 2
            bb, bo = bound(nbytes, 2 * M * K * N, INT8_OPS_PER_S)
            log(f"a4_gemv {pname:8s} M={M:3d} K={K} N={N}: {ms:.4f} ms, device {fmt_ms(dms)} (plain {pms:.3f} ms, "
                f"bound {max(bb, bo):.4f} ms), bit-equal")
            if M == 8:  # the JSON line reports one decode layer: the four projections
                for key, val in (("ms", ms), ("plain_ms", pms), ("bytes_ms", bb), ("ops_ms", bo)):
                    decode_sum[key] += val
    rows["a4_gemv"] = decode_sum

    # --- W4A8 two-level lm_head, paired, N = 128256, with and without argmax
    K, N, M = 4096, 128256, 8
    w = randint(-128, 128, (K // 2, N), torch.int8)
    mult = randint(1, 16, (K // g, N), torch.int8)
    s_col = torch.rand((N,), generator=gen, device=dev) * 1e-3
    x_q, x_s = mm.quantize_rowwise(torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16))
    nbytes = K * N // 2 + K // g * N + N * 4 + M * K + M * 4
    w4a8_err = 0.0
    for out_dtype in (torch.float32, torch.bfloat16):
        kern = lambda: mm.matmul_w4a8_2l_gemv(x_q, x_s, w, mult, s_col, g, out_dtype, paired=True)
        plain = lambda: mm.matmul_w4a8_2l_reference(x_q, x_s, w, mult, s_col, None, g, out_dtype,
                                                   paired=True)
        out, ref = kern(), plain()
        torch.cuda.synchronize()
        w4a8_err = max(w4a8_err, max_err(out, ref))
        if not torch.equal(out, ref):
            raise AssertionError(f"w4a8_gemv {out_dtype}: not bit-equal")
        ms, pms, dms = median_ms(kern), median_ms(plain), device_ms(kern)
        bb, bo = bound(nbytes + M * N * out.element_size(), 2 * M * K * N, INT8_OPS_PER_S)
        log(f"w4a8_gemv lm_head {out_dtype} M={M}: {ms:.4f} ms, device {fmt_ms(dms)} (plain {pms:.3f} ms, "
            f"bound {max(bb, bo):.4f} ms), bit-equal")
    kern = lambda: mm.matmul_w4a8_2l_gemv_argmax(x_q, x_s, w, mult, s_col, g, paired=True)
    plain = lambda: torch.argmax(mm.matmul_w4a8_2l_reference(
        x_q, x_s, w, mult, s_col, None, g, torch.float32, paired=True), dim=-1).to(torch.int32)
    ids, ref = kern(), plain()
    torch.cuda.synchronize()
    if not torch.equal(ids, ref):
        raise AssertionError(f"w4a8_gemv argmax ids differ: {ids.tolist()} vs {ref.tolist()}")
    ms, pms, dms = median_ms(kern), median_ms(plain), device_ms(kern)
    bb, bo = bound(nbytes + M * 4, 2 * M * K * N, INT8_OPS_PER_S)
    log(f"w4a8_gemv lm_head argmax M={M}: {ms:.4f} ms, device {fmt_ms(dms)} (plain {pms:.3f} ms, "
        f"bound {max(bb, bo):.4f} ms), ids equal")
    rows["w4a8_gemv"] = dict(ms=ms, plain_ms=pms, bytes_ms=bb, ops_ms=bo,
                             max_abs_err=max(w4a8_err, max_err(ids, ref)))

    # --- KV append and flash decode: B=8, Hkv=8, G=4, d=128, S=512, L=2, layer 1
    B, Hkv, G, d, S = 8, 8, 4, 128, 512
    H = Hkv * G
    kc = randint(-128, 128, (L, B, Hkv, S, d), torch.int8)
    vc = randint(-128, 128, (L, B, Hkv, S, d), torch.int8)
    ks = torch.rand((L, B, Hkv, S), generator=gen, device=dev) * 0.05
    vs = torch.rand((L, B, Hkv, S), generator=gen, device=dev) * 0.05
    kn = randint(-128, 128, (B, Hkv, 1, d), torch.int8)
    vn = randint(-128, 128, (B, Hkv, 1, d), torch.int8)
    ksn = torch.rand((B, Hkv, 1), generator=gen, device=dev)
    vsn = torch.rand((B, Hkv, 1), generator=gen, device=dev)
    lengths = torch.randint(1, 301, (B,), generator=gen, device=dev, dtype=torch.int32)
    lengths[0], lengths[1] = 1, 300
    starts = (lengths - 1).contiguous()
    bufs = [t.clone() for t in (kc, vc, ks, vs)]
    ref = kvu.kv_append_decode_stacked_reference(
        *[t.clone() for t in (kc, vc, ks, vs)], kn, vn, ksn, vsn, starts, 1)
    out = kvu.kv_append_decode_int8_stacked(*bufs, kn, vn, ksn, vsn, starts, 1)
    torch.cuda.synchronize()
    append_err = max(max_err(a, r) for a, r in zip(out, ref))
    if not all(torch.equal(a, r) for a, r in zip(out, ref)):
        raise AssertionError("kv_append: not bit-equal to the reference")
    kern = lambda: kvu.kv_append_decode_int8_stacked(*bufs, kn, vn, ksn, vsn, starts, 1)
    ms, dms = median_ms(kern), device_ms(kern)
    pms = median_ms(lambda: kvu.kv_append_decode_stacked_reference(
        *bufs, kn, vn, ksn, vsn, starts, 1))
    bb, bo = bound(2 * 2 * B * Hkv * (d + 4) + B * 4, 0, INT8_OPS_PER_S)
    log(f"kv_append B={B} Hkv={Hkv} d={d} S={S}: {ms:.4f} ms, device {fmt_ms(dms)} (plain {pms:.3f} ms, "
        f"bound {max(bb, bo):.5f} ms), bit-equal")
    rows["kv_append"] = dict(ms=ms, plain_ms=pms, bytes_ms=bb, ops_ms=bo, max_abs_err=append_err)

    q = torch.randn((B, H, d), generator=gen, device=dev).to(torch.bfloat16)
    kern = lambda: att.flash_decode_int8_stacked(q, kc, ks, vc, vs, lengths, 1)
    plain = lambda: att.flash_decode_int8_reference(q, kc[1], ks[1], vc[1], vs[1], lengths)
    out, ref = kern(), plain()
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    if not err <= FLASH_RTOL * scale:
        raise AssertionError(f"flash_decode: max err {err} > {FLASH_RTOL} x {scale}")
    ms, pms, dms = median_ms(kern), median_ms(plain), device_ms(kern)
    live = int(lengths.sum().item())
    bb, bo = bound(live * Hkv * 2 * (d + 4) + 2 * B * H * d * 2 + B * 4,
                   4 * live * G * d * Hkv, F32_OPS_PER_S)
    # yardstick only: SDPA over the same cache dequantized to bf16 beforehand
    kd = (kc[1].float() * ks[1][..., None]).to(torch.bfloat16)
    vd = (vc[1].float() * vs[1][..., None]).to(torch.bfloat16)
    amask = (torch.arange(S, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
    lib = median_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q[:, :, None, :], kd, vd, attn_mask=amask, enable_gqa=True))
    log(f"flash_decode B={B} H={H} Hkv={Hkv} d={d} S={S} lengths 1..300: {ms:.4f} ms, device {fmt_ms(dms)} "
        f"(plain {pms:.3f} ms, bound {max(bb, bo):.5f} ms, sdpa on dequantized bf16 "
        f"{lib:.4f} ms), max err {err:.3g} of {scale:.3g}")
    rows["flash_decode"] = dict(ms=ms, plain_ms=pms, bytes_ms=bb, ops_ms=bo, max_abs_err=err,
                                library_ms=lib)
    return rows


def _plain_patches():
    """Swap every kernel wrapper the serving path calls for its plain
    PyTorch version, for the comparison run on the card."""
    from fastforward_tpu_torch.kernels import attention as att
    from fastforward_tpu_torch.kernels import kv_update as kvu
    from fastforward_tpu_torch.kernels import matmul as mm
    from fastforward_tpu_torch.kernels.packing import unpack_mult_nibbles

    def a4(x_q, x_s, w, mp, s_col, layer, group_size, out_dtype=torch.bfloat16):
        n_groups = x_q.shape[1] // group_size
        return mm.matmul_w4a4_2l_reference(
            x_q, x_s, w[layer], unpack_mult_nibbles(mp[layer], n_groups), s_col[layer], None,
            group_size, out_dtype)

    def w4a8(x_q, x_s, w, mult, s_col, group_size, out_dtype, paired):
        return mm.matmul_w4a8_2l_reference(x_q, x_s, w, mult, s_col, None, group_size,
                                           out_dtype, paired=paired)

    def argmax(x_q, x_s, w, mult, s_col, group_size, paired):
        return torch.argmax(w4a8(x_q, x_s, w, mult, s_col, group_size, torch.float32, paired),
                            dim=-1).to(torch.int32)

    def flash(q, k, ks, v, vs, lengths, layer):
        return att.flash_decode_int8_reference(q, k[layer], ks[layer], v[layer], vs[layer], lengths)

    return [
        mock.patch("fastforward_tpu_torch.serving.engine.matmul_w4a4_2l_gemv_stacked", a4),
        mock.patch("fastforward_tpu_torch.serving.engine.matmul_w4a8_2l_gemv", w4a8),
        mock.patch("fastforward_tpu_torch.serving.stacked.matmul_w4a8_2l_gemv_argmax", argmax),
        mock.patch("fastforward_tpu_torch.serving.stacked.kv_append_decode_int8_stacked",
                   kvu.kv_append_decode_stacked_reference),
        mock.patch("fastforward_tpu_torch.serving.stacked.flash_decode_int8_stacked", flash),
    ]


def _serve(config, params, layers, ids, steps, S, dev):
    from fastforward_tpu_torch.serving import (
        StackedKVCache,
        make_stacked_decode_loop,
        serving_forward_stacked,
    )

    B = ids.shape[0]
    cache = StackedKVCache.create(config.num_layers, B, S, config.num_kv_heads,
                                  config.head_dim, device=dev)
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
                "kv_append_kernel", "flash_decode_kernel")


def profile_decode_step(config, params, layers, cache, token, dev, n=3):
    """Device time of one decode step by kernel name, and the device's busy
    share of the step's wall time (torch.profiler over ``n`` steps)."""
    from torch.profiler import ProfilerActivity, profile

    from fastforward_tpu_torch.serving import serving_forward_stacked

    cache.length -= n  # rewrite the last n rows: the slab keeps its size
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            tok, cache = serving_forward_stacked(params, layers, config, token, cache,
                                                 greedy_head=True)
            token = tok.to(token.dtype)[:, None]
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    rows = [(getattr(e, "self_device_time_total", 0) / n / 1e3, e.count // n, e.key)
            for e in prof.key_averages()]
    rows = sorted((r for r in rows if r[0] > 0), reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"decode step (profiled): wall {wall_ms:.2f} ms, device busy {busy:.3f} ms "
        f"({100 * busy / wall_ms:.1f}%), {sum(r[1] for r in rows)} kernels")
    ours = sum(r[0] for r in rows if any(k in r[2] for k in PORT_KERNELS))
    log(f"  port kernels {ours:.3f} ms, PyTorch glue kernels {busy - ours:.3f} ms per step")
    for ms, count, name in rows[:12]:
        log(f"  {ms:8.4f} ms  x{count:5d}  {name[:90]}")


def phase_serve(dev):
    from fastforward_tpu_torch.kernels import launch_counts, reset_launch_counts
    from fastforward_tpu_torch.models.llama import LlamaConfig
    from fastforward_tpu_torch.serving import fuse_stacked_layers, random_stacked_params

    B, T, steps, S, g = 8, 32, 32, 512, 512
    config = LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    params, layers = random_stacked_params(config, mode="w4a4_2l", group_size=g, seed=0, device=dev)
    layers = fuse_stacked_layers(layers)
    torch.cuda.synchronize()
    log(f"serve: Llama-3-8B W4A4 g{g} weights on the card in {time.perf_counter() - t0:.1f} s")
    ids = torch.randint(0, config.vocab_size, (B, T), generator=torch.Generator(device=dev).manual_seed(7),
                        device=dev)

    # warm-up at the same shapes, so the measured run holds no first-call costs
    _serve(config, params, layers, ids, 2, S, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    logits, first, tokens, cache, prefill_ms, decode_s = _serve(config, params, layers, ids, steps, S, dev)
    counts = dict(launch_counts)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    L = config.num_layers
    expect = {"a4_gemv": 4 * L * (steps + 1), "kv_append": L * steps,
              "flash_decode": L * steps, "w4a8_gemv": 1 + steps}
    log(f"serve: prefill {B}x{T} {prefill_ms:.1f} ms; decode {B}x{steps} tokens in "
        f"{decode_s:.3f} s = {B * steps / decode_s:.1f} tok/s; peak memory {peak:.2f} GiB")
    log(f"serve: launches {counts}")
    if counts != expect:
        raise AssertionError(f"launch counts {counts} != expected {expect}")
    if tuple(logits.shape) != (B, 1, config.vocab_size) or not torch.isfinite(logits).all():
        raise AssertionError("prefill logits are not finite (B, 1, vocab)")
    if tuple(tokens.shape) != (B, steps) or not ((tokens >= 0) & (tokens < config.vocab_size)).all():
        raise AssertionError(f"decoded tokens out of range: {tokens.shape}")
    if cache.length != T + steps:
        raise AssertionError(f"cache length {cache.length} != {T + steps}")
    profile_decode_step(config, params, layers, cache, tokens[:, -1:], dev)
    del params, layers, cache

    # kernel path against the plain path on the card, full width, depth 2
    small = dataclasses.replace(config, num_layers=2)
    params, layers = random_stacked_params(small, mode="w4a4_2l", group_size=g, seed=1, device=dev)
    layers = fuse_stacked_layers(layers)
    k_logits, k_first, k_tok, _, _, _ = _serve(small, params, layers, ids, 1, S, dev)
    patches = _plain_patches()
    for p in patches:
        p.start()
    try:
        p_logits, p_first, p_tok, _, _, _ = _serve(small, params, layers, ids, 1, S, dev)
    finally:
        for p in patches:
            p.stop()
    err = (k_logits - p_logits).abs().max().item()
    log(f"serve: depth-2 kernel vs plain: prefill logits max err {err:.3g}, first tokens "
        f"{k_first[:, 0].tolist()} vs {p_first[:, 0].tolist()}, next {k_tok[:, 0].tolist()} "
        f"vs {p_tok[:, 0].tolist()}")
    if err != 0.0:
        raise AssertionError("prefill logits of the kernel path differ from the plain path")
    if not torch.equal(k_first, p_first) or not torch.equal(k_tok, p_tok):
        raise AssertionError("greedy tokens of the kernel path differ from the plain path")
    return counts


SOURCES = {
    "a4_gemv": ("fastforward_tpu_torch/csrc/a4_gemv.cu",
                "fastforward_tpu/kernels/matmul.py:1406"),
    "w4a8_gemv": ("fastforward_tpu_torch/csrc/w4a8_gemv.cu",
                  "fastforward_tpu/kernels/matmul.py:708 (and :571)"),
    "kv_append": ("fastforward_tpu_torch/csrc/kv_append.cu",
                  "fastforward_tpu/kernels/kv_update.py:100"),
    "flash_decode": ("fastforward_tpu_torch/csrc/flash_decode.cu",
                     "fastforward_tpu/kernels/attention.py:635 (and :271)"),
}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import fastforward_tpu_torch  # noqa: F401  (fails outside the repository)

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "unknown"
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t_all = time.perf_counter()
    phase_build()
    rows = phase_kernels(dev)
    counts = phase_serve(dev)
    log(f"total {time.perf_counter() - t_all:.1f} s")
    kernels = []
    for name, (src, replaces) in SOURCES.items():
        r = rows[name]
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=counts.get(name, 0), max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=max(r["bytes_ms"], r["ops_ms"]),
            bound_by="bytes" if r["bytes_ms"] >= r["ops_ms"] else "operations",
            library_ms=r.get("library_ms"),
        ))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
