"""A/B of the two-level int4 GEMVs and the INT8 flash decode between two
checkouts, on one card.

    python3 fastforward_tpu_torch/scripts/ab_two_level.py TREE TAG [--serve | --serve-only]
        [--splits] [--out DIR]
    python3 fastforward_tpu_torch/scripts/ab_two_level.py TREE TAG --groups [--serve] [--out DIR]
    python3 fastforward_tpu_torch/scripts/ab_two_level.py TREE TAG --any [--serve] [--out DIR]
    python3 fastforward_tpu_torch/scripts/ab_two_level.py --compare A B [--out DIR]

Run it as a file, not with ``-m``: it imports ``chip_smoke`` and
``fastforward_tpu_torch`` from the checkout TREE (e.g. the parent commit
unpacked with ``git archive`` into a git-ignored directory), builds its
kernels there, and prints the device time (``torch.profiler``, 30 calls,
from a profile that recorded every launch of them: `device_ms`) of row 5
(the two-level W4A8 GEMV: the paired lm_head at g512, M = 192 and 8, f32;
the unpaired lm_head at g128, f32, and the seven unfused projections of a
Llama-3-8B layer, bf16), row 4 (the argmax lm_head, paired g512, M = 192
and 8), row 9 (the stacked W4A8 GEMV over the four fused projections at
g128, M = 192 and 8, by each route: flat, pre-blocked in 512-column
panels, split-W, dot-raw, concat-pairs at 4 pairs a unit, and the manual
stream at nbuf 2 and 4), row 1 (the A4 GEMV over the four fused
projections at g512, M = 192 and 8), row 3 (stacked INT8 flash decode,
Hkv 8, G 4, layer 1 of 2 of a 512-token slab: B = 192 at lengths 129-160,
bench.py's decode, and B = 8 at 33-64, run (c)'s), row 20 (the per-layer
form at B = 192) and row 22 (paged flash decode at the engine's decode:
B = 32, 39 pages of 256 tokens, lengths 17-160 and two rows of 300 and
512), row 12 (the fused A4 layer head, K 4096, N 6144, g512, M = 192, 64
and 8) and row 13 (the fused W4A8 head, g128, M = 192, 64 and 8), row 17
(the W4 GEMV over the four fused projections, g128, M = 192 and 8, with
its caller-visible median; and on the lm_head, f32 out, M = 192) and row
18t (the tiled W4A16 GEMM over the four fused projections, g128, M = 192
x 128 = 24,576, bf16 out), and rows 10 (the fused W4A8 layer tail, M =
8, 32 and 64) and 11 (its o + gate/up head, M = 192, 64 and 8) at the 8B
widths, g128, layer 1 of 2, each with its caller-visible median, their
outputs (y or gu, x1, the int8 activations and their scales) saved under
DIR; and rows 19 (the W8A8 GEMM) and 16 (the float-scale W4A8 GEMV) over
the four projections at M = 192 and 8, g128, and on the f32 lm_head at M
= 192, row 19 also at the prefill's M = 24,576, with caller-visible
medians (the prefill's device time only) and their outputs saved (the
prefill's as an exact digest); row 7 (flash prefill, int8 and bf16 K/V,
Hkv 8, G 4, a 512-token slab: bench.py's prefill, B = 192, T = 128,
starts 0, and a ragged chunk, B = 16, T = 77, starts 0-300) with its
caller-visible median; the prefill dequant over the four projections,
rows 15 (group halves g128), 14 (paired g128), 14p (the same pre-blocked
at bn 512) and 8 (vertical g512); and the device time of the yardstick of
rows 19 and 16, one torch._int_mm on a K-major int8 weight (four
projections and the lm_head, M = 192); each line tagged TAG. Inputs come from one
seed, so two trees time the same integers; run them in turns on one card
(A, B, B, A). ``--serve`` also serves chip_smoke.py's runs (a), (b), (c),
(k), (n), (f), (l), (e), (g) and (h) on their seeds and the engine
workload (d), paged and on the slab, profiles each run's decode step and
prefill (the engine: a decode burst of 8 steps) as chip_smoke.py does
(wall, device busy, kernels launched), and saves the greedy tokens and
prefill logits under DIR (``--serve-only``: that alone, no kernel timed);
``--splits`` times row 17 at each K split of 1-8 (the four projections,
M = 192 and 8), and rows 10 and 11 with their gate/up in one K split and
in two
(default build/ab_two_level). ``--groups`` instead times rows 16, 17 and
18t (the float-scale W4A8 GEMV, the W4 GEMV, the tiled W4A16 GEMM) on
Llama-3-8B's down_proj at g 112 and g 128 (M = 192 and 8) and over the four
projections at g 128 (M = 192 and 8), device and caller-visible ms, and
saves row 16's outputs at every shape and rows 17 and 18t's at g 128 (the
same bits in every tree); with ``--serve`` it then serves runs (e) and
(f) only, their tokens and prefill logits saved. ``--any`` instead times
the two-level GEMVs' any-group route on Llama-3-8B's down_proj at g 14
(1,024 groups; M = 192 and 8): rows 1 (A4, vertical), 5 (paired and
group halves) and 9 (stacked, flat), beside the tile on the same shape
at g 16 (rows 1, 5 paired, 9; with ``--splits`` row 9 at each K split
of 3-16, M = 192, 64, 24 and 8), and the fused routes at the groups
chip_smoke.py's `_fused_any_kernels` uses (the W4A8 head g 2, the A4 head
g 4, the tail and its o + gate/up head g 2; M = 8), device and
caller-visible ms, their outputs saved; with ``--serve`` it then serves
run (ag) only (w4a4_2l and w4a8_2l at g 14), tokens and prefill logits
saved.
``--compare A B`` then says, run by run,
how many greedy tokens differ between the two tags and whether their
prefill logits are bit-equal, and whether rows 10, 11, 19 and 16 gave the
same bits (where both tags timed them), and exits 1 where the tokens, the
logits or those outputs differ. Needs a CUDA
GPU.
"""

import os
import sys
import time

import torch


def _digest(t):
    """An exact int64 digest of a tensor's bytes (each byte times its
    position mod 65,521, plus one, summed in chunks): equal bytes give equal
    digests, and a change of any byte changes it."""
    b = t.contiguous().view(torch.uint8).flatten()
    total = 0
    for i in range(0, b.numel(), 1 << 26):
        c = b[i:i + (1 << 26)].to(torch.int64)
        total += int((c * (torch.arange(i, i + c.numel(), device=c.device) % 65521 + 1)).sum())
    return torch.tensor([total])


def _out_dir():
    i = sys.argv.index("--out") + 1 if "--out" in sys.argv else 0
    return sys.argv[i] if i else os.path.join(os.getcwd(), "build", "ab_two_level")


def compare(a, b):
    same = True
    path = os.path.join(_out_dir(), "{}.pt")
    if all(os.path.exists(path.format(t)) for t in (a, b)):
        ra, rb = (torch.load(path.format(t)) for t in (a, b))
        for run in ra:
            ta, tb = ra[run]["tokens"], rb[run]["tokens"]
            differ = ta != tb
            same = same and not bool(differ.any())
            first = differ.long().argmax(dim=1)[differ.any(dim=1)]
            line = (f"AB ({run}) {a} vs {b}: {int(differ.sum())} of {ta.numel()} greedy tokens "
                    f"differ (in {int(differ.any(dim=1).sum())} of {ta.shape[0]} rows, the "
                    f"earliest at step {int(first.min()) if first.numel() else '-'})")
            if "logits" in ra[run]:  # the engine runs keep tokens only
                logits = torch.equal(ra[run]["logits"], rb[run]["logits"])
                same = same and logits
                line += f", prefill logits {'bit-equal' if logits else 'DIFFER'}"
            print(line)
    tails = [path.format(f"{t}_tail") for t in (a, b)]
    ra, rb = (torch.load(p) for p in tails) if all(map(os.path.exists, tails)) else ({}, {})
    for label in ra:
        equal = [torch.equal(x, y) for x, y in zip(ra[label], rb[label])]
        same = same and all(equal)
        print(f"AB {label} {a} vs {b}: outputs "
              + ("bit-equal" if all(equal) else f"DIFFER (equal by output: {equal})"))
    return 0 if same else 1


def serve_runs(cs, tag, dev, only=None):
    """``--serve``: chip_smoke.py's runs on their seeds (``only``: those
    named, the engine's as "d"; (ag) only where named), profiled, their
    greedy tokens and prefill logits saved under DIR."""
    from fastforward_tpu_torch.models.llama import LlamaConfig

    config = LlamaConfig.llama3_8b()
    record = {}
    for run, mode, g, B, T, kv, flags in [
            ("ag4", "w4a4_2l", 14, cs.BATCH, cs.PROMPT, None, {}),
            ("ag8", "w4a8_2l", 14, cs.BATCH, cs.PROMPT, None, {}),
            ("a", "w4a4_2l", 512, cs.BATCH, cs.PROMPT, None, {}),
            ("b", "w4a8_2l", 128, cs.BATCH, cs.PROMPT, None, {}),
            ("c", "w4a4_2l", 512, 8, 32, None, {}),
            ("k", "w4a4_2l", 512, cs.BATCH, cs.PROMPT, None, cs.FLAGS_K),
            ("n", "w4a8_2l", 128, cs.BATCH, cs.PROMPT, None, cs.FLAGS_N),
            ("f", "w4a16", 128, cs.BATCH, cs.PROMPT, None, {}),
            ("l", "w4a8_2l", 128, cs.BATCH, cs.PROMPT, None, cs.FLAGS_L),
            ("e", "w4a8", 128, cs.BATCH, cs.PROMPT, None, {}),
            ("g", "w8a8", 128, cs.BATCH, cs.PROMPT, None, {}),
            ("h", "w4a8", 128, cs.BATCH, cs.PROMPT, "int8", {})]:
        if run not in (("a", "b", "c", "k", "n", "f", "l", "e", "g", "h") if only is None
                       else only):
            continue
        t0 = time.perf_counter()
        with cs.flag_env(**flags):
            path = cs.ServePath.random(config, mode, g, 0, dev, kv)
            ids = torch.randint(0, config.vocab_size, (B, T), device=dev,
                                generator=torch.Generator(device=dev).manual_seed(7))
            logits, _, tokens, cache, _, _ = cs._serve(path, ids, cs.STEPS, dev)
            record[run] = dict(logits=logits.cpu(), tokens=tokens.cpu())
            print(f"AB[{tag}] ({run}) profiles:", flush=True)
            cs.profile_steps(path, cache, tokens[:, -1:], ids)
            del path, cache, logits
            torch.cuda.empty_cache()
        print(f"AB[{tag}] served ({run}) in {time.perf_counter() - t0:.1f} s", flush=True)
    # (d): bench.py's engine workload, paged and on the slab
    path = cs.ServePath.random(config, "w4a8_2l", 128, 0, dev)
    trace = cs._engine_trace(config.vocab_size)
    for run, paged in ((("d paged", True), ("d slab", False))
                       if only is None or "d" in only else ()):
        t0 = time.perf_counter()
        eng, tokens, _, summary = cs.engine_run(run, config, path.params, path.layers, trace,
                                                dev, paged)
        record[run] = dict(tokens=torch.tensor(tokens))
        print(f"AB[{tag}] ({run}) profile:", flush=True)
        cs.profile_burst(eng, trace)
        del eng
        torch.cuda.empty_cache()
        print(f"AB[{tag}] served ({run}) in {time.perf_counter() - t0:.1f} s, "
              f"{summary['tok_s']:.1f} tok/s", flush=True)
    del path
    os.makedirs(_out_dir(), exist_ok=True)
    torch.save(record, os.path.join(_out_dir(), f"{tag}.pt"))


def any_group(cs, mm, tag, dev, gen, ri, device_ms):
    """``--any``: the any-group route at down_proj g 14 beside the tile at
    g 16, and the fused routes at chip_smoke.py's groups; outputs saved."""
    from fastforward_tpu_torch.kernels.packing import pack_mult_nibbles

    outputs = {}

    def timed(label, fn):
        ms, vis = device_ms(fn), cs.median_ms(fn)
        print(f"AB[{tag}] {label}: device {ms:.4f} ms, caller-visible {vis:.4f} ms", flush=True)
        out = fn()
        outputs[label] = [t.cpu() for t in (out if isinstance(out, tuple) else (out,))
                          if isinstance(t, torch.Tensor)]

    K, N = cs.PROJ["down"]
    for g in (14, 16):
        w, m = ri(-128, 128, (2, K // 2, N)), ri(1, 16, (2, K // g, N))
        mp = pack_mult_nibbles(m).contiguous()
        s = torch.rand((2, N), generator=gen, device=dev) * 1e-3
        if "--splits" in sys.argv and g == 14 and hasattr(mm, "rows_plan"):
            # row 9 at each K split of the any-group route (its plan's marked)
            own = mm.rows_plan
            for M in (cs.BATCH, 64, 24, 8):
                x_q, x_s = mm.quantize_rowwise(torch.randn((M, K), generator=gen, device=dev))
                times = {}
                for split in (3, 4, 5, 6, 8, 9, 12, 16):
                    mm.rows_plan = lambda *a, split=split, **k: own(*a[:5], split, **k)
                    try:
                        times[split] = device_ms(lambda: mm.matmul_w4a8_2l_gemv_stacked(
                            x_q, x_s, w, mp, s, 1, group_size=g))
                    finally:
                        mm.rows_plan = own
                print(f"AB[{tag}] row 9 down g14 M={M} by split (the plan's "
                      f"{own(M, K, N, g, 'paired').n_split}): "
                      + ", ".join(f"{k} {v:.4f}" for k, v in times.items()), flush=True)
        for M in (cs.BATCH, 8):
            x_q, x_s = mm.quantize_rowwise(torch.randn((M, K), generator=gen, device=dev))
            x4, x4s = mm.quantize_rowwise_a4(torch.randn((M, K), generator=gen, device=dev))
            at = f"down g{g} M={M}"
            timed(f"row 1 {at}", lambda: mm.matmul_w4a4_2l_gemv_stacked(x4, x4s, w, mp, s, 1,
                                                                        group_size=g))
            for paired in (True, False) if g == 14 else (True,):
                timed(f"row 5 {'paired' if paired else 'halves'} {at}",
                      lambda: mm.matmul_w4a8_2l_gemv(x_q, x_s, w[1], m[1], s[1], g,
                                                     paired=paired))
            timed(f"row 9 {at}", lambda: mm.matmul_w4a8_2l_gemv_stacked(x_q, x_s, w, mp, s, 1,
                                                                        group_size=g))
        del w, m, mp
        torch.cuda.empty_cache()
    L, eps, M = 2, 1e-5, 8
    K, N = cs.PROJ["qkv"]
    for a4, g in ((False, 2), (True, 4)):
        w, mp = ri(-128, 128, (L, K // 2, N)), pack_mult_nibbles(ri(1, 16, (L, K // g, N)))
        s_col = torch.rand((L, N), generator=gen, device=dev) * 1e-3
        norm = (torch.rand((L, K), generator=gen, device=dev) + 0.5).to(torch.bfloat16)
        x = (torch.randn((M, K), generator=gen, device=dev) * 3).to(torch.bfloat16)
        timed(f"fused {'A4 ' if a4 else ''}head g{g} M={M}",
              lambda: mm._fused_head_launch(a4, x, norm, w, mp.contiguous(), s_col, 1, g, eps,
                                            torch.bfloat16))
        del w, mp
    H, inter, g = 4096, 14336, 2
    ops = []
    for Kp, Np in ((H, H), (H, 2 * inter), (inter, H)):
        ops += [ri(-128, 128, (L, Kp // 2, Np)),
                pack_mult_nibbles(ri(1, 16, (L, Kp // g, Np))).contiguous(),
                torch.rand((L, Np), generator=gen, device=dev) * (4.0 / Kp)]
    norm = (torch.rand((L, H), generator=gen, device=dev) + 0.5).to(torch.bfloat16)
    attn = torch.randn((M, H), generator=gen, device=dev).to(torch.bfloat16)
    x_res = torch.randn((M, H), generator=gen, device=dev).to(torch.bfloat16)
    timed(f"fused tail g{g} M={M}",
          lambda: mm._fused_o_mlp_launch(attn, x_res, norm, *ops, 1, g, eps)[:6])
    timed(f"fused o + gate/up g{g} M={M}",
          lambda: mm._fused_o_gu_launch(attn, x_res, norm, *ops[:6], 1, g, eps)[:4])
    del ops
    os.makedirs(_out_dir(), exist_ok=True)
    torch.save(outputs, os.path.join(_out_dir(), f"{tag}_tail.pt"))


def main():
    if sys.argv[1] == "--compare":
        return compare(sys.argv[2], sys.argv[3])
    if not torch.cuda.is_available():
        print("ab_two_level: CUDA is not available", file=sys.stderr)
        return 2
    tree, tag = os.path.abspath(sys.argv[1]), sys.argv[2]
    sys.path.insert(0, tree)
    import chip_smoke as cs
    from fastforward_tpu_torch.kernels import _build
    from fastforward_tpu_torch.kernels import attention as att
    from fastforward_tpu_torch.kernels import matmul as mm
    from fastforward_tpu_torch.kernels import paged_attention as pa
    from fastforward_tpu_torch.kernels.packing import pack_mult_nibbles

    if not cs.__file__.startswith(tree):
        raise RuntimeError(f"chip_smoke imported from {cs.__file__}, not {tree}")
    _build.build_all()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(99)

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, dtype=torch.int8, device=dev)

    def device_ms(fn, n=30):
        # the tree's profiler wrapper (a parent's may not check launches).
        # One call's launches: the most that single-call profiles recorded,
        # once two agree (CUPTI drops records now and then, a whole
        # profile's at times); an n-call profile that recorded fewer than n
        # times as many is taken again
        fn()
        seen = []
        for _ in range(8):
            seen.append(round(sum(r[1] for r in cs._profile(fn, 1)[1])))
            if max(seen) > 0 and seen.count(max(seen)) >= 2:
                break
        per = max(seen)
        for _ in range(6):
            rows = cs._profile(fn, n)[1]
            if per and round(sum(r[1] for r in rows) * n) >= per * n:
                return sum(r[0] for r in rows)
        raise RuntimeError(f"no profile recorded all {per} launches a call of {n} calls "
                           f"(single-call probes: {seen})")

    def show(label, ms):
        print(f"AB[{tag}] {label}: device {ms:.4f} ms", flush=True)

    if "--serve-only" in sys.argv:
        serve_runs(cs, tag, dev)
        return 0
    if "--any" in sys.argv:
        any_group(cs, mm, tag, dev, gen, ri, device_ms)
        if "--serve" in sys.argv:
            serve_runs(cs, tag, dev, {"ag4", "ag8"})
        return 0
    if "--groups" in sys.argv:
        outputs = {}
        for label, g, shapes in (("down", 112, [cs.PROJ["down"]]), ("down", 128, [cs.PROJ["down"]]),
                                 ("4 projections", 128, list(cs.PROJ.values()))):
            for M in (cs.BATCH, 8):
                totals = {"16": 0.0, "17": 0.0, "18t": 0.0}
                visible = dict(totals)
                for i, (K, N) in enumerate(shapes):
                    w = ri(-128, 128, (K // 2, N))
                    s = torch.rand((K // g, N), generator=gen, device=dev) * (0.5 / K ** 0.5) + 1e-4
                    x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
                    x_q, x_s = mm.quantize_rowwise(x)
                    for row, fn in (("16", lambda: mm.matmul_w4a8_gemv(x_q, x_s, w, s, g)),
                                    ("17", lambda: mm.matmul_w4_gemv(x, w, s, g)),
                                    ("18t", lambda: mm.matmul_w4a16_tiled(x, w, s, None, g))):
                        totals[row] += device_ms(fn)
                        visible[row] += cs.median_ms(fn)
                        if row == "16" or g == 128:
                            outputs[f"row {row} {label} g{g} M={M} #{i}"] = [fn().cpu()]
                    del w, s, x
                    torch.cuda.empty_cache()
                for row in totals:
                    print(f"AB[{tag}] row {row} {label} g{g} M={M}: device {totals[row]:.4f} ms, "
                          f"caller-visible {visible[row]:.4f} ms", flush=True)
        os.makedirs(_out_dir(), exist_ok=True)
        torch.save(outputs, os.path.join(_out_dir(), f"{tag}_tail.pt"))
        if "--serve" in sys.argv:
            serve_runs(cs, tag, dev, {"e", "f"})
        return 0

    with cs.flag_env():
        K, N = 4096, cs.VOCAB
        w, m = ri(-128, 128, (K // 2, N)), ri(1, 16, (K // 512, N))
        s = torch.rand((N,), generator=gen, device=dev) * 1e-3
        for M in (cs.BATCH, 8):
            x_q, x_s = mm.quantize_rowwise(torch.randn((M, K), generator=gen, device=dev))
            show(f"row 5 paired lm_head g512 f32 M={M}", device_ms(
                lambda: mm.matmul_w4a8_2l_gemv(x_q, x_s, w, m, s, 512, torch.float32,
                                               paired=True)))
            show(f"row 4 argmax lm_head g512 M={M}", device_ms(
                lambda: mm.matmul_w4a8_2l_gemv_argmax(x_q, x_s, w, m, s, 512, paired=True)))
        m = ri(1, 16, (K // 128, N))
        x_q, x_s = mm.quantize_rowwise(torch.randn((cs.BATCH, K), generator=gen, device=dev))
        show(f"row 5 unpaired lm_head g128 f32 M={cs.BATCH}", device_ms(
            lambda: mm.matmul_w4a8_2l_gemv(x_q, x_s, w, m, s, 128, torch.float32, paired=False)))
        del w, m
        for M in (cs.BATCH, 8):
            total = 0.0
            for K, N in cs.LAYER_PROJ.values():
                w, m = ri(-128, 128, (K // 2, N)), ri(1, 16, (K // 128, N))
                s = torch.rand((N,), generator=gen, device=dev) * 1e-3
                x_q, x_s = mm.quantize_rowwise(torch.randn((M, K), generator=gen, device=dev))
                total += device_ms(lambda: mm.matmul_w4a8_2l_gemv(x_q, x_s, w, m, s, 128,
                                                                  paired=False))
            show(f"row 5 unpaired 7 projections M={M}", total)
        # row 9 by route: (label, flags, panel width or 0 for flat weights)
        routes = (("9", {}, 0), ("9p bn=512", {}, cs.PANEL), ("9s", cs.FLAGS_O, 0),
                  ("9d", cs.FLAGS_P, 0), ("9c cp=4", cs.FLAGS_Q, 0),
                  ("9m nbuf=2", {"FF_2L_MANUAL": "2"}, cs.PANEL),
                  ("9m nbuf=4", {"FF_2L_MANUAL": "4"}, cs.PANEL))
        for M in (cs.BATCH, 8):
            totals = dict.fromkeys((r[0] for r in routes), 0.0)
            for K, N in cs.PROJ.values():
                w = ri(-128, 128, (2, K // 2, N))
                mp = pack_mult_nibbles(ri(1, 16, (2, K // 128, N))).contiguous()
                s = torch.rand((2, N), generator=gen, device=dev) * 1e-3
                w4 = mm.preblock_stacked(w, cs.PANEL)
                x_q, x_s = mm.quantize_rowwise(torch.randn((M, K), generator=gen, device=dev))
                for label, flags, bn in routes:
                    wt = w4 if bn else w
                    with cs.flag_env(**flags):
                        totals[label] += device_ms(lambda wt=wt: mm.matmul_w4a8_2l_gemv_stacked(
                            x_q, x_s, wt, mp, s, 1, group_size=128))
                del w, w4
            for label, total in totals.items():
                show(f"row {label} 4 projections M={M}", total)
        for M in (cs.BATCH, 8):
            total = 0.0
            for K, N in cs.PROJ.values():
                w = ri(-128, 128, (2, K // 2, N))
                mp = pack_mult_nibbles(ri(1, 16, (2, K // 512, N))).contiguous()
                s = torch.rand((2, N), generator=gen, device=dev) * 1e-2
                x_q, x_s = mm.quantize_rowwise_a4(torch.randn((M, K), generator=gen, device=dev))
                total += device_ms(lambda: mm.matmul_w4a4_2l_gemv_stacked(
                    x_q, x_s, w, mp, s, 1, group_size=512))
            show(f"row 1 4 projections g512 M={M}", total)
        del w
        torch.cuda.empty_cache()

        # rows 3 and 20: INT8 flash decode over layer 1 of a 512-token slab
        Hkv, G, d, S = 8, 4, 128, cs.SLAB
        for B, lo, hi in ((cs.BATCH, cs.PROMPT + 1, cs.PROMPT + cs.STEPS + 1), (8, 33, 65)):
            kc, vc = (ri(-128, 128, (2, B, Hkv, S, d)) for _ in range(2))
            ks, vs = (torch.rand((2, B, Hkv, S), generator=gen, device=dev) * 0.05
                      for _ in range(2))
            q = torch.randn((B, Hkv * G, d), generator=gen, device=dev).to(torch.bfloat16)
            lengths = torch.randint(lo, hi, (B,), generator=gen, device=dev, dtype=torch.int32)
            show(f"row 3 B={B} lengths {lo}-{hi - 1}", device_ms(
                lambda: att.flash_decode_int8_stacked(q, kc, ks, vc, vs, lengths, 1)))
            if B == cs.BATCH:
                k1, v1, ks1, vs1 = kc[1], vc[1], ks[1], vs[1]
                show(f"row 20 B={B} lengths {lo}-{hi - 1}", device_ms(
                    lambda: att.flash_decode_int8(q, k1, ks1, v1, vs1, lengths)))
            del kc, vc
        # row 22: paged flash decode at the engine's decode
        B, P, page = cs.ENGINE_SLOTS, cs.ENGINE_PAGES, cs.ENGINE_PAGE
        MP = cs.ENGINE_MAXLEN // page
        k, v = (ri(-128, 128, (2, P, Hkv, page, d)) for _ in range(2))
        ks, vs = (torch.rand((2, P, Hkv, page), generator=gen, device=dev) * 0.05 for _ in range(2))
        table = torch.full((B, MP), -1, dtype=torch.int32, device=dev)
        perm = (torch.randperm(P - 1, generator=gen, device=dev) + 1).to(torch.int32)
        table[:, 0] = perm[:B]
        table[4:6, 1] = perm[B:B + 2]
        lengths = torch.randint(17, 161, (B,), generator=gen, device=dev, dtype=torch.int32)
        lengths[4], lengths[5] = 300, MP * page
        q = torch.randn((B, Hkv * G, d), generator=gen, device=dev).to(torch.bfloat16)
        show(f"row 22 B={B} page={page} lengths 17-160, 300, {MP * page}", device_ms(
            lambda: pa.paged_flash_decode_int8(q, k, ks, v, vs, table, lengths, 1)))
        del k, v
        torch.cuda.empty_cache()

        # rows 12 and 13: the fused layer heads, layer 1 of 2
        K, N = cs.PROJ["qkv"]
        for a4, g, ms in ((True, 512, (cs.BATCH, 64, 8)), (False, 128, (cs.BATCH, 64, 8))):
            w = ri(-128, 128, (2, K // 2, N))
            mp = pack_mult_nibbles(ri(1, 16, (2, K // g, N))).contiguous()
            s = torch.rand((2, N), generator=gen, device=dev) * 1e-3
            norm = (torch.rand((2, K), generator=gen, device=dev) + 0.5).to(torch.bfloat16)
            for M in ms:
                x = (torch.randn((M, K), generator=gen, device=dev) * 3).to(torch.bfloat16)
                show(f"row {12 if a4 else 13} g{g} M={M}", device_ms(
                    lambda: mm._fused_head_launch(a4, x, norm, w, mp, s, 1, g, 1e-5,
                                                  torch.bfloat16)))
            del w
        # rows 17 and 18t: the W4 GEMV at the decode (M = 192 and 8; the
        # caller-visible median too), the tiled W4A16 GEMM at bench.py's
        # w4a16 prefill, four projections each; then row 17 on the f32 lm_head
        for row, M in (("17", cs.BATCH), ("17", 8), ("18t", cs.BATCH * cs.PROMPT)):
            total = call = 0.0
            for K, N in cs.PROJ.values():
                w = ri(-128, 128, (K // 2, N))
                s = torch.rand((K // 128, N), generator=gen, device=dev) * (0.5 / K ** 0.5) + 1e-4
                x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
                fn = mm.matmul_w4_gemv if row == "17" else mm.matmul_w4a16_tiled
                total += device_ms(lambda: fn(x, w, s, group_size=128),
                                   n=30 if row == "17" else 10)
                call += cs.median_ms(lambda: fn(x, w, s, group_size=128)) if row == "17" else 0.0
                del w, x
            show(f"row {row} 4 projections g128 M={M}", total)
            if row == "17":
                print(f"AB[{tag}] row 17 4 projections g128 M={M}: caller-visible {call:.4f} ms",
                      flush=True)
        K, N = cs.PROJ["qkv"][0], cs.VOCAB
        w = ri(-128, 128, (K // 2, N))
        s = torch.rand((K // 128, N), generator=gen, device=dev) * (0.5 / K ** 0.5) + 1e-4
        x = torch.randn((cs.BATCH, K), generator=gen, device=dev).to(torch.bfloat16)
        show(f"row 17 lm_head g128 f32 M={cs.BATCH}", device_ms(
            lambda: mm.matmul_w4_gemv(x, w, s, group_size=128, out_dtype=torch.float32)))
        del w, x
        torch.cuda.empty_cache()

        # rows 10 and 11: the fused layer tail and its o + gate/up head,
        # Llama-3-8B widths, g128, layer 1 of 2
        H, inter, g = 4096, 14336, 128
        ops = []
        for K, N in ((H, H), (H, 2 * inter), (inter, H)):
            ops += [ri(-128, 128, (2, K // 2, N)),
                    pack_mult_nibbles(ri(1, 16, (2, K // g, N))).contiguous(),
                    torch.rand((2, N), generator=gen, device=dev) * (4.0 / K)]
        norm = (torch.rand((2, H), generator=gen, device=dev) + 0.5).to(torch.bfloat16)
        outputs = {}
        for row, ms in (("10", (8, cs.ENGINE_SLOTS, 64)), ("11", (cs.BATCH, 64, 8))):
            for M in ms:
                attn = torch.randn((M, H), generator=gen, device=dev).to(torch.bfloat16)
                x_res = torch.randn((M, H), generator=gen, device=dev).to(torch.bfloat16)
                if row == "10":  # (y, x1, hq, s_h, x2, s_g)
                    fn, keep = (lambda: mm._fused_o_mlp_launch(attn, x_res, norm, *ops, 1, g,
                                                               1e-5)), 6
                else:  # (x1, gu, hq, s_h)
                    fn, keep = (lambda: mm._fused_o_gu_launch(attn, x_res, norm, *ops[:6], 1, g,
                                                              1e-5)), 4
                show(f"row {row} g{g} M={M}", device_ms(fn))
                print(f"AB[{tag}] row {row} g{g} M={M}: caller-visible "
                      f"{cs.median_ms(fn):.4f} ms", flush=True)
                outputs[f"row {row} M={M}"] = [t.cpu() for t in fn()[:keep]]

        # rows 19 and 16: the W8A8 GEMM and the float-scale W4A8 GEMV at the
        # decode (M = 192 and 8, four projections, bf16), on the f32 lm_head
        # (M = 192) and, row 19, at bench.py's prefill (M = 24,576), g128,
        # with caller-visible medians and their outputs saved (the
        # prefill's as a digest)
        for row, M in (("19", cs.BATCH), ("19", 8), ("16", cs.BATCH), ("16", 8),
                       ("19", cs.BATCH * cs.PROMPT)):
            total = call = 0.0
            got = []
            for K, N in cs.PROJ.values():
                x_q, x_s = mm.quantize_rowwise(torch.randn((M, K), generator=gen, device=dev))
                if row == "19":
                    w = ri(-127, 128, (K, N))
                    ws = torch.rand((N,), generator=gen, device=dev) * (0.02 / K ** 0.5)
                    fn = (lambda: mm.matmul_w8a8(x_q, x_s, w, ws))
                else:
                    w = ri(-128, 128, (K // 2, N))
                    ws = torch.rand((K // 128, N), generator=gen, device=dev) * 1e-3 + 1e-4
                    fn = (lambda: mm.matmul_w4a8_gemv(x_q, x_s, w, ws, 128))
                prefill = M > 256
                total += device_ms(fn, n=5 if prefill else 30)
                call += 0.0 if prefill else cs.median_ms(fn)
                out = fn()
                got.append(_digest(out) if prefill else out.cpu())
                del w, x_q, out
                torch.cuda.empty_cache()
            label = f"row {row} 4 projections M={M}"
            show(label, total)
            if M <= 256:
                print(f"AB[{tag}] {label}: caller-visible {call:.4f} ms", flush=True)
            outputs[label] = got
        K, N = cs.PROJ["qkv"][0], cs.VOCAB
        x_q, x_s = mm.quantize_rowwise(torch.randn((cs.BATCH, K), generator=gen, device=dev))
        for row in ("19", "16"):
            if row == "19":
                w = ri(-127, 128, (K, N))
                ws = torch.rand((N,), generator=gen, device=dev) * (0.02 / K ** 0.5)
                fn = (lambda: mm.matmul_w8a8(x_q, x_s, w, ws, out_dtype=torch.float32))
            else:
                w = ri(-128, 128, (K // 2, N))
                ws = torch.rand((K // 128, N), generator=gen, device=dev) * 1e-3 + 1e-4
                fn = (lambda: mm.matmul_w4a8_gemv(x_q, x_s, w, ws, 128, torch.float32))
            label = f"row {row} lm_head f32 M={cs.BATCH}"
            show(label, device_ms(fn))
            print(f"AB[{tag}] {label}: caller-visible {cs.median_ms(fn):.4f} ms", flush=True)
            outputs[label] = [fn().cpu()]
            del w
        torch.cuda.empty_cache()

        # row 7, flash prefill over int8 and bf16 K/V (Hkv 8, G 4, a
        # 512-token slab): bench.py's prefill (B 192, T 128, starts 0) and a
        # ragged chunk (B 16, T 77, starts 0..300)
        Hkv, G, d, S = 8, 4, 128, cs.SLAB
        for B, T, smax in ((cs.BATCH, cs.PROMPT, 0), (16, 77, 300)):
            q = torch.randn((B, Hkv * G, T, d), generator=gen, device=dev).to(torch.bfloat16)
            starts = torch.randint(0, smax + 1, (B,), generator=gen, device=dev,
                                   dtype=torch.int32)
            for kv in ("int8", "bf16"):
                if kv == "int8":
                    k, v = ri(-128, 128, (B, Hkv, S, d)), ri(-128, 128, (B, Hkv, S, d))
                    ks = torch.rand((B, Hkv, S), generator=gen, device=dev) * 0.02
                    vs = torch.rand((B, Hkv, S), generator=gen, device=dev) * 0.05
                else:
                    k = torch.randn((B, Hkv, S, d), generator=gen, device=dev).to(torch.bfloat16)
                    v = torch.randn((B, Hkv, S, d), generator=gen, device=dev).to(torch.bfloat16)
                    ks = vs = None
                fn = (lambda: att.flash_prefill(q, k, ks, v, vs, starts))
                show(f"row 7 {kv} B={B} T={T} starts 0..{smax}", device_ms(fn))
                print(f"AB[{tag}] row 7 {kv} B={B} T={T} starts 0..{smax}: caller-visible "
                      f"{cs.median_ms(fn):.4f} ms", flush=True)
                del k, v
        torch.cuda.empty_cache()

        # the prefill dequant over the four projections: rows 15 (group
        # halves g128), 14 (paired g128), 14p (paired g128, pre-blocked at
        # bn 512) and 8 (vertical g512)
        for row, layout, g in (("15", "halves", 128), ("14", "paired", 128),
                               ("14p", "paired", 128), ("8", "vertical", 512)):
            total = 0.0
            for K, N in cs.PROJ.values():
                w = ri(-128, 128, (2, K // 2, N))
                if row == "15":
                    s = torch.rand((K // g, N), generator=gen, device=dev) * 1e-3
                    fn = (lambda: mm.dequantize_int4(w[1], s, g))
                else:
                    m, s = ri(1, 16, (2, K // g, N)), torch.rand((2, N), generator=gen,
                                                                 device=dev) * 1e-3
                    wt = mm.preblock_stacked(w, cs.PANEL) if row == "14p" else w
                    stacked = getattr(mm, f"dequantize_int4_{layout}_stacked")
                    fn = (lambda: stacked(wt, m, s, 1, group_size=g))
                total += device_ms(fn)
                del w
                torch.cuda.empty_cache()
            show(f"row {row} dequant 4 projections g{g}", total)

        # the yardstick of rows 19 and 16: one torch._int_mm (the int32
        # product alone) on a K-major copy of an int8 weight, device time,
        # four projections at M = 192 and the lm_head
        for name, shapes in (("4 projections", list(cs.PROJ.values())),
                             ("lm_head", [(cs.PROJ["qkv"][0], cs.VOCAB)])):
            total = 0.0
            for K, N in shapes:
                x_q = ri(-127, 128, (cs.BATCH, K))
                wt = ri(-127, 128, (N, K))
                total += device_ms(lambda: torch._int_mm(x_q, wt.t()))
                del wt
            show(f"torch._int_mm K-major {name} M={cs.BATCH}", total)
        torch.cuda.empty_cache()
        os.makedirs(_out_dir(), exist_ok=True)
        torch.save(outputs, os.path.join(_out_dir(), f"{tag}_tail.pt"))

    if "--splits" in sys.argv and hasattr(mm, "_tail_product_plan"):
        # rows 10 and 11 with their gate/up in one K split (the plan's) and
        # in two (the tile's own target below M = 65), device ms a call
        own = mm._tail_product_plan
        for split in (1, 2):
            mm._tail_product_plan = lambda M, K, N, g, route="tile", split=split: (
                mm.mma_plan(M, K, N, g, "paired", split) if N == 2 * inter
                else own(M, K, N, g, route))
            mm.tail_plan.cache_clear()
            try:
                for row, ms in (("10", (8, cs.ENGINE_SLOTS, 64)), ("11", (cs.BATCH, 64, 8))):
                    for M in ms:
                        attn = torch.randn((M, H), generator=gen, device=dev).to(torch.bfloat16)
                        x_res = torch.randn((M, H), generator=gen, device=dev).to(torch.bfloat16)
                        fn = ((lambda: mm._fused_o_mlp_launch(attn, x_res, norm, *ops, 1, g, 1e-5))
                              if row == "10" else
                              (lambda: mm._fused_o_gu_launch(attn, x_res, norm, *ops[:6], 1, g,
                                                             1e-5)))
                        show(f"row {row} g{g} M={M} gate/up split {split}", device_ms(fn))
            finally:
                mm._tail_product_plan = own
                mm.tail_plan.cache_clear()
    del ops
    torch.cuda.empty_cache()

    if "--splits" in sys.argv and hasattr(mm, "w4_plan"):
        # row 17 by K split (1-8: the plan's own and the others), four
        # projections at M = 192 and 8, device ms per projection
        plan_of = mm.w4_plan
        for M in (cs.BATCH, 8):
            for name, (K, N) in cs.PROJ.items():
                w = ri(-128, 128, (K // 2, N))
                s = torch.rand((K // 128, N), generator=gen, device=dev) * (0.5 / K ** 0.5) + 1e-4
                x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
                own = plan_of(M, K, N, 128).n_split
                times = {}
                for split in range(1, 9):
                    plan = plan_of(M, K, N, 128, split)
                    if plan.n_split in times:
                        continue
                    mm.w4_plan = lambda *a, plan=plan: plan
                    try:
                        times[plan.n_split] = device_ms(lambda: mm.matmul_w4_gemv(x, w, s, 128))
                    finally:
                        mm.w4_plan = plan_of
                print(f"AB[{tag}] row 17 {name} M={M} by split (the plan's {own}): "
                      + ", ".join(f"{k} {v:.4f}" for k, v in times.items()), flush=True)
                del w, x

    if "--serve" in sys.argv:
        serve_runs(cs, tag, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
