"""A/B of the two-level int4 GEMVs between two checkouts, on one card.

    python3 fastforward_tpu_torch/scripts/ab_two_level.py TREE TAG [--serve] [--out DIR]
    python3 fastforward_tpu_torch/scripts/ab_two_level.py --compare A B [--out DIR]

Run it as a file, not with ``-m``: it imports ``chip_smoke`` and
``fastforward_tpu_torch`` from the checkout TREE (e.g. the parent commit
unpacked with ``git archive`` into a git-ignored directory), builds its
kernels there, and prints the device time (``torch.profiler``, 30 calls)
of row 5 (the two-level W4A8 GEMV: the paired lm_head at g512, M = 192
and 8, f32; the unpaired lm_head at g128, f32, and the seven unfused
projections of a Llama-3-8B layer, bf16), row 9m (the manual stream
over the four fused projections pre-blocked in 512-column panels, nbuf 2
and 4, M = 192 and 8), row 1 (the A4 GEMV over the four fused
projections at g512, M = 192 and 8) and row 4 (the argmax lm_head, paired
g512, M = 192 and 8), each line tagged TAG. Inputs come from one seed, so
two trees time the same integers; run them in turns on one card (A, B, B,
A). ``--serve`` also serves chip_smoke.py's runs (a), (b), (c), (i), (k)
and (n) on their seeds and saves the greedy tokens and prefill logits
under DIR (default build/ab_two_level); ``--compare A B`` then says, run
by run, whether the two tags' tokens are identical and their prefill
logits bit-equal, and exits 1 where they are not. Needs a CUDA GPU.
"""

import os
import sys
import time

import torch


def _out_dir():
    i = sys.argv.index("--out") + 1 if "--out" in sys.argv else 0
    return sys.argv[i] if i else os.path.join(os.getcwd(), "build", "ab_two_level")


def compare(a, b):
    ra, rb = (torch.load(os.path.join(_out_dir(), f"{t}.pt")) for t in (a, b))
    same = True
    for run in ra:
        tokens = torch.equal(ra[run]["tokens"], rb[run]["tokens"])
        logits = torch.equal(ra[run]["logits"], rb[run]["logits"])
        same = same and tokens and logits
        print(f"AB ({run}) {a} vs {b}: greedy tokens {'identical' if tokens else 'DIFFER'}, "
              f"prefill logits {'bit-equal' if logits else 'DIFFER'}")
    return 0 if same else 1


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
    from fastforward_tpu_torch.kernels import matmul as mm
    from fastforward_tpu_torch.kernels.packing import pack_mult_nibbles

    if not cs.__file__.startswith(tree):
        raise RuntimeError(f"chip_smoke imported from {cs.__file__}, not {tree}")
    _build.build_all()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(99)

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, dtype=torch.int8, device=dev)

    def device_ms(fn):
        for _ in range(4):  # the profiler now and then records no kernel
            d = cs.device_ms(fn, n=30)
            if d:
                return d
        raise RuntimeError("the profiler recorded no device time")

    def show(label, ms):
        print(f"AB[{tag}] {label}: device {ms:.4f} ms", flush=True)

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
        for M in (cs.BATCH, 8):
            for nbuf in (2, 4):
                total = 0.0
                for K, N in cs.PROJ.values():
                    w = ri(-128, 128, (2, K // 2, N))
                    mp = pack_mult_nibbles(ri(1, 16, (2, K // 128, N))).contiguous()
                    s = torch.rand((2, N), generator=gen, device=dev) * 1e-3
                    w4 = mm.preblock_stacked(w, cs.PANEL)
                    x_q, x_s = mm.quantize_rowwise(torch.randn((M, K), generator=gen, device=dev))
                    with cs.flag_env(FF_2L_MANUAL=str(nbuf)):
                        total += device_ms(lambda: mm.matmul_w4a8_2l_gemv_stacked(
                            x_q, x_s, w4, mp, s, 1, group_size=128))
                show(f"row 9m 4 projections M={M} nbuf={nbuf}", total)
        del w, w4
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

    if "--serve" in sys.argv:
        from fastforward_tpu_torch.models.llama import LlamaConfig

        config = LlamaConfig.llama3_8b()
        record = {}
        for run, mode, g, B, T, kv, flags in (
                ("a", "w4a4_2l", 512, cs.BATCH, cs.PROMPT, None, {}),
                ("b", "w4a8_2l", 128, cs.BATCH, cs.PROMPT, None, {}),
                ("c", "w4a4_2l", 512, 8, 32, None, {}),
                ("i", "w4a8_2l", 128, cs.BATCH, cs.PROMPT, "bf16", {}),
                ("k", "w4a4_2l", 512, cs.BATCH, cs.PROMPT, None, cs.FLAGS_K),
                ("n", "w4a8_2l", 128, cs.BATCH, cs.PROMPT, None, cs.FLAGS_N)):
            t0 = time.perf_counter()
            with cs.flag_env(**flags):
                path = cs.ServePath.random(config, mode, g, 0, dev, kv)
                ids = torch.randint(0, config.vocab_size, (B, T), device=dev,
                                    generator=torch.Generator(device=dev).manual_seed(7))
                logits, _, tokens, cache, _, _ = cs._serve(path, ids, cs.STEPS, dev)
                record[run] = dict(logits=logits.cpu(), tokens=tokens.cpu())
                del path, cache, logits
                torch.cuda.empty_cache()
            print(f"AB[{tag}] served ({run}) in {time.perf_counter() - t0:.1f} s", flush=True)
        os.makedirs(_out_dir(), exist_ok=True)
        torch.save(record, os.path.join(_out_dir(), f"{tag}.pt"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
