"""Row by row, how far the dense attention routes' logits lie from the flash
routes' on a random model, and how far the two routes' plain f32 forms lie
from each other on the same inputs.

    python3 fastforward_tpu_torch/scripts/dense_rows.py

Run it as a file from the repository's root: it imports ``chip_smoke``. It
builds the kernels, then chip_smoke.py's depth-2 model of run (ae)
(Llama-3-8B's widths, w4a8_2l g128, seed 1; per layer over an INT8
KVCache, then stacked), prefills 192 prompts of 128 tokens and takes one
decode step from the same first tokens, five ways: the flash routes, the
dense decode step (``FF_BENCH_FLASH=0``), each of the two with every
kernel swapped for its plain version, and the dense step with its
attention in f32. For each pair it prints the relative RMS difference of
the step's logits over the batch and the five rows farthest apart (the
row's relative error, both norms, both greedy tokens). A row that lands in
another attractor of the random model shows as one error near 2 among
errors near 1e-3. Needs a CUDA GPU.
"""

import dataclasses
import os
import sys

import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402

PAIRS = (("dense", "flash"), ("flash", "flash plain"), ("dense", "dense plain"),
         ("dense plain", "flash plain"), ("dense f32", "flash plain"), ("dense", "dense f32"))


def report(what, a, b):
    err = (a - b).norm(dim=-1) / b.norm(dim=-1)
    top = torch.topk(err, 5)
    cs.log(f"{what}: relative RMS {cs._rel_rms(a, b):.4g}; farthest rows " + ", ".join(
        f"{int(i)}: {float(e):.4g} (norms {float(a[i].norm()):.4g}, {float(b[i].norm()):.4g}; "
        f"tokens {int(a[i].argmax())}, {int(b[i].argmax())})"
        for e, i in zip(top.values, top.indices)))


def step_logits(path, ids, token, flags, patches, f32):
    """The decode step's last-position logits after a prefill on ``path``."""
    import fastforward_tpu_torch.serving.stacked as ts

    dense = ts._attention_grouped

    def dense_f32(q, k, v, mask):
        return dense(q.float(), k.float(), v.float(), mask).to(q.dtype)

    if f32:
        patches = [*patches, cs.mock.patch.object(ts, "_attention_grouped", dense_f32)]
    with cs.flag_env(**flags):
        for p in patches:
            p.start()
        try:
            cache = path.new_cache(ids.shape[0], ids.device)
            logits, cache = path.forward(ids, cache, logits_positions="last")
            if token is None:
                token = torch.argmax(logits[:, -1], dim=-1).to(ids.dtype)[:, None]
            step, _ = path.forward(token, cache)
        finally:
            for p in patches:
                p.stop()
    return step[:, -1].float(), token


def main():
    from fastforward_tpu_torch.models.llama import LlamaConfig

    dev = torch.device("cuda", 0)
    with cs.flag_env():
        cs.phase_build()
        config = dataclasses.replace(LlamaConfig.llama3_8b(), num_layers=2)
        for kv in ("int8", None):
            path = cs.ServePath.random(config, "w4a8_2l", 128, 1, dev, kv)
            ids = torch.randint(0, config.vocab_size, (cs.BATCH, cs.PROMPT), device=dev,
                                generator=torch.Generator(device=dev).manual_seed(11))
            dense = {"FF_BENCH_FLASH": "0"}
            out, token = {}, None
            for name, flags, plain, f32 in (("flash", {}, False, False),
                                            ("dense", dense, False, False),
                                            ("flash plain", {}, True, False),
                                            ("dense plain", dense, True, False),
                                            ("dense f32", dense, False, True)):
                out[name], token = step_logits(path, ids, token, flags,
                                               cs._plain_patches() if plain else [], f32)
            label = "stacked" if kv is None else f"per-layer {kv}"
            for a, b in PAIRS:
                report(f"{label} decode step, {a} vs {b}", out[a], out[b])
            del path
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
