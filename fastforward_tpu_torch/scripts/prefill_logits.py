"""Prefill logits of a served run with a checkout's flash prefill kernel and
with its plain version, to tell a kernel's rounding from a fault.

    python3 fastforward_tpu_torch/scripts/prefill_logits.py TREE TAG [--out DIR]
    python3 fastforward_tpu_torch/scripts/prefill_logits.py --compare A B [--out DIR]

Run it as a file: it imports ``chip_smoke`` and ``fastforward_tpu_torch``
from the checkout TREE. For chip_smoke.py's runs (e) (w4a8) and (g) (w8a8),
g128, at full depth and bench.py's shape on their seeds, it saves the last
position's prefill logits twice under DIR (default build/prefill_logits):
through the tree's flash prefill kernel, and with
`attention.flash_prefill_reference` in its place (every other kernel the
same). ``--compare A B`` prints, for each run, kernel vs plain within each
tag and kernel vs kernel across the tags: the relative RMS difference, the
rows whose greedy token (argmax) differs, the median top-2 margin and the
median largest error of a row. Needs a CUDA GPU.
"""

import contextlib
import os
import sys
from unittest import mock

import torch

RUNS = (("e", "w4a8"), ("g", "w8a8"))


def _out_dir():
    i = sys.argv.index("--out") + 1 if "--out" in sys.argv else 0
    return sys.argv[i] if i else os.path.join(os.getcwd(), "build", "prefill_logits")


def compare(a, b):
    ra, rb = (torch.load(os.path.join(_out_dir(), f"{t}.pt")) for t in (a, b))
    for run in ra:
        for what, x, y in ((f"{a} kernel vs plain", ra[run]["kernel"], ra[run]["plain"]),
                           (f"{b} kernel vs plain", rb[run]["kernel"], rb[run]["plain"]),
                           (f"{a} kernel vs {b} kernel", ra[run]["kernel"], rb[run]["kernel"])):
            x, y = x.double(), y.double()
            rms = ((x - y).pow(2).mean() / y.pow(2).mean()).sqrt().item()
            top2 = torch.topk(y, 2, dim=-1).values
            flips = int((x.argmax(-1) != y.argmax(-1)).sum())
            print(f"LOGITS ({run}) {what}: relative RMS {rms:.4g}, greedy token differs in "
                  f"{flips} of {len(y)} rows, median top-2 margin "
                  f"{(top2[:, 0] - top2[:, 1]).median().item():.4g}, median row max error "
                  f"{(x - y).abs().amax(-1).median().item():.4g} (largest logit "
                  f"{y.abs().max().item():.4g})", flush=True)
    return 0


def main():
    if sys.argv[1] == "--compare":
        return compare(sys.argv[2], sys.argv[3])
    if not torch.cuda.is_available():
        print("prefill_logits: CUDA is not available", file=sys.stderr)
        return 2
    tree, tag = os.path.abspath(sys.argv[1]), sys.argv[2]
    sys.path.insert(0, tree)
    import chip_smoke as cs
    from fastforward_tpu_torch.kernels import attention as att
    from fastforward_tpu_torch.models.llama import LlamaConfig

    if not cs.__file__.startswith(tree):
        raise RuntimeError(f"chip_smoke imported from {cs.__file__}, not {tree}")
    dev = torch.device("cuda", 0)
    config = LlamaConfig.llama3_8b()
    record = {}
    with cs.flag_env():
        for run, mode in RUNS:
            path = cs.ServePath.random(config, mode, 128, 0, dev)
            ids = torch.randint(0, config.vocab_size, (cs.BATCH, cs.PROMPT), device=dev,
                                generator=torch.Generator(device=dev).manual_seed(7))
            record[run] = {}
            plain = mock.patch("fastforward_tpu_torch.serving.stacked.flash_prefill",
                               att.flash_prefill_reference)
            for key, patch in (("kernel", contextlib.nullcontext()), ("plain", plain)):
                with patch:
                    cache = path.new_cache(cs.BATCH, dev)
                    logits, _ = path.forward(ids, cache, logits_positions="last")
                record[run][key] = logits[:, -1].float().cpu()
                del cache, logits
            del path
            torch.cuda.empty_cache()
            print(f"LOGITS[{tag}] ({run}) {mode}: saved", flush=True)
    os.makedirs(_out_dir(), exist_ok=True)
    torch.save(record, os.path.join(_out_dir(), f"{tag}.pt"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
