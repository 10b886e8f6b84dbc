"""Evaluation harness: perplexity over token batches
(`fastforward_tpu/utils/evaluation.py`).

BASELINE's tier-parity criterion compares the execution tier's perplexity
with the simulated tier's at the same bit-width; this computes the
perplexity of any causal-LM forward (ids → logits) over token batches, as
the JAX harness does: next-token log-likelihood in float32, the mean over
``B * (T - 1)`` positions a batch, summed over batches in Python floats.
"""

import math
from typing import Callable, Iterable

import torch


def sequence_nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of next-token prediction.

    logits: (B, T, V); targets: (B, T) — position t predicts targets[t + 1].
    """
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    tgt = targets[:, 1:].to(device=logp.device, dtype=torch.int64)
    picked = torch.gather(logp, -1, tgt[..., None])[..., 0]
    return -torch.mean(picked)


@torch.no_grad()
def evaluate_perplexity(
    forward: Callable[[torch.Tensor], torch.Tensor],
    token_batches: Iterable[torch.Tensor],
) -> float:
    """Perplexity of ``forward`` over the batches."""
    total_nll, total_tokens = 0.0, 0
    for ids in token_batches:
        logits = forward(ids)
        n = ids.shape[0] * (ids.shape[1] - 1)
        total_nll += float(sequence_nll(logits, ids)) * n
        total_tokens += n
    return float(math.exp(total_nll / total_tokens))


def perplexity_delta(
    forward_a: Callable[[torch.Tensor], torch.Tensor],
    forward_b: Callable[[torch.Tensor], torch.Tensor],
    token_batches: list,
) -> tuple[float, float, float]:
    """(ppl_a, ppl_b, |delta|) over the same batches."""
    ppl_a = evaluate_perplexity(forward_a, token_batches)
    ppl_b = evaluate_perplexity(forward_b, token_batches)
    return ppl_a, ppl_b, abs(ppl_a - ppl_b)
