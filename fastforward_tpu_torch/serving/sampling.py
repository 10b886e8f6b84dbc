"""Token sampling for the decode loop, ported from
`fastforward_tpu/serving/sampling.py`.

Greedy (temperature 0), temperature, top-k and top-p, per batch
(`sample_logits`) or per row (`sample_logits_per_row`). A
``torch.Generator`` on the logits' device takes the place of the JAX key;
the two give different random numbers from the same seed, so the per-row
path is split into a deterministic filter (`filter_logits_per_row`, which
the tests hold against the JAX chain row by row) and the draw.

The draw is the Gumbel-max form of a categorical sample, as
``jax.random.categorical`` computes it: argmax of the filtered logits plus
Gumbel noise. A filtered-out logit is ``NEG_INF`` and never wins.
"""

import dataclasses
from typing import Optional

import torch

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-batch sampling configuration (`sampling.py:24`).

    temperature: 0 → greedy argmax; otherwise logits are divided by it.
    top_k: keep only the k highest-probability tokens (0 disables).
    top_p: keep the smallest prefix of sorted tokens whose cumulative
        probability reaches p (1.0 disables).
    """

    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0

    @property
    def is_greedy(self) -> bool:
        return self.temperature == 0.0


def _apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Mask all but the k largest logits per row to NEG_INF; k above the
    vocabulary keeps every logit (`sampling.py:44`)."""
    k = min(k, logits.shape[-1])
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, torch.full_like(logits, NEG_INF), logits)


def _top_p_threshold(sorted_desc: torch.Tensor, p) -> torch.Tensor:
    """Smallest kept logit per row of descending-sorted logits: a position
    is kept while the probability mass before it is below ``p`` (the first
    position always)."""
    cum = torch.cumsum(torch.softmax(sorted_desc, dim=-1), dim=-1)
    keep = torch.cat([torch.ones_like(cum[..., :1], dtype=torch.bool), cum[..., :-1] < p],
                     dim=-1)
    inf = torch.full_like(sorted_desc, float("inf"))
    return torch.where(keep, sorted_desc, inf).amin(dim=-1, keepdim=True)


def _apply_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filtering (`sampling.py:55`)."""
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    thresh = _top_p_threshold(sorted_desc, p)
    return torch.where(logits < thresh, torch.full_like(logits, NEG_INF), logits)


def _gumbel_argmax(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=torch.float32)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1).to(torch.int32)


def sample_logits(logits: torch.Tensor, params: SamplingParams,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """One token id per row of ``logits`` (..., vocab) → (...,) int32
    (`sampling.py:75`)."""
    if params.is_greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if generator is None:
        raise ValueError("stochastic sampling requires a torch.Generator")
    scaled = logits.float() / params.temperature
    if params.top_k and params.top_k > 0:
        scaled = _apply_top_k(scaled, params.top_k)
    if params.top_p < 1.0:
        scaled = _apply_top_p(scaled, params.top_p)
    return _gumbel_argmax(scaled, generator)


def filter_logits_per_row(logits: torch.Tensor, temperature: torch.Tensor,
                          top_k: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """The deterministic half of `sample_logits_per_row`: temperature, then
    per-row top-k, then per-row top-p (`sampling.py:116-137`, ``scaled3``).
    logits (B, V); temperature (B,) f32 (0 → greedy row, scaled by 1 here);
    top_k (B,) int (0 disables); top_p (B,) f32 (1.0 disables)."""
    V = logits.shape[-1]
    safe_t = torch.where(temperature > 0, temperature, torch.ones_like(temperature))
    scaled = logits.float() / safe_t[:, None]
    neg = torch.full_like(scaled, NEG_INF)

    sorted_l = torch.sort(scaled, dim=-1, descending=True).values
    k_eff = torch.where(top_k > 0, torch.clamp(top_k, 1, V), torch.full_like(top_k, V))
    kth = torch.gather(sorted_l, 1, (k_eff.long() - 1)[:, None])
    scaled2 = torch.where(scaled < kth, neg, scaled)

    sorted2 = torch.sort(scaled2, dim=-1, descending=True).values
    thresh = _top_p_threshold(sorted2, top_p[:, None])
    return torch.where(scaled2 < thresh, neg, scaled2)


def sample_logits_per_row(logits: torch.Tensor, temperature: torch.Tensor,
                          top_k: torch.Tensor, top_p: torch.Tensor,
                          generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Per-row sampling (`sampling.py:97`): greedy argmax where temperature
    is 0, temperature → top-k → top-p → categorical elsewhere. An all-greedy
    batch skips the two sorts (`:142-148`)."""
    greedy_tok = torch.argmax(logits, dim=-1).to(torch.int32)
    hot = temperature > 0
    if not bool(hot.any()):
        return greedy_tok
    if generator is None:
        raise ValueError("stochastic sampling requires a torch.Generator")
    sampled = _gumbel_argmax(filter_logits_per_row(logits, temperature, top_k, top_p), generator)
    return torch.where(hot, sampled, greedy_tok)
