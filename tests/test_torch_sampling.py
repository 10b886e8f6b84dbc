"""The port's sampling (`fastforward_tpu_torch.serving.sampling`) against
`fastforward_tpu.serving.sampling`, on the CPU.

JAX keys and torch generators give different random numbers, so the
deterministic parts are compared and the draw only for its support:
- the top-k and top-p filters and the per-row filter (temperature → top-k
  → top-p) give the same masked logits, bit for bit, row by row;
- temperature-0 rows give the argmax;
- a sampled token always lies where JAX's filter kept the logit.
Logits are made by numpy from a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastforward_tpu.serving import sampling as js
from fastforward_tpu_torch.serving import sampling as ts

V = 256


def _logits(B, seed):
    return (np.random.RandomState(seed).randn(B, V) * 3).astype(np.float32)


@pytest.mark.parametrize("k", [1, 7, 64, V, V + 10])
def test_apply_top_k_matches_jax(k):
    x = _logits(4, k)
    np.testing.assert_array_equal(np.asarray(js._apply_top_k(jnp.asarray(x), k)),
                                  ts._apply_top_k(torch.from_numpy(x), k).numpy())


@pytest.mark.parametrize("p", [0.1, 0.5, 0.9, 0.99])
def test_apply_top_p_matches_jax(p):
    x = _logits(4, int(p * 100))
    np.testing.assert_array_equal(np.asarray(js._apply_top_p(jnp.asarray(x), p)),
                                  ts._apply_top_p(torch.from_numpy(x), p).numpy())


def test_per_row_filter_matches_jax_chain_row_by_row():
    # GIVEN six rows with their own temperature, top-k and top-p (p < 1 on
    # every row: at p = 1 the per-row path still cuts the tail where the
    # float cumulative mass reaches 1, which the scalar chain skips)
    x = _logits(6, 3)
    temps = np.array([0.7, 1.0, 1.3, 2.0, 0.5, 1.0], np.float32)
    top_ks = np.array([0, 5, 40, 0, 1, V], np.int32)
    top_ps = np.array([0.9, 0.5, 0.95, 0.3, 0.8, 0.99], np.float32)
    # WHEN the port filters all rows at once
    out = ts.filter_logits_per_row(torch.from_numpy(x), torch.from_numpy(temps),
                                   torch.from_numpy(top_ks), torch.from_numpy(top_ps)).numpy()
    # THEN each row equals JAX's temperature → top-k → top-p chain on it
    for b in range(6):
        row = jnp.asarray(x[b:b + 1]) / temps[b]
        if top_ks[b] > 0:
            row = js._apply_top_k(row, int(top_ks[b]))
        row = js._apply_top_p(row, float(top_ps[b]))
        np.testing.assert_array_equal(np.asarray(row)[0], out[b], err_msg=f"row {b}")


def test_greedy_rows_are_the_argmax_and_samples_stay_in_support():
    # GIVEN rows mixing greedy (temperature 0) and filtered sampling
    x = _logits(5, 11)
    temps = np.array([0.0, 1.0, 0.0, 0.8, 1.5], np.float32)
    top_ks = np.array([0, 3, 10, 0, 20], np.int32)
    top_ps = np.array([1.0, 1.0, 0.5, 0.7, 0.9], np.float32)
    args = [torch.from_numpy(a) for a in (x, temps, top_ks, top_ps)]
    kept = ts.filter_logits_per_row(*args) > ts.NEG_INF
    gen = torch.Generator().manual_seed(0)
    draws = np.stack([ts.sample_logits_per_row(*args, generator=gen).numpy()
                      for _ in range(64)])
    # THEN greedy rows always give the argmax, and every draw of a hot row
    # is a token JAX's filter kept
    assert (draws[:, [0, 2]] == np.argmax(x, axis=-1)[[0, 2]]).all()
    for b in (1, 3, 4):
        row = jnp.asarray(x[b:b + 1]) / temps[b]
        if top_ks[b] > 0:
            row = js._apply_top_k(row, int(top_ks[b]))
        if top_ps[b] < 1.0:
            row = js._apply_top_p(row, float(top_ps[b]))
        support = set(np.flatnonzero(np.asarray(row)[0] > js.NEG_INF).tolist())
        assert set(draws[:, b].tolist()) <= support
        assert set(draws[:, b].tolist()) <= set(np.flatnonzero(kept[b].numpy()).tolist())
    assert len(set(draws[:, 4].tolist())) > 1  # the draw is random


def test_all_greedy_batch_and_scalar_sampling():
    x = _logits(3, 5)
    xt = torch.from_numpy(x)
    z = torch.zeros(3)
    # an all-greedy batch needs no generator and gives the argmax
    out = ts.sample_logits_per_row(xt, z, z.int(), torch.ones(3))
    np.testing.assert_array_equal(out.numpy(), np.argmax(x, axis=-1))
    assert out.dtype == torch.int32
    # scalar params: greedy, and top_k = 1 sampling, are the argmax
    np.testing.assert_array_equal(
        ts.sample_logits(xt, ts.SamplingParams(temperature=0.0)).numpy(),
        np.asarray(js.sample_logits(jnp.asarray(x), js.SamplingParams(temperature=0.0))))
    gen = torch.Generator().manual_seed(1)
    np.testing.assert_array_equal(
        ts.sample_logits(xt, ts.SamplingParams(temperature=0.7, top_k=1), gen).numpy(),
        np.argmax(x, axis=-1))
    with pytest.raises(ValueError):
        ts.sample_logits(xt, ts.SamplingParams(temperature=1.0))
    assert ts.SamplingParams(temperature=0.0).is_greedy
    assert not ts.SamplingParams().is_greedy
