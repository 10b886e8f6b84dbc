"""The port's continuous-batching engine against the JAX package's, on the CPU.

Both engines serve the same requests on the same weights: a narrow
Llama (hidden 256, 2 layers, head dim 128, two query heads per kv head,
so attention width = hidden as the fused tail needs), two-level W4A8 g128,
made by the JAX package and carried into the port by `params_from_flat`.
The greedy tokens must be equal request by request, and every
`EngineStats` counter equal.

The JAX engine takes its TPU routes, as the port does on every device:
``stacked._serving_on_tpu`` and ``engine._on_tpu`` read as true, and the
``_on_tpu`` that `serving/stacked.py` asks before flash prefill too, so
both packages take the stacked KV decode, flash prefill, the paged decode
and the fused W4A8 layer tail; each JAX kernel then runs its CPU
reference. Its paged append reference gets the table its TPU wrapper
passes (``max(table, 0)``: -1 is the trash page 0; on the raw table the
reference wraps -1 to the last page, ROADMAP.md Queue 3). Its jitted
steps are compiled with ``xla_allow_excess_precision=False``, the function
as written, which is what the port computes eagerly.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastforward_tpu.kernels import matmul as jmm
from fastforward_tpu.kernels import paged_attention as jpa
from fastforward_tpu.models.llama import LlamaConfig as JConfig
from fastforward_tpu.serving import batching as jb
from fastforward_tpu.serving import engine as je
from fastforward_tpu.serving import stacked as jst
from fastforward_tpu_torch.models.llama import LlamaConfig as TConfig
from fastforward_tpu_torch.serving import batching as tb
from fastforward_tpu_torch.serving import stacked as tst
from fastforward_tpu_torch.serving.convert import params_from_flat
from fastforward_tpu_torch.serving.sampling import SamplingParams
from tests.test_torch_serving import jax_to_flat

EXACT = {"xla_allow_excess_precision": False}
_STACKED_PY = os.path.join("fastforward_tpu", "serving", "stacked.py")
# jitted closures of the JAX engine and their static argument positions
_JITTED = {"_decode_step": (), "_decode_burst_greedy": (3,), "_decode_burst": (9,),
           "_prefill_batch": (), "_prefill_chunk": (), "_scatter_rows": ()}


@pytest.fixture(scope="module")
def models():
    kw = dict(vocab_size=256, hidden_size=256, intermediate_size=512, num_layers=2,
              num_heads=2, num_kv_heads=1, head_dim=128, max_seq_len=512)
    jc, tc = JConfig(**kw, dtype=jnp.float32), TConfig(**kw, dtype=torch.float32)
    params, layers = jst.random_stacked_params(jc, mode="w4a8_2l", seed=0)
    layers = jst.fuse_stacked_layers(layers)
    return jc, params, layers, tc, *params_from_flat(jax_to_flat(params, layers), device="cpu")


@pytest.fixture
def routes(monkeypatch):
    """The JAX package's TPU routing (see the module docstring); returns
    the set of routes each package took."""
    taken = set()

    def on_tpu_from_stacked():
        return sys._getframe(1).f_code.co_filename.endswith(_STACKED_PY)

    def spy(module, name, key, wrap=None):
        fn = getattr(module, name)

        def call(*args, **kwargs):
            taken.add(key)
            return (wrap or fn)(*args, **kwargs)
        monkeypatch.setattr(module, name, call)

    monkeypatch.setattr(jst, "_serving_on_tpu", lambda: True)
    monkeypatch.setattr(je, "_on_tpu", lambda: True)
    monkeypatch.setattr(jmm, "_on_tpu", on_tpu_from_stacked)
    ref = jpa.paged_kv_append_reference
    monkeypatch.setattr(jpa, "paged_kv_append_reference",
                        lambda *a: ref(*a[:9], jnp.maximum(a[9], 0), a[10]))
    spy(jmm, "fused_o_mlp_stacked", "jax fused tail")
    spy(jpa, "paged_flash_decode_int8", "jax paged decode")
    spy(tst, "fused_o_mlp_stacked", "port fused tail")
    spy(tst, "paged_flash_decode_int8", "port paged decode")
    spy(tst, "paged_flash_decode_reference", "port paged decode")
    return taken


def _exact(fn, static):
    """``fn`` (jitted) compiled per argument shape with EXACT options."""
    compiled = {}

    def call(*args):
        dyn = [a for i, a in enumerate(args) if i not in static]
        leaves, tree = jax.tree_util.tree_flatten(dyn)
        key = (tuple(args[i] for i in static), tree,
               tuple((np.shape(x), str(jnp.asarray(x).dtype)) for x in leaves))
        if key not in compiled:
            compiled[key] = fn.lower(*args).compile(compiler_options=EXACT)
        return compiled[key](*dyn)
    return call


def _stats(engine):
    return {k: v for k, v in dataclasses.asdict(engine.stats).items() if "seconds" not in k}


def _compare(models, drive, **kw):
    """Run ``drive(engine) -> {request id: tokens}`` on a JAX engine and a
    port engine built with ``kw``; assert equal tokens and counters."""
    jc, jp, jl, tc, tp, tl = models
    jeng = jb.ContinuousBatchingEngine(jc, jp, jl, **kw)
    for name, static in _JITTED.items():
        setattr(jeng, name, _exact(getattr(jeng, name), static))
    teng = tb.ContinuousBatchingEngine(tc, tp, tl, device="cpu", **kw)
    jout, tout = drive(jeng), drive(teng)
    assert tout == jout
    assert _stats(teng) == _stats(jeng)
    return teng


PROMPTS = [[5, 17, 3], [9, 1, 2, 8, 4], [7], [11, 13], list(range(40, 60))]


@pytest.mark.parametrize("paged", [False, True])
def test_engine_matches_jax(models, routes, paged):
    # GIVEN five requests through two slots (slot reuse, bursts of 3, a
    # request that finishes mid-burst), on the slab or 128-token pages
    def drive(eng):
        for p in PROMPTS:
            eng.submit(p, max_new_tokens=6)
        return eng.run_until_complete(burst=3)

    # WHEN both engines run THEN tokens and counters agree, through the
    # fused tail and (paged) the paged decode in both packages
    eng = _compare(models, drive, max_batch=2, max_len=256, paged=paged, page_size=128)
    assert eng.stats.admitted == 5 and eng.stats.decode_steps % 3 == 0
    expect = {"jax fused tail", "port fused tail"}
    if paged:
        expect |= {"jax paged decode", "port paged decode"}
    assert expect <= routes


@pytest.mark.parametrize("paged", [False, True])
def test_staggered_admission_matches_jax(models, routes, paged):
    # GIVEN a request admitted while another is mid-generation, single steps
    # (logits + per-row sampling, all rows greedy)
    def drive(eng):
        a = eng.submit([4, 5, 6], max_new_tokens=8)
        eng.step()
        eng.step()
        b = eng.submit([7, 8], max_new_tokens=4)
        out = eng.run_until_complete()
        return {a: out[a], b: out[b]}

    _compare(models, drive, max_batch=4, max_len=256, paged=paged, page_size=128)


def test_chunked_prefill_with_decode_between_chunks_matches_jax(models, routes):
    # GIVEN a 48-token prompt prefilled in 16-token chunks while an earlier
    # request keeps decoding 2 steps between chunks
    rng = np.random.RandomState(1)
    short, long_ = rng.randint(0, 256, (8,)).tolist(), rng.randint(0, 256, (48,)).tolist()

    def drive(eng):
        eng.submit(short, max_new_tokens=12)
        eng.step()
        eng.submit(long_, max_new_tokens=4)
        return eng.run_until_complete(burst=2)

    eng = _compare(models, drive, max_batch=2, max_len=128, prefill_chunk=16,
                   decode_between_chunks=2)
    assert eng.stats.prefill_chunks == 4


def test_dry_pool_preempts_and_requeues_like_jax(models, routes):
    # GIVEN a pool of 3 allocatable 32-token pages (the plain route in both
    # packages) and two prompts that each need a second page mid-flight
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, 256, (n,)).tolist() for n in (28, 29)]

    def drive(eng):
        for p in prompts:
            eng.submit(p, max_new_tokens=10)
        return eng.run_until_complete(burst=4)

    # WHEN the pool runs dry THEN a request is preempted and requeued, and
    # both engines agree on every token and counter
    eng = _compare(models, drive, max_batch=2, max_len=128, paged=True, page_size=32,
                   num_pages=4, cache_overflow="requeue")
    assert eng.stats.preempt_requeued >= 1
    assert eng._alloc.num_free == 3


@pytest.mark.parametrize("policy,prompt_len,new", [("truncate", 16, 100), ("requeue", 4, 20)])
def test_slab_overflow_matches_jax(models, routes, policy, prompt_len, new):
    # GIVEN a 32-token slab row that a request outgrows
    prompt = np.random.RandomState(3).randint(0, 256, (prompt_len,)).tolist()

    def drive(eng):
        eng.submit(prompt, max_new_tokens=new)
        return eng.run_until_complete(burst=8 if policy == "truncate" else 4)

    eng = _compare(models, drive, max_batch=2, max_len=32, cache_overflow=policy)
    r = next(iter(eng._done.values()))
    assert r.truncated == (policy == "truncate")


def test_admission_cap_counts_the_bucketed_group(models):
    # GIVEN a slab engine whose admission KV budget holds three rows of the
    # transient (the prompt bucket rounded to 256 positions)
    *_, tc, tp, tl = models
    eng = tb.ContinuousBatchingEngine(tc, tp, tl, max_batch=4, max_len=256, device="cpu")
    per_row = 2 * tc.num_layers * tc.num_kv_heads * 256 * tc.head_dim * (1 + 4 / tc.head_dim)
    eng._ADMIT_KV_BUDGET = int(3 * per_row)
    created = []
    create = tst.StackedKVCache.create

    def spy(*args, **kwargs):
        cache = create(*args, **kwargs)
        created.append(cache)
        return cache

    for p in ([1, 2], [3, 4, 5], [6]):
        eng.submit(p, max_new_tokens=2)
    # WHEN it admits the three pending requests
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tb.StackedKVCache, "create", spy)
        eng._admit()
    # THEN the group is two: three would allocate a bucket of four rows
    small = created[0]
    nbytes = sum(t.numel() * t.element_size()
                 for t in (small.k, small.v, small.k_scale, small.v_scale))
    assert eng.num_active == 2 and len(eng._pending) == 1
    assert nbytes <= eng._ADMIT_KV_BUDGET
    assert eng._admit_cap(2) == 2 and tb.ContinuousBatchingEngine._ADMIT_KV_BUDGET == 1 << 30


def test_sampling_engine_serves_mixed_requests(models):
    # GIVEN an engine with temperature / top-k / top-p requests beside a
    # greedy one, in both flows
    *_, tc, tp, tl = models
    for paged in (False, True):
        eng = tb.ContinuousBatchingEngine(
            tc, tp, tl, max_batch=2, max_len=256, paged=paged, page_size=128, device="cpu",
            sampling=SamplingParams(temperature=0.9, top_k=16), seed=7)
        a = eng.submit([1, 2, 3], max_new_tokens=5)
        b = eng.submit([4, 5], max_new_tokens=3,
                       sampling=SamplingParams(temperature=1.2, top_k=20, top_p=0.9))
        c = eng.submit([4, 5], max_new_tokens=4, sampling=SamplingParams(temperature=0.0))
        out = eng.run_until_complete(burst=2)
        # THEN every request completes with in-vocabulary tokens
        assert [len(out[r]) for r in (a, b, c)] == [5, 3, 4]
        assert all(0 <= t < tc.vocab_size for r in (a, b, c) for t in out[r])


def test_engine_rejects_what_cannot_run(models):
    *_, tc, tp, tl = models
    eng = tb.ContinuousBatchingEngine(tc, tp, tl, max_batch=2, max_len=256, paged=True,
                                      page_size=128, num_pages=2, device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(list(range(300)))
    with pytest.raises(ValueError, match="pool"):
        eng.submit(list(range(200)))
    eng.submit([1, 2, 3])
    eng._alloc.free.clear()  # pages leaked behind the allocator's back
    with pytest.raises(RuntimeError, match="cannot make progress"):
        eng.run_until_complete()
    with pytest.raises(ValueError, match="multiple"):
        tb.ContinuousBatchingEngine(tc, tp, tl, max_len=300, paged=True, device="cpu")
    with pytest.raises(ValueError, match="policy"):
        tb.ContinuousBatchingEngine(tc, tp, tl, cache_overflow="drop", device="cpu")
