"""The port's tensor-parallel serving (`fastforward_tpu_torch/parallel/tp_serving.py`)
against the JAX package's shard_map TP (`fastforward_tpu/parallel/tp_serving.py`),
on the CPU.

The JAX side runs in the pytest process on 4 of the conftest's virtual
devices: `make_tp_decode_step` iterated, and `make_tp_decode_loop` greedy
and sampled, over the slab and the paged pool, compiled with
``xla_allow_excess_precision=False`` (as the port computes eagerly), with the model config of
`tests/parallel/test_tp_serving.py` (hidden 128, 8 heads of 16, 4 kv
heads, 2 layers, groups of 32). It takes the decode routes the port takes
(the stacked-KV flow with its append and flash decode, `_serving_on_tpu`
read as true, ``FF_KV_STACKED=force``), each kernel on its CPU path. The
port's side runs in 4 gloo processes (`tests/torch_dist.py`, one spawn for
the module) that import the port and never JAX; each cuts its shard of the
whole weights and cache (`shard_for_tp`). Meshes: data 2 x model 2 (tp 2)
and data 1 x model 4 (tp 4).

Held: each step's logits bit-equal to JAX's on every rank (tp 2 and 4,
w8a8, w4a8_2l, w4a4_2l: each shard quantizes its own rows, and the
row-parallel sums are XLA's: bf16 partials summed in f32 and rounded once,
`tp_all_reduce`), so the greedy tokens too; the greedy loop (fused argmax
head) and the sampled loop at top_k 1 give JAX's greedy loop tokens; at
top_k 8 the model ranks of a data shard draw the same tokens, each lies in
JAX's top 8 of JAX's TP step logits fed the port's tokens (the convention
of `tests/test_torch_preblock.py`), and two data shards fed the same token
draw their own streams; fused layers are unfused and give the
unfused tokens; the paged pool (pages over data, local page ids) gives
JAX's logits; kv heads that do not divide over the model dim raise JAX's
error.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fastforward_tpu.models.llama import LlamaConfig as JConfig
from fastforward_tpu.parallel import make_mesh
from fastforward_tpu.parallel import tp_serving as jtp
from fastforward_tpu.serving import stacked as js
from fastforward_tpu.serving.paged import PagedKVCache as JPaged
from fastforward_tpu.serving.sampling import SamplingParams
from tests import torch_dist
from tests.test_torch_serving import EXACT, jax_to_flat

pytestmark = pytest.mark.multi_device

KW = dict(vocab_size=256, hidden_size=128, intermediate_size=256, num_layers=2, num_heads=8,
          num_kv_heads=4, head_dim=16, max_seq_len=64)
B, S, STEPS = 2, 16, 4
MESHES = {"tp2": {"data": 2, "model": 2}, "tp4": {"data": 1, "model": 4}}
WORLD = 4


def _rows(axes):
    d = axes["data"]
    return [(i * B // d, (i + 1) * B // d) for i in range(d)]


def _exact(fn, *args):
    """``fn`` (a jitted JAX function) compiled as written
    (``xla_allow_excess_precision`` off, as the port computes it eagerly)
    and run."""
    return fn.lower(*args).compile(compiler_options=EXACT)(*args)


def _jmesh(axes):
    return make_mesh(dict(axes), devices=jax.devices()[:WORLD])


def _fresh(jc):
    return js.StackedKVCache.create(jc.num_layers, B, S, jc.num_kv_heads, jc.head_dim,
                                    quantized=True)


def _jax_steps(jc, params, stacked, axes, token0):
    mesh = _jmesh(axes)
    p, s, c = jtp.shard_for_tp(params, stacked, _fresh(jc), mesh, config=jc)
    step = jtp.make_tp_decode_step(jc, mesh, stacked, params, _fresh(jc))
    tok, logits = token0, []
    for i in range(STEPS):
        lg, c = _exact(step, p, s, c, tok, jnp.asarray([i], jnp.int32))
        logits.append(np.asarray(lg))
        tok = jnp.argmax(lg[:, -1], -1).astype(tok.dtype)[:, None]
    return logits


def _jax_loop(jc, params, stacked, axes, token0, sampling=None, key=None):
    mesh = _jmesh(axes)
    p, s, c = jtp.shard_for_tp(params, stacked, _fresh(jc), mesh, config=jc)
    loop = jtp.make_tp_decode_loop(jc, mesh, stacked, params, _fresh(jc), STEPS + 2,
                                   sampling=sampling, donate=False)
    args = (p, s, c, token0) + (() if key is None else (key,))
    return np.asarray(_exact(loop, *args)[0])


def _paged_case(jc, params, stacked):
    """JAX's paged TP case (`tests/parallel/test_tp_serving.py:88`) on data
    2 x model 2: a 6-token prefill copied into a pool of 8 pages of 8, the
    tables of local page ids; returns (JAX TP logits, pool arrays)."""
    L, page, mp = jc.num_layers, 8, 2
    rng = np.random.RandomState(0)
    prompt = jnp.asarray(rng.randint(0, 256, (B, 6)))
    slab = js.StackedKVCache.create(L, B, S, jc.num_kv_heads, jc.head_dim, quantized=True)
    prefill = jax.jit(lambda p, l, c, i: js.serving_forward_stacked(p, l, jc, i, cache=c))
    logits, slab = _exact(prefill, params, stacked, slab, prompt)
    token = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
    pool = JPaged.create(num_layers=L, num_pages=8, batch_size=B, max_pages_per_seq=mp,
                         num_kv_heads=jc.num_kv_heads, head_dim=jc.head_dim, page_size=page)
    arrays = {n: np.array(getattr(pool, n)) for n in ("k", "v", "k_scale", "v_scale")}
    for b, row in enumerate([[3, 1], [6, 4]]):  # global ids; local [[3, 1], [2, 0]]
        for i, pid in enumerate(row):
            for n, src in (("k", slab.k), ("v", slab.v), ("k_scale", slab.k_scale),
                           ("v_scale", slab.v_scale)):
                arrays[n][:, pid] = np.asarray(src)[:, b, :, i * page:(i + 1) * page]
    arrays["table"] = np.asarray([[3, 1], [2, 0]], np.int32)
    cache = dataclasses.replace(pool, **{n: jnp.asarray(a) for n, a in arrays.items()},
                                length=6)
    mesh = _jmesh(MESHES["tp2"])
    p, s, c = jtp.shard_for_tp(params, stacked, cache, mesh)
    step = jtp.make_tp_decode_step(jc, mesh, stacked, params, cache)
    lg, _ = _exact(step, p, s, c, token, jnp.asarray([6], jnp.int32))
    return np.asarray(lg), arrays, np.asarray(token)


@pytest.fixture(scope="module")
def tp_run():
    """(JAX results, payload cases, the port's per-rank results), one spawn."""
    jc = JConfig(**KW, dtype=jnp.float32)
    token0 = np.random.RandomState(1).randint(0, 256, (B, 1)).astype(np.int32)
    jax_out, cases = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(js, "_serving_on_tpu", lambda: True)
        mp.setenv("FF_KV_STACKED", "force")
        weights = {m: js.random_stacked_params(jc, m, seed=0, group_size=32)
                   for m in ("w8a8", "w4a8_2l", "w4a4_2l")}

        def add(name, want, **case):
            jax_out.append((name, want))
            cases.append(dict(case, config=KW, batch=B, max_len=S, steps=case.get("steps", STEPS),
                              tokens=token0))

        for mode, (params, stacked) in weights.items():
            for mesh_name, axes in MESHES.items():
                add(f"step-{mode}-{mesh_name}",
                    _jax_steps(jc, params, stacked, axes, jnp.asarray(token0)),
                    kind="step", axes=axes, rows=_rows(axes),
                    flat=jax_to_flat(params, stacked))
        params, stacked = weights["w4a8_2l"]
        flat = jax_to_flat(params, stacked)
        for mesh_name, axes in MESHES.items():
            add(f"loop-{mesh_name}", _jax_loop(jc, params, stacked, axes, jnp.asarray(token0)),
                kind="loop", axes=axes, rows=_rows(axes), flat=flat, steps=STEPS + 2)
        greedy = jax_out[-2][1]  # tp 2
        add("sampled-top1", greedy, kind="loop", axes=MESHES["tp2"], rows=_rows(MESHES["tp2"]),
            flat=flat, steps=STEPS + 2, sampling=dict(temperature=0.8, top_k=1), seed=5)
        add("sampled-top8", _jax_loop(jc, params, stacked, MESHES["tp2"], jnp.asarray(token0),
                                      SamplingParams(temperature=0.8, top_k=8),
                                      jax.random.PRNGKey(7)),
            kind="loop", axes=MESHES["tp2"], rows=_rows(MESHES["tp2"]), flat=flat,
            steps=STEPS + 2, sampling=dict(temperature=0.8, top_k=8), seed=7)
        same = np.repeat(token0[:1], B, axis=0)  # both data shards fed the same token
        jax_out.append(("sampled-streams", None))
        cases.append(dict(kind="loop", config=KW, axes=MESHES["tp2"], rows=_rows(MESHES["tp2"]),
                          flat=flat, steps=STEPS + 2, sampling=dict(temperature=0.8, top_k=8),
                          seed=7, batch=B, max_len=S, tokens=same))
        fused = js.fuse_stacked_layers(stacked)
        add("fused", greedy, kind="loop", axes=MESHES["tp2"], rows=_rows(MESHES["tp2"]),
            flat=jax_to_flat(params, fused), steps=STEPS + 2)
        logits, pool, token = _paged_case(jc, params, stacked)
        jax_out.append(("paged", logits))
        cases.append(dict(kind="step", config=KW, axes=MESHES["tp2"], rows=_rows(MESHES["tp2"]),
                          flat=flat, pool=pool, length=6, tokens=token, steps=1, batch=B,
                          max_len=S, positions0=6))
        bad = dict(KW, num_kv_heads=2)
        jbad = JConfig(**bad, dtype=jnp.float32)
        bp, bs = js.random_stacked_params(jbad, "w8a8", seed=0)
        with pytest.raises(ValueError, match="num_kv_heads") as err:
            jtp.make_tp_decode_step(jbad, _jmesh(MESHES["tp4"]), bs, bp, None)
        jax_out.append(("reject", str(err.value)))
        cases.append(dict(kind="reject", config=bad, axes=MESHES["tp4"], flat=jax_to_flat(bp, bs)))
    ranks = torch_dist.run(WORLD, "tp", cases)
    return jax_out, cases, ranks, (jc, weights["w4a8_2l"])


def _case(tp_run, name):
    jax_out, cases, ranks, _ = tp_run
    i = [n for n, _ in jax_out].index(name)
    return jax_out[i][1], cases[i], [r[i] for r in ranks]


def _gather(case, ranks, key):
    """The ranks' per-data-shard results stacked over the batch, after
    checking the model ranks of each data shard agree bit for bit."""
    d = case["axes"]["data"]
    tp = WORLD // d
    shards = []
    for i in range(d):
        group = [ranks[i * tp + m][key] for m in range(tp)]
        for g in group[1:]:
            np.testing.assert_array_equal(np.asarray(group[0]), np.asarray(g))
        shards.append(group[0])
    return shards


@pytest.mark.parametrize("mode", ["w8a8", "w4a8_2l", "w4a4_2l"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_tp_step_logits_bit_equal_to_jax(tp_run, mode, mesh_name):
    want, case, ranks = _case(tp_run, f"step-{mode}-{mesh_name}")
    shards = _gather(case, ranks, "logits")
    for i in range(STEPS):
        got = np.concatenate([s[i] for s in shards], axis=0)
        assert got.shape == want[i].shape == (B, 1, KW["vocab_size"])
        np.testing.assert_array_equal(got, want[i])


@pytest.mark.parametrize("name", ["loop-tp2", "loop-tp4", "sampled-top1", "fused"])
def test_tp_loops_give_jax_greedy_tokens(tp_run, name):
    want, case, ranks = _case(tp_run, name)
    got = np.concatenate(_gather(case, ranks, "tokens"), axis=0)
    assert got.shape == (B, STEPS + 2)
    np.testing.assert_array_equal(got, want)
    assert all(r["length"] == STEPS + 2 for r in ranks)


def test_tp_sampled_loop_draws_from_jax_top_k(tp_run, monkeypatch):
    # GIVEN the port's top_k 8 draws at tp 2 (model ranks agree)
    want, case, ranks = _case(tp_run, "sampled-top8")
    got = np.concatenate(_gather(case, ranks, "tokens"), axis=0)
    assert got.shape == want.shape == (B, STEPS + 2)
    # WHEN JAX's TP step computes each step's logits, fed the port's tokens
    monkeypatch.setattr(js, "_serving_on_tpu", lambda: True)
    monkeypatch.setenv("FF_KV_STACKED", "force")
    jc, (params, stacked) = tp_run[3]
    mesh = _jmesh(MESHES["tp2"])
    p, s, c = jtp.shard_for_tp(params, stacked, _fresh(jc), mesh, config=jc)
    step = jtp.make_tp_decode_step(jc, mesh, stacked, params, _fresh(jc))
    tok = jnp.asarray(case["tokens"])
    for i in range(STEPS + 2):
        lg, c = _exact(step, p, s, c, tok, jnp.asarray([i], jnp.int32))
        top = np.argsort(-np.asarray(lg[:, -1]), axis=-1)[:, :8]
        # THEN each drawn token lies in JAX's top 8 of those logits
        assert all(got[b, i] in top[b] for b in range(B)), (i, got[:, i], top)
        tok = jnp.asarray(got[:, i].astype(np.int32))[:, None]


def test_tp_sampled_loop_streams(tp_run):
    # GIVEN both data shards fed the same token and the same seed, at top_k 8
    _, case, ranks = _case(tp_run, "sampled-streams")
    shards = _gather(case, ranks, "tokens")  # the model ranks of a shard agree
    assert all(t.shape == (1, STEPS + 2) for t in shards)
    # THEN each data shard draws its own stream (JAX folds the data index
    # into its key): their tokens differ
    assert not np.array_equal(shards[0], shards[1])


def test_tp_paged_logits_bit_equal_to_jax(tp_run):
    want, case, ranks = _case(tp_run, "paged")
    got = np.concatenate([s[0] for s in _gather(case, ranks, "logits")], axis=0)
    np.testing.assert_array_equal(got, want)


def test_tp_rejects_indivisible_heads_with_jax_error(tp_run):
    want, case, ranks = _case(tp_run, "reject")
    assert all(r == want for r in ranks)
    assert "num_kv_heads=2 must divide over tp=4" in want
