"""The port's sharded per-layer forward (`fastforward_tpu_torch/parallel/sharding.py`)
against the JAX package's GSPMD placement (`fastforward_tpu/parallel/sharding.py`),
on the CPU.

JAX places the per-layer params and cache on 4 of the conftest's virtual
devices and runs its jitted single-device `serving_forward` on them (GSPMD
partitions it); the port's 4 gloo processes (`tests/torch_dist.py`, one
spawn for the module, no JAX) cut their shards and run
`sharded_serving_forward`, which computes that single-device function:
row-parallel projections quantize by the whole row's amax and sum f32
partial products, the lm_head's logits are gathered. Config and bounds
are `tests/parallel/test_sharding.py`'s (hidden 128, 8 heads of 16, 4 kv
heads; rtol 2e-2, atol 5e-2, `:41`). JAX's forwards are compiled with
``xla_allow_excess_precision=False``: its default compile keeps f32 where
the program rounds to bf16, and differs from the function as written by up
to 0.157 in these logits, both sharded and not.

How close it comes: in w8a8 the logits are bit-equal to JAX's GSPMD and
single-device logits, at tp 4 and in a prefill into a cache sharded over
data 2 x model 2 (the integer partial products are exact, and their f32
sums round to the same bf16 outputs at these shapes). In w4a16 (groups of
32) they are within the JAX bounds, 0.0156 from JAX's single-device logits
(the port's single-device W4A16 GEMV is that far too: its bf16 sums follow
the TPU route's order) and 0.0428 from JAX's GSPMD logits, of a largest
logit of 5.2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from fastforward_tpu.models.llama import LlamaConfig as JConfig
from fastforward_tpu.parallel import make_mesh, shard_kv_cache, shard_serving_params
from fastforward_tpu.serving import KVCache
from fastforward_tpu.serving.engine import random_serving_params, serving_forward
from tests import torch_dist
from tests.test_torch_serving_forward import EXACT, jax_params_to_flat

pytestmark = pytest.mark.multi_device

KW = dict(vocab_size=256, hidden_size=128, intermediate_size=256, num_layers=2, num_heads=8,
          num_kv_heads=4, head_dim=16, max_seq_len=64)
WORLD = 4
RTOL, ATOL = 2e-2, 5e-2  # tests/parallel/test_sharding.py:41


def _exact(fn, *args):
    return fn.lower(*args).compile(compiler_options=EXACT)(*args)


def _mesh(axes):
    return make_mesh(dict(axes), devices=jax.devices()[:WORLD])


@pytest.fixture(scope="module")
def run():
    jc = JConfig(**KW, dtype=jnp.float32)
    fwd = jax.jit(lambda p, i: serving_forward(p, jc, i)[0])
    out, cases = [], []
    tp4 = {"data": 1, "model": 4}
    for mode, g in (("w8a8", 128), ("w4a16", 32)):
        params = random_serving_params(jc, mode=mode, seed=0, group_size=g)
        ids = np.random.RandomState(0).randint(0, 256, (2, 8)).astype(np.int32)
        single = np.asarray(_exact(fwd, params, jnp.asarray(ids)))
        gspmd = np.asarray(_exact(fwd, shard_serving_params(params, _mesh(tp4)), jnp.asarray(ids)))
        whole_o = params.layers[0].o_proj.data.shape[0]
        out.append((f"forward-{mode}", (single, gspmd, whole_o)))
        cases.append(dict(axes=tp4, config=KW, flat=jax_params_to_flat(params), ids=ids))
    # a decode prefill into a cache sharded over data 2 x model 2
    dp = {"data": 2, "model": 2}
    mesh = _mesh(dp)
    params = random_serving_params(jc, mode="w8a8", seed=1)
    ids = np.random.RandomState(1).randint(0, 256, (4, 4)).astype(np.int32)
    cache = shard_kv_cache(KVCache.create(num_layers=2, batch_size=4, max_len=16,
                                          num_kv_heads=4, head_dim=16, quantized=True), mesh)
    step = jax.jit(lambda p, c, i: serving_forward(p, jc, i, cache=c))
    logits, jcache = _exact(step, shard_serving_params(params, mesh), cache, jax.device_put(
        jnp.asarray(ids), NamedSharding(mesh, P("data", None))))
    single, _ = _exact(step, params, KVCache.create(num_layers=2, batch_size=4, max_len=16,
                                                    num_kv_heads=4, head_dim=16, quantized=True),
                       jnp.asarray(ids))
    out.append(("decode", (np.asarray(single), np.asarray(logits))))
    cases.append(dict(axes=dp, config=KW, flat=jax_params_to_flat(params), ids=ids,
                      cache=(4, 16)))
    # a group whose row shards would split groups: JAX's error
    bad = random_serving_params(jc, mode="w4a16", seed=0, group_size=64)
    with pytest.raises(ValueError, match="row-shard") as err:
        shard_serving_params(bad, _mesh(tp4))
    out.append(("reject", str(err.value)))
    cases.append(dict(axes=tp4, config=KW, flat=jax_params_to_flat(bad), ids=ids))
    return out, torch_dist.run(WORLD, "sharded", cases)


def _get(run, name):
    out, ranks = run
    i = [n for n, _ in out].index(name)
    return out[i][1], [r[i] for r in ranks]


@pytest.mark.parametrize("mode", ["w8a8", "w4a16"])
def test_sharded_forward_matches_gspmd_and_single_device(run, mode):
    (single, gspmd, whole_o), ranks = _get(run, f"forward-{mode}")
    # every rank holds its shard (q columns and o rows split 4 ways) and
    # the whole batch's logits (data 1), all ranks the same bits
    for r in ranks:
        assert r["q_shape"][1] * 4 == KW["num_heads"] * KW["head_dim"]
        assert r["o_shape"][0] * 4 == whole_o
        np.testing.assert_array_equal(r["logits"], ranks[0]["logits"])
    got = ranks[0]["logits"]
    assert got.shape == single.shape == (2, 8, KW["vocab_size"])
    for want in (gspmd, single):
        if mode == "w8a8":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_sharded_cache_decode_matches_gspmd(run):
    (single, gspmd), ranks = _get(run, "decode")
    # data 2 x model 2: ranks 0, 1 hold rows 0-1, ranks 2, 3 rows 2-3; the
    # cache shard is (2 rows, 2 kv heads)
    assert all(r["k_shape"] == (2, 2, 16, 16) and r["length"] == 4 for r in ranks)
    for a, b in ((0, 1), (2, 3)):
        np.testing.assert_array_equal(ranks[a]["logits"], ranks[b]["logits"])
    got = np.concatenate([ranks[0]["logits"], ranks[2]["logits"]], axis=0)
    for want in (gspmd, single):
        np.testing.assert_array_equal(got, want)


def test_row_shard_of_split_groups_raises_jax_error(run):
    want, ranks = _get(run, "reject")
    assert all(r == {"error": want} for r in ranks)

