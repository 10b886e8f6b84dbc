"""The port's MoE block (`fastforward_tpu_torch/serving/moe.py`) against the
JAX package's (`fastforward_tpu/serving/moe.py`), on the CPU.

Blocks are made by JAX's `make_moe_block` and carried into the port byte
for byte (`moe_block_from_flat`). The JAX forward runs eagerly, as
`tests/serving/test_moe.py` runs it.

Tolerances. At decode token counts (at most 256 rows: the GEMV routes)
the bf16 output is bit-equal in the modes whose products are integer
(w8a8, w4a8, w4a8_2l, w4a4_2l); the f32 output is within 2 ulp of the
largest output, because the f32 router product sums in another order than
XLA's (1 ulp in about half its logits), which moves the softmax weights by
an ulp. w4a16's GEMV sums its bf16 products in another order than the
eager JAX reference (rtol 1e-2 of the largest output). Above 256 rows the
projections dequantize and take a dense product whose f32 sums run in
another order (rtol 2e-2, the JAX test's own tolerance for its expert
parallel block). Ties in the router's top-k go to the lower expert index
in both packages.

Expert parallelism: JAX's `expert_parallel_moe` over 4 of the conftest's
virtual devices (jitted: eager shard_map takes tens of seconds, and gives
the same bits), the port's over 4 gloo processes (`tests/torch_dist.py`,
one spawn for the module) that import the port and never JAX: the bf16
outputs are bit-equal (each rank's experts and the router are those of the
single-process block; the f32 sum over 4 ranks rounds to the same bf16 at
these shapes), held at the JAX test's rtol 2e-2 against the unsharded
forward too.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastforward_tpu.parallel import make_mesh as jmake_mesh
from fastforward_tpu.serving import moe as jmoe
from fastforward_tpu_torch.serving import moe as tmoe
from fastforward_tpu_torch.serving.convert import moe_block_from_flat, moe_block_to_flat
from tests import torch_dist

EP = 4


def jax_moe_flat(block) -> dict:
    """Flat {path: numpy} dict of a JAX MoEBlock (`moe_block_from_flat`)."""
    flat = {"router": np.asarray(block.router), "top_k": np.asarray(block.top_k)}
    for name in ("gate_up", "down"):
        ql = getattr(block, name)
        for f in dataclasses.fields(ql):
            v = getattr(ql, f.name)
            if v is not None:
                flat[f"{name}.{f.name}"] = np.asarray(v)
    return flat


def _block(mode, E, g=64, seed=2, hidden=64, inter=128):
    return jmoe.make_moe_block(jax.random.PRNGKey(seed), hidden=hidden, intermediate=inter,
                               num_experts=E, mode=mode, group_size=g, top_k=2)


def _x(shape, seed=3):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32))


# (mode, group, experts, tokens)
DECODE = [("w8a8", 128, 4, 6), ("w4a8_2l", 64, 8, 10), ("w4a8", 64, 4, 6),
          ("w4a16", 64, 4, 6), ("w4a4_2l", 64, 4, 6)]


@pytest.mark.parametrize("mode,g,E,T", DECODE, ids=[c[0] for c in DECODE])
def test_moe_forward_matches_jax(mode, g, E, T):
    # GIVEN a JAX block and its bytes in the port
    b = _block(mode, E, g)
    tb = moe_block_from_flat(jax_moe_flat(b), device="cpu")
    x = _x((T, 64))
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)):
        # WHEN both run the forward
        want = np.asarray(jmoe.moe_forward(jnp.asarray(x), b, out_dtype=jdt), np.float32)
        got = tmoe.moe_forward(torch.from_numpy(x), tb, out_dtype=tdt)
        assert got.dtype == tdt and tuple(got.shape) == (T, 64)
        got = got.float().numpy()
        # THEN within the stated tolerance
        scale = np.abs(want).max()
        if mode == "w4a16":
            assert np.abs(want - got).max() <= 1e-2 * scale
        elif jdt == jnp.bfloat16:
            np.testing.assert_array_equal(want, got)
        else:
            assert np.abs(want - got).max() <= 2 * np.spacing(np.float32(scale))


def test_moe_forward_prefill_rows_within_tolerance():
    # 300 tokens (more than the GEMVs' 256 rows): dequant and dense product
    b = _block("w4a8_2l", 8)
    tb = moe_block_from_flat(jax_moe_flat(b), device="cpu")
    x = _x((3, 100, 64))
    want = np.asarray(jmoe.moe_forward(jnp.asarray(x), b, out_dtype=jnp.float32))
    got = tmoe.moe_forward(torch.from_numpy(x), tb, out_dtype=torch.float32).numpy()
    assert got.shape == want.shape == (3, 100, 64)
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2 * np.abs(want).max())


def test_route_breaks_ties_to_the_lower_index():
    # GIVEN router columns 1, 3 and 6 equal (three-way tie for the top 2)
    rs = np.random.RandomState(0)
    router = rs.randn(16, 8).astype(np.float32)
    router[:, 3] = router[:, 1]
    router[:, 6] = router[:, 1]
    x = rs.randn(5, 16).astype(np.float32)
    x[:, :] = np.abs(x) * np.sign(router[:, 1])[None, :]  # column 1's logit the largest
    jv, ji = jax.lax.top_k(jnp.asarray(x) @ jnp.asarray(router), 2)
    idx, w = tmoe.route(torch.from_numpy(x), torch.from_numpy(router), 2)
    # THEN both take experts 1 and 3, in JAX's order
    np.testing.assert_array_equal(np.asarray(ji), idx.numpy())
    assert (idx.numpy() == [1, 3]).all()
    np.testing.assert_allclose(w.numpy(), np.asarray(jax.nn.softmax(jv, axis=-1)), rtol=1e-6)


def test_make_moe_block_layouts_match_jax():
    # GIVEN blocks of the same shape from both packages (each its own random
    # values) THEN the arrays have the same shapes and dtypes, the experts
    # low-bit, and the block carries across and back byte for byte
    jb = _block("w4a8_2l", 2)
    tb = tmoe.make_moe_block(torch.Generator().manual_seed(0), 64, 128, 2, "w4a8_2l",
                             group_size=64, device="cpu")
    jf, tf = jax_moe_flat(jb), moe_block_to_flat(tb)
    assert set(jf) == set(tf)
    for k in jf:
        assert jf[k].shape == tf[k].shape, k
    assert tb.gate_up.data.dtype == torch.int8 and tuple(tb.gate_up.data.shape) == (2, 32, 256)
    assert tb.gate_up.mult is not None and tb.num_experts == 2 and tb.top_k == 2
    assert tb.router.dtype == torch.bfloat16
    back = moe_block_to_flat(moe_block_from_flat(jf, device="cpu"))
    for k in jf:
        assert np.ascontiguousarray(jf[k]).tobytes() == back[k].tobytes(), k
    y = tmoe.moe_forward(torch.randn(3, 64), tb)
    assert torch.isfinite(y.float()).all()


def test_moe_forward_rejects_a_partial_block_without_a_group():
    b = moe_block_from_flat(jax_moe_flat(_block("w8a8", 4, 128)), device="cpu")
    with pytest.raises(ValueError, match="without a group"):
        tmoe.moe_forward(torch.randn(2, 64), tmoe.expert_shard(b, 0, 2))


# (mode, group, experts, token shape): the JAX test's block, and w8a8
EP_CASES = [("w4a8_2l", 64, 8, (2, 5, 64)), ("w8a8", 128, 8, (7, 64))]


@pytest.fixture(scope="module")
def ep_run():
    """JAX's expert-parallel and single-device outputs, and the port's
    from its 4 gloo ranks (one spawn)."""
    mesh = jmake_mesh({"expert": EP}, devices=jax.devices()[:EP])
    cases, payload = [], []
    for i, (mode, g, E, shape) in enumerate(EP_CASES):
        b = _block(mode, E, g, seed=2 + i)
        x = np.asarray(jax.random.normal(jax.random.PRNGKey(3 + i), shape, jnp.bfloat16))
        xf = x.astype(np.float32)
        ep = jax.jit(lambda b, x: jmoe.expert_parallel_moe(mesh, b, x))
        cases.append((np.asarray(ep(b, jnp.asarray(x)), np.float32),
                      np.asarray(jmoe.moe_forward(jnp.asarray(x), b, out_dtype=jnp.float32))))
        payload.append({"flat": jax_moe_flat(b), "x": xf})
    return cases, torch_dist.run(EP, "moe_ep", payload)


@pytest.mark.multi_device
@pytest.mark.parametrize("case", range(len(EP_CASES)), ids=[c[0] for c in EP_CASES])
def test_expert_parallel_matches_jax(ep_run, case):
    (jep, jref), ranks = ep_run[0][case], ep_run[1]
    # THEN every rank holds the same combined output, bit-equal to JAX's
    # expert-parallel block, and within the JAX test's tolerance of the
    # unsharded forward
    outs = [r[case] for r in ranks]
    for o in outs[1:]:
        np.testing.assert_array_equal(outs[0], o)
    assert outs[0].shape == jep.shape
    np.testing.assert_array_equal(outs[0], jep)
    np.testing.assert_allclose(outs[0], jref, rtol=2e-2, atol=2e-2)
