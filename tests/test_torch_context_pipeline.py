"""The port's ring attention, GPipe pipeline and dry run
(`fastforward_tpu_torch/parallel/context.py`, `pipeline.py`, `dryrun.py`)
against the JAX package's (`fastforward_tpu/parallel/context.py`,
`pipeline.py`, `__graft_entry__.py:48`), on the CPU.

The JAX side runs in the pytest process on the conftest's virtual devices;
the port's in four gloo processes (`tests/torch_dist.py`, one spawn for the
module, no JAX). Ring attention at sp 2 (two rings of two ranks) and sp 4,
causal and not, f32 and bf16: within atol 2e-5 of JAX's
`context_parallel_attention` in f32 (the JAX test's tolerance,
`tests/parallel/test_context.py:37`) and within 8e-3 of the largest output
in bf16 (another summation order of bf16 products), every rank holding the
same full output. The pipeline of four w4a8_2l g128 `QuantLinear` layers
(f32 out) at 1, 2 and 4 stages and 4 microbatches: bit-equal to JAX's
`pipeline_forward` (jitted, ``xla_allow_excess_precision=False``) and to
the port's own sequential loop; both of JAX's ValueErrors, and JAX's
message for a sequence that does not split. The dry run at 4 ranks: JAX's
shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fastforward_tpu.parallel import make_mesh
from fastforward_tpu.parallel.context import context_parallel_attention
from fastforward_tpu.parallel.pipeline import pipeline_forward
from fastforward_tpu.serving.engine import QuantLinear, quantize_linear
from tests import torch_dist

pytestmark = pytest.mark.multi_device

EXACT = {"xla_allow_excess_precision": False}
RING_ATOL = 2e-5  # f32, tests/parallel/test_context.py:37
RING_BF16_RTOL = 8e-3  # bf16: share of the largest output
B, H, T, D = 2, 4, 32, 16
RINGS = [(sp, causal, dtype) for sp in (2, 4) for causal in (True, False)
         for dtype in ("float32", "bfloat16")]
STAGES = (1, 2, 4)
L, HID, NB, M = 4, 256, 8, 4


def _jit(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=EXACT)(*args)


@pytest.fixture(scope="module")
def run():
    rs = np.random.RandomState(0)
    ring_cases, want_ring = [], []
    for sp, causal, dtype in RINGS:
        # bf16 inputs as the f32 values of their bf16 roundings
        qkv = [np.asarray(jnp.asarray(rs.randn(B, H, T, D), jnp.float32).astype(dtype)
                          .astype(jnp.float32)) for _ in range(3)]
        mesh = make_mesh({"sp": sp}, devices=jax.devices()[:sp])
        args = [jnp.asarray(a).astype(dtype) for a in qkv]
        out = jax.jit(lambda q, k, v, mesh=mesh, causal=causal: context_parallel_attention(
            mesh, q, k, v, axis_name="sp", causal=causal))(*args)
        want_ring.append(np.asarray(out.astype(jnp.float32)))
        axes = {"sp": 4} if sp == 4 else {"rep": 2, "sp": 2}
        ring_cases.append(dict(axes=axes, causal=causal, dtype=dtype, q=qkv[0], k=qkv[1],
                               v=qkv[2]))
    ws = [rs.randn(HID, HID).astype(np.float32) / np.sqrt(HID) for _ in range(L)]
    qls = [quantize_linear(jnp.asarray(w), "w4a8_2l", group_size=128) for w in ws]
    layers = QuantLinear(data=jnp.stack([q.data for q in qls]),
                         scale=jnp.stack([q.scale for q in qls]), mode="w4a8_2l",
                         group_size=128, mult=jnp.stack([q.mult for q in qls]),
                         paired=qls[0].paired)
    x = rs.randn(NB, HID).astype(np.float32)
    want_pp = []
    for stages in STAGES:
        mesh = make_mesh({"stage": stages}, devices=jax.devices()[:stages])
        want_pp.append(np.asarray(_jit(lambda lay, h, mesh=mesh: pipeline_forward(
            mesh, lay, h, lambda ql, a: ql(a, out_dtype=jnp.float32), n_microbatches=M),
            layers, jnp.asarray(x))))
    errors = {}
    mesh2 = make_mesh({"stage": 2}, devices=jax.devices()[:2])
    for name, call in (
            ("batch", lambda: pipeline_forward(mesh2, layers, jnp.asarray(x[:5]),
                                               lambda ql, a: ql(a), n_microbatches=2)),
            ("layers", lambda: pipeline_forward(
                mesh2, jax.tree.map(lambda t: t[:3], layers), jnp.asarray(x),
                lambda ql, a: ql(a), n_microbatches=2)),
            ("ring", lambda: context_parallel_attention(
                make_mesh({"sp": 4}, devices=jax.devices()[:4]),
                *(jnp.zeros((1, 2, 6, 8)) for _ in range(3))))):
        with pytest.raises(ValueError) as e:
            call()
        errors[name] = str(e.value)
    payload = dict(ring=ring_cases, x=x, pipeline=[
        dict(axes={"stage": 4} if s == 4 else {"rep": 4 // s, "stage": s}, microbatches=M)
        for s in STAGES],
        layers=dict(data=np.asarray(layers.data), scale=np.asarray(layers.scale),
                    mult=np.asarray(layers.mult), paired=bool(layers.paired), group_size=128))
    ranks = torch_dist.run(4, "context_pipeline", payload)
    return dict(ring=want_ring, pp=want_pp, errors=errors), ranks


@pytest.mark.parametrize("i", range(len(RINGS)), ids=[f"sp{s}-{'causal' if c else 'full'}-{d}"
                                                     for s, c, d in RINGS])
def test_ring_attention_matches_jax(run, i):
    want, ranks = run
    sp, causal, dtype = RINGS[i]
    ref = want["ring"][i]
    for res in ranks:  # every rank holds the full (B, H, T, D) output
        got = res["ring"][i]
        assert got.shape == ref.shape == (B, H, T, D)
        if dtype == "float32":
            np.testing.assert_allclose(got, ref, rtol=0, atol=RING_ATOL)
        else:
            assert np.abs(got - ref).max() <= RING_BF16_RTOL * np.abs(ref).max()
        np.testing.assert_array_equal(got, ranks[0]["ring"][i])


@pytest.mark.parametrize("i", range(len(STAGES)), ids=[f"stages{s}" for s in STAGES])
def test_pipeline_bit_equal_to_jax_and_the_sequential_loop(run, i):
    want, ranks = run
    for res in ranks:
        got = res["pipeline"][i]
        assert got.shape == (NB, HID)
        np.testing.assert_array_equal(got, want["pp"][i])
        np.testing.assert_array_equal(got, res["sequential"])


def test_errors_are_jax_errors(run):
    want, ranks = run
    for res in ranks:
        # the pipeline's two ValueErrors word for word
        assert res["errors"]["batch"] == want["errors"]["batch"] == \
            "batch 5 not divisible by 2 microbatches"
        assert res["errors"]["layers"] == want["errors"]["layers"] == \
            "3 layers not divisible by 2 stages"
        # a sequence that does not split over sp: JAX's shard_map error, in brief
        part = "maps array axis 2 (of size 6) to mesh axis 'sp' (of size 4), but 4 does not " \
               "evenly divide 6"
        assert part in res["errors"]["ring"] and part in want["errors"]["ring"]


def test_dryrun_multichip_at_four_ranks(run):
    _, ranks = run
    for res in ranks:
        shapes = res["dryrun"]
        # JAX's dry run on 4 devices: a (dcn 1, data 2, model 2) mesh, batch 4
        assert shapes["mesh"] == {"dcn": 1, "data": 2, "model": 2}
        assert shapes["serve"] == (4, 8, 512)
        assert shapes["tp"] == shapes["paged"] == (4, 1, 512)
        assert shapes["pool"] == (2, 8, 4, 16, 32)
        assert shapes["loop"] == (4, 3)
        assert shapes["sp"] == (2, 4, 32, 32)
        assert shapes["pp"] == (8, 256) and shapes["ep"] == (4, 64)
        assert shapes["line"].startswith("dryrun_multichip OK: mesh={'dcn': 1, 'data': 2, ")
