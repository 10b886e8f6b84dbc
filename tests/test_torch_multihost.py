"""The port's multi-host pieces (`fastforward_tpu_torch/parallel/multihost.py`)
against the JAX package's (`fastforward_tpu/parallel/multihost.py`), on the
CPU.

Four gloo processes (`tests/torch_dist.py`, one spawn for the module, no
JAX) stand for 2 "hosts" of 2 devices: `make_hybrid_mesh` gives the
(dcn 2, model 2) mesh, host-major (ranks 0, 1 the first host), and
`host_local_batch_slice` each host's half of a batch of 8; both refuse
what JAX's refuse. A TP decode step with the batch over ``dcn``
(`make_tp_decode_step(..., data_axis="dcn")`: weights replicated over
hosts, heads split over ``model``) gives, for 3 steps, the logits of
JAX's step over the same (dcn, model) mesh of 4 virtual devices, bit for
bit (compiled with ``xla_allow_excess_precision=False``, as in
`tests/test_torch_tp_serving.py`). `initialize_distributed` is checked in
the pytest process on a one-process gloo group from the environment.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

from fastforward_tpu.models.llama import LlamaConfig as JConfig
from fastforward_tpu.parallel import tp_serving as jtp
from fastforward_tpu.serving import stacked as js
from fastforward_tpu_torch.parallel import initialize_distributed
from tests import torch_dist
from tests.test_torch_serving import EXACT, jax_to_flat

pytestmark = pytest.mark.multi_device

KW = dict(vocab_size=256, hidden_size=128, intermediate_size=256, num_layers=2, num_heads=8,
          num_kv_heads=4, head_dim=16, max_seq_len=64)
B, S, STEPS = 2, 16, 3


@pytest.fixture(scope="module")
def run():
    jc = JConfig(**KW, dtype=jnp.float32)
    token0 = np.random.RandomState(2).randint(0, 256, (B, 1)).astype(np.int32)
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("dcn", "model"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(js, "_serving_on_tpu", lambda: True)
        mp.setenv("FF_KV_STACKED", "force")
        params, stacked = js.random_stacked_params(jc, "w4a8_2l", seed=0, group_size=32)

        def fresh():
            return js.StackedKVCache.create(2, B, S, 4, 16, quantized=True)

        p, s, c = jtp.shard_for_tp(params, stacked, fresh(), mesh, data_axis="dcn")
        step = jtp.make_tp_decode_step(jc, mesh, stacked, params, fresh(), data_axis="dcn")
        tok, logits = jnp.asarray(token0), []
        for i in range(STEPS):
            args = (p, s, c, tok, jnp.asarray([i], jnp.int32))
            lg, c = step.lower(*args).compile(compiler_options=EXACT)(*args)
            logits.append(np.asarray(lg))
            tok = jnp.argmax(lg[:, -1], -1).astype(tok.dtype)[:, None]
    case = dict(kind="step", config=KW, axes={"dcn": 2, "model": 2}, data_axis="dcn",
                rows=[(0, 1), (1, 2)], flat=jax_to_flat(params, stacked), tokens=token0,
                batch=B, max_len=S, steps=STEPS)
    return logits, torch_dist.run(4, "multihost", [case])


def test_hybrid_mesh_is_host_major(run):
    _, ranks = run
    for r, res in enumerate(ranks):
        assert res["names"] == ("dcn", "model") and res["shape"] == (2, 2)
        assert res["coord"] == (r // 2, r % 2)


def test_host_local_batch_slice(run):
    _, ranks = run
    for r, res in enumerate(ranks):
        assert res["slice"] == slice(4 * (r // 2), 4 * (r // 2) + 4)
        # JAX's errors for a batch that does not split, and for ici axes
        # that do not cover a host's devices
        assert res["slice_error"] == "global batch 7 not divisible by 2 hosts"
        assert res["axes_error"] == "ici axes {'model': 3} do not cover 2 local devices"


def test_tp_step_with_the_batch_over_dcn_bit_equal_to_jax(run):
    want, ranks = run
    shards = []
    for host in (0, 1):
        a, b = (ranks[2 * host + m]["tp"][0]["logits"] for m in (0, 1))
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)  # both model ranks of a host
        shards.append(a)
    for i in range(STEPS):
        np.testing.assert_array_equal(np.concatenate([s[i] for s in shards], axis=0), want[i])


def test_initialize_distributed_from_the_environment(monkeypatch):
    # GIVEN the launcher's environment for a one-process group
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(torch_dist._free_port()))
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    assert not dist.is_initialized()
    try:
        # WHEN it initializes (twice: the second call is a no-op)
        initialize_distributed(backend="gloo")
        initialize_distributed(backend="gloo")
        # THEN the group is up, and a collective runs over it
        assert dist.get_world_size() == 1 and dist.get_rank() == 0
        t = torch.ones(3)
        dist.all_reduce(t)
        assert torch.equal(t, torch.ones(3))
    finally:
        dist.destroy_process_group()
