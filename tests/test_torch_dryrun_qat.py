"""The dry run's QAT step in the port (`fastforward_tpu_torch/parallel/dryrun.py`
`qat_model`, `qat_step`) against the JAX package's
(`__graft_entry__.py:178-231`), on the CPU.

JAX's step is rebuilt here as the dry run writes it: a two-layer MLP (32 →
64 → 32) through `quantize_model`, 8-bit quantizers placed by two
`QuantizationConfig` rules (parameters symmetric, activations asymmetric),
every range (-3, 3), and one jitted SGD step (optax, lr 1e-3) on the MSE
of a global batch of 8 rows, differentiating every float leaf of the NNX
state (compiled with ``xla_allow_excess_precision=False``). The port takes
the same parameters (`nn.convert.load_nnx_params`) in two gloo processes
(`tests/torch_dist.py` `qat`): at world size 1, each rank over a group of
itself alone on the whole batch, and at world size 2, each rank its rows
of the batch, the gradients averaged over the ranks.

Tolerances: the loss within 1e-6 relative of JAX's; every parameter after
the step (weights, biases, the quantizers' scales and learnable offsets)
within 1e-6 of the largest |value| of its tensor (f32 gradients summed
in other orders, and over ranks), and each tensor moved by the step where
JAX's moved.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from flax import nnx

from fastforward_tpu import flags as jflags
from fastforward_tpu import nn as jnn
from fastforward_tpu import quantization as jq
from fastforward_tpu.quant_init import QuantizationConfig
from tests import torch_dist

pytestmark = pytest.mark.multi_device

EXACT = {"xla_allow_excess_precision": False}
LOSS_RTOL = 1e-6
PARAM_TOL = 1e-6
BATCH = 8


class QatMLP(nnx.Module):
    def __init__(self, rngs):
        self.fc1 = nnx.Linear(32, 64, rngs=rngs)
        self.fc2 = nnx.Linear(64, 32, rngs=rngs)

    def __call__(self, x):
        h = self.fc1(x)
        h = jax.nn.relu(h.dequantize() if isinstance(h, jq.QuantizedArray) else h)
        out = self.fc2(h)
        return out.dequantize() if isinstance(out, jq.QuantizedArray) else out


def _flat(state):
    return {"/".join(str(p) for p in path): np.asarray(v[...])
            for path, v in nnx.to_flat_state(state)}


@pytest.fixture(scope="module")
def steps():
    model = QatMLP(nnx.Rngs(0))
    jnn.quantize_model(model)
    cfg = QuantizationConfig()
    cfg.add_rule("**/[quantizer:parameter]", jnn.LinearQuantizer, num_bits=8, symmetric=True)
    cfg.add_rule("**/[quantizer:activation]", jnn.LinearQuantizer, num_bits=8, symmetric=False)
    cfg.initialize(model)
    for _, q in jnn.named_quantizers(model):
        if isinstance(q, jnn.LinearQuantizer):
            q.quantization_range = (-3.0, 3.0)
    graphdef, state = nnx.split(model)
    opt = optax.sgd(1e-3)
    x = np.random.RandomState(1).randn(BATCH, 32).astype(np.float32)
    y = np.random.RandomState(2).randn(BATCH, 32).astype(np.float32)

    def train_step(state, opt_state, x, y):
        def loss_fn(state):
            m = nnx.merge(graphdef, state)
            with jflags.strict_quantization(False):
                pred = m(x)
            return jnp.mean((pred - y) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(state)
        updates, opt_state = opt.update(grads, opt_state)
        return loss, jax.tree.map(lambda p, u: p + u, state, updates)

    args = (state, opt.init(state), jnp.asarray(x), jnp.asarray(y))
    loss, new = jax.jit(train_step).lower(*args).compile(compiler_options=EXACT)(*args)
    payload = dict(params=_flat(state), x=x, y=y)
    return dict(loss=float(loss), before=_flat(state), after=_flat(new)), \
        torch_dist.run(2, "qat", payload)


def _jax_name(port_name):
    return port_name.replace(".", "/").replace("/weight", "/kernel") \
        if port_name.endswith(".weight") else port_name.replace(".", "/")


@pytest.mark.parametrize("world", [1, 2])
def test_qat_step_matches_jax(steps, world):
    want, ranks = steps
    for res in (r[world] for r in ranks):
        # THEN every rank reports the global batch's loss
        assert abs(res["loss"] - want["loss"]) <= LOSS_RTOL * abs(want["loss"])
        assert sorted(_jax_name(n) for n in res["params"]) == sorted(want["after"])
        for name, value in res["params"].items():
            key = _jax_name(name)
            after, before = want["after"][key], want["before"][key]
            if key.endswith("kernel"):
                after, before = after.T, before.T
            value = value.reshape(after.shape)
            # AND every parameter took JAX's step, and moved where JAX's did
            assert np.abs(value - after).max() <= PARAM_TOL * np.abs(after).max(), key
            assert np.any(value != before) == np.any(after != before), key
