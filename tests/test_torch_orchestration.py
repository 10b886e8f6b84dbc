"""`fastforward_tpu_torch/orchestration.py` against the JAX package's
`orchestration.py`, on the CPU: the algorithm registry (the same targets
resolved on the same model), and `trace`'s op counts, module inventory and
cost.

`trace` counts aten ops of a `make_fx` graph where JAX counts jaxpr
primitives: the names differ (``linear`` for ``dot_general``), so the
counts are held to the model's structure, not to JAX's names. The module
inventory holds JAX's (path, class) pairs (``/``-joined paths in both;
NNX lists a module after its children, torch before). The flop count is
exact: 2 M K N a product.
"""

import jax.numpy as jnp
import numpy as np
import torch
from flax import nnx

from fastforward_tpu import nn as jnn
from fastforward_tpu import orchestration as jorch
from fastforward_tpu_torch import nn as tnn
from fastforward_tpu_torch import orchestration as torch_orch
from fastforward_tpu_torch.graph import trace_modules
from fastforward_tpu_torch.nn import convert


class JMLP(nnx.Module):
    def __init__(self, *, rngs):
        self.fc1 = nnx.Linear(8, 16, rngs=rngs)
        self.fc2 = nnx.Linear(16, 4, rngs=rngs)

    def __call__(self, x):
        h = self.fc1(x)
        h = h.dequantize() if hasattr(h, "dequantize") else h
        return self.fc2(h)


class TMLP(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = torch.nn.Linear(8, 16)
        self.fc2 = torch.nn.Linear(16, 4)

    def forward(self, x):
        h = self.fc1(x)
        h = h.dequantize() if hasattr(h, "dequantize") else h
        return self.fc2(h)


def _pair(quantized=True):
    j, t = JMLP(rngs=nnx.Rngs(0)), TMLP()
    convert.load_nnx_params(t, {"/".join(str(p) for p in path): np.asarray(v[...])
                                for path, v in nnx.to_flat_state(nnx.state(j, nnx.Param))})
    if quantized:
        jnn.quantize_model(j)
        tnn.quantize_model(t)
    return j, t


def _x():
    return np.random.RandomState(0).randn(2, 8).astype(np.float32)


def test_trace_counts_inventory_and_cost():
    # GIVEN the converted MLP in both packages
    j, t = _pair()
    jg = jorch.trace(j, jnp.asarray(_x()))
    tg = torch_orch.trace(t, torch.from_numpy(_x()))
    # THEN the port counts its two Linears as two aten.linear ops, as JAX
    # counts two dot_generals
    assert tg.primitive_counts["linear"] == 2 == jg.primitive_counts["dot_general"]
    assert tg.num_equations == sum(tg.primitive_counts.values()) > 0
    # AND the module inventory is JAX's (paths and converted class names,
    # quantizer slots included), listed in torch's order
    assert sorted(tg.module_inventory) == sorted(jg.module_inventory)
    assert tg.module_inventory[0] == ("fc1", "QuantizedLinear")
    assert len(tg.module_inventory) == 10
    # AND the cost is the two products' flops
    assert tg.cost["flops"] == 2 * 2 * 8 * 16 + 2 * 2 * 16 * 4
    assert "equations:" in tg.summary() and "linear: 2" in tg.summary()
    # AND the traced graph runs the forward
    from fastforward_tpu_torch import flags

    with torch.no_grad(), flags.strict_quantization(False):
        assert torch.equal(tg.graph(torch.from_numpy(_x())), t(torch.from_numpy(_x())))


def test_trace_counts_higher_order_bodies():
    # GIVEN a forward whose products sit in a scan body
    from torch._higher_order_ops.scan import scan

    def fn(x, ws):
        return scan(lambda h, w: (torch.tanh(h @ w), h.sum()), x, ws)[0]

    class M(torch.nn.Module):
        def forward(self, x, ws):
            return fn(x, ws)

    tg = torch_orch.trace(M(), torch.randn(4, 8), torch.randn(3, 8, 8))
    # THEN the ops inside the body are counted with the scan itself
    assert tg.primitive_counts["scan"] == 1
    assert tg.primitive_counts["matmul"] == 1 and tg.primitive_counts["tanh"] == 1
    # AND no cost is given (the flop counter refuses higher-order ops)
    assert tg.cost is None and "flops" not in tg.summary()


def test_algorithm_registry_resolves_like_jax():
    # GIVEN one registration per package against the same query
    jorch.register("gptq-linears", print, "**/[cls:QuantizedLinear]", num_bits=4)
    torch_orch.register("gptq-linears", print, "**/[cls:QuantizedLinear]", num_bits=4)
    j, t = _pair()
    jspec, jtargets = jorch.resolve(j, "gptq-linears")
    tspec, ttargets = torch_orch.resolve(t, "gptq-linears")
    # THEN both resolve the same targets, kwargs and names
    assert tspec.kwargs == jspec.kwargs == {"num_bits": 4}
    assert [i.full_name for i in ttargets] == [i.full_name for i in jtargets]
    assert len(ttargets) == 2
    assert "gptq-linears" in torch_orch.registered_algorithms()


def test_reexports():
    assert torch_orch.trace_modules is trace_modules
    from fastforward_tpu_torch.algorithms.layerwise import layerwise_optimize

    assert callable(layerwise_optimize) and callable(torch_orch.layerwise_optimize)
    for name in ("GraphModule", "SubgraphSpec", "run_scheduled"):
        assert hasattr(torch_orch, name)
