"""Orchestration: model tracing and the algorithm registry
(`fastforward_tpu/orchestration.py`).

  - `trace(model, *args)` captures one forward as an aten-level graph with
    `torch.fx.experimental.proxy_tensor.make_fx` and returns a
    `TracedGraph`: the `torch.fx.GraphModule`, per-op counts (aten ops, the
    counterpart of the jaxpr's primitives), the model's module inventory
    and the forward's floating-point operations from
    `torch.utils.flop_counter.FlopCounterMode` (the counterpart of XLA's
    cost analysis; the JAX package's also reports bytes, this one does not;
    a forward with a higher-order op, which the flop counter refuses, has
    no cost).
  - The algorithm registry: named (algorithm, target-query) registrations
    resolved against a model with `mpath`.
  - `layerwise_optimize` (in `algorithms.layerwise`), the execution loop,
    and the module graph of `graph.py`, re-exported.
"""

import dataclasses
from typing import Any, Callable, Optional

import torch
from torch._ops import HigherOrderOperator
from torch.fx.experimental.proxy_tensor import make_fx
from torch.utils.flop_counter import FlopCounterMode

from fastforward_tpu_torch import flags, mpath
from fastforward_tpu_torch.graph import GraphModule, SubgraphSpec, run_scheduled, trace_modules


@dataclasses.dataclass
class TracedGraph:
    """Structural and cost view of a traced model forward."""

    graph: Any  # torch.fx.GraphModule
    primitive_counts: dict[str, int]
    cost: Optional[dict[str, float]]
    module_inventory: list[tuple[str, str]]  # (path, type name)

    @property
    def num_equations(self) -> int:
        return sum(self.primitive_counts.values())

    def summary(self) -> str:
        lines = [f"equations: {self.num_equations}"]
        for name, count in sorted(self.primitive_counts.items(), key=lambda kv: -kv[1])[:20]:
            lines.append(f"  {name}: {count}")
        if self.cost:
            flops = self.cost.get("flops")
            if flops:
                lines.append(f"flops: {flops:.3e}")
        return "\n".join(lines)


def op_name(target: Any) -> str:
    """The name of an fx node's call target: an aten overload's packet name
    (``aten.addmm.default`` → ``addmm``), a higher-order op's name."""
    overload = getattr(target, "overloadpacket", None)
    if overload is not None:
        return overload.__name__
    return getattr(target, "__name__", str(target))


def _count_ops(gm: torch.fx.GraphModule, counts: dict[str, int]) -> None:
    for node in gm.graph.nodes:
        if node.op != "call_function":
            continue
        name = op_name(node.target)
        counts[name] = counts.get(name, 0) + 1
        for arg in node.args:  # the subgraphs of a higher-order op
            if isinstance(arg, torch.fx.Node) and arg.op == "get_attr":
                sub = getattr(gm, arg.target, None)
                if isinstance(sub, torch.fx.GraphModule):
                    _count_ops(sub, counts)


def trace(model: Any, *args: Any, strict: bool = False, **kwargs: Any) -> TracedGraph:
    """Trace one forward of ``model`` and return its TracedGraph.

    Runs non-strict by default (the reference traces with quantization
    disabled). The forward runs twice, once traced and once under the flop
    counter (but where the trace holds a higher-order op)."""

    def fn(*a, **k):
        with flags.strict_quantization(strict):
            return model(*a, **k)

    with torch.no_grad():
        gm = make_fx(fn, pre_dispatch=True)(*args, **kwargs)
    counts: dict[str, int] = {}
    _count_ops(gm, counts)
    cost = None
    if not any(isinstance(n.target, HigherOrderOperator) for n in gm.graph.nodes):
        counter = FlopCounterMode(display=False)
        with torch.no_grad(), counter:
            fn(*args, **kwargs)
        cost = {"flops": float(counter.get_total_flops())}
    inventory = [(name.replace(".", "/"), type(m).__name__)
                 for name, m in model.named_modules() if name]
    return TracedGraph(graph=gm, primitive_counts=counts, cost=cost,
                       module_inventory=inventory)


# --- the algorithm registry ---------------------------------------------------


@dataclasses.dataclass
class AlgorithmSpec:
    name: str
    algorithm: Callable[..., None]
    targets: str
    kwargs: dict[str, Any]


_REGISTRY: dict[str, AlgorithmSpec] = {}


def register(name: str, algorithm: Callable[..., None], targets: str,
             **kwargs: Any) -> AlgorithmSpec:
    """Register an algorithm against a target query."""
    spec = AlgorithmSpec(name, algorithm, targets, kwargs)
    _REGISTRY[name] = spec
    return spec


def resolve(model: Any, name: str, context: Optional[dict] = None):
    """Resolve a registered algorithm's targets against a model."""
    spec = _REGISTRY[name]
    return spec, mpath.search(spec.targets, model, context=context)


def registered_algorithms() -> dict[str, AlgorithmSpec]:
    return dict(_REGISTRY)


def layerwise_optimize(*args: Any, **kwargs: Any):
    """Re-export of the layer-wise loop (`algorithms.layerwise`)."""
    from fastforward_tpu_torch.algorithms.layerwise import layerwise_optimize as impl

    return impl(*args, **kwargs)


__all__ = [
    "AlgorithmSpec",
    "GraphModule",
    "SubgraphSpec",
    "TracedGraph",
    "layerwise_optimize",
    "op_name",
    "register",
    "registered_algorithms",
    "resolve",
    "run_scheduled",
    "trace",
    "trace_modules",
]
