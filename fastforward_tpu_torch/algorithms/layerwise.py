"""Layer-wise optimization (`fastforward_tpu/algorithms/layerwise.py`).

A capture-then-optimize loop over the model's forwards:

  1. find the target modules (an mpath query),
  2. capture each target's calibration inputs with an override on its
     input quantizer,
  3. optimize the targets in model order; in sequential mode the inputs of
     target i+1 are captured again after target i was optimized (GPTQ's
     error propagation: each layer sees the optimized upstream layers).

Model order is the order of ``model.modules()`` (registration order, the
forward's for a decoder), not mpath's: mpath sorts full names by their
string segments, so ``layers/10`` comes before ``layers/2`` and
``mlp/down_proj`` before ``mlp/gate_proj``. The JAX package walks mpath's
order, which feeds a stage the output of the stage before it in that
order from 11 stages on; the port does not copy that.

Captured activations are kept in host memory and moved to the module's
device when its algorithm runs, as the JAX package keeps them on the host.
`layerwise_optimize_staged` walks stages (decoder blocks) once: a prelude
pass catches the first stage's inputs and stops the forward there (a
forward pre-hook that raises), then each stage runs twice over its cached
inputs, once to capture its targets' inputs and once, optimized, to make
the next stage's.
"""

import contextlib
from typing import Any, Callable, Iterable, Optional, Sequence, Union

import torch

from fastforward_tpu_torch import mpath
from fastforward_tpu_torch.forward_override import OverrideHandle


def _map_tensors(fn, value):
    """``value`` with ``fn`` applied to every tensor in its tuples, lists
    and dicts."""
    if isinstance(value, torch.Tensor):
        return fn(value)
    if isinstance(value, (tuple, list)):
        return type(value)(_map_tensors(fn, v) for v in value)
    if isinstance(value, dict):
        return {k: _map_tensors(fn, v) for k, v in value.items()}
    return value


def _to_host(value):
    return _map_tensors(lambda t: t.detach().cpu(), value)


def _module_device(module: torch.nn.Module) -> torch.device:
    for p in module.parameters():
        return p.device
    return torch.device("cpu")


class _InputRecorder:
    """Override on a module's input quantizer that captures the module's
    input batches to host memory."""

    def __init__(self):
        self.batches: list[torch.Tensor] = []

    def __call__(self, context, overridden_fn, args, kwargs):
        self.batches.append(_to_host(args[0]))
        return overridden_fn(*args, **kwargs)

    def concat(self, device=None) -> torch.Tensor:
        """The captured batches as (rows, features) on ``device``."""
        data = torch.cat([b.reshape(-1, b.shape[-1]) for b in self.batches], dim=0)
        return data if device is None else data.to(device)


def _in_model_order(items: list, root: torch.nn.Module) -> list:
    """mpath items sorted by their module's position in ``root.modules()``."""
    position = {id(m): i for i, m in enumerate(root.modules())}
    return sorted(items, key=lambda item: position[id(item.module)])


def _attach_recorder(module) -> tuple[_InputRecorder, OverrideHandle]:
    """Record the module's input via its input_quantizer override slot."""
    recorder = _InputRecorder()
    quantizer = getattr(module, "input_quantizer", None)
    if quantizer is None:
        raise ValueError(
            f"Module {type(module).__name__} has no input_quantizer slot to "
            "hook; convert the model with quantize_model first."
        )
    handle = quantizer.register_override(recorder)
    return recorder, handle


def layerwise_optimize(
    model: Any,
    calibration_batches: Iterable[Any],
    algorithm: Callable[..., None],
    *,
    targets: str = "**/[cls:QuantizedLinear]",
    context: Optional[dict] = None,
    sequential: bool = True,
    forward: Optional[Callable[[Any, Any], Any]] = None,
    **algorithm_kwargs: Any,
) -> list[str]:
    """Run ``algorithm(module, inputs, **kwargs)`` on every target module.

    - ``calibration_batches``: iterable of model inputs (re-iterated per
      capture pass — pass a list).
    - ``sequential=True``: re-capture activations after each layer is
      optimized (error propagation); ``False``: one capture pass for all.
    - ``forward``: optional ``(model, batch) -> out`` override.

    Returns the optimized module paths, in model order.
    """
    from fastforward_tpu_torch import flags

    batches = list(calibration_batches)
    run = forward or (lambda m, b: m(b))

    items = _in_model_order(list(mpath.search(targets, model, context=context)), model)
    if not items:
        return []

    def capture(modules) -> list[torch.Tensor]:
        recorders = []
        handles = []
        for m in modules:
            r, h = _attach_recorder(m)
            recorders.append(r)
            handles.append(h)
        try:
            with flags.strict_quantization(False), torch.no_grad():
                for batch in batches:
                    run(model, batch)
        finally:
            for h in handles:
                h.remove()
        return [r.concat(_module_device(m)) for r, m in zip(recorders, modules)]

    optimized = []
    if not sequential:
        inputs = capture([item.module for item in items])
        for item, x in zip(items, inputs):
            algorithm(item.module, x, **algorithm_kwargs)
            optimized.append(item.full_name)
    else:
        for item in items:
            (x,) = capture([item.module])
            algorithm(item.module, x, **algorithm_kwargs)
            optimized.append(item.full_name)
    return optimized


class _EarlyExit(Exception):
    """Raised by the stage-input catcher to abort the forward after the
    prelude (embedding etc.) has produced the first stage's input."""


@contextlib.contextmanager
def _catch_stage_inputs(module: torch.nn.Module, sink: list, abort: bool):
    """While the context is open, every call of ``module`` appends host
    copies of its (args, kwargs) to ``sink`` (a forward pre-hook); with
    ``abort`` the hook raises `_EarlyExit` and the module's body never runs,
    so capturing the first stage's inputs costs only the prelude."""

    def hook(mod, args, kwargs):
        sink.append((_to_host(args), _to_host(kwargs)))
        if abort:
            raise _EarlyExit
        return None

    handle = module.register_forward_pre_hook(hook, with_kwargs=True)
    try:
        yield
    finally:
        handle.remove()


def layerwise_optimize_staged(
    model: Any,
    calibration_batches: Iterable[Any],
    algorithm: Callable[..., None],
    *,
    stages: Union[str, Sequence[Any]],
    targets: str = "**/[cls:QuantizedLinear]",
    context: Optional[dict] = None,
    forward: Optional[Callable[[Any, Any], Any]] = None,
    stage_output: Callable[[Any], Any] = lambda out: out[0] if isinstance(out, tuple) else out,
    **algorithm_kwargs: Any,
) -> list[str]:
    """Single-pass layer-sequential optimization with host activation caching.

      1. One *prelude-only* pass over the calibration batches captures stage
         0's inputs (a catcher aborts the forward at the stage boundary, so
         the embedding/prelude is the only compute).
      2. Per stage: run the stage once over the cached inputs with recorders
         on each target's ``input_quantizer`` (captures target inputs), run
         ``algorithm`` on every target, then re-run the stage with the now
         *optimized* weights to produce the next stage's cached inputs.

    Total stage compute = 2 stage-forwards per stage per batch.

    ``stages``: ordered stage modules, or an mpath query resolving to them
    (taken in model order) —
    each stage must take the previous stage's (hidden-state) output as its
    first positional argument; remaining args/kwargs are captured per batch
    in the prelude pass and replayed. ``stage_output`` extracts the hidden
    state from a stage's return value (default: first element of a tuple).
    ``targets`` is searched *within* each stage.

    Returns the optimized module paths ("<stage>/<target>").
    """
    from fastforward_tpu_torch import flags

    batches = list(calibration_batches)
    run = forward or (lambda m, b: m(b))

    if isinstance(stages, str):
        stage_items = _in_model_order(list(mpath.search(stages, model, context=context)), model)
        stage_list = [(item.full_name, item.module) for item in stage_items]
    else:
        stage_list = [(f"stage{i}", m) for i, m in enumerate(stages)]
    if not stage_list:
        return []

    # 1. Prelude pass: catch stage-0 inputs, abort before the stage body.
    cached: list = []
    first_stage = stage_list[0][1]
    with _catch_stage_inputs(first_stage, cached, abort=True):
        with flags.strict_quantization(False), torch.no_grad():
            for batch in batches:
                try:
                    run(model, batch)
                except _EarlyExit:
                    pass
    if len(cached) != len(batches):
        raise RuntimeError(
            f"stage-input capture saw {len(cached)} calls for {len(batches)} "
            "batches — is the first stage called exactly once per forward?"
        )

    optimized: list[str] = []
    for stage_name, stage in stage_list:
        device = _module_device(stage)

        def on_device(value):
            return _map_tensors(lambda t: t.to(device), value)

        t_items = _in_model_order(list(mpath.search(targets, stage, context=context)), stage)
        recorders, handles = [], []
        for item in t_items:
            r, h = _attach_recorder(item.module)
            recorders.append(r)
            handles.append(h)
        try:
            with flags.strict_quantization(False), torch.no_grad():
                for args, kwargs in cached:
                    stage(*on_device(args), **on_device(kwargs))
        finally:
            for h in handles:
                h.remove()
        for item, r in zip(t_items, recorders):
            algorithm(item.module, r.concat(device), **algorithm_kwargs)
            optimized.append(f"{stage_name}/{item.full_name}")
        # 2. Recompute this stage's outputs with optimized weights → the
        #    next stage's cached inputs; the previous cache entry is dropped
        #    at once.
        new_cached = []
        with flags.strict_quantization(False), torch.no_grad():
            for args, kwargs in cached:
                out = stage_output(stage(*on_device(args), **on_device(kwargs)))
                new_cached.append(((_to_host(out),) + tuple(args[1:]), kwargs))
        cached = new_cached
    return optimized
