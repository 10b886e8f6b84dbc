"""Autoquant on a torch.fx graph: quantize ops that call interception cannot
see (`fastforward_tpu/autoquant_jaxpr.py`, the jaxpr pass; this module walks
an aten-level `torch.fx` graph where that one walks a jaxpr).

`fastforward_tpu_torch.autoquant` intercepts known torch functions; it does
not see operator syntax on plain tensors (``x @ w``). Traced with
`make_fx` (``pre_dispatch=True``, so ``F.linear`` stays one ``aten.linear``
and ``@`` one ``aten.matmul``), every call, whatever its syntax or binding,
is an fx node, and a small evaluator sees all of them, including the
bodies of torch's higher-order ops ``scan``, ``cond`` and ``while_loop``
(`torch.ops.higher_order`, kept as subgraphs), the counterparts of JAX's
``lax.scan``, ``lax.cond`` and ``lax.while_loop``.

The products are the sites by default: ``aten.linear``, ``matmul``, ``mm``,
``addmm``, ``bmm`` and ``einsum`` (``dot_general``'s counterparts: JAX
lowers each of them to one) and the convolutions
(``conv_general_dilated``'s); ``ops=`` names others (elementwise aten ops:
``("add",)``). A site's name is its aten op and its index in pre-order
(``linear_0``, ``matmul_1``). Its input slots are the tensors among the
node's positional arguments in order, lists flattened (``aten.einsum``'s
operands; ``aten.linear``: 0 the input, 1 the weight in
torch's (out, in) layout, 2 the bias), its output slots ``("out", j)``.

A site in a scan or while body runs once per iteration, and its calibration
folds every iteration's range. Observing runs the bodies as host loops on
concrete tensors; the quantized function does too when called eagerly, and
re-stages the higher-order op (a scan stays a scan) when `make_fx` traces
it: the counterpart of "jittable". Interpretation runs under
``torch.no_grad()`` and skips the trace's grad-mode switches.

Usage::

    plan = trace_quantization_sites(fn, x, w)      # structural trace
    plan.observe(x_calib, w)                        # calibration (repeat ok)
    qfn = plan.quantized(num_bits=8)                # QDQ'd fn
"""

from __future__ import annotations

import contextlib
import dataclasses
import fnmatch
from typing import Any, Callable, Dict, Iterator, List, Sequence, Tuple

import torch
import torch.fx.traceback as fx_traceback
from torch.fx.experimental.proxy_tensor import get_proxy_mode, make_fx
from torch.utils import _pytree as pytree

from fastforward_tpu_torch.exceptions import QuantizationError
from fastforward_tpu_torch.orchestration import op_name

__all__ = ["DEFAULT_QUANTIZED_OPS", "QuantSite", "FxQuantizationPlan",
           "trace_quantization_sites", "named_torch_modules", "scoped_forward"]

DEFAULT_QUANTIZED_OPS: Tuple[str, ...] = (
    "linear", "matmul", "mm", "addmm", "bmm", "einsum",
    "convolution", "conv1d", "conv2d", "conv3d",
)

_SCAN = torch.ops.higher_order.scan
_COND = torch.ops.higher_order.cond
_WHILE = torch.ops.higher_order.while_loop
_CONTEXT = {_SCAN: "scan", _COND: "cond", _WHILE: "while"}
_GRAD_SWITCHES = (torch._C._set_grad_enabled,)


def _is_quantizable(val: Any) -> bool:
    return isinstance(val, torch.Tensor) and val.is_floating_point() and val.dim() >= 1


@dataclasses.dataclass
class QuantSite:
    """One quantizable op in traversal order."""

    name: str                 # e.g. "linear_0"
    prim: str                 # the aten op
    in_shapes: Tuple[Tuple[int, ...], ...]
    # nesting context, e.g. ("scan",) for a site inside one scan body
    context: Tuple[str, ...] = ()
    # slot -> running absmax (inputs 0..n-1, outputs ("out", j))
    absmax: Dict[Any, float] = dataclasses.field(default_factory=dict)
    in_dtypes: Tuple[Any, ...] = ()
    out_shapes: Tuple[Tuple[int, ...], ...] = ()
    out_dtypes: Tuple[Any, ...] = ()
    # slot -> nn.LinearQuantizer (installed by `install_quantizers`)
    quantizers: Dict[Any, Any] = dataclasses.field(default_factory=dict)
    # the module path that ran the op, where the trace ran under
    # `scoped_forward` ("" otherwise): the site <-> module-path bridge
    module_path: str = ""

    def float_slots(self):
        for i, (shp, dt) in enumerate(zip(self.in_shapes, self.in_dtypes)):
            if dt is not None and len(shp) >= 1 and dt.is_floating_point:
                yield i
        for j, (shp, dt) in enumerate(zip(self.out_shapes, self.out_dtypes)):
            if dt is not None and len(shp) >= 1 and dt.is_floating_point:
                yield ("out", j)


def _tensor_leaves(args):
    """(leaves, spec, positions of the tensor leaves) of a node's positional
    arguments, lists included (``aten.einsum``'s operands)."""
    leaves, spec = pytree.tree_flatten(list(args))
    return leaves, spec, [i for i, a in enumerate(leaves) if isinstance(a, torch.Tensor)]


def _val(node: Any):
    return node.meta.get("val") if isinstance(node, torch.fx.Node) else node


def _module_path(node: torch.fx.Node) -> str:
    stack = node.meta.get("nn_module_stack") or {}
    return next(reversed(stack)) if stack else ""


class FxQuantizationPlan:
    """Sites and calibration statistics of one traced function."""

    def __init__(self, gm: torch.fx.GraphModule, out_spec, ops: Tuple[str, ...]):
        self._gm = gm
        self._out_spec = out_spec
        self._ops = ops
        self.sites: List[QuantSite] = []
        self._counts: Dict[int, int] = {}  # id(graph module) -> sites inside, recursively
        self._steps: Dict[Tuple[str, Any], Any] = {}
        self._discover()

    # -- traversal ---------------------------------------------------------
    @staticmethod
    def _subgraphs(gm: torch.fx.GraphModule, node: torch.fx.Node) -> List[torch.fx.GraphModule]:
        """The subgraphs of a higher-order op node in site order: argument
        order, but a cond's false branch first (JAX's cond is a switch on the
        predicate's index, branch 0 the false one, and its sites come in
        that order)."""
        subs = []
        for a in node.args:
            if isinstance(a, torch.fx.Node) and a.op == "get_attr":
                sub = getattr(gm, a.target)
                if isinstance(sub, torch.fx.GraphModule):
                    subs.append(sub)
        return subs[::-1] if node.target is _COND else subs

    def _discover(self) -> None:
        counters: Dict[str, int] = {}

        def walk(gm: torch.fx.GraphModule, context: Tuple[str, ...]) -> int:
            n_sites = 0
            for node in gm.graph.nodes:
                if node.op != "call_function":
                    continue
                if node.target in _CONTEXT:
                    for sub in self._subgraphs(gm, node):
                        n_sites += walk(sub, context + (_CONTEXT[node.target],))
                    continue
                name = op_name(node.target)
                if name not in self._ops:
                    continue
                n = counters.get(name, 0)
                counters[name] = n + 1
                leaves, _, pos = _tensor_leaves(torch.fx.node.map_arg(node.args, _val))
                ins = [leaves[i] for i in pos]
                out = _val(node)
                outs = list(out) if isinstance(out, (list, tuple)) else [out]
                self.sites.append(QuantSite(
                    name=f"{name}_{n}", prim=name,
                    in_shapes=tuple(tuple(v.shape) for v in ins),
                    in_dtypes=tuple(v.dtype for v in ins),
                    out_shapes=tuple(tuple(v.shape) for v in outs),
                    out_dtypes=tuple(v.dtype for v in outs),
                    context=context, module_path=_module_path(node),
                ))
                n_sites += 1
            self._counts[id(gm)] = n_sites
            return n_sites

        walk(self._gm, ())

    def _interpret(self, args, handler):
        """Evaluate the graph, calling ``handler(site, tensors) -> tensors``
        and ``handler.out(site, outputs) -> outputs`` at every site. Sites are
        addressed by pre-order index, so a body re-entered every iteration
        hits the same sites and an unselected cond branch is skipped."""
        handler_out = getattr(handler, "out", lambda site, outs: outs)

        def run(gm: torch.fx.GraphModule, in_vals: Sequence[Any], base: int) -> List[Any]:
            env: Dict[torch.fx.Node, Any] = {}
            vals = iter(in_vals)
            cursor = base

            def load(a):
                return torch.fx.node.map_arg(a, lambda n: env[n])

            for node in gm.graph.nodes:
                if node.op == "placeholder":
                    env[node] = next(vals)
                elif node.op == "get_attr":
                    obj = gm
                    for part in node.target.split("."):
                        obj = getattr(obj, part)
                    env[node] = obj
                elif node.op == "output":
                    out = load(node.args[0])
                    return list(out) if isinstance(out, (list, tuple)) else [out]
                elif node.target in _GRAD_SWITCHES:
                    continue
                elif node.target in _CONTEXT:
                    outs = self._run_control(gm, node, load(node.args), cursor, run)
                    cursor += sum(self._counts[id(s)] for s in self._subgraphs(gm, node))
                    env[node] = outs
                else:
                    a, kw = load(node.args), load(node.kwargs)
                    if op_name(node.target) in self._ops:
                        site = self.sites[cursor]
                        cursor += 1
                        leaves, spec, pos = _tensor_leaves(a)
                        for i, v in zip(pos, handler(site, [leaves[i] for i in pos])):
                            leaves[i] = v
                        out = node.target(*pytree.tree_unflatten(leaves, spec), **kw)
                        many = isinstance(out, (list, tuple))
                        outs = handler_out(site, list(out) if many else [out])
                        out = type(out)(outs) if many else outs[0]
                    else:
                        out = node.target(*a, **kw)
                    env[node] = out
            raise RuntimeError("graph without an output node")

        flat, _ = pytree.tree_flatten(args)
        with torch.no_grad():
            out_flat = run(self._gm, flat, 0)
        return pytree.tree_unflatten(out_flat, self._out_spec)

    # -- the higher-order ops ----------------------------------------------
    def _run_control(self, gm, node, args, base, run):
        subs = self._subgraphs(gm, node)
        staged = get_proxy_mode() is not None  # under make_fx: re-stage the op
        if node.target is _SCAN:
            (body,), init, xs, extra = subs, list(args[1]), list(args[2]), list(args[3])
            if staged:
                return _SCAN(lambda *a: tuple(run(body, a, base)), init, xs, extra)
            carry, ys = init, []
            for t in range(xs[0].shape[0] if xs else 0):
                outs = run(body, [*carry, *(x[t] for x in xs), *extra], base)
                carry, y = outs[:len(init)], outs[len(init):]
                ys.append(y)
            stacked = [torch.stack([y[i] for y in ys]) for i in range(len(ys[0]))] if ys else []
            return [*carry, *stacked]
        if node.target is _COND:
            false_gm, true_gm = subs
            pred, operands = args[0], list(args[3])
            false_base, true_base = base, base + self._counts[id(false_gm)]
            if staged:
                return _COND(pred, lambda *o: tuple(run(true_gm, o, true_base)),
                             lambda *o: tuple(run(false_gm, o, false_base)), tuple(operands))
            if bool(pred):
                return run(true_gm, operands, true_base)
            return run(false_gm, operands, false_base)
        cond_gm, body_gm = subs
        carried, extra = list(args[2]), list(args[3])
        body_base = base + self._counts[id(cond_gm)]
        if staged:
            return _WHILE(lambda *c: run(cond_gm, c, base)[0],
                          lambda *c: tuple(run(body_gm, c, body_base)),
                          tuple(carried), tuple(extra))
        while bool(run(cond_gm, [*carried, *extra], base)[0]):
            carried = run(body_gm, [*carried, *extra], body_base)
        return carried

    # -- quantizer-stack integration ---------------------------------------
    def install_quantizers(
        self,
        rules: Sequence[Tuple[str, Any, Dict[str, Any]]] = (),
        *,
        default: Any = None,
        estimator: Any = None,
    ) -> "FxQuantizationPlan":
        """Attach `nn.LinearQuantizer`s to site slots.

        ``rules``: ``(site_pattern, slot, kwargs)`` triples, last wins (the
        `QuantizationConfig` precedence). ``site_pattern`` is an fnmatch
        pattern on site names (``"linear_*"``); ``slot`` an input index,
        ``("out", j)``, or ``"inputs"`` / ``"outputs"`` / ``"all"``;
        ``kwargs`` go to `LinearQuantizer`. ``default``: kwargs for every
        float slot, before the rules. ``estimator``: a `range_setting`
        estimator (default running min-max); `observe` runs its step on
        every slot, folding ranges across batches and iterations.
        """
        per_site: Dict[Tuple[str, Any], Dict[str, Any]] = {}
        for site in self.sites:
            slots = list(site.float_slots())
            if default is not None:
                for s in slots:
                    per_site[(site.name, s)] = dict(default)
            for pattern, slot, kwargs in rules:
                if not fnmatch.fnmatch(site.name, pattern):
                    continue
                if slot == "inputs":
                    targets = [s for s in slots if isinstance(s, int)]
                elif slot == "outputs":
                    targets = [s for s in slots if not isinstance(s, int)]
                elif slot == "all":
                    targets = slots
                else:
                    targets = [slot] if slot in slots else []
                for s in targets:
                    per_site[(site.name, s)] = dict(kwargs)
        self._install(per_site, estimator)
        return self

    def _install(self, per_site, estimator) -> None:
        from fastforward_tpu_torch.nn.linear_quantizer import LinearQuantizer
        from fastforward_tpu_torch.range_setting.common import step_factory

        by_name = {s.name: s for s in self.sites}
        step_cls = step_factory(estimator)
        for (sname, slot), kwargs in per_site.items():
            q = LinearQuantizer(**kwargs)
            by_name[sname].quantizers[slot] = q
            self._steps[(sname, slot)] = step_cls(q)

    # -- the site <-> module-path bridge -----------------------------------
    #
    # Trace under `scoped_forward(model)` and every site records the module
    # path that ran it. `install_from_config` drives quantizer installation
    # on the plan from a module-path `QuantizationConfig`; `apply_to_module`
    # pushes a calibrated plan's quantizers onto the module's slots. Slots of
    # a Linear's aten.linear: input 0 = activation/input, 1 = parameter/
    # weight, 2 = parameter/bias, ("out", 0) = activation/output (after the
    # bias, as the module's output quantizer).

    _SLOT_BY_ATTR = {
        "input_quantizer": 0,
        "weight_quantizer": 1,
        "bias_quantizer": 2,
        "output_quantizer": ("out", 0),
    }

    def site_module_paths(self) -> Dict[str, str]:
        """{site name: owning module path} (sites with no scope map to "")."""
        return {s.name: s.module_path for s in self.sites}

    def install_from_config(self, config: Any, model: Any, *, estimator: Any = None,
                            context: Any = None) -> "FxQuantizationPlan":
        """Drive `install_quantizers` from a module-path `QuantizationConfig`.

        ``config``'s rules are resolved against ``model`` (a quantized module
        tree) as `QuantizationConfig.initialize` would; every matched
        quantizer slot maps through the scope bridge onto this plan's sites,
        later rules winning. The plan must have been traced under
        `scoped_forward` on a model with the same module paths.
        """
        from fastforward_tpu_torch.nn.linear_quantizer import LinearQuantizer
        from fastforward_tpu_torch.quant_init import find_quantizers

        sites_by_path: Dict[str, List[QuantSite]] = {}
        for s in self.sites:
            sites_by_path.setdefault(s.module_path, []).append(s)

        per_site: Dict[Tuple[str, Any], Dict[str, Any]] = {}
        for query, factory, kwargs in config._rules:
            if not (isinstance(factory, type) and issubclass(factory, LinearQuantizer)):
                raise QuantizationError("install_from_config supports LinearQuantizer rules only")
            for item in find_quantizers(model, query, context=context):
                parts = item.full_name.strip("/").split("/")
                slot = self._SLOT_BY_ATTR.get(parts[-1])
                if slot is None:
                    continue
                for site in sites_by_path.get("/".join(parts[:-1]), ()):
                    if slot in list(site.float_slots()):
                        per_site[(site.name, slot)] = dict(kwargs)
        self._install(per_site, estimator)
        return self

    def apply_to_module(self, model: Any) -> int:
        """Push this plan's (calibrated) quantizers onto ``model``'s module
        quantizer slots through the scope bridge; returns the slots set.
        The module slot gets the plan's `LinearQuantizer` itself (shared
        calibration state): the inverse of `install_from_config`."""
        by_path = dict(named_torch_modules(model))
        attr_by_slot = {v: k for k, v in self._SLOT_BY_ATTR.items()}
        applied = 0
        for site in self.sites:
            mod = by_path.get(site.module_path)
            if mod is None:
                continue
            for slot, q in site.quantizers.items():
                attr = attr_by_slot.get(slot)
                if attr is None or not hasattr(mod, attr):
                    continue
                setattr(mod, attr, q)
                applied += 1
        return applied

    def encodings(self):
        """The calibrated plan as `export.encodings.QuantizerEncoding`
        records (every schema handler takes them: legacy, v1, v2, LPBQ)."""
        from fastforward_tpu_torch.export.encodings import QuantizerEncoding

        out = []
        for site in self.sites:
            for slot, q in sorted(site.quantizers.items(), key=lambda kv: str(kv[0])):
                if q.scale is None:
                    continue
                tag = f"in{slot}" if isinstance(slot, int) else f"out{slot[1]}"
                shape = site.in_shapes[slot] if isinstance(slot, int) else site.out_shapes[slot[1]]
                out.append(QuantizerEncoding(
                    name=f"{site.name}.{tag}",
                    num_bits=q.num_bits,
                    scale=q.scale.detach().cpu().numpy(),
                    offset=None if q.offset is None else q.offset.detach().cpu().numpy(),
                    granularity=q.granularity,
                    symmetric=q.symmetric,
                    data_shape=tuple(shape),
                    producing_operator=site.prim,
                ))
        return out

    def export_encodings(self, path: str, schema: str = "v1") -> str:
        """Write the calibrated plan's encodings JSON (the sidecar format of
        model export, `export/torch_export.py`)."""
        import json

        from fastforward_tpu_torch.export.encodings import SCHEMA_HANDLERS

        with open(path, "w") as f:
            json.dump(SCHEMA_HANDLERS[schema]().encode(self.encodings()), f, indent=2)
        return path

    # -- calibration -------------------------------------------------------
    def observe(self, *args: Any) -> Any:
        """Run once on concrete inputs, folding each slot's absmax (and the
        installed estimators' ranges) into the plan: a running max across
        calls and across iterations (a site in a scan body observes every
        iteration). Returns the function's output."""
        steps = self._steps

        def fold(site, key, v):
            site.absmax[key] = max(site.absmax.get(key, 0.0), float(v.detach().abs().max()))
            step = steps.get((site.name, key))
            if step is not None:
                step.estimate_step(v)

        class _Observer:
            @staticmethod
            def __call__(site, invals):
                for i, v in enumerate(invals):
                    if _is_quantizable(v):
                        fold(site, i, v)
                return invals

            @staticmethod
            def out(site, outs):
                for j, v in enumerate(outs):
                    if _is_quantizable(v):
                        fold(site, ("out", j), v)
                return outs

        return self._interpret(args, _Observer())

    # -- application -------------------------------------------------------
    def quantized(self, num_bits: int = 8, quantize_outputs: bool = True,
                  only_installed: bool = False) -> Callable:
        """The function with QDQ on every calibrated slot (uncalibrated slots
        pass through). Traced by `make_fx`, its higher-order ops stay
        higher-order ops with the QDQ inside their bodies.

        A slot with an installed `LinearQuantizer` applies that quantizer's
        QDQ (export mode: its granularity, range and calibrated parameters);
        `num_bits` applies to the absmax-calibrated slots (symmetric).
        ``only_installed=True`` QDQs only the slots that carry installed
        quantizers (the config bridge: slots no rule matched stay float, as
        on the module path)."""
        if not any(s.absmax for s in self.sites):
            raise QuantizationError(
                "FxQuantizationPlan has no calibration data: call "
                "plan.observe(*calibration_inputs) before plan.quantized()."
            )
        from fastforward_tpu_torch import flags

        qmax = float(2 ** (num_bits - 1) - 1)

        def qdq(v, absmax, quantizer=None):
            if quantizer is not None and quantizer.scale is not None:
                with flags.export_mode(True):
                    return quantizer(v).to(v.dtype)
            if absmax <= 0.0:
                return v
            scale = absmax / qmax
            return (torch.clamp(torch.round(v / scale), -qmax - 1, qmax) * scale).to(v.dtype)

        def wanted(site, key):
            return key in site.quantizers or (not only_installed and key in site.absmax)

        class _Applier:
            @staticmethod
            def __call__(site, invals):
                return [qdq(v, site.absmax.get(i, 0.0), site.quantizers.get(i))
                        if _is_quantizable(v) and wanted(site, i) else v
                        for i, v in enumerate(invals)]

            @staticmethod
            def out(site, outs):
                if not quantize_outputs:
                    return outs
                return [qdq(v, site.absmax.get(("out", j), 0.0), site.quantizers.get(("out", j)))
                        if _is_quantizable(v) and wanted(site, ("out", j)) else v
                        for j, v in enumerate(outs)]

        def quantized_fn(*args: Any) -> Any:
            return self._interpret(args, _Applier())

        return quantized_fn

    def summary(self) -> str:
        lines = [f"{len(self.sites)} quantization sites:"]
        for s in self.sites:
            cal = ", ".join(f"{k}:{v:.4g}" for k, v in sorted(
                s.absmax.items(), key=lambda kv: str(kv[0]))) or "uncalibrated"
            ctx = ("/".join(s.context) + " ") if s.context else ""
            lines.append(f"  {s.name} {ctx}{s.in_shapes} [{cal}]")
        return "\n".join(lines)


def trace_quantization_sites(fn: Callable, *example_args: Any,
                             ops: Sequence[str] = DEFAULT_QUANTIZED_OPS) -> FxQuantizationPlan:
    """Trace ``fn`` with `make_fx` and enumerate its quantizable sites.

    Operator syntax (``x @ w``) and functions bound before any context are
    nodes like any other once traced, inside the bodies of ``scan``,
    ``cond`` and ``while_loop`` too; helper functions are traced through.
    The trace runs ``fn`` once (real tensors, no gradients)."""
    holder = {}

    def flat_fn(*flat):
        out = fn(*pytree.tree_unflatten(list(flat), in_spec))
        out_flat, holder["spec"] = pytree.tree_flatten(out)
        return out_flat

    flat, in_spec = pytree.tree_flatten(list(example_args))
    with torch.no_grad(), fx_traceback.preserve_node_meta():
        gm = make_fx(flat_fn, pre_dispatch=True)(*flat)
    return FxQuantizationPlan(gm, holder["spec"], tuple(ops))


# --- scoped tracing: module paths in the traced nodes' metadata --------------


def named_torch_modules(model: torch.nn.Module) -> Iterator[Tuple[str, torch.nn.Module]]:
    """(path, module) for every module of ``model`` but its quantizers, root
    first (path ""), attribute names joined with ``/`` as the JAX package's
    `named_nnx_modules` joins NNX paths."""
    from fastforward_tpu_torch.graph import module_paths
    from fastforward_tpu_torch.nn.quantizer import Quantizer

    for path, module in module_paths(model):
        if not isinstance(module, Quantizer):
            yield path, module


@contextlib.contextmanager
def scoped_forward(model: torch.nn.Module):
    """Run or trace ``model`` with every submodule call recorded in the
    traced nodes' ``nn_module_stack`` metadata (the module path, ``/``
    joined): sites traced in this context know their module
    (`QuantSite.module_path`), for `install_from_config` and
    `apply_to_module`.

    Each module class of the tree gets a temporary ``__call__`` wrapper that
    looks up the instance's path; instances outside ``model`` pass through."""
    paths = {id(m): p for p, m in named_torch_modules(model)}
    patched: Dict[type, Tuple[Any, bool]] = {}

    def make(orig):
        def wrapped(self, *args, **kwargs):
            path = paths.get(id(self))
            if path is None:
                return orig(self, *args, **kwargs)
            meta = fx_traceback.current_meta
            saved = meta.get("nn_module_stack")
            stack = dict(saved or {})
            stack[path] = (path, type(self))
            meta["nn_module_stack"] = stack
            try:
                return orig(self, *args, **kwargs)
            finally:
                if saved is None:
                    fx_traceback.current_meta.pop("nn_module_stack", None)
                else:
                    fx_traceback.current_meta["nn_module_stack"] = saved

        return wrapped

    for _, m in named_torch_modules(model):
        cls = type(m)
        if cls in patched:
            continue
        patched[cls] = (cls.__call__, "__call__" in vars(cls))
        cls.__call__ = make(cls.__call__)
    try:
        yield model
    finally:
        for cls, (orig, owned) in patched.items():
            if owned:
                cls.__call__ = orig
            else:
                del cls.__call__
