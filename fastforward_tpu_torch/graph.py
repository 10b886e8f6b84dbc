"""Structural module graph: capture, multi-resolution addressing, scheduled
execution with host activation caching (`fastforward_tpu/graph.py`).

The graph is captured at **module granularity** (the resolution every
orchestration algorithm works at: GPTQ targets layers, not add nodes) by
running ONE forward with ``__call__`` intercepted on the model's module
classes and recording, per module call:

  - the call hierarchy (parent/children: the "folds"),
  - argument provenance (which earlier node or graph input produced each
    `torch.utils._pytree` leaf of the arguments, by tensor identity),
  - output provenance (whether a fold's output is exactly a child's output).

Glue compute between module calls (residual adds, masks) stays inside the
enclosing fold's module call: executing a fold *coarse* is always exact;
executing it *expanded* (children replayed one by one) is only done where
provenance proves the children reproduce the fold's output
(`Node.replayable`), else the fold falls back to its own module call.
Resolution controls addressing and activation-capture granularity; the
numbers are the model's at every resolution.

Node paths join the attribute names of `named_modules` with ``/``
(``blocks/0/attn``), as the JAX package's NNX paths are joined, so one path
string addresses the same node in both packages.
"""

import contextlib
import dataclasses
from typing import Any, Callable, Iterator, Optional, Sequence, Union

import torch
from torch.utils import _pytree as pytree

from fastforward_tpu_torch import flags

__all__ = [
    "Const",
    "GraphModule",
    "InputRef",
    "Node",
    "NodeRef",
    "ReplayError",
    "SubgraphSpec",
    "run_scheduled",
    "trace_modules",
]


class ReplayError(RuntimeError):
    """Raised when a graph cannot be re-executed with new inputs because a
    node argument was produced by untracked (glue) compute and
    ``captured_consts='error'``."""


@dataclasses.dataclass(frozen=True)
class InputRef:
    """Reference to leaf ``index`` of the flattened graph inputs."""

    index: int


@dataclasses.dataclass(frozen=True)
class NodeRef:
    """Reference to output leaf ``index`` of ``node``."""

    node: "Node"
    index: int

    def __hash__(self):  # dataclass eq would recurse into Node
        return hash((id(self.node), self.index))

    def __eq__(self, other):
        return (
            isinstance(other, NodeRef)
            and other.node is self.node
            and other.index == self.index
        )


@dataclasses.dataclass(frozen=True)
class Const:
    """A captured constant argument. ``derived`` marks tensors produced by
    glue compute between module calls during the trace: they *may* depend
    on the graph inputs, so replaying them is only safe for
    shape-compatible inputs (position ids, causal masks)."""

    value: Any
    derived: bool = False

    def __hash__(self):
        return hash(id(self.value))

    def __eq__(self, other):
        return isinstance(other, Const) and other.value is self.value


Ref = Union[InputRef, NodeRef, Const]


@dataclasses.dataclass
class Node:
    """One module call. A node with ``children`` is a *fold*: a coarse
    region that can be expanded."""

    path: str
    module: Any
    arg_refs: list  # refs for the flattened (args, kwargs) leaves
    in_treedef: Any
    out_treedef: Any = None
    num_outputs: int = 0
    out_refs: Optional[list] = None  # inner provenance of output leaves
    children: list = dataclasses.field(default_factory=list)
    parent: Optional["Node"] = None
    expanded: bool = False

    @property
    def is_fold(self) -> bool:
        return bool(self.children)

    @property
    def replayable(self) -> bool:
        """True if executing the children reproduces this fold's output:
        every output leaf resolves to a child output, fold input or const."""
        if not self.is_fold or self.out_refs is None:
            return False
        return all(ref is not None for ref in self.out_refs)

    def __repr__(self):
        kind = "fold" if self.is_fold else "leaf"
        return f"Node({self.path or '<root>'!r}, {type(self.module).__name__}, {kind})"


def _is_tracked_leaf(leaf: Any) -> bool:
    return isinstance(leaf, torch.Tensor)


class _Recorder:
    def __init__(self, paths: dict[int, str]):
        self.paths = paths  # id(module) -> path
        self.registry: dict[int, Ref] = {}  # id(tensor leaf) -> producing ref
        self.hold: list[Any] = []  # strong refs: prevent id() reuse
        self.stack: list[Node] = []
        self.root: Optional[Node] = None
        self.counts: dict[str, int] = {}

    def resolve(self, leaf: Any) -> Ref:
        if _is_tracked_leaf(leaf):
            ref = self.registry.get(id(leaf))
            if ref is not None:
                return ref
            self.hold.append(leaf)
            return Const(leaf, derived=True)
        return Const(leaf, derived=False)

    def register(self, leaf: Any, ref: Ref) -> None:
        if _is_tracked_leaf(leaf):
            self.hold.append(leaf)
            self.registry[id(leaf)] = ref

    def enter(self, module: Any, args, kwargs) -> Node:
        base = self.paths.get(id(module), f"<anon:{type(module).__name__}>")
        n = self.counts.get(base, 0)
        self.counts[base] = n + 1
        path = base if n == 0 else f"{base}@{n}"
        leaves, treedef = pytree.tree_flatten((args, dict(kwargs)))
        node = Node(path=path, module=module,
                    arg_refs=[self.resolve(leaf) for leaf in leaves], in_treedef=treedef)
        if self.stack:
            node.parent = self.stack[-1]
            self.stack[-1].children.append(node)
        self.stack.append(node)
        return node

    def exit(self, node: Node, output: Any) -> None:
        if not self.stack or self.stack[-1] is not node:
            raise RuntimeError(f"module call stack out of order at {node.path!r}")
        self.stack.pop()
        leaves, treedef = pytree.tree_flatten(output)
        node.out_treedef = treedef
        node.num_outputs = len(leaves)
        # Inner provenance FIRST (is this leaf exactly a child output or a
        # fold input?), then overwrite the registry so that outer scopes see
        # this node as the producer.
        node.out_refs = [self.registry.get(id(leaf)) if _is_tracked_leaf(leaf)
                         else Const(leaf, derived=False) for leaf in leaves]
        for i, leaf in enumerate(leaves):
            self.register(leaf, NodeRef(node, i))


@contextlib.contextmanager
def _intercept_calls(classes: Sequence[type], recorder: _Recorder, tracked: set):
    """Patch ``__call__`` on each class to record calls of tracked instances."""
    saved: list[tuple[type, Any, bool]] = []

    def make_wrapper(orig):
        def wrapper(self, *args, **kwargs):
            if id(self) not in tracked:
                return orig(self, *args, **kwargs)
            node = recorder.enter(self, args, kwargs)
            try:
                out = orig(self, *args, **kwargs)
            except BaseException:
                if recorder.stack and recorder.stack[-1] is node:
                    recorder.stack.pop()
                raise
            recorder.exit(node, out)
            if node.parent is None:
                recorder.root = node
            return out

        wrapper.__ff_graph_wrapper__ = True
        return wrapper

    try:
        for cls in classes:
            orig = cls.__call__
            if getattr(orig, "__ff_graph_wrapper__", False):
                continue
            owned = "__call__" in vars(cls)
            saved.append((cls, orig, owned))
            cls.__call__ = make_wrapper(orig)
        yield
    finally:
        for cls, orig, owned in saved:
            if owned:
                cls.__call__ = orig
            else:
                del cls.__call__


def module_paths(model: torch.nn.Module) -> Iterator[tuple[str, torch.nn.Module]]:
    """(path, module) for every module of ``model``, root first (path ""),
    the attribute names joined with ``/``."""
    for name, module in model.named_modules():
        yield name.replace(".", "/"), module


def trace_modules(model: torch.nn.Module, *args: Any, strict: bool = False,
                  **kwargs: Any) -> "GraphModule":
    """Run one forward of ``model`` and capture the module-call graph.

    Nodes hold the model's module instances, so optimizing a module in
    place affects every resolution at once."""
    paths = dict((id(m), p) for p, m in module_paths(model))
    tracked = set(paths)
    classes = {type(m) for m in model.modules()}

    recorder = _Recorder(paths)
    input_leaves, _ = pytree.tree_flatten((args, dict(kwargs)))
    for i, leaf in enumerate(input_leaves):
        recorder.register(leaf, InputRef(i))
    with _intercept_calls(sorted(classes, key=lambda c: c.__name__), recorder, tracked):
        with flags.strict_quantization(strict):
            model(*args, **kwargs)
    if recorder.root is None:
        raise RuntimeError("model(*args) did not route through model.__call__")
    graph = GraphModule(recorder.root, model)
    graph.root.expanded = True  # top level visible by default
    return graph


class GraphModule:
    """Multi-resolution module-call DAG.

    ``nodes()`` yields the currently *visible* nodes: children of expanded
    folds, recursively. The recorded order is a valid topological order
    (capture followed real execution). Calling the graph re-executes it on
    new inputs at the current resolution.
    """

    def __init__(self, root: Node, model: Any):
        self.root = root
        self.model = model

    # --- addressing ---------------------------------------------------------

    def nodes(self) -> Iterator[Node]:
        def walk(node: Node) -> Iterator[Node]:
            for child in node.children:
                if child.expanded and child.is_fold:
                    yield from walk(child)
                else:
                    yield child

        if self.root.expanded:
            yield from walk(self.root)
        else:
            yield self.root

    def all_nodes(self) -> Iterator[Node]:
        def walk(node: Node) -> Iterator[Node]:
            yield node
            for child in node.children:
                yield from walk(child)

        yield from walk(self.root)

    def find(self, path: str) -> Node:
        for node in self.all_nodes():
            if node.path == path:
                return node
        raise KeyError(path)

    def topological_sort(self) -> list[Node]:
        return list(self.nodes())

    def find_nodes_on_path(self, start: str, end: str) -> list[Node]:
        """Visible nodes from ``start`` to ``end`` inclusive; both must be
        visible at the current resolution."""
        nodes = self.topological_sort()
        paths = [n.path for n in nodes]
        i, j = paths.index(start), paths.index(end)
        if j < i:
            raise ValueError(f"{end!r} precedes {start!r}")
        return nodes[i : j + 1]

    # --- resolution ---------------------------------------------------------

    def expand(self, *paths: str) -> "GraphModule":
        """Unfold the folds at ``paths`` (and their ancestors)."""
        for path in paths:
            node = self.find(path)
            if not node.is_fold:
                raise ValueError(f"{path!r} is a leaf, not a fold")
            node.expanded = True
            p = node.parent
            while p is not None:
                p.expanded = True
                p = p.parent
        return self

    def collapse(self, *paths: str) -> "GraphModule":
        for path in paths:
            self.find(path).expanded = False
        return self

    def reduce_resolution(self, specs: Sequence[Union[str, "SubgraphSpec"]]) -> "GraphModule":
        """Expand exactly the folds *containing* each spec's targets, leaving
        everything else coarse. Specs are node paths or `SubgraphSpec`s; a
        target that is a leaf expands its ancestors so that it is visible."""
        for spec in specs:
            targets = [spec.start, spec.end] if isinstance(spec, SubgraphSpec) else [spec]
            for path in targets:
                p = self.find(path).parent
                while p is not None:
                    p.expanded = True
                    p = p.parent
        return self

    def summarize(self) -> str:
        lines = []

        def walk(node: Node, depth: int):
            kind = "fold" if node.is_fold else "leaf"
            state = ""
            if node.is_fold:
                state = " [expanded]" if node.expanded else " [folded]"
                if node.replayable:
                    state += " [replayable]"
            lines.append("  " * depth
                         + f"{node.path or '<root>'} ({type(node.module).__name__}, {kind}){state}")
            for child in node.children:
                walk(child, depth + 1)

        walk(self.root, 0)
        return "\n".join(lines)

    # --- execution ----------------------------------------------------------

    def __call__(self, *args: Any, captured_consts: str = "replay", **kwargs: Any):
        """Re-execute at the current resolution.

        An expanded fold replays its children only where provenance proves
        that is exact (`Node.replayable` and no child fed by untracked glue
        compute); otherwise it falls back to its own module call.

        ``captured_consts``: ``'replay'`` (default) substitutes captured
        glue-produced tensors only where unavoidable; ``'force'`` also
        replays folds whose children consume such values (exact for
        shape-compatible inputs: positions, masks); ``'error'`` raises
        `ReplayError` wherever a captured derived value would be used."""
        leaves, _ = pytree.tree_flatten((args, dict(kwargs)))
        if len(leaves) != len(self.root.arg_refs):
            raise ValueError(f"expected {len(self.root.arg_refs)} input leaves, got {len(leaves)}")
        env: dict = {("in", i): leaf for i, leaf in enumerate(leaves)}
        return _exec_node(self.root, env, captured_consts=captured_consts)


def _resolve_ref(ref: Ref, env: dict, captured_consts: str, node: Optional[Node] = None):
    if isinstance(ref, InputRef):
        return env[("in", ref.index)]
    if isinstance(ref, NodeRef):
        key = (id(ref.node), ref.index)
        try:
            # a plain lookup (not `in`), so that the scheduled run's cache
            # view (a dict with __missing__) can bring host-cached
            # activations back on demand
            return env[key]
        except KeyError:
            raise KeyError(f"output of {ref.node.path!r} not materialized") from None
    if ref.derived and captured_consts == "error":
        where = f" of {node.path!r}" if node is not None else ""
        raise ReplayError(
            f"an argument{where} was produced by untracked glue compute at trace time; "
            "pass captured_consts='replay' to substitute the captured value"
        )
    return ref.value


def _replay_safe(node: Node) -> bool:
    """True if replaying ``node``'s children needs no captured glue values."""
    for child in node.children:
        if any(isinstance(r, Const) and r.derived for r in child.arg_refs):
            return False
        if child.is_fold and child.expanded and child.replayable and not _replay_safe(child):
            return False
    return True


def _exec_node(node: Node, env: dict, captured_consts: str = "replay"):
    """Execute one node; store its output leaves in ``env``; return its output."""
    arg_leaves = [_resolve_ref(r, env, captured_consts, node) for r in node.arg_refs]
    args, kwargs = pytree.tree_unflatten(arg_leaves, node.in_treedef)

    if (
        node.is_fold
        and node.expanded
        and node.replayable
        # 'force' replays through captured glue values; 'error' attempts the
        # replay so that the unsafe substitution surfaces as ReplayError
        and (_replay_safe(node) or captured_consts in ("force", "error"))
    ):
        for child in node.children:
            _exec_node(child, env, captured_consts=captured_consts)
        out_leaves = [_resolve_ref(r, env, captured_consts, node) for r in node.out_refs]
        out = pytree.tree_unflatten(out_leaves, node.out_treedef)
    else:
        out = node.module(*args, **kwargs)
        out_leaves = pytree.tree_leaves(out)

    for i, leaf in enumerate(out_leaves):
        env[(id(node), i)] = leaf
    return out


@dataclasses.dataclass
class SubgraphSpec:
    """A target region and the optimizer to run on it."""

    start: str
    end: str
    optimizer: Optional[Callable[..., None]] = None

    @classmethod
    def single(cls, path: str, optimizer: Optional[Callable[..., None]] = None):
        return cls(path, path, optimizer)


def _model_device(model: torch.nn.Module) -> torch.device:
    for t in model.parameters():
        return t.device
    for t in model.buffers():
        return t.device
    return torch.device("cpu")


def run_scheduled(
    graph: GraphModule,
    batches: Sequence[Any],
    optimize: Optional[dict[str, Callable[..., None]]] = None,
    *,
    optimization_only: bool = False,
    captured_consts: str = "replay",
) -> dict:
    """Single-pass scheduled execution over calibration batches with host
    activation caching and lifetime management:

      - visible nodes run in topological order, ONCE over all batches each;
      - every node's per-batch outputs are cached in host memory and freed
        after their last consumer has run (the lifetime pass); a consumer
        gets them back on the model's device;
      - ``optimize[path]`` is called as ``fn(module, stacked_first_input)``
        *before* the node computes its outputs, so that downstream nodes see
        optimized upstream activations (sequential GPTQ);
      - ``optimization_only`` stops after the last optimized node and skips
        nodes whose outputs no optimized node needs, directly or not.

    Returns ``{"outputs": per-batch final outputs or None, "stats": {...}}``.
    """
    optimize = dict(optimize or {})
    nodes = graph.topological_sort()
    by_path = {n.path: n for n in nodes}
    for path in optimize:
        if path not in by_path:
            raise KeyError(
                f"optimize target {path!r} is not visible at the current "
                f"resolution; call graph.reduce_resolution([...]) first"
            )
    dev = _model_device(graph.model)

    def ref_nodes(refs):
        for r in refs or []:
            if isinstance(r, NodeRef):
                yield r.node

    idx_of = {id(n): i for i, n in enumerate(nodes)}

    def visible(producer):
        # the producer may be a descendant of a visible fold: charge the
        # nearest visible ancestor
        while producer is not None and id(producer) not in idx_of:
            producer = producer.parent
        return producer

    # for each producing node, the last visible node that reads its outputs
    last_consumer: dict[int, int] = {}
    for i, n in enumerate(nodes):
        for producer in ref_nodes(n.arg_refs):
            p = visible(producer)
            if p is not None:
                last_consumer[id(p)] = i

    needed: set[int] = set()
    if optimization_only and optimize:
        opt_idx = max(idx_of[id(by_path[p])] for p in optimize)
        frontier = [by_path[p] for p in optimize]  # backward reachability
        while frontier:
            n = frontier.pop()
            if id(n) in needed:
                continue
            needed.add(id(n))
            for producer in ref_nodes(n.arg_refs):
                p = visible(producer)
                if p is not None and id(p) not in needed:
                    frontier.append(p)
    else:
        opt_idx = len(nodes) - 1
        needed = {id(n) for n in nodes}

    num_batches = len(batches)
    cache: dict = {}  # (node_id, leaf_idx) -> per-batch host tensors
    stats = {"peak_live_entries": 0, "node_runs": {}, "skipped_nodes": 0}

    def to_dev(leaf):
        return leaf.to(dev) if _is_tracked_leaf(leaf) else leaf

    class _CacheView(dict):
        batch_idx = 0

        def __missing__(self, key):
            value = to_dev(cache[key][self.batch_idx])
            self[key] = value
            return value

    def env_for(batch_idx: int, batch: Any) -> dict:
        leaves = pytree.tree_leaves((batch if isinstance(batch, tuple) else (batch,), {}))
        view = _CacheView({("in", i): to_dev(leaf) for i, leaf in enumerate(leaves)})
        view.batch_idx = batch_idx
        return view

    outputs = [None] * num_batches
    for i, node in enumerate(nodes):
        if i > opt_idx:
            break
        if id(node) not in needed:
            stats["skipped_nodes"] += 1
            continue
        if node.path in optimize:
            # this node's first positional input, gathered across batches
            gathered = []
            for b in range(num_batches):
                first = _resolve_ref(node.arg_refs[0], env_for(b, batches[b]), captured_consts)
                gathered.append(first.reshape(-1, first.shape[-1]))
            optimize[node.path](node.module, torch.cat(gathered, dim=0))
        for b in range(num_batches):
            out = _exec_node(node, env_for(b, batches[b]), captured_consts=captured_consts)
            for k, leaf in enumerate(pytree.tree_leaves(out)):
                cache.setdefault((id(node), k), [None] * num_batches)[b] = (
                    leaf.detach().cpu() if _is_tracked_leaf(leaf) else leaf)
            if i == len(nodes) - 1:
                outputs[b] = out
        stats["node_runs"][node.path] = num_batches
        stats["peak_live_entries"] = max(stats["peak_live_entries"], len(cache))
        # lifetime: free producers whose last consumer was this node
        for nid in [nid for nid, last in last_consumer.items() if last == i]:
            for key in [k for k in cache if k[0] == nid]:
                del cache[key]

    return {"outputs": outputs, "stats": stats}
