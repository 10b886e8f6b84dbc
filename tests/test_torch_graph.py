"""The module graph (`fastforward_tpu_torch/graph.py`) against the JAX
package's (`fastforward_tpu/graph.py`), on the CPU: the counterparts of
`tests/test_graph_module.py`'s checks.

Each model is written once per package (NNX and `torch.nn`, the same
attribute names), the NNX one's parameters carried into the torch one by
`nn.convert.load_nnx_params`. Both graphs are traced on the same input.

Tolerances: node paths, their order, fold and replayable flags, the
visible nodes at every resolution and the scheduled run's statistics equal
JAX's; each port graph's execution equals its own model's forward bit for
bit (the graph calls the same modules on the same tensors), and its outputs
are within `FLOAT_TOL` of the largest of the JAX graph's (f32 products
summed in other orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from fastforward_tpu import graph as jgraph
from fastforward_tpu_torch import graph as tgraph
from fastforward_tpu_torch.nn import convert

FLOAT_TOL = 1e-5
D = 8


def _flat(model) -> dict:
    return {"/".join(str(p) for p in path): np.asarray(v[...])
            for path, v in nnx.to_flat_state(nnx.state(model, nnx.Param))}


def _lin(rngs=None):
    return nnx.Linear(D, D, rngs=rngs) if rngs is not None else torch.nn.Linear(D, D)


# Each model is written twice, NNX (J*) and torch (T*), with the same
# attribute names and the same forward.


class JInner(nnx.Module):
    def __init__(self, rngs):
        self.a, self.b = _lin(rngs), _lin(rngs)

    def __call__(self, x):
        return self.b(self.a(x))


class TInner(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.a, self.b = _lin(), _lin()

    def forward(self, x):
        return self.b(self.a(x))


class JChain(nnx.Module):
    def __init__(self, n=3, *, rngs):
        self.blocks = nnx.List([JInner(rngs) for _ in range(n)])

    def __call__(self, x):
        for block in self.blocks:
            x = block(x)
        return x


class TChain(torch.nn.Module):
    def __init__(self, n=3):
        super().__init__()
        self.blocks = torch.nn.ModuleList([TInner() for _ in range(n)])

    def forward(self, x):
        for block in self.blocks:
            x = block(x)
        return x


class JResidual(nnx.Module):
    def __init__(self, rngs):
        self.a = _lin(rngs)

    def __call__(self, x):
        return x + self.a(x)


class TResidual(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.a = _lin()

    def forward(self, x):
        return x + self.a(x)


class JGlue(nnx.Module):
    def __init__(self, *, rngs):
        self.r, self.out = JResidual(rngs), _lin(rngs)

    def __call__(self, x):
        return self.out(self.r(x))


class TGlue(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.r, self.out = TResidual(), _lin()

    def forward(self, x):
        return self.out(self.r(x))


class JGlueFeeds(nnx.Module):
    def __init__(self, *, rngs):
        self.a = _lin(rngs)

    def __call__(self, x):
        return self.a(x * 2.0)


class TGlueFeeds(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.a = _lin()

    def forward(self, x):
        return self.a(x * 2.0)


class JNest(nnx.Module):
    def __init__(self, *, rngs):
        self.first, self.second = JInner(rngs), JInner(rngs)

    def __call__(self, x):
        return self.second(self.first(x))


class TNest(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.first, self.second = TInner(), TInner()

    def forward(self, x):
        return self.second(self.first(x))


class JNestHost(nnx.Module):
    def __init__(self, *, rngs):
        self.deep, self.out = JNest(rngs=rngs), _lin(rngs)

    def __call__(self, x):
        return self.out(self.deep(x))


class TNestHost(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.deep, self.out = TNest(), _lin()

    def forward(self, x):
        return self.out(self.deep(x))


class JShared(nnx.Module):
    def __init__(self, *, rngs):
        self.lin = _lin(rngs)

    def __call__(self, x):
        return self.lin(self.lin(x))


class TShared(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.lin = _lin()

    def forward(self, x):
        return self.lin(self.lin(x))


class JTwoIn(nnx.Module):
    def __init__(self, rngs):
        self.lin = _lin(rngs)

    def __call__(self, x, y, gain=1.0):
        return self.lin(x) + y * gain


class JTwoHost(nnx.Module):
    def __init__(self, *, rngs):
        self.two = JTwoIn(rngs)

    def __call__(self, x):
        return self.two(x, x, gain=2.0)


class TTwoIn(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.lin = _lin()

    def forward(self, x, y, gain=1.0):
        return self.lin(x) + y * gain


class TTwoHost(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.two = TTwoIn()

    def forward(self, x):
        return self.two(x, x, gain=2.0)


MODELS = {
    "chain": (lambda: JChain(rngs=nnx.Rngs(0)), TChain),
    "chain4": (lambda: JChain(4, rngs=nnx.Rngs(0)), lambda: TChain(4)),
    "glue": (lambda: JGlue(rngs=nnx.Rngs(0)), TGlue),
    "glue_feeds": (lambda: JGlueFeeds(rngs=nnx.Rngs(0)), TGlueFeeds),
    "nest": (lambda: JNestHost(rngs=nnx.Rngs(0)), TNestHost),
    "shared": (lambda: JShared(rngs=nnx.Rngs(0)), TShared),
    "two_in": (lambda: JTwoHost(rngs=nnx.Rngs(0)), TTwoHost),
}


def _x(seed=0):
    return np.random.RandomState(seed).randn(4, D).astype(np.float32)


def _pair(name):
    jb, tb = MODELS[name]
    j, t = jb(), tb()
    convert.load_nnx_params(t, _flat(j))
    return j, t


def _traced(name, seed=0):
    j, t = _pair(name)
    return (j, t, jgraph.trace_modules(j, jnp.asarray(_x(seed))),
            tgraph.trace_modules(t, torch.from_numpy(_x(seed))))


def _run(jg, tg, t, seed, **kw):
    """(port graph out, JAX graph out) on a new input; the port's equal to
    its model's bits."""
    x = _x(seed)
    with torch.no_grad():
        got = tg(torch.from_numpy(x), **kw)
        assert torch.equal(got, t(torch.from_numpy(x)))
    want = np.asarray(jg(jnp.asarray(x), **kw))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FLOAT_TOL * np.abs(want).max())
    return got


def _paths(g):
    return [n.path for n in g.nodes()]


def _tree(g):
    return [(n.path, n.is_fold, n.replayable, len(n.arg_refs), n.num_outputs)
            for n in g.all_nodes()]


@pytest.mark.parametrize("name", sorted(MODELS))
def test_trace_structure_and_order_match_jax(name):
    # GIVEN the same model traced in both packages
    _, _, jg, tg = _traced(name)
    # THEN every node (path, fold, replayable, argument and output leaves)
    # and the visible order agree
    assert _tree(tg) == _tree(jg)
    assert _paths(tg) == _paths(jg)
    # AND the summaries list the same lines but for the class names
    strip = [line.split(" (")[0] + line[line.index(","):] for line in tg.summarize().splitlines()]
    assert strip == [line.split(" (")[0] + line[line.index(","):]
                     for line in jg.summarize().splitlines()]


@pytest.mark.parametrize("name", sorted(MODELS))
def test_coarse_execution_matches_model_and_jax(name):
    j, t, jg, tg = _traced(name)
    _run(jg, tg, t, seed=1)


def test_expanded_replayable_fold_matches_model():
    # GIVEN all folds expanded: every Linear is a visible node
    j, t, jg, tg = _traced("chain")
    for g in (jg, tg):
        g.expand("blocks/0", "blocks/1", "blocks/2")
    assert _paths(tg) == [f"blocks/{i}/{s}" for i in range(3) for s in ("a", "b")]
    assert all(tg.find(f"blocks/{i}").replayable for i in range(3))
    _run(jg, tg, t, seed=2)


def test_glue_fold_is_not_replayable_but_execution_stays_exact():
    j, t, jg, tg = _traced("glue")
    assert not tg.find("r").replayable and not jg.find("r").replayable
    for g in (jg, tg):
        g.expand("r")
    _run(jg, tg, t, seed=3)


def test_derived_const_falls_back_and_error_mode_raises():
    # GIVEN root glue feeding the child
    j, t, jg, tg = _traced("glue_feeds")
    child = tg.find("a")
    assert any(isinstance(r, tgraph.Const) and r.derived for r in child.arg_refs)
    # THEN default execution is exact (the opaque fallback)
    _run(jg, tg, t, seed=4)
    # AND 'error' mode raises on both sides, naming the node
    with pytest.raises(tgraph.ReplayError, match="'a'"):
        tg(torch.from_numpy(_x(5)), captured_consts="error")
    with pytest.raises(jgraph.ReplayError):
        jg(jnp.asarray(_x(5)), captured_consts="error")


def test_reduce_resolution_expands_only_target_region():
    _, _, jg, tg = _traced("chain")
    for g in (jg, tg):
        g.reduce_resolution(["blocks/1/a"])
    assert _paths(tg) == _paths(jg) == ["blocks/0", "blocks/1/a", "blocks/1/b", "blocks/2"]
    for g in (jg, tg):
        g.reduce_resolution([jgraph.SubgraphSpec("blocks/2/a", "blocks/2/b")
                             if g is jg else tgraph.SubgraphSpec("blocks/2/a", "blocks/2/b")])
    assert _paths(tg) == _paths(jg)


def test_nested_partial_expand_collapse_and_bounds():
    j, t, jg, tg = _traced("nest")
    for step in (("expand", "deep"), ("expand", "deep/first")):
        for g in (jg, tg):
            getattr(g, step[0])(step[1])
        assert _paths(tg) == _paths(jg)
    assert _paths(tg) == ["deep/first/a", "deep/first/b", "deep/second", "out"]
    _run(jg, tg, t, seed=7)
    seg = tg.find_nodes_on_path("deep/first/b", "out")
    assert [n.path for n in seg] == ["deep/first/b", "deep/second", "out"]
    with pytest.raises(ValueError):
        tg.find_nodes_on_path("out", "deep/second")
    for g in (jg, tg):
        g.collapse("deep")
    assert _paths(tg) == _paths(jg) == ["deep", "out"]
    _run(jg, tg, t, seed=8)
    with pytest.raises(KeyError, match="deep/third"):
        tg.find("deep/third")


def test_topological_order_respects_dataflow():
    _, _, _, tg = _traced("nest")
    tg.expand("deep")
    order = tg.topological_sort()
    pos = {id(n): i for i, n in enumerate(order)}

    def produced_at(node):
        if id(node) in pos:
            return pos[id(node)]
        return max(produced_at(c) for c in node.children)

    for n in order:
        for r in n.arg_refs:
            if isinstance(r, tgraph.NodeRef):
                assert produced_at(r.node) < pos[id(n)], (r.node.path, n.path)


def test_shared_module_is_two_nodes_of_one_module():
    _, t, jg, tg = _traced("shared")
    nodes = list(tg.nodes())
    assert [n.path for n in nodes] == _paths(jg) == ["lin", "lin@1"]
    assert all(n.module is t.lin for n in nodes)


def _zero_fold(module):
    for lin in (module.a, module.b):
        if isinstance(lin, torch.nn.Linear):
            with torch.no_grad():
                lin.weight.zero_()
                lin.bias.zero_()
        else:
            lin.kernel[...] = jnp.zeros_like(lin.kernel[...])
            lin.bias[...] = jnp.zeros_like(lin.bias[...])


def test_run_scheduled_lifetime_and_sequential_optimize():
    # GIVEN a 4-block chain and 3 calibration batches on both sides
    j, t, jg, tg = _traced("chain4")
    seen = {}

    def zero_out(module, stacked):
        seen.setdefault("shapes", []).append(tuple(stacked.shape))
        _zero_fold(module)

    jr = jgraph.run_scheduled(jg, [(jnp.asarray(_x(s)),) for s in range(3)],
                              optimize={"blocks/2": zero_out})
    with torch.no_grad():
        tr = tgraph.run_scheduled(tg, [(torch.from_numpy(_x(s)),) for s in range(3)],
                                  optimize={"blocks/2": zero_out})
    # THEN each optimizer saw the batches stacked row-wise
    assert seen["shapes"] == [(12, D), (12, D)]
    # AND the statistics (runs per node, peak live cache entries) are JAX's
    assert tr["stats"] == jr["stats"]
    assert tr["stats"]["peak_live_entries"] <= 2
    # AND the outputs (downstream of the zeroed block: the same for every
    # batch) agree
    outs = [o.numpy() for o in tr["outputs"]]
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_allclose(outs[0], np.asarray(jr["outputs"][0]), rtol=0,
                               atol=FLOAT_TOL * np.abs(outs[0]).max())
    # AND every cached activation went to host memory and came back
    assert all(o.device.type == "cpu" for o in tr["outputs"])


def test_run_scheduled_optimization_only_skips_tail():
    _, _, jg, tg = _traced("chain4")
    jr = jgraph.run_scheduled(jg, [(jnp.asarray(_x(s)),) for s in range(2)],
                              optimize={"blocks/1": lambda m, s: None}, optimization_only=True)
    tr = tgraph.run_scheduled(tg, [(torch.from_numpy(_x(s)),) for s in range(2)],
                              optimize={"blocks/1": lambda m, s: None}, optimization_only=True)
    assert set(tr["stats"]["node_runs"]) == set(jr["stats"]["node_runs"]) == {"blocks/0",
                                                                              "blocks/1"}
    assert tr["outputs"] == [None, None]
    with pytest.raises(KeyError, match="not visible"):
        tgraph.run_scheduled(tg, [(torch.from_numpy(_x(0)),)], optimize={"blocks/1/a": print})


def test_gpt2_blocks_address_and_execute():
    # GIVEN the tiny GPT-2 in both packages (the blocks consume root glue:
    # the embedding sum), traced on the same ids
    from fastforward_tpu.models import gpt2 as jgpt2
    from fastforward_tpu_torch.models import gpt2 as tgpt2

    j = jgpt2.GPT2LMHead(jgpt2.GPT2Config.tiny(), rngs=nnx.Rngs(0))
    t = tgpt2.GPT2LMHead(tgpt2.GPT2Config.tiny(), device="cpu")
    convert.load_nnx_params(t, _flat(j))
    ids = np.random.RandomState(0).randint(0, 256, (2, 8))
    jg = jgraph.trace_modules(j, jnp.asarray(ids))
    with torch.no_grad():
        tg = tgraph.trace_modules(t, torch.from_numpy(ids))
    assert _paths(tg) == _paths(jg) == ["wte", "wpe", "blocks/0", "blocks/1", "ln_f"]
    # THEN coarse execution on new ids is the model's, bit for bit
    ids2 = np.random.RandomState(1).randint(0, 256, (2, 8))
    with torch.no_grad():
        assert torch.equal(tg(torch.from_numpy(ids2)), t(torch.from_numpy(ids2)))
    # AND the scheduled run over the visible nodes (host-cached activations)
    # gives, for the traced ids, the last node's output (ln_f's) bit for bit;
    # for other ids blocks/0 replays the captured embedding sum (root glue, a
    # derived Const under captured_consts='replay'), as JAX's does
    seen = []
    handle = t.ln_f.register_forward_hook(lambda m, a, out: seen.append(out))
    with torch.no_grad():
        t(torch.from_numpy(ids))
        res = tgraph.run_scheduled(tg, [torch.from_numpy(ids), torch.from_numpy(ids2)])
    handle.remove()
    assert torch.equal(res["outputs"][0], seen[0])
    assert res["stats"]["node_runs"] == {p: 2 for p in _paths(tg)}
    jres = jgraph.run_scheduled(jg, [jnp.asarray(ids), jnp.asarray(ids2)])
    for got, want in zip(res["outputs"], jres["outputs"]):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FLOAT_TOL * np.abs(want).max())
