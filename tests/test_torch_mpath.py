"""The port's mpath (`fastforward_tpu_torch/mpath/`) and quantizer
configuration (`fastforward_tpu_torch/quant_init.py`) against the JAX
package's (`fastforward_tpu/mpath/`, `quant_init.py`), on the CPU.

One module tree built twice, as flax NNX modules and as `torch.nn` modules
with the same attribute names (an embedding, twelve blocks of a Linear and
a LayerNorm, a head), so that the list indices "10" and "11" sort before
"2". Every query must select the same ``full_name``s in the same order on
both trees, before and after `quantize_model`. `QuantizationConfig` must
install the same quantizers (type, bits, symmetry, granularity mapped to
torch's layout by `nn.convert.transpose_granularity`, slot tags) under each
overwrite policy, and raise the same error. Tolerance: none; names, order,
quantizer fields and messages are compared for equality.
"""

import pytest
import torch
from flax import nnx

from fastforward_tpu import mpath as jmpath
from fastforward_tpu import nn as jnn
from fastforward_tpu import quantization as jq
from fastforward_tpu.exceptions import QuantizationError as JQuantizationError
from fastforward_tpu.quant_init import QuantizationConfig as JConfig
from fastforward_tpu.quant_init import find_quantizers as jfind
from fastforward_tpu_torch import QuantizationConfig as TConfig
from fastforward_tpu_torch import find_quantizers as tfind
from fastforward_tpu_torch import mpath as tmpath
from fastforward_tpu_torch import nn as tnn
from fastforward_tpu_torch.exceptions import QuantizationError as TQuantizationError
from fastforward_tpu_torch.nn import convert

N_BLOCKS = 12


class JBlock(nnx.Module):
    def __init__(self, *, rngs):
        self.linear = nnx.Linear(4, 4, rngs=rngs)
        self.norm = nnx.LayerNorm(4, rngs=rngs)


class JModel(nnx.Module):
    def __init__(self, *, rngs):
        self.embed = nnx.Embed(10, 4, rngs=rngs)
        self.blocks = nnx.data([JBlock(rngs=rngs) for _ in range(N_BLOCKS)])
        self.head = nnx.Linear(4, 10, rngs=rngs)


class TBlock(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.linear = torch.nn.Linear(4, 4)
        self.norm = torch.nn.LayerNorm(4)


class TModel(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.embed = torch.nn.Embedding(10, 4)
        self.blocks = torch.nn.ModuleList([TBlock() for _ in range(N_BLOCKS)])
        self.head = torch.nn.Linear(4, 10)


def _models(quantized):
    j, t = JModel(rngs=nnx.Rngs(0)), TModel()
    if quantized:
        jnn.quantize_model(j)
        tnn.quantize_model(t)
    return j, t


QUERIES = [
    "**",
    "*",
    "head",
    "blocks/*",
    "blocks/*/linear",
    "**/head",
    "**/[cls:Linear]",
    "**/[cls:Embed]",          # NNX's name; torch.nn.Embedding in the port
    "**/[cls:LayerNorm]",
    "blocks/[re:1.*]/linear",
    "blocks/*/~norm",
    "**/[cls:Linear]&[re:head|linear]",
    "blocks/[re:1]|[re:2]|[re:10]/*",
    "**/[cls:Block]/norm",
]
QUANTIZED_QUERIES = QUERIES + [
    "**/[quantizer:parameter/weight]",
    "**/[quantizer:parameter]",
    "**/[quantizer:activation/input]",
    "**/[quantizer:*]",
    "blocks/[re:1.]/*/[quantizer:activation]",
    "**/[cls:Linear]/[quantizer:parameter/weight]",
    "**/~[quantizer:*]",
    "**/[cls:QuantizedLinear]",
    "**/[cls:Quantizer]",
    "**/[cls:QuantizerStub]",
]


def _context(side):
    return {"Block": JBlock if side == "j" else TBlock}


@pytest.mark.parametrize("quantized", [False, True], ids=["float", "quantized"])
def test_queries_select_jax_paths_in_jax_order(quantized):
    # GIVEN the same tree in both packages
    j, t = _models(quantized)
    for query in (QUANTIZED_QUERIES if quantized else QUERIES):
        # WHEN each package searches it
        want = jmpath.search(query, j, context=_context("j")).paths
        got = tmpath.search(query, t, context=_context("t")).paths
        # THEN the same full names, in the same order
        assert got == want, query
        assert want, query


def test_order_is_by_string_segments():
    j, t = _models(False)
    paths = tmpath.search("blocks/*", t).paths
    assert paths[:4] == ["blocks/0", "blocks/1", "blocks/10", "blocks/11"]
    assert paths == jmpath.search("blocks/*", j).paths


def test_selector_algebra_and_collections():
    j, t = _models(True)
    for build in (lambda m: m.query("head") | m.query("embed"),
                  lambda m: m.query("blocks") / "*" / "linear",
                  lambda m: m.query("blocks/**") & m.query("**/[cls:Linear]"),
                  lambda m: m.query("**/[cls:Linear]")[1:]):
        assert tmpath.search(build(tmpath), t).paths == jmpath.search(build(jmpath), j).paths
    for ops in (lambda a, b: a - b, lambda a, b: a & b, lambda a, b: a | b):
        want = ops(jmpath.search("**/[cls:Linear]", j), jmpath.search("blocks/**", j)).paths
        got = ops(tmpath.search("**/[cls:Linear]", t), tmpath.search("blocks/**", t)).paths
        assert got == want


def test_update_module_in_a_list_and_an_attribute():
    _, t = _models(False)
    item = tmpath.search("blocks/10/linear", t)[0]
    new = torch.nn.Linear(4, 4)
    item.update_module(new)
    assert t.blocks[10].linear is new and item.module is new
    block = TBlock()
    tmpath.search("blocks/11", t)[0].update_module(block)
    assert t.blocks[11] is block
    d = torch.nn.ModuleDict({"a": torch.nn.Linear(2, 2)})
    tmpath.search("a", d)[0].update_module(new)
    assert d["a"] is new


def test_class_resolution_errors_and_extension():
    j, t = _models(False)
    with pytest.raises(ValueError, match="Cannot resolve") as je:
        jmpath.search("**/[cls:NoSuchClass]", j)
    with pytest.raises(ValueError, match="Cannot resolve") as te:
        tmpath.search("**/[cls:NoSuchClass]", t)
    assert str(te.value) == str(je.value)

    def factory(frag_base):
        class HasAttr(frag_base):
            def __init__(self, attr):
                self.attr = attr

            def matches(self, segment, module):
                return hasattr(module, self.attr)
        return lambda payload, context: HasAttr(payload)

    jmpath.mpath_query_extension("hasnorm")(factory(jmpath.Fragment))
    tmpath.mpath_query_extension("hasnorm")(factory(tmpath.Fragment))
    want = jmpath.search("**/[hasnorm:norm]", j).paths
    assert tmpath.search("**/[hasnorm:norm]", t).paths == want
    assert len(want) == N_BLOCKS


# --- QuantizationConfig -----------------------------------------------------


def _quantizer_fields(q, torch_side, slot, owner):
    """(type, bits, symmetric, granularity in torch's layout, tags) of a
    quantizer slot; stubs by type and tags only."""
    tags = tuple(t.name for t in q.quant_metadata.tags) if q.quant_metadata else ()
    if q.is_stub:
        return ("stub", tags)
    gran = q.granularity
    if not torch_side:
        perm = (1, 0) if slot == "weight_quantizer" and "Linear" in owner else None
        gran = convert.transpose_granularity(gran, perm) if perm else \
            convert.transpose_granularity(gran, tuple(range(2)))
    return (type(q).__name__, q.num_bits, q.symmetric, repr(gran), tags)


def _installed(j, t):
    owners = {item.full_name: type(item.module).__name__ for item in jmpath.search("**", j)}
    jq_ = {}
    for name, q in jnn.named_quantizers(j):
        owner = owners["/".join(name.split("/")[:-1])] if "/" in name else type(j).__name__
        jq_[name] = _quantizer_fields(q, False, name.split("/")[-1], owner)
    tq_ = {name.replace(".", "/"): _quantizer_fields(q, True, None, None)
           for name, q in tnn.named_quantizers(t)}
    return jq_, tq_


def _rules(cfg, lq, gran_w):
    cfg.add_rule("**/[quantizer:parameter]", lq, num_bits=8, symmetric=True)
    cfg.add_rule("**/[cls:Linear]/[quantizer:parameter/weight]", lq, num_bits=4,
                 symmetric=True, granularity=gran_w)
    cfg.add_rule("**/[quantizer:activation/input]", lq, num_bits=8, symmetric=False)
    cfg.add_rule("blocks/1/linear/output_quantizer", lq, num_bits=6)
    return cfg


@pytest.mark.parametrize("policy", ["overwrite", "skip", "error"])
def test_quantization_config_installs_jax_quantizers(policy):
    # GIVEN both trees converted, and the same rules (the weight grid given
    # on each package's layout)
    j, t = _models(True)
    jgran = jq.PerChannel(1)
    jcfg = _rules(JConfig(), jnn.LinearQuantizer, jgran)
    tcfg = _rules(TConfig(), tnn.LinearQuantizer,
                  convert.transpose_granularity(jgran, convert.LINEAR_WEIGHT_PERM))
    # WHEN each initializes its tree under the policy (from stubs: every
    # policy installs; then again over the installed quantizers)
    jcfg.initialize(j, overwrite_policy="overwrite")
    tcfg.initialize(t, overwrite_policy="overwrite")
    jnum, tnum = JConfig(), TConfig()
    jnum.add_rule("**/[quantizer:parameter/weight]", jnn.LinearQuantizer, num_bits=3)
    tnum.add_rule("**/[quantizer:parameter/weight]", tnn.LinearQuantizer, num_bits=3)
    if policy == "error":
        with pytest.raises(JQuantizationError) as je:
            jnum.initialize(j, overwrite_policy=policy)
        with pytest.raises(TQuantizationError) as te:
            tnum.initialize(t, overwrite_policy=policy)
        # THEN the same error, word for word
        assert str(te.value) == str(je.value)
        assert "already initialized" in str(te.value)
    else:
        jnum.initialize(j, overwrite_policy=policy)
        tnum.initialize(t, overwrite_policy=policy)
    # THEN the same quantizers in every slot
    want, got = _installed(j, t)
    assert got == want
    bits = {f[1] for n, f in got.items() if n.endswith("weight_quantizer")}
    assert bits == ({3} if policy == "overwrite" else {4, 8})


def test_find_quantizers_and_collection_initialize():
    j, t = _models(True)
    for query in ("**/[quantizer:parameter/weight]", "blocks/0/linear/output_quantizer",
                  "**/[cls:Linear]", "head/*"):
        assert tfind(t, query).paths == jfind(j, query).paths
    jfind(j, "**/[quantizer:activation]").initialize(jnn.LinearQuantizer, num_bits=8)
    tfind(t, "**/[quantizer:activation]").initialize(tnn.LinearQuantizer, num_bits=8)
    want, got = _installed(j, t)
    assert got == want
    # the slot metadata carries over from the stub
    assert t.head.output_quantizer.quant_metadata.matches_tag("activation/output")
