"""The port's `utils/serialization.py`, `utils/block_yaml.py` and
`utils/checkpoint.py` against the JAX package's, on the CPU.

The cases of `tests/test_checkpoint.py` run on the port (a two-Linear
torch MLP, torch's (out, in) layout: JAX's ``PerChannel(1)`` on a kernel
is ``PerChannel(0)`` on a weight): the round trip; lazy quantizers, opt-in
at save and at load; a shared quantizer written once and loaded as one
object, its ``shared_with`` the path JAX records for the same model;
the three overwrite policies; stubs not saved; the version gate; missing
files; the ``name_or_path`` warning. Beside them:
- a state written by the JAX package loads into the port's model (its
  weights carried by `nn.convert.load_nnx_params`): the scales are JAX's
  reordered onto torch's layout, and the quantized weights' grids and the
  layers' quantized outputs equal JAX's;
- ``config.yaml`` is the text ``yaml.safe_dump`` writes for the same dict,
  and `block_yaml.safe_load` reads JAX-written files, and texts with
  floats such as ``1.0e-05``, awkward strings and folded long lines, as
  ``yaml.safe_load`` does;
- `serialization.dump` / `load` of every granularity, and JAX's
  ``fastforward_tpu.`` type names read as the port's;
- `save_params` / `load_params`: a `QuantizedTensor` leaf keeps its raw
  dtype and grid; tiny `ServingParams` in every ported mode come back byte
  for byte with their dataclasses and non-tensor fields; without a
  template as nested dicts; a template of another shape, dtype or mode
  raises.
"""

import dataclasses
import math
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import nnx

import fastforward_tpu as ff
import fastforward_tpu_torch as fft
from fastforward_tpu import nn as jnn
from fastforward_tpu.utils import checkpoint as jck
from fastforward_tpu.utils import serialization as jser
from fastforward_tpu_torch import nn as tnn
from fastforward_tpu_torch.models.llama import LlamaConfig
from fastforward_tpu_torch.nn import convert
from fastforward_tpu_torch.serving.engine import PACKED_MODES, PORTED_MODES, random_serving_params
from fastforward_tpu_torch.serving.stacked import random_stacked_params
from fastforward_tpu_torch.utils import block_yaml
from fastforward_tpu_torch.utils import checkpoint as tck
from fastforward_tpu_torch.utils import serialization as tser


class JMLP(nnx.Module):
    def __init__(self, *, rngs):
        self.fc1 = nnx.Linear(8, 16, rngs=rngs)
        self.fc2 = nnx.Linear(16, 4, rngs=rngs)


class TMLP(torch.nn.Module):
    def __init__(self):
        super().__init__()
        gen = torch.Generator().manual_seed(0)
        self.fc1 = torch.nn.Linear(8, 16)
        self.fc2 = torch.nn.Linear(16, 4)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=gen))


def _tconfig():
    config = fft.QuantizationConfig()
    config.add_rule("**/[quantizer:parameter/weight]", tnn.LinearQuantizer,
                    num_bits=4, symmetric=True, granularity=fft.PerChannel(0))
    config.add_rule("**/[quantizer:activation/output]", tnn.LinearQuantizer,
                    num_bits=8, symmetric=False)
    return config


def _quantized_mlp(initialized=True):
    model = TMLP()
    tnn.quantize_model(model)
    _tconfig().initialize(model)
    if initialized:
        model.fc1.weight_quantizer.quantization_range = (
            torch.full((16,), -1.0), torch.full((16,), 1.0))
        model.fc2.weight_quantizer.quantization_range = (
            torch.full((4,), -0.5), torch.full((4,), 0.5))
        model.fc1.output_quantizer.quantization_range = (-3.0, 3.0)
        model.fc2.output_quantizer.quantization_range = (-2.0, 4.0)
    return model


def _fresh():
    model = TMLP()
    tnn.quantize_model(model)
    return model


def _jax_mlp(initialized=True):
    model = JMLP(rngs=nnx.Rngs(0))
    jnn.quantize_model(model)
    config = ff.QuantizationConfig()
    config.add_rule("**/[quantizer:parameter/weight]", jnn.LinearQuantizer,
                    num_bits=4, symmetric=True, granularity=ff.PerChannel(1))
    config.add_rule("**/[quantizer:activation/output]", jnn.LinearQuantizer,
                    num_bits=8, symmetric=False)
    config.initialize(model)
    if initialized:
        model.fc1.weight_quantizer.quantization_range = (
            jnp.linspace(-1.0, -0.5, 16), jnp.linspace(1.0, 0.5, 16))
        model.fc2.weight_quantizer.quantization_range = (
            jnp.full((4,), -0.5), jnp.full((4,), 0.5))
        model.fc1.output_quantizer.quantization_range = (-3.0, 3.0)
        model.fc2.output_quantizer.quantization_range = (-2.0, 4.0)
    return model


# -- the cases of tests/test_checkpoint.py, on the port ---------------------------------


def _case_roundtrip(tmp_path):
    model = _quantized_mlp()
    tck.save_quantization_state(model, str(tmp_path / "state"))
    fresh = _fresh()
    tck.load_quantization_state(fresh, str(tmp_path / "state"))
    q = fresh.fc1.weight_quantizer
    assert isinstance(q, tnn.LinearQuantizer)
    assert q.num_bits == 4 and q.granularity == fft.PerChannel(0)
    assert torch.equal(q.scale, model.fc1.weight_quantizer.scale)
    oq = fresh.fc2.output_quantizer
    assert oq.offset is not None and torch.equal(oq.offset, model.fc2.output_quantizer.offset)
    mn, _ = oq.quantization_range
    assert math.isclose(float(mn.detach().squeeze()), -2.0, rel_tol=1e-5)
    x = torch.randn(3, 8, generator=torch.Generator().manual_seed(1))
    with fft.strict_quantization(False), torch.no_grad():
        assert torch.equal(fresh.fc1(x).dequantize(), model.fc1(x).dequantize())


def _case_lazy(tmp_path):
    model = _quantized_mlp(initialized=False)
    with pytest.raises(fft.QuantizationError, match="lazy"):
        tck.save_quantization_state(model, str(tmp_path / "state"))
    tck.save_quantization_state(model, str(tmp_path / "state"), allow_lazy_params=True)
    fresh = _fresh()
    with pytest.raises(fft.QuantizationError, match="lazy"):
        tck.load_quantization_state(fresh, str(tmp_path / "state"))
    tck.load_quantization_state(fresh, str(tmp_path / "state"), allow_lazy_params=True)
    assert isinstance(fresh.fc1.weight_quantizer, tnn.LinearQuantizer)
    assert fresh.fc1.weight_quantizer.has_uninitialized_params


def _case_shared(tmp_path):
    model = _quantized_mlp()
    model.fc2.output_quantizer = model.fc1.output_quantizer
    tck.save_quantization_state(model, str(tmp_path / "state"))
    fresh = _fresh()
    tck.load_quantization_state(fresh, str(tmp_path / "state"))
    assert fresh.fc1.output_quantizer is fresh.fc2.output_quantizer
    # the path JAX records for the same sharing on the same module tree
    jmodel = _jax_mlp()
    jmodel.fc2.output_quantizer = jmodel.fc1.output_quantizer
    jck.save_quantization_state(jmodel, str(tmp_path / "jax"))
    ours = yaml.safe_load((tmp_path / "state" / "config.yaml").read_text())["quantizers"]
    theirs = yaml.safe_load((tmp_path / "jax" / "config.yaml").read_text())["quantizers"]
    assert ours["fc2/output_quantizer"] == theirs["fc2/output_quantizer"] == \
        {"shared_with": "fc1/output_quantizer"}
    assert sorted(ours) == sorted(theirs)


def _case_policy_error(tmp_path):
    model = _quantized_mlp()
    tck.save_quantization_state(model, str(tmp_path / "state"))
    with pytest.raises(fft.QuantizationError, match="already initialized"):
        tck.load_quantization_state(model, str(tmp_path / "state"), overwrite_policy="error")


def _case_policy_skip(tmp_path):
    model = _quantized_mlp()
    tck.save_quantization_state(model, str(tmp_path / "state"))
    existing = model.fc1.weight_quantizer
    tck.load_quantization_state(model, str(tmp_path / "state"), overwrite_policy="skip")
    assert model.fc1.weight_quantizer is existing


def _case_policy_overwrite(tmp_path):
    model = _quantized_mlp()
    tck.save_quantization_state(model, str(tmp_path / "state"))
    existing = model.fc1.weight_quantizer
    tck.load_quantization_state(model, str(tmp_path / "state"), overwrite_policy="overwrite")
    assert model.fc1.weight_quantizer is not existing
    assert torch.equal(model.fc1.weight_quantizer.scale, existing.scale)


def _case_stubs(tmp_path):
    tck.save_quantization_state(_fresh(), str(tmp_path / "state"))
    saved = yaml.safe_load((tmp_path / "state" / "config.yaml").read_text())
    assert saved["quantizers"] == {}


def _case_granularity_any_import_order(tmp_path):
    g = fft.PerTensor()
    assert hasattr(g, "_yaml_init_args")
    text = tser.dump({"g": g, "b": fft.PerBlock(0, 64, 1)})
    restored = tser.load(text)
    assert restored["g"] == fft.PerTensor() and restored["b"] == fft.PerBlock(0, 64, 1)


def _case_name_or_path(tmp_path):
    model = _quantized_mlp()
    tck.save_quantization_state(model, str(tmp_path / "state"), name_or_path="llama-8b")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        tck.load_quantization_state(_fresh(), str(tmp_path / "state"), name_or_path="gpt2")
    assert any("llama-8b" in str(x.message) for x in w)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        tck.load_quantization_state(_fresh(), str(tmp_path / "state"), name_or_path="llama-8b")
    assert not any("saved for" in str(x.message) for x in w)


def _case_missing_files(tmp_path):
    model = _quantized_mlp()
    with pytest.raises(fft.QuantizationError, match="config not found"):
        tck.load_quantization_state(model, str(tmp_path / "nowhere"))
    tck.save_quantization_state(model, str(tmp_path / "state"))
    (tmp_path / "state" / "quantizers.safetensors").unlink()
    with pytest.raises(fft.QuantizationError, match="tensors not found"):
        tck.load_quantization_state(model, str(tmp_path / "state"))


def _case_version(tmp_path):
    tck.save_quantization_state(_quantized_mlp(), str(tmp_path / "state"))
    cfg = tmp_path / "state" / "config.yaml"
    saved = yaml.safe_load(cfg.read_text())
    saved["version"] = "99.0"
    cfg.write_text(yaml.safe_dump(saved))
    with pytest.raises(fft.QuantizationError, match="version"):
        tck.load_quantization_state(_fresh(), str(tmp_path / "state"))


def _case_path_not_found(tmp_path):
    tck.save_quantization_state(_quantized_mlp(), str(tmp_path / "state"))
    other = torch.nn.Sequential(torch.nn.Linear(8, 4))
    tnn.quantize_model(other)
    with pytest.raises(fft.QuantizationError, match="not found in model"):
        tck.load_quantization_state(other, str(tmp_path / "state"))


CASES = {
    "roundtrip": _case_roundtrip,
    "lazy": _case_lazy,
    "shared": _case_shared,
    "policy_error": _case_policy_error,
    "policy_skip": _case_policy_skip,
    "policy_overwrite": _case_policy_overwrite,
    "stubs_not_saved": _case_stubs,
    "granularity_any_import_order": _case_granularity_any_import_order,
    "name_or_path": _case_name_or_path,
    "missing_files": _case_missing_files,
    "version": _case_version,
    "path_not_found": _case_path_not_found,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_quantization_state_case(case, tmp_path):
    CASES[case](tmp_path)


# -- JAX-written states ------------------------------------------------------------------


def _flat(model) -> dict:
    return {"/".join(str(p) for p in path): np.asarray(v[...])
            for path, v in nnx.to_flat_state(nnx.state(model, nnx.Param))
            if path[-1] in ("kernel", "bias")}


def test_jax_written_state_loads_into_the_port(tmp_path):
    # GIVEN a JAX MLP, quantized and calibrated, its state saved by JAX
    jmodel = _jax_mlp()
    jck.save_quantization_state(jmodel, str(tmp_path / "jax"), name_or_path="mlp")
    # AND the port's MLP holding the same float weights
    model = TMLP()
    convert.load_nnx_params(model, _flat(jmodel))
    tnn.quantize_model(model)
    # WHEN the JAX-written state loads into it
    tck.load_quantization_state(model, str(tmp_path / "jax"), name_or_path="mlp")
    q = model.fc1.weight_quantizer
    # THEN the quantizers are the port's, on torch's layout, with JAX's scales
    assert type(q) is tnn.LinearQuantizer and q.granularity == fft.PerChannel(0)
    np.testing.assert_array_equal(q.scale.detach().numpy(),
                                  np.asarray(jmodel.fc1.weight_quantizer.scale[...]))
    # AND the quantized weights and outputs equal JAX's
    x = np.random.RandomState(1).randn(3, 8).astype(np.float32)
    with ff.strict_quantization(False), fft.strict_quantization(False), torch.no_grad():
        _same_quantized_layers(jmodel, model, x)


def _same_quantized_layers(jmodel, model, x):
    for name in ("fc1", "fc2"):
        jl, tl = getattr(jmodel, name), getattr(model, name)
        jw = jl.weight_quantizer(jl.kernel[...])
        tw = tl.weight_quantizer(tl.weight)
        np.testing.assert_array_equal(tw.raw_data.numpy(), np.asarray(jw.raw_data).T)
        xin = x if name == "fc1" else np.asarray(jmodel.fc1(jnp.asarray(x)).dequantize())
        jy = jl(jnp.asarray(xin))
        ty = tl(torch.from_numpy(np.array(xin)))
        np.testing.assert_array_equal(ty.raw_data.numpy(), np.asarray(jy.raw_data))
        np.testing.assert_array_equal(ty.dequantize().numpy(), np.asarray(jy.dequantize()))


def test_jax_written_per_block_state_reorders_tiles(tmp_path):
    # GIVEN a JAX state with PerBlock(0, 4, 1) weight grids on (in, out) kernels
    jmodel = JMLP(rngs=nnx.Rngs(0))
    jnn.quantize_model(jmodel)
    config = ff.QuantizationConfig()
    config.add_rule("**/[quantizer:parameter/weight]", jnn.LinearQuantizer, num_bits=4,
                    symmetric=True, granularity=ff.PerBlock(0, 4, 1))
    config.initialize(jmodel)
    for layer in (jmodel.fc1, jmodel.fc2):
        k = np.asarray(layer.kernel[...])
        K, N = k.shape
        mabs = np.abs(k.reshape(K // 4, 4, N)).max(axis=1).reshape(-1)
        layer.weight_quantizer.quantization_range = (-jnp.asarray(mabs), jnp.asarray(mabs))
    jck.save_quantization_state(jmodel, str(tmp_path / "jax"))
    model = TMLP()
    convert.load_nnx_params(model, _flat(jmodel))
    tnn.quantize_model(model)
    tck.load_quantization_state(model, str(tmp_path / "jax"))
    # THEN the granularity is PerBlock(1, 4, 0) and the grids equal JAX's, transposed
    with torch.no_grad():
        _same_weight_grids(jmodel, model)


def _same_weight_grids(jmodel, model):
    for name in ("fc1", "fc2"):
        jl, tl = getattr(jmodel, name), getattr(model, name)
        assert tl.weight_quantizer.granularity == fft.PerBlock(1, 4, 0)
        jw = jl.weight_quantizer(jl.kernel[...])
        tw = tl.weight_quantizer(tl.weight)
        np.testing.assert_array_equal(tw.raw_data.numpy(), np.asarray(jw.raw_data).T)
        np.testing.assert_array_equal(tw.dequantize().numpy(), np.asarray(jw.dequantize()).T)


# -- config.yaml: the text yaml.safe_dump writes, read as yaml.safe_load reads ---------


@pytest.mark.parametrize("name_or_path", [None, "llama-8b", "meta-llama/Llama-3.1 8B: it's 'big'",
                                          "x" * 40 + " " + "y" * 60 + " tail", "naïve", "1.0",
                                          "a #comment", "- dash", "multi\nline"])
def test_config_yaml_is_safe_dump_text(tmp_path, name_or_path):
    model = _quantized_mlp()
    model.fc2.output_quantizer = model.fc1.output_quantizer
    tck.save_quantization_state(model, str(tmp_path / "state"), name_or_path=name_or_path)
    text = (tmp_path / "state" / "config.yaml").read_text()
    data = yaml.safe_load(text)
    assert yaml.safe_dump(data) == text
    assert block_yaml.safe_load(text) == data
    assert data.get("name_or_path") == name_or_path


def _jax_states(tmp_path):
    out = []
    for i, (initialized, share, name) in enumerate([(True, False, None), (False, False, "m"),
                                                     (True, True, "meta-llama/x y: 'z'")]):
        model = _jax_mlp(initialized)
        if share:
            model.fc2.output_quantizer = model.fc1.output_quantizer
        path = tmp_path / f"jax{i}"
        jck.save_quantization_state(model, str(path), name_or_path=name,
                                    allow_lazy_params=not initialized)
        out.append((path / "config.yaml").read_text())
    return out


def test_reader_equals_safe_load_on_jax_files(tmp_path):
    for text in _jax_states(tmp_path):
        assert block_yaml.safe_load(text) == yaml.safe_load(text)
        # the same dict written by the port is JAX's text
        assert block_yaml.safe_dump(yaml.safe_load(text)) == text
    # a float, as PyYAML writes one
    data = yaml.safe_load(_jax_states(tmp_path)[0])
    data["quantizers"]["fc1/weight_quantizer"]["args"]["eps"] = 1e-05
    text = yaml.safe_dump(data)
    assert "eps: 1.0e-05" in text
    assert block_yaml.safe_dump(data) == text
    assert block_yaml.safe_load(text) == yaml.safe_load(text)
    assert block_yaml.safe_load("a: 1e-05\n") == yaml.safe_load("a: 1e-05\n") == {"a": "1e-05"}


YAML_CASES = [
    {"a": 1, "b": -2.5, "c": True, "d": None, "e": "", "f": "1.0", "g": [1, 2], "h": {}},
    {"f": [1e-05, 1e17, float("inf"), -float("inf"), 0.1, -0.0, 123456789.125]},
    {"s": ["true", "no", "~", "null", "0x1F", "07", "1_000", "2001-12-14", "<<", "=", ".inf"]},
    {"s": ["- a", ": b", "a: b", "a #b", "#c", "?x", "? y", "---", "...", " lead", "trail ",
           "it's", 'say "hi"', "tab\there", "back\\slash", "é", "中", "\U0001F600"]},
    {"long": " ".join(["word"] * 40), "long_quoted": "'" + " ".join(["w"] * 60),
     "long_double": "é " * 50, "lines": "a\nb\n\nc", "spacebreak": "a \nb"},
    {"n": {"m": {"k": [[1, 2], [3, [4, 5]], {"x": 1, "y": [True]}, [], {}]}}},
    {"k" * 122: 1},
]


@pytest.mark.parametrize("i", range(len(YAML_CASES)))
def test_block_yaml_matches_pyyaml(i):
    data = YAML_CASES[i]
    text = yaml.safe_dump(data)
    assert block_yaml.safe_dump(data) == text

    def same(a, b):
        if isinstance(a, float) and isinstance(b, float):
            return (math.isnan(a) and math.isnan(b)) or a == b
        if isinstance(a, dict):
            return isinstance(b, dict) and a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
        if isinstance(a, list):
            return isinstance(b, list) and len(a) == len(b) and all(map(same, a, b))
        return type(a) is type(b) and a == b

    assert same(block_yaml.safe_load(text), yaml.safe_load(text))


def test_block_yaml_refuses_what_it_cannot_write_or_read():
    with pytest.raises(ValueError, match="simple key"):
        block_yaml.safe_dump({"k" * 123: 1})
    with pytest.raises(ValueError):
        block_yaml.safe_dump({"a": (1, 2)})
    for text in ("a: [1, 2]\n", "a: |\n  x\n", "a: !!str 1\n", "a: 2001-12-14\n"):
        with pytest.raises(ValueError):
            block_yaml.safe_load(text)


def test_block_yaml_reads_anchors():
    shared = [1, 2]
    text = yaml.safe_dump({"a": shared, "b": shared})
    assert "&id001" in text
    assert block_yaml.safe_load(text) == yaml.safe_load(text)


# -- serialization ---------------------------------------------------------------------


GRANULARITIES = {
    "PerTensor": (lambda m: m.PerTensor(),),
    "PerChannel": (lambda m: m.PerChannel((0, 2)),),
    "PerBlock": (lambda m: m.PerBlock(block_dims=1, block_sizes=64, per_channel_dims=0),),
    "PerTile": (lambda m: m.PerTile((2, 4)),),
}


@pytest.mark.parametrize("kind", sorted(GRANULARITIES))
def test_granularity_dump_load(kind):
    make = GRANULARITIES[kind][0]
    g = make(fft)
    assert tser.load(tser.dump(g)) == g
    assert tser.load(tser.dump({"g": g}))["g"] == g
    assert tser.from_yamlable_dict(tser.to_yamlable_dict(g)) == g
    # JAX's text of the same granularity names the JAX class: read as the port's
    jtext = jser.dump({"g": make(ff)})
    assert "fastforward_tpu.quantization.granularity" in jtext
    assert tser.load(jtext)["g"] == g
    jdict = jser.to_yamlable_dict(make(ff))
    assert tser.from_yamlable_dict(jdict) == g


def test_names_outside_the_port_raise():
    with pytest.raises(ValueError, match="refusing"):
        tser.from_yamlable_dict({"type": "os.system", "args": {}})
    assert tser.port_name("fastforward_tpu.nn.linear_quantizer.LinearQuantizer") == \
        "fastforward_tpu_torch.nn.linear_quantizer.LinearQuantizer"
    assert tser.resolve_name("fastforward_tpu.nn.linear_quantizer.LinearQuantizer") is \
        tnn.LinearQuantizer


# -- params ------------------------------------------------------------------------------


def test_params_roundtrip_quantized_leaf(tmp_path):
    # GIVEN a tree with a QuantizedTensor leaf (the case of test_checkpoint.py)
    qa = fft.quantize_per_tensor(torch.arange(8.0).reshape(2, 4), scale=0.1, num_bits=8)
    params = {"layer": {"w": qa, "b": torch.ones((4,), dtype=torch.float32)}}
    tck.save_params(params, str(tmp_path / "ckpt"))
    restored = tck.load_params(str(tmp_path / "ckpt"), template=params)
    # THEN it round-trips with its raw dtype and grid
    w = restored["layer"]["w"]
    assert type(w) is type(qa) and w.raw_data.dtype == qa.raw_data.dtype
    assert torch.equal(w.raw_data, qa.raw_data) and torch.equal(w.dequantize(), qa.dequantize())
    assert w.quant_args().granularity == qa.quant_args().granularity
    free = tck.load_params(str(tmp_path / "ckpt"), device="cpu")
    assert torch.equal(free["layer"]["w"]["raw_data"], qa.raw_data)


def _tiny_config():
    return LlamaConfig(vocab_size=64, hidden_size=128, intermediate_size=256, num_layers=2,
                       num_heads=4, num_kv_heads=2, head_dim=32)


def _tensors(tree, path=""):
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name), f"{path}.{f.name}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _tensors(v, f"{path}.{i}")


@pytest.mark.parametrize("mode", PORTED_MODES)
def test_params_roundtrip_serving_params(tmp_path, mode):
    # per-layer params of a packed mode; the sim tier's come stacked (a tuple
    # of the params and the stacked layers)
    if mode in PACKED_MODES:
        params = random_serving_params(_tiny_config(), mode=mode, group_size=64, seed=0,
                                       device="cpu")
    else:
        params = random_stacked_params(_tiny_config(), mode=mode, group_size=64, seed=0,
                                       device="cpu")
    written = tck.save_params(params, str(tmp_path / "p"))
    loaded = tck.load_params(str(tmp_path / "p"), template=params)
    assert written > 0 and type(loaded) is type(params)
    a, b = list(_tensors(params)), list(_tensors(loaded))
    assert [p for p, _ in a] == [p for p, _ in b] and a
    for (path, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape, path
        assert torch.equal(x.contiguous().view(torch.uint8), y.contiguous().view(torch.uint8)), path
    layers = zip(params.layers, loaded.layers) if mode in PACKED_MODES else [(params[1], loaded[1])]
    for la, lb in layers:
        for f in ("q_proj", "down_proj"):
            qa, qb = getattr(la, f), getattr(lb, f)
            assert type(qb) is type(qa)
            assert (qa.mode, qa.group_size, qa.paired) == (qb.mode, qb.group_size, qb.paired)
    free = tck.load_params(str(tmp_path / "p"), device="cpu")
    layer = free["layers"][0] if mode in PACKED_MODES else free[1]
    assert layer["q_proj"]["mode"] == mode
    embedding = params.embedding if mode in PACKED_MODES else params[0].embedding
    assert torch.equal((free if mode in PACKED_MODES else free[0])["embedding"], embedding)


def test_params_template_mismatch_raises(tmp_path):
    config = _tiny_config()
    params = random_serving_params(config, mode="w4a8", group_size=64, seed=0, device="cpu")
    tck.save_params(params, str(tmp_path / "p"))
    other = random_serving_params(dataclasses.replace(config, vocab_size=96), mode="w4a8",
                                  group_size=64, seed=0, device="cpu")
    with pytest.raises(ValueError, match="embedding"):
        tck.load_params(str(tmp_path / "p"), template=other)
    bf = dataclasses.replace(params, final_norm=params.final_norm.float())
    with pytest.raises(ValueError, match="final_norm"):
        tck.load_params(str(tmp_path / "p"), template=bf)
    w8 = random_serving_params(config, mode="w8a8", group_size=64, seed=0, device="cpu")
    with pytest.raises(ValueError):
        tck.load_params(str(tmp_path / "p"), template=w8)


def _random_document(rng):
    """A random mapping of the subset: awkward strings (indicators, quotes,
    breaks, unicode, long lines with spaces), numbers, bools, nulls,
    nested mappings and lists."""
    alphabet = list("abcxyz019 ") * 4 + list(":#-?'\"[]{},&*!|>%@`~.\\/\t\n_=<+eE") + \
        ["é", " ", "\x85", "\xa0", "\x00", "中", "\U0001F600"]
    words = ["true", "no", "null", "~", "1.0", "1e-05", "0x1F", "07", "1_000", "2001-12-14",
             "<<", "=", ".inf", ".nan", "1:20", "---", "...", "", " ", "- a", ": b", "a #b"]

    def text(n):
        r = rng.random()
        if r < 0.2:
            return rng.choice(words)
        if r < 0.35:
            return " ".join("w" * rng.randint(1, 12) for _ in range(rng.randint(1, 30)))
        return "".join(rng.choice(alphabet) for _ in range(rng.randint(0, n)))

    def key():
        while True:
            k = "".join(rng.choice("abc/._0123?-") for _ in range(rng.randint(1, 40)))
            if k[0] not in "?-" or len(k) > 1 and k[1] not in " ":
                return k

    def node(depth):
        r = rng.random()
        if depth > 3 or r < 0.5:
            r = rng.random()
            if r < 0.5:
                return text(120)
            if r < 0.6:
                return rng.randint(-10 ** 12, 10 ** 12)
            if r < 0.75:
                return rng.choice([1e-05, 1e17, 0.1, -0.0, float("inf"), rng.random() * 1e-9])
            return rng.choice([True, False, None])
        if r < 0.75:
            return {key(): node(depth + 1) for _ in range(rng.randint(0, 4))}
        return [node(depth + 1) for _ in range(rng.randint(0, 4))]

    return {key(): node(0) for _ in range(rng.randint(1, 6))}


@pytest.mark.parametrize("seed", range(4))
def test_block_yaml_random_documents(seed):
    import random

    rng = random.Random(seed)
    for _ in range(150):
        data = _random_document(rng)
        text = yaml.safe_dump(data)
        assert block_yaml.safe_dump(data) == text
        assert block_yaml.safe_load(text) == yaml.safe_load(text) or \
            yaml.safe_dump(block_yaml.safe_load(text)) == text  # equal but for NaN
