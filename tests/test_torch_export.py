"""Export (`fastforward_tpu_torch/export/`) against the JAX package's
(`fastforward_tpu/export/`), on the CPU: the counterparts of
`tests/export/test_export.py`'s checks.

The same MLP in both packages (the NNX one's weights carried into the torch
one), converted, configured (8-bit symmetric weights per output channel:
JAX's ``PerChannel(1)`` on the (in, out) kernel, the port's
``PerChannel(0)`` on the (out, in) weight; 8-bit asymmetric outputs) and
calibrated by running min-max on the same batches.

Tolerances: each schema's encodings JSON equal to JAX's, key for key, every
string, integer and flag equal, every float of a weight's entry within
`SCALE_RTOL` (eager JAX divides by 2^b - 1 where the port multiplies by the
f32 reciprocal, `tests/test_torch_range_setting.py`) and of an output's
within `ACT_RTOL` (its calibration saw products summed in other orders:
4.4e-6 measured); the hand-built encodings (the same
numpy scales in both) bit-equal; the LPBQ fields bit-equal to JAX's and the
reconstruction within half a compressed step; the reloaded ``.pt2`` bit-equal
to the export-mode forward. The layout changes one field: a per-channel
weight's ``data_shape`` is (out, in) in the port and (in, out) in JAX (its
scale runs over the output channels in both), held in
`test_data_shape_is_torch_layout`.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from fastforward_tpu import flags as jflags
from fastforward_tpu import nn as jnn
from fastforward_tpu import range_setting as jrs
from fastforward_tpu.export import encodings as jenc
from fastforward_tpu.export import pipeline as jpipe
from fastforward_tpu.export import stablehlo as jexport
from fastforward_tpu.quant_init import QuantizationConfig as JConfig
from fastforward_tpu.quantization import quantizer_annotations as jannot
from fastforward_tpu.quantization import granularity as jgran
from fastforward_tpu_torch import QuantizationConfig as TConfig
from fastforward_tpu_torch import flags as tflags
from fastforward_tpu_torch import nn as tnn
from fastforward_tpu_torch import range_setting as trs
from fastforward_tpu_torch.exceptions import ExportError, QuantizationError
from fastforward_tpu_torch.export import encodings as tenc
from fastforward_tpu_torch.export import pipeline as tpipe
from fastforward_tpu_torch.export import torch_export as texport
from fastforward_tpu_torch.nn import convert
from fastforward_tpu_torch.quantization import quantizer_annotations as tannot
from fastforward_tpu_torch.quantization import granularity as tgran

SCALE_RTOL = 2.0 ** -22
ACT_RTOL = 2e-5


def _dq(h):
    return h.dequantize() if hasattr(h, "dequantize") else h


class JMLP(nnx.Module):
    def __init__(self, *, rngs):
        self.fc1, self.fc2 = nnx.Linear(8, 16, rngs=rngs), nnx.Linear(16, 4, rngs=rngs)

    def __call__(self, x):
        return _dq(self.fc2(_dq(self.fc1(x))))


class TMLP(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1, self.fc2 = torch.nn.Linear(8, 16), torch.nn.Linear(16, 4)

    def forward(self, x):
        return _dq(self.fc2(_dq(self.fc1(x))))


def _x(seed=0):
    return np.random.RandomState(seed).randn(2, 8).astype(np.float32)


def _rules(pkg, cfg, wgran):
    cfg.add_rule("**/[quantizer:parameter/weight]", pkg.LinearQuantizer, num_bits=8,
                 symmetric=True, granularity=wgran)
    cfg.add_rule("**/[quantizer:activation/output]", pkg.LinearQuantizer, num_bits=8,
                 symmetric=False)
    return cfg


def _models(calibrate=True):
    j, t = JMLP(rngs=nnx.Rngs(0)), TMLP()
    convert.load_nnx_params(t, {"/".join(str(p) for p in path): np.asarray(v[...])
                                for path, v in nnx.to_flat_state(nnx.state(j, nnx.Param))})
    jnn.quantize_model(j)
    tnn.quantize_model(t)
    if not calibrate:
        return j, t
    _rules(jnn, JConfig(), jgran.PerChannel(1)).initialize(j)
    _rules(tnn, TConfig(), tgran.PerChannel(0)).initialize(t)
    with jflags.strict_quantization(False):
        with jrs.estimate_ranges(j, jrs.running_minmax):
            for s in range(2):
                j(jnp.asarray(_x(s)))
    with tflags.strict_quantization(False), torch.no_grad():
        with trs.estimate_ranges(t, trs.running_minmax):
            for s in range(2):
                t(torch.from_numpy(_x(s)))
    return j, t


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """Both calibrated models exported with each schema."""
    j, t = _models()
    out = {"models": (j, t)}
    for schema in ("legacy", "v1", "v2"):
        # annotation's last operator is module state on both sides (a
        # quantizer that runs before any operator takes it): reset it
        jannot._LAST_OP.set(None)
        tannot._LAST_OP.set(None)
        d = tmp_path_factory.mktemp(schema)
        with jflags.strict_quantization(False):
            jp = jexport.export(j, (jnp.asarray(_x()),), str(d / "jax"), name="mlp", schema=schema)
        tp = texport.export(t, (torch.from_numpy(_x()),), str(d / "torch"), name="mlp",
                            schema=schema)
        out[schema] = (json.load(open(jp["encodings"])), json.load(open(tp["encodings"])), tp)
    return out


def _same_json(got, want, path="", names=("",)):
    assert type(got) is type(want) or {type(got), type(want)} <= {int, float}, path
    if isinstance(want, dict):
        assert set(got) == set(want), path
        names = names + (str(want.get("name", "")),)
        for k in want:
            _same_json(got[k], want[k], f"{path}/{k}", names)
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same_json(g, w, f"{path}[{i}]", names)
    elif isinstance(want, float):
        act = "output_quantizer" in path + "".join(names)
        assert got == pytest.approx(want, rel=ACT_RTOL if act else SCALE_RTOL, abs=0), path
    else:
        assert got == want, path


@pytest.mark.parametrize("schema", ["legacy", "v1", "v2"])
def test_encodings_json_matches_jax(exported, schema):
    jdoc, tdoc, _ = exported[schema]
    # THEN the documents agree entry for entry (names, bit widths, symmetry,
    # encoding kinds, scales and offsets over the output channels, operators)
    _same_json(tdoc, jdoc)
    names = [e["name"] for e in tdoc["encodings"]] if schema != "legacy" else list(
        tdoc["param_encodings"]) + list(tdoc["activation_encodings"])
    assert "fc1/weight_quantizer" in names and "fc2/output_quantizer" in names


def test_saved_program_reloads_and_runs_the_export_mode_forward(exported):
    _, t = exported["models"]
    _, _, paths = exported["v1"]
    program = torch.export.load(paths["program"])
    # THEN the graph holds no call of the port: plain aten ops (a QDQ: round)
    code = open(paths["graph"]).read()
    assert "torch.ops.aten.round" in code and "fastforward" not in code
    # AND the reloaded program computes the export-mode forward bit for bit
    x = torch.from_numpy(_x(5))
    with torch.no_grad(), tflags.export_mode(True), tflags.strict_quantization(False):
        want = t(x)
    assert torch.equal(program.module()(x), want)


def test_producing_operator_annotations(exported):
    _, tdoc, _ = exported["v1"]
    by_name = {e["name"]: e for e in tdoc["encodings"]}
    assert by_name["fc1/output_quantizer"]["op"] == "linear"


def test_data_shape_is_torch_layout():
    # GIVEN the same per-channel weight quantizer encoded from either layout
    scale = np.arange(1, 17, dtype=np.float32) / 100
    jenc_ = jenc.QuantizerEncoding("fc1/weight_quantizer", 8, scale, None, jgran.PerChannel(1),
                                   True, data_shape=(8, 16))
    tenc_ = tenc.QuantizerEncoding("fc1/weight_quantizer", 8, scale, None, tgran.PerChannel(0),
                                   True, data_shape=(16, 8))
    # THEN every schema gives the same entry (the scale over the output
    # channels), but for the data shape the entry carries
    for schema in ("legacy", "v1", "v2"):
        _same_json(tenc.SCHEMA_HANDLERS[schema]().encode([tenc_]),
                   jenc.SCHEMA_HANDLERS[schema]().encode([jenc_]))
    assert tenc_.data_shape == jenc_.data_shape[::-1]


def _per_block(pkg_enc, pkg_gran, scale, data_shape, bits=4):
    return pkg_enc.QuantizerEncoding(
        name="w", num_bits=bits, scale=scale, offset=None,
        granularity=pkg_gran.PerBlock(block_dims=0, block_sizes=16, per_channel_dims=1),
        symmetric=True, data_shape=data_shape)


def test_v2_per_block_and_lpbq_match_jax():
    rng = np.random.RandomState(0)
    scales = rng.uniform(0.01, 0.5, size=(8, 4))
    t = _per_block(tenc, tgran, scales.reshape(-1), (128, 4))
    j = _per_block(jenc, jgran, scales.reshape(-1), (128, 4))
    # THEN the per-block v2 entries (block size, scales) are JAX's
    _same_json(tenc.V2SchemaHandler().encode([t]), jenc.V2SchemaHandler().encode([j]))
    assert tenc.V2SchemaHandler().encode([t])["encodings"][0]["block_size"] == [16, 1]
    # AND the LPBQ fields are JAX's, within the compressed grid
    lp_t, lp_j = tenc.LPBQProcessor(4, 8), jenc.LPBQProcessor(4, 8)
    entry = lp_t.process(t)
    assert entry == lp_j.process(j)
    assert max(entry["per_block_int_scale"]) <= 15 and min(entry["per_block_int_scale"]) >= 1
    _same_json(tenc.V2SchemaHandler(lp_t).encode([t]), jenc.V2SchemaHandler(lp_j).encode([j]))
    # AND the round trip is within half a compressed step of every scale
    rebuilt = lp_t.reconstruct(entry, (8, 4), ch_axes=(1,))
    np.testing.assert_array_equal(rebuilt, lp_j.reconstruct(entry, (8, 4), ch_axes=(1,)))
    per_ch = np.asarray(entry["per_channel_float_scale"])
    assert (np.abs(rebuilt - scales) <= per_ch[None, :] / 2 + 1e-7).all()
    with pytest.raises(ValueError, match="PerBlock"):
        lp_t.process(tenc.QuantizerEncoding("w", 8, scales, None, tgran.PerTensor(), True))


def test_legacy_and_v1_hand_built_entries_match_jax():
    for kw in (dict(name="layer.weight", num_bits=8, scale=np.array([0.1, 0.2]), offset=None,
                    symmetric=True),
               dict(name="m/w", num_bits=8, scale=np.asarray([0.1, 0.2]),
                    offset=np.asarray([3.0, -2.0]), symmetric=False, data_shape=(4, 2)),
               dict(name="m/weight", num_bits=4, scale=np.asarray([0.25]),
                    offset=np.asarray([1.0]), symmetric=False, data_shape=(8,))):
        gt = tgran.PerChannel(0) if kw["scale"].size > 1 else tgran.PerTensor()
        gj = jgran.PerChannel(0) if kw["scale"].size > 1 else jgran.PerTensor()
        for schema in ("legacy", "v1", "v2"):
            got = tenc.SCHEMA_HANDLERS[schema]().encode([tenc.QuantizerEncoding(granularity=gt, **kw)])
            want = jenc.SCHEMA_HANDLERS[schema]().encode([jenc.QuantizerEncoding(granularity=gj, **kw)])
            assert got == want
    entry = tenc.LegacySchemaHandler().encode([tenc.QuantizerEncoding(
        "m/weight", 4, np.asarray([0.25]), np.asarray([1.0]), tgran.PerTensor(), False)])
    entry = entry["param_encodings"]["m/weight"][0]
    np.testing.assert_allclose(entry["max"] - entry["min"], 0.25 * 15, rtol=1e-6)


def test_pipeline_dag_order_cycles_and_errors():
    log = []

    def stage(tag):
        return lambda ctx: log.append(tag)

    for pkg, err in ((tpipe, ExportError), (jpipe, None)):
        p = pkg.Pipeline("t")
        p.add_stage("a", stage("a")).add_stage("b", stage("b"), after=("a",))
        p.add_stage("c", stage("c"), after=("b",))
        p.insert_stage_before("b", stage("x"), "x")
        p.insert_stage_after("b", stage("y"), "y")
        ctx = pkg.ExportContext(model=None, sample_args=(), output_dir="", name="t")
        log.clear()
        p.run(ctx)
        assert log == ["a", "x", "b", "y", "c"]
        p.replace_stage("x", stage("x2"))
        p.insert_stage_before("c", stage("side"), "side", depends_on=("a",))
        p.remove_dependency("c", "y")
        p.add_dependency("c", "y")
        order = p.stage_order()
        assert order.index("side") > order.index("a") and order.index("c") > order.index("y")
    p = tpipe.Pipeline("t")
    p.add_stage("a", stage("a"))
    with pytest.raises(ExportError, match="duplicate"):
        p.add_stage("a", stage("a"))
    with pytest.raises(ExportError, match="unknown stage"):
        p.add_stage("b", stage("b"), after=("zzz",))
    p.add_stage("b", stage("b"), after=("a",))
    with pytest.raises(ExportError, match="cycle"):
        p.add_dependency("a", "b")
    with pytest.raises(ExportError, match="no dependency"):
        p.remove_dependency("a", "b")

    def boom(ctx):
        raise ValueError("inner detail")

    q = tpipe.Pipeline("mypipe").add_stage("explode", boom)
    with pytest.raises(ExportError, match="explode.*mypipe.*inner detail"):
        q.run(tpipe.ExportContext(model=None, sample_args=(), output_dir=".", name="x"))
    with pytest.raises(ExportError, match="gpu"):
        tpipe.build_default_registry().resolve("tpu", "stablehlo")


def test_export_pipeline_validates(tmp_path):
    _, t = _models()
    ctx = tpipe.run_export_pipeline(t, (torch.from_numpy(_x()),), str(tmp_path), name="m")
    assert ctx.artifacts["validated"] is True
    assert set(ctx.artifacts) >= {"program", "graph", "encodings", "golden_output"}


def test_uncalibrated_model_fails_cleanly(tmp_path):
    # GIVEN stubs only: an artifact with no encodings, as JAX's
    j, t = _models(calibrate=False)
    with jflags.strict_quantization(False):
        jp = jexport.export(j, (jnp.asarray(_x()),), str(tmp_path / "jax"), name="raw")
    tp = texport.export(t, (torch.from_numpy(_x()),), str(tmp_path / "torch"), name="raw")
    assert json.load(open(tp["encodings"])) == json.load(open(jp["encodings"]))
    assert json.load(open(tp["encodings"]))["encodings"] == []
    # AND configured quantizers without ranges: QuantizationError, no artifact
    _rules(tnn, TConfig(), tgran.PerChannel(0)).initialize(t)
    with pytest.raises(QuantizationError, match="range"):
        texport.export(t, (torch.from_numpy(_x()),), str(tmp_path / "bad"), name="bad")
    assert not (tmp_path / "bad" / "bad.pt2").exists()


def test_export_modules_captures_real_inputs(tmp_path):
    _, t = _models()
    out = texport.export_modules(t, (torch.from_numpy(_x()),), "**/[cls:QuantizedLinear]",
                                 str(tmp_path), context={"QuantizedLinear": tnn.QuantizedLinear})
    assert set(out) == {"fc1", "fc2"}
    # fc2 was exported on fc1's output: a (2, 16) input
    program = torch.export.load(out["fc2"]["program"])
    assert tuple(program.example_inputs[0][0].shape) == (2, 16)
