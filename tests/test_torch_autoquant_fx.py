"""The fx-graph autoquant pass (`fastforward_tpu_torch/autoquant_fx.py`)
against the JAX package's jaxpr pass (`fastforward_tpu/autoquant_jaxpr.py`),
on the CPU: the counterparts of `tests/test_autoquant_jaxpr.py`'s checks.

Each function is written once per package, each side with its own control
flow (``lax.scan`` ↔ ``torch.ops.higher_order.scan``, ``lax.cond`` ↔
``torch.cond``, ``lax.while_loop`` ↔ ``while_loop``), on the same numpy
inputs. A JAX ``dot_general_i`` is the port's i-th product site
(``matmul_i``, ``linear_i``, ``einsum_i``).

Tolerances: the sites (their count, order, shapes and control-flow
contexts) equal JAX's; the observed absmax of every slot within `F32_RTOL`
(bit-equal inputs; outputs summed in other orders); the quantized outputs
within `QDQ_TOL` of the largest output of JAX's (f32 products summed in
other orders; a level moved by one would exceed it, and none does with
these seeds); the float outputs of observe
within `F32_RTOL`; the GPT-2 bridge (module path against plan path, one
package) within `BRIDGE_TOL` of the largest logit (the module path runs the
dense fallback on dequantized tensors, the plan the same aten.linear on
quantize-dequantized ones: 0.0 measured); the encodings JSON equal to JAX's
but for the site names and the weight's ``data_shape`` (a (K, N) matmul
operand in both here, so equal too).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import nnx
from torch._higher_order_ops.scan import scan as tscan
from torch._higher_order_ops.while_loop import while_loop as twhile
from torch.fx.experimental.proxy_tensor import make_fx

from fastforward_tpu import autoquant_jaxpr as jfx
from fastforward_tpu import range_setting as jrs
from fastforward_tpu.quantization import granularity as jgran
from fastforward_tpu_torch import autoquant_fx as tfx
from fastforward_tpu_torch import range_setting as trs
from fastforward_tpu_torch.exceptions import QuantizationError
from fastforward_tpu_torch.quantization import granularity as tgran

F32_RTOL = 1e-6
QDQ_TOL = 1e-6
BRIDGE_TOL = 1e-5


def _rand(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _same_sites(tplan, jplan):
    assert len(tplan.sites) == len(jplan.sites)
    for t, j in zip(tplan.sites, jplan.sites):
        assert t.in_shapes == j.in_shapes and t.out_shapes == j.out_shapes
        assert t.context == j.context


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _same_absmax(tplan, jplan):
    for t, j in zip(tplan.sites, jplan.sites):
        assert set(t.absmax) == set(j.absmax)
        for k, v in j.absmax.items():
            assert t.absmax[k] == pytest.approx(v, rel=F32_RTOL)


# -- operator syntax and pre-bound functions -----------------------------------

from jax.nn import gelu as jgelu  # noqa: E402  (pre-bound, as JAX's test binds it)
from torch.nn.functional import gelu as tgelu  # noqa: E402


def _jmodel(x, w1, w2):
    return jgelu(x @ w1, approximate=False) @ w2


def _tmodel(x, w1, w2):
    return tgelu(x @ w1) @ w2


def _mlp_inputs(seed=1):
    return (_rand(seed, 8, 16), _rand(seed + 1, 16, 32, scale=0.2), _rand(seed + 2, 32, 8, scale=0.2))


def test_operator_syntax_sites_observe_and_quantize_match_jax():
    arrays = _mlp_inputs()
    jplan = jfx.trace_quantization_sites(_jmodel, *_j(*arrays))
    tplan = tfx.trace_quantization_sites(_tmodel, *_t(*arrays))
    # THEN both `@` are product sites, in JAX's order and shapes
    assert [s.name for s in tplan.sites] == ["matmul_0", "matmul_1"]
    _same_sites(tplan, jplan)
    # AND observe runs the function and folds the same ranges
    ref_j, ref_t = jplan.observe(*_j(*arrays)), tplan.observe(*_t(*arrays))
    _close(ref_t, ref_j, F32_RTOL)
    _close(ref_t, _tmodel(*_t(*arrays)), 0)
    _same_absmax(tplan, jplan)
    # AND the INT8 QDQ'd functions agree, and quantization bites
    out_t = tplan.quantized(num_bits=8)(*_t(*arrays))
    out_j = jplan.quantized(num_bits=8)(*_j(*arrays))
    _close(out_t, out_j, QDQ_TOL)
    assert not torch.equal(out_t, ref_t)
    # AND make_fx traces the quantized function again, to the same numbers
    gm = make_fx(tplan.quantized(num_bits=8))(*_t(*arrays))
    assert torch.equal(gm(*_t(*arrays)), out_t)


def test_helper_functions_are_traced_through():
    def inner(a, b):
        return a @ b

    plan = tfx.trace_quantization_sites(lambda x, w: inner(x, w) + 1.0,
                                        torch.ones(2, 8), torch.ones(8, 4))
    assert [s.name for s in plan.sites] == ["matmul_0"]


def test_quantized_without_calibration_raises():
    plan = tfx.trace_quantization_sites(lambda a, b: a @ b, torch.ones(2, 4), torch.ones(4, 4))
    with pytest.raises(QuantizationError, match="observe"):
        plan.quantized()


def test_elementwise_ops_selectable_and_summary():
    x = torch.ones(2, 4)
    plan = tfx.trace_quantization_sites(lambda a, b: a + b, x, x, ops=("add",))
    assert [s.name for s in plan.sites] == ["add_0"]
    assert "uncalibrated" in plan.summary()
    plan.observe(x, x)
    np.testing.assert_allclose(plan.quantized()(x, x).numpy(), 2.0, rtol=1e-2)
    assert "add_0" in plan.summary() and "uncalibrated" not in plan.summary()


# -- control flow --------------------------------------------------------------


def _jscan_model(x, ws):
    def body(h, w):
        return jnp.tanh(h @ w), ()

    return jax.lax.scan(body, x, ws)[0]


def _tscan_model(x, ws):
    return tscan(lambda h, w: (torch.tanh(h @ w), h.sum()), x, ws)[0]


def test_scan_site_folds_every_iteration_like_jax():
    x, ws = _rand(0, 4, 16), _rand(1, 3, 16, 16, scale=0.3)
    jplan = jfx.trace_quantization_sites(_jscan_model, *_j(x, ws))
    tplan = tfx.trace_quantization_sites(_tscan_model, *_t(x, ws))
    # THEN the body's product is one site in a scan context
    assert [s.name for s in tplan.sites] == ["matmul_0"]
    assert tplan.sites[0].context == ("scan",) == jplan.sites[0].context
    # AND its weight range folds every layer's
    ref_t, ref_j = tplan.observe(*_t(x, ws)), jplan.observe(*_j(x, ws))
    _close(ref_t, ref_j, 1e-5)
    assert tplan.sites[0].absmax[1] == pytest.approx(float(np.abs(ws).max()), rel=F32_RTOL)
    _same_absmax(tplan, jplan)
    # AND the quantized functions agree
    out_t = tplan.quantized(num_bits=8)(*_t(x, ws))
    _close(out_t, jplan.quantized(num_bits=8)(*_j(x, ws)), QDQ_TOL)
    assert not torch.equal(out_t, ref_t)


def test_quantized_scan_stays_a_scan_when_traced():
    x, ws = _rand(2, 4, 16), _rand(3, 3, 16, 16, scale=0.3)
    tplan = tfx.trace_quantization_sites(_tscan_model, *_t(x, ws))
    tplan.observe(*_t(x, ws))
    qfn = tplan.quantized(num_bits=8)
    gm = make_fx(qfn, pre_dispatch=True)(*_t(x, ws))
    # THEN the traced quantized function holds a scan (not unrolled), with
    # the QDQ in its body, and computes what the eager one does
    targets = [n.target for n in gm.graph.nodes if n.op == "call_function"]
    assert targets.count(torch.ops.higher_order.scan) == 1
    assert "round" in gm.scan_combine_graph_0.code
    assert torch.equal(gm(*_t(x, ws)), qfn(*_t(x, ws)))


def test_cond_branches_are_sites_like_jax():
    x, w1, w2 = np.ones((2, 8), np.float32), np.full((8, 4), 0.5, np.float32), \
        np.full((8, 4), 0.25, np.float32)

    def jfn(pred, x, w1, w2):
        return jax.lax.cond(pred, lambda a: a @ w1, lambda a: a @ w2, x)

    def tfn(pred, x, w1, w2):
        return torch.cond(pred, lambda a: a @ w1, lambda a: a @ w2, (x,))

    jplan = jfx.trace_quantization_sites(jfn, True, *_j(x, w1, w2))
    tplan = tfx.trace_quantization_sites(tfn, torch.tensor(True), *_t(x, w1, w2))
    assert len(tplan.sites) == 2 and all(s.context == ("cond",) for s in tplan.sites)
    _same_sites(tplan, jplan)
    for pred in (True, False):
        _close(tplan.observe(torch.tensor(pred), *_t(x, w1, w2)),
               jplan.observe(pred, *_j(x, w1, w2)), 0)
    _same_absmax(tplan, jplan)
    qfn = tplan.quantized()
    np.testing.assert_allclose(qfn(torch.tensor(True), *_t(x, w1, w2)).numpy(), 4.0, rtol=0.05)
    np.testing.assert_allclose(qfn(torch.tensor(False), *_t(x, w1, w2)).numpy(), 2.0, rtol=0.05)
    gm = make_fx(qfn, pre_dispatch=True)(torch.tensor(False), *_t(x, w1, w2))
    assert any(n.target is torch.ops.higher_order.cond for n in gm.graph.nodes)
    np.testing.assert_allclose(gm(torch.tensor(True), *_t(x, w1, w2)).numpy(), 4.0, rtol=0.05)


def test_while_body_site_like_jax():
    x, w = _rand(2, 2, 8), _rand(3, 8, 8, scale=0.3)

    def jfn(x, w):
        return jax.lax.while_loop(lambda s: s[0] < 3, lambda s: (s[0] + 1, jnp.tanh(s[1] @ w)),
                                  (0, x))[1]

    def tfn(x, w):
        return twhile(lambda i, h: i < 3, lambda i, h: (i + 1, torch.tanh(h @ w)),
                      (torch.tensor(0), x))[1]

    jplan = jfx.trace_quantization_sites(jfn, *_j(x, w))
    tplan = tfx.trace_quantization_sites(tfn, *_t(x, w))
    assert [s.name for s in tplan.sites] == ["matmul_0"]
    assert tplan.sites[0].context == ("while",) == jplan.sites[0].context
    _close(tplan.observe(*_t(x, w)), jplan.observe(*_j(x, w)), 1e-5)
    _same_absmax(tplan, jplan)
    out = tplan.quantized()(*_t(x, w))
    _close(out, jplan.quantized()(*_j(x, w)), QDQ_TOL)
    gm = make_fx(tplan.quantized(), pre_dispatch=True)(*_t(x, w))
    assert torch.equal(gm(*_t(x, w)), out)


def test_nested_scan_in_cond_addressing_like_jax():
    x, w0, ws, w1 = _rand(3, 2, 8), _rand(4, 8, 8, scale=0.3), _rand(5, 2, 8, 8, scale=0.3), \
        _rand(6, 8, 4, scale=0.3)

    def jfn(pred, x, w0, ws, w1):
        def scanned(a):
            return jax.lax.scan(lambda c, w: (c @ w, ()), a, ws)[0]

        return jax.lax.cond(pred, scanned, lambda a: a, x @ w0) @ w1

    def tfn(pred, x, w0, ws, w1):
        def scanned(a):
            return tscan(lambda c, w: (c @ w, c.sum()), a, ws)[0]

        return torch.cond(pred, scanned, lambda a: a.clone(), (x @ w0,)) @ w1

    jplan = jfx.trace_quantization_sites(jfn, True, *_j(x, w0, ws, w1))
    tplan = tfx.trace_quantization_sites(tfn, torch.tensor(True), *_t(x, w0, ws, w1))
    assert [s.context for s in tplan.sites] == [s.context for s in jplan.sites] == [
        (), ("cond", "scan"), ()]
    for pred in (True, False):
        _close(tplan.observe(torch.tensor(pred), *_t(x, w0, ws, w1)),
               jplan.observe(pred, *_j(x, w0, ws, w1)), 1e-5)
    _same_absmax(tplan, jplan)
    for pred in (True, False):
        _close(tplan.quantized()(torch.tensor(pred), *_t(x, w0, ws, w1)),
               jplan.quantized()(pred, *_j(x, w0, ws, w1)), QDQ_TOL)


# -- the quantizer stack -------------------------------------------------------


def test_install_quantizers_per_channel_weight_like_jax():
    x = _rand(0, 16, 32)
    w = (np.random.RandomState(1).randn(32, 8) * np.geomspace(0.01, 1.0, 8)[None, :]).astype(
        np.float32)
    plans = []
    for pkg, gran, rs, arrays in ((jfx, jgran, jrs, _j(x, w)), (tfx, tgran, trs, _t(x, w))):
        plan = pkg.trace_quantization_sites(lambda a, b: a @ b, *arrays)
        plan.install_quantizers(
            rules=[(plan.sites[0].name, 0, dict(num_bits=8)),
                   (plan.sites[0].name, 1, dict(num_bits=8, granularity=gran.PerChannel(1)))],
            estimator=rs.running_minmax)
        plan.observe(*arrays)
        plans.append(plan)
    jplan, tplan = plans
    q1 = tplan.sites[0].quantizers[1]
    # THEN one scale per column, JAX's
    assert q1.scale.numel() == 8
    np.testing.assert_allclose(q1.scale.detach().numpy(),
                               np.asarray(jplan.sites[0].quantizers[1].scale[...]), rtol=2e-7)
    # AND the weight-only QDQ'd products agree
    out_t = tplan.quantized(quantize_outputs=False)(*_t(x, w))
    _close(out_t, jplan.quantized(quantize_outputs=False)(*_j(x, w)), QDQ_TOL)
    # AND per-channel beats per-tensor on the smallest column
    pt = tfx.trace_quantization_sites(lambda a, b: a @ b, *_t(x, w))
    pt.observe(*_t(x, w))
    ref = (torch.from_numpy(x) @ torch.from_numpy(w)).numpy()

    def col_sqnr(a):
        return 10 * np.log10((ref ** 2).mean(0) / np.maximum(((a - ref) ** 2).mean(0), 1e-20))

    worst_pt = col_sqnr(pt.quantized(quantize_outputs=False)(*_t(x, w)).numpy()).min()
    assert col_sqnr(out_t.numpy()).min() > worst_pt + 6


def test_install_quantizers_in_scan_folds_ranges():
    x = _rand(1, 4, 16)
    ws = np.stack([_rand(2, 16, 16, scale=0.01), _rand(3, 16, 16)])
    plan = tfx.trace_quantization_sites(_tscan_model, *_t(x, ws))
    plan.install_quantizers(default=dict(num_bits=8))
    plan.observe(*_t(x, ws))
    lo, hi = plan.sites[0].quantizers[1].quantization_range
    assert float(hi.max()) >= float(ws.max()) * 0.999
    assert float(lo.min()) <= float(ws.min()) * 0.999
    assert torch.isfinite(plan.quantized()(*_t(x, ws))).all()


def test_encodings_json_matches_jax(tmp_path):
    x, w = _rand(2, 8, 16), _rand(3, 16, 4)
    docs = []
    for pkg, gran, arrays in ((jfx, jgran, _j(x, w)), (tfx, tgran, _t(x, w))):
        plan = pkg.trace_quantization_sites(lambda a, b: a @ b, *arrays)
        plan.install_quantizers(
            rules=[(plan.sites[0].name, 1, dict(num_bits=4, granularity=gran.PerChannel(1)))],
            default=dict(num_bits=8))
        plan.observe(*arrays)
        encs = plan.encodings()
        assert {e.name.split(".")[1] for e in encs} == {"in0", "in1", "out0"}
        path = plan.export_encodings(str(tmp_path / f"{pkg.__name__}.json"), schema="v1")
        docs.append(json.load(open(path)))
    jdoc, tdoc = docs
    # THEN the documents agree but for the site names and the op name
    assert tdoc["version"] == jdoc["version"]
    for te, je in zip(tdoc["encodings"], jdoc["encodings"]):
        assert te["name"].replace("matmul", "dot_general") == je["name"]
        assert (te["op"], je["op"]) == ("matmul", "dot_general")
        for k in ("enc_type", "dtype", "bw", "is_sym"):
            assert te[k] == je[k]
        np.testing.assert_allclose(te["scale"], je["scale"], rtol=2e-7)
        np.testing.assert_allclose(te["offset"], je["offset"], atol=0)
    assert any(e["enc_type"] == "PER_CHANNEL" and e["bw"] == 4 for e in tdoc["encodings"])


# -- the site <-> module-path bridge -------------------------------------------


class _Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1, self.fc2 = torch.nn.Linear(8, 16), torch.nn.Linear(16, 8)

    def forward(self, x):
        return self.fc2(F.relu(self.fc1(x)))


def test_scoped_forward_records_module_paths():
    m = _Tiny()
    with tfx.scoped_forward(m):
        plan = tfx.trace_quantization_sites(lambda x: m(x), torch.ones(4, 8))
    assert plan.site_module_paths() == {"linear_0": "fc1", "linear_1": "fc2"}
    # the patch is gone on exit
    plan2 = tfx.trace_quantization_sites(lambda x: m(x), torch.ones(4, 8))
    assert plan2.sites[0].module_path == ""
    assert [p for p, _ in tfx.named_torch_modules(m)] == ["", "fc1", "fc2"]


def test_apply_to_module_pushes_calibration():
    from fastforward_tpu_torch import flags
    from fastforward_tpu_torch import nn as tnn

    m = torch.nn.Sequential()
    m.fc = torch.nn.Linear(8, 8)
    x = torch.from_numpy(_rand(1, 4, 8))
    with tfx.scoped_forward(m):
        plan = tfx.trace_quantization_sites(lambda x: m(x), x)
    plan.install_quantizers(rules=[("linear_0", 0, dict(num_bits=8, symmetric=False))])
    plan.observe(x)
    tnn.quantize_model(m)
    assert plan.apply_to_module(m) == 1
    q = m.fc.input_quantizer
    assert isinstance(q, tnn.LinearQuantizer) and q.scale is not None
    with flags.strict_quantization(False), torch.no_grad():
        out = m(x)
    out = out.dequantize() if hasattr(out, "dequantize") else out
    np.testing.assert_allclose(out.numpy(), plan.quantized(only_installed=True)(x).numpy(),
                               atol=2e-5)


def _gpt2_pair():
    from fastforward_tpu.models import gpt2 as jgpt2
    from fastforward_tpu_torch.models import gpt2 as tgpt2
    from fastforward_tpu_torch.nn import convert

    j = jgpt2.GPT2LMHead(jgpt2.GPT2Config.tiny(), rngs=nnx.Rngs(0))
    state = {"/".join(str(p) for p in path): np.asarray(v[...])
             for path, v in nnx.to_flat_state(nnx.state(j, nnx.Param))}
    models = []
    for _ in range(2):
        t = tgpt2.GPT2LMHead(tgpt2.GPT2Config.tiny(), device="cpu")
        convert.load_nnx_params(t, state)
        models.append(t)
    return models


def gpt2_bridge(m_mod, m_plan, calib, eval_ids):
    """The module path and the plan path of one QuantizationConfig (8-bit
    symmetric Linear weights, 8-bit asymmetric Linear inputs), each
    calibrated with running min-max on ``calib``; (module logits, plan
    logits, plan)."""
    from fastforward_tpu_torch import QuantizationConfig, flags
    from fastforward_tpu_torch import nn as tnn
    from fastforward_tpu_torch.autoquant import autoquantize

    cfg = QuantizationConfig()
    cfg.add_rule("**/[cls:Linear]/[quantizer:parameter/weight]", tnn.LinearQuantizer,
                 num_bits=8, symmetric=True)
    cfg.add_rule("**/[cls:Linear]/[quantizer:activation/input]", tnn.LinearQuantizer,
                 num_bits=8, symmetric=False)
    with torch.no_grad():
        autoquantize(m_mod, calib)
        with tfx.scoped_forward(m_plan):
            plan = tfx.trace_quantization_sites(lambda ids: m_plan(ids), calib)
    plan.install_from_config(cfg, m_mod, estimator=trs.running_minmax)
    cfg.initialize(m_mod)
    with flags.strict_quantization(False), torch.no_grad():
        with trs.estimate_ranges(m_mod, trs.running_minmax, disable_quantization=True):
            m_mod(calib)
        out_mod = m_mod(eval_ids)
    plan.observe(calib)
    return out_mod, plan.quantized(only_installed=True)(eval_ids), plan


def test_gpt2_bridge_module_path_equals_plan_path():
    m_mod, m_plan = _gpt2_pair()
    rs = np.random.RandomState(0)
    calib, eval_ids = (torch.from_numpy(rs.randint(0, 256, (2, 16))) for _ in range(2))
    out_mod, out_plan, plan = gpt2_bridge(m_mod, m_plan, calib, eval_ids)
    _close(out_plan, out_mod, BRIDGE_TOL)
    # the bridge installed quantizers on the Linears' input and weight slots only
    L = m_mod.config.num_layers
    with_q = [s for s in plan.sites if s.quantizers]
    assert len(with_q) == 4 * L and all(s.prim == "linear" for s in with_q)
    assert all(set(s.quantizers) == {0, 1} for s in with_q)


def test_port_stacked_forward_sites():
    # GIVEN the port's sim_w8 stacked forward at tiny size: a Python loop
    # over layers (JAX's is a lax.scan), so make_fx unrolls it
    from fastforward_tpu_torch.models.llama import LlamaConfig
    from fastforward_tpu_torch.serving.stacked import (
        StackedKVCache,
        random_stacked_params,
        serving_forward_stacked,
    )

    config = LlamaConfig.tiny()
    params, stacked = random_stacked_params(config, mode="sim_w8", seed=0, device="cpu")
    cache = StackedKVCache.create(config.num_layers, 1, 32, config.num_kv_heads,
                                  config.head_dim, quantized=False, device="cpu")
    ids = torch.ones((1, 8), dtype=torch.int32)

    def fwd(params, stacked, ids, cache):
        return serving_forward_stacked(params, stacked, config, ids, cache=cache)[0]

    plan = tfx.trace_quantization_sites(fwd, params, stacked, ids, cache)
    # THEN 9 sites a layer (q/k/v, the two attention products, o/gate/up/
    # down), each its own (no scan context), plus the lm_head
    L = config.num_layers
    assert len(plan.sites) == 9 * L + 1
    assert all(s.context == () for s in plan.sites)
    assert [s.prim for s in plan.sites].count("einsum") == 2 * L
    # AND calibration and application run end to end
    ref = plan.observe(params, stacked, ids, cache)
    out = plan.quantized(num_bits=8)(params, stacked, ids, cache)
    assert out.shape == ref.shape and torch.isfinite(out).all()
