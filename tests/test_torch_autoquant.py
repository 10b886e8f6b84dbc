"""Autoquant (`fastforward_tpu_torch/autoquant.py`) against the JAX
package's (`fastforward_tpu/autoquant.py`), on the CPU: the counterparts of
`tests/test_autoquant.py`'s checks.

Each model is written once per package with the same calls (``jax.nn.relu``
↔ ``torch.relu``, ``jax.nn.softmax(axis=)`` ↔ ``F.softmax(dim=)``, ...), the
NNX one's parameters carried into the torch one by
`nn.convert.load_nnx_params`.

Tolerances: the site sets (names and order) equal JAX's; the quantized
outputs, JAX's calibrated site and layer quantizers carried over, within
`QUANT_TOL` of the largest output (a level moved by an f32 product summed
in another order would exceed it; 0.0 measured); the outputs of an
autoquantized model with stub slots within `FLOAT_TOL` of the float model's
and `JAX_TOL` of the largest of JAX's (2.9e-6 measured: the erf GELU and
the softmaxes round differently); the rest is structure (rules,
predicates, errors, the mode stack).
"""

import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import nnx

import fastforward_tpu as jff
from fastforward_tpu import autoquant as jaq
from fastforward_tpu import flags as jflags
from fastforward_tpu import nn as jnn
from fastforward_tpu import range_setting as jrs
from fastforward_tpu.quant_init import QuantizationConfig as JConfig
from fastforward_tpu_torch import QuantizationConfig as TConfig
from fastforward_tpu_torch import autoquant as taq
from fastforward_tpu_torch import flags as tflags
from fastforward_tpu_torch import nn as tnn
from fastforward_tpu_torch import range_setting as trs
from fastforward_tpu_torch.nn import convert
from fastforward_tpu_torch.quantization import PerTensor, QuantizedTensor

FLOAT_TOL = 1e-6
QUANT_TOL = 1e-6
JAX_TOL = 1e-5


def _flat(model) -> dict:
    return {"/".join(str(p) for p in path): np.asarray(v[...])
            for path, v in nnx.to_flat_state(nnx.state(model, nnx.Param))}


def _dq(h):
    return h.dequantize() if hasattr(h, "dequantize") else h


class JMLP(nnx.Module):
    def __init__(self, *, rngs):
        self.fc1, self.fc2 = nnx.Linear(8, 16, rngs=rngs), nnx.Linear(16, 4, rngs=rngs)

    def __call__(self, x):
        h = jax.nn.relu(_dq(self.fc1(x)))
        return jax.nn.softmax(_dq(self.fc2(h)), axis=-1)


class TMLP(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1, self.fc2 = torch.nn.Linear(8, 16), torch.nn.Linear(16, 4)

    def forward(self, x):
        h = torch.relu(_dq(self.fc1(x)))
        return F.softmax(_dq(self.fc2(h)), dim=-1)


class JMix(nnx.Module):
    """Every substitutable op once, some twice, and plain glue between."""

    def __init__(self, *, rngs):
        self.fc = nnx.Linear(8, 8, rngs=rngs)
        self.w = jnp.asarray(np.random.RandomState(1).randn(8, 4).astype(np.float32))

    def __call__(self, x):
        h = _dq(self.fc(x))
        h = jnp.tanh(jax.nn.gelu(h, approximate=False)) + jax.nn.sigmoid(h)
        h = jnp.matmul(h, jnp.eye(8)) * 2.0
        y = jnp.einsum("bi,io->bo", jax.nn.relu(h), self.w)
        return jax.nn.log_softmax(y, axis=-1) + jnp.tanh(y)


class TMix(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(8, 8)
        # a plain tensor attribute (no buffer), as JAX's plain array
        self.w = torch.from_numpy(np.random.RandomState(1).randn(8, 4).astype(np.float32))

    def forward(self, x):
        h = _dq(self.fc(x))
        h = torch.tanh(F.gelu(h)) + torch.sigmoid(h)
        h = torch.matmul(h, torch.eye(8)) * 2.0
        y = torch.einsum("bi,io->bo", torch.relu(h), self.w)
        return F.log_softmax(y, dim=-1) + torch.tanh(y)


MODELS = {"mlp": (lambda: JMLP(rngs=nnx.Rngs(0)), TMLP),
          "mix": (lambda: JMix(rngs=nnx.Rngs(0)), TMix)}


def _pair(name):
    jb, tb = MODELS[name]
    j, t = jb(), tb()
    convert.load_nnx_params(t, _flat(j))
    return j, t


def _x(seed=0):
    return np.random.RandomState(seed).randn(2, 8).astype(np.float32)


def _both(name, **kw):
    j, t = _pair(name)
    with jflags.strict_quantization(False):
        jaq.autoquantize(j, jnp.asarray(_x()), **kw)
    taq.autoquantize(t, torch.from_numpy(_x()), **kw)
    return j, t


def _tout(t, x):
    with tflags.strict_quantization(False), torch.no_grad():
        return _dq(t(torch.from_numpy(x))).numpy()


@pytest.mark.parametrize("name", sorted(MODELS))
def test_site_set_matches_jax(name):
    j, t = _both(name)
    assert list(t.autoquant_quantizers) == list(j.autoquant_quantizers)
    assert isinstance(t.fc1 if name == "mlp" else t.fc, tnn.QuantizedLinear)


def test_mix_sites_and_stub_outputs():
    # GIVEN the mixed model autoquantized (stub slots)
    j, t = _both("mix")
    assert list(t.autoquant_quantizers) == [
        "einsum_0", "gelu_0", "log_softmax_0", "matmul_0", "relu_0", "sigmoid_0", "tanh_0",
        "tanh_1"]
    # THEN the substituted forward gives the float model's outputs
    j0, t0 = _pair("mix")
    with tflags.strict_quantization(False), torch.no_grad():
        want = t0(torch.from_numpy(_x(1))).numpy()
    np.testing.assert_allclose(_tout(t, _x(1)), want, rtol=0, atol=FLOAT_TOL)
    with jflags.strict_quantization(False):
        jout = np.asarray(j(jnp.asarray(_x(1))))
    np.testing.assert_allclose(_tout(t, _x(1)), jout, rtol=0,
                               atol=JAX_TOL * np.abs(jout).max())


@pytest.fixture(scope="module")
def calibrated_mlp():
    """The MLP autoquantized in both packages, 8-bit asymmetric quantizers on
    every site and layer output, calibrated by running min-max (JAX's)."""
    j, t = _both("mlp")
    for pkg, model, cfg in ((jnn, j, JConfig()), (tnn, t, TConfig())):
        cfg.add_rule("autoquant_quantizers/*", pkg.LinearQuantizer, num_bits=8, symmetric=False)
        cfg.add_rule("**/[quantizer:activation/output]", pkg.LinearQuantizer, num_bits=8,
                     symmetric=False)
        cfg.initialize(model)
    xs = [_x(s) for s in range(3)]
    with jflags.strict_quantization(False):
        with jrs.estimate_ranges(j, jrs.running_minmax):
            for x in xs:
                j(jnp.asarray(x))
    with tflags.strict_quantization(False), torch.no_grad():
        with trs.estimate_ranges(t, trs.running_minmax):
            for x in xs:
                t(torch.from_numpy(x))
    return j, t


def test_quantized_outputs_match_jax(calibrated_mlp):
    j, t = calibrated_mlp
    assert isinstance(t.autoquant_quantizers["relu_0"], tnn.LinearQuantizer)
    assert not t.autoquant_quantizers["relu_0"].has_uninitialized_params
    # the site quantizers' ranges agree (the relu output's within one f32 ulp)
    state = _flat(j)
    for site in ("relu_0", "softmax_0"):
        np.testing.assert_allclose(t.autoquant_quantizers[site].scale.detach().numpy(),
                                   state[f"autoquant_quantizers/{site}/scale"], rtol=1e-6)
    # JAX's calibrated state carried over: the quantized outputs agree
    convert.load_nnx_params(t, state)
    x = _x(7)
    with jflags.strict_quantization(False):
        want = np.asarray(_dq(j(jnp.asarray(x))))
    got = _tout(t, x)
    np.testing.assert_allclose(got, want, rtol=0, atol=QUANT_TOL * np.abs(want).max())
    # AND the site quantizers act: the relu output lies on its 8-bit grid
    seen = []
    handle = t.fc2.register_forward_pre_hook(lambda m, a: seen.append(_dq(a[0])))
    _tout(t, x)
    handle.remove()
    q = t.autoquant_quantizers["relu_0"]
    levels = (seen[0] / q.scale.detach()).numpy()
    np.testing.assert_allclose(levels, np.round(levels), atol=1e-3)


def _gelu_net(rule_target, replacement, predicate=None):
    class TGelu(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.fc = torch.nn.Linear(8, 8)

        def forward(self, x):
            return torch.exp(F.gelu(_dq(self.fc(x))))

    t = TGelu()
    taq.autoquantize(t, torch.from_numpy(_x()), replacement_patterns=[
        taq.PatternRule(rule_target, replacement, predicate)])
    return t


def test_pattern_rule_replaces_matched_site():
    calls = []

    def fast_gelu(x, *, output_quantizer=None, **kwargs):
        calls.append(output_quantizer)
        return x * torch.sigmoid(1.702 * x)

    t = _gelu_net("torch.nn.functional.gelu", fast_gelu)
    _tout(t, _x(2))
    assert len(calls) == 1 and calls[0] is t.autoquant_quantizers["gelu_0"]


def test_pattern_rule_predicate_gates_replacement():
    calls = []

    def repl(x, *, output_quantizer=None, **kwargs):
        calls.append(x)
        return x

    t = _gelu_net("torch.nn.functional.gelu", repl, predicate=lambda a, k: False)
    out = _tout(t, _x(2))
    assert calls == [] and out.shape == (2, 8)


def test_pattern_rule_targets_new_function():
    seen = []

    def quant_exp(x, *, output_quantizer=None, **kwargs):
        seen.append(tuple(x.shape))
        return torch.exp(x)

    t = _gelu_net("torch.exp", quant_exp)
    assert "exp_0" in t.autoquant_quantizers
    _tout(t, _x(2))
    assert seen == [(2, 8)]


def test_prebound_import_is_intercepted_on_both_sides():
    # GIVEN model modules that bind gelu at import time
    jsrc = """
from flax import nnx
from jax.nn import gelu

class Prebound(nnx.Module):
    def __init__(self, rngs):
        self.fc = nnx.Linear(8, 8, rngs=rngs)

    def __call__(self, x):
        return gelu(self.fc(x))
"""
    tsrc = """
import torch
from torch.nn.functional import gelu

class Prebound(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(8, 8)

    def forward(self, x):
        h = self.fc(x)
        return gelu(h.dequantize() if hasattr(h, "dequantize") else h)
"""
    mods = {}
    for name, src in (("_aq_prebound_jax", jsrc), ("_aq_prebound_torch", tsrc)):
        mods[name] = types.ModuleType(name)
        sys.modules[name] = mods[name]
        exec(src, mods[name].__dict__)
    try:
        j = mods["_aq_prebound_jax"].Prebound(nnx.Rngs(0))
        t = mods["_aq_prebound_torch"].Prebound()
        with jflags.strict_quantization(False):
            jaq.autoquantize(j, jnp.asarray(_x()))
        taq.autoquantize(t, torch.from_numpy(_x()))
        # THEN both find the pre-bound call
        assert list(t.autoquant_quantizers) == list(j.autoquant_quantizers) == ["gelu_0"]
        # AND the name is the original function after the context
        assert mods["_aq_prebound_torch"].gelu is F.gelu
    finally:
        for name in mods:
            del sys.modules[name]


def test_site_count_mismatch_raises():
    class Branchy(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.fc = torch.nn.Linear(8, 8)
            self.extra = False

        def forward(self, x):
            h = torch.tanh(_dq(self.fc(x)))
            if self.extra:
                h = torch.tanh(h)
            return h

    t = Branchy()
    x = torch.from_numpy(_x())
    taq.autoquantize(t, x)
    with tflags.strict_quantization(False), torch.no_grad():
        t(x)  # the same path: fine
        t.extra = True
        with pytest.raises(taq.AutoquantSiteMismatch, match="tanh: recorded 1, observed 2"):
            t(x)
        t._autoquant_strict_sites = False  # opt out: per-forward assignment
        t(x)


def _quantizer(pkg, granularity):
    q = pkg.LinearQuantizer(num_bits=8, granularity=granularity)
    q.quantization_range = (-4.0, 4.0)
    return q


def test_operator_syntax_on_quantized_tensor_matches_jax():
    # GIVEN a Linear whose output quantizer makes its output quantized, and
    # operator syntax on it: qt + x, and x * qt (a plain tensor on the left)
    class JM(nnx.Module):
        def __init__(self, rngs):
            self.fc = nnx.Linear(8, 8, rngs=rngs)

        def __call__(self, x):
            h = self.fc(x) + x
            return x * self.fc(_dq(h))

    class TM(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.fc = torch.nn.Linear(8, 8)

        def forward(self, x):
            h = self.fc(x) + x
            return x * self.fc(_dq(h))

    j, t = JM(nnx.Rngs(0)), TM()
    convert.load_nnx_params(t, _flat(j))
    jnn.quantize_model(j)
    tnn.quantize_model(t)
    j.fc.output_quantizer = _quantizer(jnn, jff.PerTensor())
    t.fc.output_quantizer = _quantizer(tnn, PerTensor())
    with jflags.strict_quantization(False):
        jaq.autoquantize(j, jnp.asarray(_x()), convert_modules=False)
    taq.autoquantize(t, torch.from_numpy(_x()), convert_modules=False)
    # THEN qt + x is a site and x * qt is none, as in JAX (a plain left
    # operand's own operator takes the call)
    assert list(t.autoquant_quantizers) == list(j.autoquant_quantizers) == ["add_0"]
    # AND a quantizer installed on the site is applied: its sum is quantized
    t.autoquant_quantizers["add_0"] = _quantizer(tnn, PerTensor())
    seen = []
    handle = t.fc.register_forward_pre_hook(lambda m, a: seen.append(a[0]))
    with tflags.strict_quantization(False), torch.no_grad():
        t(torch.from_numpy(_x(3)))
    handle.remove()
    h = seen[1]  # fc's second input: the dequantized site output
    levels = (h / 4.0 * 127).numpy()
    np.testing.assert_allclose(levels, np.round(levels), atol=1e-3)
    # AND outside the context the operators take no site
    with tflags.strict_quantization(False):
        qt = t.fc.output_quantizer(torch.ones(2, 8))
        assert not isinstance(qt + torch.ones(2, 8), QuantizedTensor)


def test_namespace_and_mode_stack_restored():
    relu, softmax = torch.relu, F.softmax
    j, t = _both("mlp")
    assert torch.relu is relu and F.softmax is softmax
    assert torch._C._len_torch_function_stack() == 0
    # AND outside the model's forward nothing is intercepted
    x = torch.from_numpy(_x())
    assert torch.equal(torch.relu(x), x.clamp_min(0))


def test_subclass_cached_and_idempotent():
    t1, t2 = TMLP(), TMLP()
    taq.autoquantize(t1, torch.from_numpy(_x()))
    taq.autoquantize(t2, torch.from_numpy(_x()))
    assert type(t1) is type(t2)
    before = type(t1)
    taq.autoquantize(t1, torch.from_numpy(_x()))
    assert type(t1) is before and before.__mro__.count(before) == 1


def test_sdpa_entry_point_intercepted():
    class Attn(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.fc = torch.nn.Linear(16, 16)

        def forward(self, x):
            B, T = x.shape[:2]
            h = _dq(self.fc(x)).reshape(B, T, 2, 8).transpose(1, 2)
            return F.scaled_dot_product_attention(h, h, h, is_causal=True)

    t = Attn()
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 4, 16).astype(np.float32))
    with torch.no_grad():
        golden = t(x)
    taq.autoquantize(t, x)
    assert list(t.autoquant_quantizers) == ["scaled_dot_product_attention_0"]
    t.autoquant_quantizers["scaled_dot_product_attention_0"] = _quantizer(tnn, PerTensor())
    with tflags.strict_quantization(False), torch.no_grad():
        out = t(x)
    # the quantized SDPA stays within an 8-bit step of torch's own
    assert out.shape == golden.shape
    np.testing.assert_allclose(out.numpy(), golden.numpy(), rtol=0, atol=8.0 / 255)


def test_gpt2_sites_match_jax():
    # GIVEN the tiny GPT-2 in both packages: its calls go through the ops
    # layer (ops.gelu, ops.scaled_dot_product_attention) and plain operators
    from fastforward_tpu.models import gpt2 as jgpt2
    from fastforward_tpu_torch.models import gpt2 as tgpt2

    j = jgpt2.GPT2LMHead(jgpt2.GPT2Config.tiny(), rngs=nnx.Rngs(0))
    t = tgpt2.GPT2LMHead(tgpt2.GPT2Config.tiny(), device="cpu")
    ids = np.random.RandomState(0).randint(0, 256, (1, 8))
    with jflags.strict_quantization(False):
        jaq.autoquantize(j, jnp.asarray(ids))
    taq.autoquantize(t, torch.from_numpy(ids))
    # THEN neither records a site (calls inside quantized operators are not
    # sites), and both converted the attention
    assert list(t.autoquant_quantizers) == list(j.autoquant_quantizers) == []
    assert isinstance(t.blocks[0].attn, tgpt2.QuantizedGPT2Attention)
