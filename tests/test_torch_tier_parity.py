"""BASELINE's tier-parity criterion on the port, held against the JAX
package's `tests/test_tier_parity.py` on the same model, on the CPU.

The JAX test's tiny Llama (hidden 128, intermediate 256, 4 heads over 2 kv
heads of 32, f32) is built from ``nnx.Rngs(0)`` and its weights carried into
the port's model (`nn.convert.load_nnx_params`). Both packages quantize it
alike: 4-bit symmetric g128 blocks on every Linear weight (JAX's
``PerBlock(0, 128, 1)`` on (in, out) kernels is ``PerBlock(1, 128, 0)`` on
torch's (out, in) weights), symmetric min-max ranges from the weights; for
the static-A8 half, 8-bit per-tensor input quantizers calibrated by
running min-max on the same batches. Each package then freezes the model
(`freeze_llama`) and measures `perplexity_delta` of its simulated tier
against its `serving_forward` (the JAX forwards jitted).

Held:
- the port's frozen scales equal its simulated quantizer's scales, and
  JAX's frozen scales within 1e-6 relative (the JAX test's rtol); the
  static input scales likewise;
- each package's relative delta below 0.02 (the JAX test's bound), and the
  static-A8 delta no worse than 1.5 x the dynamic one + 0.02 x ppl_sim;
- the port's ``ppl_sim`` within `PPL_REL` of JAX's in both halves, and
  its w4a16 ``ppl_exec`` too (measured on the CPU: 2.4e-7 and 7e-7
  relative; the simulated forwards sum their f32 products in other orders
  and the exec tiers quantize the same grids). The static-A8 ``ppl_exec``
  is held within `PPL_REL_A8` of JAX's: its 8-bit input grids round x / s,
  and one element of one token whose f32 input differs in its last bit
  from one order of sums to another flips a level there and moves every
  later position's attention. JAX's own forwards show it: its eager and
  jitted ``ppl_exec`` differ by 1.4e-3 relative (385.5603 and 385.0091);
  the port's is 1.4e-5 from the eager one (385.5551); the first batch's
  logits are bit-equal in all three;
- a given scale kept by `quantize_linear`; the static scales through the
  stacked forward (fused projections take the largest of their inputs'
  scales) with finite logits.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import fastforward_tpu as ff
import fastforward_tpu_torch as fft
from fastforward_tpu import nn as jnn
from fastforward_tpu.models import llama as jllama
from fastforward_tpu.serving import engine as je
from fastforward_tpu.utils.evaluation import perplexity_delta as jdelta
from fastforward_tpu_torch import nn as tnn
from fastforward_tpu_torch.models import llama as tllama
from fastforward_tpu_torch.nn import convert
from fastforward_tpu_torch.serving import engine as te
from fastforward_tpu_torch.utils.evaluation import perplexity_delta as tdelta

EXACT = {"xla_allow_excess_precision": False}
PPL_REL = 1e-5
PPL_REL_A8 = 5e-3
REL_DELTA = 0.02
G = 128
WIDTHS = dict(hidden_size=128, intermediate_size=256, num_heads=4, num_kv_heads=2, head_dim=32)
PROJ = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")


def _exact(fn):
    """``fn`` jitted and compiled without XLA's excess precision (the bf16
    values rounded where the program rounds them, as the port does), once
    for each tree structure of its arguments."""
    compiled = {}

    def run(*args):
        key = jax.tree_util.tree_structure(args)
        if key not in compiled:
            compiled[key] = jax.jit(fn).lower(*args).compile(compiler_options=EXACT)
        return compiled[key](*args)

    return run


def _flat(model) -> dict:
    """The model's float parameters by NNX path (its quantizers' left out)."""
    return {"/".join(str(p) for p in path): np.asarray(v[...])
            for path, v in nnx.to_flat_state(nnx.state(model, nnx.Param))
            if not any(str(p).endswith("_quantizer") for p in path)}


def _jax_rules(inputs):
    cfg = ff.QuantizationConfig()
    if inputs:
        cfg.add_rule("**/[cls:Linear]/[quantizer:activation/input]", jnn.LinearQuantizer,
                     num_bits=8, symmetric=True, allow_one_sided=False, granularity=ff.PerTensor())
    else:
        cfg.add_rule("**/[cls:Linear]/[quantizer:parameter/weight]", jnn.LinearQuantizer,
                     num_bits=4, symmetric=True, allow_one_sided=False,
                     granularity=ff.PerBlock(block_dims=0, block_sizes=G, per_channel_dims=1))
    return cfg


def _port_rules(inputs):
    cfg = fft.QuantizationConfig()
    if inputs:
        cfg.add_rule("**/[cls:Linear]/[quantizer:activation/input]", tnn.LinearQuantizer,
                     num_bits=8, symmetric=True, allow_one_sided=False,
                     granularity=fft.PerTensor())
    else:
        cfg.add_rule("**/[cls:Linear]/[quantizer:parameter/weight]", tnn.LinearQuantizer,
                     num_bits=4, symmetric=True, allow_one_sided=False,
                     granularity=fft.PerBlock(block_dims=1, block_sizes=G, per_channel_dims=0))
    return cfg


def _jax_ranges(model):
    for _, module in nnx.iter_modules(model):
        if isinstance(module, jnn.QuantizedLinear):
            w = np.asarray(module.kernel[...])
            K, N = w.shape
            mabs = np.abs(w.reshape(K // G, G, N)).max(axis=1).reshape(-1)
            module.weight_quantizer.quantization_range = (-jnp.asarray(mabs), jnp.asarray(mabs))


def _port_ranges(model):
    for module in model.modules():
        if isinstance(module, tnn.QuantizedLinear):
            w = module.weight.detach()
            N, K = w.shape
            mabs = w.reshape(N, K // G, G).abs().amax(-1).reshape(-1)
            module.weight_quantizer.quantization_range = (-mabs, mabs)


def _batches(seed, n=2, shape=(2, 32)):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, shape) for _ in range(n)]


class _Jax:
    """The JAX side, its forwards jitted (its eager ops compile one by one),
    its float-scale modes on their TPU routes' math (the shims of
    `tests/test_torch_quant_modes.py`, which the port's kernels follow)."""

    def __init__(self, config):
        self.config = config
        self.model = jllama.LlamaForCausalLM(config, rngs=nnx.Rngs(0))
        jnn.quantize_model(self.model)
        _jax_rules(False).initialize(self.model)
        _jax_ranges(self.model)
        self._exec = _exact(lambda params, ids: je.serving_forward(params, config, ids)[0])

    def sim(self):
        graphdef, state = nnx.split(self.model)

        @_exact
        def fwd(state, ids):
            with ff.strict_quantization(False):
                return nnx.merge(graphdef, state)(ids)[0]

        return lambda ids: fwd(state, ids)

    def delta(self, params, batches):
        return jdelta(self.sim(), lambda ids: self._exec(params, ids),
                      [jnp.asarray(b) for b in batches])

    def take_port_state(self, port):
        """The port's calibrated quantizers (input scales, and the weight
        scales its calibration re-estimated), in JAX's tile order."""
        _jax_rules(True).initialize(self.model)
        jq = dict(jnn.named_quantizers(self.model))
        for name, q in tnn.named_quantizers(port):
            if not isinstance(q, tnn.LinearQuantizer):
                continue
            scale = q.scale.detach().numpy()
            if name.endswith("weight_quantizer"):
                n, k = port.get_submodule(name.rsplit(".", 1)[0]).weight.shape
                scale = scale.reshape(n, k // G).T.reshape(-1)
            jq[name.replace(".", "/")].scale = nnx.Param(jnp.asarray(scale))


class _Port:
    def __init__(self, config, weights):
        self.config = config
        self.model = tllama.LlamaForCausalLM(config, device="cpu")
        convert.load_nnx_params(self.model, weights)
        tnn.quantize_model(self.model)
        _port_rules(False).initialize(self.model)
        _port_ranges(self.model)

    def sim(self, ids):
        with fft.strict_quantization(False), torch.no_grad():
            return self.model(ids)[0]

    def delta(self, params, batches):
        return tdelta(self.sim, lambda ids: te.serving_forward(params, self.config, ids)[0],
                      [torch.from_numpy(b) for b in batches])

    def calibrate(self, batches):
        _port_rules(True).initialize(self.model)
        with fft.strict_quantization(False), torch.no_grad():
            with fft.estimate_ranges(self.model, fft.range_setting.running_minmax):
                for ids in batches:
                    self.model(torch.from_numpy(ids))


@pytest.fixture(scope="module")
def tiers():
    """Both packages through the JAX test's protocol: w4a16 on the weights;
    then the port calibrates its inputs (running min-max over the batches,
    which also re-estimates the weights' ranges) and freezes static and
    dynamic w4a8, and the JAX model takes the port's calibrated scales and
    freezes static w4a8."""
    from tests.test_torch_quant_modes import _jax_w4a8_tpu, _jax_w4a16_tpu

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(je, "_on_tpu", lambda: True)
        mp.setattr(je, "matmul_w4a8", _jax_w4a8_tpu)
        mp.setattr(je, "matmul_w4a16", _jax_w4a16_tpu)
        jx = _Jax(dataclasses.replace(jllama.LlamaConfig.tiny(), **WIDTHS))
        pt = _Port(dataclasses.replace(tllama.LlamaConfig.tiny(), **WIDTHS), _flat(jx.model))
        out = {"jax": jx, "port": pt}
        batches = _batches(0)
        for side, freeze in ((jx, je.freeze_llama), (pt, te.freeze_llama)):
            params = freeze(side.model, mode="w4a16", group_size=G)
            out[side, "w4a16"] = params, side.delta(params, batches)
        out["sim_scales"] = {name: q.scale.detach().clone()
                             for name, q in tnn.named_quantizers(pt.model)
                             if isinstance(q, tnn.LinearQuantizer)}
        batches = _batches(3)
        pt.calibrate(batches)
        jx.take_port_state(pt.model)
        for side, freeze in ((jx, je.freeze_llama), (pt, te.freeze_llama)):
            static = freeze(side.model, mode="w4a8", group_size=G, static_activations=True)
            out[side, "static"] = static, side.delta(static, batches)
        dynamic = te.freeze_llama(pt.model, mode="w4a8", group_size=G)
        out[pt, "dynamic"] = dynamic, pt.delta(dynamic, batches)
    return out


def test_frozen_scales_match_sim_quantizer(tiers):
    pt, jx = tiers["port"], tiers["jax"]
    params, _ = tiers[pt, "w4a16"]
    jparams, _ = tiers[jx, "w4a16"]
    for i, (block, layer) in enumerate(zip(pt.model.layers, params.layers)):
        for name in PROJ:
            mod = getattr(block.self_attn if name[0] in "qkvo" else block.mlp, name)
            N, K = mod.weight.shape
            path = f"layers.{i}.{'self_attn' if name[0] in 'qkvo' else 'mlp'}.{name}"
            sim = tiers["sim_scales"][path + ".weight_quantizer"].reshape(N, K // G).t()
            assert torch.equal(getattr(layer, name).scale, sim), (i, name)
            np.testing.assert_allclose(getattr(layer, name).scale.numpy(),
                                       np.asarray(getattr(jparams.layers[i], name).scale),
                                       rtol=1e-6)


@pytest.mark.parametrize("mode", ["w4a16", "static"])
def test_exec_tier_ppl_delta_below_threshold(tiers, mode):
    (_, (ppl_sim, ppl_exec, delta)) = tiers[tiers["port"], mode]
    (_, (jppl_sim, jppl_exec, jdelta_)) = tiers[tiers["jax"], mode]
    assert delta / ppl_sim < REL_DELTA, (ppl_sim, ppl_exec)
    assert jdelta_ / jppl_sim < REL_DELTA
    assert abs(ppl_sim - jppl_sim) <= PPL_REL * jppl_sim, (ppl_sim, jppl_sim)
    tol = PPL_REL if mode == "w4a16" else PPL_REL_A8
    assert abs(ppl_exec - jppl_exec) <= tol * jppl_exec, (ppl_exec, jppl_exec)


def test_static_a8_parity(tiers):
    pt, jx = tiers["port"], tiers["jax"]
    static, (ppl_sim, _, delta) = tiers[pt, "static"]
    dynamic, (_, _, delta_dyn) = tiers[pt, "dynamic"]
    jstatic, _ = tiers[jx, "static"]
    for i, (block, layer) in enumerate(zip(pt.model.layers, static.layers)):
        for name in PROJ:
            mod = getattr(block.self_attn if name[0] in "qkvo" else block.mlp, name)
            in_scale = getattr(layer, name).in_scale
            assert torch.equal(in_scale, mod.input_quantizer.scale.detach().float().reshape(()))
            assert float(in_scale) == float(getattr(jstatic.layers[i], name).in_scale)
    assert dynamic.layers[0].q_proj.in_scale is None
    assert delta <= delta_dyn * 1.5 + REL_DELTA * ppl_sim, (delta, delta_dyn)


def test_external_scale_roundtrip():
    rng = np.random.RandomState(1)
    w = torch.from_numpy(rng.randn(256, 32).astype(np.float32))
    scale = torch.from_numpy(rng.uniform(0.05, 0.3, (2, 32)).astype(np.float32))
    ql = te.quantize_linear(w, "w4a16", group_size=128, scale=scale)
    assert torch.equal(ql.scale, scale)


def test_static_a8_stacked_decode_runs(tiers):
    from fastforward_tpu_torch.serving.stacked import (
        StackedKVCache,
        fuse_stacked_layers,
        serving_forward_stacked,
        stack_serving_layers,
    )

    pt = tiers["port"]
    config = pt.config
    params = te.freeze_llama(pt.model, mode="w4a8_2l", group_size=G, static_activations=True)
    stacked = fuse_stacked_layers(stack_serving_layers(params))
    assert stacked.qkv_proj.in_scale is not None
    assert stacked.qkv_proj.in_scale.shape[0] == config.num_layers
    cache = StackedKVCache.create(
        num_layers=config.num_layers, batch_size=2, max_len=32,
        num_kv_heads=config.num_kv_heads, head_dim=config.head_dim, quantized=True, device="cpu")
    ids = torch.from_numpy(_batches(4, 1, (2, 16))[0])
    logits, cache = serving_forward_stacked(params, stacked, config, ids, cache)
    assert logits.shape == (2, 16, config.vocab_size)
    assert torch.isfinite(logits.float()).all()
