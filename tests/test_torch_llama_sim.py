"""The port's Llama `nn.Module`s (`fastforward_tpu_torch/models/llama.py`),
`serving.engine.freeze_llama`, and the quickstart's whole simulation-to-
serving path, against the JAX package's NNX modules and functions, on the
CPU.

The NNX model is built from a seed (`LlamaConfig.tiny()`: hidden 64, 2
layers, 4 heads over 2 kv heads of 16) and its parameters carried into the
port's model by `nn.convert.load_nnx_params`. Quantization follows
`docs/quickstart_llm.md`: `quantize_model`, three `QuantizationConfig`
rules (8-bit parameters per tensor; 4-bit Linear weights in blocks of
`G` along the in-features, one per output channel, the granularity mapped
to torch's layout; 8-bit symmetric layer inputs per tensor), smoothed
min-max calibration over seeded token ids, GPTQ layer by layer
(`layerwise_optimize_staged`), `freeze_llama` (w4a8, static activations)
and the per-layer serve over an INT8 `KVCache`. The JAX forwards are
jitted with ``xla_allow_excess_precision=False``.

Tolerances:
- float logits within `FLOAT_TOL` of the largest |logit| (f32 sums in
  other orders), also through an INT8 cache (prefill and decode steps);
- the port's `RMSNorm` (NNX's order of operations) on bf16 weights
  bit-equal to `nnx.RMSNorm`, at 256 and 4,096 wide (`torch.nn.RMSNorm`,
  which the modules used before, rounds x * rsqrt(.) before the weight
  product and is one bf16 ulp off in 3 of 262,144 elements at 4,096 wide);
  a bf16 decoder block at 256 wide, its norms bit-equal, within two bf16
  ulps of the largest output (its bf16 projections and attention round
  their f32 sums in other orders than XLA's: 2 of 16,384 gate_proj outputs
  differ alone, and the residual adds carry a rounding on);
- quantized logits, the JAX model's calibrated state carried over, within
  relative RMS `QUANT_RMS` (a layer input one f32 ulp off moves an int8
  level now and then);
- the modules (and the dry run's QAT model) raise without CUDA unless
  given ``device="cpu"``, a generator given or not;
- the 2-layer MLP (`models/mlp.py`): float outputs within `FLOAT_TOL`; with
  8-bit quantizers (JAX's scales carried over) bit-equal;
- `freeze_llama` on the JAX model's GPTQ'd state: every packed byte, scale
  and static input scale equal;
- the whole path, each package from the same float weights on its own
  (calibrated on 256 token positions, more than the 128 in-features, so
  that GPTQ's Hessians are well conditioned): the frozen grids of the port
  equal its simulated grids bit for bit; they equal JAX's frozen grids but
  in at most `GRID_SHARE` of the entries, there one level off (the column
  loops round in other orders; none differ with these seeds), and its
  serve logits (prefill, a decode step) are within relative RMS `E2E_RMS`
  of JAX's (0.0 with these seeds; 0.019 where a calibration set of 8 x 32
  positions moved 0.74% of down_proj's entries).
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from fastforward_tpu import flags as jflags
from fastforward_tpu import nn as jnn
from fastforward_tpu import quantization as jq
from fastforward_tpu import range_setting as jrs
from fastforward_tpu.algorithms import gptq as jgptq
from fastforward_tpu.algorithms import layerwise_optimize_staged as jstaged
from fastforward_tpu.models import llama as jllama
from fastforward_tpu.models.mlp import MLP as JMLP
from fastforward_tpu.quant_init import QuantizationConfig as JConfig
from fastforward_tpu.serving import engine as je
from fastforward_tpu.serving import kv_cache as jkv
from fastforward_tpu_torch import QuantizationConfig as TConfig
from fastforward_tpu_torch import flags as tflags
from fastforward_tpu_torch import nn as tnn
from fastforward_tpu_torch import range_setting as trs
from fastforward_tpu_torch.algorithms import gptq as tgptq
from fastforward_tpu_torch.algorithms import layerwise_optimize_staged as tstaged
from fastforward_tpu_torch.kernels.packing import unpack_int4
from fastforward_tpu_torch.models import llama as tllama
from fastforward_tpu_torch.models.mlp import MLP as TMLP
from fastforward_tpu_torch.nn import convert
from fastforward_tpu_torch.parallel import dryrun
from fastforward_tpu_torch.serving import engine as te
from fastforward_tpu_torch.serving import kv_cache as tkv
from fastforward_tpu_torch.serving.convert import params_to_flat
from tests.test_torch_serving_forward import jax_params_to_flat

EXACT = {"xla_allow_excess_precision": False}
FLOAT_TOL = 1e-5
BLOCK_TOL = 2.0 ** -7
QUANT_RMS = 1e-3
E2E_RMS = 5e-2
GRID_SHARE = 1e-2
G = 16
JGRAN = jq.PerBlock(block_dims=0, block_sizes=G, per_channel_dims=1)


def _jit(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=EXACT)(*args)


def _flat(model) -> dict:
    return {"/".join(str(p) for p in path): np.asarray(v[...])
            for path, v in nnx.to_flat_state(nnx.state(model, nnx.Param))}


def _jlogits(model, ids, cache=None):
    graphdef, state = nnx.split(model)

    def f(state, ids, cache):
        with jflags.strict_quantization(False):
            return nnx.merge(graphdef, state)(ids, cache=cache)

    return _jit(f, state, jnp.asarray(ids), cache)


def _tlogits(model, ids, cache=None):
    with tflags.strict_quantization(False), torch.no_grad():
        return model(torch.from_numpy(np.asarray(ids)), cache=cache)


def _rel_rms(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(((a - b) ** 2).mean() / (b ** 2).mean()))


def _close(port, want, tol):
    port, want = np.asarray(port, np.float64), np.asarray(want, np.float64)
    assert port.shape == want.shape
    err = np.abs(port - want).max()
    assert err <= tol * np.abs(want).max(), err


def _pair(seed=0, jcfg=None, tcfg=None):
    j = jllama.LlamaForCausalLM(jcfg or jllama.LlamaConfig.tiny(), rngs=nnx.Rngs(seed))
    t = tllama.LlamaForCausalLM(tcfg or tllama.LlamaConfig.tiny(), device="cpu")
    convert.load_nnx_params(t, _flat(j))
    return j, t


def _ids(seed, shape=(2, 12)):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(np.int32)


def test_float_logits_match_nnx():
    j, t = _pair()
    ids = _ids(0)
    (want, _), (got, _) = _jlogits(j, ids), _tlogits(t, ids)
    _close(got, want, FLOAT_TOL)


def test_int8_cache_prefill_and_decode_match_nnx():
    j, t = _pair(1)
    c = jllama.LlamaConfig.tiny()
    jcache = jkv.KVCache.create(num_layers=c.num_layers, batch_size=2, max_len=32,
                                num_kv_heads=c.num_kv_heads, head_dim=c.head_dim,
                                dtype=jnp.float32, quantized=True)
    tcache = tkv.KVCache.create(c.num_layers, 2, 32, c.num_kv_heads, c.head_dim,
                                quantized=True, device="cpu")
    ids = _ids(1, (2, 10))
    for chunk in (ids[:, :8], ids[:, 8:9], ids[:, 9:10]):
        want, jcache = _jlogits(j, chunk, jcache)
        got, tcache = _tlogits(t, chunk, tcache)
        _close(got, want, FLOAT_TOL)
    assert tcache.length == int(jcache.length) == 10


def test_bf16_block_matches_nnx():
    # GIVEN one decoder block at 256 wide with bf16 weights (norm scales
    # away from one), and a bf16 input
    kw = dict(hidden_size=256, intermediate_size=512, num_heads=4, num_kv_heads=2,
              head_dim=64)
    jc = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.bfloat16, **kw)
    tc = dataclasses.replace(tllama.LlamaConfig.tiny(), dtype=torch.bfloat16, **kw)
    jb = jllama.LlamaBlock(jc, rngs=nnx.Rngs(2))
    rs = np.random.RandomState(2)
    for norm in (jb.input_layernorm, jb.post_attention_layernorm):
        norm.scale.value = jnp.asarray(1 + 0.2 * rs.randn(256), jnp.bfloat16)
    tb = tllama.LlamaBlock(tc, device="cpu")
    convert.load_nnx_params(tb, _flat(jb))
    x = rs.randn(2, 16, 256).astype(np.float32)
    pos = np.arange(16)
    graphdef, state = nnx.split(jb)
    want = _jit(lambda s, x, p: nnx.merge(graphdef, s)(x, p)[0], state,
                jnp.asarray(x, jnp.bfloat16), jnp.asarray(pos))
    with torch.no_grad():
        got = tb(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(pos))[0]
    want = np.asarray(want.astype(jnp.float32))
    # THEN within two bf16 ulps of the largest output
    _close(got.float().numpy(), want, BLOCK_TOL)
    # AND its norms are NNX's bit for bit
    for name in ("input_layernorm", "post_attention_layernorm"):
        jnorm = _jit(lambda s, x: getattr(nnx.merge(graphdef, s), name)(x), state,
                     jnp.asarray(x, jnp.bfloat16))
        with torch.no_grad():
            tnorm = getattr(tb, name)(torch.from_numpy(x).to(torch.bfloat16))
        np.testing.assert_array_equal(tnorm.float().numpy(),
                                      np.asarray(jnorm.astype(jnp.float32)))


@pytest.mark.parametrize("width", [256, 4096])
def test_bf16_rms_norm_rounds_as_nnx(width):
    # GIVEN the norm alone on bf16 weights away from one and a bf16 input
    rs = np.random.RandomState(3)
    x = rs.randn(64, width).astype(np.float32)
    w = (1 + 0.1 * rs.randn(width)).astype(np.float32)
    jn = nnx.RMSNorm(width, epsilon=1e-5, param_dtype=jnp.bfloat16, rngs=nnx.Rngs(0))
    jn.scale.value = jnp.asarray(w, jnp.bfloat16)
    graphdef, state = nnx.split(jn)
    want = _jit(lambda s, x: nnx.merge(graphdef, s)(x), state, jnp.asarray(x, jnp.bfloat16))
    tn = tllama.RMSNorm(width, eps=1e-5, dtype=torch.bfloat16)
    with torch.no_grad():
        tn.weight.copy_(torch.from_numpy(w))
        got = tn(torch.from_numpy(x).to(torch.bfloat16))
    # THEN the same bits: both reduce in f32 and round to bf16 once, as
    # x * (rsqrt(.) * w)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_modules_need_cuda_unless_cpu_is_asked(monkeypatch):
    # GIVEN a host without CUDA
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tllama.LlamaConfig.tiny()
    # THEN the modules raise by default, a CPU generator given or not
    for build in (lambda **kw: tllama.LlamaForCausalLM(cfg, **kw),
                  lambda **kw: tllama.LlamaBlock(cfg, **kw),
                  lambda **kw: TMLP(16, 32, 8, **kw),
                  lambda **kw: dryrun.qat_model(**kw)):
        for kw in ({}, {"generator": torch.Generator().manual_seed(0)}):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                build(**kw)
    # AND build on the CPU when asked, refusing a generator on another device
    model = tllama.LlamaForCausalLM(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    assert {p.device.type for p in model.parameters()} == {"cpu"}
    with pytest.raises(ValueError, match="generator"):
        tllama.LlamaMLP(cfg, device="cpu", generator=types.SimpleNamespace(device=torch.device("cuda", 0)))


@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int8"])
def test_mlp_matches_nnx(quantized):
    # GIVEN the per-tensor INT8 milestone's MLP in both packages, the same
    # weights, and (quantized) 8-bit per-tensor quantizers at (-3, 3)
    j, t = JMLP(16, 32, 8, rngs=nnx.Rngs(4)), TMLP(16, 32, 8, device="cpu")
    convert.load_nnx_params(t, _flat(j))
    if quantized:
        for pkg, model, cfg in ((jnn, j, JConfig()), (tnn, t, TConfig())):
            pkg.quantize_model(model)
            cfg.add_rule("**/[quantizer:*]", pkg.LinearQuantizer, num_bits=8, symmetric=False)
            cfg.initialize(model)
        for (_, jqz), (_, tqz) in zip(jnn.named_quantizers(j), tnn.named_quantizers(t)):
            jqz.quantization_range = (-3.0, 3.0)
            tqz.quantization_range = (-3.0, 3.0)
        convert.load_nnx_params(t, _flat(j))  # JAX's scales and offsets, bit for bit
    x = np.random.RandomState(4).randn(4, 16).astype(np.float32)
    graphdef, state = nnx.split(j)

    def f(state, x):
        with jflags.strict_quantization(False):
            y = nnx.merge(graphdef, state)(x)
        return y.dequantize() if isinstance(y, jq.QuantizedArray) else y

    want = _jit(f, state, jnp.asarray(x))
    with tflags.strict_quantization(False), torch.no_grad():
        got = t(torch.from_numpy(x))
        got = got.dequantize() if quantized else got
    # THEN the outputs agree: quantized bit for bit, float within FLOAT_TOL
    if quantized:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        _close(got.numpy(), want, FLOAT_TOL)


def _rules(pkg, cfg, wgran):
    cfg.add_rule("**/[quantizer:parameter]", pkg.LinearQuantizer, num_bits=8, symmetric=True)
    cfg.add_rule("**/[cls:Linear]/[quantizer:parameter/weight]", pkg.LinearQuantizer,
                 num_bits=4, symmetric=True, granularity=wgran)
    cfg.add_rule("**/[quantizer:activation/input]", pkg.LinearQuantizer, num_bits=8,
                 symmetric=True)
    return cfg


TGRAN = convert.transpose_granularity(JGRAN, convert.LINEAR_WEIGHT_PERM)


def _configure(j, t):
    jnn.quantize_model(j)
    _rules(jnn, JConfig(), JGRAN).initialize(j)
    tnn.quantize_model(t)
    _rules(tnn, TConfig(), TGRAN).initialize(t)


def _fresh_port(state):
    """A configured port model holding a JAX model's flat state."""
    t = tllama.LlamaForCausalLM(tllama.LlamaConfig.tiny(), device="cpu")
    tnn.quantize_model(t)
    _rules(tnn, TConfig(), TGRAN).initialize(t)
    convert.load_nnx_params(t, state)
    return t


CALIB = [_ids(10, (2, 128))]


def _jstaged_restoring(model, *args, **kwargs):
    """JAX's `layerwise_optimize_staged`, then the class state it leaves
    behind undone. Its stage-input catcher restores ``type(stage).__call__``
    by assignment (`fastforward_tpu/algorithms/layerwise.py:140-153`), so a
    class that inherited ``__call__`` (the converted block's) keeps an own
    copy that shadows any later patch of its base:
    `tests/algorithms/test_layerwise_staged.py` then counts no calls of a
    patched `LlamaBlock.__call__` when it runs after this file in one
    process."""
    classes = {type(m) for _, m in nnx.iter_modules(model)}
    inherited = [c for c in classes if "__call__" not in vars(c)]
    try:
        return jstaged(model, *args, **kwargs)
    finally:
        for c in inherited:
            if "__call__" in vars(c):
                del c.__call__


@pytest.fixture(scope="module")
def flows():
    """Both packages' quickstart path from the same float weights: after
    calibration, after GPTQ, frozen; and the port holding JAX's states."""
    j, t = _pair(3)
    _configure(j, t)
    with jflags.strict_quantization(False):
        with jrs.estimate_ranges(j, jrs.smoothed_minmax):
            for b in CALIB:
                j(jnp.asarray(b))
    with tflags.strict_quantization(False), torch.no_grad():
        with trs.estimate_ranges(t, trs.smoothed_minmax):
            for b in CALIB:
                t(torch.from_numpy(b))
    out = {"calibrated": _flat(j)}
    ids = _ids(4, (2, 12))
    out["quant_logits"] = (_jlogits(j, ids)[0], _tlogits(_fresh_port(out["calibrated"]), ids)[0])

    def jforward(m, b):
        return m(b)[0]

    kw = dict(stages="layers/*", forward=jforward, num_bits=4, block_size=G)
    out["paths"] = (
        _jstaged_restoring(j, [jnp.asarray(b) for b in CALIB], jgptq, granularity=JGRAN, **kw),
        tstaged(t, [torch.from_numpy(b) for b in CALIB], tgptq, granularity=TGRAN, **kw))
    out["gptq_state"] = _flat(j)
    out["models"] = (j, t)
    out["frozen"] = (je.freeze_llama(j, "w4a8", G, static_activations=True),
                     te.freeze_llama(t, "w4a8", G, static_activations=True),
                     te.freeze_llama(_fresh_port(out["gptq_state"]), "w4a8", G,
                                     static_activations=True))
    return out


def test_quantized_logits_match_nnx(flows):
    want, got = flows["quant_logits"]
    assert _rel_rms(got.numpy(), want) <= QUANT_RMS


def test_staged_gptq_paths_are_jax_paths(flows):
    jpaths, tpaths = flows["paths"]
    # the same projections; the port's in model order (JAX's in mpath's
    # string order: down_proj first)
    assert sorted(tpaths) == sorted(jpaths) and len(tpaths) == 14
    names = ["self_attn/q_proj", "self_attn/k_proj", "self_attn/v_proj", "self_attn/o_proj",
             "mlp/gate_proj", "mlp/up_proj", "mlp/down_proj"]
    assert tpaths == [f"layers/{i}/{n}" for i in range(2) for n in names]


def test_freeze_llama_matches_jax_bytes(flows):
    # GIVEN JAX's GPTQ'd state frozen by JAX, and by the port from the same state
    jp, _, tp = flows["frozen"]
    want, got = jax_params_to_flat(jp), params_to_flat(tp)
    # THEN every packed byte, scale and static input scale is JAX's
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        g = got[k]
        if w.dtype == jnp.bfloat16:
            w = w.view(np.int16)
        np.testing.assert_array_equal(g, w, err_msg=k)
    for layer in tp.layers:
        for f in dataclasses.fields(layer):
            ql = getattr(layer, f.name)
            if isinstance(ql, te.QuantLinear):
                assert ql.data.is_contiguous() and ql.scale.is_contiguous()
                assert ql.in_scale is not None


def test_port_frozen_grids_equal_its_simulated_grids(flows):
    _, t = flows["models"]
    _, tp, _ = flows["frozen"]
    for block, layer in zip(t.layers, tp.layers):
        for name in ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
                     "down_proj"):
            mod = getattr(block.self_attn if name[0] in "qkvo" else block.mlp, name)
            ql = getattr(layer, name)
            sim = mod.weight_quantizer(mod.weight)
            N, K = mod.weight.shape
            assert torch.equal(sim.raw_data.float(), unpack_int4(ql.data, G).float().t())
            assert torch.equal(sim.quant_args().scale.detach().reshape(N, K // G).t(), ql.scale)


def test_quickstart_serve_logits_match_jax(flows):
    # GIVEN each package's own path from the same float weights, frozen
    jp, tp, tpj = flows["frozen"]
    # THEN the port's GPTQ grids are JAX's but for a share of entries one
    # level off (the column loops round in other orders)
    for layer, jlayer in zip(tp.layers, tpj.layers):
        for f in dataclasses.fields(layer):
            ql = getattr(layer, f.name)
            if isinstance(ql, te.QuantLinear):
                a = unpack_int4(ql.data, G).int()
                b = unpack_int4(getattr(jlayer, f.name).data, G).int()
                assert (a != b).float().mean().item() <= GRID_SHARE, f.name
                assert (a - b).abs().max().item() <= 1, f.name
    # AND the serve's logits (prefill, then a decode step from each cache)
    # are JAX's within E2E_RMS
    jc, tc = jllama.LlamaConfig.tiny(), tllama.LlamaConfig.tiny()
    ids = _ids(5, (2, 12))
    jcache = jkv.KVCache.create(num_layers=jc.num_layers, batch_size=2, max_len=32,
                                num_kv_heads=jc.num_kv_heads, head_dim=jc.head_dim,
                                quantized=True)
    tcache = tkv.KVCache.create(tc.num_layers, 2, 32, tc.num_kv_heads, tc.head_dim,
                                quantized=True, device="cpu")
    for _ in range(2):
        want, jcache = _jit(lambda p, i, c: je.serving_forward(p, jc, i, c), jp,
                            jnp.asarray(ids), jcache)
        got, tcache = te.serving_forward(tp, tc, torch.from_numpy(ids), tcache)
        assert _rel_rms(got.numpy(), want) <= E2E_RMS
        ids = np.argmax(np.asarray(want)[:, -1], -1)[:, None].astype(np.int32)
