"""The port's GPT-2 (`fastforward_tpu_torch/models/gpt2.py`) against the
JAX package's NNX model (`fastforward_tpu/models/gpt2.py`), on the CPU.

The NNX model is built from a seed (`GPT2Config.tiny()`: 2 layers, 32 wide,
2 heads, vocab 256) and its parameters carried into the port's model by
`nn.convert.load_nnx_params`. The W8A8 configuration is BASELINE config 2's
(`tests/models/test_gpt2.py:30-47`): 8-bit symmetric parameters per tensor,
int8-stored symmetric Linear weights per output channel (JAX's
``PerChannel(1)`` on the (in, out) kernel is the port's ``PerChannel(0)``
on the (out, in) weight), 8-bit asymmetric activations per tensor. The JAX
forwards are jitted with ``xla_allow_excess_precision=False``.

Tolerances:
- `torch.nn.LayerNorm` in f32 against `nnx.LayerNorm` within `LN_TOL`
  absolute on unit-scale rows, 768 wide (XLA reduces in its own order; not
  bit-equal, and NNX's order written out in torch is no closer);
- float logits within `FLOAT_TOL` of the largest |logit|;
- each W8A8 quantizer's range after running min-max calibration, each side
  calibrating its own model from the same float weights: parameters'
  scales within `SCALE_RTOL` (eager JAX divides by 127 where the port
  multiplies by XLA's f32 reciprocal, as `tests/test_torch_range_setting.py`
  states), activations' within `RANGE_TOL` of the largest (their inputs
  went through other roundings, and the attention's quantized scores
  and weights flip levels on them: up to 4.1e-3 measured with these
  seeds); the weights' scales after the
  minimum-error grid within `SCALE_RTOL` too (the same candidate chosen);
- quantized logits, the JAX model's calibrated state carried over: with
  SDPA's scores and weights quantizers left stubs, bit-equal to the jitted
  JAX logits; with them (config 2 as written), within relative RMS
  `QUANT_RMS` (a score one f32 ulp off moves its int8 level, and so the
  softmax; 0.0163 measured with these seeds, where JAX's own eager forward
  is 0.0054 off its jitted one); every Linear goes through the W8A8 registration on
  both sides (4 per block), the port's through row 19's plain version
  (`matmul_w8a8` on CPU tensors), and its logits are within `SQNR_DB` of
  the float logits as JAX's are;
- the modules raise without CUDA unless given ``device="cpu"``.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import fastforward_tpu.kernels  # noqa: F401  (registers the JAX W8A8 kernel)
import fastforward_tpu_torch.kernels  # noqa: F401  (registers the port's)
from fastforward_tpu import flags as jflags
from fastforward_tpu import nn as jnn
from fastforward_tpu import quantization as jq
from fastforward_tpu import range_setting as jrs
from fastforward_tpu.kernels import dispatch as jdispatch
from fastforward_tpu.models import gpt2 as jgpt2
from fastforward_tpu.quant_init import QuantizationConfig as JConfig
from fastforward_tpu_torch import QuantizationConfig as TConfig
from fastforward_tpu_torch import flags as tflags
from fastforward_tpu_torch import nn as tnn
from fastforward_tpu_torch import quantization as tq
from fastforward_tpu_torch import range_setting as trs
from fastforward_tpu_torch.kernels import dispatch as tdispatch
from fastforward_tpu_torch.models import gpt2 as tgpt2
from fastforward_tpu_torch.nn import convert

EXACT = {"xla_allow_excess_precision": False}
LN_TOL = 4e-6
FLOAT_TOL = 1e-5
RANGE_TOL = 2e-2
SCALE_RTOL = 2.0 ** -22
QUANT_RMS = 5e-2
SQNR_DB = 20.0


def _jit(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=EXACT)(*args)


def _flat(model) -> dict:
    return {"/".join(str(p) for p in path): np.asarray(v[...])
            for path, v in nnx.to_flat_state(nnx.state(model, nnx.Param))}


def _pair(seed=0):
    j = jgpt2.GPT2LMHead(jgpt2.GPT2Config.tiny(), rngs=nnx.Rngs(seed))
    t = tgpt2.GPT2LMHead(tgpt2.GPT2Config.tiny(), device="cpu")
    convert.load_nnx_params(t, _flat(j))
    return j, t


def _ids(seed, shape=(2, 16)):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(np.int32)


def _jlogits(model, ids):
    graphdef, state = nnx.split(model)

    def f(state, ids):
        with jflags.strict_quantization(False):
            return nnx.merge(graphdef, state)(ids)

    return np.asarray(_jit(f, state, jnp.asarray(ids)))


def _tlogits(model, ids):
    with tflags.strict_quantization(False), torch.no_grad():
        return model(torch.from_numpy(ids)).numpy()


def _rel_rms(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(((a - b) ** 2).mean() / (b ** 2).mean()))


def _sqnr(ref, out):
    ref, out = np.asarray(ref, np.float64), np.asarray(out, np.float64)
    return float(10 * np.log10((ref ** 2).mean() / ((ref - out) ** 2).mean()))


def w8a8_rules(pkg, cfg, weight_granularity, int8):
    """BASELINE config 2's rules on ``pkg`` (either package's `nn`)."""
    cfg.add_rule("**/[quantizer:parameter]", pkg.LinearQuantizer, num_bits=8, symmetric=True)
    cfg.add_rule("**/[cls:Linear]/[quantizer:parameter/weight]", pkg.LinearQuantizer,
                 num_bits=8, symmetric=True, granularity=weight_granularity,
                 quantized_dtype=int8)
    cfg.add_rule("**/[quantizer:activation]", pkg.LinearQuantizer, num_bits=8, symmetric=False)
    return cfg


def _configure(j, t):
    jnn.quantize_model(j)
    w8a8_rules(jnn, JConfig(), jq.PerChannel(1), jnp.int8).initialize(j)
    tnn.quantize_model(t)
    w8a8_rules(tnn, TConfig(), tq.PerChannel(0), torch.int8).initialize(t)


def _tlinears(model):
    return [lin for b in model.blocks for lin in (b.attn.c_attn, b.attn.c_proj, b.fc_in, b.fc_out)]


CALIB = [_ids(10)]
MSE_CANDIDATES = 20  # the grid the MSE step searches (the estimators' default is 100)


@pytest.fixture(scope="module")
def calibrated():
    """Both packages' W8A8 model from the same float weights, each
    calibrated with running min-max on `CALIB`; their weight ranges before
    and after the minimum-error grid; the port holding JAX's state."""
    j, t = _pair(3)
    fp = (_jlogits(j, CALIB[0]), _tlogits(t, CALIB[0]))
    _configure(j, t)
    with jflags.strict_quantization(False):
        with jrs.estimate_ranges(j, jrs.running_minmax):
            for b in CALIB:
                j(jnp.asarray(b))
    with tflags.strict_quantization(False), torch.no_grad():
        with trs.estimate_ranges(t, trs.running_minmax):
            for b in CALIB:
                t(torch.from_numpy(b))
    minmax = (_flat(j), {n: q for n, q in tnn.named_quantizers(t)})
    minmax = (minmax[0], {n: (None if q.scale is None else q.scale.detach().clone(),
                              None if q.offset is None else q.offset.detach().clone())
                          for n, q in minmax[1].items() if isinstance(q, tnn.LinearQuantizer)})
    # the weights again with the minimum-error grid (config 2's "min-max + MSE")
    for jlin, tlin in zip([m for b in j.blocks for m in (b.attn.c_attn, b.attn.c_proj,
                                                         b.fc_in, b.fc_out)], _tlinears(t)):
        with jrs.estimate_ranges(jlin.weight_quantizer, jrs.min_error_grid,
                                 num_candidates=MSE_CANDIDATES):
            jlin.weight_quantizer(jlin.kernel[...])
        with trs.estimate_ranges(tlin.weight_quantizer, trs.min_error_grid,
                                 num_candidates=MSE_CANDIDATES), torch.no_grad():
            tlin.weight_quantizer(tlin.weight)
    return dict(models=(j, t), fp=fp, minmax=minmax, mse=_flat(j))


def _port_of(state):
    t = tgpt2.GPT2LMHead(tgpt2.GPT2Config.tiny(), device="cpu")
    tnn.quantize_model(t)
    w8a8_rules(tnn, TConfig(), tq.PerChannel(0), torch.int8).initialize(t)
    convert.load_nnx_params(t, state)
    return t


def test_layer_norm_rounds_within_a_few_ulps_of_nnx():
    # GIVEN unit-scale rows 768 wide and a LayerNorm with seeded scale and bias
    rs = np.random.RandomState(0)
    x = (rs.randn(64, 768) * 3 + 0.5).astype(np.float32)
    j = nnx.LayerNorm(768, epsilon=1e-5, rngs=nnx.Rngs(0))
    j.scale.value = jnp.asarray(rs.randn(768).astype(np.float32))
    j.bias.value = jnp.asarray(rs.randn(768).astype(np.float32))
    t = torch.nn.LayerNorm(768, eps=1e-5)
    convert.load_nnx_params(t, _flat(j))
    graphdef, state = nnx.split(j)
    want = np.asarray(_jit(lambda s, x: nnx.merge(graphdef, s)(x), state, jnp.asarray(x)))
    with torch.no_grad():
        got = t(torch.from_numpy(x)).numpy()
    # THEN torch's LayerNorm is within LN_TOL of NNX's (not bit-equal)
    assert np.abs(got - want).max() <= LN_TOL


def test_float_logits_match_nnx():
    j, t = _pair()
    ids = _ids(0)
    want, got = _jlogits(j, ids), _tlogits(t, ids)
    assert got.shape == (2, 16, 256)
    assert np.abs(got - want).max() <= FLOAT_TOL * np.abs(want).max()


def test_quantize_model_converts_attention_and_passes_through():
    # GIVEN the float model's logits
    _, t = _pair(1)
    ids = _ids(1, (1, 5))
    want = _tlogits(t, ids)
    # WHEN converted (stubs only)
    tnn.quantize_model(t)
    # THEN the attention has its quantized counterpart and the logits stay
    assert isinstance(t.blocks[0].attn, tgpt2.QuantizedGPT2Attention)
    assert isinstance(t.blocks[0].attn.attn_scores_quantizer, tnn.QuantizerStub)
    np.testing.assert_allclose(_tlogits(t, ids), want, rtol=1e-4, atol=1e-5)


def test_minmax_and_mse_ranges_match_jax(calibrated):
    jstate, tranges = calibrated["minmax"]
    for path, (scale, offset) in tranges.items():
        jpath = path.replace(".", "/")
        if scale is None:  # a slot no forward reaches (the attention's output)
            assert f"{jpath}/scale" not in jstate
            continue
        want = jstate[f"{jpath}/scale"]
        got = scale.numpy()
        if not path.endswith(("weight_quantizer", "bias_quantizer")):  # an activation
            top = np.abs(want).max()
            assert np.abs(got - want.reshape(got.shape)).max() <= RANGE_TOL * top, path
        else:
            np.testing.assert_allclose(got, want.reshape(got.shape), rtol=SCALE_RTOL, atol=0,
                                       err_msg=path)
    # the weights' scales after the minimum-error grid: bit-equal
    _, t = calibrated["models"]
    mse = calibrated["mse"]
    for i, block in enumerate(t.blocks):
        for name, lin in (("attn/c_attn", block.attn.c_attn), ("attn/c_proj", block.attn.c_proj),
                          ("fc_in", block.fc_in), ("fc_out", block.fc_out)):
            want = mse[f"blocks/{i}/{name}/weight_quantizer/scale"]
            np.testing.assert_allclose(lin.weight_quantizer.scale.detach().numpy(), want,
                                       rtol=SCALE_RTOL, atol=0)
            # the grid's candidates shrink the min-max range, never widen it
            assert (want <= jstate[f"blocks/{i}/{name}/weight_quantizer/scale"]).all()


@contextlib.contextmanager
def _spy(module, name, calls):
    original = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(tuple(args[0].shape))
        return original(*args, **kwargs)

    setattr(module, name, spy)
    try:
        yield
    finally:
        setattr(module, name, original)


def test_w8a8_logits_match_jax_through_row_19(calibrated):
    # GIVEN JAX's calibrated (min-max + MSE) state in a configured port model
    j, _ = calibrated["models"]
    t = _port_of(calibrated["mse"])
    ids = CALIB[0]
    jcalls, tcalls = [], []
    # WHEN both run their quantized forward (JAX's jitted)
    with _spy(jdispatch, "matmul_w8a8", jcalls):
        want = _jlogits(j, ids)
    with _spy(tdispatch, "matmul_w8a8", tcalls):
        got = _tlogits(t, ids)
    # THEN every Linear went through the W8A8 registration on both sides,
    # the port's on row 19's plain version (CPU tensors), with the same shapes
    L = jgpt2.GPT2Config.tiny().num_layers
    assert len(tcalls) == 4 * L and sorted(tcalls) == sorted(jcalls)
    # AND the logits agree, and keep config 2's SQNR bar against the float logits
    assert _rel_rms(got, want) <= QUANT_RMS
    fp_j, fp_t = calibrated["fp"]
    assert _sqnr(fp_t, got) >= SQNR_DB and _sqnr(fp_j, want) >= SQNR_DB
    # AND with SDPA's intermediate quantizers left stubs, they are bit-equal
    for jb, tb in zip(j.blocks, t.blocks):
        for name in ("attn_scores_quantizer", "attn_weights_quantizer"):
            setattr(jb.attn, name, jnn.QuantizerStub("activation/" + name))
            setattr(tb.attn, name, tnn.QuantizerStub("activation/" + name))
    np.testing.assert_array_equal(_tlogits(t, ids), _jlogits(j, ids))


def test_modules_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device is valid")
    cfg = tgpt2.GPT2Config.tiny()
    for build in (lambda **kw: tgpt2.GPT2LMHead(cfg, **kw),
                  lambda **kw: tgpt2.GPT2Block(cfg, **kw)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build(generator=torch.Generator().manual_seed(0))
        build(device="cpu")
