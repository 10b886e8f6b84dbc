"""The port's range estimators (`fastforward_tpu_torch/range_setting/`)
against the JAX package's (`fastforward_tpu/range_setting/`), on the CPU.

The same numpy batches go through each package's estimator steps (running
and smoothed min-max, minimum-error grid) on a `LinearQuantizer` of each
package with the same spec (a weight's granularity mapped to torch's (out,
in) layout by `nn.convert.transpose_granularity`, its tiles reordered), and
through `estimate_ranges` on the same two-layer model (weights carried by
`nn.convert.load_nnx_params`).

Tolerances:
- running and smoothed min-max: the per-tile ranges bit-equal;
- the quantizer's scale and offset: bit-equal to the jitted JAX
  ``parameters_for_range`` of the estimated range (the port writes out its
  multiplication by the f32 reciprocal of 2^b - 1, 127 or 128), within
  2^-22 relative of the eager JAX setter's true division (two roundings
  against one); through `estimate_ranges` on a model, where the range is
  internal, within 1e-6 relative of the eager JAX package's (a layer
  downstream sees its input quantized on a grid a few ulps off);
- minimum-error grid: the candidate fractions within one f32 ulp of
  ``jnp.linspace`` (the port rounds the f64 grid once), the per-tile error
  tables within rtol 1e-4 (another summation order of the squared errors,
  and a candidate range one ulp off moves an element's rounding now and
  then: 1.1e-5 in 3 of 2,560 entries), the chosen candidate of every tile
  equal, and the final scales within rtol 1e-5 (a neighbouring candidate is
  2% away).
"""

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
from fastforward_tpu.quant_init import QuantizationConfig as JConfig
from fastforward_tpu.quantization import affine as jaffine
from fastforward_tpu.range_setting import min_error as jme
from fastforward_tpu.range_setting import minmax as jmm
from fastforward_tpu_torch import QuantizationConfig as TConfig
from fastforward_tpu_torch import flags as tflags
from fastforward_tpu_torch import nn as tnn
from fastforward_tpu_torch import range_setting as trs
from fastforward_tpu_torch.nn import convert
from fastforward_tpu_torch.range_setting import min_error as tme
from fastforward_tpu_torch.range_setting import minmax as tmm

EXACT = {"xla_allow_excess_precision": False}
MINERR_RTOL = 1e-5
MINERR_TABLE_RTOL = 1e-4
MODEL_RTOL = 1e-6
ULP = 2.0 ** -23

# (name, data shape, JAX granularity, the permutation torch's layout applies)
CASES = [
    ("act per tensor", (4, 16, 32), jq.PerTensor(), (0, 1, 2)),
    ("act per channel", (4, 16, 32), jq.PerChannel(2), (0, 1, 2)),
    ("weight per out-channel", (32, 16), jq.PerChannel(1), (1, 0)),
    ("weight per block g8", (32, 16), jq.PerBlock(block_dims=0, block_sizes=8,
                                                   per_channel_dims=1), (1, 0)),
]


def _batches(shape, n=3, seed=0):
    rs = np.random.RandomState(seed)
    return [(rs.randn(*shape) * (1 + rs.rand(*shape[-1:]))).astype(np.float32)
            for _ in range(n)]


def _quantizers(jgran, perm, symmetric):
    jquant = jnn.LinearQuantizer(8, granularity=jgran, symmetric=symmetric)
    tquant = tnn.LinearQuantizer(8, granularity=convert.transpose_granularity(jgran, perm),
                                 symmetric=symmetric)
    return jquant, tquant


def _in_torch_order(values, jgran, jshape, perm):
    """Per-tile values of a JAX-layout tensor in the tile order of its
    torch-layout transpose."""
    tshape = tuple(jshape[p] for p in perm)
    return convert._reorder_tiles(np.asarray(values), convert.transpose_granularity(jgran, perm),
                                  tshape, perm)


def _jit_params(mn, mx, symmetric):
    f = jax.jit(lambda a, b: jaffine.parameters_for_range(a, b, 8, symmetric=symmetric,
                                                          allow_one_sided=True))
    return f.lower(mn, mx).compile(compiler_options=EXACT)(mn, mx)


def _check_params(jquant, tquant, jgran, jshape, perm, symmetric, jrange=None, rtol=2 * ULP):
    """The port's scale (and offset) within ``rtol`` of the eager JAX
    setter's; given the estimated range ``jrange`` (JAX's (min, max)), also
    bit-equal to the jitted JAX function of it."""
    ts = tquant.scale.detach().numpy()
    eager = _in_torch_order(jquant.scale.value, jgran, jshape, perm)
    assert np.all(np.abs(ts - eager) <= rtol * np.abs(eager))
    if jrange is None:
        return
    js, jo = _jit_params(*jrange, symmetric)
    np.testing.assert_array_equal(ts, _in_torch_order(js, jgran, jshape, perm))
    if not symmetric:
        to = tquant.offset.detach().numpy()
        np.testing.assert_array_equal(to, _in_torch_order(jo, jgran, jshape, perm))


@pytest.mark.parametrize("kind", ["running", "smoothed"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_minmax_steps_bit_equal(kind, case):
    # GIVEN the same batches and quantizer spec in both packages
    _, shape, jgran, perm = case
    symmetric = "weight" in case[0]
    jquant, tquant = _quantizers(jgran, perm, symmetric)
    if kind == "running":
        jstep, tstep = jmm.RunningMinMaxEstimatorStep(jquant), tmm.RunningMinMaxEstimatorStep(tquant)
    else:
        jstep = jmm.SmoothedMinMaxEstimatorStep(jquant, gamma=0.7)
        tstep = tmm.SmoothedMinMaxEstimatorStep(tquant, gamma=0.7)
    # WHEN each step observes them
    for b in _batches(shape):
        jstep.estimate_step(jnp.asarray(b))
        tstep.estimate_step(torch.from_numpy(b.transpose(perm).copy()))
    # THEN the per-tile ranges are bit-equal, and so are the parameters to
    # the jitted JAX function's
    for jv, tv in ((jstep._min, tstep._min), (jstep._max, tstep._max)):
        np.testing.assert_array_equal(tv.numpy(), _in_torch_order(jv, jgran, shape, perm))
    _check_params(jquant, tquant, jgran, shape, perm, symmetric, (jstep._min, jstep._max))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_min_error_step_picks_jax_candidates(case):
    _, shape, jgran, perm = case
    symmetric = "weight" in case[0]
    jquant, tquant = _quantizers(jgran, perm, symmetric)
    jstep = jme.MinErrorEstimatorStep(jquant, num_candidates=40)
    tstep = tme.MinErrorEstimatorStep(tquant, num_candidates=40)
    for b in _batches(shape, n=2, seed=1):
        jstep.estimate_step(jnp.asarray(b))
        tstep.estimate_step(torch.from_numpy(b.transpose(perm).copy()))
    jf, tf = np.asarray(jstep.fractions), tstep.fractions.numpy()
    assert np.all(np.abs(tf - jf) <= ULP * jf)
    jerr = np.stack([_in_torch_order(e, jgran, shape, perm) for e in np.asarray(jstep._errors)])
    np.testing.assert_allclose(tstep._errors.numpy(), jerr, rtol=MINERR_TABLE_RTOL, atol=0)
    np.testing.assert_array_equal(tstep._errors.argmin(0).numpy(), jerr.argmin(0))
    jstep.finalize()
    tstep.finalize()
    np.testing.assert_allclose(tquant.scale.detach().numpy(),
                               _in_torch_order(jquant.scale.value, jgran, shape, perm),
                               rtol=MINERR_RTOL)


# --- estimate_ranges on a model -----------------------------------------------


class JMLP(nnx.Module):
    def __init__(self, *, rngs):
        self.fc1 = nnx.Linear(8, 16, rngs=rngs)
        self.fc2 = nnx.Linear(16, 4, rngs=rngs)

    def __call__(self, x):
        h = self.fc1(x)
        return self.fc2(h.dequantize() if isinstance(h, jq.QuantizedArray) else h)


class TMLP(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = torch.nn.Linear(8, 16)
        self.fc2 = torch.nn.Linear(16, 4)

    def forward(self, x):
        from fastforward_tpu_torch.quantization import dequantize_if_quantized

        return self.fc2(dequantize_if_quantized(self.fc1(x)))


def _configured_models():
    j, t = JMLP(rngs=nnx.Rngs(0)), TMLP()
    params = {"/".join(str(p) for p in path): np.asarray(v[...])
              for path, v in nnx.to_flat_state(nnx.state(j, nnx.Param))}
    convert.load_nnx_params(t, params)
    jnn.quantize_model(j)
    tnn.quantize_model(t)
    for cfg, pkg, gran in ((JConfig(), jnn, jq.PerChannel(1)),
                           (TConfig(), tnn, convert.transpose_granularity(
                               jq.PerChannel(1), convert.LINEAR_WEIGHT_PERM))):
        cfg.add_rule("**/[quantizer:parameter/weight]", pkg.LinearQuantizer, num_bits=8,
                     symmetric=True, granularity=gran)
        cfg.add_rule("**/[quantizer:activation]", pkg.LinearQuantizer, num_bits=8,
                     symmetric=False)
        cfg.initialize(j if pkg is jnn else t)
    return j, t


@pytest.mark.parametrize("estimator", ["running_minmax", "smoothed_minmax", "min_error_grid"])
def test_estimate_ranges_on_a_model(estimator):
    # GIVEN the same configured two-layer model in both packages
    j, t = _configured_models()
    batches = _batches((16, 8), n=4, seed=2)
    kw = {"num_candidates": 10} if estimator == "min_error_grid" else {}
    # WHEN each calibrates it
    with jflags.strict_quantization(False):
        with jrs.estimate_ranges(j, getattr(jrs, estimator), **kw):
            for b in batches:
                j(jnp.asarray(b))
    with tflags.strict_quantization(False), torch.no_grad():
        with trs.estimate_ranges(t, getattr(trs, estimator), **kw) as est:
            for b in batches:
                t(torch.from_numpy(b))
    assert isinstance(est, trs.RangeEstimator)
    # THEN every quantizer holds JAX's range; no override is left behind
    jqs = dict(jnn.named_quantizers(j))
    for name, tquant in tnn.named_quantizers(t):
        jquant = jqs[name.replace(".", "/")]
        if jquant.is_stub:
            assert tquant.is_stub
            continue
        assert not tquant.has_overrides
        if getattr(jquant, "scale", None) is None:  # bias quantizers: never called
            assert tquant.scale is None
            continue
        symmetric = jquant.symmetric
        if estimator == "min_error_grid":
            np.testing.assert_allclose(tquant.scale.detach().numpy(),
                                       np.asarray(jquant.scale.value).reshape(-1),
                                       rtol=MINERR_RTOL)
        elif name.endswith("weight_quantizer"):
            kernel = getattr(j, name.split(".")[0]).kernel
            _check_params(jquant, tquant, jquant.granularity, tuple(kernel.shape), (1, 0),
                          symmetric, rtol=MODEL_RTOL)
        else:  # per-tensor activations: no tile order
            _check_params(jquant, tquant, jquant.granularity, (1, 1), (0, 1), symmetric,
                          rtol=MODEL_RTOL)
