"""The port's `nn/` (quantizers, `quantize_model` on `torch.nn` layers, the
quantized layers), `quantization/freeze.py`, `overrides.py` and
`quantization/quantizer_annotations.py` against the JAX package's on flax
NNX, on the CPU.

Each NNX model is built from a seed, converted with the JAX
`quantize_model`, given `LinearQuantizer`s (ranges set by hand from its
weights), and its parameters carried into the converted torch model by
`fastforward_tpu_torch.nn.convert.load_nnx_params` (kernels transposed to
torch's layouts, quantizer scales reordered into torch's tile order). The
port's quantizers are configured from the same spec through
`transpose_granularity`. The JAX forwards are jitted with
``xla_allow_excess_precision=False``.

Tolerances: quantized outputs (grid values and their dequantized values),
the W8A8 registration's output and frozen parameters bit-equal; float
outputs within ULPS f32 ulps of the largest |JAX output|; quantizer
names, summaries and operator annotations equal (NNX paths mapped to
torch's: ``layers/0/weight_quantizer`` is ``0.weight_quantizer``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import fastforward_tpu.kernels  # noqa: F401  (the JAX W8A8 registration)
import fastforward_tpu_torch.kernels  # noqa: F401  (the port's)
from fastforward_tpu import flags as jflags
from fastforward_tpu import nn as jnn
from fastforward_tpu import overrides as joverrides
from fastforward_tpu import quantization as jq
from fastforward_tpu.quantization import freeze as jfreeze
from fastforward_tpu.quantization import quantizer_annotations as jannot
from fastforward_tpu.quantization import tiling as jtiling
from fastforward_tpu_torch import flags as tflags
from fastforward_tpu_torch import nn as tnn
from fastforward_tpu_torch import overrides as toverrides
from fastforward_tpu_torch.exceptions import QuantizationError
from fastforward_tpu_torch.kernels import matmul as tmm
from fastforward_tpu_torch.nn import convert
from fastforward_tpu_torch.quantization import QuantizedTensor
from fastforward_tpu_torch.quantization import freeze as tfreeze
from fastforward_tpu_torch.quantization import quantizer_annotations as tannot

EXACT = {"xla_allow_excess_precision": False}
ULPS = 8


def _jit(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=EXACT)(*args)


def _np(a):
    if isinstance(a, torch.Tensor):
        a = a.detach()
        return a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


def _close(port, want, what=""):
    p, w = _np(port), _np(want)
    assert p.shape == w.shape, (what, p.shape, w.shape)
    err = float(np.abs(p.astype(np.float64) - w.astype(np.float64)).max())
    assert err <= ULPS * 2.0 ** -23 * float(np.abs(w).max()), (what, err)


def _flat(model) -> dict:
    """An NNX model's parameters as numpy arrays by ``/``-joined path."""
    return {"/".join(str(p) for p in path): np.asarray(v[...])
            for path, v in nnx.to_flat_state(nnx.state(model, nnx.Param))}


def _jforward(model, x):
    """The NNX model's jitted forward: (grid values, dequantized) for a
    quantized output, else the array."""
    graphdef, state = nnx.split(model)

    def f(state, x):
        y = nnx.merge(graphdef, state)(x)
        return (y.raw_data, y.dequantize()) if isinstance(y, jq.QuantizedArray) else y

    return _jit(f, state, x)


def _tforward(model, x):
    with torch.no_grad():
        y = model(x)
    return (y.raw_data, y.dequantize()) if isinstance(y, QuantizedTensor) else y


def _tile_range(arr, gran):
    """Per-tile (min, max) of a JAX-layout array, flat in tile order."""
    arr = np.asarray(arr)
    tile = gran.tile_size(arr.shape)
    if isinstance(tile, str):
        return arr.min(), arr.max()
    tiled = arr.reshape(jtiling.interleaved_shape(arr.shape, tile))
    axes = tuple(range(1, tiled.ndim, 2))
    return tiled.min(axes).reshape(-1), tiled.max(axes).reshape(-1)


def _install(jlayer, tlayer, slot, bits, jgran, rng, perm, symmetric=True, int8=False):
    """The same LinearQuantizer on both layers' ``slot``: the JAX one's range
    set from ``rng`` (a (min, max) pair, or an array to take per-tile
    extremes of), the port's from the same spec on torch's layout (its
    scale and offset come with `load_nnx_params`)."""
    jquant = jnn.LinearQuantizer(bits, granularity=jgran, symmetric=symmetric,
                                 quantized_dtype=jnp.int8 if int8 else None)
    jquant.quantization_range = _tile_range(rng, jgran) if isinstance(rng, np.ndarray) else rng
    setattr(jlayer, slot, jquant)
    setattr(tlayer, slot, tnn.LinearQuantizer(
        bits, granularity=convert.transpose_granularity(jgran, perm), symmetric=symmetric,
        quantized_dtype=torch.int8 if int8 else None))


def _linear():
    return torch.nn.Linear(16, 8), nnx.Linear(16, 8, rngs=nnx.Rngs(0))


def _pair(kind):
    """(torch model, NNX model, x in torch layout, x to JAX, output from
    JAX, quantizer setup(jmodel, tmodel))."""
    rs = np.random.RandomState(sum(map(ord, kind)))
    ident = lambda a: a  # noqa: E731
    act = ((-3.0, 3.0), jq.PerTensor())
    if kind in ("linear", "linear_w8a8"):
        t, j = _linear()
        x = (rs.randn(4, 16) * 1.5).astype(np.float32)

        def setup(jm, tm):
            k = np.asarray(jm.kernel[...])
            if kind == "linear_w8a8":
                _install(jm, tm, "weight_quantizer", 8, jq.PerChannel(1), k,
                         convert.LINEAR_WEIGHT_PERM, int8=True)
                return
            _install(jm, tm, "input_quantizer", 8, act[1], act[0], (0, 1), symmetric=False)
            _install(jm, tm, "weight_quantizer", 4, jq.PerBlock(0, 8, 1), k,
                     convert.LINEAR_WEIGHT_PERM)
            _install(jm, tm, "bias_quantizer", 8, jq.PerTensor(), (-2.0, 2.0), (0,))
            _install(jm, tm, "output_quantizer", 8, jq.PerTensor(), (-4.0, 4.0), (0, 1),
                     symmetric=False)
        return t, j, x, ident, ident, setup
    if kind.startswith("conv"):
        nd = int(kind[4])
        ks = (3,) * nd
        t = {1: torch.nn.Conv1d, 2: torch.nn.Conv2d, 3: torch.nn.Conv3d}[nd](3, 4, 3, padding=1)
        j = nnx.Conv(3, 4, ks, padding=1, rngs=nnx.Rngs(nd))
        x = rs.randn(2, 3, *((5,) * nd)).astype(np.float32)

        def setup(jm, tm):
            k = np.asarray(jm.kernel[...])
            _install(jm, tm, "input_quantizer", 8, act[1], act[0], convert.channels_last_perm(
                nd + 2), symmetric=False)
            _install(jm, tm, "weight_quantizer", 8, jq.PerChannel(nd + 1), k,
                     convert.conv_weight_perm(nd))
            _install(jm, tm, "output_quantizer", 8, jq.PerTensor(), (-4.0, 4.0),
                     convert.channels_last_perm(nd + 2), symmetric=False)
        return t, j, x, lambda a: np.moveaxis(a, 1, -1), lambda a: np.moveaxis(a, -1, 1), setup
    if kind == "embed":
        t, j = torch.nn.Embedding(10, 8), nnx.Embed(10, 8, rngs=nnx.Rngs(3))
        x = rs.randint(0, 10, (3, 5)).astype(np.int64)

        def setup(jm, tm):
            table = np.asarray(jm.embedding[...])
            _install(jm, tm, "weight_quantizer", 8, jq.PerChannel(1), table, (0, 1))
            _install(jm, tm, "output_quantizer", 8, jq.PerTensor(), (-1.0, 1.0), (0, 1, 2))
        return t, j, x, lambda a: a.astype(np.int32), ident, setup
    if kind in ("layer_norm", "rms_norm"):
        if kind == "layer_norm":
            t, j = torch.nn.LayerNorm(16, eps=1e-6), nnx.LayerNorm(16, rngs=nnx.Rngs(4))
        else:
            t, j = torch.nn.RMSNorm(16, eps=1e-6), nnx.RMSNorm(16, rngs=nnx.Rngs(4))
        x = (rs.randn(4, 16) * 2 + 0.5).astype(np.float32)

        def setup(jm, tm):
            jm.scale[...] = jnp.asarray(rs.rand(16).astype(np.float32) + 0.5)
            _install(jm, tm, "input_quantizer", 8, act[1], act[0], (0, 1), symmetric=False)
            _install(jm, tm, "weight_quantizer", 8, jq.PerTensor(), (0.0, 2.0), (0,),
                     symmetric=False)
            if kind == "layer_norm":
                jm.bias[...] = jnp.asarray(rs.randn(16).astype(np.float32) * 0.1)
                _install(jm, tm, "bias_quantizer", 8, jq.PerTensor(), (-0.5, 0.5), (0,))
            _install(jm, tm, "output_quantizer", 8, jq.PerTensor(), (-4.0, 4.0), (0, 1))
        return t, j, x, ident, ident, setup
    if kind == "einsum":
        t = tnn.Einsum("bi,io->bo", (16, 8), (8,))
        j = nnx.Einsum("bi,io->bo", (16, 8), (8,), rngs=nnx.Rngs(5))
        x = rs.randn(4, 16).astype(np.float32)

        def setup(jm, tm):
            jm.bias[...] = jnp.asarray(rs.randn(8).astype(np.float32) * 0.1)
            k = np.asarray(jm.kernel[...])
            _install(jm, tm, "input_quantizer", 8, act[1], act[0], (0, 1), symmetric=False)
            _install(jm, tm, "weight_quantizer", 4, jq.PerBlock(0, 4, 1), k, (0, 1))
            _install(jm, tm, "bias_quantizer", 8, jq.PerTensor(), (-1.0, 1.0), (0,))
            _install(jm, tm, "output_quantizer", 8, jq.PerTensor(), (-4.0, 4.0), (0, 1))
        return t, j, x, ident, ident, setup
    if kind in ("sequential_relu", "sequential_silu", "sequential_dropout"):
        act_t = {"relu": torch.nn.ReLU(), "silu": torch.nn.SiLU(),
                 "dropout": torch.nn.Dropout(0.5)}[kind.split("_")[1]]
        act_j = {"relu": jnn.QuantizedRelu(), "silu": jnn.QuantizedSilu(),
                 "dropout": nnx.Dropout(0.5, deterministic=True)}[kind.split("_")[1]]
        t = torch.nn.Sequential(torch.nn.Linear(16, 8), act_t, torch.nn.Linear(8, 4)).eval()
        j = nnx.Sequential(nnx.Linear(16, 8, rngs=nnx.Rngs(6)), act_j,
                           nnx.Linear(8, 4, rngs=nnx.Rngs(7)))
        x = rs.randn(4, 16).astype(np.float32)

        def setup(jm, tm):
            for i in (0, 2):
                jl, tl = jm.layers[i], tm[i]
                _install(jl, tl, "input_quantizer", 8, act[1], act[0], (0, 1), symmetric=False)
                _install(jl, tl, "weight_quantizer", 8, jq.PerChannel(1),
                         np.asarray(jl.kernel[...]), convert.LINEAR_WEIGHT_PERM)
                _install(jl, tl, "output_quantizer", 8, jq.PerTensor(), (-4.0, 4.0), (0, 1),
                         symmetric=False)
            if not kind.endswith("dropout"):
                _install(jm.layers[1], tm[1], "output_quantizer", 8, jq.PerTensor(), (0.0, 4.0),
                         (0, 1))
        return t, j, x, ident, ident, setup
    raise KeyError(kind)


KINDS = ["linear", "linear_w8a8", "conv1d", "conv2d", "conv3d", "embed", "layer_norm",
         "rms_norm", "einsum", "sequential_relu", "sequential_silu", "sequential_dropout"]


def _converted(kind):
    tmodel, jmodel, x, to_jax, from_jax, setup = _pair(kind)
    jnn.quantize_model(jmodel)
    tnn.quantize_model(tmodel)
    setup(jmodel, tmodel)
    convert.load_nnx_params(tmodel, _flat(jmodel))
    return tmodel, jmodel, x, to_jax, from_jax


@pytest.mark.parametrize("kind", KINDS)
def test_quantized_layer_matches_nnx(kind):
    # GIVEN an NNX layer and its torch counterpart, both converted, with the
    # same quantizers and the NNX parameters carried across
    tmodel, jmodel, x, to_jax, from_jax = _converted(kind)
    expected = {"linear": tnn.QuantizedLinear, "linear_w8a8": tnn.QuantizedLinear,
                "conv1d": tnn.QuantizedConv1d, "conv2d": tnn.QuantizedConv2d,
                "conv3d": tnn.QuantizedConv3d, "embed": tnn.QuantizedEmbed,
                "layer_norm": tnn.QuantizedLayerNorm, "rms_norm": tnn.QuantizedRMSNorm,
                "einsum": tnn.QuantizedEinsum}.get(kind, tnn.QuantizedSequential)
    assert type(tmodel) is expected
    if kind.startswith("sequential"):
        want_act = {"relu": tnn.QuantizedRelu, "silu": tnn.QuantizedSilu,
                    "dropout": tnn.QuantizedDropout}[kind.split("_")[1]]
        assert type(tmodel[1]) is want_act
    # WHEN both run forward under strict quantization
    with jflags.strict_quantization(True):
        want = _jforward(jmodel, jnp.asarray(to_jax(x)))
    with tflags.strict_quantization(True):
        got = _tforward(tmodel, torch.from_numpy(x))
    # THEN their grids are bit-equal (the W8A8 registration's output too)
    if kind == "linear_w8a8":
        np.testing.assert_array_equal(_np(got), from_jax(_np(want)))
        return
    np.testing.assert_array_equal(_np(got[0]), from_jax(_np(want[0])))
    np.testing.assert_array_equal(_np(got[1]), from_jax(_np(want[1])))


def test_w8a8_layer_launches_the_registration_and_freezes_off_it():
    tmodel, jmodel, x, _, _ = _converted("linear_w8a8")
    xt = torch.from_numpy(x)
    calls = []
    real = tmm.matmul_w8a8
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("fastforward_tpu_torch.kernels.dispatch.matmul_w8a8",
                   lambda *a, **k: calls.append(1) or real(*a, **k))
        y = _tforward(tmodel, xt)
        assert len(calls) == 1
        # frozen: the weight baked to its grid, the quantizer bypassed, the
        # dense fallback (strict quantization off: the weight is plain now)
        handles = tfreeze.freeze_parameters(tmodel)
        jfreeze.freeze_parameters(jmodel)
        with tflags.strict_quantization(False):
            y_frozen = _tforward(tmodel, xt)
        assert len(calls) == 1 and len(handles) == 1
    np.testing.assert_array_equal(_np(tmodel.weight), np.asarray(jmodel.kernel[...]).T)
    with jflags.strict_quantization(False):
        want = _jforward(jmodel, jnp.asarray(x))
    _close(y_frozen, want, "frozen")
    assert torch.equal(y_frozen, torch.nn.functional.linear(xt, tmodel.weight, tmodel.bias))
    assert (y_frozen - y).abs().max() > 0  # int8 activations quantized before, not after
    with tflags.strict_quantization(True), pytest.raises(QuantizationError):
        tmodel(xt)
    tfreeze.unfreeze(handles)
    assert not tmodel.weight_quantizer.has_overrides


def _torch_path(path):
    return ".".join(p for p in path.split("/") if p != "layers")


def test_named_quantizers_summaries_and_annotations_match_nnx():
    tmodel, jmodel, x, _, _ = _converted("sequential_relu")
    # named_quantizers: the same slots in the same order
    jnames = [_torch_path(n) for n, _ in jnn.named_quantizers(jmodel)]
    tnames = [n for n, _ in tnn.named_quantizers(tmodel)]
    assert tnames == jnames and len(tnames) == 10
    # summarize_quantizers: the same lines, each granularity in its own layout
    perms = {"weight_quantizer": convert.LINEAR_WEIGHT_PERM}
    want = []
    for line, (_, jquant) in zip(jnn.summarize_quantizers(jmodel).splitlines(),
                                 jnn.named_quantizers(jmodel)):
        name, state = line.split(": ", 1)
        if isinstance(jquant, jnn.LinearQuantizer):
            perm = perms.get(name.split("/")[-1], (0, 1))
            state = state.replace(repr(jquant.granularity),
                                  repr(convert.transpose_granularity(jquant.granularity, perm)))
        want.append(f"{_torch_path(name)}: {state}")
    assert tnn.summarize_quantizers(tmodel).splitlines() == want
    # annotate_operator_metadata: each quantizer tagged with the same operator.
    # Both packages keep the last operator of an earlier annotation run (a
    # JAX-only test in the same process may have left one) and tag a model's
    # first quantizers with it: start both from no operator.
    jannot._LAST_OP.set(None)
    tannot._LAST_OP.set(None)
    jannot.annotate_operator_metadata(jmodel, jnp.asarray(x))
    tannot.annotate_operator_metadata(tmodel, torch.from_numpy(x))
    jtags = {_torch_path(n): getattr(q.quant_metadata, "producing_operator", None)
             for n, q in jnn.named_quantizers(jmodel)}
    ttags = {n: getattr(q.quant_metadata, "producing_operator", None)
             for n, q in tnn.named_quantizers(tmodel)}
    assert ttags == jtags
    assert ttags["0.output_quantizer"] == "linear" and ttags["1.input_quantizer"] == "linear"
    # a quantizer shared by two slots appears at both, once with remove_duplicate
    shared = tnn.QuantizerStub()
    tmodel[0].bias_quantizer = shared
    tmodel[2].bias_quantizer = shared
    assert [n for n, q in tnn.named_quantizers(tmodel) if q is shared] == [
        "0.bias_quantizer", "2.bias_quantizer"]
    assert [n for n, q in tnn.named_quantizers(tmodel, remove_duplicate=True)
            if q is shared] == ["0.bias_quantizer"]


def test_disable_and_enable_quantization_match_nnx():
    tmodel, jmodel, x, _, _ = _converted("sequential_silu")
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    with joverrides.disable_quantization(jmodel):
        j_off = jmodel(xj)
        with joverrides.enable_quantization(jmodel):
            j_on = jmodel(xj)
    with toverrides.disable_quantization(tmodel):
        assert not tflags.get_strict_quantization()
        t_off = _tforward(tmodel, xt)
        with toverrides.enable_quantization(tmodel):
            t_on = _tforward(tmodel, xt)
    assert tflags.get_strict_quantization()
    # disabled: the plain float model (strict quantization off)
    _close(t_off, j_off, "disabled")
    plain = torch.nn.Sequential(torch.nn.Linear(16, 8), torch.nn.SiLU(), torch.nn.Linear(8, 4))
    plain.load_state_dict({k: v for k, v in tmodel.state_dict().items()
                           if "quantizer" not in k})
    assert torch.equal(t_off, plain(xt).detach())
    # re-enabled: the quantized forward's grid
    assert isinstance(t_on[0], torch.Tensor)
    np.testing.assert_array_equal(_np(t_on[0]), np.asarray(j_on.raw_data))
    assert not any(q.has_overrides for _, q in tnn.named_quantizers(tmodel))


def test_quantize_model_conversion_rules():
    # GIVEN a model with a custom container, a ModuleList and a parameter-
    # holding module without counterpart
    class Block(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.proj = torch.nn.Linear(4, 4)
            self.norm = torch.nn.LayerNorm(4)
            self.stack = torch.nn.ModuleList([torch.nn.ReLU(), torch.nn.Dropout(0.1)])

    class Scale(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.ones(4))

    model = Block()
    weight = model.proj.weight
    tnn.quantize_model(model)
    # THEN classes are swapped in place, parameters kept, surrogates made
    assert isinstance(model, tnn.QuantizedModule) and type(model).__name__ == "QuantizedBlock"
    assert isinstance(model.proj, tnn.QuantizedLinear) and model.proj.weight is weight
    assert isinstance(model.stack, tnn.QuantizedModule)
    assert type(model.stack[0]) is tnn.QuantizedRelu
    assert type(model.stack[1]) is tnn.QuantizedDropout
    assert isinstance(model.proj.weight_quantizer, tnn.QuantizerStub)
    assert model.proj.weight_quantizer.quant_metadata.matches_tag("parameter")
    assert tnn.quantized_module_map()[torch.nn.Linear] is tnn.QuantizedLinear
    assert tnn.Einsum in tnn.quantized_module_map()
    with pytest.raises(QuantizationError, match="Scale"):
        tnn.quantize_model(torch.nn.Sequential(Scale()))
    seq = torch.nn.Sequential(Scale(), torch.nn.Linear(4, 4))
    tnn.quantize_model(seq, extra_conversion={Scale: tnn.SKIP_QUANTIZATION})
    assert type(seq[0]) is Scale and type(seq[1]) is tnn.QuantizedLinear
    with tnn.filter_quantized_module_map(lambda base, q: base is not torch.nn.Linear):
        assert torch.nn.Linear not in tnn.quantized_module_map()
        lin = torch.nn.Sequential(torch.nn.Linear(2, 2))
        tnn.quantize_model(lin, allow_surrogates=True, extra_conversion={
            torch.nn.Linear: tnn.SKIP_QUANTIZATION})
        assert type(lin[0]) is torch.nn.Linear
    # a padding mode other than zeros pads through ops.pad first, as torch does
    conv = torch.nn.Conv2d(2, 3, 3, padding=1, padding_mode="reflect")
    xc = torch.randn(1, 2, 5, 5, generator=torch.Generator().manual_seed(0))
    want = conv(xc).detach()
    tnn.quantize_model(conv)
    with tflags.strict_quantization(False), torch.no_grad():
        assert torch.equal(conv(xc), want)
    # a QuantizedRelu built directly has its quantizer slots
    assert [n for n, _ in tnn.QuantizedRelu().named_quantizers()] == ["input_quantizer",
                                                                       "output_quantizer"]
    # stub quantizers under strict quantization: the converted model refuses
    with pytest.raises(QuantizationError):
        model.proj(torch.ones(2, 4))
    with tflags.strict_quantization(False):
        out = model.proj(torch.ones(2, 4))
    assert torch.equal(out, torch.nn.functional.linear(torch.ones(2, 4), weight, model.proj.bias))
    # a QuantizedDropout passes a QuantizedTensor through in eval, dequantizes in training
    qt = tnn.LinearQuantizer(8)
    qt.quantization_range = (-1.0, 1.0)
    q = qt(torch.linspace(-1, 1, 8))
    drop = model.stack[1]
    assert drop.eval()(q) is q
    assert isinstance(drop.train()(q), torch.Tensor)


def test_linear_quantizer_matches_nnx():
    rs = np.random.RandomState(5)
    x = (rs.randn(8, 16) * 2).astype(np.float32)
    for symmetric, lo, hi in ((True, -3.0, 2.0), (False, -3.0, 2.0), (True, 0.5, 2.0)):
        jquant = jnn.LinearQuantizer(8, symmetric=symmetric)
        tquant = tnn.LinearQuantizer(8, symmetric=symmetric)
        assert tquant.has_uninitialized_params
        with pytest.raises(QuantizationError):
            tquant(torch.from_numpy(x))
        jquant.quantization_range = (lo, hi)
        tquant.quantization_range = (lo, hi)
        want = _jit(lambda a, q=jquant: (q(a).raw_data, q(a).dequantize(),
                                         q.quantization_range), jnp.asarray(x))
        got = tquant(torch.from_numpy(x))
        np.testing.assert_array_equal(_np(got.raw_data), np.asarray(want[0]))
        np.testing.assert_array_equal(_np(got.dequantize()), np.asarray(want[1]))
        for a, b in zip(tquant.quantization_range, want[2]):
            np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6)
        assert isinstance(tquant.scale, torch.nn.Parameter)
        one_sided = symmetric and lo >= 0
        assert (tquant.offset is None) == (symmetric and not one_sided)
        if tquant.offset is not None:
            assert tquant.offset.requires_grad == (not one_sided)
        ctx = tquant.operator_for_range(lo, hi, x.shape)
        assert torch.equal(ctx.quantize(torch.from_numpy(x)).raw_data, got.raw_data)
    # the dynamic quantizer: per-call ranges
    jd = jnn.DynamicLinearQuantizer(8, granularity=jq.PerChannel(0))
    td = tnn.DynamicLinearQuantizer(8, granularity=convert.transpose_granularity(
        jq.PerChannel(0), (0, 1)))
    want = _jit(lambda a: (jd(a).raw_data, jd(a).dequantize()), jnp.asarray(x))
    got = td(torch.from_numpy(x))
    np.testing.assert_array_equal(_np(got.raw_data), np.asarray(want[0]))
    np.testing.assert_array_equal(_np(got.dequantize()), np.asarray(want[1]))
    assert "num_bits=8" in tnn.summarize_quantizers(torch.nn.ModuleDict({"q": tquant}))


def test_transpose_granularity_and_tile_reorder():
    from fastforward_tpu_torch.quantization import granularity as tg

    # one spec on the NNX (in, out) kernel, mapped to torch's (out, in)
    assert convert.transpose_granularity(jq.PerChannel(1), (1, 0)) == tg.PerChannel(0)
    assert convert.transpose_granularity(jq.PerChannel(-1), (1, 0)) == tg.PerChannel(0)
    assert convert.transpose_granularity(jq.PerBlock(0, 8, 1), (1, 0)) == tg.PerBlock(1, 8, 0)
    assert convert.transpose_granularity(jq.PerTile((4, 2)), (1, 0)) == tg.PerTile((2, 4))
    assert convert.transpose_granularity(jq.PerChannel(3), convert.conv_weight_perm(2)) == \
        tg.PerChannel(0)
    # the port's quantization of the transposed weight with the reordered
    # scales is the JAX one's, transposed, for every granularity kind
    rs = np.random.RandomState(9)
    k = rs.randn(16, 8).astype(np.float32)
    for jgran in (jq.PerTensor(), jq.PerChannel(1), jq.PerBlock(0, 4, 1), jq.PerTile((4, 2))):
        lo, hi = _tile_range(k, jgran)
        jquant = jnn.LinearQuantizer(4, granularity=jgran, symmetric=False)
        jquant.quantization_range = (lo, hi)
        lin = torch.nn.Linear(16, 8)
        tnn.quantize_model(lin)
        lin.weight_quantizer = tnn.LinearQuantizer(
            4, granularity=convert.transpose_granularity(jgran, (1, 0)), symmetric=False)
        convert.load_nnx_params(lin, {"kernel": k, "weight_quantizer/scale": np.asarray(
            jquant.scale[...]), "weight_quantizer/offset": np.asarray(jquant.offset[...])})
        want = _jit(lambda a: jquant(a).raw_data, jnp.asarray(k))
        got = lin.weight_quantizer(lin.weight)
        np.testing.assert_array_equal(_np(got.raw_data), np.asarray(want).T)
    with pytest.raises(KeyError):
        convert.load_nnx_params(lin, {"gamma": k})
    # an activation quantizer's tiles along two dims: its torch order is unknown
    lin.input_quantizer = tnn.LinearQuantizer(8, granularity=tg.PerTile((2, 4)))
    with pytest.raises(ValueError, match="activation"):
        convert.load_nnx_params(lin, {"input_quantizer/scale": np.ones(8, np.float32)})
