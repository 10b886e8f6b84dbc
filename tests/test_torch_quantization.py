"""The port's simulation-tier core (`fastforward_tpu_torch/quantization/`)
against the JAX package's (`fastforward_tpu/quantization/`), on the CPU.

Inputs are made from numpy seeds and handed to both packages. The JAX
functions are jitted with ``xla_allow_excess_precision=False``.
Tolerances:
- tiling, granularities, the integer grid, `can_support_bitwidth`: equal;
- `parameters_for_range`: rtol 1e-6 (the JAX tests' own);
- quantize, dequantize and dynamic quantize (grid values, scales,
  offsets), in f32 and bf16, per tensor, per channel, per block and per
  tile, and the `affine_function` constructors over them: bit-equal;
- gradients through `torch.autograd` against `jax.vjp`: the data's
  bit-equal; the scale's and offset's (per-tile sums, summed in another
  order than XLA's) within GRAD_RTOL of the largest |gradient|;
- straight-through estimators: forward bit-equal, gradient the identity;
- `random_quantized` (no bits shared across generators): shape, dtypes,
  grid range and ``dequantize`` equal to JAX's formula on the port's data;
- `QuantizedTensor`'s Python operators against the jitted JAX
  `QuantizedArray`'s: grid results bit-equal, float results within 8 f32
  ulps of the largest (jitted XLA fuses the dequantize product into a
  following sum).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastforward_tpu import flags as jflags
from fastforward_tpu import quantization as jq
from fastforward_tpu.exceptions import QuantizationError as JQuantizationError
from fastforward_tpu.quantization import affine as ja
from fastforward_tpu.quantization.ste import round_ste as jround_ste
from fastforward_tpu.quantization.ste import ste as jste
from fastforward_tpu.quantization import tiling as jt
from fastforward_tpu_torch import flags as tflags
from fastforward_tpu_torch import quantization as tq
from fastforward_tpu_torch.exceptions import QuantizationError
from fastforward_tpu_torch.quantization import affine as ta
from fastforward_tpu_torch.quantization.ste import round_ste as tround_ste
from fastforward_tpu_torch.quantization.ste import ste as tste
from fastforward_tpu_torch.quantization import tiling as tt
from fastforward_tpu_torch.quantization.random import random_quantized
from fastforward_tpu_torch.quantization.strict_quantization import (
    strict_quantization_for_module,
)

EXACT = {"xla_allow_excess_precision": False}
GRAD_RTOL = 1e-6  # scale and offset gradients: share of the largest |gradient|
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# (data shape, tile, bits): per tensor, per channel (rows), per block along
# rows and along columns, 2-D tiles
TILES = [((32, 48), (32, 48), 8), ((64, 96), (1, 96), 8), ((48, 256), (1, 128), 4),
         ((256, 64), (128, 1), 4), ((64, 96), (16, 32), 4)]


def _jit(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=EXACT)(*args)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy() if a.is_floating_point() else a.numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


def _eq(a, b):
    np.testing.assert_array_equal(_np(a), _np(b))


def _inputs(shape, tile, seed):
    rs = np.random.RandomState(seed)
    n = tt.num_tiles(shape, tile)
    x = (rs.randn(*shape) * 3).astype(np.float32)
    s = (rs.rand(n) * 0.1 + 0.01).astype(np.float32)
    o = (rs.randn(n) * 3).astype(np.float32)
    return x, s, o


# --- tiling and granularities ------------------------------------------------


@pytest.mark.parametrize("shape,tile", [((8, 12), (2, 3)), ((4, 6, 8), (1, 6, 4)),
                                        ((16,), (16,)), ((6, 10), (6, 1))])
def test_tiling_matches_jax(shape, tile):
    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    rows_j = jt.tiles_to_rows(jnp.asarray(x), tile)
    rows_t = tt.tiles_to_rows(torch.from_numpy(x), tile)
    _eq(rows_j, rows_t)
    _eq(jt.rows_to_tiles(rows_j, shape, tile), tt.rows_to_tiles(rows_t, shape, tile))
    for fn in ("interleaved_shape", "tile_grid", "num_tiles"):
        assert getattr(jt, fn)(shape, tile) == getattr(tt, fn)(shape, tile)
    p = np.arange(tt.num_tiles(shape, tile), dtype=np.float32)
    _eq(jt.apply_per_tile(lambda d, q: d * q, jnp.asarray(x), jnp.asarray(p), tile_size=tile),
        tt.apply_per_tile(lambda d, q: d * q, torch.from_numpy(x), torch.from_numpy(p),
                          tile_size=tile))


def test_tiling_errors_match_jax():
    for shape, tile in (((8, 12), (3, 3)), ((8, 12), (8,)), ((8, 12), (5, 5))):
        with pytest.raises(ValueError) as je_:
            jt.check_tile_compatibility(shape, tile)
        with pytest.raises(ValueError) as te_:
            tt.check_tile_compatibility(shape, tile)
        assert str(je_.value) == str(te_.value)
    with pytest.raises(ValueError, match="expected to be of size"):
        tt.rows_to_tiles(torch.zeros(3, 4), (4, 4), (2, 2))
    assert tuple(tt.tiles_to_rows(torch.zeros(0, 3), (1, 3)).shape) == (1, 0)


GRANULARITIES = [
    ("PerTensor", (), {}), ("PerChannel", (0,), {}), ("PerChannel", ((0, 2),), {}),
    ("PerBlock", (-1, 4), {"per_channel_dims": 0}), ("PerBlock", ((1, 2), (2, 4)), {}),
    ("PerBlock", (1, 5), {"strict_blocks": False}), ("PerTile", ((2, 3, 4),), {}),
]


@pytest.mark.parametrize("name,args,kw", GRANULARITIES)
def test_granularity_matches_jax(name, args, kw):
    shape = (4, 6, 8)
    jg, tg = getattr(jq, name)(*args, **kw), getattr(tq, name)(*args, **kw)
    assert jg.tile_size(shape) == tg.tile_size(shape)
    assert jg.parameter_dimensionality(shape) == tg.parameter_dimensionality(shape)
    assert repr(jg) == repr(tg)
    assert tg == getattr(tq, name)(*args, **kw) and hash(tg) == hash(getattr(tq, name)(*args, **kw))
    for pred in ("is_per_tensor", "is_per_channel", "is_per_block"):
        assert getattr(jq.granularity, pred)(jg) == getattr(tq.granularity, pred)(tg)
    tile = tg.tile_size(shape)
    if tile != "data_shape":
        assert repr(jq.granularity_from_sizes(shape, tile)) == \
            repr(tq.granularity_from_sizes(shape, tile))


def test_granularity_errors_match_jax():
    for make, shape in ((lambda m: m.PerBlock(1, 4), (4, 6)), (lambda m: m.PerBlock(1, 8), (4, 6)),
                        (lambda m: m.PerTile((3, 3)), (4, 6))):
        with pytest.raises(ValueError) as je_:
            make(jq).tile_size(shape)
        with pytest.raises(ValueError) as te_:
            make(tq).tile_size(shape)
        assert str(je_.value) == str(te_.value)
    with pytest.raises(ValueError, match="equal length"):
        tq.PerBlock((0, 1), 4)
    assert tq.PerChannel(0) != tq.PerTile((1, 6)) and tq.PerTensor() == tq.PerTensor()


# --- the integer grid and the range math -------------------------------------


def test_grid_and_bitwidth_match_jax():
    for bits in (2, 4, 8, 16):
        assert ja.integer_minimum(bits) == ta.integer_minimum(bits)
        assert ja.integer_maximum(bits) == ta.integer_maximum(bits)
        assert ja.quantization_range(0.5, 3.0, bits) == ta.quantization_range(0.5, 3.0, bits)
        for jd, td in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16),
                       (jnp.float16, torch.float16), (jnp.int8, torch.int8),
                       (jnp.int16, torch.int16), (jnp.int32, torch.int32)):
            assert ja.can_support_bitwidth(jd, bits) == ta.can_support_bitwidth(td, bits)


@pytest.mark.parametrize("symmetric,one_sided", [(False, True), (True, False), (True, True)])
@pytest.mark.parametrize("bits", [4, 8])
def test_parameters_for_range_matches_jax(symmetric, one_sided, bits):
    rs = np.random.RandomState(bits)
    for lo in (-rs.rand(16) * 4, rs.rand(16)):  # a two-sided and a non-negative range
        mn = lo.astype(np.float32)
        mx = (mn + rs.rand(16) * 5 + 0.1).astype(np.float32)
        # jitted, as the dynamic quantizer computes it: traced, the JAX
        # function gives a zero offset where it gives None eagerly
        js, jo = _jit(lambda a, b: ja.parameters_for_range(a, b, bits, symmetric, one_sided),
                      jnp.asarray(mn), jnp.asarray(mx))
        ts, to = ta.parameters_for_range(torch.from_numpy(mn), torch.from_numpy(mx), bits,
                                         symmetric, one_sided)
        np.testing.assert_allclose(_np(ts), _np(js), rtol=1e-6)
        if to is None:
            assert symmetric and not (one_sided and mn.min() >= 0)
            np.testing.assert_array_equal(_np(jo), 0)
        else:
            np.testing.assert_allclose(_np(to), _np(jo), rtol=1e-6)


# --- quantize, dequantize and dynamic quantize: bit-equal forwards ------------


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,tile,bits", TILES)
def test_quantize_dequantize_bit_equal(dtype, shape, tile, bits):
    jd, td = DTYPES[dtype]
    x, s, o = _inputs(shape, tile, seed=bits + len(shape))
    qj = _jit(lambda d, s, o: ja.quantize_by_tile(d, s, o, tile_size=tile, num_bits=bits),
              jnp.asarray(x).astype(jd), jnp.asarray(s), jnp.asarray(o))
    qt = ta.quantize_by_tile(torch.from_numpy(x).to(td), torch.from_numpy(s), torch.from_numpy(o),
                             tile_size=tile, num_bits=bits)
    assert qt.dtype == td
    _eq(qj, qt)
    # dequantized in the scale's dtype (f32), and to an int8 grid and back
    _eq(_jit(lambda q, s, o: ja.dequantize_by_tile(q, s, o, tile_size=tile), qj, jnp.asarray(s),
             jnp.asarray(o)),
        ta.dequantize_by_tile(qt, torch.from_numpy(s), torch.from_numpy(o), tile_size=tile))
    q8 = ta.quantize_by_tile(torch.from_numpy(x).to(td), torch.from_numpy(s), None,
                             tile_size=tile, num_bits=bits, output_dtype=torch.int8)
    assert q8.dtype == torch.int8
    _eq(_jit(lambda d, s: ja.quantize_by_tile(d, s, tile_size=tile, num_bits=bits,
                                              output_dtype=jnp.int8),
             jnp.asarray(x).astype(jd), jnp.asarray(s)), q8)
    _eq(_jit(lambda q, s: ja.dequantize_by_tile(q, s, tile_size=tile, output_dtype=jd),
             jnp.asarray(_np(q8)), jnp.asarray(s)),
        ta.dequantize_by_tile(q8, torch.from_numpy(s), tile_size=tile, output_dtype=td))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("symmetric,one_sided", [(False, True), (True, False), (True, True)])
@pytest.mark.parametrize("shape,tile,bits", TILES[:4])
def test_quantize_dynamic_bit_equal(dtype, symmetric, one_sided, shape, tile, bits):
    jd, td = DTYPES[dtype]
    x = _inputs(shape, tile, seed=7)[0]
    if one_sided:
        x = np.abs(x)  # a non-negative tensor takes the one-sided grid
    yj = _jit(lambda d: ja.quantize_dynamic_by_tile(d, tile_size=tile, num_bits=bits,
                                                    symmetric=symmetric,
                                                    allow_one_sided=one_sided),
              jnp.asarray(x).astype(jd))
    yt = ta.quantize_dynamic_by_tile(torch.from_numpy(x).to(td), tile_size=tile, num_bits=bits,
                                     symmetric=symmetric, allow_one_sided=one_sided)
    for a, b in zip(yj, yt):  # grid values, scales, offsets
        assert b.dtype == td
        _eq(a, b)


def test_quantize_errors_match_jax():
    x = torch.zeros(4, 8)
    with pytest.raises(QuantizationError, match="not enough to store 16 bits"):
        ta.quantize_by_tile(x, 0.1, num_bits=16, output_dtype=torch.int8)
    with pytest.raises(QuantizationError, match="empty tensor"):
        ta.quantize_dynamic_by_tile(torch.zeros(0, 4))
    with pytest.raises(ValueError) as te_:
        ta.quantize_by_tile(x, torch.ones(3), tile_size=(1, 8))
    with pytest.raises(ValueError) as je_:
        ja.quantize_by_tile(jnp.zeros((4, 8)), jnp.ones(3), tile_size=(1, 8))
    assert str(te_.value) == str(je_.value)


# --- gradients: torch.autograd against jax.vjp -------------------------------


def _close_to_largest(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= GRAD_RTOL * max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,tile,bits", TILES)
def test_quantize_gradients_match_jax(dtype, shape, tile, bits):
    jd, td = DTYPES[dtype]
    x, s, o = _inputs(shape, tile, seed=11 + bits)
    g = np.random.RandomState(12).randn(*shape).astype(np.float32)

    def vjp(d, s, o, g):
        out, back = jax.vjp(lambda d, s, o: ja.quantize_by_tile(d, s, o, tile_size=tile,
                                                                num_bits=bits), d, s, o)
        return back(g.astype(out.dtype))

    want = _jit(vjp, *(jnp.asarray(a).astype(jd) for a in (x, s, o)), jnp.asarray(g))
    xt, st, ot = (torch.from_numpy(a).to(td).requires_grad_() for a in (x, s, o))
    q = ta.quantize_by_tile(xt, st, ot, tile_size=tile, num_bits=bits)
    q.backward(torch.from_numpy(g).to(q.dtype))
    _eq(want[0], xt.grad)  # clipped STE: bit-equal
    assert st.grad.dtype == ot.grad.dtype == td
    _close_to_largest(st.grad, want[1])  # LSQ scale gradient, summed per tile
    _close_to_largest(ot.grad, want[2])
    # some values were clipped (the data gradient has zeros) and some not
    assert 0 < int((xt.grad == 0).sum()) < xt.numel()


def test_dequantize_and_dynamic_gradients_match_jax():
    shape, tile = (48, 64), (1, 64)
    x, s, o = _inputs(shape, tile, seed=13)
    g = np.random.RandomState(14).randn(*shape).astype(np.float32)
    q = np.round(x * 10).astype(np.float32)

    def deq(q, s, o, g):
        _, back = jax.vjp(lambda q, s, o: ja.dequantize_by_tile(q, s, o, tile_size=tile), q, s, o)
        return back(g)

    want = _jit(deq, *(jnp.asarray(a) for a in (q, s, o, g)))
    qt, st, ot = (torch.from_numpy(a).requires_grad_() for a in (q, s, o))
    ta.dequantize_by_tile(qt, st, ot, tile_size=tile).backward(torch.from_numpy(g))
    for a, b in zip(want, (qt.grad, st.grad, ot.grad)):  # identity; zeros for the parameters
        _eq(a, b)

    def dyn(d, g):
        out, back = jax.vjp(lambda d: ja.quantize_dynamic_by_tile(d, tile_size=tile)[0], d)
        return back(g)

    xt = torch.from_numpy(x).requires_grad_()
    yt, st2, ot2 = ta.quantize_dynamic_by_tile(xt, tile_size=tile)
    assert not st2.requires_grad and not ot2.requires_grad
    yt.backward(torch.from_numpy(g))
    _eq(_jit(dyn, jnp.asarray(x), jnp.asarray(g))[0], xt.grad)  # straight through


def test_ste_matches_jax():
    x = (np.random.RandomState(15).randn(64) * 4).astype(np.float32)
    _eq(_jit(jround_ste, jnp.asarray(x)), tround_ste(torch.from_numpy(x)))
    clip = tste(lambda d, lo: torch.clamp(d, min=lo))
    xt = torch.from_numpy(x).requires_grad_()
    y = clip(xt, 0.5)
    _eq(_jit(lambda d: jste(lambda a, lo: jnp.clip(a, lo))(d, 0.5), jnp.asarray(x)), y)
    y.sum().backward()
    assert torch.equal(xt.grad, torch.ones_like(xt)) and clip.__name__ == "<lambda>_ste"
    xt.grad = None
    tround_ste(xt).sum().backward()
    assert torch.equal(xt.grad, torch.ones_like(xt))


# --- affine_function, QuantizedTensor, the function framework ----------------


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_affine_function_constructors_match_jax(dtype):
    jd, td = DTYPES[dtype]
    rs = np.random.RandomState(16)
    x = (rs.randn(8, 32) * 2).astype(np.float32)
    xj, xt = jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)
    s8, s_blk = (rs.rand(8) * 0.05 + 0.01).astype(np.float32), \
        (rs.rand(32) * 0.5 + 0.1).astype(np.float32)
    o8 = rs.randn(8).astype(np.float32)
    cases = [
        ("quantize_per_tensor", (0.03,), (0.03,), {}),
        ("quantize_per_channel", (0, jnp.asarray(s8), jnp.asarray(o8)),
         (0, torch.from_numpy(s8), torch.from_numpy(o8)), {"num_bits": 4}),
        ("quantize_by_tile_array", ((1, 32), jnp.asarray(s8)), ((1, 32), torch.from_numpy(s8)),
         {}),
        ("quantize_per_block", (1, 8, jnp.asarray(s_blk)), (1, 8, torch.from_numpy(s_blk)),
         {"per_channel_dims": 0, "num_bits": 4}),
    ]
    def both(qa):  # grid values and reals, jitted
        return qa.raw_data, qa.dequantize()

    for name, jargs, targs, kw in cases:
        want = _jit(lambda d, name=name, jargs=jargs, kw=kw: both(
            getattr(jq, name)(d, *jargs, **kw)), xj)
        qt = getattr(tq, name)(xt, *targs, **kw)
        assert isinstance(qt, tq.QuantizedTensor)
        _eq(want[0], qt.raw_data)
        _eq(want[1], qt.dequantize())
        assert qt.dtype == td and qt.shape == (8, 32) and qt.ndim == 2 and qt.size == 256
    for sym in (False, True):
        gran = tq.PerChannel(0)
        want = _jit(lambda d, sym=sym: both(jq.quantize_dynamically(
            d, jq.PerChannel(0), num_bits=8, symmetric=sym)), xj)
        qt = tq.quantize_dynamically(xt, gran, num_bits=8, symmetric=sym)
        _eq(want[0], qt.raw_data)
        _eq(want[1], qt.dequantize())
        args = qt.quant_args()
        assert isinstance(args, tq.StaticAffineQuantParams) and args.granularity == gran
        assert args.dequantize_dtype == td


def test_quantized_tensor_api_and_strict_conversion():
    x = torch.linspace(-1, 1, 24).reshape(4, 6)
    qt = tq.quantize_per_tensor(x, 0.01, num_bits=8, quantized_dtype=torch.int8)
    assert qt.quantized_dtype == torch.int8 and qt.dtype == torch.float32
    assert torch.equal(qt.raw_data, torch.clamp(torch.round(x / 0.01), -128, 127).to(torch.int8))
    assert "num_bits=8" in repr(qt) and tq.is_quantized(qt) and not tq.is_quantized(x)
    assert torch.equal(tq.dequantize_if_quantized(qt), qt.dequantize())
    assert torch.equal(tq.apply_quantized(lambda a, b: a + b, qt, b=1.0), qt.dequantize() + 1.0)
    assert qt.with_data(qt.raw_data).quant_args() is qt.quant_args()
    # implicit conversion: refused under strict quantization, else dequantized
    with pytest.raises(QuantizationError, match="implicitly dequantize"):
        np.asarray(qt)
    with tflags.strict_quantization(False):
        np.testing.assert_array_equal(np.asarray(qt), qt.dequantize().numpy())
    with jflags.strict_quantization(True), pytest.raises(JQuantizationError):
        jnp.asarray(jq.quantize_per_tensor(jnp.asarray(x.numpy()), 0.01))
    # the Python operators run the quantized operators of ops/, as JAX's
    # do, the reflected ones with the operands in their written order
    qa = jq.quantize_per_tensor(jnp.asarray(x.numpy()), 0.01, num_bits=8,
                                quantized_dtype=jnp.int8)
    xt = jnp.asarray(x.numpy().T)
    ops_ = (lambda a, m: a + 1, lambda a, m: 1 - a, lambda a, m: a - 1, lambda a, m: a * 2,
            lambda a, m: 2 * a, lambda a, m: a / 2, lambda a, m: a @ m, lambda a, m: -a)
    with tflags.strict_quantization(False), jflags.strict_quantization(False):
        want = _jit(lambda a, m: [op(a, m) for op in ops_], qa, xt)
        for op, w in zip(ops_, want):
            got = op(qt, x.T)
            if isinstance(w, jq.QuantizedArray):
                assert isinstance(got, tq.QuantizedTensor)
                _eq(w.raw_data, got.raw_data)
                _eq(_jit(lambda a: a.dequantize(), w), got.dequantize())
            else:  # jitted XLA fuses the dequantize product into the sum: 8 ulps
                np.testing.assert_allclose(_np(got), _np(w), rtol=0,
                                           atol=8 * 2.0 ** -23 * float(np.abs(_np(w)).max()))
        assert not torch.equal(1 - qt, qt - 1)
    with pytest.raises(QuantizationError):
        _ = 1 - qt  # a dense result needs an output quantizer under strict quantization
    # re-quantization moves a QuantizedTensor onto the new grid via its reals
    again = tq.quantize_per_tensor(qt, 0.02)
    assert torch.equal(again.raw_data, tq.quantize_per_tensor(qt.dequantize(), 0.02).raw_data)
    # export mode: the QDQ plain tensor
    with tflags.export_mode(True):
        plain = tq.quantize_per_tensor(x, 0.01)
    assert isinstance(plain, torch.Tensor) and torch.equal(plain, qt.dequantize())
    ctx = tq.dynamic_quantization_context(num_bits=8)
    with pytest.raises(TypeError, match="dynamic parameters"):
        ctx.dequantize(x)


def test_create_quantization_function_matches_jax():
    def jquant(data, scale, num_bits=8):
        return jnp.clip(jnp.round(data / scale), -(2 ** (num_bits - 1)), 2 ** (num_bits - 1) - 1)

    def tquant(data, scale, num_bits=8):
        return torch.clamp(torch.round(data / scale), -(2 ** (num_bits - 1)),
                           2 ** (num_bits - 1) - 1)

    jfn = jq.create_quantization_function("Simple", jquant, lambda data, scale, num_bits=8:
                                          data * scale, static_params=("num_bits",))
    tfn = tq.create_quantization_function("Simple", tquant, lambda data, scale, num_bits=8:
                                          data * scale, static_params=("num_bits",))
    x = np.random.RandomState(17).randn(5, 7).astype(np.float32)
    qa = jfn.quantize(jnp.asarray(x), jfn.Params(scale=jnp.float32(0.1), num_bits=4))
    qt = tfn.quantize(torch.from_numpy(x), tfn.Params(scale=torch.tensor(0.1), num_bits=4))
    _eq(qa.raw_data, qt.raw_data)
    _eq(qa.dequantize(), qt.dequantize())
    assert tfn.__name__ == "Simple" and [f.name for f in tfn.Params.__dataclass_fields__.values()] \
        == ["scale", "num_bits"]
    assert tfn.Params.__dataclass_fields__["num_bits"].metadata["static"]
    moved = qt.quant_args()._apply(lambda t: t * 2)
    assert float(moved.scale) == pytest.approx(0.2) and moved.num_bits == 4


def test_random_quantized():
    gen = torch.Generator().manual_seed(3)
    for gran, bits, offset in ((None, 8, None), (tq.PerChannel(0), 4, 2.0)):
        qt = random_quantized((6, 16), generator=gen, num_bits=bits, granularity=gran,
                              scale=0.05, offset=offset, device="cpu")
        raw = qt.raw_data
        assert qt.shape == (6, 16) and raw.dtype == torch.float32 and qt.dtype == torch.float32
        assert raw.min() >= ta.integer_minimum(bits) and raw.max() <= ta.integer_maximum(bits)
        assert torch.equal(raw, torch.round(raw))
        n = (gran or tq.PerTensor()).parameter_dimensionality((6, 16))
        assert qt.quant_args().scale.shape == (n,)
        # dequantize is JAX's formula, (q + round(offset)) * scale, on the port's data
        want = ja.dequantize_by_tile(jnp.asarray(raw.numpy()), jnp.full((n,), 0.05, jnp.float32),
                                     None if offset is None else jnp.full((n,), offset),
                                     tile_size=(gran or jq.PerTensor()).tile_size((6, 16)))
        _eq(want, qt.dequantize())


def test_strict_quantization_for_module():
    seen = []

    class Probe(torch.nn.Module):
        def forward(self, x, fail=False):
            seen.append(tflags.get_strict_quantization())
            if fail:
                raise RuntimeError("inner")
            return x

    m = Probe()
    with strict_quantization_for_module(m, False):
        m(1)
        with tflags.strict_quantization(True):
            m(2)  # the module's own value, whatever the context
        with pytest.raises(RuntimeError):
            m(3, fail=True)
        assert tflags.get_strict_quantization()  # restored after a raising forward
    m(4)  # hooks removed
    assert seen == [False, False, False, True]
