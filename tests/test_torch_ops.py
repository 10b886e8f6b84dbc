"""The port's quantized operators (`fastforward_tpu_torch/ops/`) against the
JAX package's (`fastforward_tpu/ops/`), on the CPU.

Inputs are made from numpy seeds in torch's layouts and handed to the JAX
side transposed at the boundary (a linear weight as its (in, out) kernel,
N, C, spatial... activations channels-last, a convolution weight as its
(*k, in, out) kernel, a transposed convolution's weight flipped along its
window with torch's padding p given to JAX as dilation (k - 1) - p; JAX's
transposed convolution takes the window as it lies and its padding on the
dilated input). The JAX operators are jitted with
``xla_allow_excess_precision=False``, one compile an operator for its
dense and quantized inputs, with and without an output quantizer.

Tolerances:
- grid outputs (an output quantizer's ``raw_data``, every grid-preserving
  registration) and integer results: bit-equal;
- float results: within ULPS f32 ulps (2^-23 each) of the largest |JAX
  output| (the two sides sum, and evaluate exp, tanh, erf, rsqrt and pow,
  in their own orders and approximations);
- dropout: the JAX operator only where it draws nothing (eval, p = 0);
  in training, the port's kept elements are input / (1 - p) and the
  rest 0, the same under the same generator seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastforward_tpu import flags as jflags
from fastforward_tpu import ops as jops
from fastforward_tpu import quantization as jq
from fastforward_tpu.exceptions import QuantizationError as JQuantizationError
from fastforward_tpu.ops import spec as jspec
from fastforward_tpu_torch import dispatcher as tdispatcher
from fastforward_tpu_torch import flags as tflags
from fastforward_tpu_torch import ops as tops
from fastforward_tpu_torch import quantization as tq
from fastforward_tpu_torch.exceptions import QuantizationError
from fastforward_tpu_torch.ops import optable, spec as tspec

EXACT = {"xla_allow_excess_precision": False}
ULPS = 8
S_IN = 2.0 / 255.0     # per-tensor input grid, about [-1, 1]
S_OUT = 1.0 / 64.0     # the output quantizer's grid


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
    if not np.issubdtype(w.dtype, np.floating):
        np.testing.assert_array_equal(p, w, err_msg=what)
        return
    top = max(float(np.abs(w).max()) if w.size else 0.0, np.finfo(np.float32).tiny)
    err = float(np.abs(p.astype(np.float64) - w.astype(np.float64)).max()) if w.size else 0.0
    assert err <= ULPS * 2.0 ** -23 * top, (what, err, top)


class TOut:
    """The port's output quantizer: per tensor, 8-bit, S_OUT."""
    is_stub = False

    def __call__(self, y):
        return tq.quantize_per_tensor(y, S_OUT, num_bits=8)


class JOut:
    is_stub = False

    def __call__(self, y):
        return jq.quantize_per_tensor(y, S_OUT, num_bits=8)


def _rs(seed):
    return np.random.RandomState(seed)


def _f(rs, *shape, scale=1.0):
    return (rs.randn(*shape) * scale).astype(np.float32)


# --- layout helpers (torch layout -> JAX's) ------------------------------------


def _last(a):   # N, C, spatial... -> N, spatial..., C
    return np.moveaxis(a, 1, -1)


def _first(a):  # back
    return np.moveaxis(a, -1, 1)


def _conv_w(w):  # (out, in, *k) -> (*k, in, out)
    nd = w.ndim - 2
    return w.transpose(tuple(range(2, 2 + nd)) + (1, 0))


def _convt_w(w):  # (in, out, *k) flipped along the window -> (*k, in, out)
    nd = w.ndim - 2
    return np.flip(w, axis=tuple(range(2, 2 + nd))).transpose(tuple(range(2, 2 + nd)) + (0, 1))


# Each case: (operator, torch-layout args as a list of arrays or literals,
# kwargs, positions of the args to quantize per tensor, to_jax(args) -> JAX
# args (and, for a transposed convolution, JAX's padding), from_jax(output)
# -> torch layout).
def _cases():
    rs = _rs(7)
    ident = lambda a: a  # noqa: E731
    same = lambda args: args  # noqa: E731
    cases = []

    def add(op, args, kw=None, q=(), to_jax=same, from_jax=ident, tag=""):
        cases.append(pytest.param(op, args, kw or {}, q, to_jax, from_jax, id=op + tag))

    x, w, b = _f(rs, 4, 16), _f(rs, 8, 16, scale=0.3), _f(rs, 8)
    add("linear", [x, w, b], q=(0, 1, 2), to_jax=lambda a: [a[0], a[1].T, a[2]])
    add("matmul", [x, _f(rs, 16, 8)], q=(0, 1))
    add("mm", [x, _f(rs, 16, 8)], q=(0, 1))
    add("bmm", [_f(rs, 2, 4, 16), _f(rs, 2, 16, 8)], q=(0, 1))
    add("einsum", ["ij,jk->ik", x, _f(rs, 16, 8)], q=(1,))
    add("log_softmax", [_f(rs, 8, 16, scale=2.0)], {"dim": -1}, q=(0,))
    add("einsum_linear", ["bi,io->bo", x, _f(rs, 16, 8), b], q=(1, 2, 3))
    for nd, xs, ws, kw in ((1, (2, 3, 10), (4, 3, 3), dict(padding=1)),
                           (2, (2, 3, 6, 6), (4, 3, 3, 3), dict(stride=2, padding=1)),
                           (3, (1, 2, 4, 4, 4), (3, 2, 2, 2, 2), dict(padding=0))):
        add(f"conv{nd}d", [_f(rs, *xs), _f(rs, *ws, scale=0.3), _f(rs, ws[0])], kw, q=(0, 1, 2),
            to_jax=lambda a: [_last(a[0]), _conv_w(a[1]), a[2]], from_jax=_first)
    for nd, xs, ws, s, p in ((1, (2, 3, 5), (3, 4, 3), 2, 1), (2, (1, 2, 4, 4), (2, 3, 3, 3), 2, 1),
                             (3, (1, 2, 3, 3, 3), (2, 2, 2, 2, 2), 1, 0)):
        k = ws[2]
        add(f"conv_transpose{nd}d", [_f(rs, *xs), _f(rs, *ws, scale=0.3), _f(rs, ws[1])],
            dict(stride=s, padding=p), q=(0, 1, 2),
            to_jax=lambda a, k=k, p=p: ([_last(a[0]), _convt_w(a[1]), a[2]], (k - 1) - p),
            from_jax=_first)
    act = _f(rs, 8, 16, scale=2.0)
    for op in ("relu", "sigmoid", "silu", "tanh"):
        add(op, [act], q=(0,))
    add("softmax", [act], {"dim": 1}, q=(0,))
    add("gelu", [act], q=(0,))
    add("gelu", [act], {"approximate": "tanh"}, q=(0,), tag="_tanh")
    add("layer_norm", [_f(rs, 4, 16), (16,), _f(rs, 16), _f(rs, 16)], {"eps": 1e-5},
        q=(0, 2, 3))
    add("rms_norm", [_f(rs, 4, 16), _f(rs, 16)], {"eps": 1e-6}, q=(0, 1))
    add("embedding", [rs.randint(0, 10, (5,)).astype(np.int64), _f(rs, 10, 8)], q=(1,),
        to_jax=lambda a: [a[0].astype(np.int32), a[1]])
    y = _f(rs, 8, 16)
    for op in ("add", "sub", "mul", "div"):
        other = np.abs(y) + 0.5 if op == "div" else y
        add(op, [act, other], q=(0, 1))
    add("add", [act, y], {"alpha": 2}, q=(0, 1), tag="_alpha")
    add("sub", [act, y], {"alpha": 2}, q=(0, 1), tag="_alpha")
    add("mul", [act, 1.5], q=(0,), tag="_scalar")
    add("pow", [np.abs(act) + 0.5, 3.0], q=(0,))
    add("floor_divide", [act * 3, np.abs(y) + 0.5], q=(0, 1))
    add("remainder", [act * 3, np.abs(y) + 0.5], q=(0, 1))
    add("negative", [act], q=(0,))
    add("positive", [act], q=(0,))
    add("sum", [act], {"dim": 1}, q=(0,))
    add("cumsum", [act], {"dim": 1}, q=(0,))
    ints = rs.randint(-100, 100, (4, 8)).astype(np.int32)
    shifts = rs.randint(0, 5, (4, 8)).astype(np.int32)
    add("bitwise_not", [ints])
    for op in ("bitwise_and", "bitwise_or", "bitwise_xor"):
        add(op, [ints, ints[::-1].copy()])
    add("bitwise_left_shift", [ints, shifts])
    add("bitwise_right_shift", [ints, shifts])
    t3 = _f(rs, 2, 3, 4)
    add("permute", [t3, (1, 2, 0)], q=(0,))
    add("transpose", [t3, 0, 2], q=(0,))
    add("reshape", [t3, (4, 6)], q=(0,))
    add("cat", [[_f(rs, 2, 3), _f(rs, 4, 3)]], {"dim": 0}, q=(0,))
    add("index_add", [_f(rs, 5, 4), 0, np.array([0, 2, 4]), _f(rs, 3, 4)], {"alpha": 1.5},
        q=(0, 3), to_jax=lambda a: [a[0], a[1], a[2].astype(np.int32), a[3]])
    add("pad", [t3, (1, 2)], {"mode": "constant", "value": 0.5}, q=(0,))
    for mode in ("reflect", "replicate", "circular"):
        add("pad", [t3, (1, 2)], {"mode": mode}, q=(0,), tag=f"_{mode}")
    add("avg_pool1d", [_f(rs, 2, 3, 8), 2], q=(0,), to_jax=lambda a: [_last(a[0]), a[1]],
        from_jax=_first)
    add("avg_pool2d", [_f(rs, 2, 3, 8, 8), 3], dict(stride=2, padding=1), q=(0,),
        to_jax=lambda a: [_last(a[0]), a[1]], from_jax=_first)
    add("avg_pool3d", [_f(rs, 1, 2, 4, 4, 4), 2], q=(0,),
        to_jax=lambda a: [_last(a[0]), a[1]], from_jax=_first)
    add("max_pool2d", [_f(rs, 2, 3, 8, 8), 3], dict(stride=2, padding=1), q=(0,),
        to_jax=lambda a: [_last(a[0]), a[1]], from_jax=_first)
    for mode in ("nearest", "bilinear"):
        add("interpolate", [_f(rs, 2, 3, 4, 4)], dict(size=(8, 8), mode=mode), q=(0,),
            to_jax=lambda a: [_last(a[0])], from_jax=_first, tag=f"_{mode}")
    add("unfold", [_f(rs, 2, 3, 5, 5), 3], dict(padding=1, stride=2), q=(0,),
        to_jax=lambda a: [_last(a[0]), a[1]])
    add("dropout", [act], {"p": 0.5, "training": False}, q=(0,), tag="_eval")
    add("dropout", [act], {"p": 0.0}, q=(0,), tag="_p0")
    for op in ("ones_like", "zeros_like"):
        add(op, [act], q=(0,))
    add("full_like", [act, 1.5], q=(0,))
    return cases


def _to_torch(v):
    if isinstance(v, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(v))
    if isinstance(v, list):
        return [_to_torch(e) for e in v]
    return v


def _to_jax(v):
    if isinstance(v, np.ndarray):
        return jnp.asarray(v)
    if isinstance(v, list):
        return [_to_jax(e) for e in v]
    return v


def _quantize(v, qfn):
    if isinstance(v, list):
        return [qfn(e) for e in v]
    return qfn(v)


def _split(args):
    """Positions of the array args (an array, or a list of arrays), which
    become jit arguments."""
    return [i for i, a in enumerate(args) if isinstance(a, np.ndarray) or (
        isinstance(a, list) and all(isinstance(e, np.ndarray) for e in a))]


def _jax_side(op, jargs, kw, q, convt_pad):
    """Jitted: the dense result, the dense result through JOut, the result
    on quantized args, and that through JOut (each (raw, dequantized) where
    quantized)."""
    pos = _split(jargs)
    arrays = [_to_jax(jargs[i]) for i in pos]
    kw = dict(kw)
    if convt_pad is not None:
        kw["padding"] = convt_pad
    fn = getattr(jops, op)

    def call(arrs, quantize):
        args = list(jargs)
        for i, a in zip(pos, arrs):
            args[i] = _quantize(a, lambda e: jq.quantize_per_tensor(e, S_IN)) if (
                quantize and i in q) else a
        plain = fn(*args, **kw)
        oq = fn(*args, output_quantizer=JOut(), **kw)
        return plain, (oq.raw_data, oq.dequantize())

    def both(*arrs):
        dense = call(arrs, False)
        quant = call(arrs, True) if q else dense
        return dense, quant

    with jflags.strict_quantization(False):
        return _jit(both, *arrays)


def _match(got, want, unlayout, what):
    """The port's result against JAX's: grids bit-equal, floats within
    ULPS."""
    if isinstance(want, jq.QuantizedArray):
        assert isinstance(got, tq.QuantizedTensor), what
        np.testing.assert_array_equal(_np(got.raw_data), unlayout(want.raw_data), err_msg=what)
        np.testing.assert_array_equal(_np(got.dequantize()), unlayout(want.dequantize()),
                                      err_msg=what)
    else:
        assert isinstance(got, torch.Tensor), what
        _close(got, unlayout(want), what)


@pytest.mark.parametrize("op,args,kw,q,to_jax,from_jax", _cases())
def test_operator_matches_jax(op, args, kw, q, to_jax, from_jax):
    # GIVEN the same inputs on both sides (the JAX ones in its layout)
    jargs = to_jax(list(args))
    convt_pad = None
    if isinstance(jargs, tuple):
        jargs, convt_pad = jargs
    jkw = dict(kw) if convt_pad is None else dict(kw, padding=convt_pad)
    want = _jax_side(op, jargs, kw, q, convt_pad)
    fn, jfn = getattr(tops, op), getattr(jops, op)
    targs = [_to_torch(a) for a in args]
    qargs = [(_quantize(a, lambda e: tq.quantize_per_tensor(e, S_IN)) if i in q else a)
             for i, a in enumerate(targs)]

    def unlayout(v):
        return from_jax(np.asarray(_np(v)))

    # WHEN the port's operator runs on dense and on quantized inputs, with
    # and without an output quantizer (strict quantization off)
    with tflags.strict_quantization(False):
        for (plain, (raw, deq)), inputs, what in ((want[0], targs, "dense"),
                                                  (want[1], qargs, "quantized")):
            # THEN the float result is within ULPS of JAX's, the output
            # quantizer's grid bit-equal
            _match(fn(*inputs, **kw), plain, unlayout, f"{op} {what}")
            got_oq = fn(*inputs, output_quantizer=TOut(), **kw)
            assert isinstance(got_oq, tq.QuantizedTensor)
            np.testing.assert_array_equal(_np(got_oq.raw_data), unlayout(raw), err_msg=op)
            np.testing.assert_array_equal(_np(got_oq.dequantize()), unlayout(deq), err_msg=op)
    # AND under strict quantization both refuse dense inputs; the port takes
    # quantized inputs with an output quantizer, and without one only where
    # a grid-preserving registration takes the call
    with jflags.strict_quantization(True), pytest.raises(JQuantizationError):
        jfn(*_to_jax(jargs), output_quantizer=JOut(), **jkw)
    with tflags.strict_quantization(True):
        with pytest.raises(QuantizationError):
            fn(*targs, output_quantizer=TOut(), **kw)
        if q:
            if tdispatcher.dispatch(op, *qargs, **kw) is None:
                with pytest.raises(QuantizationError, match="output quantizer"):
                    fn(*qargs, **kw)
            assert isinstance(fn(*qargs, output_quantizer=TOut(), **kw), tq.QuantizedTensor)


def test_sdpa_matches_jax():
    rs = _rs(11)
    q, k, v = (_f(rs, 2, 2, 5, 8) for _ in range(3))
    kv1 = (_f(rs, 2, 1, 5, 8), _f(rs, 2, 1, 5, 8))
    bool_mask = rs.rand(5, 5) > 0.3
    np.fill_diagonal(bool_mask, True)
    float_mask = _f(rs, 5, 5, scale=0.5)
    variants = [
        ({}, (q, k, v), None),
        ({"is_causal": True}, (q, k, v), None),
        ({"scale": 0.25}, (q, k, v), None),
        ({"enable_gqa": True}, (q,) + kv1, None),
        ({}, (q, k, v), bool_mask),
        ({}, (q, k, v), float_mask),
        ({"is_causal": True, "neg_inf": -1e4, "slots": True}, (q, k, v), float_mask),
    ]
    slot_names = ("scaled_query_quantizer", "scaled_key_quantizer", "attn_scores_quantizer",
                  "attn_mask_quantizer", "masked_scores_quantizer", "attn_weights_quantizer")

    def kwargs(kw, out):
        kw = dict(kw)
        if kw.pop("slots", False):
            kw.update({s: out() for s in slot_names})
        return kw

    runs = [(kw, qkv, mask, upcast) for kw, qkv, mask in variants for upcast in (True, False)]

    def jfn():
        out = []
        for kw, qkv, mask, upcast in runs:
            arrs = [jnp.asarray(a) for a in qkv]
            m = None if mask is None else jnp.asarray(mask)
            qs = [jq.quantize_per_tensor(a, S_IN) for a in arrs]
            with jops.sdpa_upcast(upcast):
                dense = jops.scaled_dot_product_attention(*arrs, m, **kwargs(kw, JOut))
                oq = jops.scaled_dot_product_attention(*qs, m, output_quantizer=JOut(),
                                                       **kwargs(kw, JOut))
            out.append((dense, oq.raw_data, oq.dequantize()))
        return out

    with jflags.strict_quantization(False):
        want = _jit(jfn)
    for (kw, qkv, mask, upcast), (dense, raw, deq) in zip(runs, want):
        targs = [torch.from_numpy(a) for a in qkv]
        tm = None if mask is None else torch.from_numpy(mask)
        with tflags.strict_quantization(False), tops.sdpa_upcast(upcast):
            got = tops.scaled_dot_product_attention(*targs, tm, **kwargs(kw, TOut))
            got_oq = tops.scaled_dot_product_attention(
                *[tq.quantize_per_tensor(a, S_IN) for a in targs], tm,
                output_quantizer=TOut(), **kwargs(kw, TOut))
        _close(got, dense, f"sdpa {kw} upcast={upcast}")
        np.testing.assert_array_equal(_np(got_oq.raw_data), _np(raw))
        np.testing.assert_array_equal(_np(got_oq.dequantize()), _np(deq))
    # the same function reached through torch's SDPA on quantized inputs
    targs = [tq.quantize_per_tensor(torch.from_numpy(a), S_IN) for a in (q, k, v)]
    with tflags.strict_quantization(False):
        routed = torch.nn.functional.scaled_dot_product_attention(*targs, is_causal=True)
        direct = tops.scaled_dot_product_attention(*targs, is_causal=True)
    assert torch.equal(routed, direct)
    # gqa under strict quantization refuses, as JAX's does
    with tflags.strict_quantization(True), pytest.raises(QuantizationError, match="enable_gqa"):
        tops.scaled_dot_product_attention(*targs[:1], *[tq.quantize_per_tensor(
            torch.from_numpy(a), S_IN) for a in kv1], enable_gqa=True, output_quantizer=TOut())


def test_dropout_in_training_keeps_and_scales_under_a_generator():
    x = torch.from_numpy(_f(_rs(3), 64, 64)) + 5.0
    for p in (0.25, 0.5):
        out = tops.dropout(x, p, True, generator=torch.Generator().manual_seed(4),
                           strict_quantization=False)
        again = tops.dropout(x, p, True, generator=torch.Generator().manual_seed(4),
                             strict_quantization=False)
        kept = out != 0
        assert torch.equal(out, again)
        assert torch.equal(out[kept], x[kept] / (1.0 - p))
        assert abs(kept.float().mean().item() - (1 - p)) < 0.03
    # through torch's dropout on a quantized input: dequantized, then dropped
    qt = tq.quantize_per_tensor(x, 0.05)
    with tflags.strict_quantization(False):
        out = torch.nn.functional.dropout(qt, 0.5, training=False)
    assert torch.equal(out, qt.dequantize())


def test_every_operator_is_held_against_jax():
    # the cases above cover 55 operators, SDPA its own test; empty_like's
    # values are unset, so its shape and dtype, dense and quantized
    covered = {p.values[0] for p in _cases()} | {"scaled_dot_product_attention", "empty_like"}
    assert covered == set(optable.OPERATOR_TABLE)
    x = _f(_rs(2), 3, 5)
    with tflags.strict_quantization(False), jflags.strict_quantization(False):
        for arg_t, arg_j in ((torch.from_numpy(x), jnp.asarray(x)),
                             (tq.quantize_per_tensor(torch.from_numpy(x), S_IN),
                              jq.quantize_per_tensor(jnp.asarray(x), S_IN))):
            for tdt, jdt in ((None, None), (torch.int32, jnp.int32)):
                got = tops.empty_like(arg_t, dtype=tdt)
                want = jax.eval_shape(lambda a: jops.empty_like(a, dtype=jdt), arg_j)
                assert got.shape == want.shape and _np(got).dtype == want.dtype


def test_operator_tables_and_yaml_match_jax():
    # GIVEN both operator tables
    names = set(optable.OPERATOR_TABLE)
    # THEN they hold the same 57 operators (56 and SDPA), each quantizing
    # the same arguments but where the port's takes a torch name for them
    assert names == set(jops.OPERATOR_TABLE) and len(names) == 57
    renamed = {"kernel": "weight"}
    for name in names:
        jspec_, tspec_ = jops.OPERATOR_TABLE[name], optable.OPERATOR_TABLE[name]
        assert tuple(renamed.get(p, p) for p in jspec_.quantized) == tspec_.quantized, name
        assert set(jspec_.maybe_quantized) == set(tspec_.maybe_quantized), name
        for alias in tspec_.aliases:
            assert alias.startswith("torch."), alias
            assert optable.torch_alias(optable._resolve_qualified(alias)) is tspec_, alias
    # AND the generated YAML lists them in the reference's shape
    import yaml

    t_entries = yaml.safe_load(tspec.operator_table_to_yaml())
    j_entries = yaml.safe_load(jspec.operator_table_to_yaml())
    assert [e["op"].split("(")[0] for e in t_entries] == [e["op"].split("(")[0]
                                                           for e in j_entries]
    lin = next(e for e in t_entries if e["op"].startswith("linear("))
    assert lin["op"] == ("linear(input: Quantized, weight: Quantized, bias: MaybeQuantized = "
                         "None) -> Quantized")
    assert lin["aliases"] == ["torch.nn.functional.linear"]


def _per_tensor(x, bits=8, offset=None, dtype=None, scale=0.05):
    return (tq.quantize_per_tensor(torch.from_numpy(x), scale, offset, num_bits=bits,
                                   quantized_dtype=dtype),
            _jit(lambda a: jq.quantize_per_tensor(a, scale, offset, num_bits=bits,
                                                  quantized_dtype=None if dtype is None
                                                  else jnp.int8), jnp.asarray(x)))


def _per_channel(x, dim, bits=8, offset=False, dtype=None):
    n = x.shape[dim]
    s = (np.abs(np.moveaxis(x, dim, 0)).reshape(n, -1).max(1) / 127 + 1e-3).astype(np.float32)
    o = np.arange(n, dtype=np.float32) % 3 if offset else None
    jdt = None if dtype is None else jnp.int8
    return (tq.quantize_per_channel(torch.from_numpy(x), dim, torch.from_numpy(s),
                                    None if o is None else torch.from_numpy(o), num_bits=bits,
                                    quantized_dtype=dtype),
            _jit(lambda a: jq.quantize_per_channel(a, dim, jnp.asarray(s),
                                                   None if o is None else jnp.asarray(o),
                                                   num_bits=bits, quantized_dtype=jdt),
                 jnp.asarray(x)))


def _with_dequantized(results):
    """JAX results as (QuantizedArray, its dequantized values), inside a jit."""
    return [(r, r.dequantize()) for r in results]


def _same_quantized(t, j, what):
    j, j_deq = j
    assert isinstance(t, tq.QuantizedTensor) and isinstance(j, jq.QuantizedArray), what
    np.testing.assert_array_equal(_np(t.raw_data), _np(j.raw_data), err_msg=what)
    np.testing.assert_array_equal(_np(t.dequantize()), _np(j_deq), err_msg=what)
    tg, jg = t.quant_args().granularity, j.quant_args().granularity
    assert type(tg).__name__ == type(jg).__name__ and repr(tg) == repr(jg), what


def test_grid_preserving_registrations_match_jax():
    rs = _rs(23)
    x = _f(rs, 6, 8)
    x3 = _f(rs, 2, 6, 4)
    pt, pj = _per_tensor(x)
    pt8, pj8 = _per_tensor(x, dtype=torch.int8)
    ct, cj = _per_channel(x, 0, dtype=torch.int8)
    c3t, c3j = _per_channel(x3, 1)
    ot, oj = _per_tensor(x, offset=2.0)
    mn_t, mn_j = _per_tensor(np.full((2, 2), -1.0, np.float32), dtype=torch.int8, scale=1 / 128)
    # every registration on both sides: (what, port call, JAX call)
    calls = [
        ("reshape per tensor", lambda: tops.reshape(pt, (4, 12)),
         lambda: jops.reshape(pj, (4, 12))),
        ("permute per tensor", lambda: tops.permute(pt, (1, 0)), lambda: jops.permute(pj, (1, 0))),
        ("transpose per tensor", lambda: tops.transpose(pt, 0, 1),
         lambda: jops.transpose(pj, 0, 1)),
        ("permute per channel", lambda: tops.permute(c3t, (2, 0, 1)),
         lambda: jops.permute(c3j, (2, 0, 1))),
        ("transpose per channel", lambda: tops.transpose(c3t, -2, 0),
         lambda: jops.transpose(c3j, -2, 0)),
        ("transpose int8 weight", lambda: tops.transpose(ct, 0, 1),
         lambda: jops.transpose(cj, 0, 1)),
        ("mul scalar", lambda: tops.mul(ct, 2.5), lambda: jops.mul(cj, 2.5)),
        ("mul negative scalar", lambda: tops.mul(pt8, -0.5), lambda: jops.mul(pj8, -0.5)),
        ("rmul scalar", lambda: tops.mul(3.0, pt), lambda: jops.mul(3.0, pj)),
        ("div scalar", lambda: tops.div(ct, 4.0), lambda: jops.div(cj, 4.0)),
        ("cat same grid", lambda: tops.cat([pt, pt], dim=1), lambda: jops.cat([pj, pj], dim=1)),
        ("cat along the channel", lambda: tops.cat([ct, ct], dim=0),
         lambda: jops.cat([cj, cj], dim=0)),
        ("negative", lambda: tops.negative(pt8), lambda: jops.negative(pj8)),
        ("negative float grid", lambda: tops.negative(ct), lambda: jops.negative(cj)),
        ("positive", lambda: tops.positive(ot), lambda: jops.positive(oj)),
        ("pad zero", lambda: tops.pad(pt, (1, 2, 0, 1)), lambda: jops.pad(pj, (1, 2, 0, 1))),
    ]
    # strict quantization stays on: the registrations take over before the
    # strict checks, which would refuse these calls without an output quantizer
    extra = [lambda: jops.negative(mn_j), lambda: jops.mul(pj, 2.0, output_quantizer=JOut())]
    jres = _jit(lambda: _with_dequantized([jcall() for _, _, jcall in calls] +
                                          [f() for f in extra]))
    for (what, tcall, _), j in zip(calls, jres):
        _same_quantized(tcall(), j, what)
    # int_min saturates to int_max on negation
    _same_quantized(tops.negative(mn_t), jres[-2], "negative int_min")
    assert int(tops.negative(mn_t).raw_data.max()) == 127
    # with an output quantizer the registration's result is requantized
    _same_quantized(tops.mul(pt, 2.0, output_quantizer=TOut()), jres[-1], "mul requantized")
    # no registration: an offset grid's scalar mul, a per-channel reshape,
    # cat of other grids fall back (and so refuse under strict quantization)
    for tcall, jcall in ((lambda: tops.mul(ot, 2.0), lambda: jops.mul(oj, 2.0)),
                         (lambda: tops.reshape(ct, (48,)), lambda: jops.reshape(cj, (48,))),
                         (lambda: tops.cat([pt, ot]), lambda: jops.cat([pj, oj]))):
        with pytest.raises(QuantizationError):
            tcall()
        with pytest.raises(JQuantizationError):
            jcall()
        with tflags.strict_quantization(False), jflags.strict_quantization(False):
            _close(tcall(), _jit(jcall))


def test_quantized_tensor_operators_and_torch_functions_route_through_ops():
    rs = _rs(31)
    x = _f(rs, 4, 8)
    w = _f(rs, 6, 8, scale=0.3)
    qt, qa = _per_tensor(x)
    wt, wj = _per_channel(w, 0)
    xt = torch.from_numpy(x)
    with tflags.strict_quantization(False), jflags.strict_quantization(False):
        # the Python operators, operands in their written order
        tpairs = [qt + 1.0, 1.0 + qt, qt - 1.0, 1.0 - qt, qt * 2.0, 2.0 * qt, qt / 4.0, -qt,
                  qt @ wt.dequantize().T, qt + qt]
        jpairs = _jit(lambda: [qa + 1.0, 1.0 + qa, qa - 1.0, 1.0 - qa, qa * 2.0, 2.0 * qa,
                               qa / 4.0, -qa, qa @ wj.dequantize().T, qa + qa])
        jdeq = _jit(lambda: _with_dequantized([j for j in jpairs
                                               if isinstance(j, jq.QuantizedArray)]))
        jdeq = {id(j): d for j, (_, d) in zip([j for j in jpairs
                                              if isinstance(j, jq.QuantizedArray)], jdeq)}
        for i, (t, j) in enumerate(zip(tpairs, jpairs)):
            if isinstance(t, tq.QuantizedTensor):
                _same_quantized(t, (j, jdeq[id(j)]), f"operator {i}")
            else:
                _close(t, j, f"operator {i}")
        assert not torch.equal(1.0 - qt, qt - 1.0)
        assert torch.equal(1.0 - qt, -(qt - 1.0))
        # torch functions on a QuantizedTensor: their operator
        assert torch.equal(torch.nn.functional.linear(xt, wt), tops.linear(xt, wt))
        assert torch.equal(xt + qt, tops.add(xt, qt))
        assert torch.equal(xt @ qt.dequantize().T, torch.matmul(xt, qt.dequantize().T))
        jshape = _jit(lambda: _with_dequantized([jops.reshape(qa, (8, 4)),
                                                 jops.transpose(wj, 0, 1),
                                                 jops.cat([qa, qa], 1)]))
        for t, j, what in zip((torch.reshape(qt, (8, 4)), torch.transpose(wt, 0, 1),
                               torch.cat([qt, qt], 1)), jshape,
                              ("torch.reshape", "torch.transpose", "torch.cat")):
            _same_quantized(t, j, what)
        assert torch.equal(torch.nn.functional.softmax(qt, dim=-1),
                           torch.softmax(qt.dequantize(), -1))
        assert torch.equal(torch.nn.functional.relu(qt), torch.relu(qt.dequantize()))
        # any other torch function: the implicit conversion (dequantize)
        assert torch.equal(torch.exp(qt), torch.exp(qt.dequantize()))
        assert torch.equal(torch.nn.functional.relu(qt, inplace=True),
                           torch.relu(qt.dequantize()))
    # strict: the operators refuse what JAX's refuse, other torch functions
    # refuse the implicit conversion
    with pytest.raises(QuantizationError):
        _ = 1.0 - qt
    with pytest.raises(JQuantizationError):
        jax.eval_shape(lambda: 1.0 - qa)
    with pytest.raises(QuantizationError, match="implicitly dequantize"):
        torch.exp(qt)
    with pytest.raises(QuantizationError, match="output quantizer"):
        torch.nn.functional.softmax(qt, dim=-1)
    _same_quantized(qt * 2.0, (jpairs[4], jdeq[id(jpairs[4])]), "strict scalar mul (registered)")
