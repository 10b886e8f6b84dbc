"""The W8A8 dispatcher registration (`fastforward_tpu_torch/kernels/dispatch.py`)
against the JAX package's (`fastforward_tpu/kernels/dispatch.py`), on the
CPU.

An int8, 2-D, symmetric weight quantized per output channel reaches
`ops.linear` on both sides: the port's in torch's (out, in) layout with
``PerChannel(0)``, JAX's as the (in, out) kernel with ``PerChannel(1)``
(the same grid values and scales, transposed). Both import their
``kernels`` package, which registers the kernel. The port's output (x
quantized per row, `matmul_w8a8`'s plain version on the CPU) is bit-equal
to the jitted JAX ``ops.linear`` (compiled with
``xla_allow_excess_precision=False``), and the two predicates accept and
refuse the same arguments.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastforward_tpu.kernels  # noqa: F401  (registers the JAX kernel)
import fastforward_tpu_torch.kernels  # noqa: F401  (registers the port's)
from fastforward_tpu import dispatcher as jdispatcher
from fastforward_tpu import flags as jflags
from fastforward_tpu import ops as jops
from fastforward_tpu import quantization as jq
from fastforward_tpu_torch import dispatcher as tdispatcher
from fastforward_tpu_torch import ops as tops
from fastforward_tpu_torch import quantization as tq
from fastforward_tpu_torch.kernels import dispatch as tdispatch

EXACT = {"xla_allow_excess_precision": False}


def _jit(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=EXACT)(*args)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


def _weights(N, K, seed, offset=False, bits=8, dtype=torch.int8):
    """The same int8 per-channel weight on both sides: the port's (N, K)
    PerChannel(0), JAX's (K, N) PerChannel(1)."""
    rs = np.random.RandomState(seed)
    w = (rs.randn(N, K) / np.sqrt(K)).astype(np.float32)
    s = (np.abs(w).max(1) / 127).astype(np.float32)
    o = (np.arange(N) % 3).astype(np.float32) if offset else None
    jdt = {torch.int8: jnp.int8, None: None}[dtype]
    qt = tq.quantize_per_channel(torch.from_numpy(w), 0, torch.from_numpy(s),
                                 None if o is None else torch.from_numpy(o), num_bits=bits,
                                 quantized_dtype=dtype)
    qa = jq.quantize_per_channel(jnp.asarray(w.T), 1, jnp.asarray(s),
                                 None if o is None else jnp.asarray(o), num_bits=bits,
                                 quantized_dtype=jdt)
    return qt, qa


@pytest.mark.parametrize("lead,K,N,dtype,bias,quantized_x,out_q", [
    ((5,), 64, 48, "float32", False, False, False),
    ((2, 3), 64, 48, "float32", True, False, False),
    ((7,), 128, 32, "bfloat16", False, False, False),
    ((4,), 32, 16, "bfloat16", True, False, False),
    ((6,), 64, 24, "float32", True, True, True),
])
def test_w8a8_registration_matches_jitted_jax(lead, K, N, dtype, bias, quantized_x, out_q):
    # GIVEN an int8 per-output-channel weight and activations on both sides
    qt, qa = _weights(N, K, K + N)
    rs = np.random.RandomState(N)
    x = (rs.randn(*lead, K) * 2).astype(np.float32)
    b = rs.randn(N).astype(np.float32) if bias else None
    tdt, jdt = {"float32": (torch.float32, jnp.float32),
                "bfloat16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    xt = torch.from_numpy(x).to(tdt)
    bt = None if b is None else torch.from_numpy(b)
    if quantized_x:
        xt = tq.quantize_per_tensor(xt, 0.05)
    tq_out = (lambda y: tq.quantize_per_tensor(y, 0.02)) if out_q else None

    def jfn(xj, bj):
        if quantized_x:
            xj = jq.quantize_per_tensor(xj, 0.05)
        y = jops.linear(xj, qa, bj,
                        output_quantizer=(lambda y: jq.quantize_per_tensor(y, 0.02))
                        if out_q else None)
        return (y.raw_data, y.dequantize()) if out_q else y

    want = _jit(jfn, jnp.asarray(x).astype(jdt), None if b is None else jnp.asarray(b))
    # WHEN both route ops.linear through their registration (strict
    # quantization on: the kernel takes the call before the strict checks)
    assert tdispatcher.dispatch("linear", xt, qt, bt) is tdispatch._linear_w8a8_kernel
    got = tops.linear(xt, qt, bt, output_quantizer=tq_out)
    # THEN the outputs are bit-equal, in JAX's dtype
    if out_q:
        np.testing.assert_array_equal(_np(got.raw_data), _np(want[0]))
        np.testing.assert_array_equal(_np(got.dequantize()), _np(want[1]))
    else:
        assert got.dtype == tdt and got.shape == (*lead, N)
        np.testing.assert_array_equal(_np(got), _np(want))
    # AND torch's linear on the QuantizedTensor is the same call
    if not out_q:
        assert torch.equal(torch.nn.functional.linear(xt, qt, bt), got)


def test_w8a8_predicate_accepts_and_refuses_as_jax():
    rs = np.random.RandomState(3)
    x2 = rs.randn(4, 32).astype(np.float32)
    good_t, good_j = _weights(16, 32, 1)
    off_t, off_j = _weights(16, 32, 2, offset=True)
    float_t, float_j = _weights(16, 32, 3, dtype=None)
    w = (rs.randn(16, 32) * 0.1).astype(np.float32)
    pt_t = tq.quantize_per_tensor(torch.from_numpy(w), 0.01, quantized_dtype=torch.int8)
    pt_j = jq.quantize_per_tensor(jnp.asarray(w.T), 0.01, quantized_dtype=jnp.int8)
    # the wrong channel dim: per input channel on each side's layout
    s_in = (np.abs(w).max(0) / 127).astype(np.float32)
    in_t = tq.quantize_per_channel(torch.from_numpy(w), 1, torch.from_numpy(s_in),
                                   quantized_dtype=torch.int8)
    in_j = jq.quantize_per_channel(jnp.asarray(w.T), 0, jnp.asarray(s_in),
                                   quantized_dtype=jnp.int8)
    w3 = (rs.randn(2, 16, 32) * 0.1).astype(np.float32)
    s3 = (np.abs(w3).max((0, 2)) / 127).astype(np.float32)
    w3_t = tq.quantize_per_channel(torch.from_numpy(w3), 1, torch.from_numpy(s3),
                                   quantized_dtype=torch.int8)
    w3_j = jq.quantize_per_channel(jnp.asarray(w3.transpose(0, 2, 1)), 2, jnp.asarray(s3),
                                   quantized_dtype=jnp.int8)
    x1 = rs.randn(32).astype(np.float32)
    cases = [  # (what, port args, JAX args, accepted)
        ("int8 per output channel", (torch.from_numpy(x2), good_t), (jnp.asarray(x2), good_j),
         True),
        ("quantized x", (tq.quantize_per_tensor(torch.from_numpy(x2), 0.05), good_t),
         (jq.quantize_per_tensor(jnp.asarray(x2), 0.05), good_j), True),
        ("an offset", (torch.from_numpy(x2), off_t), (jnp.asarray(x2), off_j), False),
        ("float storage", (torch.from_numpy(x2), float_t), (jnp.asarray(x2), float_j), False),
        ("per tensor", (torch.from_numpy(x2), pt_t), (jnp.asarray(x2), pt_j), False),
        ("per input channel", (torch.from_numpy(x2), in_t), (jnp.asarray(x2), in_j), False),
        ("3-D weight", (torch.from_numpy(x2), w3_t), (jnp.asarray(x2), w3_j), False),
        ("1-D x", (torch.from_numpy(x1), good_t), (jnp.asarray(x1), good_j), False),
        ("dense weight", (torch.from_numpy(x2), torch.from_numpy(w)),
         (jnp.asarray(x2), jnp.asarray(w.T)), False),
    ]
    for what, targs, jargs, accepted in cases:
        t_hit = tdispatcher.dispatch("linear", *targs) is not None
        j_hit = jdispatcher.dispatch("linear", *jargs) is not None
        assert t_hit == j_hit == accepted, what
    # a refused weight takes the dense fallback, as JAX's does
    with jflags.strict_quantization(False):
        want = jops.linear(jnp.asarray(x2), off_j)
    from fastforward_tpu_torch import flags as tflags

    with tflags.strict_quantization(False):
        got = tops.linear(torch.from_numpy(x2), off_t)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-5 * float(np.abs(want).max()))
