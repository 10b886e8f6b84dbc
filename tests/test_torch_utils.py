"""The port's `utils/` (common, dataclasses, logging, cache, metrics,
evaluation, profiling) and `native.py` against the JAX package's, on the
CPU, on the same numpy-seeded inputs.

Held:
- `sqnr` within a relative 1e-6 of JAX's, a `QuantizedTensor` on either
  side dequantized as JAX dequantizes a `QuantizedArray`;
- `sequence_nll`, `evaluate_perplexity` and `perplexity_delta` within a
  relative 1e-6 of JAX's on the same logits;
- `native.quantize_pack_int4` and `quantize_int8` byte-equal to the JAX
  package's C++ library (`native/libffq_native.so`), exact ties included
  (rounded away from zero); bfloat16 weights against the library's bf16
  entry, called directly (`fastforward_tpu.native` sends bf16 to its numpy
  fallback, which rounds ties to even);
- profiling on the CPU: `benchmark`'s keys, an `annotate` region inside
  `trace_to` named in the written trace, `device_memory_stats` empty;
- the common helpers as JAX's, with the tensor functions on an explicit
  device (raising without CUDA when none is given).
"""

import ctypes
import dataclasses
import json
import logging
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastforward_tpu import native as jnative
from fastforward_tpu.quantization import quantize_per_channel as jquantize_per_channel
from fastforward_tpu.utils import cache as jcache
from fastforward_tpu.utils import common as jcommon
from fastforward_tpu.utils import evaluation as jeval
from fastforward_tpu.utils import metrics as jmetrics
from fastforward_tpu_torch import native as tnative
from fastforward_tpu_torch.quantization import quantize_per_channel as tquantize_per_channel
from fastforward_tpu_torch.utils import cache as tcache
from fastforward_tpu_torch.utils import common as tcommon
from fastforward_tpu_torch.utils import dataclasses as tdataclasses
from fastforward_tpu_torch.utils import evaluation as teval
from fastforward_tpu_torch.utils import logging_utils as tlogging
from fastforward_tpu_torch.utils import metrics as tmetrics
from fastforward_tpu_torch.utils import profiling as tprofiling

REL = 1e-6


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


# -- common, dataclasses, logging, cache --------------------------------------


@pytest.mark.parametrize("value", [3, [1.5, 2.5], np.arange(6, dtype=np.float32).reshape(2, 3)])
def test_ensure_array_matches_jax(value):
    # GIVEN a scalar, a list and an array WHEN coerced on the CPU
    got = tcommon.ensure_array(value, torch.float32, device="cpu")
    want = jcommon.ensure_array(value, jnp.float32)
    # THEN the tensor holds JAX's array
    assert got.device.type == "cpu" and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tcommon.array_or_none(None, device="cpu") is None
    np.testing.assert_array_equal(tcommon.array_or_none(value, device="cpu").numpy(),
                                  np.asarray(jcommon.array_or_none(value)))


def test_common_aliases_and_apply():
    assert tcommon.ensure_tensor is tcommon.ensure_array
    assert tcommon.tensor_or_none is tcommon.array_or_none
    assert tcommon.maybe_tensor_apply is tcommon.maybe_array_apply
    t = torch.ones(2)
    assert torch.equal(tcommon.maybe_array_apply(lambda x: x * 2, t), torch.full((2,), 2.0))
    assert tcommon.maybe_array_apply(lambda x: x * 2, "s") == "s"
    assert jcommon.maybe_array_apply(lambda x: x * 2, "s") == "s"


def test_ensure_array_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcommon.ensure_array([1.0])


class _Sample:
    def regular(self):
        pass

    @classmethod
    def cls_method(cls):
        pass

    @staticmethod
    def static_method():
        pass

    attr = 3


@pytest.mark.parametrize("name", ["regular", "cls_method", "static_method", "missing", "attr"])
def test_method_type_matches_jax(name):
    assert tcommon.method_type(_Sample, name).name == jcommon.method_type(_Sample, name).name
    assert tcommon.method_type(tcommon, "method_type") is tcommon.MethodType.STATIC_METHOD
    with pytest.raises(ValueError):
        tcommon.method_type(_Sample(), name)


def test_names_and_classproperty():
    # the qualified name of a class, a function and an instance, as JAX names them
    for obj in (_Sample, _rel, _Sample()):
        assert tcommon.fully_qualified_name(obj) == jcommon.fully_qualified_name(obj)
    assert tcommon.import_by_name("fastforward_tpu_torch.utils.common.method_type") is \
        tcommon.method_type

    class C:
        @tcommon.classproperty
        def kind(cls):
            return cls.__name__

    assert C.kind == "C" and C().kind == "C"


def test_nocopy_asdict_keeps_tensors():
    @dataclasses.dataclass
    class P:
        w: torch.Tensor
        n: int

    p = P(torch.zeros(3), 2)
    d = tdataclasses.nocopy_asdict(p)
    assert d["w"] is p.w and d["n"] == 2


def test_duplicate_log_filter():
    f = tlogging.DuplicateLogFilter()
    rec = logging.LogRecord("x", logging.WARNING, __file__, 1, "same", None, None)
    info = logging.LogRecord("x", logging.INFO, __file__, 1, "same", None, None)
    assert f.filter(rec) and not f.filter(rec) and f.filter(info) and f.filter(info)


def test_assets_path(tmp_path, monkeypatch):
    # GIVEN the JAX package's cache variable WHEN both resolve an asset path
    monkeypatch.setenv("FASTFORWARD_TPU_CACHE", str(tmp_path / "env"))
    assert tcache.get_assets_path("k", "t") == jcache.get_assets_path("k", "t")
    assert (tmp_path / "env" / "k" / "t").is_dir()
    assert tcache.get_assets_path("k", "t", str(tmp_path / "d")) == tmp_path / "d" / "k" / "t"
    # THEN without either, the port keeps its own cache directory
    monkeypatch.delenv("FASTFORWARD_TPU_CACHE")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert tcache.get_assets_path("k", "t") == \
        tmp_path / "home" / ".cache" / "fastforward_tpu_torch" / "k" / "t"


# -- metrics and evaluation ------------------------------------------------------


def test_sqnr_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(64, 32).astype(np.float32)
    y = (x + 0.05 * rng.randn(64, 32)).astype(np.float32)
    assert _rel(tmetrics.sqnr(torch.from_numpy(x), torch.from_numpy(y)),
                jmetrics.sqnr(jnp.asarray(x), jnp.asarray(y))) < REL
    # a quantized tensor on either side is dequantized first
    scale = (np.abs(x).max(axis=0) / 127).astype(np.float32)
    tq = tquantize_per_channel(torch.from_numpy(x), 1, torch.from_numpy(scale), num_bits=8)
    jq = jquantize_per_channel(jnp.asarray(x), 1, jnp.asarray(scale), num_bits=8)
    assert _rel(tmetrics.sqnr(torch.from_numpy(x), tq), jmetrics.sqnr(jnp.asarray(x), jq)) < REL
    assert _rel(tmetrics.sqnr(tq, torch.from_numpy(x)), jmetrics.sqnr(jq, jnp.asarray(x))) < REL


def _logits(seed, B=2, T=9, V=50):
    rng = np.random.RandomState(seed)
    return (3 * rng.randn(B, T, V)).astype(np.float32), rng.randint(0, V, (B, T))


def test_sequence_nll_and_perplexity_match_jax():
    logits, ids = _logits(0)
    assert _rel(teval.sequence_nll(torch.from_numpy(logits), torch.from_numpy(ids)),
                jeval.sequence_nll(jnp.asarray(logits), jnp.asarray(ids))) < REL
    table = {i: _logits(i + 1) for i in range(3)}

    def jfwd(ids):
        return jnp.asarray(table[int(ids[0, 0])][0])

    def tfwd(ids):
        return torch.from_numpy(table[int(ids[0, 0])][0])

    batches = [np.full((2, 9), i) for i in range(3)]
    want = jeval.evaluate_perplexity(jfwd, [jnp.asarray(b) for b in batches])
    got = teval.evaluate_perplexity(tfwd, [torch.from_numpy(b) for b in batches])
    assert _rel(got, want) < REL

    # the delta of two forwards on the same batches
    def jfwd2(ids):
        return jfwd(ids) * 0.5

    def tfwd2(ids):
        return tfwd(ids) * 0.5

    want = jeval.perplexity_delta(jfwd, jfwd2, [jnp.asarray(b) for b in batches])
    got = teval.perplexity_delta(tfwd, tfwd2, [torch.from_numpy(b) for b in batches])
    for g, w in zip(got, want):
        assert _rel(g, w) < REL


def test_perplexity_of_bf16_logits_is_f32():
    logits, ids = _logits(4)
    bf = torch.from_numpy(logits).to(torch.bfloat16)
    want = jeval.sequence_nll(jnp.asarray(logits, jnp.bfloat16), jnp.asarray(ids))
    assert _rel(teval.sequence_nll(bf, torch.from_numpy(ids)), want) < REL


# -- profiling ----------------------------------------------------------------------


def test_benchmark_keys():
    out = tprofiling.benchmark(lambda x: {"y": x * 2}, torch.ones(4), iters=3, warmup=1)
    assert set(out) == {"mean_s", "best_s", "iters"} and out["iters"] == 3.0
    assert 0 <= out["best_s"] <= out["mean_s"]


def test_annotate_inside_trace_to_names_the_region(tmp_path):
    with tprofiling.trace_to(str(tmp_path)):
        with tprofiling.annotate("ff/test_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((tmp_path / tprofiling.TRACE_FILE).read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "ff/test_region" in names


def test_device_memory_stats_empty_on_cpu():
    assert tprofiling.device_memory_stats("cpu") == {}


# -- native -------------------------------------------------------------------------


def _with_ties(rng, K, N, g):
    """Weights where w / scale lands on exact halves in some entries."""
    w = rng.randn(K, N).astype(np.float32)
    for grp in range(K // g):
        w[grp * g] = 7.0  # the group's absmax: scale = 1
        w[grp * g + 1] = np.float32(2.5)
        w[grp * g + 2] = np.float32(-3.5)
    return w


def test_native_available():
    assert tnative.native_available()
    assert jnative.native_available(), "the JAX package's C++ library failed to build"


@pytest.mark.parametrize("g", [32, 128])
def test_quantize_pack_int4_bytes_equal_cpp(g):
    w = _with_ties(np.random.RandomState(g), 256, 64, g)
    want = jnative.quantize_pack_int4(w, g)
    got = tnative.quantize_pack_int4(w, g, device="cpu")
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_quantize_pack_int4_bf16_bytes_equal_cpp_entry():
    rng = np.random.RandomState(3)
    wb = np.asarray(jnp.asarray(_with_ties(rng, 256, 32, 128), jnp.bfloat16))
    lib = jnative._load_library()
    K, N = wb.shape
    packed = np.empty((K // 2, N), np.int8)
    scales = np.empty((K // 128, N), np.float32)
    raw = np.ascontiguousarray(wb).view(np.uint16)
    lib.ffq_quantize_pack_int4_bf16(
        raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), K, N, 128,
        packed.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        scales.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    got = tnative.quantize_pack_int4(wb, 128, device="cpu")
    np.testing.assert_array_equal(got[0], packed)
    np.testing.assert_array_equal(got[1], scales)


def test_quantize_int8_bytes_equal_cpp():
    rng = np.random.RandomState(2)
    w = rng.randn(128, 64).astype(np.float32)
    w[0] = 127.0  # scale 1 in every column
    w[1], w[2], w[3] = 2.5, -0.5, 0.0  # exact ties, and a zero
    w[:, 5] = 0.0  # an all-zero column: scale 1e-8
    want = jnative.quantize_int8(w)
    got = tnative.quantize_int8(w, device="cpu")
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got[0][1, 0] == 3 and got[0][2, 0] == -1  # away from zero


def test_native_errors_and_other_dtypes():
    with pytest.raises(ValueError, match="not divisible"):
        tnative.quantize_pack_int4(np.zeros((100, 4), np.float32), 64, device="cpu")
    # a float64 weight is quantized as its float32 conversion, as JAX's module takes it
    w = np.random.RandomState(5).randn(64, 8)
    for a, b in zip(tnative.quantize_int8(w, device="cpu"),
                    tnative.quantize_int8(w.astype(np.float32), device="cpu")):
        np.testing.assert_array_equal(a, b)


def test_native_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tnative.quantize_int8(np.zeros((4, 4), np.float32))


def test_port_modules_keep_jax_names():
    # every public function of the JAX modules has its counterpart here
    for jmod, tmod in ((jcommon, tcommon), (jeval, teval), (jmetrics, tmetrics),
                       (jcache, tcache), (jnative, tnative)):
        public = {n for n, v in vars(jmod).items() if callable(v) and not n.startswith("_")
                  and getattr(v, "__module__", None) == jmod.__name__}
        assert public <= set(dir(tmod)), public - set(dir(tmod))
    assert os.path.basename(tprofiling.__file__) == "profiling.py"
