"""The port imports torch and never JAX or the JAX package.

Every module of `fastforward_tpu_torch` is imported in a fresh Python
process; afterwards neither ``jax``, ``flax``, ``triton``, any
``fastforward_tpu.`` module, ``safetensors``, ``yaml`` (PyYAML, which the
JAX package's granularities import for their YAML registration),
``transformers`` nor ``orbax`` may be loaded there. Nor may they after
``import fastforward_tpu_torch`` and its checkpoint module alone. The kernel build table names every CUDA source of
`csrc/`, and each C entry point it binds is defined in its source.
"""

import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import fastforward_tpu_torch
from fastforward_tpu_torch.kernels import _build

REPO = Path(__file__).resolve().parent.parent

_PROBE = """
import importlib, json, pkgutil, sys
import fastforward_tpu_torch
names = [m.name for m in pkgutil.walk_packages(fastforward_tpu_torch.__path__,
                                               "fastforward_tpu_torch.")]
for name in names:
    importlib.import_module(name)
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "flax", "triton", "fastforward_tpu", "safetensors",
                                       "yaml", "transformers", "orbax"))
print(json.dumps({"modules": names, "forbidden": loaded}))
"""


def test_port_modules_import_no_jax():
    # GIVEN every module of the port
    expected = sorted(m.name for m in pkgutil.walk_packages(
        fastforward_tpu_torch.__path__, "fastforward_tpu_torch."))
    for name in ("serving.stacked", "serving.sampling", "serving.paged", "serving.batching",
                 "serving.kv_cache", "serving.engine", "serving.loader",
                 "kernels.paged_attention", "kernels.matmul", "kernels.kv_update", "flags",
                 "scripts.probe_int4", "serving.moe", "parallel", "parallel.mesh",
                 "parallel.tp_serving", "parallel.sharding", "parallel.multihost",
                 "parallel.context", "parallel.pipeline", "parallel.dryrun", "parallel.transport",
                 "exceptions", "dispatcher", "forward_override", "quantization",
                 "quantization.tiling", "quantization.granularity", "quantization.function",
                 "quantization.quantized_array", "quantization.affine",
                 "quantization.affine_function", "quantization.ste", "quantization.random",
                 "quantization.strict_quantization", "ops", "ops.optable", "ops.operators",
                 "ops.sdpa", "ops.linear_quantized_ops", "ops.spec", "kernels.dispatch", "nn",
                 "nn.functional", "nn.quantizer", "nn.linear_quantizer", "nn.quantized_module",
                 "nn.layers", "nn.convert", "quantization.freeze",
                 "quantization.quantizer_annotations", "overrides", "mpath", "mpath.fragments",
                 "mpath.selector", "mpath.parser", "mpath.search", "quant_init",
                 "range_setting", "range_setting.common", "range_setting.minmax",
                 "range_setting.min_error", "algorithms", "algorithms.gptq",
                 "algorithms.layerwise", "models.llama", "models.mlp", "models.gpt2", "graph",
                 "orchestration", "autoquant", "autoquant_fx", "export", "export.encodings",
                 "export.pipeline", "export.torch_export", "utils", "utils.common",
                 "utils.dataclasses", "utils.logging_utils", "utils.cache", "utils.metrics",
                 "utils.serialization", "utils.block_yaml", "utils.checkpoint",
                 "utils.evaluation", "utils.profiling", "native", "testing",
                 "testing.initialization", "testing.package_mock", "testing.hf_golden"):
        assert f"fastforward_tpu_torch.{name}" in expected
    # WHEN all are imported in a fresh interpreter
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True, text=True,
                         cwd=REPO, env=env, timeout=300, check=True)
    result = json.loads(out.stdout.strip().splitlines()[-1])
    # THEN each imported, and no JAX module was loaded
    assert sorted(result["modules"]) == expected
    assert result["forbidden"] == []


_TOP = """
import json, sys
import fastforward_tpu_torch
import fastforward_tpu_torch.utils.checkpoint
print(json.dumps(sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "flax", "yaml", "safetensors", "transformers", "orbax"))))
"""


def test_package_and_checkpoint_import_nothing_forbidden():
    # GIVEN a fresh interpreter WHEN the package and its checkpoint module are imported
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", _TOP], capture_output=True, text=True,
                         cwd=REPO, env=env, timeout=300, check=True)
    # THEN none of the JAX stack, PyYAML, safetensors, transformers or orbax is loaded
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_build_table_covers_every_source():
    # GIVEN the CUDA sources of the port
    sources = sorted(p.stem for p in _build.CSRC_DIR.glob("*.cu"))
    # THEN the build table compiles each, including the float-scale modes'
    assert sorted(_build.SOURCES) == sources == sorted(_build.SIGNATURES)
    for name in ("w8a8_gemm", "w4_gemv"):
        assert name in sources
    # AND every bound entry point is an extern "C" function of its source
    for name, entries in _build.SIGNATURES.items():
        text = (_build.CSRC_DIR / f"{name}.cu").read_text()
        for fn in entries:
            assert f'extern "C" int {fn}(' in text, (name, fn)
    assert "ff_w4a8_gemv_halves" in _build.SIGNATURES["w4a8_halves"]
    assert "ff_dequant_halves" in _build.SIGNATURES["dequant"]
    assert "ff_w4a8_gemv_unpaired" in _build.SIGNATURES["w4a8_gemv"]
    assert "ff_flash_prefill_bf16" in _build.SIGNATURES["flash_prefill"]
    assert "ff_fused_o_gu" in _build.SIGNATURES["fused_tail"]
    assert sorted(_build.SIGNATURES["fused_head"]) == ["ff_fused_norm_qkv", "ff_fused_norm_qkv_a4",
                                                       "ff_fused_norm_qkv_a4_any",
                                                       "ff_fused_norm_qkv_any"]
    for fn in ("ff_w4a8_gemv_any", "ff_w4a8_gemv_unpaired_any", "ff_w4a8_gemv_stacked_any"):
        assert fn in _build.SIGNATURES["w4a8_gemv"]
    assert list(_build.SIGNATURES["a4_gemv"]) == ["ff_a4_gemv", "ff_a4_gemv_any"]
    for fn in ("ff_fused_o_mlp_any", "ff_fused_o_gu_any"):
        assert fn in _build.SIGNATURES["fused_tail"]
    for fn in ("ff_w4a8_gemv_dotraw", "ff_w4a8_gemv_concat"):
        assert fn in _build.SIGNATURES["w4a8_gemv"]
    assert list(_build.SIGNATURES["w4a16_gemm"]) == ["ff_w4a16_gemm"]
    assert list(_build.SIGNATURES["w4a8_halves"]) == ["ff_w4a8_gemv_halves"]
    assert list(_build.SIGNATURES["w4_gemv"]) == ["ff_w4_gemv", "ff_w4_gemv_clusters"]
    for fn in ("ff_kv_quantize_append", "ff_paged_kv_quantize_append"):
        assert fn in _build.SIGNATURES["kv_append"]
    assert list(_build.SIGNATURES["probe_int4"]) == ["ff_probe_int4"]


def _c_params(text, fn):
    """The parameter types of ``extern "C" int fn(...)`` in a source."""
    head = text.index(f'extern "C" int {fn}(') + len(f'extern "C" int {fn}(')
    params = " ".join(text[head:text.index(")", head)].split())
    return [p.rsplit(" ", 1)[0].strip() for p in params.split(",")]


def test_build_table_argument_counts_match_the_sources():
    # GIVEN every bound C entry point and its ctypes signature
    for name, entries in _build.SIGNATURES.items():
        text = (_build.CSRC_DIR / f"{name}.cu").read_text()
        for fn, argtypes in entries.items():
            params = _c_params(text, fn)
            # THEN it takes as many arguments as the table passes, each a
            # pointer where the table passes a pointer, else an int or float
            assert len(params) == len(argtypes), (fn, params)
            for p, t in zip(params, argtypes):
                want = {_build.P: "*", _build.I: "int", _build.F: "float"}[t]
                assert (p.endswith("*") if want == "*" else p == want), (fn, p, t)
