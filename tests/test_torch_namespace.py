"""The port's top-level namespace against the JAX package's.

Every name of `fastforward_tpu`'s ``__all__``, ``_LAZY_SUBMODULES``,
``_SUBMODULE_ALIASES`` and ``_LAZY_NAMES`` resolves on
`fastforward_tpu_torch`, as do the reference names of
`tests/test_namespace_parity.py`; where the port's object has another name
the JAX name points at it (``QuantizedArray`` and ``QuantizedTensor`` at
`QuantizedTensor`, ``JaxprQuantizationPlan`` at the fx pass's
`FxQuantizationPlan`), and the port's own exports stay.
"""

import importlib
import types

import pytest
import torch

import fastforward_tpu as ff
import fastforward_tpu_torch as fft
from tests.test_namespace_parity import REFERENCE_NAMES

JAX_NAMES = sorted(set(ff.__all__) | set(ff._LAZY_SUBMODULES) | set(ff._SUBMODULE_ALIASES)
                   | set(ff._LAZY_NAMES))
PORT_NAMES = ["resolve_device", "QuantizationConfig", "find_quantizers", "estimate_ranges",
              "range_setting", "mpath", "autoquantize", "trace_quantization_sites",
              "trace_modules", "GraphModule", "run_scheduled", "export"]


@pytest.mark.parametrize("name", JAX_NAMES)
def test_jax_name_resolves(name):
    value = getattr(fft, name)
    jvalue = getattr(ff, name)
    # a module where JAX has a module, the port's own; else an object of the port
    assert isinstance(value, types.ModuleType) == isinstance(jvalue, types.ModuleType)
    module = value.__name__ if isinstance(value, types.ModuleType) else \
        getattr(value, "__module__", "fastforward_tpu_torch")
    assert module.startswith("fastforward_tpu_torch"), (name, module)


def test_tables_match_jax():
    assert fft._LAZY_SUBMODULES == ff._LAZY_SUBMODULES
    assert {k: v.replace("fastforward_tpu_torch.", "fastforward_tpu.")
            for k, v in fft._SUBMODULE_ALIASES.items()} == ff._SUBMODULE_ALIASES
    assert set(fft._LAZY_NAMES) == set(ff._LAZY_NAMES)
    assert set(ff.__all__) <= set(fft.__all__)
    assert fft.version == fft.__version__ == ff.__version__


def test_reference_names_resolve():
    missing = [n for n in REFERENCE_NAMES if not hasattr(fft, n)]
    assert not missing


def test_renamed_objects():
    from fastforward_tpu_torch.autoquant_fx import FxQuantizationPlan
    from fastforward_tpu_torch.quantization.quantized_array import QuantizedTensor

    assert fft.QuantizedTensor is fft.QuantizedArray is QuantizedTensor
    assert fft.JaxprQuantizationPlan is FxQuantizationPlan
    assert fft.testing is importlib.import_module("fastforward_tpu_torch.testing")
    assert fft.native.native_available()
    assert fft.type_common.method_type is not None and fft.sqnr is fft.testing.sqnr


@pytest.mark.parametrize("name", PORT_NAMES)
def test_port_exports_stay(name):
    assert name in fft.__all__ and hasattr(fft, name)


def test_unknown_name_raises():
    with pytest.raises(AttributeError, match="no attribute"):
        fft.no_such_name  # noqa: B018


def test_surrogate_quantized_modules_builds_conversion_dict():
    # GIVEN a model with an unquantizable container type (the case of
    # tests/test_namespace_parity.py)
    class Holder(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.inner = torch.nn.Linear(4, 4)

        def forward(self, x):
            return self.inner(x)

    conv = fft.surrogate_quantized_modules(Holder())
    # THEN the holder type gets a pass-through QuantizedModule counterpart
    assert Holder in conv and issubclass(conv[Holder], Holder)
