"""The port's `testing/` against the JAX package's, on the CPU.

Held:
- `PackageMock`: the cases of `tests/test_utils_common.py` (fake modules
  importable inside the context, their sources visible to ``inspect``,
  purged on exit; names validated, sealed while active, re-enterable), and
  its annotations resolve (the port's copy imports the names the JAX copy
  leaves to ``from __future__ import annotations``);
- `initialize_quantizers_to_linear_quantizer` on the port's MLP installs
  JAX's quantizers at JAX's paths, with JAX's scales and offsets;
- `is_close_to_rounding` equal to JAX's; `seed_prngs` seeds numpy as JAX's
  does and returns a seeded `torch.Generator` on the device asked for;
  `dedent_strip` and `assert_strings_match_verbose` as JAX's;
- `llama_from_tensors` and `gpt2_from_hf` on the tiny fabricated HF models
  (`LLAMA_DIMS["tiny"]`, `GPT2_DIMS["tiny"]`, the `transformers` package):
  their float logits within `FLOAT_TOL` of the largest logit of JAX's
  `nnx_model_from_tensors` / `nnx_gpt2_from_hf` models on the same tensors,
  and within `HF_TOL` of HF's own fp32 logits (measured on the CPU, as a
  share of the largest logit: Llama 2.1e-7 from JAX's, 2.4e-7 from HF's;
  GPT-2 3.5e-7 and 1.7e-7; JAX's own from HF's 2.6e-7 and 3.5e-7); `ppl`
  within 1e-5 relative of JAX's `ppl_jax` of the JAX model (1.4e-6
  measured) and within 1e-4 of HF's `ppl_torch` (9e-10).
"""

import inspect
import sys
import typing

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import fastforward_tpu.testing as jtesting
import fastforward_tpu_torch.testing as ttesting
from fastforward_tpu import nn as jnn
from fastforward_tpu.models.mlp import MLP as JMLP
from fastforward_tpu.testing import hf_golden as jgolden
from fastforward_tpu_torch import nn as tnn
from fastforward_tpu_torch.models.mlp import MLP as TMLP
from fastforward_tpu_torch.testing import hf_golden as tgolden
from fastforward_tpu_torch.testing import package_mock as tpm

FLOAT_TOL = 1e-5
HF_TOL = 1e-5


# -- PackageMock ------------------------------------------------------------------------


def test_package_mock_import_and_cleanup():
    # GIVEN two fake modules, one importing the other
    pkg = ttesting.PackageMock({"ff_fake_tpkg.a": "def foo():\n    return 1\n"})
    pkg.add_module("ff_fake_tpkg.b", "from ff_fake_tpkg import a\nbar = a.foo() + 1\n")
    # WHEN the context is active
    with pkg:
        import ff_fake_tpkg.b as b

        assert b.bar == 2
        import ff_fake_tpkg.a as a

        assert "def foo" in inspect.getsource(a)
    # THEN everything is purged on exit
    assert "ff_fake_tpkg" not in sys.modules and "ff_fake_tpkg.a" not in sys.modules
    with pytest.raises(ImportError):
        import ff_fake_tpkg.c  # noqa: F401


def test_package_mock_sealed_and_validated():
    pkg = ttesting.PackageMock()
    with pytest.raises(ValueError):
        pkg.add_module("not-valid-name")
    pkg.add_module("ff_fake_tsolo", "x = 5")
    with pkg:
        with pytest.raises(RuntimeError):
            pkg.add_module("ff_fake_tother")
        with pytest.raises(RuntimeError):
            pkg.__enter__()
        import ff_fake_tsolo

        assert ff_fake_tsolo.x == 5
    with pkg:  # re-enterable after exit
        import ff_fake_tsolo

        assert ff_fake_tsolo.x == 5


def test_package_mock_annotations_resolve():
    for fn in (tpm._MockLoader.__init__, tpm._MockLoader.create_module,
               tpm._MockLoader.exec_module, tpm.PackageMock.__init__, tpm._MockFinder.__init__):
        typing.get_type_hints(fn)


# -- initialization and helpers ---------------------------------------------------------------


def test_initialize_quantizers_matches_jax():
    j = JMLP(8, 16, 4, rngs=nnx.Rngs(0))
    t = TMLP(8, 16, 4, device="cpu")
    jnn.quantize_model(j)
    tnn.quantize_model(t)
    jtesting.initialize_quantizers_to_linear_quantizer(j)
    ttesting.initialize_quantizers_to_linear_quantizer(t)
    jq, tq = list(jnn.named_quantizers(j)), list(tnn.named_quantizers(t))
    assert [n for n, _ in jq] == [n.replace(".", "/") for n, _ in tq] and jq
    for (name, a), (_, b) in zip(jq, tq):
        assert type(b) is tnn.LinearQuantizer and b.num_bits == a.num_bits == 8, name
        np.testing.assert_array_equal(b.scale.detach().numpy(), np.asarray(a.scale[...]))
        np.testing.assert_array_equal(b.offset.detach().numpy(), np.asarray(a.offset[...]))
        assert b.quant_metadata is not None
        assert [x.name for x in b.quant_metadata.tags] == [x.name for x in a.quant_metadata.tags]


def test_is_close_to_rounding_matches_jax():
    x = np.random.RandomState(0).randn(1000).astype(np.float32) * 4
    x[:10] = np.arange(10) + 0.5
    got = ttesting.is_close_to_rounding(torch.from_numpy(x), 1.0, 1e-2).numpy()
    want = np.asarray(jtesting.is_close_to_rounding(jnp.asarray(x), 1.0, 1e-2))
    np.testing.assert_array_equal(got, want)
    assert got[:10].all()


def test_seed_prngs():
    gen = ttesting.seed_prngs(123, device="cpu")
    first = np.random.rand(3)
    jtesting.seed_prngs(123)
    np.testing.assert_array_equal(first, np.random.rand(3))
    assert isinstance(gen, torch.Generator) and gen.initial_seed() == 123
    assert gen.device.type == "cpu"
    assert torch.equal(torch.rand(4, generator=gen),
                       torch.rand(4, generator=torch.Generator().manual_seed(123)))


def test_string_helpers_match_jax():
    block = """
        a
          b
    """
    assert ttesting.dedent_strip(block) == jtesting.dedent_strip(block)
    ttesting.assert_strings_match_verbose("x\ny", "x\ny")
    with pytest.raises(AssertionError, match="strings do not match") as info:
        ttesting.assert_strings_match_verbose("x\ny", "x\nz")
    with pytest.raises(AssertionError) as jinfo:
        jtesting.assert_strings_match_verbose("x\ny", "x\nz")
    assert str(info.value) == str(jinfo.value)


# -- HF golden models -------------------------------------------------------------------------


def _jitted(model):
    """The NNX model's forward, jitted once (its eager ops compile one by one)."""
    graphdef, state = nnx.split(model)
    fn = jax.jit(lambda state, ids: nnx.merge(graphdef, state)(ids))
    return lambda ids: fn(state, jnp.asarray(ids))


def _close(port, want, tol):
    port, want = np.asarray(port, np.float64), np.asarray(want, np.float64)
    assert port.shape == want.shape
    err = np.abs(port - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


@pytest.fixture(scope="module", autouse=True)
def _transformers_without_tensorflow():
    """``transformers`` imports TensorFlow where it is installed (~9 s); the
    fixtures here use its torch models only."""
    if "transformers" not in sys.modules:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("USE_TF", "0")
            mp.setenv("USE_FLAX", "0")
            import transformers  # noqa: F401
    yield


@pytest.fixture(scope="module")
def hf_llama(tmp_path_factory):
    model, hf_cfg = tgolden.fabricate_hf_checkpoint(str(tmp_path_factory.mktemp("hf")), "tiny")
    tensors = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    ids = np.random.RandomState(0).randint(0, hf_cfg.vocab_size, (2, 12))
    return model, hf_cfg, tensors, ids


def test_llama_from_tensors_matches_jax_and_hf(hf_llama):
    model, hf_cfg, tensors, ids = hf_llama
    tc = tgolden.our_config(hf_cfg)
    jc = jgolden.our_config(hf_cfg)
    assert {f: getattr(tc, f) for f in vars(tc) if f != "dtype"} == \
        {f: getattr(jc, f) for f in vars(tc) if f != "dtype"}
    port = tgolden.llama_from_tensors(tensors, tc, device="cpu")
    assert port.embed_tokens.weight.dtype == torch.float32
    jmodel = jgolden.nnx_model_from_tensors(tensors, jc)
    with torch.no_grad():
        got = port(torch.from_numpy(ids))[0].numpy()
    jforward = _jitted(jmodel)
    want, _ = jforward(ids)
    _close(got, want, FLOAT_TOL)
    _close(got, tgolden.torch_logits(model, ids), HF_TOL)
    assert np.array_equal(tgolden.torch_logits(model, ids), jgolden.torch_logits(model, ids))
    # perplexities: the port's ppl, JAX's ppl_jax and HF's
    p_port = tgolden.ppl(lambda x: port(x)[0], ids, device="cpu")
    p_jax = jgolden.ppl_jax(lambda x: jforward(x)[0], ids)
    assert abs(p_port - p_jax) <= 1e-5 * p_jax
    assert abs(p_port - tgolden.ppl_torch(model, ids)) <= 1e-4 * p_port


def test_gpt2_from_hf_matches_jax_and_hf():
    model, hf_cfg = tgolden.fabricate_gpt2_model("tiny")
    tc, jc = tgolden.our_gpt2_config(hf_cfg), jgolden.our_gpt2_config(hf_cfg)
    assert tc.dtype == torch.float32 and tc.hidden_size == jc.hidden_size == 96
    port = tgolden.gpt2_from_hf(model, tc, device="cpu")
    jmodel = jgolden.nnx_gpt2_from_hf(model, jc)
    ids = np.random.RandomState(1).randint(0, hf_cfg.vocab_size, (2, 16))
    with torch.no_grad():
        got = port(torch.from_numpy(ids)).numpy()
    _close(got, _jitted(jmodel)(ids), FLOAT_TOL)
    _close(got, tgolden.torch_logits(model, ids), HF_TOL)
    # the sampled eval set is HF's own
    s1 = tgolden.sample_eval_set(model, hf_cfg.vocab_size, 2, 8)
    s2 = jgolden.sample_eval_set(model, hf_cfg.vocab_size, 2, 8)
    assert np.array_equal(s1, s2) and s1.shape == (2, 8)


def test_golden_dims_and_fabricators_are_jax_ones():
    assert tgolden.LLAMA_DIMS == jgolden.LLAMA_DIMS and tgolden.GPT2_DIMS == jgolden.GPT2_DIMS


def test_golden_models_need_cuda_unless_cpu_is_asked(monkeypatch, hf_llama):
    _, hf_cfg, tensors, ids = hf_llama
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tgolden.llama_from_tensors(tensors, tgolden.our_config(hf_cfg))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tgolden.ppl(lambda x: x, ids)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttesting.seed_prngs(0)
