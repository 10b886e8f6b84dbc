"""The port's GPTQ and layer-wise loops (`fastforward_tpu_torch/algorithms/`)
against the JAX package's (`fastforward_tpu/algorithms/`), on the CPU.

The same numpy weights (JAX's (in, out) layout, transposed for the port's
(out, in)) and correlated calibration inputs go through both packages'
functions; a granularity is mapped to torch's layout by
`nn.convert.transpose_granularity`. GPTQ's column loops round in other
orders (XLA fuses the error feedback's multiply-adds; the port's rank-1
updates do not), so its grids are compared by share.

Tolerances:
- the Hessian within rtol 1e-5 of the largest entry (f32 sums in other
  orders); the upper Cholesky factor of the dampened inverse of a
  well-conditioned Hessian within 1e-4 of its largest entry (two LAPACK
  factorizations);
- the core given JAX's factor (``act_order`` on and off; per output
  channel, per tensor, per block of 16 in-features): the integer grids
  equal in at least `GRID_SHARE` of the entries and one level apart
  elsewhere;
- with each package's own factor, the layer's reconstruction error
  ‖X Ŵ − X W‖ within `RECON_RTOL` (1e-3) relative of JAX's;
- on a module: the installed weight quantizer (type, bits, granularity)
  equal, its scales within 2^-21 relative (eager JAX divides where the
  port multiplies by the f32 reciprocal), its grid as the core's;
- `layerwise_optimize` (sequential and one pass): JAX's optimized paths in
  JAX's order, and the same grids by share;
- the port alone, at 12 layers: `layerwise_optimize_staged` over the query
  ``layers/*`` bit-equal to the same loop over the list of blocks in model
  order; at 2 layers, sequential `layerwise_optimize` over one query
  bit-equal to one call a target in model order (the JAX package takes
  mpath's string order, ``layers/10`` before ``layers/2`` and ``down_proj``
  before ``gate_proj``; the port does not copy that).
"""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from fastforward_tpu import nn as jnn
from fastforward_tpu import quantization as jq
from fastforward_tpu.algorithms import calculate_hessian as jhessian
from fastforward_tpu.algorithms import gptq as jgptq
from fastforward_tpu.algorithms import gptq_quantize as jquantize
from fastforward_tpu.algorithms import invert_hessian as jinvert
from fastforward_tpu.algorithms import layerwise_optimize as jlayerwise
from fastforward_tpu_torch import nn as tnn
from fastforward_tpu_torch.algorithms import calculate_hessian as thessian
from fastforward_tpu_torch.algorithms import gptq as tgptq
from fastforward_tpu_torch.algorithms import gptq_quantize as tquantize
from fastforward_tpu_torch.algorithms import invert_hessian as tinvert
from fastforward_tpu_torch.algorithms import layerwise_optimize as tlayerwise
from fastforward_tpu_torch.algorithms import layerwise_optimize_staged as tstaged
from fastforward_tpu_torch.models import llama as tllama
from fastforward_tpu_torch.nn import convert

tgptq_mod = importlib.import_module("fastforward_tpu_torch.algorithms.gptq")

GRID_SHARE = 0.99
RECON_RTOL = 1e-3
K, M, N_ROWS = 64, 32, 512
GRANS = {
    "per_channel": jq.PerChannel(1),
    "per_tensor": jq.PerTensor(),
    "per_block": jq.PerBlock(block_dims=0, block_sizes=16, per_channel_dims=1),
}


def _data(seed=0, k=K, m=M):
    rs = np.random.RandomState(seed)
    base = rs.randn(N_ROWS, 8).astype(np.float32)
    x = base @ rs.randn(8, k).astype(np.float32) + 0.1 * rs.randn(N_ROWS, k).astype(np.float32)
    x *= np.linspace(0.2, 3.0, k, dtype=np.float32)
    return x.astype(np.float32), rs.randn(k, m).astype(np.float32)


def _tgran(jgran):
    return convert.transpose_granularity(jgran, convert.LINEAR_WEIGHT_PERM)


def _grids_agree(port_q, jax_q):
    """The port's (out, in) grid against JAX's (in, out) one."""
    a, b = np.asarray(port_q), np.asarray(jax_q).T
    assert a.shape == b.shape
    assert (a == b).mean() >= GRID_SHARE, (a != b).mean()
    assert np.abs(a - b).max() <= 1


def _recon(x, w, w_dq):
    return float(np.linalg.norm(x.astype(np.float64) @ (np.asarray(w_dq, np.float64) - w)))


def test_hessian_and_inverse_factor_match_jax():
    x, _ = _data()
    hj, ht = np.asarray(jhessian(jnp.asarray(x))), thessian(torch.from_numpy(x)).numpy()
    assert np.abs(ht - hj).max() <= 1e-5 * np.abs(hj).max()
    # the factor of a well-conditioned Hessian (the calibration one's
    # condition number amplifies the factorizations' roundings)
    a = np.random.RandomState(5).randn(K, K).astype(np.float32)
    h = (a @ a.T + K * np.eye(K)).astype(np.float32)
    uj = np.asarray(jinvert(jnp.asarray(h)))
    ut = tinvert(torch.from_numpy(h)).numpy()
    assert np.abs(ut - uj).max() <= 1e-4 * np.abs(uj).max()
    assert np.array_equal(np.triu(ut), ut)


@pytest.mark.parametrize("act_order", [False, True], ids=["natural", "act_order"])
@pytest.mark.parametrize("gran", list(GRANS))
def test_core_given_jax_factor(monkeypatch, gran, act_order):
    # GIVEN the same weight, inputs and grid; the port's inversion replaced
    # by JAX's on the same (permuted) Hessian
    x, w = _data(1)
    monkeypatch.setattr(tgptq_mod, "invert_hessian", lambda h, d: torch.from_numpy(
        np.asarray(jinvert(jnp.asarray(h.numpy()), d))))
    kw = dict(num_bits=4, block_size=16, act_order=act_order)
    qj, wj, sj = jquantize(jnp.asarray(w), jnp.asarray(x), granularity=GRANS[gran], **kw)
    qt, wt, st = tquantize(torch.from_numpy(w.T.copy()), torch.from_numpy(x),
                           granularity=_tgran(GRANS[gran]), **kw)
    # THEN the integer grids agree but in a small share, by one level
    _grids_agree(qt.numpy(), qj)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj).T, rtol=2.0 ** -21)
    assert np.asarray(qj).min() >= -8 and np.asarray(qj).max() <= 7


@pytest.mark.parametrize("act_order", [False, True], ids=["natural", "act_order"])
def test_reconstruction_error_matches_jax(act_order):
    x, w = _data(2)
    gran = GRANS["per_channel"]
    _, wj, _ = jquantize(jnp.asarray(w), jnp.asarray(x), granularity=gran, block_size=16,
                         act_order=act_order)
    _, wt, _ = tquantize(torch.from_numpy(w.T.copy()), torch.from_numpy(x),
                         granularity=_tgran(gran), block_size=16, act_order=act_order)
    ej, et = _recon(x, w, wj), _recon(x, w, wt.numpy().T)
    assert abs(et - ej) <= RECON_RTOL * ej, (et, ej)
    # and GPTQ beats round-to-nearest on the same grid
    s = np.abs(w).max(axis=0, keepdims=True) / 7
    rtn = np.clip(np.round(w / s), -8, 7) * s
    assert et < _recon(x, w, rtn)


def _linear_pair(seed=0):
    j = nnx.Linear(K, M, rngs=nnx.Rngs(seed))
    t = torch.nn.Linear(K, M)
    convert.load_nnx_params(t, {"kernel": np.asarray(j.kernel[...]),
                                "bias": np.asarray(j.bias[...])})
    jnn.quantize_model(j)
    tnn.quantize_model(t)
    return j, t


@pytest.mark.parametrize("slot", ["stub", "configured"])
def test_module_gptq_installs_jax_quantizer(slot):
    # GIVEN the same Linear in both packages, its weight slot a stub or a
    # configured 4-bit block quantizer
    j, t = _linear_pair()
    gran = GRANS["per_block"]
    if slot == "configured":
        j.weight_quantizer = jnn.LinearQuantizer(4, granularity=gran, symmetric=True)
        t.weight_quantizer = tnn.LinearQuantizer(4, granularity=_tgran(gran), symmetric=True)
    x, _ = _data(3)
    # WHEN GPTQ runs on each
    jgptq(j, jnp.asarray(x), num_bits=4, granularity=gran, block_size=16)
    tgptq(t, torch.from_numpy(x), num_bits=4, granularity=_tgran(gran), block_size=16)
    # THEN the same quantizer, its scales JAX's, and the same grid by share
    jqz, tqz = j.weight_quantizer, t.weight_quantizer
    assert type(tqz).__name__ == type(jqz).__name__ == "LinearQuantizer"
    assert tqz.num_bits == jqz.num_bits == 4 and repr(tqz.granularity) == repr(_tgran(gran))
    js = convert._reorder_tiles(np.asarray(jqz.scale[...]), _tgran(gran), (M, K), (1, 0))
    np.testing.assert_allclose(tqz.scale.detach().numpy(), js, rtol=2.0 ** -21)
    with torch.no_grad():
        tgrid = tqz(t.weight).raw_data.numpy()
    _grids_agree(tgrid, np.asarray(jqz(j.kernel[...]).raw_data))


class JMLP(nnx.Module):
    def __init__(self, rngs):
        self.fc1 = nnx.Linear(32, 64, rngs=rngs)
        self.fc2 = nnx.Linear(64, 16, rngs=rngs)

    def __call__(self, x):
        h = self.fc1(x)
        h = h.dequantize() if isinstance(h, jq.QuantizedArray) else h
        return self.fc2(h)


class TMLP(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = torch.nn.Linear(32, 64)
        self.fc2 = torch.nn.Linear(64, 16)

    def forward(self, x):
        from fastforward_tpu_torch.quantization import dequantize_if_quantized

        return self.fc2(dequantize_if_quantized(self.fc1(x)))


@pytest.mark.parametrize("sequential", [True, False], ids=["sequential", "one_pass"])
def test_layerwise_optimize_matches_jax(sequential):
    j, t = JMLP(nnx.Rngs(0)), TMLP()
    convert.load_nnx_params(t, {"/".join(str(p) for p in path): np.asarray(v[...])
                                for path, v in nnx.to_flat_state(nnx.state(j, nnx.Param))})
    jnn.quantize_model(j)
    tnn.quantize_model(t)
    rs = np.random.RandomState(4)
    batches = [rs.randn(64, 32).astype(np.float32) for _ in range(3)]
    jpaths = jlayerwise(j, [jnp.asarray(b) for b in batches], jgptq, num_bits=4,
                        sequential=sequential)
    tpaths = tlayerwise(t, [torch.from_numpy(b) for b in batches], tgptq, num_bits=4,
                        sequential=sequential)
    assert tpaths == jpaths == ["fc1", "fc2"]
    for name in ("fc1", "fc2"):
        jm, tm = getattr(j, name), getattr(t, name)
        with torch.no_grad():
            tgrid = tm.weight_quantizer(tm.weight).raw_data.numpy()
        _grids_agree(tgrid, np.asarray(jm.weight_quantizer(jm.kernel[...]).raw_data))


# --- model order at depth ------------------------------------------------------

DEPTH = 12


def _deep_model(seed=0, depth=DEPTH):
    """A Llama of 32 wide, converted; at 12 layers (more than 10 stages)
    mpath's string order puts ``layers/10`` before ``layers/2``."""
    cfg = dataclasses.replace(tllama.LlamaConfig.tiny(), vocab_size=64, hidden_size=32,
                              intermediate_size=64, num_layers=depth, num_heads=2,
                              num_kv_heads=1, head_dim=16)
    model = tllama.LlamaForCausalLM(cfg, device="cpu",
                                    generator=torch.Generator().manual_seed(seed))
    tnn.quantize_model(model)
    return model


def _deep_batches():
    rs = np.random.RandomState(6)
    return [torch.from_numpy(rs.randint(0, 64, (2, 16)).astype(np.int64))]


DEEP_KW = dict(forward=lambda m, x: m(x)[0], num_bits=4, block_size=16)


def test_staged_stages_run_in_model_order():
    # GIVEN a 12-layer model staged by the query "layers/*", and its twin
    # (the same seed) staged by the list of its blocks in model order
    a, b = _deep_model(), _deep_model()
    paths = tstaged(a, _deep_batches(), tgptq, stages="layers/*", **DEEP_KW)
    want = tstaged(b, _deep_batches(), tgptq, stages=list(b.layers), **DEEP_KW)
    # THEN each stage calibrated on the output of the block before it in the
    # model: the query's result is the list's, bit for bit, in model order
    names = ["self_attn/q_proj", "self_attn/k_proj", "self_attn/v_proj", "self_attn/o_proj",
             "mlp/gate_proj", "mlp/up_proj", "mlp/down_proj"]
    assert paths == [f"layers/{i}/{n}" for i in range(DEPTH) for n in names]
    assert want == [f"stage{i}/{n}" for i in range(DEPTH) for n in names]
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name


def test_sequential_targets_run_in_model_order():
    # GIVEN a 2-layer model whose MLP projections are optimized sequentially
    # by one query (mpath's order: down_proj, gate_proj, up_proj), and its
    # twin one projection after another in model order
    a, b = _deep_model(1, depth=2), _deep_model(1, depth=2)
    order = [f"layers/{i}/mlp/{n}" for i in range(2) for n in ("gate_proj", "up_proj", "down_proj")]
    paths = tlayerwise(a, _deep_batches(), tgptq, targets="**/mlp/*", **DEEP_KW)
    for target in order:
        tlayerwise(b, _deep_batches(), tgptq, targets=target, **DEEP_KW)
    # THEN each projection was captured after the ones before it in the model
    # were optimized: the same weights, bit for bit, and the paths in model order
    assert paths == order
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
