"""The last TPU kernel bodies against the JAX package, on the CPU: row 9's
dot-raw (``FF_2L_DOTRAW``) and concat-pairs (``FF_2L_CONCAT_PAIRS``)
bodies of the stacked W4A8 GEMV, row 18's tiled W4A16 body and row 24's
int4/int8 dot probe.

The JAX bodies run in Pallas interpret mode, in a `pallas_call` built here
as the JAX package builds it (`matmul.py:1217`, `:1866`,
`scripts/tpu_probe_int4.py:70`). Inputs are made by numpy from a seed and
handed to both packages. Tolerances: the GEMV bodies and the probe are
bit-equal; the tiled W4A16 body is within one bf16 ulp of each output
(XLA's CPU dot sums a group in its own order, which depends on the CPU's
instructions; the share of bit-equal outputs is asserted above 0.9).
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from fastforward_tpu import flags as jflags
from fastforward_tpu.kernels import matmul as jm
from fastforward_tpu.kernels import packing as jpk
from fastforward_tpu.serving import engine as je
from fastforward_tpu.serving import stacked as js
from fastforward_tpu_torch import flags as tflags
from fastforward_tpu_torch.kernels import matmul as tm
from fastforward_tpu_torch.scripts import probe_int4 as tp
from fastforward_tpu_torch.serving import stacked as ts
from tests.test_torch_preblock import (  # noqa: F401  (tiny: a module fixture)
    EXACT,
    L,
    _bytes,
    _jax_prefill,
    _port_cache,
    _stacked,
    tiny,
)

REPO = Path(__file__).resolve().parent.parent


def _t(a):
    return torch.from_numpy(np.array(a))


def _operands(M, K, N, g, seed):
    """Stacked paired W4A8 operands of both packages (L layers) and the
    activations quantized by the jitted JAX quantizer."""
    w, m, s = _stacked(K, N, g, seed)
    x = np.random.RandomState(seed + 1).randn(M, K).astype(np.float32)
    qj, sj = jax.jit(jm.quantize_rowwise)(jnp.asarray(x))
    mp = jpk.pack_mult_nibbles(jnp.asarray(m))
    return dict(qj=qj, sj=sj, w=jnp.asarray(w), m=m, mp=mp, s=jnp.asarray(s),
                qt=_t(qj), st=_t(sj), wt=torch.from_numpy(w), mpt=_t(mp), s_t=torch.from_numpy(s))


def _jax_body(body, o, layer, g, bn, preblocked):
    """JAX's stacked GEMV body over layer ``layer`` in interpret mode, in a
    `pallas_call` built as `matmul.py:1149-1237` builds the default call
    (M a multiple of 8, N of bn)."""
    x_q, x_s, w, mp, s = o["qj"], o["sj"], o["w"], o["mp"], o["s"]
    M, K = x_q.shape
    Lw, Kh, N = w.shape
    if preblocked:
        w = jm.preblock_stacked(w, bn)
        w_spec = pl.BlockSpec((1, 1, Kh, bn), lambda j, l: (l[0], j, 0, 0))
    else:
        w_spec = pl.BlockSpec((1, Kh, bn), lambda j, l: (l[0], 0, j))
    n_pack = mp.shape[1]
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(N // bn,),
        in_specs=[pl.BlockSpec((M, K), lambda j, l: (0, 0)),
                  pl.BlockSpec((M, 1), lambda j, l: (0, 0)), w_spec,
                  pl.BlockSpec((1, n_pack, bn), lambda j, l: (l[0], 0, j)),
                  pl.BlockSpec((1, 1, bn), lambda j, l: (l[0], 0, j))],
        out_specs=pl.BlockSpec((M, bn), lambda j, l: (0, j)),
        scratch_shapes=[pltpu.VMEM((M, bn), jnp.int32)])
    part = functools.partial(body, n_groups=K // g, group=g)
    if preblocked:
        def kernel(l_ref, x_ref, xs_ref, wp_ref, m_ref, sc_ref, out_ref, acc_ref):
            part(l_ref, x_ref, xs_ref, wp_ref.at[:, 0], m_ref, sc_ref, out_ref, acc_ref)
    else:
        kernel = part
    return pl.pallas_call(kernel, grid_spec=grid_spec, interpret=True,
                          out_shape=jax.ShapeDtypeStruct((M, N), jnp.bfloat16))(
        jnp.asarray([layer], jnp.int32), x_q, x_s.reshape(M, 1), w, mp, s.reshape(Lw, 1, N))


def _port_route(o, layer, g, monkeypatch, bn=None, **env):
    """The port's stacked GEMV on the CPU under the flags ``env``, on flat
    or (``bn``) pre-blocked weights."""
    for var in ("FF_2L_MANUAL", "FF_2L_SPLITW", "FF_2L_DOTRAW", "FF_2L_CONCAT_PAIRS"):
        monkeypatch.delenv(var, raising=False)
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    w = o["wt"] if bn is None else tm.preblock_stacked(o["wt"], bn)
    return tm.matmul_w4a8_2l_gemv_stacked(o["qt"], o["st"], w, o["mpt"], o["s_t"], layer,
                                          group_size=g)


def _oracle(o, layer, g):
    return tm.matmul_w4a8_2l_reference(o["qt"], o["st"], o["wt"][layer],
                                       torch.from_numpy(o["m"][layer]), o["s_t"][layer], None, g,
                                       paired=True)


# --- Flags and the route choice


FLAGS = [("two_level_dotraw", "FF_2L_DOTRAW", ["1", "0", "true"]),
         ("two_level_concat_pairs", "FF_2L_CONCAT_PAIRS", ["1", "2", "4", "0"])]


@pytest.mark.parametrize("name,var,values", FLAGS, ids=[f[1] for f in FLAGS])
def test_flags_parse_like_jax(monkeypatch, name, var, values):
    monkeypatch.delenv(var, raising=False)
    assert getattr(tflags, name)() == getattr(jflags, name)()
    for value in values:
        monkeypatch.setenv(var, value)
        assert getattr(tflags, name)() == getattr(jflags, name)()


def _jax_route(monkeypatch, preblocked, n_groups, env):
    """The body JAX's `matmul_w4a8_2l_gemv_stacked` hands `pallas_call` on
    its TPU route under ``env``, named by the port's launch counts; the
    default body's concat-pairs branch read from its own condition
    (`matmul.py:834`)."""
    g, N, bn = 8, 256, 128
    K = n_groups * g
    for var in ("FF_2L_MANUAL", "FF_2L_SPLITW", "FF_2L_DOTRAW", "FF_2L_CONCAT_PAIRS",
                "FF_2L_SKIPFOLD", "FF_2L_SKIPDOT", "FF_2L_BUFFERS", "FF_2L_LOOKAHEAD"):
        monkeypatch.delenv(var, raising=False)
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    seen = []

    def spy(kernel, *, out_shape, **kw):
        seen.append(kernel)
        return lambda *args: jnp.zeros(out_shape.shape, out_shape.dtype)

    monkeypatch.setattr(jm, "_on_tpu", lambda: True)
    monkeypatch.setattr(jm.pl, "pallas_call", spy)
    w = jnp.zeros((1, K // 2, N), jnp.int8)
    if preblocked:
        w = jm.preblock_stacked(w, bn)
    jm.matmul_w4a8_2l_gemv_stacked(jnp.zeros((8, K), jnp.int8), jnp.ones((8,)), w,
                                   jnp.zeros((1, -(-n_groups // 8), N), jnp.int32),
                                   jnp.ones((1, N)), jnp.int32(0), group_size=g, block_n=bn)
    concat = (jflags.two_level_concat_pairs() > 1 and not jflags.two_level_skipfold()
              and not jflags.two_level_skipdot())
    monkeypatch.undo()
    (kernel,) = seen
    if not isinstance(kernel, functools.partial):  # the pre-blocked wrapper of a body
        kernel = next(c.cell_contents for c in kernel.__closure__
                      if isinstance(c.cell_contents, functools.partial))
    body = kernel.func
    if body is jm._w4a8_2l_gemv_stacked_manual_kernel:
        return "w4a8_gemv_manual"
    if body is jm._w4a8_2l_gemv_stacked_kernel_splitw:
        return "w4a8_gemv_splitw"
    if body is jm._w4a8_2l_gemv_stacked_kernel_dotraw:
        return "w4a8_gemv_dotraw"
    assert body is jm._w4a8_2l_gemv_stacked_kernel
    if concat:
        return "w4a8_gemv_concat"
    return "w4a8_gemv_preblocked" if preblocked else "w4a8_gemv_stacked"


ENVS = [dict(zip(("FF_2L_MANUAL", "FF_2L_SPLITW", "FF_2L_DOTRAW", "FF_2L_CONCAT_PAIRS"), v))
        for v in [(m, sw, d, c) for m in ("0", "4") for sw in ("0", "1") for d in ("0", "1")
                  for c in ("1", "4")]]


@pytest.mark.parametrize("preblocked", [False, True])
@pytest.mark.parametrize("n_groups", [8, 6])
def test_route_choice_follows_jax_under_every_flag_combination(monkeypatch, preblocked, n_groups):
    # GIVEN every combination of the four route flags, on both layouts, at
    # a group count split-W takes (8) and one it does not (6)
    for env in ENVS:
        # WHEN JAX picks its body and the port its route
        jax_route = _jax_route(monkeypatch, preblocked, n_groups, env)
        port_route = tm.stacked_gemv_route(
            preblocked, n_groups, n_groups * 4, int(env["FF_2L_MANUAL"]),
            env["FF_2L_SPLITW"] == "1", env["FF_2L_DOTRAW"] == "1",
            int(env["FF_2L_CONCAT_PAIRS"]))
        # THEN they agree
        assert port_route == jax_route, env


# --- The dot-raw and concat-pairs bodies


@pytest.mark.parametrize("preblocked", [False, True], ids=["flat", "preblocked"])
@pytest.mark.parametrize("K,cp", [(768, 3), (1024, 2), (1024, 4)])
def test_concat_pairs_plain_version_equals_jax_body(monkeypatch, preblocked, K, cp):
    # GIVEN paired W4A8 operands whose pair count cp divides
    g = 128
    o = _operands(8, K, 256, g, seed=K + cp)
    # WHEN JAX's default body runs under FF_2L_CONCAT_PAIRS=cp (its concat
    # branch) and the port's route under the same flag
    monkeypatch.setenv("FF_2L_CONCAT_PAIRS", str(cp))
    a = _jax_body(jm._w4a8_2l_gemv_stacked_kernel, o, 1, g, 128, preblocked)
    seen = []
    fn = tm.matmul_w4a8_2l_concat_reference
    monkeypatch.setattr(tm, "matmul_w4a8_2l_concat_reference",
                        lambda *a_, **k: seen.append(a_[5]) or fn(*a_, **k))
    b = _port_route(o, 1, g, monkeypatch, bn=128 if preblocked else None,
                    FF_2L_CONCAT_PAIRS=str(cp))
    # THEN the port took its concat-pairs plain version, and both equal the
    # oracle bit for bit
    assert seen == [cp]
    assert _bytes(a) == _bytes(b)
    assert torch.equal(b, _oracle(o, 1, g))


@pytest.mark.parametrize("preblocked", [False, True], ids=["flat", "preblocked"])
@pytest.mark.parametrize("M,K,N,g", [(8, 768, 256, 128), (16, 512, 128, 64)])
def test_dotraw_plain_version_equals_jax_body(monkeypatch, preblocked, M, K, N, g):
    # GIVEN paired W4A8 operands
    o = _operands(M, K, N, g, seed=M + K)
    # WHEN JAX's dot-raw body runs and the port's route under FF_2L_DOTRAW=1
    a = _jax_body(jm._w4a8_2l_gemv_stacked_kernel_dotraw, o, 2, g, 128, preblocked)
    seen = []
    fn = tm.matmul_w4a8_2l_dotraw_reference
    monkeypatch.setattr(tm, "matmul_w4a8_2l_dotraw_reference",
                        lambda *a_, **k: seen.append(1) or fn(*a_, **k))
    b = _port_route(o, 2, g, monkeypatch, bn=128 if preblocked else None, FF_2L_DOTRAW="1")
    # THEN the port took its dot-raw plain version, and both equal the
    # oracle bit for bit
    assert seen == [1]
    assert _bytes(a) == _bytes(b)
    assert torch.equal(b, _oracle(o, 2, g))


def test_jax_concat_pairs_body_drops_trailing_pairs(monkeypatch):
    # A difference inside the reference (ROADMAP.md Queue 3). GIVEN 3 group
    # pairs (K 768, g128) and FF_2L_CONCAT_PAIRS=2
    g = 128
    o = _operands(8, 768, 256, g, seed=3)
    ref = _oracle(o, 1, g)
    monkeypatch.setenv("FF_2L_CONCAT_PAIRS", "2")
    # WHEN JAX's body runs (one unit of 2 pairs: the third is never dotted)
    a = _t(_jax_body(jm._w4a8_2l_gemv_stacked_kernel, o, 1, g, 128, False).astype(jnp.float32))
    # THEN most of its outputs differ from the oracle, and it equals the
    # oracle with the third pair's weights zeroed (u = 8)
    assert (a != ref.float()).float().mean() > 0.9
    o3 = dict(o)
    w = np.array(o["w"])
    w[:, 2 * g:] = np.int8(-120)  # 0x88: both nibbles 8, v = 0
    o3["wt"] = torch.from_numpy(w)
    assert torch.equal(a, _oracle(o3, 1, g).float())
    # AND the port computes every pair: its last unit is one pair long
    b = _port_route(o, 1, g, monkeypatch, FF_2L_CONCAT_PAIRS="2")
    assert torch.equal(b, ref)


@pytest.mark.parametrize("env", [{"FF_2L_DOTRAW": "1"}, {"FF_2L_CONCAT_PAIRS": "2"},
                                 {"FF_2L_CONCAT_PAIRS": "3"}, {"FF_2L_CONCAT_PAIRS": "4"}],
                         ids=["dotraw", "concat2", "concat3", "concat4"])
def test_greedy_tokens_under_each_flag_equal_jax(tiny, jax_tokens, monkeypatch, env):
    # GIVEN the port's fused flat layers and JAX's prefill cache; every
    # projection through the stacked GEMV (FF_FUSED_LAYER=0)
    jc, jp, jl, tc, tp, tl = tiny
    taken = []
    for name in ("matmul_w4a8_2l_dotraw_reference", "matmul_w4a8_2l_concat_reference"):
        fn = getattr(tm, name)
        monkeypatch.setattr(tm, name, lambda *a, _fn=fn, _n=name, **k: taken.append(_n) or
                            _fn(*a, **k))
    monkeypatch.setenv("FF_FUSED_LAYER", "0")
    layers = ts.fuse_stacked_layers(tl)
    first = torch.from_numpy(np.array(jax_tokens["first"])).long()

    def decode():
        return ts.make_stacked_decode_loop(tc, jax_tokens["steps"])(
            tp, layers, _port_cache(jax_tokens["jcache"], jax_tokens["T"]), first)[0]

    plain = decode()
    assert taken == []
    # WHEN the port decodes under the flag
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    flagged = decode()
    # THEN every projection of every step took the flag's plain version,
    # and the tokens are the unflagged run's and JAX's
    want = ("matmul_w4a8_2l_dotraw_reference" if "FF_2L_DOTRAW" in env
            else "matmul_w4a8_2l_concat_reference")
    assert taken == [want] * (4 * L * jax_tokens["steps"])
    assert torch.equal(flagged, plain)
    np.testing.assert_array_equal(jax_tokens["tokens"], flagged.numpy())


@pytest.fixture(scope="module")
def jax_tokens(tiny):
    """JAX's greedy tokens over its fused flat layers from its own prefill
    cache (B = 4, T = 8, 5 steps), FF_FUSED_LAYER=0: the stacked GEMV for
    every projection (JAX's CPU path takes its oracle whatever the GEMV
    flags)."""
    jc, jp, jl, tc, tp, tl = tiny
    B, T, steps = 4, 8, 5
    ids = np.random.RandomState(12).randint(0, jc.vocab_size, (B, T))
    with pytest.MonkeyPatch.context() as mp:
        for var in ("FF_FUSED_QKV", "FF_FUSED_OGU", "FF_FUSED_ARGMAX"):
            mp.delenv(var, raising=False)
        mp.setenv("FF_FUSED_LAYER", "0")
        jf = js.fuse_stacked_layers(jl)
        jcache, first = _jax_prefill(jc, jp, jf, ids)
        mp.setattr(js, "_serving_on_tpu", lambda: True)
        mp.setattr(je, "_on_tpu", lambda: True)
        mp.setenv("FF_KV_STACKED", "force")
        loop = js.make_stacked_decode_loop(jc, steps, donate=False)
        args = (jp, jf, jcache, first)
        tokens, _ = loop.lower(*args).compile(compiler_options=EXACT)(*args)
    return dict(T=T, steps=steps, jcache=jcache, first=first, tokens=np.asarray(tokens))


# --- Row 18: the tiled W4A16 body


def _jax_w4a16_tiled(x, w, s, g, bm, bn):
    """JAX's `_w4a16_kernel` in interpret mode, in the `pallas_call` of
    `matmul.py:1862-1885` (bias added after it, as `:1886-1887`)."""
    M, K = x.shape
    N = w.shape[1]
    n_groups = K // g
    return pl.pallas_call(
        functools.partial(jm._w4a16_kernel, n_k=n_groups),
        grid=(pl.cdiv(M, bm), pl.cdiv(N, bn), n_groups),
        in_specs=[pl.BlockSpec((bm, g), lambda i, j, k: (i, k)),
                  pl.BlockSpec((g // 2, bn), lambda i, j, k: (k, j)),
                  pl.BlockSpec((1, 1, bn), lambda i, j, k: (k, 0, j))],
        out_specs=pl.BlockSpec((bm, bn), lambda i, j, k: (i, j)),
        out_shape=jax.ShapeDtypeStruct((M, N), x.dtype),
        scratch_shapes=[pltpu.VMEM((bm, bn), jnp.float32)],
        interpret=True,
    )(x, w, s.reshape(n_groups, 1, N))


def _within_one_bf16_ulp(a, b):
    a, b = a.float(), b.float()
    mag = torch.maximum(a.abs(), b.abs()).clamp_min(torch.finfo(torch.float32).tiny)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return bool(((a - b).abs() <= ulp).all())


@pytest.mark.parametrize("M,K,N,g,bias", [(16, 256, 256, 128, False), (24, 512, 256, 64, True),
                                          (8, 256, 384, 32, False)])
def test_w4a16_tiled_plain_version_equals_jax_body(M, K, N, g, bias):
    # GIVEN bf16 activations and pack_int4 weights with f32 group scales
    rs = np.random.RandomState(M + K + g)
    x = jnp.asarray(rs.randn(M, K).astype(np.float32)).astype(jnp.bfloat16)
    w = jpk.pack_int4(jnp.asarray(rs.randint(-8, 8, (K, N)).astype(np.int8)), g)
    s = jnp.asarray((rs.rand(K // g, N) * 1e-2 + 1e-4).astype(np.float32))
    b = (rs.randn(N) * 0.1).astype(np.float32) if bias else None
    # WHEN JAX's tiled body runs (bias added as its wrapper adds it) and the
    # port's plain version on the same bytes
    a = _jax_w4a16_tiled(x, w, s, g, bm=8, bn=128)
    if bias:
        a = (a.astype(jnp.float32) + jnp.asarray(b)).astype(jnp.bfloat16)
    a = _t(a.astype(jnp.float32))
    out = tm.matmul_w4a16_tiled(_t(x.astype(jnp.float32)).to(torch.bfloat16), _t(w), _t(s),
                                None if b is None else torch.from_numpy(b), g)
    # THEN each output is within one bf16 ulp of JAX's, nearly all equal
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (M, N)
    assert _within_one_bf16_ulp(out, a)
    assert (out.float() == a).float().mean() > 0.9
    # AND the weight rounds twice: the serving route's oracle (one rounding)
    # differs from it
    once = tm.matmul_w4a16_reference(_t(x.astype(jnp.float32)).to(torch.bfloat16), _t(w), _t(s),
                                     None, g)
    if not bias:
        assert not torch.equal(once, out)


# --- Row 24: the int4 / int8 dot probe


def _tpu_probe_module(bm, k, panels, rounds):
    """`scripts/tpu_probe_int4.py` loaded from its file with its sizes set
    (its kernel reads them as module globals)."""
    spec = importlib.util.spec_from_file_location("tpu_probe_int4",
                                                  REPO / "scripts" / "tpu_probe_int4.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.BM, mod.K, mod.N, mod.PANELS, mod.ROUNDS = bm, k, k, panels, rounds
    return mod


def _probe_inputs(bm, k, panels, seed):
    rs = np.random.RandomState(seed)
    x = rs.randint(0, 16, (bm, k)).astype(np.int8)
    w = rs.randint(-8, 8, (panels, k, k)).astype(np.int8)
    return x, w


@pytest.mark.parametrize("bm,k,panels,rounds", [(16, 128, 2, 3), (8, 64, 3, 5)])
def test_probe_int8_plain_version_equals_jax_kernel(bm, k, panels, rounds):
    # GIVEN the TPU probe's kernel at a small size, and its inputs
    mod = _tpu_probe_module(bm, k, panels, rounds)
    x, w = _probe_inputs(bm, k, panels, seed=bm + k)
    # WHEN it runs one call in interpret mode, int8 form
    a = pl.pallas_call(functools.partial(mod._kernel, int4=False), interpret=True,
                       out_shape=jax.ShapeDtypeStruct((bm, k), jnp.int8))(jnp.asarray(x),
                                                                        jnp.asarray(w))
    # THEN the port's probe on the CPU (each instruction's route, plain)
    # gives its bytes
    for inst in ("dp4a", "mma_s8", "mma_bf16"):
        b = tp.make_probe(False, inst, rounds)(torch.from_numpy(x), torch.from_numpy(w))
        assert b.dtype == torch.int8 and _bytes(a) == _bytes(b), inst


def _jnp_probe_int4(x, w, rounds):
    """The probe's int4 form written with jnp int4 casts and int32 dots
    (XLA:CPU runs no int4 dot)."""
    x = jnp.asarray(x).astype(jnp.int4)
    w = jnp.asarray(w).astype(jnp.int4).astype(jnp.int32)
    for r in range(rounds):
        acc = sum(jax.lax.dot(x.astype(jnp.int32), w[p], preferred_element_type=jnp.int32)
                  for p in range(w.shape[0]))
        x = jnp.bitwise_and(acc + r, 0x0F).astype(jnp.int8).astype(jnp.int4)
    return x.astype(jnp.int8)


@pytest.mark.parametrize("bm,k,panels,rounds", [(16, 128, 2, 3), (8, 64, 3, 5)])
def test_probe_int4_plain_version_equals_jnp_int4(bm, k, panels, rounds):
    # GIVEN the probe's inputs, w drawn past int4 too (int4 wraps it)
    x, w = _probe_inputs(bm, k, panels, seed=7 * bm + k)
    w = (w * 3).astype(np.int8)
    # WHEN the int4 form runs in jnp and the port's probe (int4 and int8
    # tensor-core routes, plain) on the same inputs
    a = _jnp_probe_int4(x, w, rounds)
    for inst in ("mma_s4", "mma_s8"):
        b = tp.make_probe(True, inst, rounds)(torch.from_numpy(x), torch.from_numpy(w))
        # THEN the bytes are equal, every value a sign-extended nibble
        assert _bytes(a) == _bytes(b), inst
        assert int(b.min()) >= -8 and int(b.max()) <= 7


def test_probe_knobs_read_the_tpu_probe_defaults(monkeypatch):
    # GIVEN no P4_* variable WHEN the knobs are read THEN they are the TPU
    # probe's defaults; and each variable sets its knob
    for var in ("P4_BM", "P4_K", "P4_N", "P4_PANELS", "P4_ROUNDS", "P4_SCAN", "P4_PAIRS",
                "P4_COPIES"):
        monkeypatch.delenv(var, raising=False)
    k = tp.Knobs.from_env()
    assert (k.bm, k.k, k.n, k.panels, k.rounds) == (192, 512, 512, 6, 16)
    spec = importlib.util.spec_from_file_location("p4", REPO / "scripts" / "tpu_probe_int4.py")
    fresh = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fresh)
    assert (k.bm, k.k, k.n, k.panels, k.rounds, k.scan, k.pairs) == (
        fresh.BM, fresh.K, fresh.N, fresh.PANELS, fresh.ROUNDS, fresh.SCAN, fresh.PAIRS)
    monkeypatch.setenv("P4_ROUNDS", "3")
    monkeypatch.setenv("P4_COPIES", "5")
    k = tp.Knobs.from_env()
    assert (k.rounds, k.copies) == (3, 5)
    # AND the default copies put two 64-row blocks on each of 132 SMs
    assert tp.default_copies(192, 132) * 3 >= 2 * 132
