"""Row 9's routes on the int8 tensor-core tile and row 3's chunked flash
decode, against the JAX package on the CPU.

On the card every route of the stacked W4A8 GEMV (`stacked_gemv_route`)
runs `csrc/w4a8_mma.cuh`'s tile, planned by `mma_plan`, and flash decode
(`csrc/flash_decode.cu`) walks the live tokens in chunks of 64. Here the
plain versions those kernels are held to are held to the JAX package:
the stacked GEMV under each route's flags bit for bit (the dot-raw and
concat-pairs routes run their own plain versions, JAX its CPU path), the
tile's split arithmetic over (b)'s four stacked projections bit for bit,
and the flash-decode plain versions (slab and paged) within one bf16 ulp
of the largest output (rtol 8e-3: f32 softmax in another summation order)
at the chunk and page edges.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastforward_tpu.kernels import attention as ja
from fastforward_tpu.kernels import matmul as jm
from fastforward_tpu.kernels import packing as jpk
from fastforward_tpu_torch.kernels import attention as ta
from fastforward_tpu_torch.kernels import matmul as tm
from fastforward_tpu_torch.kernels import paged_attention as tpa
from tests.test_torch_gemv_mma import PROJ, _tile_emulation

L = 3                  # stacked layers
RTOL = 8e-3
CHUNK = 64             # tokens a flash-decode chunk (csrc/flash_decode.cu kC)


def _bits(a):
    if isinstance(a, torch.Tensor):
        return (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy().tobytes()
    return np.asarray(a).tobytes()


# --- Row 9: every route's plain version against JAX's stacked GEMV

# (flags, the route on flat weights, the route on pre-blocked ones); K = 6
# pairs of g64 groups, which 4 does not divide
ROUTES = [
    ({}, "w4a8_gemv_stacked", "w4a8_gemv_preblocked"),
    ({"FF_2L_SPLITW": "1"}, "w4a8_gemv_splitw", "w4a8_gemv_preblocked"),
    ({"FF_2L_DOTRAW": "1"}, "w4a8_gemv_dotraw", "w4a8_gemv_dotraw"),
    ({"FF_2L_CONCAT_PAIRS": "2"}, "w4a8_gemv_concat", "w4a8_gemv_concat"),
    ({"FF_2L_CONCAT_PAIRS": "4"}, "w4a8_gemv_concat", "w4a8_gemv_concat"),
    ({"FF_2L_MANUAL": "4"}, "w4a8_gemv_stacked", "w4a8_gemv_manual"),
]
M, K, N, G64, BN = 7, 768, 256, 64, 128


@pytest.fixture(scope="module")
def stacked():
    """Three layers of paired W4A8 weights, their activations, and JAX's
    stacked GEMV on each layer (its CPU path takes no flag) in both dtypes."""
    rs = np.random.RandomState(11)
    w = rs.randint(-128, 128, (L, K // 2, N)).astype(np.int8)
    m = rs.randint(1, 16, (L, K // G64, N)).astype(np.int8)
    s = (rs.rand(L, N) * 1e-2 + 1e-4).astype(np.float32)
    x = (rs.randn(M, K) * 3).astype(np.float32)
    qj, sj = jax.jit(jm.quantize_rowwise)(jnp.asarray(x))
    mp = jpk.pack_mult_nibbles(jnp.asarray(m))
    gemv = jax.jit(jm.matmul_w4a8_2l_gemv_stacked, static_argnames=("group_size", "out_dtype"))
    ref = {(layer, dt): gemv(qj, sj, jnp.asarray(w), mp, jnp.asarray(s), jnp.int32(layer),
                             group_size=G64, out_dtype=getattr(jnp, dt))
           for layer in range(L) for dt in ("float32", "bfloat16")}
    port = (torch.from_numpy(np.array(qj)), torch.from_numpy(np.array(sj)),
            torch.from_numpy(w), torch.from_numpy(np.array(mp)), torch.from_numpy(s))
    return port, ref


@pytest.mark.parametrize("preblocked", [False, True], ids=["flat", "preblocked"])
@pytest.mark.parametrize("flags,flat_route,pre_route", ROUTES,
                         ids=[str(r[0]) or "default" for r in ROUTES])
def test_stacked_route_plain_version_equals_jax(monkeypatch, stacked, flags, flat_route,
                                                pre_route, preblocked):
    # GIVEN the route flags set as the serving path reads them
    for var in ("FF_2L_MANUAL", "FF_2L_SPLITW", "FF_2L_DOTRAW", "FF_2L_CONCAT_PAIRS"):
        monkeypatch.delenv(var, raising=False)
    for var, value in flags.items():
        monkeypatch.setenv(var, value)
    (qt, st, w, mp, s), ref = stacked
    wt = tm.preblock_stacked(w, BN) if preblocked else w
    # THEN the port picks the route its launch count names, as before
    route = tm.stacked_gemv_route(preblocked, K // G64, K // 2, int(flags.get("FF_2L_MANUAL", 0)),
                                  "FF_2L_SPLITW" in flags, "FF_2L_DOTRAW" in flags,
                                  int(flags.get("FF_2L_CONCAT_PAIRS", 1)))
    assert route == (pre_route if preblocked else flat_route)
    # AND its plain version gives JAX's bits on every layer, f32 and bf16
    for layer in range(L):
        for dt in ("float32", "bfloat16"):
            out = tm.matmul_w4a8_2l_gemv_stacked(qt, st, wt, mp, s, layer, group_size=G64,
                                                 out_dtype=getattr(torch, dt))
            assert _bits(out) == _bits(ref[layer, dt]), (layer, dt)


@pytest.mark.parametrize("K,N,g,paired", PROJ)
def test_stacked_plan_at_the_b_projections(K, N, g, paired):
    # GIVEN one of (b)'s four stacked projections, at every GEMV row count
    for M_ in range(1, 257):
        plan = tm.mma_plan(M_, K, N, g, "paired")
        # THEN the stacked routes' ring of _MMA_DEPTH stages fits and holds
        # at least one stage
        depth = tm.manual_depth(plan, tm._MMA_DEPTH)
        assert 1 <= depth <= min(tm._MMA_DEPTH, plan.stages)
        assert depth * (plan.stage_bytes + 16) + tm._MMA_SLACK <= 232448
        # every padded row is a weight row (the TMA feed: no padding, flat
        # and 512-column panels alike)
        assert plan.p16 == plan.unit_rows == g and N % 16 == 0 and N % 512 == 0
        # K is split only where the tiles alone fall short of the target,
        # each split keeping two stages of rows, never into an empty split
        tiles = plan.m_tiles * plan.n_tiles
        most = max(1, plan.n_units * plan.p16 // (2 * tm._MMA_ROWS))
        assert plan.n_split <= min(plan.n_units, -(-tm._MMA_TARGET_BLOCKS // tiles), most)
        assert plan.n_split == -(-plan.n_units // plan.ups)
        assert (plan.n_split - 1) * plan.ups < plan.n_units
        if tiles >= tm._MMA_TARGET_BLOCKS:
            assert plan.n_split == 1


@pytest.mark.parametrize("M_", [1, 8, 17, 192])
def test_tile_arithmetic_on_a_stacked_layer_equals_jax(M_):
    # GIVEN layer 2 of 3 stacked layers at (b)'s down_proj K (56 pairs of
    # g128), narrowed to 64 columns
    Kd, Nd, g = 14336, 64, 128
    rs = np.random.RandomState(M_)
    w = rs.randint(-128, 128, (L, Kd // 2, Nd)).astype(np.int8)
    m = rs.randint(1, 16, (L, Kd // g, Nd)).astype(np.int8)
    s = (rs.rand(L, Nd) * 1e-2 + 1e-4).astype(np.float32)
    x = (rs.randn(M_, Kd) * 3).astype(np.float32)
    qj, sj = jax.jit(jm.quantize_rowwise)(jnp.asarray(x))
    qt, st = torch.from_numpy(np.array(qj)), torch.from_numpy(np.array(sj))
    # WHEN the tile's split arithmetic runs on the layer and JAX's stacked
    # GEMV on the stack
    out = _tile_emulation(qt, st, torch.from_numpy(w[2]), torch.from_numpy(m[2]),
                          torch.from_numpy(s[2]), g, True, torch.bfloat16)
    ref = jm.matmul_w4a8_2l_gemv_stacked(qj, sj, jnp.asarray(w), jpk.pack_mult_nibbles(
        jnp.asarray(m)), jnp.asarray(s), jnp.int32(2), group_size=g, out_dtype=jnp.bfloat16)
    # THEN they agree bit for bit
    assert _bits(out) == _bits(ref)


# --- Row 3: the flash-decode plain versions at the chunk and page edges

S = 320
LENGTHS = [0, 1, CHUNK - 1, CHUNK, CHUNK + 1, 255, 256, 257, S, S + 9]


def _cache(B, Hkv, S_, seed):
    rs = np.random.RandomState(seed)
    return (rs.randint(-128, 128, (B, Hkv, S_, 128)).astype(np.int8),
            (rs.rand(B, Hkv, S_) * 0.05).astype(np.float32),
            rs.randint(-128, 128, (B, Hkv, S_, 128)).astype(np.int8),
            (rs.rand(B, Hkv, S_) * 0.05).astype(np.float32))


@pytest.fixture(scope="module")
def jax_decode_reference():
    return jax.jit(ja.flash_decode_int8_reference)


def _close(a, b):
    a = np.asarray(jnp.asarray(a).astype(jnp.float32))
    b = b.float().numpy()
    assert np.abs(a - b).max() <= RTOL * np.abs(a).max()


@pytest.mark.parametrize("G", [1, 2, 4, 8])
def test_flash_decode_reference_equals_jax_at_chunk_edges(jax_decode_reference, G):
    # GIVEN one sequence at each edge: empty, one token, a chunk +- 1, a
    # 256-token block +- 1, the whole slab and past it
    B, Hkv = len(LENGTHS), 2
    k, ks, v, vs = _cache(B, Hkv, S, seed=G)
    q = np.random.RandomState(10 + G).randn(B, Hkv * G, 128).astype(np.float32)
    lengths = np.array(LENGTHS, np.int32)
    qb = jnp.asarray(q).astype(jnp.bfloat16)
    # WHEN both plain versions attend over the live tokens
    a = jax_decode_reference(qb, *map(jnp.asarray, (k, ks, v, vs, lengths)))
    b = ta.flash_decode_int8_reference(torch.from_numpy(q).to(torch.bfloat16),
                                       *map(torch.from_numpy, (k, ks, v, vs, lengths)))
    # THEN they agree within one bf16 ulp of the largest output
    assert b.dtype == torch.bfloat16 and tuple(b.shape) == (B, Hkv * G, 128)
    _close(a, b)


@pytest.mark.parametrize("page", [32, 64, 128])
def test_paged_reference_equals_jax_slab_at_page_edges(jax_decode_reference, page):
    # GIVEN a pool of shuffled pages holding each sequence's tokens, one
    # sequence at each chunk and page edge, a table with -1 entries
    Hkv, G, MP = 2, 4, -(-S // page)
    lengths = np.array(LENGTHS + [page - 1, page, page + 1], np.int32)
    B = len(lengths)
    k, ks, v, vs = _cache(B, Hkv, MP * page, seed=page)
    rs = np.random.RandomState(page + 1)
    P = B * MP + 1
    table = (rs.permutation(P - 1)[:B * MP] + 1).reshape(B, MP).astype(np.int32)
    table[0, :] = -1  # the empty sequence: the trash page
    pool = []
    for a in (k, ks, v, vs):
        p = np.zeros((P, Hkv, page) + a.shape[3:], a.dtype)
        for bi in range(B):
            for i in range(MP):
                p[max(table[bi, i], 0)] = a[bi, :, i * page:(i + 1) * page]
        pool.append(p)
    for i in range(MP):  # the trash page holds what sequence 0 reads
        for a, p in zip((k, ks, v, vs), pool):
            a[0, :, i * page:(i + 1) * page] = p[0]
    q = rs.randn(B, Hkv * G, 128).astype(np.float32)
    # WHEN the port's paged plain version reads the pool through the table
    # and JAX's reference reads the slab
    b = tpa.paged_flash_decode_reference(torch.from_numpy(q).to(torch.bfloat16),
                                         *map(torch.from_numpy, pool), torch.from_numpy(table),
                                         torch.from_numpy(lengths))
    a = jax_decode_reference(jnp.asarray(q).astype(jnp.bfloat16),
                             *map(jnp.asarray, (k, ks, v, vs, lengths)))
    # THEN they agree within one bf16 ulp of the largest output
    _close(a, b)
