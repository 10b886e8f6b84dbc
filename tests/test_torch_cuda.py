"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA GPU (built for sm_90a) and skips without
one. Run them on the card with

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest``: the shared conftest imports JAX, which the GPU host
need not have). Tolerances: the GEMVs (the unpaired two-level one too, and
every route of the stacked W4A8 GEMV: flat, pre-blocked, the manual stream
and split-W), the W8A8 GEMM, argmax ids, the dequants (the pre-blocked one
too) and the KV appends (slab, per-layer and paged; the decode step's
fused K/V quantize and append too) are bit-equal; the W4 GEMV
(w4a16, wgmma: every token tile edge, split and unsplit, the same bits
call to call) is within 1e-4 of its largest output in f32, one bf16 ulp
more in bf16; flash decode (slab, per-layer and paged) and flash prefill (int8
and bf16 K/V; wgmma fed by TMA, persistent blocks, T above the 128-row
work item) are within one bf16 ulp of the largest output (rtol 8e-3),
and paged flash decode gives the slab kernel's bits over the same tokens.
The fused layer tail and its o + gate/up head (their products on the int8
tensor-core tile): x1 bit-equal, the int8 activations hq and x2 within
one level (the IEEE rsqrt and exp round unlike PyTorch's in a few rows),
the output within rtol 8e-3, the staged operands where the tile reads
them, the same bits call to call. The stacked W4A8 GEMV's dot-raw and
concat-pairs routes are bit-equal too (either layout; the last unit of a
concat-pairs split shorter), and so is every route of the int4/int8 dot
probe; the tiled W4A16 kernel (wgmma) is held as the W4 GEMV (its bias
epilogue exactly) at every edge of its 128 x 128 tiles and its 128-k
stages. Both fused layer heads run their product on the tensor-core tile
(the A4 head on the vertical layout, the W4A8 head on the paired one),
their prologue staging its operand, and stay bit-equal at every M = 1-256. The A4 GEMV and the argmax head run the tensor-core tile
(its vertical layout and its argmax epilogue): bit-equal, token ids equal
to torch.argmax of the f32 logits, ties and NaNs included. Every route
of the stacked W4A8 GEMV runs that tile too (bit-equal at the 8B widths,
layers 0 and L - 1, each call counted once), and flash decode walks chunks
of 64 tokens (within rtol 8e-3 at every chunk and page edge, zeros at
length 0, the paged and per-layer forms giving the slab form's bits).
The W8A8 GEMM and the float-scale W4A8 GEMV run int8 wgmma: bit-equal at
every token-tile and row-block edge (the prefill's ragged row tile, a
bias, ragged K, N % 16 != 0, g 32/64/128), under every K split and row
split, the same bits call to call; the W4A8 GEMV stays bit-equal, the W4
GEMV and the tiled W4A16 GEMM within their tolerance, at groups of 256,
512 and g = K at the 8B shapes. Every other even group (2, 16, 48, 96,
112, 192, 320; g = K at 192 and 320) takes the same sources' permuted
route, held the same way. The two-level GEMVs (rows 1, 4, 5, 9) and the
fused heads and tail take every other group their references take (1-14,
N % 4 != 0, any panel width, and 1,024 groups of 14 along K) on the
any-group route of the same tensor cores (csrc/w4a8_mma.cuh
w4a8_rows_kernel), counted under its own names: the GEMVs and heads
bit-equal, the tail held as on the tile. The prefill
dequant's four rows are bit-equal at the 8B projections (pre-blocked at
bn 128 and 512).
"""

import pytest
import torch

from fastforward_tpu_torch.kernels import _build
from fastforward_tpu_torch.kernels import attention as att
from fastforward_tpu_torch.kernels import kv_update as kvu
from fastforward_tpu_torch.kernels import matmul as mm
from fastforward_tpu_torch.kernels import paged_attention as pa
from fastforward_tpu_torch.kernels.packing import (
    pack_int4_vertical,
    pack_mult_nibbles,
    unpack_mult_nibbles,
)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", 0)


def _gen(dev, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return g


def _ri(gen, lo, hi, shape, dtype, dev):
    return torch.randint(lo, hi, shape, generator=gen, dtype=dtype, device=dev)


@pytest.mark.parametrize("M,K,N,g", [
    (1, 512, 132, 64), (8, 4096, 6144, 512), (13, 1024, 4100, 128), (256, 2048, 512, 32),
    (40, 3584, 260, 512),
])
def test_a4_gemv_kernel_bit_equal(dev, M, K, N, g):
    gen = _gen(dev, M + K + N)
    L = 3
    w = _ri(gen, -128, 128, (L, K // 2, N), torch.int8, dev)
    mp = pack_mult_nibbles(_ri(gen, 1, 16, (L, K // g, N), torch.int8, dev)).contiguous()
    s = torch.rand((L, N), generator=gen, device=dev) * 1e-2
    x_q, x_s = mm.quantize_rowwise_a4(torch.randn((M, K), generator=gen, device=dev))
    before = _build.launch_counts["a4_gemv"]
    for layer in (0, L - 1):
        out = mm.matmul_w4a4_2l_gemv_stacked(x_q, x_s, w, mp, s, layer, group_size=g)
        ref = mm.matmul_w4a4_2l_reference(x_q, x_s, w[layer], unpack_mult_nibbles(mp[layer], K // g),
                                          s[layer], None, g)
        assert torch.equal(out, ref)
    assert _build.launch_counts["a4_gemv"] == before + 2


# the A4 GEMV on the tensor-core tile (vertical layout): run (a)'s four
# fused projections at g512 and the GEMV's row counts, plus a g128 and a
# g32 shape (layer 1 of 2)
_A4_TILE_SHAPES = [(4096, 6144, 512), (4096, 4096, 512), (4096, 28672, 512),
                   (14336, 4096, 512), (4096, 6144, 128), (1024, 4100, 32)]


@pytest.mark.parametrize("M", [1, 8, 17, 192, 256])
@pytest.mark.parametrize("K,N,g", _A4_TILE_SHAPES)
def test_a4_gemv_tile_bit_equal(dev, M, K, N, g):
    gen = _gen(dev, M + K + N + g)
    w = _ri(gen, -128, 128, (2, K // 2, N), torch.int8, dev)
    mult = _ri(gen, 1, 16, (2, K // g, N), torch.int8, dev)
    mp = pack_mult_nibbles(mult).contiguous()
    s = torch.rand((2, N), generator=gen, device=dev) * 1e-2
    x_q, x_s = mm.quantize_rowwise_a4(torch.randn((M, K), generator=gen, device=dev))
    before = _build.launch_counts["a4_gemv"]
    out = mm.matmul_w4a4_2l_gemv_stacked(x_q, x_s, w, mp, s, 1, group_size=g)
    assert _build.launch_counts["a4_gemv"] == before + 1
    ref = mm.matmul_w4a4_2l_reference(x_q, x_s, w[1], mult[1], s[1], None, g)
    assert out.dtype == torch.bfloat16 and torch.equal(out, ref)


def test_a4_gemv_tile_extreme_sums_exact(dev):
    # x, v in {-8, 7}, m = 15 over K = 14336: the largest sums of the grid
    gen = _gen(dev, 14336)
    M, K, N, g = 72, 14336, 256, 512
    x_q = torch.where(_ri(gen, 0, 2, (M, K), torch.int8, dev) > 0, 7, -8).to(torch.int8)
    x_s = torch.rand((M,), generator=gen, device=dev) + 0.5
    v = torch.where(_ri(gen, 0, 2, (K, N), torch.int8, dev) > 0, 7, -8).to(torch.int8)
    w = pack_int4_vertical(v)[None].contiguous()
    mult = torch.full((1, K // g, N), 15, dtype=torch.int8, device=dev)
    s = torch.rand((1, N), generator=gen, device=dev) * 1e-6
    out = mm.matmul_w4a4_2l_gemv_stacked(x_q, x_s, w, pack_mult_nibbles(mult).contiguous(), s,
                                         0, group_size=g)
    assert torch.equal(out, mm.matmul_w4a4_2l_reference(x_q, x_s, w[0], mult[0], s[0], None, g))


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_a4_gemv_serves_a_group_not_a_multiple_of_8(dev, out_dtype):
    # the smallest case the tile refuses (M 2, K 48, N 16, g 12): the
    # any-group route, bit-equal, f32 and bf16
    gen = _gen(dev, 48)
    x_q, x_s = mm.quantize_rowwise_a4(torch.randn((2, 48), generator=gen, device=dev))
    w = _ri(gen, -128, 128, (1, 24, 16), torch.int8, dev)
    mult = _ri(gen, 1, 16, (1, 4, 16), torch.int8, dev)
    s = torch.rand((1, 16), generator=gen, device=dev) * 1e-2
    before = _build.launch_counts["a4_gemv_any"]
    out = mm.matmul_w4a4_2l_gemv_stacked(x_q, x_s, w, pack_mult_nibbles(mult).contiguous(), s, 0,
                                         group_size=12, out_dtype=out_dtype)
    assert _build.launch_counts["a4_gemv_any"] == before + 1
    ref = mm.matmul_w4a4_2l_reference(x_q, x_s, w[0], mult[0], s[0], None, 12, out_dtype)
    assert out.dtype == out_dtype and torch.equal(out, ref)


@pytest.mark.parametrize("M", [1, 8, 17, 192, 256])
@pytest.mark.parametrize("g", [512, 128])
def test_w4a8_argmax_tile_lm_head_ids_equal(dev, M, g):
    # the lm_head (K 4096, N 128256): column 3 copied to 77 (its block),
    # 5000 and N - 2 (the ragged last block) at a scale that makes them the
    # maximum wherever their sum is positive; row 0 all zeros (a tie over
    # the whole row); the last row's scale NaN (every logit NaN: id 0)
    gen = _gen(dev, M + g)
    K, N = 4096, 128256
    w = _ri(gen, -128, 128, (K // 2, N), torch.int8, dev)
    m = _ri(gen, 1, 16, (K // g, N), torch.int8, dev)
    s = torch.rand((N,), generator=gen, device=dev) * 1e-3
    tied = [3, 77, 5000, N - 2]
    w[:, tied] = w[:, 3:4]
    m[:, tied] = m[:, 3:4]
    s[tied] = 1.0
    x_q, x_s = mm.quantize_rowwise(torch.randn((M, K), generator=gen, device=dev))
    x_q[0] = 0
    if M > 1:
        x_s[M - 1] = float("nan")
    before = _build.launch_counts["w4a8_gemv_argmax"]
    ids = mm.matmul_w4a8_2l_gemv_argmax(x_q, x_s, w, m, s, g, paired=True)
    assert _build.launch_counts["w4a8_gemv_argmax"] == before + 1
    logits = mm.matmul_w4a8_2l_reference(x_q, x_s, w, m, s, None, g, torch.float32, paired=True)
    want = torch.argmax(logits, dim=-1).to(torch.int32)
    assert torch.equal(ids, want)
    assert int(ids[0]) == 0 and (M == 1 or int(ids[M - 1]) == 0)
    assert all(int(i) == 3 for i in ids[1:M - 1] if int(i) in tied)


@pytest.mark.parametrize("M,K,N,g", [
    (1, 256, 1004, 64), (8, 4096, 128256, 512), (20, 1024, 260, 128),
    # the tensor-core tile: odd M, 64-row blocks, a ragged last column tile
    # on the TMA feed (N % 128 == 16), K split, groups shorter than 16 rows
    (17, 4096, 128256, 128), (192, 4096, 128256, 512), (256, 2048, 1040, 64),
    (192, 4096, 1024, 128), (33, 1040, 132, 20), (5, 256, 40, 4),
])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_w4a8_gemv_kernel_bit_equal(dev, M, K, N, g, out_dtype):
    gen = _gen(dev, M * N)
    w = _ri(gen, -128, 128, (K // 2, N), torch.int8, dev)
    m = _ri(gen, 1, 16, (K // g, N), torch.int8, dev)
    s = torch.rand((N,), generator=gen, device=dev) * 1e-2
    x_q, x_s = mm.quantize_rowwise(torch.randn((M, K), generator=gen, device=dev))
    before = _build.launch_counts["w4a8_gemv"]
    out = mm.matmul_w4a8_2l_gemv(x_q, x_s, w, m, s, g, out_dtype, paired=True)
    assert _build.launch_counts["w4a8_gemv"] == before + 1
    ref = mm.matmul_w4a8_2l_reference(x_q, x_s, w, m, s, None, g, out_dtype, paired=True)
    assert torch.equal(out, ref)


@pytest.mark.parametrize("paired", [True, False])
def test_w4a8_gemv_kernel_extreme_sums_exact(dev, paired):
    # x = +-127, m = 15, u = 0 and 15 over K = 14336: the largest int32 sums
    # the two-level grid allows, exact in any order
    gen = _gen(dev, 14336 + paired)
    M, K, N, g = 72, 14336, 256, 128
    x_q = torch.where(_ri(gen, 0, 2, (M, K), torch.int8, dev) > 0, 127, -127).to(torch.int8)
    x_s = torch.rand((M,), generator=gen, device=dev) + 0.5
    w = torch.where(_ri(gen, 0, 2, (K // 2, N), torch.int8, dev) > 0, 0, -1).to(torch.int8)
    m = torch.full((K // g, N), 15, dtype=torch.int8, device=dev)
    s = torch.rand((N,), generator=gen, device=dev) * 1e-6
    out = mm.matmul_w4a8_2l_gemv(x_q, x_s, w, m, s, g, torch.float32, paired=paired)
    ref = mm.matmul_w4a8_2l_reference(x_q, x_s, w, m, s, None, g, torch.float32, paired=paired)
    assert torch.equal(out, ref)


@pytest.mark.parametrize("M,N", [(1, 1004), (8, 128256), (3, 5000)])
def test_w4a8_argmax_kernel_ids_equal(dev, M, N):
    # ties (duplicated columns across tiles) and a NaN row included
    gen = _gen(dev, N)
    K, g = 512, 128
    w = _ri(gen, -128, 128, (K // 2, N), torch.int8, dev)
    m = _ri(gen, 1, 16, (K // g, N), torch.int8, dev)
    s = torch.rand((N,), generator=gen, device=dev) * 1e-2
    w[:, N - 8:] = w[:, :8]
    m[:, N - 8:] = m[:, :8]
    s[N - 8:] = s[:8]
    x_q, x_s = mm.quantize_rowwise(torch.randn((M, K), generator=gen, device=dev))
    x_s[M - 1] = float("nan")
    ids = mm.matmul_w4a8_2l_gemv_argmax(x_q, x_s, w, m, s, g, paired=True)
    logits = mm.matmul_w4a8_2l_reference(x_q, x_s, w, m, s, None, g, torch.float32, paired=True)
    assert torch.equal(ids, torch.argmax(logits, dim=-1).to(torch.int32))
    assert int(ids[M - 1]) == 0


@pytest.mark.parametrize("paired,g", [(False, 4), (True, 2)])
def test_w4a8_kernel_serves_unpaired_and_paired_small_groups(dev, paired, g):
    # the tile stages 4 byte rows of one unit at a time; an unpaired group
    # no multiple of 8 (M 1, K 256, N 64, g 4) and a paired group no
    # multiple of 4 (M 1, K 8, N 4, g 2) take the any-group route, bit-equal
    K, N = (8, 4) if paired else (256, 64)
    gen = _gen(dev, K + g)
    x_q, x_s = mm.quantize_rowwise(torch.randn((1, K), generator=gen, device=dev))
    w = _ri(gen, -128, 128, (K // 2, N), torch.int8, dev)
    m = _ri(gen, 1, 16, (K // g, N), torch.int8, dev)
    s = torch.rand((N,), generator=gen, device=dev) * 1e-2
    name = "w4a8_gemv_any" if paired else "w4a8_gemv_unpaired_any"
    before = _build.launch_counts[name]
    out = mm.matmul_w4a8_2l_gemv(x_q, x_s, w, m, s, g, paired=paired)
    assert _build.launch_counts[name] == before + 1
    ref = mm.matmul_w4a8_2l_reference(x_q, x_s, w, m, s, None, g, paired=paired)
    assert out.dtype == torch.bfloat16 and torch.equal(out, ref)


def test_kv_append_kernel_bit_equal(dev):
    gen = _gen(dev, 3)
    L, B, Hkv, S, D = 3, 4, 8, 512, 128
    cache = [_ri(gen, -128, 128, (L, B, Hkv, S, D), torch.int8, dev) for _ in range(2)]
    cache += [torch.rand((L, B, Hkv, S), generator=gen, device=dev) for _ in range(2)]
    new = [_ri(gen, -128, 128, (B, Hkv, 1, D), torch.int8, dev) for _ in range(2)]
    new += [torch.rand((B, Hkv, 1), generator=gen, device=dev) for _ in range(2)]
    starts = torch.tensor([0, 511, 512, 77], dtype=torch.int32, device=dev)  # 512: no write
    ref = kvu.kv_append_decode_stacked_reference(*[t.clone() for t in cache], *new, starts, 2)
    out = kvu.kv_append_decode_int8_stacked(*[t.clone() for t in cache], *new, starts, 2)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


def _token_kv(gen, B, Hkv, D, dtype, dev):
    """One decode token's k (contiguous, as RoPE leaves it) and v (a view of
    a qkv row, as the projection leaves it), (B, Hkv, 1, D); row 0 of v
    zero (the scale's floor), a few exact ties."""
    qkv = torch.randn((B, 1, 4 * Hkv, D), generator=gen, device=dev) * 3
    qkv[0, 0, 3 * Hkv] = 0
    qkv[1, 0, 2 * Hkv, :5] = 0.5
    qkv = qkv.to(dtype)
    k = qkv[:, :, 2 * Hkv:3 * Hkv].transpose(1, 2).contiguous()
    v = qkv[:, :, 3 * Hkv:].transpose(1, 2)
    assert not v.is_contiguous()
    return k, v


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kv_quantize_append_kernels_bit_equal(dev, dtype):
    # the fused K/V quantizer and append in its three forms: int8 bytes and
    # f32 scales bit-equal to quantize_kv and the plain append, starts 0,
    # S - 1, -1 and S (no write) and one inside, a page id of -1 and a page
    # index past the table (page 0); one launch under the row's name
    gen = _gen(dev, 41)
    L, B, Hkv, S, D = 3, 5, 8, 512, 128
    k, v = _token_kv(gen, B, Hkv, D, dtype, dev)
    cache = [_ri(gen, -128, 128, (L, B, Hkv, S, D), torch.int8, dev) for _ in range(2)]
    cache += [torch.rand((L, B, Hkv, S), generator=gen, device=dev) for _ in range(2)]
    starts = torch.tensor([0, S - 1, -1, S, 77], dtype=torch.int32, device=dev)
    ref = kvu.kv_quantize_append_stacked_reference(*[t.clone() for t in cache], k, v, starts, 2)
    bufs = [t.clone() for t in cache]
    before = _build.launch_counts["kv_append"]
    out = kvu.kv_quantize_append_stacked(*bufs, k, v, starts, 2)
    assert _build.launch_counts["kv_append"] == before + 1
    for a, b, r in zip(out, bufs, ref):
        assert a is b and torch.equal(a, r)
    layer = [t[1].clone() for t in cache]
    ref = kvu.kv_quantize_append_reference(*[t.clone() for t in layer], k, v, starts)
    before = _build.launch_counts["kv_append_layer"]
    out = kvu.kv_quantize_append(*layer, k, v, starts)
    assert _build.launch_counts["kv_append_layer"] == before + 1
    for a, b, r in zip(out, layer, ref):
        assert a is b and torch.equal(a, r)
    P, page, MP = 9, 64, 4
    pools = [_ri(gen, -128, 128, (L, P, Hkv, page, D), torch.int8, dev) for _ in range(2)]
    pools += [torch.rand((L, P, Hkv, page), generator=gen, device=dev) for _ in range(2)]
    table = torch.tensor([[1, 2, -1, -1], [3, -1, -1, -1], [4, 5, 6, -1], [7, -1, -1, -1],
                          [8, -1, -1, -1]], dtype=torch.int32, device=dev)
    pos = torch.tensor([page + 3, page + 1, 2 * page + 5, MP * page + 7, 9], dtype=torch.int32,
                       device=dev)
    ref = pa.paged_kv_quantize_append_reference(*[t.clone() for t in pools], k, v, pos, table, 1)
    bufs = [t.clone() for t in pools]
    before = _build.launch_counts["paged_kv_append"]
    out = pa.paged_kv_quantize_append(*bufs, k, v, pos, table, 1)
    assert _build.launch_counts["paged_kv_append"] == before + 1
    for a, b, r in zip(out, bufs, ref):
        assert a is b and torch.equal(a, r)


def test_kv_quantize_append_at_bench_batch(dev):
    # B = 192 x 8 kv heads, the stacked form: the same bits at the served shape
    gen = _gen(dev, 42)
    L, B, Hkv, S, D = 2, 192, 8, 256, 128
    k, v = _token_kv(gen, B, Hkv, D, torch.bfloat16, dev)
    cache = [torch.zeros((L, B, Hkv, S, D), dtype=torch.int8, device=dev) for _ in range(2)]
    cache += [torch.zeros((L, B, Hkv, S), device=dev) for _ in range(2)]
    starts = torch.randint(0, S, (B,), generator=gen, device=dev, dtype=torch.int32)
    ref = kvu.kv_quantize_append_stacked_reference(*[t.clone() for t in cache], k, v, starts, 1)
    out = kvu.kv_quantize_append_stacked(*cache, k, v, starts, 1)
    for a, r in zip(out, ref):
        assert torch.equal(a, r)


@pytest.mark.parametrize("G", [1, 2, 4, 8])
def test_flash_decode_kernel_within_tolerance(dev, G):
    gen = _gen(dev, G)
    L, B, Hkv, S, d = 2, 5, 4, 1024, 128
    k = _ri(gen, -128, 128, (L, B, Hkv, S, d), torch.int8, dev)
    v = _ri(gen, -128, 128, (L, B, Hkv, S, d), torch.int8, dev)
    ks = torch.rand((L, B, Hkv, S), generator=gen, device=dev) * 0.05
    vs = torch.rand((L, B, Hkv, S), generator=gen, device=dev) * 0.05
    q = torch.randn((B, Hkv * G, d), generator=gen, device=dev).to(torch.bfloat16)
    lengths = torch.tensor([1, 256, 257, 1000, S], dtype=torch.int32, device=dev)
    out = att.flash_decode_int8_stacked(q, k, ks, v, vs, lengths, 1)
    ref = att.flash_decode_int8_reference(q, k[1], ks[1], v[1], vs[1], lengths)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= 8e-3 * ref.float().abs().max().item()


def test_wrappers_check_their_inputs(dev):
    x_q = torch.zeros((2, 64), dtype=torch.int8, device=dev)
    w = torch.zeros((1, 32, 16), dtype=torch.int8, device=dev)
    mp = torch.zeros((1, 1, 16), dtype=torch.int32, device=dev)
    s = torch.ones((1, 16), device=dev)
    with pytest.raises(ValueError, match="float32"):
        mm.matmul_w4a4_2l_gemv_stacked(x_q, torch.ones(2, dtype=torch.float64, device=dev),
                                       w, mp, s, 0, group_size=32)
    with pytest.raises(ValueError, match="contiguous"):
        mm.matmul_w4a4_2l_gemv_stacked(torch.zeros((64, 2), dtype=torch.int8, device=dev).t(),
                                       torch.ones(2, device=dev), w, mp, s, 0, group_size=32)
    with pytest.raises(ValueError, match="layer"):
        mm.matmul_w4a4_2l_gemv_stacked(x_q, torch.ones(2, device=dev), w, mp, s, 1, group_size=32)


@pytest.mark.parametrize("M,K,N,g", [
    (1, 256, 132, 64), (192, 4096, 6144, 128), (13, 1024, 4100, 32), (256, 2048, 520, 128),
    (192, 14336, 4096, 128),
])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_w4a8_gemv_stacked_kernel_bit_equal(dev, M, K, N, g, out_dtype):
    gen = _gen(dev, M + K + N + g)
    L = 3
    w = _ri(gen, -128, 128, (L, K // 2, N), torch.int8, dev)
    mp = pack_mult_nibbles(_ri(gen, 1, 16, (L, K // g, N), torch.int8, dev)).contiguous()
    s = torch.rand((L, N), generator=gen, device=dev) * 1e-2
    x_q, x_s = mm.quantize_rowwise(torch.randn((M, K), generator=gen, device=dev))
    before = _build.launch_counts["w4a8_gemv_stacked"]
    for layer in (0, L - 1):
        out = mm.matmul_w4a8_2l_gemv_stacked(x_q, x_s, w, mp, s, layer, g, out_dtype)
        ref = mm.matmul_w4a8_2l_reference(x_q, x_s, w[layer], unpack_mult_nibbles(mp[layer], K // g),
                                          s[layer], None, g, out_dtype, paired=True)
        assert torch.equal(out, ref)
    assert _build.launch_counts["w4a8_gemv_stacked"] == before + 2


@pytest.mark.parametrize("layout", ["vertical", "paired"])
@pytest.mark.parametrize("K,N,g", [(4096, 6144, 512), (1024, 4100, 128), (256, 40, 32),
                                   (512, 2064, 64), (14336, 4096, 128)])
def test_dequant_kernels_bit_equal(dev, layout, K, N, g):
    # N = 4100 and 40 are not multiples of 16: the one-column-per-thread path
    gen = _gen(dev, K + N + g)
    L = 3
    w = _ri(gen, -128, 128, (L, K // 2, N), torch.int8, dev)
    m = _ri(gen, 1, 16, (L, K // g, N), torch.int8, dev)
    s = torch.rand((L, N), generator=gen, device=dev) * 1e-2
    stacked = getattr(mm, f"dequantize_int4_{layout}_stacked")
    ref_fn = getattr(mm, f"dequantize_int4_{layout}_reference")
    count = f"dequant_{layout}"
    before = _build.launch_counts[count]
    for layer in (0, L - 1):
        out = stacked(w, m, s, layer, group_size=g)
        s_eff = m[layer].float() * s[layer][None, :]
        ref = ref_fn(w[layer], s_eff, g)
        assert out.dtype == torch.bfloat16 and torch.equal(out, ref)
    # the non-stacked form: the same kernel at L = 1 with s_eff given
    s_eff = m[1].float() * s[1][None, :]
    if layout == "vertical":
        out = mm.dequantize_int4_vertical(w[1], s_eff, g)
    else:
        out = mm.dequantize_int4(w[1], s_eff, g, offset_binary=True, paired=True)
    assert torch.equal(out, ref_fn(w[1], s_eff, g))
    assert _build.launch_counts[count] == before + 3


@pytest.mark.parametrize("G", [1, 2, 4, 8])
@pytest.mark.parametrize("T,S,starts", [(128, 512, (0, 0, 0)), (40, 100, (0, 7, 60)),
                                        (77, 300, (5, 0, 223)), (1, 64, (63, 0, 10)),
                                        (200, 260, (0, 30, 60)), (300, 333, (0, 11, 33))])
def test_flash_prefill_kernel_within_tolerance(dev, G, T, S, starts):
    # ragged T (not a multiple of the 64/G positions of a block), nonzero
    # starts, a slab S that is not a multiple of the 64-key tile, and rows
    # whose position lies past the slab (starts + t >= S)
    gen = _gen(dev, G * T + S)
    B, Hkv, d = 3, 2, 128
    H = Hkv * G
    k = _ri(gen, -128, 128, (B, Hkv, S, d), torch.int8, dev)
    v = _ri(gen, -128, 128, (B, Hkv, S, d), torch.int8, dev)
    ks = torch.rand((B, Hkv, S), generator=gen, device=dev) * 0.02
    vs = torch.rand((B, Hkv, S), generator=gen, device=dev) * 0.05
    q = torch.randn((B, H, T, d), generator=gen, device=dev).to(torch.bfloat16)
    st = torch.tensor(starts, dtype=torch.int32, device=dev)
    before = _build.launch_counts["flash_prefill"]
    out = att.flash_prefill(q, k, ks, v, vs, st)
    ref = att.flash_prefill_reference(q, k, ks, v, vs, st)
    assert _build.launch_counts["flash_prefill"] == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= 8e-3 * ref.float().abs().max().item()


def test_new_wrappers_check_their_inputs(dev):
    B, H, Hkv, T, S, d = 1, 4, 2, 8, 64, 128
    q = torch.zeros((B, H, T, d), dtype=torch.bfloat16, device=dev)
    k = torch.zeros((B, Hkv, S, d), dtype=torch.int8, device=dev)
    sc = torch.ones((B, Hkv, S), device=dev)
    st = torch.zeros((B,), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="without"):  # bf16 K/V take no scales
        att.flash_prefill(q, k.to(torch.bfloat16), sc, k.to(torch.bfloat16), sc, st)
    with pytest.raises(ValueError, match="without"):  # int8 K/V need them
        att.flash_prefill(q, k, None, k, None, st)
    with pytest.raises(ValueError, match="bfloat16"):
        att.flash_prefill(q.float(), k, sc, k, sc, st)
    with pytest.raises(ValueError, match="contiguous"):
        att.flash_prefill(q.transpose(2, 3).contiguous().transpose(2, 3), k, sc, k, sc, st)
    w = torch.zeros((2, 64, 48), dtype=torch.int8, device=dev)
    m = torch.ones((2, 4, 48), dtype=torch.int8, device=dev)
    s = torch.ones((2, 48), device=dev)
    with pytest.raises(ValueError, match="int8"):
        mm.dequantize_int4_vertical_stacked(w, m.int(), s, 1, group_size=32)
    with pytest.raises(ValueError, match="contiguous"):
        mm.dequantize_int4_paired_stacked(w.transpose(1, 2).contiguous().transpose(1, 2), m, s, 0,
                                          group_size=32)
    with pytest.raises(ValueError, match="layer"):
        mm.dequantize_int4_vertical_stacked(w, m, s, 2, group_size=32)
    x_q = torch.zeros((2, 128), dtype=torch.int8, device=dev)
    mp = torch.zeros((2, 1, 48), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="float32"):
        mm.matmul_w4a8_2l_gemv_stacked(x_q, torch.ones(2, dtype=torch.float64, device=dev),
                                       w, mp, s, 0, group_size=32)
    with pytest.raises(ValueError, match="int32"):
        mm.matmul_w4a8_2l_gemv_stacked(x_q, torch.ones(2, device=dev), w, mp.long(), s, 0,
                                       group_size=32)


@pytest.mark.parametrize("page,Hkv", [(256, 8), (128, 2), (32, 1)])
def test_paged_kv_append_kernel_bit_equal(dev, page, Hkv):
    # a -1 table entry and a position at or beyond the table both write the
    # trash page 0 (at different rows, so no two sequences share a row)
    gen = _gen(dev, page + Hkv)
    L, P, MP, D = 2, 7, 3, 128
    pools = [_ri(gen, -128, 128, (L, P, Hkv, page, D), torch.int8, dev) for _ in range(2)]
    pools += [torch.rand((L, P, Hkv, page), generator=gen, device=dev) for _ in range(2)]
    table = torch.tensor([[3, 5, -1], [1, -1, -1], [2, 6, 4], [-1, -1, -1], [4, 2, 6]],
                         dtype=torch.int32, device=dev)
    B = table.shape[0]
    new = [_ri(gen, -128, 128, (B, Hkv, 1, D), torch.int8, dev) for _ in range(2)]
    new += [torch.rand((B, Hkv, 1), generator=gen, device=dev) for _ in range(2)]
    pos = torch.tensor([page + 1, page - 1, 2 * page + 5, 7, MP * page + 3], dtype=torch.int32,
                       device=dev)
    before = _build.launch_counts["paged_kv_append"]
    ref = pa.paged_kv_append_reference(*[t.clone() for t in pools], *new, pos, table, 1)
    out = pa.paged_kv_append_decode_int8(*[t.clone() for t in pools], *new, pos, table, 1)
    assert _build.launch_counts["paged_kv_append"] == before + 1
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("page,G", [(256, 4), (128, 2), (128, 8), (64, 1)])
def test_paged_flash_decode_kernel(dev, page, G):
    # lengths of one token, a page, a page plus one, the whole table and
    # past it; a row whose table is all -1 (the trash page)
    gen = _gen(dev, page * G)
    L, P, Hkv, MP, d = 2, 11, 2, 4, 128
    k = _ri(gen, -128, 128, (L, P, Hkv, page, d), torch.int8, dev)
    v = _ri(gen, -128, 128, (L, P, Hkv, page, d), torch.int8, dev)
    ks = torch.rand((L, P, Hkv, page), generator=gen, device=dev) * 0.05
    vs = torch.rand((L, P, Hkv, page), generator=gen, device=dev) * 0.05
    table = torch.stack([torch.randperm(P - 1, generator=torch.Generator().manual_seed(b))[:MP] + 1
                         for b in range(6)]).to(torch.int32).to(dev)
    table[5] = -1
    table[0, 2:] = -1
    B = table.shape[0]
    lengths = torch.tensor([1, page, page + 1, MP * page, MP * page + 40, 3 * page],
                           dtype=torch.int32, device=dev)
    q = torch.randn((B, Hkv * G, d), generator=gen, device=dev).to(torch.bfloat16)
    before = _build.launch_counts["paged_flash_decode"]
    out = pa.paged_flash_decode_int8(q, k, ks, v, vs, table, lengths, 1)
    assert _build.launch_counts["paged_flash_decode"] == before + 1
    ref = pa.paged_flash_decode_reference(q, k[1], ks[1], v[1], vs[1], table, lengths)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= 8e-3 * ref.float().abs().max().item()
    # the slab kernel over the gathered pages: the same bits
    def slab(pool):
        return torch.stack([pa.gather_pages(pool[1], t) for t in table])[None].contiguous()
    same = att.flash_decode_int8_stacked(q, slab(k), slab(ks), slab(v), slab(vs), lengths, 0)
    assert torch.equal(out, same)


def _tail_case(dev, M, K1, H, inter, g, seed):
    gen = _gen(dev, seed)
    L = 2
    ops = []
    for K, N in ((K1, H), (H, 2 * inter), (inter, H)):
        ops += [_ri(gen, -128, 128, (L, K // 2, N), torch.int8, dev),
                pack_mult_nibbles(_ri(gen, 1, 16, (L, K // g, N), torch.int8, dev)).contiguous(),
                torch.rand((L, N), generator=gen, device=dev) * (4.0 / K)]
    norm = (torch.rand((L, H), generator=gen, device=dev) + 0.5).to(torch.bfloat16)
    attn = torch.randn((M, K1), generator=gen, device=dev).to(torch.bfloat16)
    x_res = torch.randn((M, H), generator=gen, device=dev).to(torch.bfloat16)
    return attn, x_res, norm, ops


def _tail_plain(attn, x_res, norm, ops, g):
    layer_ops = mm._fused_o_mlp_layer(norm, *ops, 1, g)
    return mm._fused_o_mlp_parts(attn.float(), x_res.float(), *layer_ops, group_size=g)


def _staged(q, plan, g):
    """The staged operand of int8 rows ``q`` as the tile reads it."""
    return mm.mma_staged_operand(q.cpu(), plan, g, "paired").to(q.device)


@pytest.mark.parametrize("M,K1,H,inter,g", [
    (1, 4096, 4096, 14336, 128), (8, 4096, 4096, 14336, 128), (32, 4096, 4096, 14336, 128),
    (64, 4096, 4096, 14336, 128), (5, 512, 256, 384, 64), (33, 256, 256, 512, 32),
])
def test_fused_o_mlp_kernel(dev, M, K1, H, inter, g):
    attn, x_res, norm, ops = _tail_case(dev, M, K1, H, inter, g, M + H)
    before = _build.launch_counts["fused_o_mlp"]
    out, x1, hq, hs, x2, gs, xf_gu, xf_dn = mm._fused_o_mlp_launch(attn, x_res, norm, *ops, 1, g,
                                                                   1e-5)
    assert _build.launch_counts["fused_o_mlp"] == before + 1
    y, rx1, rhq, rhs, rx2, rgs = _tail_plain(attn, x_res, norm, ops, g)
    torch.cuda.synchronize()
    assert torch.equal(x1, rx1)
    for a, b in ((hq, rhq), (x2, rx2)):
        diff = (a.int() - b.int()).abs()
        assert diff.max().item() <= 1
        assert diff.count_nonzero().item() <= max(4, a.numel() // 1000)
    torch.testing.assert_close(hs, rhs, rtol=1e-6, atol=0)
    torch.testing.assert_close(gs, rgs, rtol=1e-6, atol=0)
    assert out.dtype == torch.bfloat16
    err = (out.float() - y).abs().max().item()
    assert err <= 8e-3 * y.abs().max().item()
    # the row kernels staged hq and x2 where gate/up's and down's tiles read them
    plan = mm.tail_plan(M, K1, H, 2 * inter, g, True)
    assert torch.equal(xf_gu, _staged(hq, plan.plans[1], g))
    assert torch.equal(xf_dn, _staged(x2, plan.plans[2], g))
    # the public wrapper returns the same output, and again the same bits
    again = mm.fused_o_mlp_stacked(attn, x_res, norm, *ops, 1, group_size=g)
    assert torch.equal(again, out)


@pytest.mark.parametrize("M", [8, 32])
def test_fused_o_mlp_kernel_same_bits_each_call(dev, M):
    """Two calls on the same inputs give the same bits (y and every
    intermediate), each counted once; f32 attn and output too."""
    attn, x_res, norm, ops = _tail_case(dev, M, 4096, 4096, 14336, 128, 21 + M)
    for a in (attn, attn.float()):
        before = _build.launch_counts["fused_o_mlp"]
        first = [t.clone() for t in mm._fused_o_mlp_launch(a, x_res, norm, *ops, 1, 128, 1e-5)]
        assert _build.launch_counts["fused_o_mlp"] == before + 1
        second = mm._fused_o_mlp_launch(a, x_res, norm, *ops, 1, 128, 1e-5)
        assert _build.launch_counts["fused_o_mlp"] == before + 2
        assert first[0].dtype == a.dtype
        assert all(torch.equal(u, v) for u, v in zip(first, second))


def test_fused_o_mlp_kernel_after_other_shapes(dev):
    """The tensor maps cached by weight pointer and shape, and the plans by
    shape: a large call, a small one, then the large one again give the
    first bits; weights freed and made anew (the allocator hands back their
    blocks, under other shapes too) still match the plain version."""
    big = _tail_case(dev, 64, 4096, 4096, 14336, 128, 7)
    small = _tail_case(dev, 5, 512, 256, 384, 64, 8)
    first = mm.fused_o_mlp_stacked(big[0], big[1], big[2], *big[3], 1, group_size=128)
    mm.fused_o_mlp_stacked(small[0], small[1], small[2], *small[3], 1, group_size=64)
    again = mm.fused_o_mlp_stacked(big[0], big[1], big[2], *big[3], 1, group_size=128)
    assert torch.equal(first, again)
    del big, small
    for case in ((8, 4096, 4096, 14336, 128, 17), (33, 256, 256, 512, 32, 18),
                 (5, 512, 256, 384, 64, 19)):
        M, K1, H, inter, g, seed = case
        attn, x_res, norm, ops = _tail_case(dev, M, K1, H, inter, g, seed)
        x1 = mm._fused_o_mlp_launch(attn, x_res, norm, *ops, 1, g, 1e-5)[1]
        assert torch.equal(x1, _tail_plain(attn, x_res, norm, ops, g)[1])
        del attn, x_res, norm, ops


def test_paged_decode_step_takes_the_kernels_at_any_page(dev):
    """A paged decode step at page 32 with one query head per kv head (the
    shapes the JAX package sends to its references) launches the paged
    append and paged flash-decode kernels once per layer; the pools equal
    those of the plain versions and the logits stay within the w4a8_2l
    relative RMS bound."""
    from unittest import mock

    from fastforward_tpu_torch.models.llama import LlamaConfig
    from fastforward_tpu_torch.serving import stacked as stk
    from fastforward_tpu_torch.serving.paged import PagedKVCache

    config = LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=2,
                         num_heads=2, num_kv_heads=2, head_dim=128)
    params, layers = stk.random_stacked_params(config, mode="w4a8_2l", seed=3, device=dev)
    fused = stk.fuse_stacked_layers(layers)
    cache = PagedKVCache.create(2, 6, 2, 4, 2, 128, page_size=32, device=dev)
    gen = _gen(dev, 11)
    cache.k.copy_(_ri(gen, -128, 128, cache.k.shape, torch.int8, dev))
    cache.v.copy_(_ri(gen, -128, 128, cache.v.shape, torch.int8, dev))
    cache.k_scale.copy_(torch.rand(cache.k_scale.shape, generator=gen, device=dev) * 0.05)
    cache.v_scale.copy_(torch.rand(cache.v_scale.shape, generator=gen, device=dev) * 0.05)
    cache.table.copy_(torch.tensor([[3, 1, -1, -1], [2, 5, 4, -1]], dtype=torch.int32))
    tokens = torch.tensor([[17], [301]], dtype=torch.int64, device=dev)
    positions = torch.tensor([[40], [70]], dtype=torch.int32, device=dev)
    plain = PagedKVCache(*[t.clone() for t in (cache.k, cache.v, cache.k_scale, cache.v_scale,
                                               cache.table)])

    before = {n: _build.launch_counts[n] for n in ("paged_kv_append", "paged_flash_decode")}
    logits, _ = stk.serving_forward_stacked(params, fused, config, tokens, cache, positions)
    for name, count in before.items():
        assert _build.launch_counts[name] == count + config.num_layers
    with mock.patch.object(stk, "paged_kv_quantize_append",
                           pa.paged_kv_quantize_append_reference), \
            mock.patch.object(stk, "paged_flash_decode_int8",
                              lambda q, k, ks, v, vs, t, n, l: pa.paged_flash_decode_reference(
                                  q, k[l], ks[l], v[l], vs[l], t, n)):
        ref, _ = stk.serving_forward_stacked(params, fused, config, tokens, plain, positions)
    for a, b in zip((cache.k, cache.v, cache.k_scale, cache.v_scale),
                    (plain.k, plain.v, plain.k_scale, plain.v_scale)):
        assert torch.equal(a, b)
    assert torch.isfinite(logits).all()
    rel_rms = ((logits - ref).pow(2).mean().sqrt() / ref.pow(2).mean().sqrt()).item()
    assert rel_rms <= 0.03


# --- the per-layer cache path: the unpaired two-level W4A8 GEMV, the
# per-layer append and flash decode, flash prefill over bf16 K/V, and the
# forward and loader on the card


@pytest.mark.parametrize("M,K,N,g", [
    (1, 256, 132, 64), (192, 4096, 4096, 128), (13, 1024, 4100, 32), (192, 14336, 4096, 128),
    (8, 384, 260, 128), (192, 4096, 128256, 128),
    # the tensor-core tile: odd M on the TMA feed with a ragged last column
    # tile, K split at N = 1024, 256 rows, groups of 4 and 12 rows a plane
    (17, 4096, 1040, 128), (256, 4096, 1024, 128), (5, 256, 40, 8), (9, 480, 100, 24),
])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_w4a8_unpaired_gemv_kernel_bit_equal(dev, M, K, N, g, out_dtype):
    # group halves, offset binary (pack_uint4_offset); 3 groups in one case
    gen = _gen(dev, M + K + N + g)
    w = _ri(gen, -128, 128, (K // 2, N), torch.int8, dev)
    m = _ri(gen, 1, 16, (K // g, N), torch.int8, dev)
    s = torch.rand((N,), generator=gen, device=dev) * 1e-2
    x_q, x_s = mm.quantize_rowwise(torch.randn((M, K), generator=gen, device=dev))
    before = _build.launch_counts["w4a8_gemv_unpaired"]
    out = mm.matmul_w4a8_2l_gemv(x_q, x_s, w, m, s, g, out_dtype, paired=False)
    assert _build.launch_counts["w4a8_gemv_unpaired"] == before + 1
    ref = mm.matmul_w4a8_2l_reference(x_q, x_s, w, m, s, None, g, out_dtype, paired=False)
    assert out.dtype == out_dtype and torch.equal(out, ref)


def test_per_layer_kv_append_kernel_bit_equal(dev):
    # starts 0, S - 1, S (no write) and one inside; written in place
    gen = _gen(dev, 21)
    B, Hkv, S, D = 4, 8, 512, 128
    cache = [_ri(gen, -128, 128, (B, Hkv, S, D), torch.int8, dev) for _ in range(2)]
    cache += [torch.rand((B, Hkv, S), generator=gen, device=dev) for _ in range(2)]
    new = [_ri(gen, -128, 128, (B, Hkv, 1, D), torch.int8, dev) for _ in range(2)]
    new += [torch.rand((B, Hkv, 1), generator=gen, device=dev) for _ in range(2)]
    starts = torch.tensor([0, S - 1, S, 77], dtype=torch.int32, device=dev)
    ref = kvu.kv_append_decode_reference(*cache, *new, starts)
    bufs = [t.clone() for t in cache]
    before = _build.launch_counts["kv_append_layer"]
    out = kvu.kv_append_decode_int8(*bufs, *new, starts)
    assert _build.launch_counts["kv_append_layer"] == before + 1
    for a, b, r in zip(out, bufs, ref):
        assert a is b and torch.equal(a, r)


@pytest.mark.parametrize("G", [1, 2, 4, 8])
def test_per_layer_flash_decode_kernel(dev, G):
    # G >= 2: the kernel, within one bf16 ulp of the largest output; G = 1:
    # the plain version by name, as the JAX TPU route (no launch)
    gen = _gen(dev, 30 + G)
    B, Hkv, S, d = 5, 2 if G == 8 else 4, 512, 128
    k = _ri(gen, -128, 128, (B, Hkv, S, d), torch.int8, dev)
    v = _ri(gen, -128, 128, (B, Hkv, S, d), torch.int8, dev)
    ks = torch.rand((B, Hkv, S), generator=gen, device=dev) * 0.05
    vs = torch.rand((B, Hkv, S), generator=gen, device=dev) * 0.05
    q = torch.randn((B, Hkv * G, d), generator=gen, device=dev).to(torch.bfloat16)
    lengths = torch.tensor([1, 256, 257, 500, S], dtype=torch.int32, device=dev)
    before = _build.launch_counts["flash_decode_layer"]
    out = att.flash_decode_int8(q, k, ks, v, vs, lengths)
    ref = att.flash_decode_int8_reference(q, k, ks, v, vs, lengths)
    assert _build.launch_counts["flash_decode_layer"] == before + (G >= 2)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= 8e-3 * ref.float().abs().max().item()
    if G == 1:
        assert torch.equal(out, ref)


@pytest.mark.parametrize("G", [1, 2, 4])
def test_flash_decode_select_lifts_a_per_layer_cache_to_the_kernel(dev, G):
    # a per-layer cache goes to the kernel at L = 1 at every group count, as
    # the JAX dispatch lifts it to its stacked kernels; counted per layer
    from fastforward_tpu_torch.serving import stacked as stk

    gen = _gen(dev, 40 + G)
    B, Hkv, S, d = 3, 4, 512, 128
    k = _ri(gen, -128, 128, (B, Hkv, S, d), torch.int8, dev)
    v = _ri(gen, -128, 128, (B, Hkv, S, d), torch.int8, dev)
    ks = torch.rand((B, Hkv, S), generator=gen, device=dev) * 0.05
    vs = torch.rand((B, Hkv, S), generator=gen, device=dev) * 0.05
    q = torch.randn((B, Hkv * G, d), generator=gen, device=dev).to(torch.bfloat16)
    lengths = torch.tensor([1, 300, S], dtype=torch.int32, device=dev)
    before = dict(_build.launch_counts)
    out = stk.flash_decode_select(q, k, ks, v, vs, lengths, None)
    assert _build.launch_counts["flash_decode_layer"] == before.get("flash_decode_layer", 0) + 1
    assert _build.launch_counts["flash_decode"] == before.get("flash_decode", 0)
    ref = att.flash_decode_int8_reference(q, k, ks, v, vs, lengths)
    assert (out.float() - ref.float()).abs().max().item() <= 8e-3 * ref.float().abs().max().item()


@pytest.mark.parametrize("G", [1, 2, 4, 8])
@pytest.mark.parametrize("T,S,starts", [(128, 512, (0, 0, 0)), (40, 100, (0, 7, 60)),
                                        (77, 300, (5, 0, 223)), (1, 64, (63, 0, 10)),
                                        (200, 260, (0, 30, 60)), (300, 333, (0, 11, 33))])
def test_flash_prefill_bf16_kernel_within_tolerance(dev, G, T, S, starts):
    gen = _gen(dev, 7 * G + T + S)
    B, Hkv, d = 3, 2, 128
    k = torch.randn((B, Hkv, S, d), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((B, Hkv, S, d), generator=gen, device=dev).to(torch.bfloat16)
    q = torch.randn((B, Hkv * G, T, d), generator=gen, device=dev).to(torch.bfloat16)
    st = torch.tensor(starts, dtype=torch.int32, device=dev)
    before = _build.launch_counts["flash_prefill_bf16"]
    out = att.flash_prefill(q, k, None, v, None, st)
    assert _build.launch_counts["flash_prefill_bf16"] == before + 1
    ref = att.flash_prefill_reference(q, k, None, v, None, st)
    err = (out.float() - ref.float()).abs().max().item()
    assert out.shape == q.shape and err <= 8e-3 * ref.float().abs().max().item()


@pytest.mark.parametrize("kv", ["int8", "bf16"])
@pytest.mark.parametrize("G,T", [(4, 128), (1, 77), (8, 200)])
def test_flash_prefill_kernel_persistent_blocks(dev, kv, G, T):
    # more work items than SMs: each persistent block walks several items
    # (their K/V tiles through one ring, Q double-buffered, the stores
    # draining behind); the same bits call to call
    gen = _gen(dev, 31 * G + T)
    B, Hkv, S, d = 64, 8, 384, 128
    H = Hkv * G
    q = torch.randn((B, H, T, d), generator=gen, device=dev).to(torch.bfloat16)
    if kv == "int8":
        k = _ri(gen, -128, 128, (B, Hkv, S, d), torch.int8, dev)
        v = _ri(gen, -128, 128, (B, Hkv, S, d), torch.int8, dev)
        ks = torch.rand((B, Hkv, S), generator=gen, device=dev) * 0.02
        vs = torch.rand((B, Hkv, S), generator=gen, device=dev) * 0.05
    else:
        k = torch.randn((B, Hkv, S, d), generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn((B, Hkv, S, d), generator=gen, device=dev).to(torch.bfloat16)
        ks = vs = None
    st = torch.randint(0, S - T + 1, (B,), generator=gen, device=dev, dtype=torch.int32)
    assert att.prefill_plan(B, H, Hkv, T, S).items > 132
    out = att.flash_prefill(q, k, ks, v, vs, st)
    ref = att.flash_prefill_reference(q, k, ks, v, vs, st)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= 8e-3 * ref.float().abs().max().item()
    assert torch.equal(out, att.flash_prefill(q, k, ks, v, vs, st))


@pytest.mark.parametrize("K,N", [(4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096)])
def test_dequant_every_layout_at_the_8b_shapes(dev, K, N):
    # the four prefill dequant rows at Llama-3-8B's projections, on the
    # grid of matmul.dequant_plan: vertical g512, paired g128 flat and
    # pre-blocked at bn 128 and 512, group halves g128 (two's complement
    # and offset binary); bit-equal, each call counted once
    gen = _gen(dev, K + N)
    L = 2
    for layout, g in (("vertical", 512), ("paired", 128)):
        w = _ri(gen, -128, 128, (L, K // 2, N), torch.int8, dev)
        m = _ri(gen, 1, 16, (L, K // g, N), torch.int8, dev)
        s = torch.rand((L, N), generator=gen, device=dev) * 1e-2
        ref = getattr(mm, f"dequantize_int4_{layout}_reference")(w[1], m[1].float() * s[1][None, :],
                                                                g)
        stacked = getattr(mm, f"dequantize_int4_{layout}_stacked")
        forms = [(w, f"dequant_{layout}")]
        if layout == "paired":
            forms += [(mm.preblock_stacked(w, bn), "dequant_paired_preblocked")
                      for bn in (128, 512)]
        for wt, count in forms:
            before = _build.launch_counts[count]
            assert torch.equal(stacked(wt, m, s, 1, group_size=g), ref)
            assert _build.launch_counts[count] == before + 1
        del w, forms, ref
    w, s = _w4(gen, K, N, 128, dev)
    for offset_binary in (False, True):
        before = _build.launch_counts["dequant_halves"]
        out = mm.dequantize_int4(w, s, 128, offset_binary=offset_binary)
        assert _build.launch_counts["dequant_halves"] == before + 1
        ref = mm.dequantize_int4_reference(w, s, 128, offset_binary=offset_binary)
        assert torch.equal(out, ref)


@pytest.mark.parametrize("mode,quantized", [("w4a8_2l", False), ("w4a8", True)])
def test_per_layer_forward_takes_the_kernels(dev, mode, quantized):
    """The per-layer prefill and decode on the card launch this path's
    kernels once per layer (projection GEMVs per call) and stay within the
    mode's relative RMS bound of the same forward on the CPU."""
    import dataclasses

    from fastforward_tpu_torch.models.llama import LlamaConfig
    from fastforward_tpu_torch.serving import KVCache, make_decode_loop, serving_forward
    from fastforward_tpu_torch.serving.engine import random_serving_params

    def to_cpu(obj):
        if torch.is_tensor(obj):
            return obj.cpu()
        if isinstance(obj, tuple):
            return tuple(to_cpu(o) for o in obj)
        if dataclasses.is_dataclass(obj):
            return dataclasses.replace(obj, **{f.name: to_cpu(getattr(obj, f.name))
                                               for f in dataclasses.fields(obj)})
        return obj

    config = LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=2,
                         num_heads=4, num_kv_heads=2, head_dim=128)
    params = random_serving_params(config, mode, group_size=64, seed=4, device=dev)
    cpu = to_cpu(params)
    ids = torch.randint(0, 512, (3, 9), generator=_gen(dev, 5), device=dev)
    out = {}
    for where, p in ((dev, params), (torch.device("cpu"), cpu)):
        cache = KVCache.create(2, 3, 32, 2, 128, quantized=quantized, device=where)
        _build.reset_launch_counts()
        logits, cache = serving_forward(p, config, ids.to(where), cache)
        toks, cache = make_decode_loop(config, 3)(p, cache, ids[:, -1:].to(where))
        out[where.type] = (logits, dict(_build.launch_counts))
    counts = out["cuda"][1]
    gemv = "w4a8_gemv_unpaired" if mode == "w4a8_2l" else "w4a8_gemv_halves"
    assert counts[gemv] == 7 * 2 * 4 + 1 + 3 and not out["cpu"][1]
    assert counts["flash_prefill_bf16" if not quantized else "flash_prefill"] == 2
    if quantized:
        assert counts["kv_append_layer"] == counts["flash_decode_layer"] == 2 * 3
    else:
        assert "kv_append_layer" not in counts and "flash_decode_layer" not in counts
    a, b = out["cuda"][0].cpu(), out["cpu"][0]
    assert torch.isfinite(a).all()
    assert ((a - b).pow(2).mean() / b.pow(2).mean()).sqrt().item() <= 0.03


def test_load_llama_on_the_card_gives_the_cpu_bytes(dev, tmp_path):
    """A bf16 checkpoint written by the port's writer, loaded on the card
    and on the CPU: every quantized array byte-equal."""
    from fastforward_tpu_torch.models.llama import LlamaConfig
    from fastforward_tpu_torch.serving.convert import params_to_flat
    from fastforward_tpu_torch.serving.loader import load_llama, write_safetensors

    config = LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=2,
                         num_heads=2, num_kv_heads=1, head_dim=128)
    gen = torch.Generator().manual_seed(9)
    shapes = {"embed_tokens": (512, 256), "norm": (256,)}
    for i in range(2):
        p = f"layers.{i}."
        shapes.update({p + "self_attn.q_proj": (256, 256), p + "self_attn.k_proj": (128, 256),
                       p + "self_attn.v_proj": (128, 256), p + "self_attn.o_proj": (256, 256),
                       p + "mlp.gate_proj": (512, 256), p + "mlp.up_proj": (512, 256),
                       p + "mlp.down_proj": (256, 512), p + "input_layernorm": (256,),
                       p + "post_attention_layernorm": (256,)})
    tensors = {f"model.{k}.weight": (torch.randn(v, generator=gen) * 0.05).to(torch.bfloat16)
               for k, v in shapes.items()}
    tensors["lm_head.weight"] = (torch.randn((512, 256), generator=gen) * 0.05).to(torch.bfloat16)
    write_safetensors(str(tmp_path / "m.safetensors"), tensors)
    for mode in ("w8a8", "w4a8", "w4a16"):
        a = params_to_flat(load_llama(str(tmp_path), config, mode, device=dev))
        b = params_to_flat(load_llama(str(tmp_path), config, mode, device="cpu"))
        assert set(a) == set(b)
        for key in a:
            assert a[key].tobytes() == b[key].tobytes(), (mode, key)


# --- the float-scale modes (w8a8, w4a8, w4a16): W8A8 GEMM, W4A8 halves
# GEMV, W4 GEMV and the group-halves dequant. M covers one row, a ragged
# tile, one 8-row tile, bench.py's batch and the GEMV limit; N = 4100 and
# 260 are multiples of 4 but not of 16 (the 4-byte weight copies); K =
# 14336 and 1056 at g = 32 give 112 and 33 groups (the windowed W4A8 sum).

# W4 GEMV: f32 outputs within this share of the largest output of the
# plain version (tensor-core sums in another order); bf16 outputs within
# one bf16 ulp more.
W4_GEMV_RTOL = 1e-4
_MS = [1, 7, 8, 192, 256]


def _w4(gen, K, N, g, dev):
    w = _ri(gen, -128, 128, (K // 2, N), torch.int8, dev)
    s = torch.rand((K // g, N), generator=gen, device=dev) * 0.05 + 1e-3
    return w, s


def _bf16_ulp(a):
    return torch.exp2(torch.floor(torch.log2(a.abs().clamp_min(torch.finfo(torch.float32).tiny))) - 7)


@pytest.mark.parametrize("M", _MS + [1000])
@pytest.mark.parametrize("K,N", [(4096, 6144), (14336, 260), (1024, 4100)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_w8a8_gemm_kernel_bit_equal(dev, M, K, N, out_dtype):
    gen = _gen(dev, M + K + N)
    w = _ri(gen, -127, 128, (K, N), torch.int8, dev)
    ws = torch.rand((N,), generator=gen, device=dev) * 1e-3
    x_q, x_s = mm.quantize_rowwise(torch.randn((M, K), generator=gen, device=dev))
    before = _build.launch_counts["w8a8_gemm"]
    out = mm.matmul_w8a8(x_q, x_s, w, ws, out_dtype=out_dtype)
    assert _build.launch_counts["w8a8_gemm"] == before + 1
    ref = mm.matmul_w8a8_reference(x_q, x_s, w, ws, out_dtype=out_dtype)
    assert out.dtype == out_dtype and torch.equal(out, ref)


def test_w8a8_gemm_kernel_bias_and_ragged_k(dev):
    # a bias fused into the last product; K = 80, not a multiple of the
    # 64-deep k step
    gen = _gen(dev, 80)
    M, K, N = 37, 80, 136
    w = _ri(gen, -127, 128, (K, N), torch.int8, dev)
    ws = torch.rand((N,), generator=gen, device=dev) * 1e-2
    bias = torch.randn((N,), generator=gen, device=dev)
    x_q, x_s = mm.quantize_rowwise(torch.randn((M, K), generator=gen, device=dev))
    for out_dtype in (torch.float32, torch.bfloat16):
        out = mm.matmul_w8a8(x_q, x_s, w, ws, bias, out_dtype=out_dtype)
        assert torch.equal(out, mm.matmul_w8a8_reference(x_q, x_s, w, ws, bias, out_dtype))


@pytest.mark.parametrize("M", _MS)
@pytest.mark.parametrize("K,N,g", [(4096, 6144, 128), (14336, 4100, 128), (1056, 260, 32),
                                   (512, 132, 64)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_w4a8_halves_gemv_kernel_bit_equal(dev, M, K, N, g, out_dtype):
    gen = _gen(dev, M + K + N + g)
    w, s = _w4(gen, K, N, g, dev)
    x_q, x_s = mm.quantize_rowwise(torch.randn((M, K), generator=gen, device=dev))
    before = _build.launch_counts["w4a8_gemv_halves"]
    out = mm.matmul_w4a8_gemv(x_q, x_s, w, s, g, out_dtype)
    assert _build.launch_counts["w4a8_gemv_halves"] == before + 1
    ref = mm.matmul_w4a8_reference(x_q, x_s, w, s, None, g, out_dtype)
    assert out.dtype == out_dtype and torch.equal(out, ref)


@pytest.mark.parametrize("M", _MS)
@pytest.mark.parametrize("K,N,g", [(4096, 6144, 128), (14336, 4100, 128), (256, 40, 32),
                                   (512, 132, 64)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_w4_gemv_kernel_within_tolerance(dev, M, K, N, g, out_dtype):
    gen = _gen(dev, M + K + N + g)
    w, s = _w4(gen, K, N, g, dev)
    x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
    before = _build.launch_counts["w4_gemv"]
    out = mm.matmul_w4_gemv(x, w, s, g, out_dtype)
    assert _build.launch_counts["w4_gemv"] == before + 1
    ref32 = mm.matmul_w4_gemv_reference(x, w, s, g, torch.float32)
    assert out.dtype == out_dtype
    err = (out.float() - ref32).abs()
    tol = W4_GEMV_RTOL * ref32.abs().max()
    if out_dtype == torch.bfloat16:
        tol = tol + _bf16_ulp(ref32)
    assert (err <= tol).all()
    if out_dtype == torch.float32:
        # the greedy ids agree wherever the top-2 margin exceeds the error
        top2 = torch.topk(ref32, 2, dim=-1).values
        sure = top2[:, 0] - top2[:, 1] > err.max()
        assert torch.equal(torch.argmax(out, -1)[sure], torch.argmax(ref32, -1)[sure])


@pytest.mark.parametrize("offset_binary", [False, True])
@pytest.mark.parametrize("K,N,g", [(4096, 6144, 128), (14336, 4096, 128), (1024, 4100, 128),
                                   (256, 40, 32)])
def test_dequant_halves_kernel_bit_equal(dev, offset_binary, K, N, g):
    gen = _gen(dev, K + N + g + offset_binary)
    w, s = _w4(gen, K, N, g, dev)
    before = _build.launch_counts["dequant_halves"]
    out = mm.dequantize_int4(w, s, g, offset_binary=offset_binary)
    assert _build.launch_counts["dequant_halves"] == before + 1
    ref = mm.dequantize_int4_reference(w, s, g, offset_binary=offset_binary)
    assert out.dtype == torch.bfloat16 and torch.equal(out, ref)


def test_float_scale_routing_takes_the_kernels(dev):
    # up to 256 rows the GEMVs, above them the halves dequant and a dense
    # product; W8A8 its GEMM at any size
    gen = _gen(dev, 5)
    K, N, g = 512, 64, 128
    w, s = _w4(gen, K, N, g, dev)
    w8 = _ri(gen, -127, 128, (K, N), torch.int8, dev)
    names = ("w4a8_gemv_halves", "w4_gemv", "dequant_halves", "w8a8_gemm")
    for M, expect in ((256, (1, 1, 0, 1)), (257, (0, 0, 2, 1))):
        before = [_build.launch_counts[n] for n in names]
        x = torch.randn((M, K), generator=gen, device=dev)
        x_q, x_s = mm.quantize_rowwise(x)
        mm.matmul_w4a8(x_q, x_s, w, s, group_size=g)
        mm.matmul_w4a16(x.to(torch.bfloat16), w, s, group_size=g)
        mm.matmul_w8a8(x_q, x_s, w8, s[0])
        assert tuple(_build.launch_counts[n] - b for n, b in zip(names, before)) == expect


_8B_SHAPES = {"qkv": (4096, 6144), "o": (4096, 4096), "gate_up": (4096, 28672),
              "down": (14336, 4096), "lm_head": (4096, 128256)}


_WGMMA_NAMES = ("w4a8_gemv_halves", "w4_gemv", "w4a16_gemm")


def _any_group_case(x_q, x_s, xb, w, s, g, out_dtype, tiled=True):
    """Rows 16, 17 (and 18t) at any group the reference takes, on their
    tensor-core kernels (x permuted into byte-row order first where
    `float_scale_route` says "permuted"): row 16 bit-equal, 17 and 18t
    within W4_GEMV_RTOL of the largest f32 output (one bf16 ulp more in
    bf16), 18t's bias epilogue exact; each call counted once under the
    row's own name."""
    names = _WGMMA_NAMES
    expect = {"w4a8_gemv_halves": 1, "w4_gemv": 1, "w4a16_gemm": 2 if tiled else 0}
    before = {n: _build.launch_counts[n] for n in names}
    out = mm.matmul_w4a8_gemv(x_q, x_s, w, s, g, out_dtype)
    assert out.dtype == out_dtype
    assert torch.equal(out, mm.matmul_w4a8_reference(x_q, x_s, w, s, None, g, out_dtype))
    outs = [(mm.matmul_w4_gemv(xb, w, s, g, out_dtype),
             mm.matmul_w4_gemv_reference(xb, w, s, g, torch.float32))]
    if tiled:
        bias = torch.randn((w.shape[1],), device=w.device)
        o = mm.matmul_w4a16_tiled(xb, w, s, None, g, out_dtype)
        assert torch.equal(mm.matmul_w4a16_tiled(xb, w, s, bias, g, out_dtype),
                           (o.float() + bias).to(out_dtype))
        outs.append((o, mm.matmul_w4a16_tiled_reference(xb, w, s, None, g, torch.float32)))
    for o, ref32 in outs:
        tol = W4_GEMV_RTOL * ref32.abs().max()
        if out_dtype == torch.bfloat16:
            tol = tol + _bf16_ulp(ref32)
        assert o.dtype == out_dtype and ((o.float() - ref32).abs() <= tol).all()
    assert {n: _build.launch_counts[n] - b for n, b in before.items()} == expect


@pytest.mark.parametrize("K,g", [(80, 2), (640, 16), (1920, 48), (3840, 96), (7680, 192),
                                 (12800, 320), (192, 192), (320, 320), (1536, 96), (2050, 2),
                                 (32 * 1056, 32)])
@pytest.mark.parametrize("M", [1, 8, 192])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_float_scale_any_group_route(dev, K, g, M, out_dtype):
    # groups the kernels read x for permuted into byte-row order: 40 groups
    # (the oracle's 32-wide windows, the first shortened), g = K at 192 and
    # 320, 16 groups (the fused multiply-add chain); 1,025 and 1,056 groups
    # (windows of window sums: row 16's direct fold stops at 32 x 32, so g
    # 32 takes its permuted route and window tree there, rows 17 and 18t
    # their direct ones); N = 260: a ragged column block
    gen = _gen(dev, K + g + M)
    w, s = _w4(gen, K, 260, g, dev)
    x = torch.randn((M, K), generator=gen, device=dev)
    x_q, x_s = mm.quantize_rowwise(x)
    _any_group_case(x_q, x_s, x.to(torch.bfloat16), w, s, g, out_dtype)


@pytest.mark.parametrize("name,g", [("down", 112), ("o", 16)])
@pytest.mark.parametrize("M", [8, 192])
def test_float_scale_any_group_route_at_8b_projections(dev, name, g, M):
    # Llama-3-8B's down_proj at g 112 (128 groups: four windows) and o_proj
    # at g 16 (256 groups); their K (14,336 and 4,096) take no multiple of 96
    K, N = _8B_SHAPES[name]
    gen = _gen(dev, K + g + M)
    w, s = _w4(gen, K, N, g, dev)
    x = torch.randn((M, K), generator=gen, device=dev)
    x_q, x_s = mm.quantize_rowwise(x)
    _any_group_case(x_q, x_s, x.to(torch.bfloat16), w, s, g, torch.bfloat16, tiled=M == 192)


@pytest.mark.parametrize("g", [256, 512, "K"])
def test_float_scale_wrappers_reject_what_the_kernels_do_not_take(dev, g):
    # groups of 256 and more (a multiple of 128, up to g = K) are kernel
    # groups: at Llama-3-8B's four projections and the f32 lm_head, row 16
    # is bit-equal, rows 17 and 18t within W4_GEMV_RTOL of the largest f32
    # output; each call counted once
    gen = _gen(dev, 256 if g == "K" else g)
    for name, (K, N) in _8B_SHAPES.items():
        gk = K if g == "K" else g
        out_dtype = torch.float32 if name == "lm_head" else torch.bfloat16
        w, s = _w4(gen, K, N, gk, dev)
        for M in (8, 192):
            x = torch.randn((M, K), generator=gen, device=dev)
            x_q, x_s = mm.quantize_rowwise(x)
            before = _build.launch_counts["w4a8_gemv_halves"]
            out = mm.matmul_w4a8_gemv(x_q, x_s, w, s, gk, out_dtype)
            assert _build.launch_counts["w4a8_gemv_halves"] == before + 1
            assert torch.equal(out, mm.matmul_w4a8_reference(x_q, x_s, w, s, None, gk, out_dtype))
            xb = x.to(torch.bfloat16)
            before = _build.launch_counts["w4_gemv"]
            out = mm.matmul_w4_gemv(xb, w, s, gk, torch.float32)
            assert _build.launch_counts["w4_gemv"] == before + 1
            ref = mm.matmul_w4_gemv_reference(xb, w, s, gk, torch.float32)
            assert (out - ref).abs().max() <= W4_GEMV_RTOL * ref.abs().max()
        if name != "lm_head":
            xb = torch.randn((200, K), generator=gen, device=dev).to(torch.bfloat16)
            before = _build.launch_counts["w4a16_gemm"]
            out = mm.matmul_w4a16_tiled(xb, w, s, None, gk, torch.float32)
            assert _build.launch_counts["w4a16_gemm"] == before + 1
            ref = mm.matmul_w4a16_tiled_reference(xb, w, s, None, gk, torch.float32)
            assert (out - ref).abs().max() <= W4_GEMV_RTOL * ref.abs().max()
        del w, s
    # group 192 (no multiple of 128) and K = g = 320 (K % 128 != 0) take
    # the kernels' permuted route: row 16 bit-equal, rows 17 and 18t within
    # W4_GEMV_RTOL, each counted once under its row's name
    for K, g in ((384, 192), (320, 320)):
        w, s = _w4(gen, K, 64, g, dev)
        x = torch.randn((2, K), generator=gen, device=dev)
        x_q, x_s = mm.quantize_rowwise(x)
        _any_group_case(x_q, x_s, x.to(torch.bfloat16), w, s, g, torch.float32)
    # and past the direct fold's 32 x 32 groups: 1,025 groups of 2 (the
    # window tree)
    w, s = _w4(gen, 2050, 64, 2, dev)
    x = torch.randn((2, 2050), generator=gen, device=dev)
    x_q, x_s = mm.quantize_rowwise(x)
    _any_group_case(x_q, x_s, x.to(torch.bfloat16), w, s, 2, torch.float32)
    # what they still refuse: an odd group, more than the GEMVs' 256 rows
    x_q = torch.zeros((2, 384), dtype=torch.int8, device=dev)
    x_s = torch.ones((2,), device=dev)
    w = torch.zeros((192, 64), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="group"):
        mm.matmul_w4a8_gemv(x_q, x_s, w, torch.ones((128, 64), device=dev), 3)
    with pytest.raises(ValueError, match="group"):
        mm.matmul_w4_gemv(x_q.to(torch.bfloat16), w, torch.ones((128, 64), device=dev), 3)
    with pytest.raises(ValueError, match="group"):
        mm.matmul_w4a16_tiled(x_q.to(torch.bfloat16), w, torch.ones((128, 64), device=dev),
                              None, 3)
    with pytest.raises(ValueError, match="M <= 256"):
        mm.matmul_w4a8_gemv(torch.zeros((257, 384), dtype=torch.int8, device=dev),
                            torch.ones((257,), device=dev), w, torch.ones((4, 64), device=dev), 96)
    with pytest.raises(ValueError, match="M <= 256"):
        mm.matmul_w4_gemv(torch.zeros((257, 384), dtype=torch.bfloat16, device=dev), w,
                          torch.ones((4, 64), device=dev), 96)
    x_q = torch.zeros((2, 256), dtype=torch.int8, device=dev)
    w = torch.zeros((128, 64), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="shape"):  # scales of another group count
        mm.matmul_w4a8_gemv(x_q, x_s, w, torch.ones((4, 64), device=dev), 128)
    with pytest.raises(ValueError, match="K % 16"):
        mm.matmul_w8a8(torch.zeros((2, 40), dtype=torch.int8, device=dev), x_s,
                       torch.zeros((40, 64), dtype=torch.int8, device=dev), torch.ones(64, device=dev))
    with pytest.raises(ValueError, match="int8"):
        mm.matmul_w8a8(x_q, x_s, torch.zeros((256, 64), dtype=torch.uint8, device=dev),
                       torch.ones(64, device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        mm.dequantize_int4(torch.zeros((64, 128), dtype=torch.int8, device=dev).t(),
                           torch.ones((2, 64), device=dev), 128)


# --- the fused decode routes: the fused layer heads (W4A8 and A4) and the
# fused o + gate/up head of the tail


def _head_case(dev, M, K, N, g, seed):
    gen = _gen(dev, seed)
    L = 3
    w = _ri(gen, -128, 128, (L, K // 2, N), torch.int8, dev)
    mp = pack_mult_nibbles(_ri(gen, 1, 16, (L, K // g, N), torch.int8, dev)).contiguous()
    s = torch.rand((L, N), generator=gen, device=dev) * 1e-2
    x = (torch.randn((M, K), generator=gen, device=dev) * 3).to(torch.bfloat16)
    norm = (torch.rand((L, K), generator=gen, device=dev) + 0.5).to(torch.bfloat16)
    return x, norm, w, mp, s


@pytest.mark.parametrize("a4,M,K,N,g", [
    (False, 1, 4096, 6144, 128), (False, 8, 4096, 6144, 128), (False, 64, 512, 260, 64),
    (False, 192, 4096, 6144, 128), (False, 256, 1024, 132, 64),
    (True, 1, 4096, 6144, 512), (True, 8, 2048, 264, 128), (True, 64, 4096, 6144, 512),
    (True, 192, 4096, 6144, 512), (True, 256, 1024, 516, 64),
])
def test_fused_head_kernel_bit_equal(dev, a4, M, K, N, g):
    # the norm, the row quantizer and the GEMV: hq, its scale and the
    # output bit-equal to the plain version, on the first and last layer
    x, norm, w, mp, s = _head_case(dev, M, K, N, g, M + K + N)
    name = "fused_norm_qkv_a4" if a4 else "fused_norm_qkv"
    quant = mm.quantize_rowwise_a4 if a4 else mm.quantize_rowwise
    for layer in (0, 2):
        before = _build.launch_counts[name]
        out, hq, hs = mm._fused_head_launch(a4, x, norm, w, mp, s, layer, g, 1e-5, torch.bfloat16)
        assert _build.launch_counts[name] == before + 1
        rq, rs = mm._norm_quant(x, norm[layer], 1e-5, quant)
        assert torch.equal(hq, rq) and torch.equal(hs, rs)
        fn = mm.fused_norm_qkv_stacked_a4 if a4 else mm.fused_norm_qkv_stacked
        ref = fn(x.cpu(), norm.cpu(), w.cpu(), mp.cpu(), s.cpu(), layer, group_size=g)
        assert out.dtype == torch.bfloat16 and torch.equal(out.cpu(), ref)
    f32 = (mm.fused_norm_qkv_stacked_a4 if a4 else mm.fused_norm_qkv_stacked)(
        x, norm, w, mp, s, 2, group_size=g, out_dtype=torch.float32)
    ref = (mm.fused_norm_qkv_a4_reference if a4 else mm.fused_norm_qkv_reference)(
        x.float(), norm[2], w[2], unpack_mult_nibbles(mp[2], K // g), s[2], g)
    assert f32.dtype == torch.float32 and torch.equal(f32, ref)


def test_fused_heads_reject_what_the_kernels_do_not_take(dev):
    x, norm, w, mp, s = _head_case(dev, 4, 384, 132, 64, 1)
    with pytest.raises(ValueError, match="2 \\* group"):  # 6 groups of 64: 3 pairs, but
        mm.fused_norm_qkv_stacked(x, norm, w, mp, s, 0, group_size=128)  # 3 groups of 128
    with pytest.raises(ValueError, match="layer"):
        mm.fused_norm_qkv_stacked(x, norm, w, mp, s, 3, group_size=64)
    with pytest.raises(ValueError, match="bfloat16"):
        mm.fused_norm_qkv_stacked(x.float(), norm, w, mp, s, 0, group_size=64)
    with pytest.raises(ValueError, match="bfloat16"):
        mm.fused_norm_qkv_stacked_a4(x, norm.float(), w, mp, s, 0, group_size=64)
    with pytest.raises(ValueError, match="out"):
        mm.fused_norm_qkv_stacked(x, norm, w, mp, s, 0, group_size=64, out_dtype=torch.float16)


def _ogu_case(dev, M, K1, H, inter, g, seed):
    gen = _gen(dev, seed)
    L = 2
    ops = []
    for K, N in ((K1, H), (H, 2 * inter)):
        ops += [_ri(gen, -128, 128, (L, K // 2, N), torch.int8, dev),
                pack_mult_nibbles(_ri(gen, 1, 16, (L, K // g, N), torch.int8, dev)).contiguous(),
                torch.rand((L, N), generator=gen, device=dev) * (4.0 / K)]
    norm = (torch.rand((L, H), generator=gen, device=dev) + 0.5).to(torch.bfloat16)
    attn = torch.randn((M, K1), generator=gen, device=dev).to(torch.bfloat16)
    x_res = torch.randn((M, H), generator=gen, device=dev).to(torch.bfloat16)
    return attn, x_res, norm, ops


def _ogu_plain(attn, x_res, norm, ops, K1, H, g):
    o_w, o_mp, o_sc, gu_w, gu_mp, gu_sc = ops
    return mm._fused_o_gu_parts(
        attn.float(), x_res.float(), norm[1], o_w[1], unpack_mult_nibbles(o_mp[1], K1 // g),
        o_sc[1], gu_w[1], unpack_mult_nibbles(gu_mp[1], H // g), gu_sc[1], g)


@pytest.mark.parametrize("M,K1,H,inter,g", [
    (1, 4096, 4096, 14336, 128), (8, 4096, 4096, 14336, 128), (64, 4096, 4096, 14336, 128),
    (128, 4096, 4096, 14336, 128), (192, 4096, 4096, 14336, 128),
    (256, 4096, 4096, 14336, 128), (5, 512, 256, 384, 64), (33, 256, 256, 512, 32),
    (72, 2048, 1024, 384, 512),
])
def test_fused_o_gu_kernel(dev, M, K1, H, inter, g):
    # x1 bit-equal (the residual add fused with the o_proj epilogue), hq
    # within one level in a few elements, gu within rtol 8e-3; layer 1 of 2
    attn, x_res, norm, ops = _ogu_case(dev, M, K1, H, inter, g, M + K1 + g)
    before = _build.launch_counts["fused_o_gu"]
    x1, gu, hq, hs, xf_gu = mm._fused_o_gu_launch(attn, x_res, norm, *ops, 1, g, 1e-5)
    assert _build.launch_counts["fused_o_gu"] == before + 1
    rx1, rgu, rhq, rhs = _ogu_plain(attn, x_res, norm, ops, K1, H, g)
    torch.cuda.synchronize()
    assert torch.equal(x1, rx1)
    diff = (hq.int() - rhq.int()).abs()
    assert diff.max().item() <= 1
    assert diff.count_nonzero().item() <= max(4, hq.numel() // 1000)
    torch.testing.assert_close(hs, rhs, rtol=1e-6, atol=0)
    assert gu.dtype == torch.bfloat16 and tuple(gu.shape) == (M, 2 * inter)
    err = (gu.float() - rgu.float()).abs().max().item()
    assert err <= 8e-3 * rgu.float().abs().max().item()
    # the norm kernel staged hq where gate/up's tile reads it
    assert torch.equal(xf_gu, _staged(hq, mm.tail_plan(M, K1, H, 2 * inter, g, False).plans[1], g))
    again = mm.fused_o_gu_stacked(attn, x_res, norm, *ops, 1, group_size=g)
    assert torch.equal(again[0], x1) and torch.equal(again[1], gu)


@pytest.mark.parametrize("M", [8, 192])
def test_fused_o_gu_kernel_same_bits_each_call(dev, M):
    """Two calls on the same inputs give the same bits, each counted once
    (gate/up split at M = 8, not at 192); f32 attn too."""
    attn, x_res, norm, ops = _ogu_case(dev, M, 4096, 4096, 14336, 128, 31 + M)
    for a in (attn, attn.float()):
        before = _build.launch_counts["fused_o_gu"]
        first = [t.clone() for t in mm._fused_o_gu_launch(a, x_res, norm, *ops, 1, 128, 1e-5)]
        assert _build.launch_counts["fused_o_gu"] == before + 1
        second = mm._fused_o_gu_launch(a, x_res, norm, *ops, 1, 128, 1e-5)
        assert _build.launch_counts["fused_o_gu"] == before + 2
        assert all(torch.equal(u, v) for u, v in zip(first, second))


def test_fused_o_gu_kernel_after_other_shapes(dev):
    """The plans and tensor maps cached per shape and pointer: a
    bench-sized call, a small one, the fused tail's, then the first again
    give the first bits; weights freed and made anew at other shapes still
    match the plain version."""
    big = _ogu_case(dev, 192, 4096, 4096, 14336, 128, 9)
    small = _ogu_case(dev, 5, 512, 256, 384, 64, 10)
    first = mm.fused_o_gu_stacked(big[0], big[1], big[2], *big[3], 1, group_size=128)
    mm.fused_o_gu_stacked(small[0], small[1], small[2], *small[3], 0, group_size=64)
    tail = _tail_case(dev, 64, 4096, 4096, 14336, 128, 11)
    mm.fused_o_mlp_stacked(tail[0], tail[1], tail[2], *tail[3], 1, group_size=128)
    again = mm.fused_o_gu_stacked(big[0], big[1], big[2], *big[3], 1, group_size=128)
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])
    del big, small, tail
    for M, K1, H, inter, g, seed in ((8, 4096, 4096, 14336, 128, 27),
                                     (72, 2048, 1024, 384, 512, 28), (33, 256, 256, 512, 32, 29)):
        attn, x_res, norm, ops = _ogu_case(dev, M, K1, H, inter, g, seed)
        x1 = mm._fused_o_gu_launch(attn, x_res, norm, *ops, 1, g, 1e-5)[0]
        assert torch.equal(x1, _ogu_plain(attn, x_res, norm, ops, K1, H, g)[0])
        del attn, x_res, norm, ops


def test_fused_o_gu_rejects_what_the_kernel_does_not_take(dev):
    attn, x_res, norm, ops = _ogu_case(dev, 4, 256, 256, 384, 64, 12)
    with pytest.raises(ValueError, match="2 \\* group"):  # 4 groups of 64 are 2 of 128
        mm.fused_o_gu_stacked(attn, x_res, norm, *ops, 0, group_size=256)
    with pytest.raises(ValueError, match="layer"):
        mm.fused_o_gu_stacked(attn, x_res, norm, *ops, 2, group_size=64)
    with pytest.raises(ValueError, match="bfloat16"):
        mm.fused_o_gu_stacked(attn, x_res.float(), norm, *ops, 0, group_size=64)
    with pytest.raises(ValueError, match="contiguous"):
        strided = ops[3].transpose(1, 2).contiguous().transpose(1, 2)  # same shape, transposed
        mm.fused_o_gu_stacked(attn, x_res, norm, *ops[:3], strided, *ops[4:], 0, group_size=64)


@pytest.mark.parametrize("B,env,counts", [
    (72, {"FF_FUSED_QKV": "1", "FF_FUSED_OGU": "1"},
     {"fused_norm_qkv": 2, "fused_o_gu": 2, "w4a8_gemv_stacked": 2}),
    (4, {"FF_FUSED_LAYER": "0", "FF_FUSED_OGU": "1"}, {"fused_o_gu": 2, "w4a8_gemv_stacked": 4}),
    (4, {"FF_FUSED_QKV": "1"}, {"fused_norm_qkv": 2, "fused_o_mlp": 2}),
    (4, {}, {"fused_o_mlp": 2, "w4a8_gemv_stacked": 2}),
])
def test_fused_routes_decode_step(dev, B, env, counts):
    """One w4a8_2l decode step of a narrow model under the flags: the
    launches of each route per layer, and the logits of the plain path
    (every fused wrapper and GEMV swapped for its plain version) within the
    w4a8_2l relative RMS bound."""
    import os
    from unittest import mock

    from fastforward_tpu_torch.models.llama import LlamaConfig
    from fastforward_tpu_torch.serving import stacked as stk

    config = LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=2,
                         num_heads=2, num_kv_heads=1, head_dim=128)
    params, layers = stk.random_stacked_params(config, mode="w4a8_2l", group_size=64, seed=4,
                                               device=dev)
    fused = stk.fuse_stacked_layers(layers)
    gen = _gen(dev, 13)
    cache = stk.StackedKVCache.create(2, B, 64, 1, 128, device=dev)
    for t in (cache.k, cache.v):
        t.copy_(_ri(gen, -128, 128, t.shape, torch.int8, dev))
    for t in (cache.k_scale, cache.v_scale):
        t.copy_(torch.rand(t.shape, generator=gen, device=dev) * 0.05)
    cache.length = 40
    plain = stk.StackedKVCache(*[t.clone() for t in (cache.k, cache.v, cache.k_scale,
                                                     cache.v_scale)], length=40)
    tokens = _ri(gen, 0, 512, (B, 1), torch.int64, dev)
    flag_env = {k: v for k, v in os.environ.items()
                if k not in ("FF_FUSED_QKV", "FF_FUSED_OGU", "FF_FUSED_LAYER")}
    with mock.patch.dict(os.environ, {**flag_env, **env}, clear=True):
        before = dict(_build.launch_counts)
        logits, _ = stk.serving_forward_stacked(params, fused, config, tokens, cache)
        got = {k: v - before.get(k, 0) for k, v in _build.launch_counts.items()
               if v != before.get(k, 0) and k in ("fused_norm_qkv", "fused_o_gu", "fused_o_mlp",
                                                  "w4a8_gemv_stacked")}
        assert got == counts
        cpu = lambda t: t.cpu()  # noqa: E731  (the plain path: every tensor on the CPU)
        ref, _ = stk.serving_forward_stacked(
            _map(params, cpu), _map(fused, cpu), config, tokens.cpu(),
            stk.StackedKVCache(*[cpu(t) for t in (plain.k, plain.v, plain.k_scale,
                                                  plain.v_scale)], length=40))
    assert torch.isfinite(logits).all()
    ref = ref.to(dev)
    rel_rms = ((logits - ref).pow(2).mean().sqrt() / ref.pow(2).mean().sqrt()).item()
    assert rel_rms <= 0.03


def _map(obj, fn):
    """``obj`` (a params or layers dataclass) with ``fn`` applied to every tensor."""
    import dataclasses

    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{f.name: _map(getattr(obj, f.name), fn)
                                           for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, tuple):
        return tuple(_map(o, fn) for o in obj)
    return obj


# --- The stacked W4A8 GEMV's routes and the pre-blocked dequant. Every
# route computes the same integers through the same epilogue, so each is
# bit-equal to the plain version and to the flat kernel. (K, N, bn, g):
# Llama-3-8B's qkv at the default panel, a 192-column panel (no power of
# two), 128-column panels, and a 20-column panel (4-byte copies).

_PB_MS = [1, 8, 17, 192, 256]
_PB_SHAPES = [(4096, 6144, 512, 128), (1024, 384, 192, 64), (2048, 1024, 128, 128),
              (1024, 40, 20, 64)]


def _flag_env(**flags):
    """os.environ with the serving flags (FF_2L_*, FF_FUSED_*) set to
    ``flags`` only."""
    import os
    from unittest import mock

    env = {k: v for k, v in os.environ.items() if not k.startswith(("FF_2L_", "FF_FUSED_"))}
    return mock.patch.dict(os.environ, {**env, **flags}, clear=True)


def _stacked_w4a8(gen, M, K, N, g, dev, L=3):
    w = _ri(gen, -128, 128, (L, K // 2, N), torch.int8, dev)
    mult = _ri(gen, 1, 16, (L, K // g, N), torch.int8, dev)
    mp = pack_mult_nibbles(mult).contiguous()
    s = torch.rand((L, N), generator=gen, device=dev) * 1e-2
    x_q, x_s = mm.quantize_rowwise(torch.randn((M, K), generator=gen, device=dev))
    return x_q, x_s, w, mult, mp, s


def _route_run(route, flags, x_q, x_s, w, mp, s, g, out_dtype):
    """Each layer's GEMV under ``flags``: the outputs, and the launches
    counted under ``route``."""
    before = _build.launch_counts[route]
    with _flag_env(**flags):
        outs = [mm.matmul_w4a8_2l_gemv_stacked(x_q, x_s, w, mp, s, layer, group_size=g,
                                               out_dtype=out_dtype) for layer in range(3)]
    return outs, _build.launch_counts[route] - before


def _plain_stacked(x_q, x_s, w, mult, s, layer, g, out_dtype):
    return mm.matmul_w4a8_2l_reference(x_q, x_s, w[layer], mult[layer], s[layer], None, g,
                                       out_dtype, paired=True)


@pytest.mark.parametrize("M", _PB_MS)
@pytest.mark.parametrize("K,N,bn,g", _PB_SHAPES)
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_preblocked_gemv_kernel_bit_equal(dev, M, K, N, bn, g, out_dtype):
    gen = _gen(dev, M + N + bn)
    x_q, x_s, w, mult, mp, s = _stacked_w4a8(gen, M, K, N, g, dev)
    w4 = mm.preblock_stacked(w, bn)
    outs, n = _route_run("w4a8_gemv_preblocked", {}, x_q, x_s, w4, mp, s, g, out_dtype)
    flat, n_flat = _route_run("w4a8_gemv_stacked", {}, x_q, x_s, w, mp, s, g, out_dtype)
    assert n == n_flat == 3
    for layer, (out, f) in enumerate(zip(outs, flat)):
        assert torch.equal(out, _plain_stacked(x_q, x_s, w, mult, s, layer, g, out_dtype))
        assert torch.equal(out, f)


def test_preblocked_gemv_rejects_a_panel_width_not_a_multiple_of_4(dev):
    gen = _gen(dev, 6)
    x_q, x_s, w, mult, mp, s = _stacked_w4a8(gen, 8, 256, 12, 64, dev)
    with pytest.raises(ValueError, match="bn=6"):
        mm.matmul_w4a8_2l_gemv_stacked(x_q, x_s, mm.preblock_stacked(w, 6), mp, s, 0,
                                       group_size=64)


@pytest.mark.parametrize("M", _PB_MS)
@pytest.mark.parametrize("K,N,bn,g", _PB_SHAPES + [
    # the TMA feed: 2 panels of 512 (fewer than nbuf 3 and 64), and
    # Llama-3-8B's down_proj at the default panel
    (4096, 1024, 512, 128), (14336, 4096, 512, 128)])
@pytest.mark.parametrize("nbuf", [2, 3, 64])
def test_manual_gemv_kernel_bit_equal(dev, M, K, N, bn, g, nbuf):
    # nbuf 64: above the stages of every block's K range (the ring's depth
    # is cut to them)
    gen = _gen(dev, M + N + nbuf)
    x_q, x_s, w, mult, mp, s = _stacked_w4a8(gen, M, K, N, g, dev)
    w4 = mm.preblock_stacked(w, bn)
    plan = mm.mma_plan(M, K, N, g, "paired")
    depth = mm.manual_depth(plan, nbuf)
    assert 1 <= depth <= min(nbuf, plan.stages)
    outs, n = _route_run("w4a8_gemv_manual", {"FF_2L_MANUAL": str(nbuf)}, x_q, x_s, w4, mp, s,
                         g, torch.bfloat16)
    assert n == 3
    for layer, out in enumerate(outs):
        assert torch.equal(out, _plain_stacked(x_q, x_s, w, mult, s, layer, g, torch.bfloat16))


@pytest.mark.parametrize("M", _PB_MS)
@pytest.mark.parametrize("K,N,g,route", [
    (512, 384, 128, "w4a8_gemv_splitw"),       # 4 groups
    (14336, 4096, 128, "w4a8_gemv_splitw"),    # 112 groups: Llama-3-8B's down_proj
    (768, 256, 128, "w4a8_gemv_stacked"),      # 6 groups: the flat kernel, as in JAX
])
def test_splitw_gemv_kernel_bit_equal(dev, M, K, N, g, route):
    gen = _gen(dev, M + K)
    x_q, x_s, w, mult, mp, s = _stacked_w4a8(gen, M, K, N, g, dev)
    outs, n = _route_run(route, {"FF_2L_SPLITW": "1"}, x_q, x_s, w, mp, s, g, torch.bfloat16)
    assert n == 3
    for layer, out in enumerate(outs):
        assert torch.equal(out, _plain_stacked(x_q, x_s, w, mult, s, layer, g, torch.bfloat16))


@pytest.mark.parametrize("K,N,bn,g", _PB_SHAPES)
def test_preblocked_dequant_kernel_bit_equal(dev, K, N, bn, g):
    gen = _gen(dev, K + bn)
    L = 3
    w = _ri(gen, -128, 128, (L, K // 2, N), torch.int8, dev)
    mult = _ri(gen, 1, 16, (L, K // g, N), torch.int8, dev)
    s = torch.rand((L, N), generator=gen, device=dev) * 1e-2
    w4 = mm.preblock_stacked(w, bn)
    before = _build.launch_counts["dequant_paired_preblocked"]
    for layer in range(L):
        out = mm.dequantize_int4_paired_stacked(w4, mult, s, layer, group_size=g)
        ref = mm.dequantize_int4_paired_reference(w[layer], mult[layer].float() * s[layer][None, :],
                                                  g)
        assert torch.equal(out, ref)
        assert torch.equal(out, mm.dequantize_int4_paired_stacked(w, mult, s, layer, group_size=g))
    assert _build.launch_counts["dequant_paired_preblocked"] == before + L


@pytest.mark.parametrize("B,flags,counts", [
    (4, {"FF_2L_PREBLOCK": "1", "FF_2L_BLOCK_N": "128"}, {"w4a8_gemv_preblocked": 8}),
    (4, {"FF_2L_PREBLOCK": "1", "FF_2L_BLOCK_N": "128", "FF_2L_MANUAL": "4"},
     {"w4a8_gemv_manual": 8}),
    (72, {"FF_2L_SPLITW": "1"}, {"w4a8_gemv_splitw": 8}),
    (4, {"FF_2L_PREBLOCK": "1", "FF_2L_BLOCK_N": "128", "FF_2L_DOTRAW": "1"},
     {"w4a8_gemv_dotraw": 8}),
    (72, {"FF_2L_CONCAT_PAIRS": "3"}, {"w4a8_gemv_concat": 8}),
    (72, {"FF_2L_DOTRAW": "1", "FF_2L_CONCAT_PAIRS": "4"}, {"w4a8_gemv_dotraw": 8}),
])
def test_stacked_gemv_routes_decode_step(dev, B, flags, counts):
    """One w4a8_2l decode step of a narrow model fused under the flags:
    every projection through the route's kernel (pre-blocked weights bypass
    the fused tail at 4 rows), and the same logits as the flat layers."""
    from fastforward_tpu_torch.models.llama import LlamaConfig
    from fastforward_tpu_torch.serving import stacked as stk

    config = LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=2,
                         num_heads=2, num_kv_heads=1, head_dim=128)
    params, layers = stk.random_stacked_params(config, mode="w4a8_2l", group_size=64, seed=4,
                                               device=dev)
    flat = stk.fuse_stacked_layers(layers)
    gen = _gen(dev, 17)
    cache = stk.StackedKVCache.create(2, B, 64, 1, 128, device=dev)
    for t in (cache.k, cache.v):
        t.copy_(_ri(gen, -128, 128, t.shape, torch.int8, dev))
    for t in (cache.k_scale, cache.v_scale):
        t.copy_(torch.rand(t.shape, generator=gen, device=dev) * 0.05)
    cache.length = 40
    copy = stk.StackedKVCache(*[t.clone() for t in (cache.k, cache.v, cache.k_scale,
                                                    cache.v_scale)], length=40)
    tokens = _ri(gen, 0, 512, (B, 1), torch.int64, dev)
    with _flag_env(**flags):
        fused = stk.fuse_stacked_layers(layers)
        before = dict(_build.launch_counts)
        logits, _ = stk.serving_forward_stacked(params, fused, config, tokens, cache)
    got = {k: v - before.get(k, 0) for k, v in _build.launch_counts.items()
           if k.startswith(("w4a8_gemv_", "fused_")) and v != before.get(k, 0)}
    assert got == counts
    with _flag_env(FF_FUSED_LAYER="0"):  # the flat layers through the flat GEMV
        ref, _ = stk.serving_forward_stacked(params, flat, config, tokens, copy)
    assert torch.equal(logits, ref)


@pytest.mark.parametrize("M", _PB_MS)
@pytest.mark.parametrize("K,N,bn,g", _PB_SHAPES + [(14336, 4096, None, 128), (768, 260, None, 64)])
def test_dotraw_gemv_kernel_bit_equal(dev, M, K, N, bn, g):
    gen = _gen(dev, M + K + N)
    x_q, x_s, w, mult, mp, s = _stacked_w4a8(gen, M, K, N, g, dev)
    wt = w if bn is None else mm.preblock_stacked(w, bn)
    outs, n = _route_run("w4a8_gemv_dotraw", {"FF_2L_DOTRAW": "1"}, x_q, x_s, wt, mp, s, g,
                         torch.bfloat16)
    assert n == 3
    for layer, out in enumerate(outs):
        assert torch.equal(out, _plain_stacked(x_q, x_s, w, mult, s, layer, g, torch.bfloat16))


@pytest.mark.parametrize("M", _PB_MS)
@pytest.mark.parametrize("K,N,bn,g,cp", [
    (14336, 4096, None, 128, 3),    # 56 pairs: units of 3, the last of 2
    (14336, 4096, 512, 128, 4),     # Llama-3-8B's down_proj, (q)'s count
    (4096, 6144, 192, 128, 5),      # 16 pairs: the last unit of 1
    (768, 384, None, 128, 2),       # 3 pairs: the pair JAX's body drops
    (1024, 40, 20, 64, 64),         # one unit of every pair
])
def test_concat_gemv_kernel_bit_equal(dev, M, K, N, bn, g, cp):
    gen = _gen(dev, M + K + cp)
    x_q, x_s, w, mult, mp, s = _stacked_w4a8(gen, M, K, N, g, dev)
    wt = w if bn is None else mm.preblock_stacked(w, bn)
    outs, n = _route_run("w4a8_gemv_concat", {"FF_2L_CONCAT_PAIRS": str(cp)}, x_q, x_s, wt, mp,
                         s, g, torch.float32)
    assert n == 3
    for layer, out in enumerate(outs):
        assert torch.equal(out, _plain_stacked(x_q, x_s, w, mult, s, layer, g, torch.float32))
        assert torch.equal(out, mm.matmul_w4a8_2l_concat_reference(
            x_q, x_s, w[layer], mult[layer], s[layer], cp, g, torch.float32))


@pytest.mark.parametrize("M", [1, 100, 300])
@pytest.mark.parametrize("K,N,g", [(4096, 6144, 128), (1024, 4100, 64), (256, 40, 32)])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_w4a16_tiled_kernel_within_tolerance(dev, M, K, N, g, out_dtype):
    gen = _gen(dev, M + K + N)
    w = _ri(gen, -128, 128, (K // 2, N), torch.int8, dev)
    s = torch.rand((K // g, N), generator=gen, device=dev) * 1e-2
    x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
    bias = torch.randn((N,), generator=gen, device=dev)
    before = _build.launch_counts["w4a16_gemm"]
    out = mm.matmul_w4a16_tiled(x, w, s, None, g, out_dtype)
    with_bias = mm.matmul_w4a16_tiled(x, w, s, bias, g, out_dtype)
    assert _build.launch_counts["w4a16_gemm"] == before + 2
    # held as the W4 GEMV: within W4_GEMV_RTOL of the largest f32 output,
    # one bf16 ulp more for bf16 outputs
    ref32 = mm.matmul_w4a16_tiled_reference(x, w, s, None, g, torch.float32)
    tol = W4_GEMV_RTOL * ref32.abs().max()
    if out_dtype == torch.bfloat16:
        tol = tol + _bf16_ulp(ref32)
    assert out.dtype == out_dtype and ((out.float() - ref32).abs() <= tol).all()
    # the bias epilogue adds in f32 to the rounded output and rounds again
    assert torch.equal(with_bias, (out.float() + bias).to(out_dtype))


def _w4a16_tiled_case(dev, M, K, N, g, out_dtype, seed):
    # the wgmma kernel with and without a bias: within W4_GEMV_RTOL of the
    # largest f32 output (one bf16 ulp more in bf16), the bias epilogue exact
    gen = _gen(dev, seed)
    w = _ri(gen, -128, 128, (K // 2, N), torch.int8, dev)
    s = torch.rand((K // g, N), generator=gen, device=dev) * (0.5 / K ** 0.5) + 1e-4
    x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
    bias = torch.randn((N,), generator=gen, device=dev)
    before = _build.launch_counts["w4a16_gemm"]
    out = mm.matmul_w4a16_tiled(x, w, s, None, g, out_dtype)
    with_bias = mm.matmul_w4a16_tiled(x, w, s, bias, g, out_dtype)
    assert _build.launch_counts["w4a16_gemm"] == before + 2
    ref32 = mm.matmul_w4a16_tiled_reference(x, w, s, None, g, torch.float32)
    tol = W4_GEMV_RTOL * ref32.abs().max()
    if out_dtype == torch.bfloat16:
        tol = tol + _bf16_ulp(ref32)
    assert out.dtype == out_dtype and ((out.float() - ref32).abs() <= tol).all()
    assert torch.equal(with_bias, (out.float() + bias).to(out_dtype))


@pytest.mark.parametrize("M", [1, 63, 64, 65, 127, 129, 300])
@pytest.mark.parametrize("N", [40, 136, 4100, 6144])
@pytest.mark.parametrize("g", [32, 64, 128])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_w4a16_wgmma_kernel_edges(dev, M, N, g, out_dtype):
    # row tiles of 128 cut at every edge, column blocks of 128 cut (N = 40,
    # 136, 4100), N % 16 != 0 (the cp.async feed: 40, 4100), K = 10 g: a
    # last stage of 64 k at g32 (K = 320)
    _w4a16_tiled_case(dev, M, 10 * g, N, g, out_dtype, M + N + g)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_w4a16_wgmma_kernel_prefill_shape(dev, out_dtype):
    _w4a16_tiled_case(dev, 2048, 4096, 6144, 128, out_dtype, 2048)


@pytest.mark.parametrize("a4,g,N", [(True, 512, 6144), (True, 512, 6148), (False, 128, 6144)])
@pytest.mark.parametrize("M", [1, 8, 64, 192, 256])
def test_fused_heads_bit_equal_at_the_decode_rows(dev, a4, g, N, M):
    # the A4 head (its product on the tensor-core tile: N = 6148 takes the
    # tile's cp.async feed) and the W4A8 head (the same tile, paired) at
    # Llama-3-8B's K: output, hq and its scale bit-equal to the plain
    # version, each call counted once
    K = 4096
    x, norm, w, mp, s = _head_case(dev, M, K, N, g, M + N + g)
    name = "fused_norm_qkv_a4" if a4 else "fused_norm_qkv"
    quant = mm.quantize_rowwise_a4 if a4 else mm.quantize_rowwise
    before = _build.launch_counts[name]
    out, hq, hs = mm._fused_head_launch(a4, x, norm, w, mp, s, 1, g, 1e-5, torch.bfloat16)
    assert _build.launch_counts[name] == before + 1
    rq, rs = mm._norm_quant(x, norm[1], 1e-5, quant)
    assert torch.equal(hq, rq) and torch.equal(hs, rs)
    fn = mm.fused_norm_qkv_stacked_a4 if a4 else mm.fused_norm_qkv_stacked
    ref = fn(x.cpu(), norm.cpu(), w.cpu(), mp.cpu(), s.cpu(), 1, group_size=g)
    assert out.dtype == torch.bfloat16 and torch.equal(out.cpu(), ref)


def test_w4a16_tiled_rejects_what_the_kernel_does_not_take(dev):
    gen = _gen(dev, 9)
    w = _ri(gen, -128, 128, (128, 64), torch.int8, dev)
    s = torch.rand((2, 64), generator=gen, device=dev)
    x = torch.randn((4, 256), generator=gen, device=dev).to(torch.bfloat16)
    with pytest.raises(ValueError, match="even group"):  # an odd group: no reference takes it
        mm.matmul_w4a16_tiled(x[:, :192], w[:96], torch.rand((64, 64), device=dev), None, 3)
    with pytest.raises(ValueError, match="f32 or bf16"):
        mm.matmul_w4a16_tiled(x, w, s, None, 128, torch.float16)
    with pytest.raises(ValueError, match="CUDA"):
        mm.matmul_w4a16_tiled(x, w.cpu(), s, None, 128)


@pytest.mark.parametrize("inst,int4", [("dp4a", False), ("mma_s8", False), ("mma_s8", True),
                                       ("mma_s4", True), ("mma_bf16", False), ("dp4a", True),
                                       ("mma_bf16", True)])
@pytest.mark.parametrize("copies,bm,k,panels,rounds", [(1, 192, 512, 6, 16), (3, 80, 256, 2, 5),
                                                       (2, 16, 64, 1, 0)])
def test_probe_kernel_bit_equal(dev, inst, int4, copies, bm, k, panels, rounds):
    from fastforward_tpu_torch.scripts import probe_int4 as pr

    knobs = pr.Knobs(bm=bm, k=k, n=k, panels=panels, rounds=rounds)
    x, w = pr.inputs(knobs, copies, dev, seed=copies + bm)
    before = _build.launch_counts[f"probe_{inst}"]
    out = pr.make_probe(int4, inst, rounds)(x, w)
    assert _build.launch_counts[f"probe_{inst}"] == before + 1
    assert out.shape == x.shape and out.dtype == torch.int8
    assert torch.equal(out, pr.probe_reference(x, w, int4, rounds))


def test_probe_rejects_what_the_kernels_do_not_take(dev):
    from fastforward_tpu_torch.scripts import probe_int4 as pr

    x, w = pr.inputs(pr.Knobs(bm=16, k=1024, n=1024, panels=2), 1, dev)
    with pytest.raises(ValueError, match="mma_s4"):
        pr.make_probe(False, "mma_s4", 2)(x, w)
    with pytest.raises(ValueError, match="2\\*\\*24"):
        pr.make_probe(False, "mma_bf16", 2)(x, pr.inputs(pr.Knobs(bm=16, k=1024, n=1024,
                                                                  panels=9), 1, dev)[1])
    with pytest.raises(ValueError, match="K % 64"):
        xs, ws = pr.inputs(pr.Knobs(bm=16, k=96, n=96, panels=1), 1, dev)
        pr.make_probe(False, "mma_s8", 1)(xs, ws)


# --- row 9's routes on the int8 tensor-core tile at the 8B widths, and row
# 3's chunked flash decode at the chunk and page edges

_R9_SHAPES = [(4096, 1024), (4096, 4096), (4096, 6144), (4096, 28672), (14336, 4096)]
# (launch count, flags, panel width or None for flat weights); 16 pairs at
# K 4096 (3 does not divide them), 56 at K 14336 (3 does not divide them)
_R9_ROUTES = [
    ("w4a8_gemv_stacked", {}, None),
    ("w4a8_gemv_preblocked", {}, 128),
    ("w4a8_gemv_preblocked", {}, 512),
    ("w4a8_gemv_splitw", {"FF_2L_SPLITW": "1"}, None),
    ("w4a8_gemv_dotraw", {"FF_2L_DOTRAW": "1"}, None),
    ("w4a8_gemv_dotraw", {"FF_2L_DOTRAW": "1"}, 512),
    ("w4a8_gemv_concat", {"FF_2L_CONCAT_PAIRS": "2"}, None),
    ("w4a8_gemv_concat", {"FF_2L_CONCAT_PAIRS": "3"}, 128),
    ("w4a8_gemv_concat", {"FF_2L_CONCAT_PAIRS": "4"}, 512),
]
_R9_CASES = {}


def _r9_case(dev, K, N, M):
    """Two stacked layers at (K, N), g128, their pre-blocked forms, M rows
    of activations and each layer's plain output (made once a shape)."""
    key = (K, N, M)
    if key not in _R9_CASES:
        _R9_CASES.clear()
        gen = _gen(dev, K + N + M)
        x_q, x_s, w, mult, mp, s = _stacked_w4a8(gen, M, K, N, 128, dev, L=2)
        pre = {bn: mm.preblock_stacked(w, bn) for bn in (128, 512)}
        refs = [_plain_stacked(x_q, x_s, w, mult, s, layer, 128, torch.bfloat16)
                for layer in (0, 1)]
        _R9_CASES[key] = (x_q, x_s, w, pre, mp, s, refs)
    return _R9_CASES[key]


@pytest.mark.parametrize("name,flags,bn", _R9_ROUTES,
                         ids=[f"{r[0]}-{r[1]}-{r[2]}" for r in _R9_ROUTES])
@pytest.mark.parametrize("M", _PB_MS)
@pytest.mark.parametrize("K,N", _R9_SHAPES)
def test_stacked_gemv_route_on_the_tile_bit_equal(dev, K, N, M, name, flags, bn):
    x_q, x_s, w, pre, mp, s, refs = _r9_case(dev, K, N, M)
    wt = w if bn is None else pre[bn]
    for layer, ref in zip((0, 1), refs):  # layers 0 and L - 1
        before = _build.launch_counts[name]
        with _flag_env(**flags):
            out = mm.matmul_w4a8_2l_gemv_stacked(x_q, x_s, wt, mp, s, layer, group_size=128)
        assert _build.launch_counts[name] == before + 1
        assert torch.equal(out, ref)


_FD_CHUNK = 64  # tokens a chunk of csrc/flash_decode.cu


def _decode_case(dev, B, Hkv, G, S, seed, L=2):
    gen = _gen(dev, seed)
    k = _ri(gen, -128, 128, (L, B, Hkv, S, 128), torch.int8, dev)
    v = _ri(gen, -128, 128, (L, B, Hkv, S, 128), torch.int8, dev)
    ks = torch.rand((L, B, Hkv, S), generator=gen, device=dev) * 0.05
    vs = torch.rand((L, B, Hkv, S), generator=gen, device=dev) * 0.05
    q = torch.randn((B, Hkv * G, 128), generator=gen, device=dev).to(torch.bfloat16)
    return q, k, ks, v, vs


@pytest.mark.parametrize("G", [1, 2, 4, 8])
def test_flash_decode_chunk_edges(dev, G):
    # lengths 0 (zeros, as the kernel has always given), 1, a chunk +- 1,
    # 256 +- 1, the slab and past it; the per-layer form gives the same bits
    S = 512
    lengths = torch.tensor([0, 1, _FD_CHUNK - 1, _FD_CHUNK, _FD_CHUNK + 1, 255, 256, 257, S,
                            S + 40], dtype=torch.int32, device=dev)
    B, Hkv = lengths.numel(), 2
    q, k, ks, v, vs = _decode_case(dev, B, Hkv, G, S, seed=70 + G)
    before = _build.launch_counts["flash_decode"]
    out = att.flash_decode_int8_stacked(q, k, ks, v, vs, lengths, 1)
    assert _build.launch_counts["flash_decode"] == before + 1
    ref = att.flash_decode_int8_reference(q, k[1], ks[1], v[1], vs[1], lengths)
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    err = (out[1:].float() - ref[1:].float()).abs().max().item()
    assert err <= 8e-3 * ref[1:].float().abs().max().item()
    layer = att._flash_decode(q, k[1:2].contiguous(), ks[1:2].contiguous(), v[1:2].contiguous(),
                              vs[1:2].contiguous(), lengths, 0, None, "flash_decode_layer")
    assert torch.equal(out, layer)


@pytest.mark.parametrize("page", [32, 64, 96, 256])
@pytest.mark.parametrize("G", [1, 4, 8])
def test_paged_flash_decode_chunk_edges_give_the_slab_bits(dev, page, G):
    # every chunk and page edge: the paged form within rtol 8e-3 of its
    # plain version and equal to the slab form's bits over the same tokens
    # (chunks of 64 need no page that 64 divides)
    MP, Hkv = 4, 2
    lens = [0, 1, _FD_CHUNK - 1, _FD_CHUNK, _FD_CHUNK + 1, page - 1, page, page + 1,
            MP * page, MP * page + 9]
    B = len(lens)
    P = B * MP + 1
    gen = _gen(dev, page + G)
    k = _ri(gen, -128, 128, (2, P, Hkv, page, 128), torch.int8, dev)
    v = _ri(gen, -128, 128, (2, P, Hkv, page, 128), torch.int8, dev)
    ks = torch.rand((2, P, Hkv, page), generator=gen, device=dev) * 0.05
    vs = torch.rand((2, P, Hkv, page), generator=gen, device=dev) * 0.05
    table = (torch.randperm(P - 1, generator=torch.Generator().manual_seed(page))[:B * MP] + 1)
    table = table.reshape(B, MP).to(torch.int32).to(dev)
    table[1, 2:] = -1
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    q = torch.randn((B, Hkv * G, 128), generator=gen, device=dev).to(torch.bfloat16)
    out = pa.paged_flash_decode_int8(q, k, ks, v, vs, table, lengths, 1)
    ref = pa.paged_flash_decode_reference(q, k[1], ks[1], v[1], vs[1], table, lengths)
    live = lengths > 0
    assert torch.equal(out[~live], torch.zeros_like(out[~live]))
    err = (out[live].float() - ref[live].float()).abs().max().item()
    assert err <= 8e-3 * ref[live].float().abs().max().item()

    def slab(pool):
        return torch.stack([pa.gather_pages(pool[1], t) for t in table])[None].contiguous()
    same = att.flash_decode_int8_stacked(q, slab(k), slab(ks), slab(v), slab(vs), lengths, 0)
    assert torch.equal(out, same)


def test_flash_decode_rejects_unaligned_kv(dev):
    q, k, ks, v, vs = _decode_case(dev, 2, 2, 4, 64, seed=5)
    lengths = torch.tensor([3, 64], dtype=torch.int32, device=dev)
    shifted = torch.empty(k.numel() + 8, dtype=torch.int8, device=dev)[8:].view(k.shape)
    shifted.copy_(k)
    with pytest.raises(ValueError, match="16-byte"):
        att.flash_decode_int8_stacked(q, shifted, ks, v, vs, lengths, 1)


# --- the wgmma W4 GEMV (row 17) and the W4A8 head on the tensor-core tile
# (row 13)


@pytest.mark.parametrize("M", [1, 8, 63, 65, 192, 256])
@pytest.mark.parametrize("K,N,g", [(4096, 6144, 128), (4096, 4100, 128), (14336, 4096, 128),
                                   (1024, 136, 64), (320, 40, 32)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("split", [None, 1, 8])
def test_w4_gemv_wgmma_kernel_within_tolerance(dev, monkeypatch, M, K, N, g, out_dtype, split):
    # token tiles of 8 and sub-tiles of 64 cut at every edge, N % 16 != 0
    # (the cp.async feed: 4100, 40), column blocks of 128 cut (136, 40),
    # K = 10 g at g32 (a last stage of 64 k); the plan's split, one split
    # and the most the cluster takes: within W4_GEMV_RTOL (bf16 one ulp
    # more) of the plain version, the same bits call to call, each call
    # counted once
    plan = mm.w4_plan(M, K, N, g, split)
    monkeypatch.setattr(mm, "w4_plan", lambda *a: plan)
    gen = _gen(dev, M + K + N + g)
    w, s = _w4(gen, K, N, g, dev)
    x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
    before = _build.launch_counts["w4_gemv"]
    out = mm.matmul_w4_gemv(x, w, s, g, out_dtype)
    again = mm.matmul_w4_gemv(x, w, s, g, out_dtype)
    assert _build.launch_counts["w4_gemv"] == before + 2
    assert out.dtype == out_dtype and torch.equal(out, again)
    ref32 = mm.matmul_w4_gemv_reference(x, w, s, g, torch.float32)
    tol = W4_GEMV_RTOL * ref32.abs().max()
    if out_dtype == torch.bfloat16:
        tol = tol + _bf16_ulp(ref32)
    assert ((out.float() - ref32).abs() <= tol).all()


def test_w4_gemv_rejects_more_than_the_gemv_rows(dev):
    gen = _gen(dev, 257)
    w, s = _w4(gen, 256, 64, 128, dev)
    x = torch.randn((257, 256), generator=gen, device=dev).to(torch.bfloat16)
    with pytest.raises(ValueError, match="M <= 256"):
        mm.matmul_w4_gemv(x, w, s, 128)


@pytest.mark.parametrize("a4", [False, True])
@pytest.mark.parametrize("M", range(1, 257))
def test_fused_heads_on_the_tile_bit_equal_at_every_decode_row(dev, a4, M):
    # both heads' prologues stage the tile's operand themselves (no staging
    # launch): output, hq and its scale bit-equal to the plain version at
    # Llama-3-8B's widths (W4A8 g128, A4 g512), each call counted once
    K, N, g = 4096, 6144, 512 if a4 else 128
    x, norm, w, mp, s = _head_case(dev, M, K, N, g, 7 * M + a4)
    name = "fused_norm_qkv_a4" if a4 else "fused_norm_qkv"
    quant = mm.quantize_rowwise_a4 if a4 else mm.quantize_rowwise
    before = _build.launch_counts[name]
    out, hq, hs = mm._fused_head_launch(a4, x, norm, w, mp, s, 1, g, 1e-5, torch.float32)
    assert _build.launch_counts[name] == before + 1
    rq, rs = mm._norm_quant(x, norm[1], 1e-5, quant)
    assert torch.equal(hq, rq) and torch.equal(hs, rs)
    ref = (mm.fused_norm_qkv_a4_reference if a4 else mm.fused_norm_qkv_reference)(
        x.float(), norm[1], w[1], unpack_mult_nibbles(mp[1], K // g), s[1], g)
    assert out.dtype == torch.float32 and torch.equal(out, ref)


# --- rows 19 and 16 on int8 wgmma (csrc/int8_wgmma.cuh): every token-tile
# edge of the W8A8 GEMM (decode tiles of 8-192, two row tiles of 128 at M =
# 193-256, prefill tiles of 192 with a ragged last one), with and without a
# bias, ragged K (80: a 128-k stage cut), N % 16 != 0 (the 4-byte weight
# feed, an odd count of column tiles); the W4A8 GEMV at every edge of its
# row blocks at g 32, 64 and 128 (chain, window splits, every window in one
# block); each K split count and row-block count forced; two calls
# bit-identical, each call counted once

_I8_EDGES = [1, 8, 9, 16, 17, 32, 33, 48, 49, 64, 65, 96, 97, 128, 129, 192, 193, 255, 256]


@pytest.mark.parametrize("M", _I8_EDGES + [257, 385, 1000])
@pytest.mark.parametrize("K,N", [(4096, 6144), (1024, 4100), (80, 136)])
@pytest.mark.parametrize("bias", [False, True])
def test_w8a8_wgmma_kernel_edges(dev, M, K, N, bias):
    gen = _gen(dev, 3 * M + K + N + bias)
    w = _ri(gen, -127, 128, (K, N), torch.int8, dev)
    ws = torch.rand((N,), generator=gen, device=dev) * 1e-3
    b = torch.randn((N,), generator=gen, device=dev) if bias else None
    x_q, x_s = mm.quantize_rowwise(torch.randn((M, K), generator=gen, device=dev))
    for out_dtype in (torch.float32, torch.bfloat16):
        before = _build.launch_counts["w8a8_gemm"]
        out = mm.matmul_w8a8(x_q, x_s, w, ws, b, out_dtype)
        again = mm.matmul_w8a8(x_q, x_s, w, ws, b, out_dtype)
        assert _build.launch_counts["w8a8_gemm"] == before + 2
        assert torch.equal(out, again)
        assert torch.equal(out, mm.matmul_w8a8_reference(x_q, x_s, w, ws, b, out_dtype))


@pytest.mark.parametrize("M", [8, 192, 256])
@pytest.mark.parametrize("split", range(1, 9))
def test_w8a8_wgmma_kernel_every_split(dev, monkeypatch, M, split):
    # K = 4,096: 32 stages over 1-8 blocks of a cluster, the int32 partials
    # added through distributed shared memory; N = 4,100 (33 column tiles)
    K, N = 4096, 4100
    plan = mm.w8a8_plan(M, K, N, split)
    assert plan.n_split == split
    monkeypatch.setattr(mm, "w8a8_plan", lambda *a: plan)
    gen = _gen(dev, 11 * M + split)
    w = _ri(gen, -127, 128, (K, N), torch.int8, dev)
    ws = torch.rand((N,), generator=gen, device=dev) * 1e-3
    bias = torch.randn((N,), generator=gen, device=dev)
    x_q, x_s = mm.quantize_rowwise(torch.randn((M, K), generator=gen, device=dev))
    out = mm.matmul_w8a8(x_q, x_s, w, ws, bias, torch.float32)
    assert torch.equal(out, mm.matmul_w8a8(x_q, x_s, w, ws, bias, torch.float32))
    assert torch.equal(out, mm.matmul_w8a8_reference(x_q, x_s, w, ws, bias, torch.float32))


@pytest.mark.parametrize("M", _I8_EDGES)
@pytest.mark.parametrize("K,N,g", [(4096, 4100, 128), (14336, 260, 128), (1056, 132, 32),
                                   (2560, 136, 64), (8448, 256, 32)])
def test_w4a8_wgmma_kernel_edges(dev, M, K, N, g):
    gen = _gen(dev, 5 * M + K + N + g)
    w, s = _w4(gen, K, N, g, dev)
    x_q, x_s = mm.quantize_rowwise(torch.randn((M, K), generator=gen, device=dev))
    for out_dtype in (torch.float32, torch.bfloat16):
        before = _build.launch_counts["w4a8_gemv_halves"]
        out = mm.matmul_w4a8_gemv(x_q, x_s, w, s, g, out_dtype)
        again = mm.matmul_w4a8_gemv(x_q, x_s, w, s, g, out_dtype)
        assert _build.launch_counts["w4a8_gemv_halves"] == before + 2
        assert torch.equal(out, again)
        assert torch.equal(out, mm.matmul_w4a8_reference(x_q, x_s, w, s, None, g, out_dtype))


def _row_splits():
    """(M, row blocks, K, g) where the row blocks hold M's rows: at most 96
    a block (64 where one block walks every window: K = 8,448 at g32), no
    row block empty."""
    cases = []
    for K, g, most in ((4096, 128, 96), (14336, 128, 96), (8448, 32, 64)):
        for M in (17, 96, 192, 256):
            for rb in (1, 2, 3, 4, 6):
                rows = -(-M // rb)
                if rows <= most and (rb - 1) * rows < M:
                    cases.append((M, rb, K, g))
    return cases


@pytest.mark.parametrize("M,row_blocks,K,g", _row_splits())
def test_w4a8_wgmma_kernel_every_row_block(dev, monkeypatch, M, row_blocks, K, g):
    # the token rows split over 1-6 row blocks
    base = mm.w4a8_plan(M, K, 4096, g)
    rows = -(-M // row_blocks)
    n = mm.i8_tile(rows)
    plan = base._replace(n=n, rows=rows, row_blocks=row_blocks, per_sm=2 if n <= 32 else 1,
                         depth=min(base.depth, 4))
    monkeypatch.setattr(mm, "w4a8_plan", lambda *a: plan)
    gen = _gen(dev, 13 * M + row_blocks + K)
    w, s = _w4(gen, K, 4096, g, dev)
    x_q, x_s = mm.quantize_rowwise(torch.randn((M, K), generator=gen, device=dev))
    out = mm.matmul_w4a8_gemv(x_q, x_s, w, s, g, torch.float32)
    assert torch.equal(out, mm.matmul_w4a8_reference(x_q, x_s, w, s, None, g, torch.float32))


# --- the any-group route of the two-level GEMVs (csrc/w4a8_mma.cuh
# w4a8_rows_kernel): every group from 1 to 14 the reference takes, N % 4 !=
# 0 and panel widths that are no multiple of 4, bit-equal, at M = 1, 8, 17,
# 192, 256; and 1,024 groups of 14 along K

_ANY_M = [1, 8, 17, 192, 256]


def _route_name(base, layout, K, N, g):
    return base + ("_any" if mm.two_level_route(layout, K, N, g) == "any" else "")


@pytest.mark.parametrize("M", _ANY_M)
@pytest.mark.parametrize("g", range(1, 15))
def test_a4_gemv_every_group_bit_equal(dev, M, g):
    K, N = 2 * g * 9, 132 if g % 2 else 130  # N % 4 != 0 takes the any-group route too
    gen = _gen(dev, M * 100 + g)
    x_q, x_s = mm.quantize_rowwise_a4(torch.randn((M, K), generator=gen, device=dev))
    w = _ri(gen, -128, 128, (2, K // 2, N), torch.int8, dev)
    mult = _ri(gen, 1, 16, (2, K // g, N), torch.int8, dev)
    s = torch.rand((2, N), generator=gen, device=dev) * 1e-2
    name = _route_name("a4_gemv", "vertical", K, N, g)
    for out_dtype in (torch.float32, torch.bfloat16):
        before = _build.launch_counts[name]
        out = mm.matmul_w4a4_2l_gemv_stacked(x_q, x_s, w, pack_mult_nibbles(mult).contiguous(),
                                             s, 1, group_size=g, out_dtype=out_dtype)
        assert _build.launch_counts[name] == before + 1
        ref = mm.matmul_w4a4_2l_reference(x_q, x_s, w[1], mult[1], s[1], None, g, out_dtype)
        assert torch.equal(out, ref)


@pytest.mark.parametrize("M", _ANY_M)
@pytest.mark.parametrize("paired,g", [(True, g) for g in range(1, 15) if g % 4]
                         + [(False, g) for g in range(2, 15, 2) if g % 8])
def test_w4a8_gemv_every_group_bit_equal(dev, M, paired, g):
    # row 5 (f32 and bf16) and row 4 (the argmax of row 5's f32 logits)
    K, N = 2 * g * 9, 260
    gen = _gen(dev, M * 100 + g + paired)
    x_q, x_s = mm.quantize_rowwise(torch.randn((M, K), generator=gen, device=dev))
    w = _ri(gen, -128, 128, (K // 2, N), torch.int8, dev)
    m = _ri(gen, 1, 16, (K // g, N), torch.int8, dev)
    s = torch.rand((N,), generator=gen, device=dev) * 1e-2
    name = "w4a8_gemv_any" if paired else "w4a8_gemv_unpaired_any"
    for out_dtype in (torch.float32, torch.bfloat16):
        before = _build.launch_counts[name]
        out = mm.matmul_w4a8_2l_gemv(x_q, x_s, w, m, s, g, out_dtype, paired=paired)
        assert _build.launch_counts[name] == before + 1
        ref = mm.matmul_w4a8_2l_reference(x_q, x_s, w, m, s, None, g, out_dtype, paired=paired)
        assert torch.equal(out, ref)
    before, head = _build.launch_counts[name], _build.launch_counts["w4a8_gemv_argmax"]
    ids = mm.matmul_w4a8_2l_gemv_argmax(x_q, x_s, w, m, s, g, paired=paired)
    assert _build.launch_counts[name] == before + 1
    assert _build.launch_counts["w4a8_gemv_argmax"] == head
    logits = mm.matmul_w4a8_2l_reference(x_q, x_s, w, m, s, None, g, torch.float32, paired=paired)
    assert torch.equal(ids, torch.argmax(logits, dim=-1).to(torch.int32))


@pytest.mark.parametrize("M", _ANY_M)
@pytest.mark.parametrize("g", [g for g in range(1, 15) if g % 4])
@pytest.mark.parametrize("bn", [0, 4, 6, 132])
def test_stacked_gemv_every_group_bit_equal(dev, M, g, bn):
    # row 9 on flat (bn 0) and pre-blocked weights (bn 6: byte loads),
    # layer 1 of 2, under the default flags and the dot-raw flag: one route
    # whatever the flags
    K, N = 2 * g * 7, 264
    gen = _gen(dev, M * 100 + g + bn)
    x_q, x_s = mm.quantize_rowwise(torch.randn((M, K), generator=gen, device=dev))
    w = _ri(gen, -128, 128, (2, K // 2, N), torch.int8, dev)
    mult = _ri(gen, 1, 16, (2, K // g, N), torch.int8, dev)
    s = torch.rand((2, N), generator=gen, device=dev) * 1e-2
    wb = mm.preblock_stacked(w, bn) if bn else w
    ref = mm.matmul_w4a8_2l_reference(x_q, x_s, w[1], mult[1], s[1], None, g, paired=True)
    for flag in ("0", "1"):
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("FF_2L_DOTRAW", flag)
            before = _build.launch_counts["w4a8_gemv_stacked_any"]
            out = mm.matmul_w4a8_2l_gemv_stacked(x_q, x_s, wb, pack_mult_nibbles(mult).contiguous(),
                                                 s, 1, group_size=g)
            assert _build.launch_counts["w4a8_gemv_stacked_any"] == before + 1
        assert torch.equal(out, ref)


@pytest.mark.parametrize("M", _ANY_M)
def test_two_level_any_route_over_1024_groups(dev, M):
    # K 14336 in 1,024 groups of 14 (512 pairs): rows 1, 5 (both layouts) and 9
    K, N, g = 14336, 516, 14
    gen = _gen(dev, M + K)
    w = _ri(gen, -128, 128, (K // 2, N), torch.int8, dev)
    m = _ri(gen, 1, 16, (K // g, N), torch.int8, dev)
    s = torch.rand((N,), generator=gen, device=dev) * 1e-3
    x_q, x_s = mm.quantize_rowwise(torch.randn((M, K), generator=gen, device=dev))
    for paired in (True, False):
        out = mm.matmul_w4a8_2l_gemv(x_q, x_s, w, m, s, g, torch.float32, paired=paired)
        ref = mm.matmul_w4a8_2l_reference(x_q, x_s, w, m, s, None, g, torch.float32,
                                          paired=paired)
        assert torch.equal(out, ref)
    mp = pack_mult_nibbles(m)[None].contiguous()
    out = mm.matmul_w4a8_2l_gemv_stacked(x_q, x_s, w[None].contiguous(), mp, s[None], 0,
                                         group_size=g)
    assert torch.equal(out, mm.matmul_w4a8_2l_reference(x_q, x_s, w, m, s, None, g, paired=True))
    x4, x4s = mm.quantize_rowwise_a4(torch.randn((M, K), generator=gen, device=dev))
    out = mm.matmul_w4a4_2l_gemv_stacked(x4, x4s, w[None].contiguous(), mp, s[None], 0,
                                         group_size=g)
    assert torch.equal(out, mm.matmul_w4a4_2l_reference(x4, x4s, w, m, s, None, g))


def test_two_level_any_route_extreme_sums_exact(dev):
    # x = +-127, m = 15, u = 0 and 15 at g 6 over K = 14,328: the largest
    # int32 sums the grid allows, the splits' sums added in int64
    gen = _gen(dev, 14328)
    M, K, N, g = 9, 14328, 132, 6
    x_q = torch.where(_ri(gen, 0, 2, (M, K), torch.int8, dev) > 0, 127, -127).to(torch.int8)
    x_s = torch.rand((M,), generator=gen, device=dev) + 0.5
    w = torch.where(_ri(gen, 0, 2, (K // 2, N), torch.int8, dev) > 0, 0, -1).to(torch.int8)
    m = torch.full((K // g, N), 15, dtype=torch.int8, device=dev)
    s = torch.rand((N,), generator=gen, device=dev) * 1e-6
    out = mm.matmul_w4a8_2l_gemv(x_q, x_s, w, m, s, g, torch.float32, paired=True)
    assert torch.equal(out, mm.matmul_w4a8_2l_reference(x_q, x_s, w, m, s, None, g,
                                                         torch.float32, paired=True))


@pytest.mark.parametrize("a4,g", [(False, 2), (False, 6), (False, 10), (True, 2), (True, 6),
                                  (True, 12)])
@pytest.mark.parametrize("M", [1, 8, 64, 192])
def test_fused_head_any_group_bit_equal(dev, a4, g, M):
    # the prologue without staging, then the any-group route on hq
    K, N = 2 * g * 16, 132
    x, norm, w, mp, s = _head_case(dev, M, K, N, g, M + g)
    name = ("fused_norm_qkv_a4" if a4 else "fused_norm_qkv") + "_any"
    quant = mm.quantize_rowwise_a4 if a4 else mm.quantize_rowwise
    before = _build.launch_counts[name]
    out, hq, hs = mm._fused_head_launch(a4, x, norm, w, mp, s, 2, g, 1e-5, torch.bfloat16)
    assert _build.launch_counts[name] == before + 1
    rq, rs = mm._norm_quant(x, norm[2], 1e-5, quant)
    assert torch.equal(hq, rq) and torch.equal(hs, rs)
    fn = mm.fused_norm_qkv_stacked_a4 if a4 else mm.fused_norm_qkv_stacked
    ref = fn(x.cpu(), norm.cpu(), w.cpu(), mp.cpu(), s.cpu(), 2, group_size=g)
    assert torch.equal(out.cpu(), ref)


@pytest.mark.parametrize("M,K1,H,inter,g", [
    (1, 384, 384, 768, 2), (5, 384, 384, 768, 6), (33, 768, 384, 1152, 6),
    (64, 4104, 4104, 14364, 6), (8, 4096, 4096, 14336, 2),
])
def test_fused_tail_any_group(dev, M, K1, H, inter, g):
    # the tail and its o + gate/up head at groups the tile does not take:
    # the row kernels as on the tile, each product on the any-group route;
    # held as the tile's tail (x1 bit-equal, hq and x2 within one level in
    # a few elements, the outputs within rtol 8e-3)
    attn, x_res, norm, ops = _tail_case(dev, M, K1, H, inter, g, M + H + g)
    before = _build.launch_counts["fused_o_mlp_any"]
    out, x1, hq, hs, x2, gs, xf_gu, xf_dn = mm._fused_o_mlp_launch(attn, x_res, norm, *ops, 1, g,
                                                                   1e-5)
    assert _build.launch_counts["fused_o_mlp_any"] == before + 1 and xf_gu is None
    y, rx1, rhq, rhs, rx2, rgs = _tail_plain(attn, x_res, norm, ops, g)
    assert torch.equal(x1, rx1)
    for a, b in ((hq, rhq), (x2, rx2)):
        diff = (a.int() - b.int()).abs()
        assert diff.max().item() <= 1
        assert diff.count_nonzero().item() <= max(4, a.numel() // 1000)
    torch.testing.assert_close(hs, rhs, rtol=1e-6, atol=0)
    torch.testing.assert_close(gs, rgs, rtol=1e-6, atol=0)
    assert (out.float() - y).abs().max().item() <= 8e-3 * y.abs().max().item()
    before = _build.launch_counts["fused_o_gu_any"]
    gx1, gu, ghq, ghs, gxf = mm._fused_o_gu_launch(attn, x_res, norm, *ops[:6], 1, g, 1e-5)
    assert _build.launch_counts["fused_o_gu_any"] == before + 1 and gxf is None
    rx1, rgu, rhq, rhs = _ogu_plain(attn, x_res, norm, ops[:6], K1, H, g)
    assert torch.equal(gx1, rx1)
    diff = (ghq.int() - rhq.int()).abs()
    assert diff.max().item() <= 1 and diff.count_nonzero().item() <= max(4, ghq.numel() // 1000)
    err = (gu.float() - rgu.float()).abs().max().item()
    assert err <= 8e-3 * rgu.float().abs().max().item()


# --- the simulation tier's core and the sim-tier KV append (run (x)) --------


@pytest.mark.parametrize("tile,bits", [((256, 1), 8), ((64, 1), 4), ((1, 96), 4)])
def test_quantize_by_tile_on_the_card_matches_the_cpu(dev, tile, bits):
    from fastforward_tpu_torch.quantization import affine

    gen = _gen(dev, 61)
    x = torch.randn((256, 96), generator=gen, device=dev)
    n = (256 // tile[0]) * (96 // tile[1])
    s = torch.rand((n,), generator=gen, device=dev) * 0.05 + 0.01
    o = torch.randint(-2, 3, (n,), generator=gen, device=dev).float()
    g = torch.randn((256, 96), generator=gen, device=dev)

    def run(d, s, o, g):
        d, s, o = (t.clone().requires_grad_() for t in (d, s, o))
        q = affine.quantize_by_tile(d, s, o, tile_size=tile, num_bits=bits)
        y = affine.dequantize_by_tile(q, s, o, tile_size=tile)
        q.backward(g)
        return [t.detach().cpu() for t in (q, y, d.grad, s.grad, o.grad)]

    card, cpu = run(x, s, o, g), run(*(t.cpu() for t in (x, s, o, g)))
    for a, b in zip(card[:3], cpu[:3]):  # forwards and the data gradient bit-equal
        assert torch.equal(a, b)
    for a, b in zip(card[3:], cpu[3:]):  # per-tile sums in another order
        assert (a - b).abs().max() <= 1e-6 * b.abs().max()
    dyn = affine.quantize_dynamic_by_tile(x, tile_size=(1, 96))
    for a, b in zip(dyn, affine.quantize_dynamic_by_tile(x.cpu(), tile_size=(1, 96))):
        assert torch.equal(a.cpu(), b)


def test_sim_tier_kv_append_one_fused_launch_bit_equal(dev):
    from fastforward_tpu_torch import quantization as tq
    from fastforward_tpu_torch.kernels import reset_launch_counts
    from fastforward_tpu_torch.serving.kv_cache import LayerKVCache

    class Quantizer:
        is_stub = False

        def __call__(self, t):
            return tq.quantize_dynamically(t, tq.PerChannel((0, 1, 2)), num_bits=8,
                                           symmetric=True)

    gen = _gen(dev, 62)
    B, Hkv, S, D = 5, 2, 64, 128
    cache = LayerKVCache(*(_ri(gen, -127, 128, (B, Hkv, S, D), torch.int8, dev) for _ in range(2)),
                         *(torch.rand((B, Hkv, S), generator=gen, device=dev) for _ in range(2)))
    plain = LayerKVCache(*(t.cpu() for t in (cache.k, cache.v, cache.k_scale, cache.v_scale)))
    k, v = (torch.randn((B, Hkv, 1, D), generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2))
    pos = torch.tensor([[0], [63], [7], [31], [40]], dtype=torch.int32, device=dev)
    qz = Quantizer()
    qdq = [qz(t).dequantize().cpu() for t in (k, v)]
    reset_launch_counts()
    cache.append(k, v, pos, quantizer=qz)
    torch.cuda.synchronize()
    assert dict(_build.launch_counts) == {"kv_append_layer": 1}
    plain.append(*qdq, pos.cpu())
    for f in ("k", "v", "k_scale", "v_scale"):
        assert torch.equal(getattr(cache, f).cpu(), getattr(plain, f))


# --- ring attention and the pipeline, two ranks on the card (runs (v), (w)) --


def test_ring_attention_and_pipeline_two_ranks_on_the_card(dev):
    import numpy as np

    from fastforward_tpu_torch.serving.engine import QuantLinear, quantize_linear
    from tests import torch_dist

    gen = _gen(dev, 63)
    q, k, v = (torch.randn((1, 4, 256, 64), generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    qls = [quantize_linear(torch.randn((256, 256), generator=gen, device=dev) / 16, "w4a8_2l",
                           128) for _ in range(4)]
    layers = QuantLinear(torch.stack([q_.data for q_ in qls]),
                         torch.stack([q_.scale for q_ in qls]), "w4a8_2l", 128,
                         torch.stack([q_.mult for q_ in qls]), qls[0].paired)
    x = torch.randn((16, 256), generator=gen, device=dev)
    payload = dict(q=q.float().cpu().numpy(), k=k.float().cpu().numpy(),
                   v=v.float().cpu().numpy(), x=x.cpu().numpy(), microbatches=4,
                   layers=dict(data=layers.data.cpu().numpy(), scale=layers.scale.cpu().numpy(),
                               mult=layers.mult.cpu().numpy(), paired=layers.paired,
                               group_size=128))
    ranks = torch_dist.run(2, "parallel_cuda", payload)
    # ring attention: both ranks equal, within one bf16 ulp of dense attention
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / 8.0
    scores = torch.where(torch.ones((256, 256), dtype=torch.bool, device=dev).tril(), scores,
                         -1e30)
    dense = torch.matmul(torch.softmax(scores, -1).to(torch.bfloat16), v).float().cpu().numpy()
    for res in ranks:
        np.testing.assert_array_equal(res["ring"], ranks[0]["ring"])
        assert np.abs(res["ring"] - dense).max() <= 8e-3 * np.abs(dense).max()
    # the pipeline: bit-equal to the sequential loop, 2 layers x 4
    # microbatches of row-5 launches a rank
    h = x
    for ql in qls:
        h = ql(h, out_dtype=torch.float32)
    for res in ranks:
        np.testing.assert_array_equal(res["pipeline"], h.cpu().numpy())
        assert res["counts"] == {"w4a8_gemv": 8}


# --- the W8A8 dispatcher registration (kernels/dispatch.py) on a CUDA weight


def _int8_weight(dev, gen, N, K):
    from fastforward_tpu_torch import quantization as tq

    w = torch.randn((N, K), generator=gen, device=dev) / K ** 0.5
    return tq.quantize_per_channel(w, 0, w.abs().amax(dim=1) / 127, quantized_dtype=torch.int8)


@pytest.mark.parametrize("lead,K,N,dtype,bias", [
    ((8,), 4096, 1024, torch.bfloat16, False), ((192,), 1024, 520, torch.bfloat16, True),
    ((2, 3), 256, 132, torch.float32, False), ((17,), 14336, 256, torch.float32, True),
])
def test_w8a8_dispatch_launches_row_19_on_a_cuda_weight(dev, lead, K, N, dtype, bias):
    import torch.nn.functional as F

    import fastforward_tpu_torch.kernels  # noqa: F401  (the registration)
    from fastforward_tpu_torch import ops

    gen = _gen(dev, K + N)
    qt = _int8_weight(dev, gen, N, K)
    x = torch.randn((*lead, K), generator=gen, device=dev).to(dtype)
    b = torch.randn((N,), generator=gen, device=dev) if bias else None
    before = _build.launch_counts["w8a8_gemm"]
    out = ops.linear(x, qt, b)
    assert _build.launch_counts["w8a8_gemm"] == before + 1
    # the kernel against its plain version on the same operands, on the card
    x_q, x_s = mm.quantize_rowwise(x.reshape(-1, K))
    ref = mm.matmul_w8a8_reference(x_q, x_s, qt.raw_data.t().contiguous(),
                                   qt.quant_args().scale.float(), b,
                                   torch.bfloat16 if dtype == torch.bfloat16 else torch.float32)
    assert out.dtype == ref.dtype and torch.equal(out, ref.reshape(*lead, N))
    # torch's linear on the QuantizedTensor: the same call, one launch
    assert torch.equal(F.linear(x, qt, b), out)
    assert _build.launch_counts["w8a8_gemm"] == before + 2


def test_w8a8_dispatch_raises_where_row_19_refuses(dev):
    from fastforward_tpu_torch import ops

    gen = _gen(dev, 5)
    before = _build.launch_counts["w8a8_gemm"]
    # K % 16 != 0: the kernel's ValueError, no plain route
    with pytest.raises(ValueError, match="W8A8 GEMM kernel needs"):
        ops.linear(torch.randn((4, 40), device=dev), _int8_weight(dev, gen, 16, 40))
    # x on the CPU, the int8 weight on the card
    with pytest.raises(ValueError, match="x is on cpu"):
        ops.linear(torch.randn((4, 64)), _int8_weight(dev, gen, 16, 64))
    assert _build.launch_counts["w8a8_gemm"] == before
