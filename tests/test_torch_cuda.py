"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA GPU (built for sm_90a) and skips without
one. Run them on the card with

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest``: the shared conftest imports JAX, which the GPU host
need not have). Tolerances: the GEMVs, argmax ids, the dequant and the KV
appends (slab and paged) are bit-equal; flash decode (slab and paged) and
flash prefill are within one bf16 ulp of the largest output (rtol 8e-3),
and paged flash decode gives the slab kernel's bits over the same tokens.
The fused layer tail: x1 bit-equal, the int8 activations hq and x2 within
one level (the IEEE rsqrt and exp round unlike PyTorch's in a few rows),
the output within rtol 8e-3.
"""

import pytest
import torch

from fastforward_tpu_torch.kernels import _build
from fastforward_tpu_torch.kernels import attention as att
from fastforward_tpu_torch.kernels import kv_update as kvu
from fastforward_tpu_torch.kernels import matmul as mm
from fastforward_tpu_torch.kernels import paged_attention as pa
from fastforward_tpu_torch.kernels.packing import pack_mult_nibbles, unpack_mult_nibbles


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


@pytest.mark.parametrize("M,K,N,g", [(1, 256, 1004, 64), (8, 4096, 128256, 512), (20, 1024, 260, 128)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_w4a8_gemv_kernel_bit_equal(dev, M, K, N, g, out_dtype):
    gen = _gen(dev, M * N)
    w = _ri(gen, -128, 128, (K // 2, N), torch.int8, dev)
    m = _ri(gen, 1, 16, (K // g, N), torch.int8, dev)
    s = torch.rand((N,), generator=gen, device=dev) * 1e-2
    x_q, x_s = mm.quantize_rowwise(torch.randn((M, K), generator=gen, device=dev))
    out = mm.matmul_w4a8_2l_gemv(x_q, x_s, w, m, s, g, out_dtype, paired=True)
    ref = mm.matmul_w4a8_2l_reference(x_q, x_s, w, m, s, None, g, out_dtype, paired=True)
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


def test_w4a8_kernel_rejects_unpaired_layout(dev):
    x_q = torch.zeros((1, 256), dtype=torch.int8, device=dev)
    x_s = torch.ones((1,), device=dev)
    w = torch.zeros((128, 64), dtype=torch.int8, device=dev)
    m = torch.ones((2, 64), dtype=torch.int8, device=dev)
    with pytest.raises(NotImplementedError):
        mm.matmul_w4a8_2l_gemv(x_q, x_s, w, m, torch.ones(64, device=dev), 128, paired=False)


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
                                        (77, 300, (5, 0, 223)), (1, 64, (63, 0, 10))])
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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        att.flash_prefill(q, k.to(torch.bfloat16), None, k.to(torch.bfloat16), None, st)
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


@pytest.mark.parametrize("M,K1,H,inter,g", [
    (1, 4096, 4096, 14336, 128), (8, 4096, 4096, 14336, 128), (64, 4096, 4096, 14336, 128),
    (5, 512, 256, 384, 64), (33, 256, 256, 512, 32),
])
def test_fused_o_mlp_kernel(dev, M, K1, H, inter, g):
    attn, x_res, norm, ops = _tail_case(dev, M, K1, H, inter, g, M + H)
    before = _build.launch_counts["fused_o_mlp"]
    out, x1, hq, hs, x2, gs = mm._fused_o_mlp_launch(attn, x_res, norm, *ops, 1, g, 1e-5)
    assert _build.launch_counts["fused_o_mlp"] == before + 1
    layer_ops = mm._fused_o_mlp_layer(norm, *ops, 1, g)
    y, rx1, rhq, rhs, rx2, rgs = mm._fused_o_mlp_parts(attn.float(), x_res.float(), *layer_ops,
                                                       group_size=g)
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
    # the public wrapper returns the same output, and again the same bits
    again = mm.fused_o_mlp_stacked(attn, x_res, norm, *ops, 1, group_size=g)
    assert torch.equal(again, out)


def test_fused_o_mlp_kernel_after_other_shapes(dev):
    """The launch's cached grid and shared-memory attribute: a large tile,
    then a small one, then the large one again give the first bits."""
    big = _tail_case(dev, 64, 4096, 4096, 14336, 128, 7)
    small = _tail_case(dev, 5, 512, 256, 384, 64, 8)
    first = mm.fused_o_mlp_stacked(big[0], big[1], big[2], *big[3], 1, group_size=128)
    mm.fused_o_mlp_stacked(small[0], small[1], small[2], *small[3], 1, group_size=64)
    again = mm.fused_o_mlp_stacked(big[0], big[1], big[2], *big[3], 1, group_size=128)
    assert torch.equal(first, again)


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
    with mock.patch.object(stk, "paged_kv_append_decode_int8", pa.paged_kv_append_reference), \
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
