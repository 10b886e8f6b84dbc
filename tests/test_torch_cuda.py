"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA GPU (built for sm_90a) and skips without
one. Run them on the card with

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest``: the shared conftest imports JAX, which the GPU host
need not have). Tolerances: the GEMVs, argmax ids, the dequant and the KV
append are bit-equal; flash decode and flash prefill are within one bf16
ulp of the largest output (rtol 8e-3).
"""

import pytest
import torch

from fastforward_tpu_torch.kernels import _build
from fastforward_tpu_torch.kernels import attention as att
from fastforward_tpu_torch.kernels import kv_update as kvu
from fastforward_tpu_torch.kernels import matmul as mm
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
