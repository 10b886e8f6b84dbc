"""The tiled W4A16 kernel's dequant (`csrc/w4_wgmma.cuh`) and the fused A4
head's plan, on the CPU.

The kernel turns a nibble into bf16 with the exponent trick (the bits
``0x4300 | u``, u = v + 8 in offset binary, are 128 + u), subtracts 136 and
multiplies by bf16(s) in bf16x2, each step rounded once. These tests pin
the identity that rests on: for every nibble and a spread of bf16 scales
(both signs, subnormal to large) the result is the reference's
``bf16(bf16(v) * bf16(s))`` bit for bit; and the plain mirror of the
kernel's word arithmetic (`w4a16_magic_words`) gives `unpack_int4`'s
values for all 256 bytes. The fused A4 head plans its product as row 1's
GEMV (`mma_plan` on the vertical layout) at the decode's row counts.
"""

import numpy as np
import pytest
import torch

from fastforward_tpu_torch.kernels import matmul as mm
from fastforward_tpu_torch.kernels.packing import unpack_int4


def _bf16_scales(n, seed):
    """``n`` bf16 scales drawn as bit patterns with numpy: either sign,
    biased exponents 0 (subnormal) to 226 (2^99), any mantissa."""
    rng = np.random.default_rng(seed)
    sign = rng.integers(0, 2, n, dtype=np.uint16) << 15
    exp = rng.integers(0, 227, n, dtype=np.uint16) << 7
    man = rng.integers(0, 128, n, dtype=np.uint16)
    return torch.from_numpy((sign | exp | man).view(np.int16)).view(torch.bfloat16)


def _bits(t):
    return t.view(torch.int16).to(torch.int32) & 0xFFFF


def _round_bf16(f32):
    """Round float32 values to bf16 to nearest even, by their bits (as
    subnormals and overflow to infinity included); returns bf16 bits."""
    b = f32.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return ((b + 0x7FFF + ((b >> 16) & 1)) >> 16) & 0xFFFF


@pytest.mark.parametrize("seed", [0, 1])
def test_magic_number_dequant_rounds_as_the_reference(seed):
    # GIVEN every nibble u (offset binary, v = u - 8) and 12,000 bf16 scales
    s = _bf16_scales(12000, seed)
    sb = _bits(s)
    exps = (sb >> 7) & 0xFF
    assert ((exps == 0) & ((sb & 0x7F) != 0)).any() and (exps > 200).any()  # subnormal, large
    assert (s < 0).any() and (s > 0).any()
    u = torch.arange(16)
    v = (u - 8).to(torch.bfloat16)
    # WHEN the kernel's steps run in bf16: bits 0x4300 | u, minus 136, times s
    m = (0x4300 | u).to(torch.int16).view(torch.bfloat16)
    kernel = (m - torch.tensor(136.0, dtype=torch.bfloat16))[:, None] * s[None, :]
    # THEN the subtraction is exact: v
    assert torch.equal(m - torch.tensor(136.0, dtype=torch.bfloat16), v)
    # AND the product is the reference's bf16(bf16(v) * bf16(s)) bit for bit
    ref = v[:, None] * s[None, :]
    assert torch.equal(_bits(kernel), _bits(ref))
    # AND both are the exact product rounded once to nearest even (the float64
    # product of a 4-bit integer and an 8-bit mantissa is exact in float32)
    exact = (v.double()[:, None] * s.double()[None, :]).float()
    assert torch.equal(_bits(kernel), _round_bf16(exact))


def test_magic_words_mirror_unpack_int4_for_every_byte():
    # GIVEN every byte, at byte 0 of a word, and every byte again (reversed)
    # at byte 2: one column's bytes of two byte rows
    b0 = torch.arange(256)
    b1 = 255 - b0
    lo, hi = mm.w4a16_magic_words(b0 | (b1 << 16))
    # WHEN the bf16 pairs lose their 136
    def values(pair):
        halves = torch.stack([pair & 0xFFFF, pair >> 16], dim=-1).to(torch.int16)
        return halves.view(torch.bfloat16).float() - 136.0
    # THEN the low and high nibbles of both bytes are unpack_int4's values
    # (one byte row of group size 2: k = 0 the low nibble, k = 1 the high)
    ref = unpack_int4(torch.stack([b0, b1], dim=1).to(torch.int8).reshape(1, 512),
                      group_size=2).float().reshape(2, 256, 2)
    assert torch.equal(values(lo), ref[0])
    assert torch.equal(values(hi), ref[1])


@pytest.mark.parametrize("M", [1, 8, 64, 192, 256])
def test_a4_head_plans_its_product_as_row_1(M):
    # GIVEN the fused A4 head's qkv product at Llama-3-8B's widths, g512
    K, N, g = 4096, 6144, 512
    plan = mm.mma_plan(M, K, N, g, "vertical")
    # THEN its splits cover every group once, in order, and its ring fits
    covered = [u for a, b in plan.unit_ranges() for u in range(a, b)]
    assert covered == list(range(K // g))
    assert 1 <= mm.manual_depth(plan, 4) <= 4
    assert plan.x_bytes == plan.m_tiles * plan.n_split * plan.stages * 2 * 2 * plan.mt * 512
