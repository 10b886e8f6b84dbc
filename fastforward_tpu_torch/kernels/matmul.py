"""The quantized matmuls of `fastforward_tpu/kernels/matmul.py`: the
two-level int4 GEMVs, the float-scale W8A8, W4A8 and W4A16 products, the
prefill dequant, the fused W4A8 layer tail and its o + gate/up head, and
the fused layer heads.

Each wrapper dispatches on the device of its tensors: a CPU tensor runs
the plain PyTorch version beside it (the port of the JAX oracle), a CUDA
tensor launches the hand-written kernel (`csrc/a4_gemv.cu`,
`csrc/w4a8_gemv.cu`, `csrc/w4a8_halves.cu`, `csrc/w4_gemv.cu`, `csrc/w8a8_gemm.cu`,
`csrc/dequant.cu`, `csrc/fused_tail.cu`, `csrc/fused_head.cu`,
`csrc/w4a16_gemm.cu`) or raises. There is no fallback
from one to the other. `matmul_w4a8` and `matmul_w4a16` take the JAX
package's TPU routing: a GEMV up to `GEMV_MAX_M` rows, else the dequant
and a dense product.

The activation quantizers divide by a constant as a multiplication by its
float32 reciprocal (``amax * (1.0 / 127.0)``): XLA compiles
``amax / 127.0`` to that inside a jitted program, which is how the JAX
serving path runs them, so they agree bit for bit with the jitted JAX
quantizers. The weight converters run eagerly in the JAX package (at load
time) and keep the true division.

The plain versions compute the integer dot in float64: every partial sum
is an integer of magnitude below 2**53, so it is exact, and converting
the float64 result to float32 rounds exactly as int32 → float32 does.
"""

import functools
import math
from typing import NamedTuple, Optional

import torch

from fastforward_tpu_torch import flags
from fastforward_tpu_torch.kernels import _build
from fastforward_tpu_torch.kernels.packing import (
    pack_int4_vertical,
    pack_mult_nibbles,
    pack_uint4_offset,
    pack_uint4_offset_paired,
    unpack_int4,
    unpack_int4_vertical,
    unpack_mult_nibbles,
    unpack_uint4_offset,
    unpack_uint4_offset_paired,
)

# Largest row count the decode GEMVs serve (`matmul.py:309`); more rows take
# the prefill path: dequantize to bf16, then a dense product.
GEMV_MAX_M = 256

def paired_default(n_groups: int) -> bool:
    """The pack-time layout of ``n_groups`` two-level W4A8 groups
    (`matmul.py:428`): paired where ``FF_2L_PAIRED`` is on (the default)
    and the count is even, else group halves."""
    return flags.default_paired_layout() and n_groups % 2 == 0


def quantize_rowwise(x: torch.Tensor, amax: Optional[torch.Tensor] = None):
    """Symmetric per-row int8 quantization: (x_q int8, scale (M,) f32)
    (`matmul.py:1896`). ``amax``: each row's absolute maximum to scale by,
    in place of the row's own (a row-parallel shard quantizing with its
    whole row's)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1) if amax is None else amax.float()
    scale = torch.clamp(amax * (1.0 / 127.0), min=1e-8)
    x_q = torch.clamp(torch.round(xf / scale[..., None]), -128, 127)
    return x_q.to(torch.int8), scale


def quantize_rowwise_a4(x: torch.Tensor, amax: Optional[torch.Tensor] = None):
    """Symmetric per-row int4 quantization: (x_q int8 in [-8, 7], scale)
    (`matmul.py:1282`); ``amax`` as `quantize_rowwise`'s."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1) if amax is None else amax.float()
    scale = torch.clamp(amax * (1.0 / 7.0), min=1e-8)
    x_q = torch.clamp(torch.round(xf / scale[..., None]), -8, 7)
    return x_q.to(torch.int8), scale


def _two_level(w_packed, w_scale, group_size):
    n_groups, N = w_scale.shape
    K = w_packed.shape[0] * 2
    s = w_scale.float()
    s_col = torch.clamp(s.amax(dim=0) / 15.0, min=1e-12)
    m = torch.clamp(torch.round(s / s_col[None, :]), 1, 15)
    s_eff = m * s_col[None, :]
    v = unpack_int4(w_packed, group_size).float().reshape(n_groups, group_size, N)
    w = v * s[:, None, :]
    v2 = torch.clamp(torch.round(w / s_eff[:, None, :]), -8, 7).to(torch.int8)
    return v2.reshape(K, N), m.to(torch.int8), s_col


def convert_two_level(w_packed, w_scale, group_size: int = 128,
                      paired: Optional[bool] = None):
    """Requantize float-per-group W4 (`pack_int4`) onto the two-level grid:
    ``(packed', mult, s_col)`` with offset-binary nibbles, by default paired
    as `paired_default` decides (`matmul.py:410`)."""
    if paired is None:
        paired = paired_default(w_scale.shape[0])
    v2, m, s_col = _two_level(w_packed, w_scale, group_size)
    pack = pack_uint4_offset_paired if paired else pack_uint4_offset
    return pack(v2, group_size=group_size), m, s_col


def convert_two_level_a4(w_packed, w_scale, group_size: int = 128):
    """Two-level requantization into the W4A4 vertical layout (`matmul.py:1290`)."""
    v2, m, s_col = _two_level(w_packed, w_scale, group_size)
    return pack_int4_vertical(v2), m, s_col


def _int_dot(x_q: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """Exact integer product (M, K) @ (K, N), returned as float32 of the
    int32 result."""
    return (x_q.double() @ w8.double()).float()


def _epilogue(acc, s_col, x_scale, bias, out_dtype):
    out = acc * s_col[None, :] * x_scale[:, None]
    if bias is not None:
        out = out + bias
    return out.to(out_dtype)


def _w4a8_2l_dot(x_q, w_packed, mult, group_size, paired):
    """The two-level W4A8 integer product (M, N), as float32."""
    K = x_q.shape[1]
    N = w_packed.shape[1]
    n_groups = K // group_size
    unpack = unpack_uint4_offset_paired if paired else unpack_uint4_offset
    v = unpack(w_packed, group_size).reshape(n_groups, group_size, N)
    w8 = (v.to(torch.int32) * mult.to(torch.int32)[:, None, :]).reshape(K, N)
    return _int_dot(x_q, w8)


def matmul_w4a8_2l_reference(x_q, x_scale, w_packed, mult, s_col, bias=None,
                             group_size: int = 128, out_dtype=torch.bfloat16,
                             paired: Optional[bool] = None):
    """Oracle: integer math end to end, one float scaling (`matmul.py:444`)."""
    if paired is None:
        paired = paired_default(x_q.shape[1] // group_size)
    return _epilogue(_w4a8_2l_dot(x_q, w_packed, mult, group_size, paired), s_col, x_scale,
                     bias, out_dtype)


def matmul_w4a4_2l_reference(x_q, x_scale, w_packed, mult, s_col, bias=None,
                             group_size: int = 128, out_dtype=torch.bfloat16):
    """Oracle for the W4A4 GEMV (`matmul.py:1317`): ``w_packed`` vertical."""
    M, K = x_q.shape
    N = w_packed.shape[1]
    n_groups = K // group_size
    v = unpack_int4_vertical(w_packed).reshape(n_groups, group_size, N)
    w8 = (v.to(torch.int32) * mult.to(torch.int32)[:, None, :]).reshape(K, N)
    return _epilogue(_int_dot(x_q, w8), s_col, x_scale, bias, out_dtype)


# The int8 tensor-core tile of the two-level GEMVs (csrc/w4a8_mma.cuh:
# kR padded byte rows a ring stage, kN columns a block, kUnitsPerStage
# multiplier slots of 4 * kN bytes, kFrag bytes an A fragment, 1024 bytes
# of slack to align the stages).
_MMA_ROWS, _MMA_N, _MMA_FRAG, _MMA_SLACK = 64, 128, 512, 1024
_MMA_W_STAGE = _MMA_ROWS * _MMA_N + (_MMA_ROWS // 16) * 4 * _MMA_N
# The H100's SMs. Blocks a tensor-core GEMV launch aims for (two on each
# SM; K is split below it), and the ring stages of every entry but the
# manual stream's (rows 1, 4 and 5).
_SMS = 132
_MMA_TARGET_BLOCKS = 2 * _SMS
_MMA_DEPTH = 4
# Shared memory a block may use on the H100.
_SMEM_MAX = 232448


def mma_tiles(M: int) -> int:
    """m16 tiles one block of the tensor-core tile owns at M rows
    (`csrc/w4a8_mma.cuh` tiles_of): 16, 32 or 64 rows."""
    return 1 if M <= 16 else 2 if M <= 32 else 4


# The weight layouts of the tensor-core tile (csrc/common.cuh Layout):
# "vertical" (`pack_int4_vertical`, the W4A4 GEMV), "paired"
# (`pack_uint4_offset_paired`) and "halves" (`pack_uint4_offset`).
MMA_LAYOUTS = ("vertical", "paired", "halves")


class MmaPlan(NamedTuple):
    """The launch plan of the tensor-core two-level tile
    (`csrc/w4a8_mma.cuh` Plan, derived there from ``n_split``): ``mt`` m16
    tiles a block, the (m, n) tile grid, a unit's byte rows (a group pair,
    or one group of the group-halves or vertical layout) and their padding
    to 16, the units, the K splits, the units a split covers (the last
    split fewer) and the ring stages (`_MMA_ROWS` padded byte rows each) a
    split streams."""
    mt: int
    m_tiles: int
    n_tiles: int
    unit_rows: int
    p16: int
    n_units: int
    n_split: int
    ups: int
    stages: int

    @property
    def stage_bytes(self) -> int:
        """Shared bytes of one ring stage: weight rows, multiplier slots and
        the activation fragments of two 32-row chunks."""
        return _MMA_W_STAGE + (_MMA_ROWS // 32) * 2 * self.mt * _MMA_FRAG

    @property
    def x_bytes(self) -> int:
        """Bytes of the activations staged in fragment order (the ``xf``
        buffer): every (m tile, split, stage)."""
        return (self.m_tiles * self.n_split * self.stages
                * (_MMA_ROWS // 32) * 2 * self.mt * _MMA_FRAG)

    def unit_ranges(self):
        """[(first unit, end unit)] of each split, in split order."""
        return [(s * self.ups, min(self.n_units, (s + 1) * self.ups))
                for s in range(self.n_split)]


@functools.lru_cache(maxsize=256)
def mma_plan(M: int, K: int, N: int, group_size: int, layout: str,
             n_split: Optional[int] = None) -> MmaPlan:
    """Plan of the tensor-core two-level GEMV on weights of ``layout`` (one
    of `MMA_LAYOUTS`): K is split over whole units only where the (m, n)
    tiles fall short of `_MMA_TARGET_BLOCKS`, each split keeping at least
    two stages of rows where the units allow; or into ``n_split`` splits
    where given (at most one a unit, none empty)."""
    if layout not in MMA_LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}, not one of {MMA_LAYOUTS}")
    paired = layout == "paired"
    unit_rows = group_size if paired else group_size // 2
    n_units = K // (2 * group_size) if paired else K // group_size
    p16 = -(-unit_rows // 16) * 16
    mt = mma_tiles(M)
    m_tiles, n_tiles = -(-M // (16 * mt)), -(-N // _MMA_N)
    if n_split is None:
        want = -(-_MMA_TARGET_BLOCKS // (m_tiles * n_tiles))
        most = max(1, n_units * p16 // (2 * _MMA_ROWS))
        n_split = min(want, most)
    n_split = max(1, min(n_units, n_split))
    # no empty split, and the units a split the kernel derives from n_split
    n_split = -(-n_units // -(-n_units // n_split))
    ups = -(-n_units // n_split)
    stages = -(-ups * p16 // _MMA_ROWS)
    return MmaPlan(mt, m_tiles, n_tiles, unit_rows, p16, n_units, n_split, ups, stages)


def manual_depth(plan: MmaPlan, nbuf: int) -> int:
    """Stages of the tensor-core tile's ring (`csrc/w4a8_mma.cuh`): the
    least of ``nbuf`` (``FF_2L_MANUAL`` for the manual stream), the stages
    a block streams, and the stages that fit in the 227 KB a block may use
    (in place of the TPU kernel's 6 MB VMEM cap, `matmul.py:1084-1085`)."""
    depth = min(nbuf, plan.stages, (_SMEM_MAX - _MMA_SLACK) // (plan.stage_bytes + 16))
    if depth < 1:
        raise ValueError(f"the tensor-core W4A8 GEMV ring has no room for a stage ({plan})")
    return depth


def mma_staged_operand(x_q: torch.Tensor, plan: MmaPlan, group_size: int,
                       layout: str) -> torch.Tensor:
    """The tensor-core tile's staged activations (``plan.x_bytes`` int8) as
    the fused heads' prologue writes them, row by row and word by word
    (`csrc/w4a8_mma.cuh` stage_row): word (split, stage, chunk, plane, half
    h, tid) of row m holds byte rows i0 + 2 tid + (0, 1, 8, 9) of the
    half's unit in plane ``plane`` (x[m, plane's first k + step * i]; zeros
    past the unit's rows, past the split's units and for the rows of the
    last m tile past M), at lane 4 (m % 8) + tid, register 2 h + m % 16 // 8
    of its fragment."""
    M, K = x_q.shape
    g, mt, chunks = group_size, plan.mt, _MMA_ROWS // 32
    rows = plan.m_tiles * 16 * mt
    wi = torch.arange(plan.n_split * plan.stages * chunks * 16)
    tid, h, plane = wi % 4, wi // 4 % 2, wi // 8 % 2
    c = wi // 16 % chunks
    s = wi // 16 // chunks % plan.stages
    split = wi // 16 // chunks // plan.stages
    q = s * _MMA_ROWS + 32 * c + 16 * h
    u, i0 = split * plan.ups + q // plan.p16, q % plan.p16
    live = u < torch.clamp((split + 1) * plan.ups, max=plan.n_units)
    b = torch.arange(4)
    i = (i0 + 2 * tid)[:, None] + (b & 1) + 8 * (b >> 1)
    first = {"paired": (2 * u + plane) * g, "halves": u * g + plane * (g // 2),
             "vertical": u * g + plane}[layout]
    k = first[:, None] + (2 if layout == "vertical" else 1) * i
    valid = live[:, None] & (i < plan.unit_rows)
    xb = torch.zeros((rows, K), dtype=torch.int64)
    xb[:M] = x_q.view(torch.uint8).long()
    byte = xb[:, k.clamp(0, K - 1)] * valid
    word = (byte << (8 * b)).sum(-1)  # (rows, words)
    m = torch.arange(rows)[:, None]
    f = ((((m // (16 * mt)) * plan.n_split + split) * plan.stages + s) * chunks + c) * 2 + plane
    at = (f * mt + m % (16 * mt) // 16) * (_MMA_FRAG // 4) + (4 * (m % 8) + tid) * 4 \
        + 2 * h + m % 16 // 8
    out = torch.zeros(plan.x_bytes // 4, dtype=torch.int64)
    out[at.flatten()] = word.flatten()
    return (out - ((out >> 31) << 32)).to(torch.int32).view(torch.int8)


# The any-group route (`csrc/w4a8_mma.cuh` w4a8_rows_kernel): byte rows in
# memory order, at most this many a split (its int32 sums cannot overflow).
_ROWS_MAX_SPLIT = 65536


class RowsPlan(NamedTuple):
    """The launch plan of the any-group route (`csrc/w4a8_mma.cuh` RowsPlan,
    derived there from ``n_split``): ``mt`` m16 tiles a block, the (m, n)
    tile grid, the layer's byte rows, the byte rows a split covers (whole
    `_MMA_ROWS`-row stages, the last split fewer), the splits, the ring
    stages a split streams, the multiplier rows a stage holds (int8 group
    rows, or nibble-packed words of 8 groups) and their bytes, and whether
    every 4-row word meets at most two groups in each plane (the fold of
    two multipliers; else slot by slot)."""
    mt: int
    m_tiles: int
    n_tiles: int
    rows: int
    rps: int
    n_split: int
    stages: int
    mult_rows: int
    mult_bytes: int
    pairs: bool

    @property
    def stage_bytes(self) -> int:
        """Shared bytes of one ring stage: weight rows, multiplier rows and
        the activation fragments, rounded up to the swizzle's 1024 bytes."""
        a = (_MMA_ROWS // 32) * 2 * self.mt * _MMA_FRAG
        return -(-(_MMA_ROWS * _MMA_N + self.mult_bytes + a) // 1024) * 1024

    @property
    def x_bytes(self) -> int:
        """Bytes of the activations staged in fragment order (``xf``)."""
        return self.m_tiles * self.n_split * self.stages * (_MMA_ROWS // 32) * 2 * self.mt \
            * _MMA_FRAG

    def row_ranges(self):
        """[(first byte row, end row)] of each split, in split order."""
        return [(s * self.rps, min(self.rows, (s + 1) * self.rps)) for s in range(self.n_split)]


def _rows_per_split(rows: int, n_split: int) -> tuple:
    """(rps, n_split) as `csrc/w4a8_mma.cuh` rows_plan_of derives them from
    ``n_split``, taken to the fixed point the kernel's check expects."""
    while True:
        rps = -(-(-(-rows // n_split)) // _MMA_ROWS) * _MMA_ROWS
        got = -(-rows // rps)
        if got == n_split:
            return rps, n_split
        n_split = got


def _rows_split(rows: int, tiles: int) -> int:
    """The K splits of the any-group route over ``tiles`` (m, n) tiles: the
    count whose blocks finish first when the SMs take them in turns, each
    SM's time its most blocks times a block's stages plus two (its ring's
    fill and drain; two blocks share an SM, one alone runs ~10% slower a
    stage), the fewer splits on a tie (each writes and reads its int32
    partials). Measured at down_proj g 14 on the H100, 700 W
    (`scripts/ab_two_level.py --any --splits`): M = 192 best at 4 splits
    (0.0810 ms; 8: 0.0840, 3: 0.1018), M = 64 and 24 at 8, M = 8 at 8-16."""
    best = None
    for n in range(1, max(1, rows // (2 * _MMA_ROWS)) + 1):
        rps, n = _rows_per_split(rows, n)
        blocks = tiles * n
        cost = -(-blocks // _SMS) * (rps // _MMA_ROWS + 2) * (11 if blocks <= _SMS else 10)
        if best is None or cost < best[0]:
            best = (cost, n)
    return best[1]


@functools.lru_cache(maxsize=256)
def rows_plan(M: int, K: int, N: int, group_size: int, layout: str,
              n_split: Optional[int] = None, packed: bool = True) -> RowsPlan:
    """Plan of the any-group route on weights of ``layout`` (one of
    `MMA_LAYOUTS`; ``packed``: nibble-packed multipliers, else int8 rows):
    K is split along whole stages, at most `_ROWS_MAX_SPLIT` rows a split,
    into the count that `_rows_split` picks; or into ``n_split`` splits
    where given (none empty)."""
    if layout not in MMA_LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}, not one of {MMA_LAYOUTS}")
    g, rows = group_size, K // 2
    mt = mma_tiles(M)
    m_tiles, n_tiles = -(-M // (16 * mt)), -(-N // _MMA_N)
    if n_split is None:
        n_split = _rows_split(rows, m_tiles * n_tiles)
    n_split = max(1, n_split, -(-rows // _ROWS_MAX_SPLIT))
    rps, n_split = _rows_per_split(rows, n_split)
    n_groups = K // g
    span = {"paired": 2 * ((_MMA_ROWS - 1) // g + 2),
            "halves": (_MMA_ROWS - 1) // max(1, g // 2) + 2,
            "vertical": (2 * _MMA_ROWS - 1) // g + 2}[layout]
    groups = min(span, n_groups)
    mult_rows = min((groups - 1) // 8 + 2, -(-n_groups // 8)) if packed else groups
    pairs = {"paired": g >= 2, "halves": g >= 4, "vertical": g == 4 or g >= 6}[layout]
    return RowsPlan(mt, m_tiles, n_tiles, rows, rps, n_split, rps // _MMA_ROWS, mult_rows,
                    mult_rows * _MMA_N * (4 if packed else 1), pairs)


def _slot_k(r: torch.Tensor, plane, g: int, layout: str) -> torch.Tensor:
    """k of the nibble of byte row ``r`` in ``plane`` (`csrc/w4a8_mma.cuh`
    slot_k)."""
    if layout == "vertical":
        return 2 * r + plane
    if layout == "paired":
        u = r // g
        return (2 * u + plane) * g + r - u * g
    h = g // 2
    u = r // h
    return u * g + plane * h + r - u * h


def _row_group(r: torch.Tensor, plane, g: int, layout: str) -> torch.Tensor:
    """The group of the nibble of byte row ``r`` in ``plane``."""
    if layout == "vertical":
        return (2 * r + plane) // g
    if layout == "paired":
        return 2 * (r // g) + plane
    return r // (g // 2)


def _rows_word_slots(plan: RowsPlan) -> tuple:
    """(token row, first byte row, plane, split) of each 32-bit word of the
    any-group route's staged operand, by stage_rows_kernel's index
    arithmetic: word 4 lane + reg of fragment ((((m tile * n_split + split)
    * stages + stage) * 2 + chunk) * 2 + plane) * mt + m16 tile; its bytes
    are the byte rows first + 0..3."""
    mt = plan.mt
    wi = torch.arange(plan.x_bytes // 4)
    reg, lane, f = wi % 4, wi // 4 % 32, wi // 128
    ti, f = f % mt, f // mt
    plane, f = f % 2, f // 2
    c, f = f % 2, f // 2
    s, f = f % plan.stages, f // plan.stages
    split, m_tile = f % plan.n_split, f // plan.n_split
    m = (m_tile * mt + ti) * 16 + lane // 4 + 8 * (reg % 2)
    ra = split * plan.rps + s * _MMA_ROWS + 32 * c + 16 * (reg // 2) + 4 * (lane % 4)
    return m, ra, plane, split


def rows_staged_operand(x_q: torch.Tensor, plan: RowsPlan, group_size: int,
                        layout: str) -> torch.Tensor:
    """The any-group route's staged activations (``plan.x_bytes`` int8) as
    `csrc/w4a8_mma.cuh` stage_rows_kernel writes them: the fragments of every
    (m tile, split, stage, chunk, plane, m16 tile) in stage_x_kernel's order,
    slot 4 t + i of half h holding byte row split * rps + stage * 64 + 32
    chunk + 16 h + 4 t + i (x at its k in the plane; zeros past the split's
    rows and past M)."""
    M, K = x_q.shape
    m, ra, plane, split = _rows_word_slots(plan)
    re = torch.clamp((split + 1) * plan.rps, max=plan.rows)
    r = ra[:, None] + torch.arange(4)
    valid = (r < re[:, None]) & (m < M)[:, None]
    k = _slot_k(r, plane[:, None], group_size, layout).clamp(0, K - 1)
    xb = x_q.view(torch.uint8).long()[m.clamp(max=M - 1)[:, None], k] * valid
    word = (xb << (8 * torch.arange(4))).sum(-1)
    return (word - ((word >> 31) << 32)).to(torch.int32).view(torch.int8)


def _fold2(nib, m_a, m_b, mask):
    """`csrc/w4a8_mma.cuh` fold2 on int64 words: the fold by m_a, and by m_b
    in the bytes of ``mask``."""
    d = (nib - 0x08080808) & 0xFFFFFFFF
    fa = (d * m_a + 0x80808080) & 0xFFFFFFFF
    fb = (d * m_b + 0x80808080) & 0xFFFFFFFF
    return ((fa & ~mask & 0xFFFFFFFF) | (fb & mask)) ^ 0x80808080


def rows_folded_weights(w_packed: torch.Tensor, mult: torch.Tensor, group_size: int,
                        layout: str, plan: RowsPlan) -> torch.Tensor:
    """The int8 B operand of the any-group route (``(rows, 2, N)`` int64:
    byte row, nibble plane, column) as `csrc/w4a8_mma.cuh` fold_rows makes
    it: each aligned 4-row word of a column (rows past K / 2 zero bytes),
    the vertical layout's nibbles flipped to offset binary, folded in each
    plane with the multipliers of the groups of its first and last rows
    (clamped to the split's last row) where ``plan.pairs``, the bytes past
    the first group's rows from the second, else slot by slot. ``w_packed``
    (K/2, N) flat or (N/bn, K/2, bn) pre-blocked; ``mult`` (K/g, N) int8."""
    g = group_size
    if w_packed.dim() == 3:
        nb, kh, bn = w_packed.shape
        w_packed = w_packed.permute(1, 0, 2).reshape(kh, nb * bn)
    rows, N = w_packed.shape
    words = -(-rows // 4)
    wb = torch.zeros((4 * words, N), dtype=torch.int64)
    wb[:rows] = w_packed.view(torch.uint8).long()
    ra = 4 * torch.arange(words)
    re = torch.clamp((ra // plan.rps + 1) * plan.rps, max=rows)  # the word's split's end
    v = (wb.view(words, 4, N) << (8 * torch.arange(4))[None, :, None]).sum(1)
    if layout == "vertical":
        v = v ^ 0x88888888
    ml = mult.long()
    r3 = torch.minimum(ra + 3, re - 1)
    r0 = torch.minimum(ra, re - 1)
    out = []
    for p in (0, 1):
        nib = (v >> (4 * p)) & 0x0F0F0F0F
        if plan.pairs:
            ga, gb = _row_group(r0, p, g, layout), _row_group(r3, p, g, layout)
            first = {"vertical": ((ga + 1) * g - p + 1) // 2, "paired": (ga // 2 + 1) * g,
                     "halves": (ga + 1) * (g // 2)}[layout]
            n = (first - ra).clamp(0, 4)
            mask = (0xFFFFFFFF << (8 * n)) & 0xFFFFFFFF
            f = _fold2(nib, ml[ga], ml[gb], mask[:, None])
            byte = (f[:, None, :] >> (8 * torch.arange(4))[None, :, None]) & 255
        else:
            gi = _row_group(torch.minimum(ra[:, None] + torch.arange(4), r3[:, None]), p, g,
                            layout)
            u = (nib[:, None, :] >> (8 * torch.arange(4))[None, :, None]) & 15
            byte = ((u - 8) * ml[gi]) & 255
        out.append(byte.reshape(4 * words, N))
    b = torch.stack(out, 1)[:rows]
    return b - ((b >> 7) << 8)


def two_level_rows_dot(x_q: torch.Tensor, w_packed: torch.Tensor, mult: torch.Tensor,
                       group_size: int, layout: str, plan: Optional[RowsPlan] = None):
    """The integer product (M, N) int64 of the any-group route, in torch
    integer ops: the activations staged in slot order (`rows_staged_operand`)
    read back by the fragments' index arithmetic, against the B operand of
    `rows_folded_weights`, summed over every byte row and plane. ``plan``
    defaults to `rows_plan` at (M, K, N)."""
    M, K = x_q.shape
    N = w_packed.shape[-1] * (w_packed.shape[0] if w_packed.dim() == 3 else 1)
    if plan is None:
        plan = rows_plan(M, K, N, group_size, layout)
    xf = rows_staged_operand(x_q, plan, group_size, layout).view(torch.int32).long()
    m, ra, plane, _ = _rows_word_slots(plan)
    r = (ra[:, None] + torch.arange(4)).flatten()
    byte = ((xf[:, None] >> (8 * torch.arange(4))) & 255).flatten()
    byte = byte - ((byte >> 7) << 8)
    keep = (r < plan.rows) & (m.repeat_interleave(4) < M)
    a = torch.zeros((M, plan.rows, 2), dtype=torch.int64)
    a[m.repeat_interleave(4)[keep], r[keep], plane.repeat_interleave(4)[keep]] = byte[keep]
    b = rows_folded_weights(w_packed, mult, group_size, layout, plan)
    return torch.einsum("mrp,rpn->mn", a.double(), b.double()).long()


def fold_w4a8_2l_words(words: torch.Tensor, m_lo, m_hi=None) -> tuple:
    """The tensor-core tile's fold (`csrc/w4a8_mma.cuh` fold, the TPU
    kernels' SWAR fold, `matmul.py:486-491`), in torch integer ops: packed
    int32 ``words`` of four offset-binary nibble pairs u, and multipliers
    (broadcast against ``words``; ``m_hi`` defaults to ``m_lo``, the
    group-halves layout) to the int32 words of the low and of the high
    plane whose bytes are the int8 ``m * (u - 8)``:
    ``((u * m + (0x80808080 - 8m * 0x01010101)) ^ 0x80808080)`` per plane."""
    mask = 0xFFFFFFFF
    w = words.to(torch.int64) & mask
    m_lo = torch.as_tensor(m_lo).to(torch.int64)
    m_hi = m_lo if m_hi is None else torch.as_tensor(m_hi).to(torch.int64)

    def plane(p, m):
        bias = (0x80808080 - m * 0x08080808) & mask
        f = ((p * m + bias) & mask) ^ 0x80808080
        return (f - ((f >> 31) << 32)).to(torch.int32)

    return plane(w & 0x0F0F0F0F, m_lo), plane((w >> 4) & 0x0F0F0F0F, m_hi)


def fold_w4a4_2l_words(words: torch.Tensor, m) -> tuple:
    """The tensor-core tile's fold of the vertical layout (`csrc/w4a8_mma.cuh`):
    packed int32 ``words`` of four two's-complement nibble pairs v (low
    nibble k = 2r, high k = 2r + 1) and their group's multiplier ``m``
    (broadcast against ``words``) to the int32 words of the low and high
    plane whose bytes are the int8 ``m * v``: bit 3 of every nibble flipped
    (``^ 0x88888888``, two's complement to offset binary u = v + 8), then
    `fold_w4a8_2l_words` with ``m`` for both planes."""
    flipped = (words.to(torch.int64) & 0xFFFFFFFF) ^ 0x88888888
    return fold_w4a8_2l_words(flipped, m)


def _check_gemv(x_q, x_scale, K, N, group_size, n4: bool = True):
    dev = x_q.device
    M = x_q.shape[0]
    _build.require(x_q, "x_q", torch.int8, (M, K))
    _build.require(x_scale, "x_scale", torch.float32, (M,), dev)
    if M < 1 or N < 1 or (n4 and N % 4 != 0) or K % group_size != 0:
        raise ValueError(f"GEMV needs M >= 1, N % 4 == 0, K % group == 0 (M={M}, N={N}, K={K})")


def two_level_route(layout: str, K: int, N: int, group_size: int) -> str:
    """The route of the two-level GEMVs (rows 1, 4, 5 and 9, and the
    products of the fused heads and tail) on weights of ``layout`` (one of
    `MMA_LAYOUTS`), chosen by shape: "tile", the int8 tensor-core tile
    (`csrc/w4a8_mma.cuh` w4a8_mma_kernel), where a unit's byte rows a plane
    are a multiple of 4 (paired g % 4 == 0, vertical and group halves g % 8
    == 0) and N % 4 == 0; else "any", the any-group route on the same
    tensor cores (w4a8_rows_kernel: byte rows in memory order, planned by
    `rows_plan`), for every other group the reference takes.
    Raises ValueError for a group the reference does not take: vertical K
    even and whole groups, paired whole group pairs, group halves an even
    group."""
    if layout not in MMA_LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}, not one of {MMA_LAYOUTS}")
    g = group_size
    ok = g >= 1 and K >= 2 and K % 2 == 0 and {
        "vertical": K % g == 0,
        "paired": K % (2 * g) == 0,
        "halves": g % 2 == 0 and K % g == 0,
    }[layout]
    if not ok:
        need = {"vertical": "K even and K % group == 0",
                "paired": "K % (2 * group) == 0 (whole group pairs)",
                "halves": "an even group and K % group == 0"}[layout]
        raise ValueError(f"the {layout} two-level layout needs {need} (K={K}, group={g})")
    unit = 4 if layout == "paired" else 8
    return "tile" if g % unit == 0 and N % 4 == 0 else "any"


def _out_kind(out_dtype) -> int:
    """The C entries' out_kind: 0 f32, 1 bf16; raises for any other dtype."""
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the two-level GEMV kernels write f32 or bf16, not {out_dtype}")
    return int(out_dtype == torch.bfloat16)


def matmul_w4a4_2l_gemv_stacked(x_q, x_scale, w_packed, mult, s_col, layer,
                                group_size: int = 128, out_dtype=torch.bfloat16):
    """W4A4 decode GEMV over stacked weights (`matmul.py:1406`).

    ``x_q`` int4-valued int8 (M, K); ``w_packed`` (L, K//2, N) vertical;
    ``mult`` (L, ceil(n_groups/8), N) int32 nibble-packed; ``s_col`` (L, N);
    f32 or bf16 out. Bit-exact against `matmul_w4a4_2l_reference` on layer
    ``layer``. On the card `csrc/a4_gemv.cu` ``ff_a4_gemv`` on the int8
    tensor-core tile (`csrc/w4a8_mma.cuh`, its vertical layout case, planned
    by `mma_plan`), counted under ``a4_gemv``; any other group
    (`two_level_route`) ``ff_a4_gemv_any``, the any-group route on the same
    tensor cores (planned by `rows_plan`), counted under ``a4_gemv_any``.
    """
    layer = int(layer)
    M, K = x_q.shape
    L, Kh, N = w_packed.shape
    n_groups = K // group_size
    if x_q.device.type == "cpu":
        ml = unpack_mult_nibbles(mult[layer], n_groups)
        return matmul_w4a4_2l_reference(
            x_q, x_scale, w_packed[layer], ml, s_col[layer], None, group_size, out_dtype,
        )
    dev = x_q.device
    route = two_level_route("vertical", K, N, group_size)
    _check_gemv(x_q, x_scale, K, N, group_size, n4=route == "tile")
    n_pack = mult.shape[1]
    _build.require(w_packed, "w_packed", torch.int8, (L, K // 2, N), dev)
    _build.require(mult, "mult", torch.int32, (L, n_pack, N), dev)
    _build.require(s_col, "s_col", torch.float32, (L, N), dev)
    kind = _out_kind(out_dtype)
    if n_pack * 8 < n_groups or not 0 <= layer < L:
        raise ValueError(f"A4 GEMV kernel needs a full multiplier pack and a valid layer "
                         f"(groups={n_groups}, n_pack={n_pack}, layer={layer})")
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    name = "a4_gemv" if route == "tile" else "a4_gemv_any"
    plan = _route_plan(route, M, K, N, group_size, "vertical", True)
    xf, partial = _mma_scratch(plan, M, N, dev)
    err = getattr(_build.lib("a4_gemv"), f"ff_{name}")(
        x_q.data_ptr(), x_scale.data_ptr(), w_packed.data_ptr(), mult.data_ptr(),
        s_col.data_ptr(), xf.data_ptr(), None if partial is None else partial.data_ptr(),
        out.data_ptr(), M, K, N, L, layer, group_size, n_pack, plan.n_split,
        manual_depth(plan, _MMA_DEPTH), kind, _build.stream_ptr(dev),
    )
    _build.launch_counts[name] += 1
    _build.check(err, name)
    return out


def matmul_w4a4_2l_gemv(x_q, x_scale, w_packed, mult, s_col, group_size: int = 128,
                        out_dtype=torch.bfloat16):
    """Non-stacked W4A4 GEMV (`matmul.py:1487`): the stacked kernel at L=1."""
    if x_q.device.type == "cpu":
        return matmul_w4a4_2l_reference(
            x_q, x_scale, w_packed, mult, s_col, None, group_size, out_dtype,
        )
    return matmul_w4a4_2l_gemv_stacked(
        x_q, x_scale, w_packed[None], pack_mult_nibbles(mult)[None].contiguous(),
        s_col[None].float().contiguous(), 0, group_size, out_dtype,
    )


def _check_2l(x_q, x_scale, w_packed, mult, s_col, group_size, paired):
    """Check the operands of the two-level W4A8 GEMV kernels; returns (M, K,
    N, route) with the route of `two_level_route` (which raises for a group
    the layout does not take: paired whole group pairs, group halves an
    even group)."""
    M, K = x_q.shape
    N = w_packed.shape[1]
    dev = x_q.device
    route = two_level_route("paired" if paired else "halves", K, N, group_size)
    _check_gemv(x_q, x_scale, K, N, group_size, n4=route == "tile")
    _build.require(w_packed, "w_packed", torch.int8, (K // 2, N), dev)
    _build.require(mult, "mult", torch.int8, (K // group_size, N), dev)
    _build.require(s_col, "s_col", torch.float32, (N,), dev)
    return M, K, N, route


def _route_plan(route: str, M: int, K: int, N: int, group_size: int, layout: str,
                packed: bool):
    """The plan of `two_level_route`'s route: `mma_plan` for the tile,
    `rows_plan` for the any-group route."""
    if route == "tile":
        return mma_plan(M, K, N, group_size, layout)
    return rows_plan(M, K, N, group_size, layout, packed=packed)


def _mma_scratch(plan, M: int, N: int, dev):
    """The tensor-core tiles' scratch (an `MmaPlan` or a `RowsPlan`): the
    staged activations, and the int32 partials (None for one split)."""
    xf = torch.empty((plan.x_bytes,), dtype=torch.int8, device=dev)
    partial = (torch.empty((plan.n_split, M, N), dtype=torch.int32, device=dev)
               if plan.n_split > 1 else None)
    return xf, partial


def matmul_w4a8_2l_gemv(x_q, x_scale, w_packed, mult, s_col, group_size: int = 128,
                        out_dtype=torch.bfloat16, paired: Optional[bool] = None):
    """Two-level W4A8 GEMV (`matmul.py:571`); f32 or bf16 out. On the card
    `csrc/w4a8_gemv.cu` on the int8 tensor-core tile (`csrc/w4a8_mma.cuh`,
    planned by `mma_plan`): the paired layout through ``ff_w4a8_gemv``
    (counted under ``w4a8_gemv``), the group-halves layout
    (`pack_uint4_offset`, the JAX kernel `:479`) through
    ``ff_w4a8_gemv_unpaired`` (``w4a8_gemv_unpaired``); any other group
    (`two_level_route`) through the any-group route on the same tensor cores
    (planned by `rows_plan`), ``ff_w4a8_gemv_any`` (``w4a8_gemv_any``) and
    ``ff_w4a8_gemv_unpaired_any`` (``w4a8_gemv_unpaired_any``); all
    bit-exact against `matmul_w4a8_2l_reference`."""
    M, K = x_q.shape
    if paired is None:
        paired = paired_default(K // group_size)
    if x_q.device.type == "cpu":
        return matmul_w4a8_2l_reference(
            x_q, x_scale, w_packed, mult, s_col, None, group_size, out_dtype, paired=paired,
        )
    M, K, N, route = _check_2l(x_q, x_scale, w_packed, mult, s_col, group_size, paired)
    kind = _out_kind(out_dtype)
    dev = x_q.device
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    lib = _build.lib("w4a8_gemv")
    name = ("w4a8_gemv" if paired else "w4a8_gemv_unpaired") + ("_any" if route == "any" else "")
    plan = _route_plan(route, M, K, N, group_size, "paired" if paired else "halves", False)
    xf, partial = _mma_scratch(plan, M, N, dev)
    err = getattr(lib, f"ff_{name}")(
        x_q.data_ptr(), x_scale.data_ptr(), w_packed.data_ptr(), mult.data_ptr(),
        s_col.data_ptr(), xf.data_ptr(), None if partial is None else partial.data_ptr(),
        out.data_ptr(), M, K, N, group_size, plan.n_split, manual_depth(plan, _MMA_DEPTH),
        kind, _build.stream_ptr(dev),
    )
    _build.launch_counts[name] += 1
    _build.check(err, name)
    return out


def matmul_w4a8_2l_gemv_argmax(x_q, x_scale, w_packed, mult, s_col,
                               group_size: int = 128, paired: Optional[bool] = None):
    """Greedy lm_head (`matmul.py:708`): int32 argmax over N per row of the
    two-level W4A8 logits — the ids of ``torch.argmax`` over the f32
    logits (first occurrence wins ties, a NaN counts as the maximum). The
    fused kernel (`csrc/w4a8_gemv.cu` ``ff_w4a8_gemv_argmax``, counted under
    ``w4a8_gemv_argmax``: row 5's int8 tensor-core tile with an argmax
    epilogue, one (max, first index) pair a row and 128-column block, then
    one warp a row over the pairs) takes the paired layout on the tile; an
    unpaired head, and a group the tile does not take (`two_level_route`),
    takes row 5's f32 logits and their argmax, as the JAX TPU route does for
    an unpaired head."""
    M, K = x_q.shape
    if paired is None:
        paired = paired_default(K // group_size)
    if x_q.device.type == "cpu":
        logits = matmul_w4a8_2l_reference(
            x_q, x_scale, w_packed, mult, s_col, None, group_size, torch.float32,
            paired=paired,
        )
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if not paired or two_level_route("paired", K, w_packed.shape[1], group_size) == "any":
        # the JAX TPU route of an unpaired head (`matmul.py:730-737`): the
        # GEMV's f32 logits (checked there), then their argmax
        logits = matmul_w4a8_2l_gemv(x_q, x_scale, w_packed, mult, s_col, group_size,
                                     torch.float32, paired=paired)
        return torch.argmax(logits, dim=-1).to(torch.int32)
    M, K, N, _ = _check_2l(x_q, x_scale, w_packed, mult, s_col, group_size, paired)
    dev = x_q.device
    plan = mma_plan(M, K, N, group_size, "paired")
    xf, partial = _mma_scratch(plan, M, N, dev)
    # one pair a row and 128-column block (where K is split, the split
    # epilogue's 1024-column tiles: fewer)
    pair_val = torch.empty((M, plan.n_tiles), dtype=torch.float32, device=dev)
    pair_idx = torch.empty((M, plan.n_tiles), dtype=torch.int32, device=dev)
    idx = torch.empty((M,), dtype=torch.int32, device=dev)
    err = _build.lib("w4a8_gemv").ff_w4a8_gemv_argmax(
        x_q.data_ptr(), x_scale.data_ptr(), w_packed.data_ptr(), mult.data_ptr(),
        s_col.data_ptr(), xf.data_ptr(), None if partial is None else partial.data_ptr(),
        pair_val.data_ptr(), pair_idx.data_ptr(), idx.data_ptr(), M, K, N, group_size,
        plan.n_split, manual_depth(plan, _MMA_DEPTH), _build.stream_ptr(dev),
    )
    _build.launch_counts["w4a8_gemv_argmax"] += 1
    _build.check(err, "w4a8_gemv_argmax")
    return idx


def preblock_stacked(w_packed, block_n: int):
    """Stacked packed weights (L, K//2, N) to the pre-blocked layout (L,
    N//bn, K//2, bn) (`matmul.py:1240`): each bn-column panel one
    contiguous chunk. Raises ValueError unless N % block_n == 0."""
    L, Kh, N = w_packed.shape
    if N % block_n:
        raise ValueError(f"N={N} not divisible by block_n={block_n}")
    return w_packed.reshape(L, Kh, N // block_n, block_n).permute(0, 2, 1, 3).contiguous()


def flat_layer(w_packed, layer):
    """Layer ``layer`` of stacked packed weights as (K//2, N): flat (L,
    K//2, N) weights as they are, pre-blocked (L, N//bn, K//2, bn) ones
    restored to the flat form (`matmul.py:1062-1063`)."""
    wl = w_packed[int(layer)]
    if wl.dim() == 3:
        nb, kh, bn = wl.shape
        wl = wl.permute(1, 0, 2).reshape(kh, nb * bn)
    return wl


def stacked_gemv_route(preblocked: bool, n_groups: int, half_k: int, manual_bufs: int,
                       split_w: bool, dotraw: bool = False, concat_pairs: int = 1) -> str:
    """The kernel route of the stacked W4A8 GEMV, in the JAX package's
    order (`matmul.py:1081-1217`, `:834`), named by its launch count: the
    manual stream for pre-blocked weights at ``FF_2L_MANUAL`` >= 2; else
    split-W (``FF_2L_SPLITW``) for flat weights at a group count divisible
    by 4 and an even K//2; else, on either layout, the dot-raw body
    (``FF_2L_DOTRAW``), then the concat-pairs body (``FF_2L_CONCAT_PAIRS``
    above 1), then the default call."""
    if preblocked and manual_bufs >= 2:
        return "w4a8_gemv_manual"
    if split_w and not preblocked and n_groups % 4 == 0 and half_k % 2 == 0:
        return "w4a8_gemv_splitw"
    if dotraw:
        return "w4a8_gemv_dotraw"
    if concat_pairs > 1:
        return "w4a8_gemv_concat"
    return "w4a8_gemv_preblocked" if preblocked else "w4a8_gemv_stacked"


def matmul_w4a8_2l_dotraw_reference(x_q, x_scale, w_packed, mult, s_col,
                                    group_size: int = 128, out_dtype=torch.bfloat16):
    """Plain version of the dot-raw route (the TPU body `matmul.py:949`):
    per group the integer dot of x with the sign-restored nibbles u - 8 of
    the paired layout (K//2, N), times the group's multiplier (K//g, N),
    summed over groups; the oracle's epilogue. The integers are the
    oracle's, so the result is `matmul_w4a8_2l_reference`'s bit for bit."""
    M, K = x_q.shape
    N = w_packed.shape[1]
    G = K // group_size
    v = unpack_uint4_offset_paired(w_packed, group_size).double().reshape(G, group_size, N)
    xg = x_q.double().reshape(M, G, group_size).transpose(0, 1)
    acc = (torch.bmm(xg, v) * mult.double()[:, None, :]).sum(0)
    return _epilogue(acc.float(), s_col, x_scale, None, out_dtype)


def matmul_w4a8_2l_concat_reference(x_q, x_scale, w_packed, mult, s_col, concat_pairs: int,
                                    group_size: int = 128, out_dtype=torch.bfloat16):
    """Plain version of the concat-pairs route (the TPU body `matmul.py:780`):
    units of ``concat_pairs`` adjacent group pairs, each unit's weights
    folded with their multipliers and dotted in one product over its
    2 * concat_pairs * group rows, the unit products summed. Where
    ``concat_pairs`` does not divide the pair count the last unit is
    shorter: every pair is computed, as the oracle computes it (the TPU
    body drops the trailing pairs, `ROADMAP.md` Queue 3). The result is
    `matmul_w4a8_2l_reference`'s bit for bit."""
    K = x_q.shape[1]
    N = w_packed.shape[1]
    G = K // group_size
    v = unpack_uint4_offset_paired(w_packed, group_size).to(torch.int32).reshape(G, group_size, N)
    w8 = (v * mult.to(torch.int32)[:, None, :]).reshape(K, N).double()
    rows = 2 * concat_pairs * group_size
    acc = sum(x_q[:, k0:k0 + rows].double() @ w8[k0:k0 + rows] for k0 in range(0, K, rows))
    return _epilogue(acc.float(), s_col, x_scale, None, out_dtype)


def matmul_w4a8_2l_gemv_stacked(x_q, x_scale, w_packed, mult, s_col, layer,
                                group_size: int = 128, out_dtype=torch.bfloat16):
    """Two-level W4A8 decode GEMV over stacked weights (`matmul.py:1023`).

    ``w_packed`` (L, K//2, N) paired offset-binary, or its pre-blocked
    form (L, N//bn, K//2, bn) (`preblock_stacked`); ``mult`` (L,
    ceil(n_groups/8), N) int32 nibble-packed; ``s_col`` (L, N). Bit-exact
    against `matmul_w4a8_2l_reference` (paired) on layer ``layer``, whose
    weights the plain version restores to the flat form as the JAX CPU
    path does. The route (`stacked_gemv_route`) follows the flags read at
    each call; on the CPU the dot-raw and concat-pairs routes run their own
    plain versions, the others the oracle. On the card one entry of
    `csrc/w4a8_gemv.cu` per route, each under its own launch count, every
    one on the int8 tensor-core tile of `csrc/w4a8_mma.cuh` (planned by
    `mma_plan`): ``w4a8_gemv_stacked`` (flat), ``w4a8_gemv_preblocked``,
    ``w4a8_gemv_manual`` (``FF_2L_MANUAL`` >= 2, pre-blocked; its ring
    depth `manual_depth` of the flag, the others' of `_MMA_DEPTH`),
    ``w4a8_gemv_splitw`` (``FF_2L_SPLITW=1``, flat), ``w4a8_gemv_dotraw``
    (``FF_2L_DOTRAW=1``) and ``w4a8_gemv_concat`` (``FF_2L_CONCAT_PAIRS``
    above 1), the last two on either layout. A group the tile does not take
    (`two_level_route`) runs the any-group route ``ff_w4a8_gemv_stacked_any``
    (planned by `rows_plan`) on either layout and any panel width whatever
    the flags, counted under ``w4a8_gemv_stacked_any``.
    """
    layer = int(layer)
    M, K = x_q.shape
    preblocked = w_packed.dim() == 4
    if preblocked:
        L, NB, Kh, bn = w_packed.shape
        N = NB * bn
    else:
        L, Kh, N = w_packed.shape
        bn = 0
    n_groups = K // group_size
    manual_bufs, concat_pairs = flags.two_level_manual_bufs(), flags.two_level_concat_pairs()
    route = stacked_gemv_route(preblocked, n_groups, Kh, manual_bufs, flags.two_level_split_w(),
                               flags.two_level_dotraw(), concat_pairs)
    if x_q.device.type == "cpu":
        args = (x_q, x_scale, flat_layer(w_packed, layer),
                unpack_mult_nibbles(mult[layer], n_groups), s_col[layer])
        if route == "w4a8_gemv_dotraw":
            return matmul_w4a8_2l_dotraw_reference(*args, group_size, out_dtype)
        if route == "w4a8_gemv_concat":
            return matmul_w4a8_2l_concat_reference(*args, concat_pairs, group_size, out_dtype)
        return matmul_w4a8_2l_reference(*args, None, group_size, out_dtype, paired=True)
    dev = x_q.device
    tile = two_level_route("paired", K, N, group_size) == "tile"
    _check_gemv(x_q, x_scale, K, N, group_size, n4=tile)
    n_pack = mult.shape[1]
    _build.require(w_packed, "w_packed", torch.int8,
                   (L, NB, K // 2, bn) if preblocked else (L, K // 2, N), dev)
    _build.require(mult, "mult", torch.int32, (L, n_pack, N), dev)
    _build.require(s_col, "s_col", torch.float32, (L, N), dev)
    kind = _out_kind(out_dtype)
    if n_pack * 8 < n_groups or not 0 <= layer < L:
        raise ValueError(
            f"stacked W4A8 GEMV kernel needs a full multiplier pack and a valid layer "
            f"(groups={n_groups}, n_pack={n_pack}, layer={layer})"
        )
    if tile and preblocked and bn % 4 != 0:
        raise ValueError(f"the pre-blocked W4A8 GEMV kernels need a panel width bn that is a "
                         f"multiple of 4 (a lane's 4 columns in one panel), got bn={bn}")
    if not tile:
        route = "w4a8_gemv_stacked_any"
    plan = _route_plan("tile" if tile else "any", M, K, N, group_size, "paired", True)
    xf, partial = _mma_scratch(plan, M, N, dev)
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    nbuf = manual_bufs if route == "w4a8_gemv_manual" else _MMA_DEPTH
    err = getattr(_build.lib("w4a8_gemv"), f"ff_{route}")(
        x_q.data_ptr(), x_scale.data_ptr(), w_packed.data_ptr(), mult.data_ptr(),
        s_col.data_ptr(), xf.data_ptr(), None if partial is None else partial.data_ptr(),
        out.data_ptr(), M, K, N, L, layer, group_size, n_pack, plan.n_split, kind, bn,
        manual_depth(plan, nbuf),
        _build.stream_ptr(dev),
    )
    _build.launch_counts[route] += 1
    _build.check(err, route)
    return out


def dequantize_int4_vertical_reference(w_packed, s_eff, group_size: int = 128,
                                       out_dtype=torch.bfloat16):
    """Oracle: vertical-layout int4 (K//2, N) to dense (K, N) with per-group
    scales ``s_eff`` (K//g, N): ``v * s_eff`` in f32, rounded once
    (`matmul.py:1511`)."""
    K, N = w_packed.shape[0] * 2, w_packed.shape[1]
    v = unpack_int4_vertical(w_packed).reshape(K // group_size, group_size, N)
    return (v.float() * s_eff.float()[:, None, :]).reshape(K, N).to(out_dtype)


def dequantize_int4_reference(w_packed, w_scale, group_size: int = 128,
                              offset_binary: bool = False, paired: bool = False):
    """Oracle of `dequantize_int4`'s CPU path (`matmul.py:1578-1585`):
    packed int4 (K//2, N) to dense bf16 (K, N) with per-group scales
    (K//g, N), ``v * s`` in f32 rounded once. Layouts: group halves with
    two's-complement nibbles (`pack_int4`), group halves offset-binary
    (``offset_binary``), or the adjacent-group pairing (``paired``)."""
    if paired:
        unpack = unpack_uint4_offset_paired
    else:
        unpack = unpack_uint4_offset if offset_binary else unpack_int4
    K, N = w_packed.shape[0] * 2, w_packed.shape[1]
    v = unpack(w_packed, group_size).reshape(K // group_size, group_size, N)
    return (v.float() * w_scale.float()[:, None, :]).reshape(K, N).to(torch.bfloat16)


def dequantize_int4_paired_reference(w_packed, w_scale, group_size: int = 128):
    """Oracle of `dequantize_int4`'s paired branch (`matmul.py:1579-1585`)."""
    return dequantize_int4_reference(w_packed, w_scale, group_size, paired=True)


# The prefill dequant's grid (csrc/dequant.cu): 256 threads a block, 8
# columns a thread (1 where the panel width is no multiple of 8), R byte
# rows a thread, R = 8 unless that leaves fewer than 4 blocks an SM.
_DQ_THREADS, _DQ_MIN_BLOCKS_PER_SM = 256, 4
H100_SMS = 132


class DequantPlan(NamedTuple):
    """The grid of `csrc/dequant.cu` (C ``launch``): the columns and byte
    rows a thread owns, the column tiles of a row of blocks (``threads *
    cols`` columns each) and the row tiles (``rows`` byte rows each); the
    blocks walk them with the column tile fastest."""
    cols: int
    rows: int
    col_tiles: int
    row_tiles: int
    threads: int = _DQ_THREADS

    @property
    def blocks(self) -> int:
        return self.col_tiles * self.row_tiles

    def block_tile(self, b: int):
        """(byte rows, columns) ranges of block ``b``."""
        ct, rt = b % self.col_tiles, b // self.col_tiles
        c0 = ct * self.threads * self.cols
        return (rt * self.rows, (rt + 1) * self.rows), (c0, c0 + self.threads * self.cols)


def dequant_plan(K: int, N: int, bn: int = 0, sms: int = H100_SMS) -> DequantPlan:
    """The prefill dequant's grid for a (K/2, N) packed weight (panels of
    ``bn`` columns, 0: flat) on a card of ``sms`` SMs: each thread issues its
    R 8-byte loads before converting any; R = 8, or 4 where 8 leaves fewer
    than `_DQ_MIN_BLOCKS_PER_SM` blocks an SM (o_proj: 1,024 blocks of 4
    rows, not 512 of 8)."""
    bn = bn if bn > 0 else N
    cols = 8 if bn % 8 == 0 else 1
    col_tiles = -(-(N // cols) // _DQ_THREADS)
    rows = 8 if col_tiles * -(-(K // 2) // 8) >= _DQ_MIN_BLOCKS_PER_SM * sms else 4
    return DequantPlan(cols, rows, col_tiles, -(-(K // 2) // rows))


def _dequant(entry, count, w_packed, mult, scale, layer, group_size, unit, *extra):
    """Launch `csrc/dequant.cu` on layer ``layer`` of (L, K//2, N) weights
    (or of their pre-blocked form (L, N//bn, K//2, bn), whose entry takes
    bn as its extra int): with ``mult`` (L, K//g, N) int8 and ``scale`` =
    s_col (L, N), or with ``mult`` None and ``scale`` = s_eff (K//g, N) at
    L = 1. ``unit``: the K rows one layout block spans; ``extra``: the
    entry's extra ints."""
    layer = int(layer)
    if w_packed.dim() == 4:
        L, NB, K2, bn = w_packed.shape
        N = NB * bn
    else:
        L, K2, N = w_packed.shape
    K = 2 * K2
    dev = w_packed.device
    _build.require(w_packed, "w_packed", torch.int8, w_packed.shape)
    if mult is None:
        _build.require(scale, "s_eff", torch.float32, (K // group_size, N), dev)
    else:
        _build.require(mult, "mult", torch.int8, (L, K // group_size, N), dev)
        _build.require(scale, "s_col", torch.float32, (L, N), dev)
    if group_size % 2 != 0 or K % unit != 0 or not 0 <= layer < L:
        raise ValueError(
            f"dequant kernel needs an even group, K divisible by {unit} and a valid layer "
            f"(K={K}, group={group_size}, layer={layer})"
        )
    out = torch.empty((K, N), dtype=torch.bfloat16, device=dev)
    err = getattr(_build.lib("dequant"), entry)(
        w_packed.data_ptr(), None if mult is None else mult.data_ptr(), scale.data_ptr(),
        out.data_ptr(), K, N, L, layer, group_size, *extra, _build.stream_ptr(dev),
    )
    _build.launch_counts[count] += 1
    _build.check(err, count)
    return out


def dequantize_int4_vertical(w_packed, s_eff, group_size: int = 128, out_dtype=torch.bfloat16):
    """Vertical-layout int4 to dense bf16 (`matmul.py:1511`): the stacked
    kernel at L = 1 with the per-group scales given."""
    if w_packed.device.type == "cpu":
        return dequantize_int4_vertical_reference(w_packed, s_eff, group_size, out_dtype)
    if out_dtype != torch.bfloat16:
        raise ValueError(f"the dequant kernel writes bf16, not {out_dtype}")
    return _dequant("ff_dequant_vertical", "dequant_vertical", w_packed[None], None, s_eff, 0,
                    group_size, group_size)


def dequantize_int4(w_packed, w_scale, group_size: int = 128, offset_binary: bool = False,
                    paired: bool = False):
    """Packed int4 (K//2, N) to dense bf16 (K, N) with per-group scales
    (K//g, N) (`matmul.py:1561`): the paired layout through the stacked
    paired kernel at L = 1, the group-halves layouts (two's complement or
    ``offset_binary``) through their own entry of `csrc/dequant.cu`.
    Bit-exact against `dequantize_int4_reference`."""
    if w_packed.device.type == "cpu":
        return dequantize_int4_reference(w_packed, w_scale, group_size, offset_binary, paired)
    if paired:
        return _dequant("ff_dequant_paired", "dequant_paired", w_packed[None], None, w_scale, 0,
                        group_size, 2 * group_size)
    return _dequant("ff_dequant_halves", "dequant_halves", w_packed[None], None, w_scale, 0,
                    group_size, group_size, int(offset_binary))


def dequantize_int4_vertical_stacked(w_packed, mult, s_col, layer, group_size: int = 512):
    """Layer ``layer`` of stacked vertical W4A4 weights to dense bf16
    (`matmul.py:1736`): ``w_packed`` (L, K//2, N), ``mult`` (L, K//g, N)
    int8, ``s_col`` (L, N); s_eff = f32(mult) * s_col. Bit-exact against the
    JAX package's CPU path (see `csrc/dequant.cu` on the TPU kernel's)."""
    layer = int(layer)
    if w_packed.device.type == "cpu":
        s_eff = mult[layer].float() * s_col[layer].float()[None, :]
        return dequantize_int4_vertical_reference(w_packed[layer], s_eff, group_size)
    return _dequant("ff_dequant_vertical", "dequant_vertical", w_packed, mult, s_col, layer,
                    group_size, group_size)


def dequantize_int4_paired_stacked(w_packed, mult, s_col, layer, group_size: int = 128):
    """Layer ``layer`` of stacked paired W4A8 weights to dense bf16
    (`matmul.py:1650`): shapes as in `dequantize_int4_vertical_stacked`;
    ``w_packed`` flat (L, K//2, N), through ``ff_dequant_paired``
    (``dequant_paired``), or pre-blocked (L, N//bn, K//2, bn)
    (`preblock_stacked`, the branch `:1666-1686`), through
    ``ff_dequant_paired_preblocked`` (``dequant_paired_preblocked``).
    Bit-exact against the JAX package's CPU path, which restores the flat
    form first."""
    layer = int(layer)
    if w_packed.device.type == "cpu":
        s_eff = mult[layer].float() * s_col[layer].float()[None, :]
        return dequantize_int4_paired_reference(flat_layer(w_packed, layer), s_eff, group_size)
    if w_packed.dim() == 4:
        return _dequant("ff_dequant_paired_preblocked", "dequant_paired_preblocked", w_packed,
                        mult, s_col, layer, group_size, 2 * group_size, w_packed.shape[3])
    return _dequant("ff_dequant_paired", "dequant_paired", w_packed, mult, s_col, layer,
                    group_size, 2 * group_size)


def dense_product(xb, w, out_dtype, bias=None):
    """``xb @ w`` of bf16 operands with f32 accumulation, plus ``bias`` in
    f32, rounded once to ``out_dtype`` (XLA's ``jax.lax.dot`` with an f32
    result, `matmul.py:229-232`). A plain large product, left to the
    library: cuBLAS computes a bf16 product in f32 and rounds its bf16
    result once."""
    if bias is None and xb.device.type == "cuda" and out_dtype == torch.bfloat16:
        return torch.matmul(xb, w)
    out = torch.matmul(xb.float(), w.float())
    if bias is not None:
        out = out + bias.float()
    return out.to(out_dtype)


def prefill_product(x_q, x_s, w, out_dtype, bias=None):
    """``bf16(x_q * x_s) @ w`` (`matmul.py:228-232`, `engine.py:115-118`):
    the int8 activations expanded to bf16 against a dequantized weight."""
    xb = (x_q.float() * x_s[:, None]).to(torch.bfloat16)
    return dense_product(xb, w, out_dtype, bias)


# --- Float-scale modes: W8A8, W4A8 and W4A16 (`matmul.py:59-384`, `:1797-1889`)
#
# Their references are float functions, and the port holds the jitted JAX
# ones bit for bit where the kernel is exact in integers: XLA's CPU compiler
# fuses a multiply feeding an add into one fused multiply-add (the W8A8 bias
# epilogue, W4A8's group sum up to 32 groups), and rewrites a longer sum as
# a tree of windows of 32 (`_group_sum`). The plain versions below write
# those orders out.

_SUM_WINDOW = 32  # XLA CPU's tree-reduction window
_STAGE_K = 128  # k a ring stage of the group-halves tensor-core kernels
_MAX_BIG_GROUP = 1 << 16  # the W4A8 GEMV's int32 dot of a group: 16 * 128 * 8 * g < 2^31


def wgmma_group_ok(K: int, group_size: int) -> bool:
    """Whether the group-halves tensor-core kernels (rows 16, 17 and 18t:
    `csrc/w4a8_halves.cu`, `csrc/w4_gemv.cu`, `csrc/w4a16_gemm.cu`; C
    `group_ok`) read x as it lies at group ``group_size`` and depth K: g
    32, 64 or 128, or g = 128 j with j >= 2 up to g = K (a group then spans
    j of their 128-k stages); K a whole number of groups. Every other group
    the reference takes reads x permuted into byte-row order (`permute_x`)."""
    g = group_size
    small = g in (32, 64, 128)
    return (small or (g >= 2 * _STAGE_K and g % _STAGE_K == 0)) and K >= g and K % g == 0


def float_scale_group_ok(K: int, group_size: int) -> bool:
    """Whether the reference takes group ``group_size`` at depth K
    (`pack_int4`'s group halves, `matmul_w4a8_gemv` and `matmul_w4_gemv`
    unroll K // g groups; C `reference_group_ok`): g even, K a whole number
    of groups."""
    g = group_size
    return g >= 2 and g % 2 == 0 and K >= g and K % g == 0


def float_scale_route(K: int, group_size: int, max_group: Optional[int] = None,
                      max_groups: Optional[int] = None) -> str:
    """The route of rows 16, 17 and 18t at group g, chosen by shape; both
    run on the tensor cores. "direct": x read as it lies, where
    `wgmma_group_ok` (and g <= ``max_group``, K / g <= ``max_groups`` where
    given: row 16's int32 group dot and its fold of at most 32 x 32 groups
    on that route); "permuted": x first permuted into byte-row order
    (`permute_x`, one pass a call) and each byte row's scale its group's,
    for every other group the reference takes. Raises for a group the
    reference does not take."""
    if not float_scale_group_ok(K, group_size):
        raise ValueError(f"group {group_size} at K={K}: the reference takes an even group with "
                         f"K a whole number of groups")
    if wgmma_group_ok(K, group_size) and (max_group is None or group_size <= max_group) \
            and (max_groups is None or K // group_size <= max_groups):
        return "direct"
    return "permuted"


def perm_cols(K: int) -> int:
    """Columns of x permuted into byte-row order (C `perm_cols`): K rounded
    up to whole 16-row runs of 32 columns."""
    return -(-K // 32) * 32


def permute_x(x: torch.Tensor, group_size: int) -> torch.Tensor:
    """x (M, K) in byte-row order (`csrc/w4_wgmma.cuh` permute_x_kernel):
    byte row b of `pack_int4`'s group halves (group p = b // h, h = g / 2, i
    = b % h) holds k = p g + i in its low nibble and p g + h + i in its high
    one; columns 32 r .. 32 r + 15 of the result are x at the low-nibble k
    of byte rows 16 r .. 16 r + 15, columns 32 r + 16 .. 32 r + 31 at their
    high-nibble k, zeros past byte row K/2 - 1. The permuted route's stages
    read it as the direct route reads x at g 32."""
    M, K = x.shape
    h, cols = group_size // 2, perm_cols(K)
    b = torch.arange(cols // 2).reshape(-1, 16)  # (runs, 16) byte rows
    k = (b // h) * group_size + b % h
    k = torch.stack([k, k + h], 1).reshape(-1)  # each run: low plane, then high plane
    valid = (b < K // 2).repeat_interleave(2, 0).reshape(-1)
    out = x[:, k.clamp(max=K - 1)]
    return torch.where(valid[None, :].to(x.device), out, torch.zeros_like(out))


def perm_scale_box(K: int, group_size: int) -> int:
    """Scale rows a permuted stage loads (C `perm_scale_box`): a stage of
    64 byte rows starts on a 16-row run, rem = (16 j) % h <= h - gcd(16, h)
    rows into its first group, so it touches at most (h - gcd(16, h) + 63)
    // h + 1 groups; no more than K / g."""
    h = group_size // 2
    return min((h - math.gcd(16, h) + 63) // h + 1, K // group_size)


def perm_scale_bytes(K: int, group_size: int) -> int:
    """Shared bytes of a permuted stage's scale rows: the box rounded up to
    an even row count of 128 f32 (a stage stays on the 128B swizzle's
    1024-byte period)."""
    return -(-perm_scale_box(K, group_size) // 2) * 2 * 128 * 4


def perm_stage_scale_rows(b0: int, K: int, group_size: int) -> torch.Tensor:
    """The scale row (index into w_scale) of each of the 64 byte rows of
    the permuted stage whose first byte row is ``b0`` (`csrc/w4_wgmma.cuh`
    GroupDiv): its first group b0 // h plus (b0 % h + o) // h, clamped to
    the box's last row (only rows past K/2, whose weights arrive as zeros,
    reach past it)."""
    h = group_size // 2
    o = torch.arange(64)
    return b0 // h + torch.clamp((b0 % h + o) // h, max=perm_scale_box(K, group_size) - 1)


def perm_stage_pieces(b0: int, group_size: int, g0: int, g1: int) -> list:
    """The group pieces of the four k32 steps of row 16's permuted stage
    whose first byte row is ``b0`` (`csrc/w4a8_halves.cu`
    w4a8_perm_kernel), for a split over groups [g0, g1): [(step q, group p,
    first row a0, end row a1 of the piece within the step's 16 byte rows,
    whether the piece closes its group)] in the order the kernel takes them."""
    h = group_size // 2
    out = []
    for q in range(4):
        b = b0 + 16 * q
        for p in range(max(b // h, g0), min((b + 15) // h, g1 - 1) + 1):
            out.append((q, p, max(p * h, b) - b, min((p + 1) * h, b + 16) - b,
                        (p + 1) * h <= b + 16))
    return out


def window_tree_sum(terms):
    """Row 16's fold beyond 32 x 32 groups (`csrc/w4a8_halves.cu` Tree, the
    permuted route's kTree) written out in torch: the (..., n) f32 ``terms`` pushed one
    at a time through the oracle's window tree (per level: windows of 32
    after the smaller half of the padding, each summed from +0, a term that
    starts a window sending the closed window's sum up a level; at most 32
    terms on the top level, summed from +0), then every level's last window
    closed. Equals `_window_sum` bit for bit."""
    n = terms.shape[-1]
    lo, top = [], 0
    while n > _SUM_WINDOW:
        windows = -(-n // _SUM_WINDOW)
        lo.append((windows * _SUM_WINDOW - n) // 2)
        n, top = windows, top + 1
    acc = [torch.zeros_like(terms[..., 0]) for _ in range(top + 1)]
    cnt = [0] * (top + 1)

    def push(v, level):
        while True:
            idx = cnt[level]
            cnt[level] += 1
            closes = level < top and idx > 0 and (idx + lo[level]) % _SUM_WINDOW == 0
            up = acc[level]
            acc[level] = (torch.zeros_like(up) if closes else up) + v
            if not closes:
                return
            v, level = up, level + 1

    for i in range(terms.shape[-1]):
        push(terms[..., i], 0)
    for level in range(top):
        push(acc[level], level + 1)
    return acc[top]


def stage_groups(group_size: int) -> tuple:
    """(groups a 128-k stage holds, stages a group spans) of the
    group-halves tensor-core kernels: (128 / g, 1) up to g = 128, (1, g /
    128) above."""
    if group_size <= _STAGE_K:
        return _STAGE_K // group_size, 1
    return 1, group_size // _STAGE_K


def _fma_f32(a, b, c):
    """float32 ``a * b + c`` rounded once, as a fused multiply-add: the
    product is exact in float64; the float64 sum is made round-to-odd from
    its exact error (TwoSum), and a round-to-odd value with 29 spare bits
    rounds to float32 as the exact value would."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    t = s - p
    err = (p - (s - t)) + (c - t)
    bits = s.view(torch.int64)
    even = (err != 0) & ((bits & 1) == 0)
    toward = torch.where((err > 0) == (s > 0), 1, -1)
    return torch.where(even, bits + toward, bits).view(torch.float64).float()


def _window_sum(t):
    """Sum of f32 ``t`` over its last axis as XLA's CPU tree-reduction
    rewrite orders it: up to 32 terms in order from +0; more are padded
    with zeros to a multiple of 32 (the smaller half of the padding in
    front), each window of 32 summed in order, then the window sums the
    same way."""
    n = t.shape[-1]
    if n > _SUM_WINDOW:
        pad = -(-n // _SUM_WINDOW) * _SUM_WINDOW - n
        t = torch.nn.functional.pad(t, (pad // 2, pad - pad // 2))
        t = t.reshape(*t.shape[:-1], -1, _SUM_WINDOW)
    acc = torch.zeros_like(t[..., 0])
    for i in range(t.shape[-1]):
        acc = acc + t[..., i]
    return acc if n <= _SUM_WINDOW else _window_sum(acc)


def _group_sum(gdots, scales):
    """(M, N) f32 ``sum_g f32(gdot_g) * s_g`` in the order of the jitted
    `matmul_w4a8_reference` (`matmul.py:171-173`): up to 32 groups a fused
    multiply-add chain in group order; beyond, rounded products summed by
    `_window_sum`. ``gdots`` yields the (M, N) f32 group dots in order,
    ``scales`` is (G, N) f32."""
    G = scales.shape[0]
    if G <= _SUM_WINDOW:
        acc = None
        for g, gd in enumerate(gdots):
            acc = torch.zeros_like(gd) if acc is None else acc
            acc = _fma_f32(gd, scales[g][None, :].expand_as(gd), acc)
        return acc
    return _window_sum(torch.stack([gd * scales[g][None, :] for g, gd in enumerate(gdots)], -1))


def matmul_w8a8_reference(x_q, x_scale, w_q, w_scale, bias=None, out_dtype=torch.bfloat16):
    """Oracle (`matmul.py:64`): ``f32(x_q @ w_q) * x_scale[:, None] *
    w_scale[None, :]``, left to right, then ``+ bias`` fused into the last
    product (one rounding, as jitted XLA computes it)."""
    out = _int_dot(x_q, w_q) * x_scale.float()[:, None]
    ws = w_scale.float()[None, :].expand_as(out)
    if bias is None:
        out = out * ws
    else:
        out = _fma_f32(out, ws, bias.float()[None, :].expand_as(out))
    return out.to(out_dtype)


def matmul_w8a8(x_q, x_scale, w_q, w_scale, bias=None, out_dtype=torch.bfloat16):
    """W8A8 matmul (`matmul.py:95`): x_q (M, K) int8 with per-row scale
    x_scale (M,) f32, w_q (K, N) int8 with per-column scale w_scale (N,)
    f32, bias (N,) or None; bf16 or f32 out. On CUDA `csrc/w8a8_gemm.cu`
    (int8 wgmma, the weights transposed into its register operand; any M,
    the decode's and the prefill's, planned by `w8a8_plan`), bit-exact
    against `matmul_w8a8_reference`."""
    if x_q.device.type == "cpu":
        return matmul_w8a8_reference(x_q, x_scale, w_q, w_scale, bias, out_dtype)
    M, K = x_q.shape
    N = w_q.shape[1]
    dev = x_q.device
    _build.require(x_q, "x_q", torch.int8, (M, K))
    _build.require(x_scale, "x_scale", torch.float32, (M,), dev)
    _build.require(w_q, "w_q", torch.int8, (K, N), dev)
    _build.require(w_scale, "w_scale", torch.float32, (N,), dev)
    if bias is not None:
        bias = _aligned16(bias.float().contiguous())
        _build.require(bias, "bias", torch.float32, (N,), dev)
    if out_dtype not in (torch.float32, torch.bfloat16) or M < 1 or K % 16 != 0 or N % 4 != 0:
        raise ValueError(f"W8A8 GEMM kernel needs f32 or bf16 out, M >= 1, K % 16 == 0 and "
                         f"N % 4 == 0 (out={out_dtype}, M={M}, K={K}, N={N})")
    plan = w8a8_plan(M, K, N)
    # x reaches the kernel through a tensor map; the split epilogue reads
    # w_scale and bias four at a time
    x_q, w_scale = _aligned16(x_q), _aligned16(w_scale)
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    err = _build.lib("w8a8_gemm").ff_w8a8_gemm(
        x_q.data_ptr(), x_scale.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(), M, K, N,
        int(out_dtype == torch.bfloat16), plan.n, plan.n_split, plan.depth, plan.group_m,
        _build.stream_ptr(dev),
    )
    _build.launch_counts["w8a8_gemm"] += 1
    _build.check(err, "w8a8_gemm")
    return out


def matmul_w4a8_reference(x_q, x_scale, w_packed, w_scale, bias=None, group_size: int = 128,
                          out_dtype=torch.bfloat16):
    """Oracle (`matmul.py:159`): per-group int32 dots of x_q (M, K) against
    two's-complement group-halves nibbles (K//2, N), each times its group
    scale w_scale (K//g, N) f32, summed over groups in the jitted order
    (`_group_sum`), times x_scale (with ``bias``: fused with the add)."""
    M, K = x_q.shape
    N = w_packed.shape[1]
    G = K // group_size
    w = unpack_int4(w_packed, group_size).double().reshape(G, group_size, N)
    xg = x_q.double().reshape(M, G, group_size)
    acc = _group_sum(((xg[:, g] @ w[g]).float() for g in range(G)), w_scale.float())
    xs = x_scale.float()[:, None].expand_as(acc)
    if bias is None:
        out = acc * xs
    else:
        out = _fma_f32(acc, xs, bias.float()[None, :].expand_as(acc))
    return out.to(out_dtype)


def matmul_w4a8_gemv(x_q, x_scale, w_packed, w_scale, group_size: int = 128,
                     out_dtype=torch.bfloat16):
    """Decode-shaped W4A8 with float per-group scales (`matmul.py:341`):
    x_q (M, K) int8, x_scale (M,) f32, w_packed (K//2, N) `pack_int4`
    layout, w_scale (K//g, N) f32; bf16 or f32 out. On CUDA
    `csrc/w4a8_halves.cu` (int8 wgmma, each group's dot folded in the
    oracle's order; rows, K splits at window boundaries, the fold and the
    route from `w4a8_plan`: at groups `wgmma_group_ok` does not take, more
    than 32 x 32 groups or g above 2^16, x is first permuted into byte-row
    order, `permute_x`, in the same call), bit-exact against
    `matmul_w4a8_reference`."""
    if x_q.device.type == "cpu":
        return matmul_w4a8_reference(x_q, x_scale, w_packed, w_scale, None, group_size, out_dtype)
    M, K = x_q.shape
    N = w_packed.shape[1]
    dev = x_q.device
    _check_gemv(x_q, x_scale, K, N, group_size)
    _build.require(w_packed, "w_packed", torch.int8, (K // 2, N), dev)
    _build.require(w_scale, "w_scale", torch.float32, (K // group_size, N), dev)
    if out_dtype not in (torch.float32, torch.bfloat16) \
            or not float_scale_group_ok(K, group_size) or M > GEMV_MAX_M:
        raise ValueError(
            f"W4A8 halves GEMV kernel needs f32 or bf16 out, an even group with K a whole "
            f"number of groups and M <= {GEMV_MAX_M} (out={out_dtype}, group={group_size}, "
            f"K={K}, M={M})"
        )
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    plan = w4a8_plan(M, K, N, group_size)
    xp = torch.empty((M, perm_cols(K)), dtype=torch.int8, device=dev) if plan.permuted else None
    x_q, w_scale = _aligned16(x_q), _aligned16(w_scale)  # both reach the kernel through tensor maps
    err = _build.lib("w4a8_halves").ff_w4a8_gemv_halves(
        x_q.data_ptr(), x_scale.data_ptr(), w_packed.data_ptr(), w_scale.data_ptr(),
        out.data_ptr(), None if xp is None else xp.data_ptr(), M, K, N, group_size,
        int(out_dtype == torch.bfloat16), plan.n, plan.row_blocks, plan.n_split,
        W4A8_FOLDS.index(plan.fold), plan.depth, _build.stream_ptr(dev),
    )
    _build.launch_counts["w4a8_gemv_halves"] += 1
    _build.check(err, "w4a8_gemv_halves")
    return out


def matmul_w4a8(x_q, x_scale, w_packed, w_scale, bias=None, group_size: int = 128,
                out_dtype=torch.bfloat16):
    """Per-group W4A8 matmul under the JAX package's TPU routing
    (`matmul.py:193`): up to `GEMV_MAX_M` rows `matmul_w4a8_gemv`; more
    rows dequantize the weight to bf16 and take `prefill_product`."""
    if x_q.shape[0] <= GEMV_MAX_M:
        out = matmul_w4a8_gemv(x_q, x_scale, w_packed, w_scale, group_size, out_dtype)
        if bias is not None:
            out = (out.float() + bias.float()).to(out_dtype)
        return out
    w = dequantize_int4(w_packed, w_scale, group_size)
    return prefill_product(x_q, x_scale, w, out_dtype, bias)


# The int8 wgmma kernels of rows 19 and 16 (csrc/int8_wgmma.cuh): _I8_BN
# weight columns a block, _I8_BK k a ring stage (one x box of 128 bytes a
# token row), a block's token rows rounded up to one of _I8_TILES (wgmma's
# n). The W8A8 GEMM's stage holds 128 weight rows, the W4A8 GEMV's 64
# packed byte rows and up to 4 scale rows.
_I8_BN, _I8_BK, _I8_MAX_DEPTH = 128, 128, 8
_I8_TILES = (8, 16, 32, 48, 64, 96, 128, 192)
_I8_RED_PITCH = _I8_BN + 8  # 4-byte words a token row of the split reduction tile


def i8_tile(rows: int) -> int:
    """wgmma's n for ``rows`` token rows (`csrc/int8_wgmma.cuh` tile_n)."""
    return next(t for t in _I8_TILES if rows <= t)


def _i8_smem(n, depth, stage_bytes, n_split):
    red = n * _I8_RED_PITCH * 4 if n_split > 1 else 0
    return max(depth * stage_bytes, red) + 16 * depth + 1024


def _i8_depth(stage_bytes, most, per_sm, n, n_split, what):
    """The deepest ring (at most `_I8_MAX_DEPTH` stages, no more than a
    split streams) that fits the block's share of an SM; two stages where
    a split streams two or more."""
    budget = _SM_SMEM // per_sm - _BLOCK_RESERVED
    depth = min(_I8_MAX_DEPTH, most, (budget - 1024) // (stage_bytes + 16))
    if depth < min(2, most) or _i8_smem(n, depth, stage_bytes, n_split) > budget:
        raise ValueError(f"the {what} ring has no room (n={n}, depth={depth})")
    return depth


class W8A8Plan(NamedTuple):
    """The launch plan of the W8A8 GEMM (`csrc/w8a8_gemm.cu`): the token
    rows of a tile (wgmma's n: M rounded up by `i8_tile` up to 192 rows,
    128 for 193-256, 192 above), the blocks an SM holds (two up to n =
    64), the row and column tiles, the 128-k stages of K, the K splits (the
    blocks of a cluster), the stages a split streams (the last split
    fewer), the ring's depth and the row tiles of a visiting group."""
    n: int
    per_sm: int
    m_tiles: int
    n_tiles: int
    stages: int
    n_split: int
    sps: int
    depth: int
    group_m: int

    @property
    def stage_bytes(self) -> int:
        return self.n * _I8_BK + _I8_BK * _I8_BN

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory of a block: the ring (or the reduction
        tile of a split, which reuses it), its barriers, the alignment
        slack."""
        return _i8_smem(self.n, self.depth, self.stage_bytes, self.n_split)

    def stage_ranges(self):
        """[(first stage, end stage)] of each split, in split order."""
        return [(z * self.sps, min(self.stages, (z + 1) * self.sps)) for z in range(self.n_split)]


def _split_choice(tiles, stages, per_sm, n_split):
    """(splits, stages a split) of 1-8 K splits over whole stages, none
    empty, for ``tiles`` column (and row) tiles: the least (waves of
    clusters, at `W4_CLUSTERS` of them at once) x (stages a block +
    `_W4_BLOCK_COST`), fewer splits on a tie; or about ``n_split`` where
    given (the W4 GEMV's and the W8A8 GEMM's plans)."""
    options = {}
    for s in range(1, min(_W4_MAX_SPLIT, stages) + 1):
        sps = -(-stages // s)
        splits = -(-stages // sps)
        waves = -(-tiles // W4_CLUSTERS[per_sm][splits - 1])
        options[splits] = (waves * (sps + _W4_BLOCK_COST), splits, sps)
    best = min(options.values())
    if n_split is not None:
        best = options[max(k for k in options if k <= max(1, n_split))]
    return best[1], best[2]


@functools.lru_cache(maxsize=256)
def w8a8_plan(M: int, K: int, N: int, n_split: Optional[int] = None) -> W8A8Plan:
    """Plan of the W8A8 GEMM. Up to 192 rows every token row is on
    wgmma's n side (one row tile, each weight byte read once a call); up to
    `GEMV_MAX_M` two row tiles of 128; above, row tiles of 192 (the
    kernel's largest n, `csrc/int8_wgmma.cuh` kMaxRows). K splits as
    `_split_choice` picks (about ``n_split`` where given); the row tiles of
    a group keep the group's x tiles within 16 MB of L2."""
    if M < 1 or K < 16 or K % 16 or N < 4 or N % 4:
        raise ValueError(f"no W8A8 GEMM plan for M={M}, K={K}, N={N} (K % 16, N % 4)")
    n = i8_tile(M) if M <= _I8_TILES[-1] else 128 if M <= GEMV_MAX_M else _I8_TILES[-1]
    per_sm = 2 if n <= 64 else 1
    m_tiles, n_tiles, stages = -(-M // n), -(-N // _I8_BN), -(-K // _I8_BK)
    splits, sps = _split_choice(m_tiles * n_tiles, stages, per_sm, n_split)
    group_m = max(1, min(16, (16 << 20) // (n * K)))
    plan = W8A8Plan(n, per_sm, m_tiles, n_tiles, stages, splits, sps, 1, group_m)
    return plan._replace(depth=_i8_depth(plan.stage_bytes, sps, per_sm, n, splits, "W8A8 GEMM"))


# How the W4A8 GEMV's block folds its group dots (`csrc/w4a8_halves.cu`
# kChain, kWindowSplit, kMulti, kTree): up to 32 groups one fused
# multiply-add chain (K unsplit); 33-256 groups one window's rounded
# products a block, window z in split z of a cluster, the window sums added
# in order through distributed shared memory; up to 32 x 32 groups every
# window in one block; beyond, the oracle's deeper window tree in one block
# (the permuted route).
W4A8_FOLDS = ("chain", "window", "multi", "tree")
# Token rows a block of the W4A8 GEMV holds by its sums' registers: the
# chain and window folds, every window (a third set), the window tree (four
# levels up to 32^4 groups; 8 rows beyond, six levels: up to 32^6 = 2^30
# groups, every K below 2^31), and at a group above 2^16 (its int64 dot
# beside the int32 one) at most 32, the tree 8.
_W4A8_ROWS = {"chain": 96, "window": 96, "multi": 64, "tree": 16}
_W4A8_WIDE_ROWS = {"chain": 32, "window": 32, "multi": 32, "tree": 8}
_W4A8_DEEP_ROWS = 8
_W4A8_TREE_LEVELS = 6


class W4A8Plan(NamedTuple):
    """The launch plan of the W4A8 GEMV (`csrc/w4a8_halves.cu`): the fold
    (`W4A8_FOLDS`), wgmma's n, the token rows of a row block and the row
    blocks, the blocks an SM holds (two up to n = 32), the column blocks,
    the K splits (window splits only), the first window's shortening, the
    stages of the longest split and the ring's depth."""
    fold: str
    n: int
    rows: int
    row_blocks: int
    per_sm: int
    n_tiles: int
    n_split: int
    lo: int
    stages: int
    depth: int
    permuted: bool = False  # x in byte-row order (`float_scale_route` "permuted")
    scale_bytes: int = _I8_BK // 32 * _I8_BN * 4  # a stage's scale rows

    @property
    def stage_bytes(self) -> int:
        return self.n * _I8_BK + _I8_BK // 2 * _I8_BN + self.scale_bytes

    @property
    def smem_bytes(self) -> int:
        return _i8_smem(self.n, self.depth, self.stage_bytes, self.n_split)

    def group_ranges(self, n_groups: int):
        """[(first group, end group)] of each split, in split order: the
        windows of the oracle's sum where K is split, else every group."""
        if self.fold != "window":
            return [(0, n_groups)]
        return [(max(0, _SUM_WINDOW * z - self.lo), min(n_groups, _SUM_WINDOW * (z + 1) - self.lo))
                for z in range(self.n_split)]


@functools.lru_cache(maxsize=256)
def w4a8_plan(M: int, K: int, N: int, group_size: int) -> W4A8Plan:
    """Plan of the W4A8 GEMV at M <= 256 token rows, at every group the
    reference takes. The fold follows the group count G = K / g
    (`W4A8_FOLDS`): K is split only at the windows of the oracle's sum,
    ceil(G / 32) splits for 33-256 groups, none otherwise. The route
    (`float_scale_route`): x as it lies at the groups `wgmma_group_ok`
    takes up to g = 2^16 and 32 x 32 groups, a group of g = 128 j (j >= 2)
    spanning j stages (`stage_groups`), so every split starts on a stage
    boundary; else x in byte-row order (`permute_x`), a split starting on
    the 16-row run of its first byte row, and the scale rows of every group
    a stage touches (`perm_scale_bytes`). A block holds at most
    `_W4A8_ROWS` token rows (`_W4A8_DEEP_ROWS` beyond 32^4 groups, no more
    than `_W4A8_WIDE_ROWS` above g = 2^16), so more rows take more row
    blocks; of one to two times the fewest row blocks it takes the least
    (waves of clusters) x (wgmma's n + 32), fewer row blocks on a tie
    (narrow projections split their rows to fill the card)."""
    if not 1 <= M <= GEMV_MAX_M or not float_scale_group_ok(K, group_size) or N < 4 or N % 4:
        raise ValueError(f"no W4A8 GEMV plan for M={M}, K={K}, N={N}, group={group_size}")
    G = K // group_size
    windows = -(-G // _SUM_WINDOW)
    if G > _SUM_WINDOW ** _W4A8_TREE_LEVELS:
        raise ValueError(f"the W4A8 GEMV sums at most {_SUM_WINDOW ** _W4A8_TREE_LEVELS} groups "
                         f"(G={G})")
    permuted = float_scale_route(K, group_size, _MAX_BIG_GROUP, _SUM_WINDOW ** 2) == "permuted"
    fold = "chain" if G <= _SUM_WINDOW else "window" if windows <= _W4_MAX_SPLIT \
        else "multi" if windows <= _SUM_WINDOW else "tree"
    n_split = windows if fold == "window" else 1
    lo = (windows * _SUM_WINDOW - G) // 2
    plan = W4A8Plan(fold, 0, 0, 0, 0, -(-N // _I8_BN), n_split, lo, 0, 1, permuted)
    if permuted:
        h = group_size // 2
        plan = plan._replace(scale_bytes=perm_scale_bytes(K, group_size))
        stages = max(-(-(-(-g1 * h // 16) - g0 * h // 16) // 4) for g0, g1 in plan.group_ranges(G))
    else:
        gps, spg = stage_groups(group_size)
        stages = max(-(-(g1 - g0) // gps) * spg for g0, g1 in plan.group_ranges(G))
    most = _W4A8_DEEP_ROWS if G > _SUM_WINDOW ** 4 else _W4A8_ROWS[fold]
    if group_size > _MAX_BIG_GROUP:
        most = min(most, _W4A8_WIDE_ROWS[fold])
    fewest = -(-M // most)
    best = None
    for rb in range(fewest, 2 * fewest + 1):
        rows = -(-M // rb)
        if (rb - 1) * rows >= M:  # a row block would be empty
            continue
        n = i8_tile(rows)
        per_sm = 2 if n <= 32 else 1
        waves = -(-plan.n_tiles * rb // W4_CLUSTERS[per_sm][n_split - 1])
        cost = waves * (n + 32)
        if best is None or cost < best[0]:
            best = (cost, n, rows, rb, per_sm)
    _, n, rows, rb, per_sm = best
    plan = plan._replace(n=n, rows=rows, row_blocks=rb, per_sm=per_sm, stages=stages)
    return plan._replace(depth=_i8_depth(plan.stage_bytes, stages, per_sm, n, n_split,
                                         "W4A8 GEMV"))


def _byte_perm(x, y, sel: int):
    """CUDA's __byte_perm on int64 tensors of 32-bit words: byte i of the
    result is byte (sel >> 4i) & 7 of the 8 bytes (y << 32) | x."""
    both = ((y & 0xFFFFFFFF) << 32) | (x & 0xFFFFFFFF)
    out = torch.zeros_like(both)
    for i in range(4):
        out |= ((both >> (8 * ((sel >> (4 * i)) & 7))) & 0xFF) << (8 * i)
    return out


def i8_operand_words(rows: torch.Tensor) -> torch.Tensor:
    """The register words the int8 wgmma kernels (`csrc/int8_wgmma.cuh`
    lane_of, col_words) build from a stage's weight rows: ``rows`` (R, 128)
    int8 (R % 32 == 0: k rows of W8A8, packed byte rows of W4A8) laid out
    as TMA's 128B swizzle lands them; each warp's lane L addresses row L % 8
    of matrix L // 8 of an ldmatrix.x4.trans over a 32-row run (a column
    pair as one 16-bit element), thread 4 gid + tid receives matrix rows 2
    tid, 2 tid + 1 of pair gid, and two byte permutes a matrix pair give its
    columns' words. Returns (R // 16, 128, 4) int64: [b, c, tid] the word of
    column c over rows 16 b + 4 tid .. + 3, the lowest row in the lowest
    byte."""
    R = rows.shape[0]
    image = torch.zeros(R * _I8_BN, dtype=torch.int64)
    r = torch.arange(R)[:, None]
    c = torch.arange(_I8_BN)[None, :]
    image[r * _I8_BN + (((c // 16) ^ (r % 8)) * 16) + c % 16] = rows.to(torch.int64) & 0xFF
    lane = torch.arange(32)
    lr, lj = lane % 8, lane // 8
    k = 16 * (lj // 2) + 4 * (lr // 2) + 2 * ((lj % 2) ^ (lr // 4)) + lr % 2  # each lane's row
    out = torch.zeros((R // 16, _I8_BN, 4), dtype=torch.int64)
    for run in range(R // 32):
        for chunk in range(_I8_BN // 16):
            # the 16 bytes each lane addresses: row k of the run, the chunk swizzled
            at = (32 * run + k) * _I8_BN + ((chunk ^ (k & 7)) << 4)
            lines = image[at[:, None] + torch.arange(16)[None, :]]  # (lane, 16)
            elem = lines[:, 0::2] | (lines[:, 1::2] << 8)  # (lane, pair): 16-bit elements
            mat = elem.reshape(4, 8, 8)  # [matrix j, row, pair]
            for gid in range(8):
                cb = 16 * chunk + 2 * gid
                for tid in range(4):
                    m = mat[:, 2 * tid, gid] | (mat[:, 2 * tid + 1, gid] << 16)
                    lo, hi = (0x2064, 0x3175) if tid & 2 else (0x6420, 0x7531)
                    for h in range(2):
                        out[2 * run + h, cb, tid] = _byte_perm(m[2 * h], m[2 * h + 1], lo)
                        out[2 * run + h, cb + 1, tid] = _byte_perm(m[2 * h], m[2 * h + 1], hi)
    return out


def _slot_bytes(w0, w1):
    """(128, 32) signed bytes of a step's slots from its two register
    words per (column, tid): slot 4 tid + i is byte i of ``w0``, slot 16 +
    4 tid + i byte i of ``w1``."""
    shifts = torch.arange(4) * 8
    b0 = (w0[..., None] >> shifts) & 0xFF  # (128, tid, i)
    b1 = (w1[..., None] >> shifts) & 0xFF
    out = torch.cat([b0.reshape(-1, 16), b1.reshape(-1, 16)], -1)
    return torch.where(out >= 128, out - 256, out)


def w4a8_step_operands(words: torch.Tensor, group_size: int) -> list:
    """The A operand of each k32 step of a W4A8 GEMV stage
    (`csrc/w4a8_halves.cu` step_regs, step_k) from its 64 byte rows'
    `i8_operand_words` (4, 128, 4): [(group q, the step's first k in the
    stage, (128, 32) the signed byte of each column at each of the step's
    32 k)], each 16 v of the weight there (the low nibble shifted up, the
    high one masked in place)."""
    lo = lambda w: (w << 4) & 0xF0F0F0F0  # noqa: E731
    hi = lambda w: w & 0xF0F0F0F0  # noqa: E731
    steps = []
    for q in range(_I8_BK // group_size):
        for t in range(group_size // 32):
            if group_size == 32:
                w0, w1, k = lo(words[q]), hi(words[q]), 32 * q
            else:
                b = 2 * q if group_size == 64 else 2 * (t % 2)
                plane = hi if (t == 1 if group_size == 64 else t >= 2) else lo
                w0, w1 = plane(words[b]), plane(words[b + 1])
                k = 64 * q + 32 * t if group_size == 64 else 64 * (t // 2) + 32 * (t % 2)
            steps.append((q, k, _slot_bytes(w0, w1)))
    return steps


def _fold_terms(plan: W4A8Plan, gd, s, G):
    """(M, N) f32 sum of the group products gd[g] * s[g] under the plan's
    fold (`W4A8_FOLDS`): one fused multiply-add chain from +0; each split's
    window of rounded products from +0, then the window sums in window
    order from +0; the closed windows' sum plus the open window's (every
    window in one block); the window tree (`window_tree_sum`)."""
    zero = torch.zeros_like(gd[0])
    if plan.fold == "chain":
        acc = zero
        for g in range(G):
            acc = _fma_f32(gd[g], s[g].expand_as(acc), acc)
    elif plan.fold == "window":
        acc = zero
        for g0, g1 in plan.group_ranges(G):
            w = zero
            for g in range(g0, g1):
                w = w + gd[g] * s[g]
            acc = acc + w
    elif plan.fold == "multi":
        acc, w = zero, zero
        for g in range(G):
            if g > 0 and (g + plan.lo) % _SUM_WINDOW == 0:
                acc, w = acc + w, zero
            w = w + gd[g] * s[g]
        acc = acc + w
    else:
        acc = window_tree_sum(torch.stack([gd[g] * s[g] for g in range(G)], -1))
    return acc


def w4a8_split_fold(x_q, x_scale, w_packed, w_scale, group_size: int, out_dtype,
                    plan: Optional[W4A8Plan] = None):
    """The W4A8 GEMV's arithmetic (`csrc/w4a8_halves.cu`) written out in
    torch under ``plan`` (default `w4a8_plan`): per output the int32 group
    dots, folded per the plan's fold (`_fold_terms`), times x_scale."""
    M, K = x_q.shape
    N = w_packed.shape[1]
    G = K // group_size
    plan = plan or w4a8_plan(M, K, N, group_size)
    v = unpack_int4(w_packed, group_size).double().reshape(G, group_size, N)
    xg = x_q.double().reshape(M, G, group_size)
    gd = [(xg[:, g] @ v[g]).float() for g in range(G)]
    acc = _fold_terms(plan, gd, w_scale.float(), G)
    return (acc * x_scale.float()[:, None]).to(out_dtype)


def w4a8_perm_fold(x_q, x_scale, w_packed, w_scale, group_size: int, out_dtype,
                   plan: Optional[W4A8Plan] = None):
    """Row 16's permuted route (`csrc/w4a8_halves.cu` w4a8_perm_kernel)
    written out in torch under ``plan`` (default `w4a8_plan`): x permuted
    into byte-row order (`permute_x`); each split's stages of 64 byte rows
    from the 16-row run of its first group's first byte row; each stage's
    k32 steps (16 byte rows: slots 0-15 their low nibbles, 16-31 their high
    nibbles, 16 v each) cut into group pieces (`perm_stage_pieces`), each
    piece's int32 product with the other groups' bytes masked to zero added
    to its group's dot (an int64 sum of per-stage int32 partials, as WIDE
    widens them); each closed group's dot, as a float, folded with its
    scale from the stage's scale rows in group order under the plan's fold;
    the window sums added in split order; times x_scale."""
    M, K = x_q.shape
    N = w_packed.shape[1]
    G, h = K // group_size, group_size // 2
    plan = plan or w4a8_plan(M, K, N, group_size)
    # int64 values as float64: every partial sum is an integer below 2^53,
    # so the products are exact (and take the BLAS path)
    xp = permute_x(x_q, group_size).double()
    w = w_packed.to(torch.int64)
    rows = K // 2
    s = w_scale.float()
    gd = [None] * G
    for g0, g1 in plan.group_ranges(G):
        r0, r1 = g0 * h // 16, -(-g1 * h // 16)
        dots = {}
        for st in range(-(-(r1 - r0) // 4)):
            b0 = 16 * r0 + 64 * st
            part = {}
            for q, p, a0, a1, closes in perm_stage_pieces(b0, group_size, g0, g1):
                b = b0 + 16 * q
                byte = torch.zeros((16, N), dtype=torch.int64)
                n_in = max(0, min(16, rows - b))
                byte[:n_in] = w[b:b + n_in]
                keep = torch.zeros((16, 1), dtype=torch.int64)
                keep[a0:a1] = 1
                lo = (((byte << 4) & 0xF0) ^ 0x80) - 0x80  # 16 v of the low nibbles
                hi = ((byte & 0xF0) ^ 0x80) - 0x80  # 16 v of the high nibbles
                step = torch.cat([lo * keep, hi * keep], 0).double()  # (32 slots, N)
                prod = xp[:, 32 * (b // 16):32 * (b // 16) + 32] @ step
                assert prod.abs().max() < 2 ** 31  # the step's int32 product
                part[p] = part.get(p, 0) + prod
                if closes:  # its scale: row p - b0 // h of the stage's box
                    assert p - b0 // h < perm_scale_box(K, group_size)
                    total = dots.pop(p, 0) + part.pop(p)
                    gd[p] = (total / 16).float()
            for p, v in part.items():  # the open group's stage partial, widened
                dots[p] = dots.get(p, 0) + v
    acc = _fold_terms(plan, gd, s, G)
    return (acc * x_scale.float()[:, None]).to(out_dtype)


def w4_perm_product(x, w_packed, w_scale, group_size: int, tiled: bool = False):
    """Rows 17 and 18t's permuted route (`csrc/w4_gemv.cu`,
    `csrc/w4_wgmma.cuh` with PERM) written out in torch, f32: x permuted
    into byte-row order (`permute_x`); each 128-k stage s of it (byte rows
    64 s .. 64 s + 63) times its byte rows' weights, each byte row
    dequantized with the scale row its stage gives it
    (`perm_stage_scale_rows`): row 17 bf16(f32(v) s), 18t (``tiled``)
    bf16(bf16(v) bf16(s)); the stages summed in order."""
    M, K = x.shape
    N = w_packed.shape[1]
    xp = permute_x(x.to(torch.bfloat16), group_size).float()
    xp = torch.nn.functional.pad(xp, (0, -(-K // 128) * 128 - xp.shape[1]))  # TMA's zeros
    rows = K // 2
    w = w_packed.to(torch.int32)
    s = w_scale.float()
    acc = torch.zeros((M, N), dtype=torch.float32)
    for st in range(-(-K // 128)):
        b0 = 64 * st
        n_in = max(0, min(64, rows - b0))
        byte = torch.zeros((64, N), dtype=torch.int32)
        byte[:n_in] = w[b0:b0 + n_in]
        lo = (((byte & 0xF) ^ 8) - 8).float()
        hi = (byte >> 4).float()
        sc = s[perm_stage_scale_rows(b0, K, group_size).clamp(max=s.shape[0] - 1)]
        if tiled:
            sc = sc.to(torch.bfloat16).float()
        dq = [(v * sc).to(torch.bfloat16).float() for v in (lo, hi)]
        xs = xp[:, 2 * b0:2 * b0 + 128].reshape(M, 4, 2, 16)  # runs of (low plane, high plane)
        for q in range(4):
            acc = acc + xs[:, q, 0] @ dq[0][16 * q:16 * q + 16] + xs[:, q, 1] @ dq[1][16 * q:16 * q + 16]
    return acc


def matmul_w4a16_reference(x, w_packed, w_scale, bias=None, group_size: int = 128,
                           out_dtype=None):
    """Oracle (`matmul.py:1797`): the weight dequantized in f32 and rounded
    to x's dtype, ``x @ w`` in x's dtype (a bf16 x gives bf16 logits)."""
    w = dequantize_int4_reference(w_packed, w_scale, group_size).to(x.dtype)
    out = x @ w
    if bias is not None:
        out = out + bias
    return out.to(out_dtype or x.dtype)


def matmul_w4_gemv_reference(x, w_packed, w_scale, group_size: int = 128,
                             out_dtype=torch.bfloat16):
    """Plain version of `matmul_w4_gemv`: ``bf16(x) @ dequantize_int4(w)``
    in f32, rounded once to ``out_dtype``."""
    w = dequantize_int4_reference(w_packed, w_scale, group_size)
    return torch.matmul(x.to(torch.bfloat16).float(), w.float()).to(out_dtype)


# The wgmma W4 GEMV (csrc/w4_gemv.cu): _W4_BN weight columns a block, _W4_BK
# k a ring stage (its x boxes, _W4_BK / 2 packed byte rows and up to
# _W4_BK / 32 scale rows), K split over at most _W4_MAX_SPLIT blocks of a
# cluster, token rows up to GEMV_MAX_M.
_W4_BN, _W4_BK, _W4_MAX_SPLIT, _W4_MAX_DEPTH = 128, 128, 8, 8
# Clusters of 1-8 blocks the H100 runs at once at one and at two blocks an
# SM (cudaOccupancyMaxActiveClusters at this kernel's shared memory, which
# chip_smoke.py logs from `ff_w4_gemv_clusters` beside this table): its 132
# SMs lie in GPCs, and a cluster must fit in one, so larger clusters leave
# SMs idle.
W4_CLUSTERS = {1: (132, 66, 39, 30, 22, 17, 15, 15), 2: (264, 132, 79, 62, 47, 39, 32, 30)}
# A block's fixed cost in stages of its stream: the ring's fill, the
# cluster's reduction through distributed shared memory.
_W4_BLOCK_COST = 3
_W4_RED_PITCH = _W4_BN + 8  # floats a token row of the reduction tile
# Shared memory of one H100 SM, and what each of its blocks reserves.
_SM_SMEM, _BLOCK_RESERVED = 233472, 1024


class W4Plan(NamedTuple):
    """The launch plan of the wgmma W4 GEMV (`csrc/w4_gemv.cu`): the wgmma n
    (M rounded up to 8, 16, 32, 64, 128, 192 or 256: the token rows of the
    x boxes, those past M arriving as zeros), the blocks an SM
    holds (its launch bounds: two up to n = 64), the 128-column blocks, the
    128-k stages of K, the K splits (the blocks of a cluster), the stages a
    split streams (the last split fewer) and the ring's depth."""
    n: int
    per_sm: int
    n_tiles: int
    stages: int
    n_split: int
    sps: int
    depth: int
    permuted: bool = False  # x in byte-row order (`float_scale_route` "permuted")
    scale_bytes: int = _W4_BK // 32 * _W4_BN * 4  # a stage's scale rows

    @property
    def stage_bytes(self) -> int:
        return 2 * self.n * 128 + _W4_BK // 2 * _W4_BN + self.scale_bytes

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory of a block: the ring (or the reduction
        tile, which reuses it), its barriers and the alignment slack."""
        red = self.n * _W4_RED_PITCH * 4
        return max(self.depth * self.stage_bytes, red) + 16 * self.depth + 1024

    @property
    def blocks(self) -> int:
        return self.n_tiles * self.n_split

    def stage_ranges(self):
        """[(first stage, end stage)] of each split, in split order."""
        return [(z * self.sps, min(self.stages, (z + 1) * self.sps)) for z in range(self.n_split)]


@functools.lru_cache(maxsize=256)
def w4_plan(M: int, K: int, N: int, group_size: int, n_split: Optional[int] = None) -> W4Plan:
    """Plan of the wgmma W4 GEMV at M <= 256 token rows, at every group the
    reference takes: the route (`float_scale_route`: x as it lies, or
    permuted into byte-row order with the scale rows of every group a stage
    touches, `perm_scale_bytes`), the wgmma n, then the K split over whole
    128-k stages (whole groups at g 32, 64, 128; at g = 128 j a j-th of a
    group; on the permuted route any 64 byte rows), no split empty, the
    splits of a column block one cluster. Of 1-8 splits it takes the least of (waves of clusters, at `W4_CLUSTERS` of them at
    once) x (stages a block + `_W4_BLOCK_COST`), fewer splits on a tie (or
    about ``n_split`` splits where given: the card tests and A/Bs take
    others); then the deepest ring that fits (at least two stages where a
    split has two)."""
    if not 1 <= M <= GEMV_MAX_M or not float_scale_group_ok(K, group_size):
        raise ValueError(f"no W4 GEMV plan for M={M}, K={K}, group={group_size}")
    n = next(t for t in (8, 16, 32, 64, 128, 192, 256) if M <= t)
    per_sm = 2 if n <= 64 else 1
    n_tiles, stages = -(-N // _W4_BN), -(-K // _W4_BK)
    n_split, sps = _split_choice(n_tiles, stages, per_sm, n_split)
    plan = W4Plan(n, per_sm, n_tiles, stages, n_split, sps, 1)
    if float_scale_route(K, group_size) == "permuted":
        plan = plan._replace(permuted=True, scale_bytes=perm_scale_bytes(K, group_size))
    budget = _SM_SMEM // per_sm - _BLOCK_RESERVED
    depth = min(_W4_MAX_DEPTH, sps, (budget - 1024) // (plan.stage_bytes + 16))
    plan = plan._replace(depth=depth)
    if depth < min(2, sps) or plan.smem_bytes > budget:
        raise ValueError(f"the W4 GEMV ring has no room at M={M} ({plan})")
    return plan


def matmul_w4_gemv(x, w_packed, w_scale, group_size: int = 128, out_dtype=torch.bfloat16):
    """Decode-shaped weight-only int4 matmul (`matmul.py:262`): bf16 x (M,
    K) against the `pack_int4` weight (K//2, N) dequantized to bf16 with
    w_scale (K//g, N), f32 accumulation, rounded once to ``out_dtype``. The
    dequant rounds once, as `dequantize_int4`'s CPU path (the TPU kernel
    rounds the scale to bf16 first). On CUDA `csrc/w4_gemv.cu` for M up to
    `GEMV_MAX_M` (bf16 wgmma, each weight dequantized once a call as
    `w4_gemv_dequant_words` mirrors, K split by `w4_plan` and the splits
    added in split order; at groups `wgmma_group_ok` does not take, x is
    first permuted into byte-row order, `permute_x`, in the same call); its
    sums run in another order than the plain version's, the same bits call
    to call."""
    if x.device.type == "cpu":
        return matmul_w4_gemv_reference(x, w_packed, w_scale, group_size, out_dtype)
    M, K = x.shape
    N = w_packed.shape[1]
    dev = x.device
    _build.require(x, "x", torch.bfloat16, (M, K))
    _build.require(w_packed, "w_packed", torch.int8, (K // 2, N), dev)
    _build.require(w_scale, "w_scale", torch.float32, (K // group_size, N), dev)
    if out_dtype not in (torch.float32, torch.bfloat16) or not 1 <= M <= GEMV_MAX_M \
            or N % 4 != 0 or not float_scale_group_ok(K, group_size):
        raise ValueError(
            f"W4 GEMV kernel needs f32 or bf16 out, 1 <= M <= {GEMV_MAX_M}, N % 4 == 0 and an "
            f"even group with K a whole number of groups (out={out_dtype}, M={M}, N={N}, "
            f"group={group_size}, K={K})"
        )
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    plan = w4_plan(M, K, N, group_size)
    xp = torch.empty((M, perm_cols(K)), dtype=torch.bfloat16, device=dev) if plan.permuted \
        else None
    x, w_scale = _aligned16(x), _aligned16(w_scale)  # both reach the kernel through tensor maps
    err = _build.lib("w4_gemv").ff_w4_gemv(
        x.data_ptr(), w_packed.data_ptr(), w_scale.data_ptr(), out.data_ptr(),
        None if xp is None else xp.data_ptr(), M, K, N, group_size, plan.n_split, plan.depth,
        int(out_dtype == torch.bfloat16), _build.stream_ptr(dev),
    )
    _build.launch_counts["w4_gemv"] += 1
    _build.check(err, "w4_gemv")
    return out


def matmul_w4a16(x, w_packed, w_scale, bias=None, group_size: int = 128, out_dtype=None):
    """Weight-only int4 matmul under the JAX package's TPU routing
    (`matmul.py:1832-1860`): up to `GEMV_MAX_M` rows `matmul_w4_gemv`; more
    rows dequantize the weight to bf16 and take a dense product with f32
    accumulation. (The tiled Pallas body after `:1860` is unreachable; the
    port has it as `matmul_w4a16_tiled`.)"""
    out_dtype = out_dtype or x.dtype
    xb = x.to(torch.bfloat16).contiguous()
    if x.shape[0] <= GEMV_MAX_M:
        out = matmul_w4_gemv(xb, w_packed, w_scale, group_size, out_dtype)
        if bias is not None:
            out = (out.float() + bias.float()).to(out_dtype)
        return out
    return dense_product(xb, dequantize_int4(w_packed, w_scale, group_size), out_dtype, bias)


def matmul_w4a16_tiled_reference(x, w_packed, w_scale, bias=None, group_size: int = 128,
                                 out_dtype=None):
    """Plain version of `matmul_w4a16_tiled`: what the tiled TPU body
    `_w4a16_kernel` (`matmul.py:1813`) computes. The weight rounds twice,
    ``w = bf16(bf16(v) * bf16(s))``; per group the f32 dot of bf16(x) with
    it, the group dots added to an f32 sum in group order; the sum cast to
    ``out_dtype`` (x's dtype by default); a bias added in f32 to that
    rounded output and rounded again (`:1886-1887`)."""
    out_dtype = out_dtype or x.dtype
    M, K = x.shape
    N = w_packed.shape[1]
    G = K // group_size
    v = unpack_int4(w_packed, group_size).to(torch.bfloat16).reshape(G, group_size, N)
    w = (v * w_scale.to(torch.bfloat16)[:, None, :]).float()
    xg = x.to(torch.bfloat16).float().reshape(M, G, group_size)
    acc = torch.zeros((M, N), dtype=torch.float32, device=x.device)
    for g in range(G):
        acc = acc + xg[:, g] @ w[g]
    out = acc.to(out_dtype)
    if bias is not None:
        out = (out.float() + bias.float()).to(out_dtype)
    return out


def w4a16_magic_words(words: torch.Tensor) -> tuple:
    """The tiled W4A16 kernel's dequant (`csrc/w4_wgmma.cuh`
    dequant_pair), in torch integer ops: int32 ``words`` holding a column's
    bytes of two byte rows at bytes 0 and 2 to the bf16x2 bit patterns of
    ``128 + u`` (u = v + 8, offset binary) of their low nibbles and of their
    high nibbles: ``(w & 0x000F000F) ^ 0x43084308``, then the same of
    ``w >> 4``. As bf16, each minus 136 is the two's-complement nibble v
    exactly."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    return (w & 0x000F000F) ^ 0x43084308, ((w >> 4) & 0x000F000F) ^ 0x43084308


# The W4 GEMV's exponent trick (csrc/w4_gemv.cu dequant_reg): a nibble at
# bit b of a word, its bit 3 flipped, under the exponent of 2^(23 - b) is the
# float 2^(23 - b) + u; (mask, bits to XOR, the float to subtract) for bits
# 0, 8 (the low nibble plane of byte rows r, r + 1) and 4, 12 (the high).
_W4_MAGIC = ((0x000F, 0x4B000008, 8388616.0), (0x0F00, 0x47000800, 32776.0),
             (0x00F0, 0x49000080, 524296.0), (0xF000, 0x45008000, 2056.0))


def w4_gemv_dequant_words(words: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The W4 GEMV kernel's dequant (`csrc/w4_gemv.cu` dequant_reg), in torch
    ops: int32 ``words`` holding a column's bytes of two byte rows r, r + 1
    at bytes 0 and 1 (two's-complement nibbles), and the column's f32
    ``scale`` (broadcast against ``words``), to the bf16 weights
    (..., 4): row r's and row r + 1's low nibble, then their high nibble.
    Each nibble becomes a float by one AND-XOR of the word with exponent
    bits, minus a constant (exactly v), times the scale in f32, rounded
    once to bf16."""
    w = words.to(torch.int64) & 0xFFFF
    scale = torch.as_tensor(scale, dtype=torch.float32)
    out = []
    for mask, bits, sub in _W4_MAGIC:
        f = ((w & mask) ^ bits).to(torch.int32).view(torch.float32)
        out.append(((f - sub) * scale).to(torch.bfloat16))
    return torch.stack(out, -1)


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it that starts on a 16-byte boundary."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def matmul_w4a16_tiled(x, w_packed, w_scale, bias=None, group_size: int = 128, out_dtype=None):
    """The tiled W4A16 body as a callable kernel (`_w4a16_kernel`,
    `matmul.py:1813`, `pallas_call` `:1866`): x (M, K), cast to bf16;
    w_packed (K//2, N) `pack_int4`; w_scale (K//g, N) f32; bias (N,) or
    None; out_dtype f32 or bf16 (x's dtype by default). No caller of the
    JAX package reaches that body (`matmul_w4a16` returns at `:1860`) and
    it rounds the weight twice where the serving route rounds once, so
    `matmul_w4a16` keeps the JAX routing and nothing in the port calls
    this. On CUDA `csrc/w4a16_gemm.cu` (`csrc/w4_wgmma.cuh`: a TMA ring,
    the weight dequantized in bf16x2 straight into wgmma's register
    operand, as `w4a16_magic_words` mirrors; counted under
    ``w4a16_gemm``; at groups `wgmma_group_ok` does not take, x is first
    permuted into byte-row order, `permute_x`, in the same call): its f32
    sums run in another order than `matmul_w4a16_tiled_reference`'s, held
    within a stated tolerance."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return matmul_w4a16_tiled_reference(x, w_packed, w_scale, bias, group_size, out_dtype)
    M, K = x.shape
    N = w_packed.shape[1]
    dev = x.device
    xb = _aligned16(x.to(torch.bfloat16).contiguous())
    _build.require(w_packed, "w_packed", torch.int8, (K // 2, N), dev)
    _build.require(w_scale, "w_scale", torch.float32, (K // group_size, N), dev)
    w_scale = _aligned16(w_scale)  # both reach the kernel through TMA tensor maps
    if bias is not None:
        bias = bias.float().contiguous()
        _build.require(bias, "bias", torch.float32, (N,), dev)
    if out_dtype not in (torch.float32, torch.bfloat16) or M < 1 or N % 4 != 0 \
            or not float_scale_group_ok(K, group_size):
        raise ValueError(
            f"W4A16 tiled kernel needs f32 or bf16 out, M >= 1, N % 4 == 0 and an even group "
            f"with K a whole number of groups (out={out_dtype}, M={M}, N={N}, "
            f"group={group_size}, K={K})"
        )
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    xp = torch.empty((M, perm_cols(K)), dtype=torch.bfloat16, device=dev) \
        if float_scale_route(K, group_size) == "permuted" else None
    err = _build.lib("w4a16_gemm").ff_w4a16_gemm(
        xb.data_ptr(), w_packed.data_ptr(), w_scale.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        None if xp is None else xp.data_ptr(), M, K, N, group_size,
        int(out_dtype == torch.bfloat16), _build.stream_ptr(dev),
    )
    _build.launch_counts["w4a16_gemm"] += 1
    _build.check(err, "w4a16_gemm")
    return out


# --- Fused W4A8 layer tail (`matmul.py:1909-2049`, `:2263-2433`) -------------


def _fused_o_mlp_parts(attn, x_res, norm_w, o_w, o_m, o_s, gu_w, gu_m, gu_s, dn_w, dn_m, dn_s,
                       group_size: int = 128, eps: float = 1e-5):
    """The oracle's steps with their intermediates: (y, x1, hq, s_h, x2,
    s_g), all f32 but the int8 hq and x2. Per-layer operands, multipliers
    unpacked (K//g, N) int8."""
    x_q, x_s = quantize_rowwise(attn)
    o_out = matmul_w4a8_2l_reference(x_q, x_s, o_w, o_m, o_s, None, group_size, torch.float32,
                                     paired=True)
    x1 = x_res.float() + o_out
    inv = torch.rsqrt(torch.mean(x1 * x1, dim=1, keepdim=True) + eps)
    h = x1 * inv * norm_w[None, :].float()
    h_q, h_s = quantize_rowwise(h)
    gu = matmul_w4a8_2l_reference(h_q, h_s, gu_w, gu_m, gu_s, None, group_size, torch.float32,
                                  paired=True)
    gu = gu.to(torch.bfloat16).float()  # the kernel stages gate/up through bf16
    inter = gu.shape[1] // 2
    gate, up = gu[:, :inter], gu[:, inter:]
    gated = gate * torch.sigmoid(gate) * up
    g_q, g_s = quantize_rowwise(gated)
    dn = matmul_w4a8_2l_reference(g_q, g_s, dn_w, dn_m, dn_s, None, group_size, torch.float32,
                                  paired=True)
    return x1 + dn, x1, h_q, h_s, g_q, g_s


def fused_o_mlp_reference(attn, x_res, norm_w, o_w, o_m, o_s, gu_w, gu_m, gu_s, dn_w, dn_m,
                          dn_s, group_size: int = 128, eps: float = 1e-5):
    """Oracle of the fused layer tail (`matmul.py:2263`), per-layer operands:
    f32 residual chain, dynamic int8 activation quantization at each
    product's input, two-level W4A8 products (paired), gate/up rounded
    through bf16. Returns (M, H) f32."""
    return _fused_o_mlp_parts(attn, x_res, norm_w, o_w, o_m, o_s, gu_w, gu_m, gu_s, dn_w, dn_m,
                              dn_s, group_size, eps)[0]


def _layer_mult(mp, w, layer, group_size):
    """Layer ``layer``'s multipliers of stacked weights ``w`` (L, K//2, N),
    unpacked from ``mp`` to the group count of w's own K."""
    return unpack_mult_nibbles(mp[layer], w.shape[1] * 2 // group_size)


def _fused_o_mlp_layer(norm_w, o_w, o_mp, o_sc, gu_w, gu_mp, gu_sc, dn_w, dn_mp, dn_sc, layer,
                       group_size):
    """Layer ``layer`` of the stacked operands, multipliers unpacked (each
    to its own K's group count: the JAX CPU path unpacks gate/up's with
    o_proj's, which holds only where the attention width equals H)."""
    g = group_size
    return (norm_w[layer], o_w[layer], _layer_mult(o_mp, o_w, layer, g), o_sc[layer],
            gu_w[layer], _layer_mult(gu_mp, gu_w, layer, g), gu_sc[layer], dn_w[layer],
            _layer_mult(dn_mp, dn_w, layer, g), dn_sc[layer])


def _tail_product_plan(M: int, K: int, N: int, group_size: int, route: str = "tile"):
    """`mma_plan` of one of the tail's products, unsplit where its (m, n)
    tiles already give every SM a block (gate/up: 224 column tiles a row
    tile). The tile's own target would split it in two below M = 65, and
    the row kernels would then read twice the partials (or the head's gu
    take a split epilogue); unsplit measured faster at every row count of
    rows 10 and 11 (PERF.md §6; ab_two_level.py --splits). ``route`` "any":
    `rows_plan`'s, by the same rule."""
    plan_of = mma_plan if route == "tile" else rows_plan
    plan = plan_of(M, K, N, group_size, "paired")
    if plan.n_split > 1 and plan.m_tiles * plan.n_tiles >= _SMS:
        return plan_of(M, K, N, group_size, "paired", 1)
    return plan


class TailPlan(NamedTuple):
    """The launch plan of `csrc/fused_tail.cu`: each product's tensor-core
    plan (`mma_plan`, or `rows_plan` on the any-group route; paired layout)
    and ring depth in launch order
    (o_proj, gate/up and, for the full tail, down), and its one scratch
    buffer: (name, byte offset, bytes) of each region in the order of the
    C entry's arguments, each 256-byte aligned, and the total bytes."""
    plans: tuple
    depths: tuple
    regions: tuple
    total: int

    @property
    def splits(self) -> tuple:
        return tuple(p.n_split for p in self.plans)


@functools.lru_cache(maxsize=64)
def tail_plan(M: int, K1: int, H: int, N_GU: int, group_size: int, full: bool = True,
              route: str = "tile") -> TailPlan:
    """Plan of one `csrc/fused_tail.cu` call at M rows: ``full`` the layer
    tail (``ff_fused_o_mlp``: o_proj (K1, H), gate/up (H, N_GU), down
    (N_GU / 2, H)), else its o + gate/up head (``ff_fused_o_gu``). Regions:
    the activation scales ``xs`` (M,), ``scales`` (2, M) (s_h, s_g), the
    tail's x1 (M, H) f32, ``hq`` (M, H) and the tail's ``x2`` (M, N_GU / 2)
    int8, each product's staged operand ``xf_*`` (its plan's x_bytes), and
    the int32 ``partial`` of the largest product that hands its partials
    to a row kernel (every product of the tail; the head's o_proj, and its
    gate/up only where that splits). ``route`` "any" (`two_level_route`):
    the products on the any-group route (`rows_plan`), and attn's int8 rows
    ``xq`` (M, K1) after x1 (the tail) or after the scales (the head)."""
    g = group_size
    shapes = ((K1, H), (H, N_GU)) + (((N_GU // 2, H),) if full else ())
    plans = tuple(_tail_product_plan(M, K, N, g, route) for K, N in shapes)
    depths = tuple(manual_depth(p, _MMA_DEPTH) for p in plans)
    partial = [p.n_split * M * N for p, (_, N) in zip(plans, shapes)]
    if not full and plans[1].n_split == 1:
        partial[1] = 0  # the head's gate/up writes gu itself
    staged = [(f"xf_{name}", p.x_bytes) for name, p in zip(("o", "gu", "dn"), plans)]
    xq = [("xq", M * K1)] if route == "any" else []
    rows = [("xs", 4 * M), ("scales", 8 * M)]
    rows += ([("x1", 4 * M * H)] + xq + [("hq", M * H), ("x2", M * (N_GU // 2))] if full
             else xq + [("hq", M * H)])
    regions, total = [], 0
    for name, size in rows + staged + [("partial", 4 * max(partial))]:
        regions.append((name, total, size))
        total += -(-size // 256) * 256
    return TailPlan(plans, depths, tuple(regions), total)


def _check_tail(attn, x_res, norm_w, products, layer, g) -> str:
    """Check the operands of a `csrc/fused_tail.cu` launch; ``products``:
    (name, w, mp, sc, K, N) of each product it runs. Returns the route:
    "tile" where `two_level_route` gives it for every product, else "any"
    (the any-group route for all of them)."""
    M, K1 = attn.shape
    L, H = norm_w.shape
    dev = attn.device
    _build.require(attn, "attn", attn.dtype, (M, K1), dev)
    _build.require(x_res, "x_res", torch.bfloat16, (M, H), dev)
    _build.require(norm_w, "norm_w", torch.bfloat16, (L, H), dev)
    if attn.dtype not in (torch.float32, torch.bfloat16) or not 0 <= layer < L or M < 1:
        raise ValueError(
            f"fused tail kernel needs f32 or bf16 attn and a valid layer "
            f"(attn={attn.dtype}, group={g}, layer={layer})"
        )
    routes = set()
    for name, w, mp, sc, K, N in products:
        _build.require(w, f"{name}_w", torch.int8, (L, K // 2, N), dev)
        _build.require(mp, f"{name}_mp", torch.int32, (L, mp.shape[1], N), dev)
        _build.require(sc, f"{name}_sc", torch.float32, (L, N), dev)
        if K % (2 * g) != 0 or mp.shape[1] * 8 < K // g or N % 4 != 0:
            raise ValueError(f"fused tail: {name} needs K % (2 * group) == 0, a full "
                             f"multiplier pack and N % 4 == 0 (K={K}, N={N}, group={g})")
        routes.add(two_level_route("paired", K, N, g))
    return "tile" if routes == {"tile"} else "any"


def _scratch(plan: TailPlan, dev):
    """One scratch buffer of a fused launch: ([region pointers in argument
    order], view(region, dtype, shape)); the view function holds the
    buffer."""
    scratch = torch.empty((plan.total,), dtype=torch.uint8, device=dev)
    at = {name: (off, size) for name, off, size in plan.regions}

    def view(name, dtype, shape):
        off, size = at[name]
        return scratch[off:off + size].view(dtype).view(shape)

    return [scratch.data_ptr() + off for _, off, _ in plan.regions], view


def _fused_o_mlp_launch(attn, x_res, norm_w, o_w, o_mp, o_sc, gu_w, gu_mp, gu_sc, dn_w, dn_mp,
                        dn_sc, layer, group_size, eps):
    """Launch `csrc/fused_tail.cu` ``ff_fused_o_mlp``; returns (y in
    attn's dtype, then scratch views x1, hq, s_h, x2, s_g and the staged
    operands of gate/up and down, int8 (x_bytes,)). A group the tile does
    not take (`_check_tail`) launches ``ff_fused_o_mlp_any`` (counted under
    ``fused_o_mlp_any``), the products on the any-group route, whose staged
    operands are in byte-row order: None for both."""
    layer = int(layer)
    M, K1 = attn.shape
    L, _, H = o_w.shape
    I = gu_w.shape[2] // 2
    dev = attn.device
    g = group_size
    route = _check_tail(attn, x_res, norm_w, (("o", o_w, o_mp, o_sc, K1, H),
                                              ("gu", gu_w, gu_mp, gu_sc, H, 2 * I),
                                              ("dn", dn_w, dn_mp, dn_sc, I, H)), layer, g)
    if I % 4 != 0:
        raise ValueError(f"fused tail needs an intermediate width % 4 == 0, got {I}")
    bf16 = int(attn.dtype == torch.bfloat16)
    name = "fused_o_mlp" if route == "tile" else "fused_o_mlp_any"
    plan = tail_plan(M, K1, H, 2 * I, g, True, route)
    ptrs, view = _scratch(plan, dev)
    out = torch.empty((M, H), dtype=attn.dtype, device=dev)
    err = getattr(_build.lib("fused_tail"), f"ff_{name}")(
        attn.data_ptr(), x_res.data_ptr(), norm_w.data_ptr(),
        o_w.data_ptr(), o_mp.data_ptr(), o_sc.data_ptr(), gu_w.data_ptr(), gu_mp.data_ptr(),
        gu_sc.data_ptr(), dn_w.data_ptr(), dn_mp.data_ptr(), dn_sc.data_ptr(),
        *ptrs, out.data_ptr(), M, K1, H, I, layer, g, o_mp.shape[1], gu_mp.shape[1],
        dn_mp.shape[1], *plan.splits, *plan.depths, float(eps), bf16, bf16,
        _build.stream_ptr(dev),
    )
    _build.launch_counts[name] += 1
    _build.check(err, name)
    scales = view("scales", torch.float32, (2, M))
    staged = ((view("xf_gu", torch.int8, (plan.plans[1].x_bytes,)),
               view("xf_dn", torch.int8, (plan.plans[2].x_bytes,))) if route == "tile"
              else (None, None))
    return (out, view("x1", torch.float32, (M, H)), view("hq", torch.int8, (M, H)), scales[0],
            view("x2", torch.int8, (M, I)), scales[1], *staged)


def fused_o_mlp_stacked(attn, x_res, norm_w, o_w, o_mp, o_sc, gu_w, gu_mp, gu_sc, dn_w, dn_mp,
                        dn_sc, layer, group_size: int = 128, eps: float = 1e-5):
    """The W4A8 layer tail in one call (`matmul.py:2298`):
    ``y = x1 + down(silu-mlp(rmsnorm(x1)))`` with ``x1 = x_res +
    o_proj(attn)``, on layer ``layer`` of stacked paired two-level weights
    (L, K//2, N) with nibble-packed multipliers and column scales (L, N).
    attn (M, K1); x_res (M, H) bf16; norm_w (L, H) bf16. Returns (M, H) in
    attn's dtype. On the card `csrc/fused_tail.cu` ``ff_fused_o_mlp``:
    its three products on the int8 tensor-core tile (`csrc/w4a8_mma.cuh`,
    paired, planned by `tail_plan`), a row kernel between each two; x1
    bit-equal to the oracle, the int8 hq and x2 within one level where the
    IEEE rsqrt and exp round differently, y within 8e-3 of its largest
    value."""
    if attn.device.type == "cpu":
        return fused_o_mlp_reference(
            attn.float(), x_res.float(),
            *_fused_o_mlp_layer(norm_w, o_w, o_mp, o_sc, gu_w, gu_mp, gu_sc, dn_w, dn_mp,
                                dn_sc, layer, group_size),
            group_size, eps,
        ).to(attn.dtype)
    return _fused_o_mlp_launch(attn, x_res, norm_w, o_w, o_mp, o_sc, gu_w, gu_mp, gu_sc, dn_w,
                               dn_mp, dn_sc, layer, group_size, eps)[0]


# --- The fused layer heads (`matmul.py:2436-2695`) and the o + gate/up head
# of the tail (`:2051-2260`)
#
# Their plain versions hold the jitted JAX oracles: the mean of squares is
# XLA's CPU sum (`_window_sum`) times float32(1/K), and the residual add
# takes the o_proj epilogue's last product as one fused multiply-add, as
# XLA contracts it. Their rsqrt is rounded correctly (the kernels'
# `__frsqrt_rn`); XLA's CPU rsqrt refines the CPU's estimate instruction by
# two Newton steps and sits one ulp off in about an eighth of its inputs.


def _rms_inverse(x, eps):
    """(M,) rsqrt(mean(x^2) + eps) of f32 rows ``x``, correctly rounded."""
    ms = _window_sum(x * x) * (1.0 / x.shape[-1])
    return torch.rsqrt((ms + eps).double()).float()


def _norm_quant(x, norm_w, eps, quantize):
    """The fused heads' prologue: f32 RMSNorm with the norm weight applied
    in f32 (h is not rounded to bf16), then the row quantizer; (h_q, h_s)."""
    xf = x.float()
    return quantize(xf * _rms_inverse(xf, eps)[:, None] * norm_w.float()[None, :])


def fused_norm_qkv_reference(x, norm_w, w, m, s, group_size: int = 128, eps: float = 1e-5):
    """Oracle of the fused W4A8 layer head (`matmul.py:2471`), per-layer
    operands: RMSNorm, int8 row quantization, the paired two-level W4A8
    GEMV; f32 out."""
    h_q, h_s = _norm_quant(x, norm_w, eps, quantize_rowwise)
    return matmul_w4a8_2l_reference(h_q, h_s, w, m, s, None, group_size, torch.float32,
                                    paired=True)


def fused_norm_qkv_a4_reference(x, norm_w, w, m, s, group_size: int = 512, eps: float = 1e-5):
    """Oracle of the fused A4 layer head (`matmul.py:2527`): RMSNorm, int4
    row quantization, the vertical-layout W4A4 GEMV; f32 out."""
    h_q, h_s = _norm_quant(x, norm_w, eps, quantize_rowwise_a4)
    return matmul_w4a4_2l_reference(h_q, h_s, w, m, s, None, group_size, torch.float32)


def _fused_head_launch(a4, x, norm_w, w_packed, mult_packed, s_col, layer, group_size, eps,
                       out_dtype):
    """Launch `csrc/fused_head.cu` (``a4``: the int4 head): the prologue,
    which also writes the tile's staged operand (as `mma_staged_operand`
    mirrors), then the tensor-core tile; returns (out, h_q, h_s). A group
    the tile does not take (`two_level_route`): the prologue without the
    staging, then the any-group route on h_q (``ff_fused_norm_qkv_any``,
    ``ff_fused_norm_qkv_a4_any``, counted under those names, planned by
    `rows_plan`)."""
    layer = int(layer)
    M, K = x.shape
    L, _, N = w_packed.shape
    dev = x.device
    g = group_size
    n_pack = mult_packed.shape[1]
    _build.require(x, "x", torch.bfloat16, (M, K))
    _build.require(norm_w, "norm_w", torch.bfloat16, (L, K), dev)
    _build.require(w_packed, "w_packed", torch.int8, (L, K // 2, N), dev)
    _build.require(mult_packed, "mult_packed", torch.int32, (L, n_pack, N), dev)
    _build.require(s_col, "s_col", torch.float32, (L, N), dev)
    layout = "vertical" if a4 else "paired"
    route = two_level_route(layout, K, N, g)
    if out_dtype not in (torch.float32, torch.bfloat16) or M < 1 or n_pack * 8 < K // g \
            or not 0 <= layer < L:
        raise ValueError(
            f"fused {'A4 ' if a4 else ''}head kernel needs f32 or bf16 out, M >= 1, a full "
            f"multiplier pack and a valid layer (out={out_dtype}, M={M}, N={N}, K={K}, "
            f"group={g}, layer={layer})"
        )
    h_q = torch.empty((M, K), dtype=torch.int8, device=dev)
    h_s = torch.empty((M,), dtype=torch.float32, device=dev)
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    name = ("fused_norm_qkv_a4" if a4 else "fused_norm_qkv") + ("_any" if route == "any" else "")
    # planned as row 1's (vertical) or row 9's (paired) GEMV on its route
    plan = _route_plan(route, M, K, N, g, layout, True)
    xf, partial = _mma_scratch(plan, M, N, dev)
    err = getattr(_build.lib("fused_head"), f"ff_{name}")(
        x.data_ptr(), norm_w.data_ptr(), w_packed.data_ptr(), mult_packed.data_ptr(),
        s_col.data_ptr(), h_q.data_ptr(), h_s.data_ptr(), xf.data_ptr(),
        None if partial is None else partial.data_ptr(), out.data_ptr(), M, K, N, layer, g,
        n_pack, plan.n_split, manual_depth(plan, _MMA_DEPTH), 1.0 / K, float(eps),
        int(out_dtype == torch.bfloat16), _build.stream_ptr(dev),
    )
    _build.launch_counts[name] += 1
    _build.check(err, name)
    return out, h_q, h_s


def _fused_head(a4, x, norm_w, w_packed, mult_packed, s_col, layer, group_size, eps,
                out_dtype):
    """A fused head on the device of ``x``: its plain version on the CPU,
    else `csrc/fused_head.cu`."""
    if x.device.type != "cpu":
        return _fused_head_launch(a4, x, norm_w, w_packed, mult_packed, s_col, layer, group_size,
                                  eps, out_dtype)[0]
    layer = int(layer)
    reference = fused_norm_qkv_a4_reference if a4 else fused_norm_qkv_reference
    return reference(x.float(), norm_w[layer], w_packed[layer],
                     _layer_mult(mult_packed, w_packed, layer, group_size), s_col[layer],
                     group_size, eps).to(out_dtype)


def fused_norm_qkv_stacked(x, norm_w, w_packed, mult_packed, s_col, layer,
                           group_size: int = 128, eps: float = 1e-5, out_dtype=torch.bfloat16):
    """The W4A8 layer head in one call (`matmul.py:2615`): qkv =
    GEMV(quant(rmsnorm(x))) on layer ``layer`` of stacked paired two-level
    weights (L, K//2, N), nibble-packed multipliers (L, ceil(K/g/8), N) and
    column scales (L, N); x (M, K) is the residual stream before the input
    norm, norm_w (L, K). On the card `csrc/fused_head.cu` (bf16 x and
    norm): the norm and quantization prologue, which stages the
    activations itself, then row 9's GEMV on the int8 tensor-core tile
    (`csrc/w4a8_mma.cuh`, paired layout, planned by `mma_plan`); bit-exact
    against `fused_norm_qkv_reference`."""
    return _fused_head(False, x, norm_w, w_packed, mult_packed, s_col, layer, group_size, eps,
                       out_dtype)


def fused_norm_qkv_stacked_a4(x, norm_w, w_packed, mult_packed, s_col, layer,
                              group_size: int = 512, eps: float = 1e-5,
                              out_dtype=torch.bfloat16):
    """The A4 layer head in one call (`matmul.py:2539`): int4 row
    quantization and the vertical-layout W4A4 GEMV; operands as
    `fused_norm_qkv_stacked`. On the card `csrc/fused_head.cu`: the norm
    and quantization prologue, which stages the activations itself, then
    row 1's GEMV on the int8 tensor-core tile (`csrc/w4a8_mma.cuh`,
    vertical layout, planned by `mma_plan`); bit-exact against
    `fused_norm_qkv_a4_reference`."""
    return _fused_head(True, x, norm_w, w_packed, mult_packed, s_col, layer, group_size, eps,
                       out_dtype)


def _fused_o_gu_parts(attn, x_res, norm_w, o_w, o_m, o_s, gu_w, gu_m, gu_s,
                      group_size: int = 128, eps: float = 1e-5):
    """The oracle's steps: (x1 f32, gu bf16, hq int8, s_h f32)."""
    x_q, x_s = quantize_rowwise(attn)
    o = _w4a8_2l_dot(x_q, o_w, o_m, group_size, True) * o_s.float()[None, :]
    x1 = _fma_f32(o, x_s[:, None].expand_as(o), x_res.float())
    h_q, h_s = _norm_quant(x1, norm_w, eps, quantize_rowwise)
    gu = matmul_w4a8_2l_reference(h_q, h_s, gu_w, gu_m, gu_s, None, group_size, torch.float32,
                                  paired=True)
    return x1, gu.to(torch.bfloat16), h_q, h_s


def fused_o_gu_reference(attn, x_res, norm_w, o_w, o_m, o_s, gu_w, gu_m, gu_s,
                         group_size: int = 128, eps: float = 1e-5):
    """Oracle of the o + gate/up head of the tail (`matmul.py:2241`),
    per-layer operands, multipliers unpacked: ``x1 = x_res + o(quant(attn))``
    in f32 and ``gu = bf16(gateup(quant(rmsnorm(x1))))``."""
    return _fused_o_gu_parts(attn, x_res, norm_w, o_w, o_m, o_s, gu_w, gu_m, gu_s, group_size,
                             eps)[:2]


def _fused_o_gu_launch(attn, x_res, norm_w, o_w, o_mp, o_sc, gu_w, gu_mp, gu_sc, layer,
                       group_size, eps):
    """Launch `ff_fused_o_gu` of `csrc/fused_tail.cu`; returns (x1, gu,
    then scratch views hq, s_h and gate/up's staged operand)."""
    layer = int(layer)
    M, K1 = attn.shape
    L, _, H = o_w.shape
    N_GU = gu_w.shape[2]
    dev = attn.device
    g = group_size
    route = _check_tail(attn, x_res, norm_w, (("o", o_w, o_mp, o_sc, K1, H),
                                              ("gu", gu_w, gu_mp, gu_sc, H, N_GU)), layer, g)
    if N_GU % 2 != 0:
        raise ValueError(f"fused o + gate/up needs an even gate/up width, got {N_GU}")
    x1 = torch.empty((M, H), dtype=torch.float32, device=dev)
    gu = torch.empty((M, N_GU), dtype=torch.bfloat16, device=dev)
    name = "fused_o_gu" if route == "tile" else "fused_o_gu_any"
    plan = tail_plan(M, K1, H, N_GU, g, False, route)
    ptrs, view = _scratch(plan, dev)
    err = getattr(_build.lib("fused_tail"), f"ff_{name}")(
        attn.data_ptr(), x_res.data_ptr(), norm_w.data_ptr(),
        o_w.data_ptr(), o_mp.data_ptr(), o_sc.data_ptr(), gu_w.data_ptr(), gu_mp.data_ptr(),
        gu_sc.data_ptr(), *ptrs, x1.data_ptr(), gu.data_ptr(),
        M, K1, H, N_GU, layer, g, o_mp.shape[1], gu_mp.shape[1], *plan.splits, *plan.depths,
        float(eps), int(attn.dtype == torch.bfloat16), _build.stream_ptr(dev),
    )
    _build.launch_counts[name] += 1
    _build.check(err, name)
    return (x1, gu, view("hq", torch.int8, (M, H)), view("scales", torch.float32, (2, M))[0],
            view("xf_gu", torch.int8, (plan.plans[1].x_bytes,)) if route == "tile" else None)


def fused_o_gu_stacked(attn, x_res, norm_w, o_w, o_mp, o_sc, gu_w, gu_mp, gu_sc, layer,
                       group_size: int = 128, eps: float = 1e-5):
    """o_proj + residual + RMSNorm + int8 requantization + gate/up in one
    call (`matmul.py:2118`): ``(x1, gu)`` with ``x1 = x_res + o_proj(attn)``
    (M, H) f32 and ``gu = gateup(quant(rmsnorm(x1)))`` (M, N_GU) bf16, on
    layer ``layer`` of stacked paired two-level weights (the caller finishes
    the MLP). attn (M, K1); x_res (M, H) bf16; norm_w (L, H) bf16. Each
    product's multipliers are unpacked to its own K's group count. On the
    card `ff_fused_o_gu` of `csrc/fused_tail.cu`: the tail's launches
    through gate/up on the int8 tensor-core tile (`tail_plan`), x1
    bit-equal to the oracle, hq within one level where the row sums round
    differently, gu within 8e-3 of its largest value; a group the tile does
    not take, the same launches with the products on the any-group route
    (``ff_fused_o_gu_any``, counted under ``fused_o_gu_any``)."""
    if attn.device.type == "cpu":
        layer, g = int(layer), group_size
        return fused_o_gu_reference(
            attn.float(), x_res.float(), norm_w[layer], o_w[layer],
            _layer_mult(o_mp, o_w, layer, g), o_sc[layer], gu_w[layer],
            _layer_mult(gu_mp, gu_w, layer, g), gu_sc[layer], g, eps,
        )
    return _fused_o_gu_launch(attn, x_res, norm_w, o_w, o_mp, o_sc, gu_w, gu_mp, gu_sc, layer,
                              group_size, eps)[:2]
