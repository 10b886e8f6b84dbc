"""The plans of the two prefill kernels redesigned for Hopper, on the CPU.

Flash prefill (`csrc/flash_prefill.cu`, `attention.prefill_plan`): work
items of 128 query rows (G heads x 128 / G positions), two warpgroups of
64, persistent blocks taking every grid-th item. Every output element (b,
head, t < T) lies in exactly one warpgroup's rows of one item, every item
in one block; the key tiles a warpgroup computes hold every key its rows
see and no tile past its frontier, the producer streams every tile any of
the item's rows needs, and the tiles it leaves unmasked hold only keys
every row sees. The kernel's tile-by-tile arithmetic written out in torch
under the plan (online softmax in f32, P rounded to bf16 after its
v_scale, the TPU kernel's rounding points) stays within the kernel's
tolerance (8e-3 of the largest output) of `flash_prefill_reference` and of
the JAX package's reference.

Dequant (`csrc/dequant.cu`, `matmul.dequant_plan`): 256 threads a block, 8
columns a thread (1 where the panel width is no multiple of 8), R byte rows
a thread; every output element of every layout is written by exactly one
thread, and R is 4 only where 8 would leave fewer than four blocks an SM.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastforward_tpu.kernels import attention as ja
from fastforward_tpu_torch.kernels import attention as att
from fastforward_tpu_torch.kernels import matmul as mm

KEYS = att.PREFILL_KEYS


def _starts(B, T, S, seed):
    rs = np.random.RandomState(seed)
    return [int(x) for x in rs.randint(0, max(1, S - T) + 40, B)]


@pytest.mark.parametrize("G", [1, 2, 4, 8])
@pytest.mark.parametrize("T", [1, 77, 128, 200])
@pytest.mark.parametrize("S", [300, 100])
def test_prefill_plan_covers_every_output_and_key_once(G, T, S):
    B, Hkv = 3, 2
    plan = att.prefill_plan(B, Hkv * G, Hkv, T, S, sms=5)
    starts = _starts(B, T, S, G + T + S)
    # every item in exactly one block
    taken = sorted(i for z in range(plan.grid) for i in plan.block_items(z))
    assert taken == list(range(plan.items))
    seen = {}
    for i in range(plan.items):
        b, h, pt = plan.item(i)
        start = starts[b]
        n = plan.item_tiles(i, start)
        assert 1 <= n <= -(-S // KEYS)
        for wg in range(2):
            rows = plan.wg_rows(i, wg)
            n_w, open_ = plan.wg_tiles(i, wg, start)
            live = [(hd, t) for hd, t in rows if t < T]
            assert (n_w > 0) == bool(live) and n_w <= n
            for hd, t in live:
                key = (b, hd, t)
                assert key not in seen  # each output once
                seen[key] = i
                last_key = min(start + t, S - 1)  # the keys this row sees
                assert last_key // KEYS < n_w  # within the computed tiles
            if live:
                # the warpgroup's frontier tile is needed by its last row
                t_last = max(t for _, t in live)
                assert (n_w - 1) * KEYS <= min(start + t_last, S - 1)
                # unmasked tiles hold only keys every row of it sees (< S)
                t_first = min(t for _, t in live)
                assert open_ * KEYS - 1 <= start + t_first and open_ * KEYS <= S
        # the producer's tiles: the item's last row needs the last one
        t_last = min((pt + 1) * plan.P, T) - 1
        assert (n - 1) * KEYS <= min(start + t_last, S - 1)
    assert len(seen) == B * Hkv * G * T


def _mirror(q, k, ks, v, vs, starts, plan, sm_scale):
    """The kernel's arithmetic under ``plan``, item by item, warpgroup by
    warpgroup, tile by tile (f32 scores of bf16 operands, scale, mask,
    online softmax in f32, P = bf16(p * v_scale), f32 P.V, acc / max(l,
    1e-20) rounded to bf16)."""
    B, H, T, D = q.shape
    S = k.shape[2]
    out = torch.zeros_like(q)
    kf, vf = k.float(), v.float()
    for i in range(plan.items):
        b, h, _ = plan.item(i)
        start = int(starts[b])
        for wg in range(2):
            rows = plan.wg_rows(i, wg)
            n_w, open_ = plan.wg_tiles(i, wg, start)
            if n_w == 0:
                continue
            heads = torch.tensor([hd for hd, _ in rows])
            ts = torch.tensor([t for _, t in rows])
            live = ts < T
            qr = torch.zeros((64, D))
            qr[live] = q[b, heads[live], ts[live]].float()
            pos = start + ts
            m = torch.full((64,), -1e30)
            lsum = torch.zeros(64)
            acc = torch.zeros((64, D))
            for t in range(n_w):
                keys = torch.arange(t * KEYS, (t + 1) * KEYS)
                inside = keys < S
                kt = torch.zeros((KEYS, D))
                vt = torch.zeros((KEYS, D))
                kt[inside] = kf[b, h, keys[inside]]
                vt[inside] = vf[b, h, keys[inside]]
                s = qr @ kt.T
                ksc = torch.ones(KEYS) if ks is None else torch.zeros(KEYS)
                vsc = torch.ones(KEYS) if vs is None else torch.zeros(KEYS)
                if ks is not None:
                    ksc[inside] = ks[b, h, keys[inside]]
                    vsc[inside] = vs[b, h, keys[inside]]
                s = s * ksc[None, :] * sm_scale
                if t >= open_:
                    ok = inside[None, :] & (keys[None, :] <= pos[:, None])
                    s = torch.where(ok, s, torch.full_like(s, -1e30))
                m_new = torch.maximum(m, s.max(dim=1).values)
                alpha = torch.exp(m - m_new)
                p = torch.exp(s - m_new[:, None])
                lsum = lsum * alpha + p.sum(dim=1)
                pb = (p * vsc[None, :]).to(torch.bfloat16).float()
                acc = acc * alpha[:, None] + pb @ vt
                m = m_new
            res = (acc / torch.clamp(lsum, min=1e-20)[:, None]).to(q.dtype)
            out[b, heads[live], ts[live]] = res[live]
    return out


@pytest.mark.parametrize("G", [1, 2, 4, 8])
@pytest.mark.parametrize("T,S,starts", [(77, 300, (5, 0, 223)), (128, 200, (0, 0, 0)),
                                        (1, 64, (63, 0, 10)), (200, 260, (0, 30, 60))])
@pytest.mark.parametrize("kv", ["int8", "bf16"])
def test_prefill_mirror_within_tolerance_of_the_references(G, T, S, starts, kv):
    # GIVEN numpy-seeded q, an int8 cache with f32 scales or a bf16 cache,
    # ragged starts, T above and below the 128-row item, S past the tile
    rs = np.random.RandomState(G * 1000 + T + S)
    B, Hkv, D = 3, 2, 128
    H = Hkv * G
    q = torch.from_numpy(rs.randn(B, H, T, D).astype(np.float32)).to(torch.bfloat16)
    if kv == "int8":
        k = torch.from_numpy(rs.randint(-128, 128, (B, Hkv, S, D)).astype(np.int8))
        v = torch.from_numpy(rs.randint(-128, 128, (B, Hkv, S, D)).astype(np.int8))
        ks = torch.from_numpy((rs.rand(B, Hkv, S) * 0.02).astype(np.float32))
        vs = torch.from_numpy((rs.rand(B, Hkv, S) * 0.05).astype(np.float32))
    else:
        k = torch.from_numpy(rs.randn(B, Hkv, S, D).astype(np.float32)).to(torch.bfloat16)
        v = torch.from_numpy(rs.randn(B, Hkv, S, D).astype(np.float32)).to(torch.bfloat16)
        ks = vs = None
    st = torch.tensor(starts, dtype=torch.int32)
    plan = att.prefill_plan(B, H, Hkv, T, S, sms=4)
    # WHEN the kernel's arithmetic runs under its plan
    got = _mirror(q, k, ks, v, vs, st, plan, 1.0 / math.sqrt(D)).float()
    # THEN it is within 8e-3 of the largest output of the port's reference
    # and of the JAX package's
    ref = att.flash_prefill_reference(q, k, ks, v, vs, st).float()
    assert (got - ref).abs().max() <= 8e-3 * ref.abs().max()
    def to_jax(t):
        return None if t is None else jnp.asarray(t.float().numpy()).astype(
            jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.dtype(str(t.dtype)[6:]))

    j = ja.flash_prefill_reference(to_jax(q), to_jax(k), to_jax(ks), to_jax(v), to_jax(vs),
                                   jnp.asarray(st.numpy()))
    jref = torch.from_numpy(np.array(jnp.asarray(j, jnp.float32)))
    assert (got - jref).abs().max() <= 8e-3 * jref.abs().max()


def test_prefill_plan_at_bench_shape():
    # bench.py's prefill: 192 x 32 heads (8 kv) x 128 positions; G = 4 gives
    # items of 32 positions, 4 a (sequence, kv head), on the 132 SMs
    plan = att.prefill_plan(192, 32, 8, 128, 512)
    assert (plan.P, plan.pw, plan.gw, plan.n_pt) == (32, 32, 2, 4)
    assert plan.items == 6144 and plan.grid == 132
    # snake order: a block alternates near and far position tiles
    tiles = [plan.item(i)[2] for i in plan.block_items(0)[:4]]
    assert tiles == [0, 3, 0, 3]


@pytest.mark.parametrize("args", [(1, 12, 4, 8, 8), (1, 16, 1, 8, 8), (1, 8, 8, 0, 8),
                                  (1, 8, 8, 8, 0)])
def test_prefill_plan_refuses_what_the_kernel_does_not_take(args):
    # G = 3, G = 16, T = 0, S = 0
    with pytest.raises(ValueError):
        att.prefill_plan(*args)


def _dequant_rows(layout, r, g):
    """(output row of the low nibble, of the high nibble) of byte row r."""
    if layout == "vertical":
        return 2 * r, 2 * r + 1
    if layout == "paired":
        p, i = divmod(r, g)
        return 2 * p * g + i, (2 * p + 1) * g + i
    p, i = divmod(r, g // 2)
    return p * g + i, p * g + g // 2 + i


@pytest.mark.parametrize("layout", ["vertical", "paired", "halves"])
@pytest.mark.parametrize("K,N,bn,g", [(4096, 6144, 0, 128), (4096, 4096, 512, 128),
                                      (1024, 4100, 0, 128), (320, 40, 0, 32),
                                      (512, 2064, 0, 64), (1024, 1024, 128, 512),
                                      (352, 4096, 0, 16)])
def test_dequant_plan_writes_every_output_once(layout, K, N, bn, g):
    if layout == "paired" and K % (2 * g):
        pytest.skip("the paired layout needs whole group pairs")
    plan = mm.dequant_plan(K, N, bn)
    assert plan.cols == (8 if (bn or N) % 8 == 0 else 1)
    hits = torch.zeros((K, N), dtype=torch.int32)
    for blk in range(plan.blocks):
        (r0, r1), (c0, c1) = plan.block_tile(blk)
        rows = [r for r in range(r0, r1) if r < K // 2]
        cols = slice(c0, min(c1, N))
        for r in rows:
            lo, hi = _dequant_rows(layout, r, g)
            hits[lo, cols] += 1
            hits[hi, cols] += 1
    assert torch.equal(hits, torch.ones_like(hits))


@pytest.mark.parametrize("K,N,rows", [(4096, 6144, 8), (4096, 4096, 4), (4096, 28672, 8),
                                      (14336, 4096, 8), (256, 40, 4)])
def test_dequant_plan_fills_the_card(K, N, rows):
    # the Llama-3-8B projections: R = 8 but at o_proj, where 8 would leave
    # 512 blocks (fewer than four an SM); at least four blocks an SM or all
    # the rows there are
    plan = mm.dequant_plan(K, N)
    assert plan.rows == rows
    assert plan.blocks >= 4 * 132 or plan.rows == 4
    assert plan.blocks == plan.col_tiles * -(-(K // 2) // plan.rows)
