"""The port's paged KV cache against the JAX package, on the CPU.

`fastforward_tpu_torch.kernels.paged_attention` (references and wrappers,
which run their plain versions on a CPU tensor) and
`fastforward_tpu_torch.serving.paged` (pool, allocator, prefill scatter)
against `fastforward_tpu.kernels.paged_attention` and
`fastforward_tpu.serving.paged`. Tolerances: the append, the page gather,
the allocator's tables and the prefill scatter are bit-equal; paged flash
decode is within one bf16 ulp of the largest output (rtol 8e-3), its
output being bf16 of an f32 softmax summed in another order. Inputs are
made by numpy from a seed.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastforward_tpu.kernels import paged_attention as jpa
from fastforward_tpu.models.llama import LlamaConfig as JConfig
from fastforward_tpu.serving import paged as jpg
from fastforward_tpu.serving import stacked as jst
from fastforward_tpu_torch.kernels import paged_attention as tpa
from fastforward_tpu_torch.models.llama import LlamaConfig as TConfig
from fastforward_tpu_torch.serving import paged as tpg
from fastforward_tpu_torch.serving import stacked as tst
from fastforward_tpu_torch.serving.convert import params_from_flat
from tests.test_torch_serving import jax_to_flat

L, P, HKV, D = 2, 7, 2, 128
# a -1 entry inside the table (row 1) and a whole row of -1 (row 3)
TABLE = np.array([[3, 5, -1], [1, -1, -1], [2, 6, 4], [-1, -1, -1], [4, 2, 6]], np.int32)


def _pool(page, seed):
    rs = np.random.RandomState(seed)
    kv = [rs.randint(-128, 128, (L, P, HKV, page, D)).astype(np.int8) for _ in range(2)]
    sc = [(rs.rand(L, P, HKV, page) * 0.05).astype(np.float32) for _ in range(2)]
    return kv + sc


def _new(B, seed):
    rs = np.random.RandomState(seed)
    kv = [rs.randint(-128, 128, (B, HKV, 1, D)).astype(np.int8) for _ in range(2)]
    sc = [rs.rand(B, HKV, 1).astype(np.float32) for _ in range(2)]
    return kv + sc


def _t(arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def test_gather_pages_matches_jax():
    pool = _pool(32, 0)[0][1]
    for row in TABLE:
        np.testing.assert_array_equal(np.asarray(jpa.gather_pages(jnp.asarray(pool),
                                                                  jnp.asarray(row))),
                                      tpa.gather_pages(torch.from_numpy(pool),
                                                       torch.from_numpy(row)).numpy())


@pytest.mark.parametrize("page", [32, 128])
def test_paged_append_bit_equal_to_jax(page):
    # GIVEN positions in an allocated page, in a -1 entry, in a row of -1,
    # and at or beyond the table (pos // page >= MP); rows 3 and 4 collide
    # on the trash page 0, and the later sequence wins in both packages
    MP = TABLE.shape[1]
    pools, new = _pool(page, 1), _new(len(TABLE), 2)
    pos = np.array([page + 3, page + 1, 2 * page + 5, 7, MP * page + 7], np.int32)
    # the JAX reference on the table its TPU wrapper passes (max(table, 0),
    # paged_attention.py:326): -1 is page 0. A page index beyond the table
    # gathers INT32_MIN, which dynamic_update_slice clamps to page 0.
    ref = jpa.paged_kv_append_reference(*[jnp.asarray(a) for a in pools + new],
                                        jnp.asarray(pos), jnp.maximum(jnp.asarray(TABLE), 0), 1)
    # WHEN the port's reference and its wrapper (plain on the CPU) append
    out_ref = tpa.paged_kv_append_reference(*_t(pools + new), torch.from_numpy(pos),
                                            torch.from_numpy(TABLE), 1)
    out = tpa.paged_kv_append_decode_int8(*_t(pools + new), torch.from_numpy(pos),
                                          torch.from_numpy(TABLE), 1)
    # THEN all pools are bit-equal to JAX's, and page 0 took the writes
    for a, b, c in zip(ref, out_ref, out):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
        np.testing.assert_array_equal(np.asarray(a), c.numpy())
    assert torch.equal(out[0][1, 0, :, 7], torch.from_numpy(new[0][4, :, 0]))
    assert torch.equal(out[0][1, 0, :, 1], torch.from_numpy(new[0][1, :, 0]))
    # the reference on the raw table wraps the -1 of row 1 to page P - 1, a
    # page the allocator hands out (ROADMAP.md Queue 3); the port does not
    raw = jpa.paged_kv_append_reference(*[jnp.asarray(a) for a in pools + new],
                                        jnp.asarray(pos), jnp.asarray(TABLE), 1)
    np.testing.assert_array_equal(np.asarray(raw[0])[1, P - 1, :, 1], new[0][1, :, 0])


@pytest.mark.parametrize("page,G", [(32, 4), (128, 2), (128, 1)])
def test_paged_flash_decode_within_tolerance_of_jax(page, G):
    # GIVEN lengths of one token, a page and one, the whole table and past it
    MP = TABLE.shape[1]
    pools = _pool(page, 3)
    q = (np.random.RandomState(4).randn(len(TABLE), HKV * G, D)).astype(np.float32)
    lengths = np.array([1, page + 1, MP * page, MP * page + 9, 2 * page], np.int32)
    qj = jnp.asarray(q).astype(jnp.bfloat16)
    qt = torch.from_numpy(q).to(torch.bfloat16)
    k_ks_v_vs = [pools[i][1] for i in (0, 2, 1, 3)]  # layer 1
    a = np.asarray(jpa.paged_flash_decode_reference(
        qj, *[jnp.asarray(p) for p in k_ks_v_vs], jnp.asarray(TABLE), jnp.asarray(lengths)
    ).astype(jnp.float32))
    pt = _t(pools)
    b = tpa.paged_flash_decode_reference(qt, *_t(k_ks_v_vs), torch.from_numpy(TABLE),
                                         torch.from_numpy(lengths))
    c = tpa.paged_flash_decode_int8(qt, pt[0], pt[2], pt[1], pt[3], torch.from_numpy(TABLE),
                                    torch.from_numpy(lengths), 1)
    assert b.dtype == c.dtype == torch.bfloat16
    assert torch.equal(b, tpa.paged_flash_decode_reference(
        qt, pt[0][1], pt[2][1], pt[1][1], pt[3][1], torch.from_numpy(TABLE),
        torch.from_numpy(lengths)))
    assert np.abs(a - c.float().numpy()).max() <= 8e-3 * np.abs(a).max()


def test_allocator_mirrors_jax():
    # the JAX package's allocator tests (tests/serving/test_paged.py): a dry
    # pool fails and rolls back only this call's pages; release frees all
    for alloc in (jpg.PageAllocator(4, 4, 2), tpg.PageAllocator(4, 4, 2)):
        assert alloc.ensure(0, 3 * 128, 128)
        assert alloc.num_free == 1
        assert not alloc.ensure(1, 2 * 128, 128)
        assert alloc.num_free == 1 and alloc.pages[1] == []
        alloc.release(0)
        assert alloc.num_free == 4
        assert alloc.ensure(1, 2 * 128, 128)
    for alloc in (jpg.PageAllocator(5, 4, 2), tpg.PageAllocator(5, 4, 2)):
        assert alloc.ensure(0, 2 * 64, 64)
        held = list(alloc.pages[0])
        assert alloc.ensure(1, 2 * 64, 64)
        assert not alloc.ensure(0, 4 * 64, 64)
        assert alloc.pages[0] == held and alloc.num_free == 1
        assert not alloc.ensure(0, 5 * 64, 64)  # beyond the table row


def test_allocator_tables_match_jax_and_are_checked():
    ja, ta = jpg.PageAllocator(9, 3, 3), tpg.PageAllocator(9, 3, 3)
    for alloc in (ja, ta):
        alloc.free.remove(0)
        alloc.ensure(0, 300, 128)
        alloc.ensure(2, 100, 128)
        alloc.ensure(0, 385, 128)
    np.testing.assert_array_equal(np.asarray(ja.table_array()), ta.table_array("cpu").numpy())
    assert ta.table_array("cpu").dtype == torch.int32
    # a page id outside [-1, num_pages) is refused before it reaches a kernel
    ta.pages[1] = [9]
    with pytest.raises(ValueError, match="outside"):
        ta.table_array("cpu")
    ta.pages[1] = [-2]
    with pytest.raises(ValueError, match="outside"):
        ta.table_array("cpu")


def test_scatter_prefill_to_pages_matches_jax():
    # GIVEN a prefilled 2-row slab of 256 positions and 128-token pages
    rs = np.random.RandomState(6)
    small = [rs.randint(-128, 128, (L, 2, HKV, 256, D)).astype(np.int8) for _ in range(2)]
    small += [rs.rand(L, 2, HKV, 256).astype(np.float32) for _ in range(2)]
    jc = jpg.PagedKVCache.create(L, 6, 2, 2, HKV, D, page_size=128)
    tc = tpg.PagedKVCache.create(L, 6, 2, 2, HKV, D, page_size=128, device="cpu")
    # WHEN row 1 goes to pages [4, 2] (and a third page past the row is ignored)
    jc = jpg.scatter_prefill_to_pages(jc, *[jnp.asarray(a) for a in small], 1, [4, 2, 5])
    tpg.scatter_prefill_to_pages(tc, *_t(small), 1, [4, 2, 5])
    # THEN the pools are bit-equal
    for f in ("k", "v", "k_scale", "v_scale", "table"):
        np.testing.assert_array_equal(np.asarray(getattr(jc, f)), getattr(tc, f).numpy())
    assert (tc.page_size, tc.num_pages, tc.max_pages_per_seq, tc.max_len) == (128, 6, 2, 256)


@pytest.fixture(scope="module")
def tiny_wide():
    """A narrow Llama with head dim 128 and two query heads per kv head (the
    kernel routes), W4A8 two-level, built by the JAX package and carried."""
    kw = dict(vocab_size=256, hidden_size=256, intermediate_size=512, num_layers=2,
              num_heads=2, num_kv_heads=1, head_dim=128, max_seq_len=512)
    jc = JConfig(**kw, dtype=jnp.float32)
    tc = TConfig(**kw, dtype=torch.float32)
    params, layers = jst.random_stacked_params(jc, mode="w4a8_2l", seed=0)
    layers = jst.fuse_stacked_layers(layers)
    return tc, *params_from_flat(jax_to_flat(params, layers), device="cpu")


@pytest.mark.parametrize("page", [128, 64])
def test_paged_forward_matches_slab(tiny_wide, page):
    # GIVEN 2 prompts of 40 tokens prefilled into a slab and copied into
    # shuffled pool pages (page 64: the plain route the JAX package takes)
    tc, tp, tl = tiny_wide
    B, T = 2, 40
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (B, T)))
    slab = tst.StackedKVCache.create(2, B, 256, tc.num_kv_heads, tc.head_dim, device="cpu")
    logits, slab = tst.serving_forward_stacked(tp, tl, tc, ids, cache=slab)
    alloc = tpg.PageAllocator(10, 256 // page, B)
    alloc.free.remove(0)
    for t in range(256 // page):
        for b in range(B):
            alloc.ensure(b, (t + 1) * page, page)
    paged = tpg.PagedKVCache.create(2, 10, B, 256 // page, tc.num_kv_heads, tc.head_dim,
                                    page_size=page, device="cpu")
    for b in range(B):
        tpg.scatter_prefill_to_pages(paged, slab.k, slab.v, slab.k_scale, slab.v_scale, b,
                                     alloc.pages[b])
    paged.table = alloc.table_array("cpu")
    paged.length = slab.length
    tok = torch.argmax(logits[:, -1], -1)[:, None]
    tok_s = tok_p = tok
    for step in range(3):
        # WHEN both decode from the same positions
        pos = torch.full((B, 1), T + step, dtype=torch.int32)
        ls, slab = tst.serving_forward_stacked(tp, tl, tc, tok_s, cache=slab, positions=pos)
        lp, paged = tst.serving_forward_stacked(tp, tl, tc, tok_p, cache=paged, positions=pos)
        # THEN the logits are equal: the same function over the same rows
        torch.testing.assert_close(ls, lp, rtol=0, atol=0)
        tok_s = torch.argmax(ls[:, -1], -1)[:, None]
        tok_p = torch.argmax(lp[:, -1], -1)[:, None]
    assert paged.length == T + 3
    with pytest.raises(ValueError, match="T == 1"):
        tst.serving_forward_stacked(tp, tl, tc, ids, cache=paged)


def test_paged_cache_create_layout():
    c = tpg.PagedKVCache.create(3, 5, 4, 2, 8, 128, page_size=256, device="cpu")
    assert tuple(c.k.shape) == (3, 5, 8, 256, 128) and c.k.dtype == torch.int8
    assert tuple(c.v_scale.shape) == (3, 5, 8, 256) and c.v_scale.dtype == torch.float32
    assert tuple(c.table.shape) == (4, 2) and bool((c.table == -1).all())
    assert c.is_quantized and dataclasses.replace(c, length=4).length == 4
