"""The port's INT4 packing against `fastforward_tpu.kernels.packing`.

Same int4 grid values (numpy, seeded) go through both packages; every
packed byte and every unpacked value must be equal (tolerance: none).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastforward_tpu.kernels import packing as jp
from fastforward_tpu_torch.kernels import packing as tp


def _grid(shape, seed):
    return np.random.RandomState(seed).randint(-8, 8, shape).astype(np.int8)


def _eq(a_jax, b_torch):
    a = np.asarray(a_jax)
    b = b_torch.numpy()
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


PACKERS = [
    # (pack, unpack, needs group_size, group size)
    ("pack_int4", "unpack_int4", True, 32),
    ("pack_uint4_offset", "unpack_uint4_offset", True, 64),
    ("pack_uint4_offset_paired", "unpack_uint4_offset_paired", True, 32),
    ("pack_int4_vertical", "unpack_int4_vertical", False, None),
]


@pytest.mark.parametrize("pack,unpack,grouped,g", PACKERS, ids=[p[0] for p in PACKERS])
def test_pack_unpack_bit_exact(pack, unpack, grouped, g):
    # GIVEN int4 grid values (K, N) with an even number of groups
    w = _grid((256, 24), seed=1)
    kw = dict(group_size=g) if grouped else {}
    # WHEN packed by both packages THEN the bytes are equal
    pj = getattr(jp, pack)(jnp.asarray(w), **kw)
    pt = getattr(tp, pack)(torch.from_numpy(w), **kw)
    _eq(pj, pt)
    # AND unpacking restores the grid values in both
    _eq(getattr(jp, unpack)(pj, **kw), getattr(tp, unpack)(pt, **kw))
    np.testing.assert_array_equal(getattr(tp, unpack)(pt, **kw).numpy(), w)


UNPACKERS = [
    ("unpack_int4", dict(group_size=2)),
    ("unpack_uint4_offset", dict(group_size=2)),
    ("unpack_uint4_offset_paired", dict(group_size=1)),
    ("unpack_int4_vertical", {}),
]


@pytest.mark.parametrize("unpack,kw", UNPACKERS, ids=[u[0] for u in UNPACKERS])
def test_unpack_every_byte_value(unpack, kw):
    # GIVEN all 256 byte patterns (the int8 shift / sign-extension idioms
    # of packing.py:101 and :163 see every one)
    packed = np.arange(-128, 128, dtype=np.int8).reshape(1, 256)
    # WHEN unpacked by both packages THEN every nibble agrees
    _eq(getattr(jp, unpack)(jnp.asarray(packed), **kw),
        getattr(tp, unpack)(torch.from_numpy(packed), **kw))


@pytest.mark.parametrize("n_groups", [1, 7, 8, 28])
def test_pack_mult_nibbles_bit_exact(n_groups):
    # GIVEN stacked multipliers in [1, 15], with 15 forced into nibble 7
    # (sets the int32 sign bit) and a group count needing padding
    m = np.random.RandomState(n_groups).randint(1, 16, (3, n_groups, 40)).astype(np.int8)
    if n_groups >= 8:
        m[:, 7, :] = 15
    # WHEN packed 8 per int32 THEN the words are equal, sign bit included
    pj = jp.pack_mult_nibbles(jnp.asarray(m))
    pt = tp.pack_mult_nibbles(torch.from_numpy(m))
    _eq(pj, pt)
    if n_groups >= 8:
        assert (pt.numpy()[:, 0, :] < 0).all()
    # AND unpacking returns the multipliers
    _eq(jp.unpack_mult_nibbles(pj, n_groups), tp.unpack_mult_nibbles(pt, n_groups))
    np.testing.assert_array_equal(tp.unpack_mult_nibbles(pt, n_groups).numpy(), m)


def test_pack_rejects_bad_group():
    with pytest.raises(ValueError):
        tp.pack_int4(torch.zeros((30, 4), dtype=torch.int8), group_size=32)
    with pytest.raises(ValueError):
        tp.pack_uint4_offset_paired(torch.zeros((96, 4), dtype=torch.int8), group_size=32)
    with pytest.raises(ValueError):
        tp.pack_int4_vertical(torch.zeros((3, 4), dtype=torch.int8))
