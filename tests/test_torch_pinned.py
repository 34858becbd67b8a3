"""The port's page-locked block pool (``repro_torch.core.pinned``) on the
CPU, with an allocator that hands out ordinary memory in place of
``cudaHostAlloc``: a block lives while any view of its array does, goes
back to the pool when the last one dies, the pool keeps one free block
of each size and frees the rest, and its counts say so.  On a card the
same pool backs ``Mapper.gain_matrix`` (``tests/test_torch_card.py``)."""

import ctypes
import gc

import numpy as np
import pytest

from repro_torch.core.pinned import PinnedPool


@pytest.fixture
def pool():
    live = {}

    def alloc(nbytes):
        buf = ctypes.create_string_buffer(nbytes)
        live[ctypes.addressof(buf)] = buf
        return ctypes.addressof(buf)

    p = PinnedPool(alloc, lambda addr: live.pop(addr))
    p.live = live
    return p


def test_a_block_lives_while_a_view_does(pool):
    a = pool.empty((4, 8), np.float32)
    assert a.flags.writeable and a.dtype == np.float32 and a.shape == (4, 8)
    a[:] = 3.0
    view = a[1:, ::2]
    del a
    gc.collect()
    assert pool.stats()["in_use_bytes"] == 128
    assert np.all(view == 3.0)
    del view
    gc.collect()
    st = pool.stats()
    assert (st["in_use_bytes"], st["free_bytes"], st["free_blocks"]) == \
        (0, 128, 1)


def test_one_free_block_per_size_the_rest_freed(pool):
    held = [pool.empty((16,), np.float32) for _ in range(3)]
    other = pool.empty((5,), np.float64)
    assert pool.stats()["host_allocs"] == 4
    del held, other
    gc.collect()
    st = pool.stats()
    assert st["free_blocks"] == 2 and st["free_bytes"] == 64 + 40
    assert st["host_frees"] == 2 and len(pool.live) == 2
    assert st["pinned_bytes"] == st["free_bytes"]


def test_a_dropped_block_is_reused(pool):
    first = pool.empty((32,), np.float32)
    addr = first.__array_interface__["data"][0]
    del first
    gc.collect()
    second = pool.empty((8, 4), np.float32)
    assert second.__array_interface__["data"][0] == addr
    st = pool.stats()
    assert (st["host_allocs"], st["reuses"], st["free_blocks"]) == (1, 1, 0)
    third = pool.empty((32,), np.float32)       # the second is held
    assert not np.shares_memory(second, third)
    assert pool.stats()["host_allocs"] == 2


def test_empty_arrays_take_no_block(pool):
    a = pool.empty((0, 7), np.float32)
    assert a.shape == (0, 7) and pool.stats()["host_allocs"] == 0
