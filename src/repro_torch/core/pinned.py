"""Page-locked host blocks that the port owns: the gain call's readback.

``plan.read_back`` copies G from the card into page-locked memory, which
the link fills at its full rate (a pageable copy runs at a fraction of
it).  The blocks come from ``csrc/host_alloc.cu`` (``cudaHostAlloc`` /
``cudaFreeHost``), not from PyTorch's caching host allocator: that cache
is shared by all the code of the process, and the port neither takes
from it nor empties it.

A block handed out as a numpy array stays pinned while any view of the
array lives (the views' base is the block's buffer).  When the last one
dies a ``weakref.finalize`` gives the block back to the pool, which
keeps at most one free block of each size and frees every other at
once.  So a call whose earlier result of its size was dropped reuses
that block and pays no ``cudaHostAlloc``, and the pool never holds more
than the arrays in use plus one free block per size it has served.

PyTorch's ``torch.cuda.host_memory_stats()`` does not see these blocks:
:func:`stats` counts them (bytes pinned, in use and free, and the
allocations, frees and reuses made).
"""

from __future__ import annotations

import ctypes
import functools
import threading
import weakref

import numpy as np

__all__ = ["PinnedPool", "POOL", "empty", "stats"]


class PinnedPool:
    """Blocks from ``alloc(nbytes) -> address``, returned with
    ``free(address)``; at most one free block of each size is kept."""

    def __init__(self, alloc, free):
        self._alloc, self._release = alloc, free
        self._lock = threading.RLock()     # a finalizer may run inside
        self._free: dict = {}              # nbytes -> address
        self._in_use = {"bytes": 0, "blocks": 0}
        self._counts = {"host_allocs": 0, "host_frees": 0, "reuses": 0}

    def empty(self, shape, dtype) -> np.ndarray:
        """An uninitialised, writable array on a page-locked block."""
        dtype = np.dtype(dtype)
        count = int(np.prod(shape, dtype=np.int64))
        nbytes = count * dtype.itemsize
        if nbytes == 0:
            return np.empty(shape, dtype)
        with self._lock:
            addr = self._free.pop(nbytes, None)
        made = addr is None
        if made:
            addr = self._alloc(nbytes)
        with self._lock:
            self._counts["host_allocs" if made else "reuses"] += 1
            self._in_use["bytes"] += nbytes
            self._in_use["blocks"] += 1
        buf = (ctypes.c_ubyte * nbytes).from_address(addr)
        # no call into CUDA at interpreter exit: the OS takes the rest
        weakref.finalize(buf, self._give_back, addr, nbytes).atexit = False
        return np.frombuffer(buf, dtype=dtype, count=count).reshape(shape)

    def _give_back(self, addr: int, nbytes: int) -> None:
        with self._lock:
            self._in_use["bytes"] -= nbytes
            self._in_use["blocks"] -= 1
            if nbytes not in self._free:
                self._free[nbytes] = addr
                return
            self._counts["host_frees"] += 1
        self._release(addr)

    def stats(self) -> dict:
        """Bytes pinned (in use + free), in use and free; blocks in use
        and free; allocations, frees and reuses so far."""
        with self._lock:
            free = sum(self._free)
            return {"pinned_bytes": self._in_use["bytes"] + free,
                    "in_use_bytes": self._in_use["bytes"],
                    "free_bytes": free,
                    "blocks_in_use": self._in_use["blocks"],
                    "free_blocks": len(self._free), **self._counts}


@functools.lru_cache(maxsize=None)
def _library():
    from ..kernels.cuda import load
    lib = load("host_alloc")
    lib.viem_host_alloc.argtypes = [ctypes.c_size_t,
                                    ctypes.POINTER(ctypes.c_void_p)]
    lib.viem_host_alloc.restype = ctypes.c_int
    lib.viem_host_free.argtypes = [ctypes.c_void_p]
    lib.viem_host_free.restype = ctypes.c_int
    return lib


def _cuda_alloc(nbytes: int) -> int:
    from ..kernels.cuda import raise_on_error
    lib = _library()
    addr = ctypes.c_void_p()
    raise_on_error(lib, lib.viem_host_alloc(nbytes, ctypes.byref(addr)),
                   f"cudaHostAlloc of {nbytes} bytes")
    return addr.value


def _cuda_free(addr: int) -> None:
    from ..kernels.cuda import raise_on_error
    lib = _library()
    raise_on_error(lib, lib.viem_host_free(addr), "cudaFreeHost")


POOL = PinnedPool(_cuda_alloc, _cuda_free)
empty = POOL.empty
stats = POOL.stats
