"""The nearest-neighbour stencil of a ``dims`` grid (no wrap-around):
2 * d + 1 points in d dimensions, vertex ids row-major (the last
coordinate fastest).  Parameters: ``dims``."""

import numpy as np


def build(params: dict):
    dims = tuple(int(d) for d in params["dims"])
    n = int(np.prod(dims))
    ids = np.arange(n, dtype=np.int64).reshape(dims)
    us, vs = [], []
    for axis in range(len(dims)):
        lo = [slice(None)] * len(dims)
        hi = [slice(None)] * len(dims)
        lo[axis] = slice(0, dims[axis] - 1)
        hi[axis] = slice(1, dims[axis])
        us.append(ids[tuple(lo)].ravel())
        vs.append(ids[tuple(hi)].ravel())
    u, v = np.concatenate(us), np.concatenate(vs)
    order = np.lexsort((v, u))
    return n, u[order], v[order]
