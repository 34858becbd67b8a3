"""A random geometric graph: ``n`` points uniform in the unit square
from ``structure_seed``, an edge between every two closer than
``radius``.  Parameters: ``n``, ``radius``, ``structure_seed``."""

import numpy as np


def build(params: dict):
    n, radius = int(params["n"]), float(params["radius"])
    rng = np.random.default_rng(int(params["structure_seed"]))
    pts = rng.random((n, 2))
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    u, v = np.nonzero(np.triu(d2 < radius * radius, k=1))
    if len(u) == 0:
        raise ValueError(f"random_geometric({n}, {radius}) has no edge")
    return n, u.astype(np.int64), v.astype(np.int64)
