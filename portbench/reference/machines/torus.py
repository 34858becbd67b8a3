"""A k-ary n-cube: ``dims``, the PE id mixed radix with axis 0 fastest;
the distance is the hop count Σ_a min(|Δ_a|, L_a − |Δ_a|)."""

import numpy as np


def distance(p, q, dims) -> np.ndarray:
    p = np.asarray(p, dtype=np.int64)
    q = np.asarray(q, dtype=np.int64)
    out = np.zeros(np.broadcast(p, q).shape, dtype=np.float64)
    for length in dims:
        length = int(length)
        delta = np.abs(p % length - q % length)
        out += np.minimum(delta, length - delta)
        p, q = p // length, q // length
    return out


def make(machine: dict):
    dims = machine["dims"]
    return (lambda p, q: distance(p, q, dims)), int(np.prod(dims))
