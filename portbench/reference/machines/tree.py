"""A hierarchy (Schulz & Träff, SEA 2017, §2): ``factors`` a_1:…:a_k,
innermost first (a_1 PEs share a processor, a_2 processors a node, …),
and ``distances`` d_1:…:d_k.  Two PEs p ≠ q are at distance d_l for the
lowest level l whose subtrees, of a_1·…·a_l consecutive PE ids, hold
both; D(p, p) = 0."""

import numpy as np


def distance(p, q, factors, distances) -> np.ndarray:
    p = np.asarray(p, dtype=np.int64)
    q = np.asarray(q, dtype=np.int64)
    out = np.zeros(np.broadcast(p, q).shape, dtype=np.float64)
    settled = p == q
    size = 1
    for a, d in zip(factors, distances):
        size *= int(a)
        here = ~settled & (p // size == q // size)
        out[here] = float(d)
        settled |= here
    if not settled.all():
        raise ValueError("PE id outside the machine")
    return out


def make(machine: dict):
    f, d = machine["factors"], machine["distances"]
    return (lambda p, q: distance(p, q, f, d)), int(np.prod(f))
