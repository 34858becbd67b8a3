"""Communication-graph structures as undirected edge lists.

A structure is ``(n, u, v)``: int64 arrays with ``u < v``, every edge
once; weights are the traffic kind's business.  A traffic file describes
one by ``generator``, the name of a file ``structures/<generator>.py``
whose ``build(params)`` makes it, and that generator's parameters.  These
are the benchmark's own generators, so that a change to the program
cannot move the workload.
"""

from __future__ import annotations

import hashlib

import numpy as np

from . import plugins

__all__ = ["build", "content_key", "shape_of"]


def build(params: dict) -> tuple[int, np.ndarray, np.ndarray]:
    """The structure ``params`` describes."""
    n, u, v = plugins.load("structures", params["generator"]).build(params)
    if not (len(u) == len(v) and np.all(u < v) and v.max(initial=-1) < n):
        raise ValueError(f"structure {params!r}: not an edge list with "
                         f"u < v < n")
    return n, u, v


def shape_of(structure) -> dict:
    """What the roofline counts of a structure: processes ``n``, edges
    ``edges`` and the widest neighbour row ``k`` (the largest degree)."""
    n, u, v = structure
    deg = np.bincount(np.concatenate([u, v]), minlength=n)
    return {"n": int(n), "edges": int(len(u)), "k": int(deg.max())}


def content_key(xadj, adjncy) -> str:
    """A key of a CSR adjacency (row pointers, neighbour ids): the same
    for two graphs of one structure, whatever their weights."""
    h = hashlib.blake2b(digest_size=16)
    h.update(np.ascontiguousarray(xadj, dtype=np.int64).tobytes())
    h.update(np.ascontiguousarray(adjncy, dtype=np.int64).tobytes())
    return h.hexdigest()
