"""Per-level traffic of a mapping: the port's copy of
``logical_traffic_summary`` from the JAX package's ``core/comm_model.py``.

The rest of that module (``device_comm_graph``, ``generate_model``)
builds communication graphs from compiled XLA programs and waits for the
port of the XLA modules (ROADMAP.md queue 1).
"""

from __future__ import annotations

import numpy as np

from .graph import CommGraph
from .hierarchy import Hierarchy

__all__ = ["logical_traffic_summary"]


def logical_traffic_summary(g: CommGraph, h: Hierarchy,
                            perm: np.ndarray) -> dict:
    """Traffic volume per hierarchy level under assignment ``perm`` —
    reported next to the QAP objective in benchmarks (bytes that cross a
    tray / superblock / pod boundary)."""
    u, v, w = g.edge_list()
    lvl = h.lca_level(perm[u], perm[v])
    out = {}
    for l in range(1, h.k + 1):
        out[f"level_{l}_bytes"] = float(np.sum(w[lvl == l]))
    return out
