"""The host QAP objective (guide §2.1): the port's copy of the JAX
package's ``core/objective.py:qap_objective``.

Conventions: ``perm[u]`` = PE assigned to process u (a bijection).  The
objective is Σ_{(u,v)∈E[C]} C_uv · D(perm[u], perm[v]), each undirected
edge counted once, in float64 on the host — the reference every device
result is reported against.
"""

from __future__ import annotations

import numpy as np

from .graph import CommGraph

__all__ = ["qap_objective"]


def qap_objective(g: CommGraph, h, perm: np.ndarray) -> float:
    """J(C, D, Π) in O(m) using the online distance oracle.  ``h`` is any
    machine model with a vectorized ``distance`` (Hierarchy or
    :class:`~repro_torch.topology.Topology`)."""
    u, v, w = g.edge_list()
    return float(np.sum(w * h.distance(perm[u], perm[v])))
