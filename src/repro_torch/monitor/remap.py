"""Dirty-region computation for incremental remaps — the port's copy of
the JAX package's ``monitor/remap.py``.

A drift episode usually moves a *fraction* of the traffic; re-solving
the whole QAP throws away the still-good incumbent structure and pays
full construction + refinement.  Instead:

1. ``dirty_vertices`` — processes incident to an edge whose weight
   moved by more than ``rel_tol`` of the baseline weight (new and
   vanished edges always count).
2. ``expand_dirty`` — grow the set ``hops`` steps along the live
   graph's adjacency, so the refinement can trade placement with the
   immediate neighborhood of the shifted region.
3. ``dirty_pair_mask`` — the boolean mask over the plan's *fixed*
   candidate-pair array selecting pairs that touch the dirty set.

``MappingPlan.execute_warm`` consumes the mask by substituting inert
``(u, u)`` self-pairs — the engine's own padding convention — so the
pair array length and the padded device shape are identical to a full
refinement: masking, never re-padding (K2 sees the same P every call).
"""

from __future__ import annotations

import numpy as np

from ..core.graph import CommGraph
from .profiler import _edge_dict


def dirty_vertices(base: CommGraph, live: CommGraph,
                   rel_tol: float = 0.05) -> np.ndarray:
    """Vertices whose incident traffic changed beyond ``rel_tol``
    (relative to the baseline edge; appear/disappear always dirty)."""
    be, le = _edge_dict(base), _edge_dict(live)
    dirty = np.zeros(base.n, dtype=bool)
    for k in be.keys() | le.keys():
        b, l = be.get(k), le.get(k)
        if b is None or l is None or abs(l - b) > rel_tol * b:
            dirty[k[0]] = dirty[k[1]] = True
    return dirty


def expand_dirty(g: CommGraph, dirty: np.ndarray,
                 hops: int = 1) -> np.ndarray:
    """Grow the dirty set ``hops`` steps along ``g``'s adjacency."""
    dirty = np.asarray(dirty, dtype=bool).copy()
    u, v, _ = g.edge_list()
    for _ in range(max(0, int(hops))):
        touch = dirty[u] | dirty[v]
        nxt = dirty.copy()
        np.logical_or.at(nxt, u, touch)
        np.logical_or.at(nxt, v, touch)
        if np.array_equal(nxt, dirty):
            break
        dirty = nxt
    return dirty


def dirty_pair_mask(pairs: np.ndarray, dirty: np.ndarray) -> np.ndarray:
    """Boolean mask over candidate pairs touching a dirty vertex."""
    pairs = np.asarray(pairs)
    if len(pairs) == 0:
        return np.zeros(0, dtype=bool)
    dirty = np.asarray(dirty, dtype=bool)
    return dirty[pairs[:, 0]] | dirty[pairs[:, 1]]
