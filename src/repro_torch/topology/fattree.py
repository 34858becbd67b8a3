"""`fattree` — k-ary fat-tree with per-level up-link costs.

A folded-Clos / fat-tree network: PEs hang off edge switches, switches
aggregate level by level.  A message between PEs whose lowest common
switch sits at level l traverses l up-links and l down-links, so

    D(p, q) = 2 · Σ_{i ≤ l} link_costs[i-1]        (l = LCA level)

— tree-*shaped* like the guide's hierarchy, but parameterized by per-hop
link cost rather than per-level distance, with the up+down doubling made
explicit.  Internally this reduces to a derived ``Hierarchy`` with
``distances = 2·cumsum(link_costs)`` (non-decreasing by construction), so
the closed-form tree kernel path applies unchanged.
"""

from __future__ import annotations

import numpy as np

from ..core.hierarchy import Hierarchy
from .base import register_topology
from .tree import TreeTopology


@register_topology("fattree")
class FatTreeTopology(TreeTopology):
    """``arities`` = ports per switch level (innermost first, like the
    hierarchy's factors); ``link_costs`` = cost of one up-link at each
    level (default 1.0 each — pure hop count)."""

    def __init__(self, arities, link_costs=None):
        arities = tuple(int(a) for a in arities)
        if link_costs is None:
            link_costs = [1.0] * len(arities)
        link_costs = tuple(float(c) for c in link_costs)
        if len(link_costs) != len(arities):
            raise ValueError("fattree arities and link_costs differ "
                             "in length")
        if any(c < 0 for c in link_costs):
            raise ValueError("fattree link costs must be >= 0")
        self.arities = arities
        self.link_costs = link_costs
        dists = tuple(float(2.0 * c) for c in np.cumsum(link_costs))
        super().__init__(hierarchy=Hierarchy(arities, dists))

    def spec_params(self) -> dict:
        return {"arities": list(self.arities),
                "link_costs": list(self.link_costs)}
