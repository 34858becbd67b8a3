"""`dragonfly` — the hierarchical min-hop model of a dragonfly network.

Standard dragonfly (Kim et al.): ``pes_per_router`` terminals per router,
``routers_per_group`` routers all-to-all connected inside a group by local
links, ``n_groups`` groups all-to-all connected by global links.  Min-hop
distance classes:

    same router                  → d_router          (through one router)
    same group, different router → d_local           (one local link)
    different groups             → 2·d_local + d_global
                                   (local hop to the gateway router, one
                                    global link, local hop at the far end —
                                    the canonical worst-case l-g-l route)

Three distance classes keyed by the lowest common enclosure — i.e. a
three-level hierarchy with factors (p, a, g); the derived ``Hierarchy``
reuses the closed-form tree kernel path.  Distance monotonicity
(d_router ≤ d_local ≤ 2·d_local + d_global) is validated on build.
"""

from __future__ import annotations

from ..core.hierarchy import Hierarchy
from .base import register_topology
from .tree import TreeTopology


@register_topology("dragonfly")
class DragonflyTopology(TreeTopology):
    def __init__(self, pes_per_router: int = 4, routers_per_group: int = 8,
                 n_groups: int = 9, d_router: float = 1.0,
                 d_local: float = 2.0, d_global: float = 10.0):
        self.pes_per_router = int(pes_per_router)
        self.routers_per_group = int(routers_per_group)
        self.n_groups = int(n_groups)
        self.d_router = float(d_router)
        self.d_local = float(d_local)
        self.d_global = float(d_global)
        if min(d_router, d_local, d_global) < 0:
            raise ValueError("dragonfly link costs must be >= 0")
        if d_router > d_local:
            raise ValueError("dragonfly expects d_router <= d_local "
                             "(a local link crosses at least one router)")
        factors = (self.pes_per_router, self.routers_per_group,
                   self.n_groups)
        dists = (self.d_router, self.d_local,
                 2.0 * self.d_local + self.d_global)
        super().__init__(hierarchy=Hierarchy(factors, dists))

    def spec_params(self) -> dict:
        return {"pes_per_router": self.pes_per_router,
                "routers_per_group": self.routers_per_group,
                "n_groups": self.n_groups,
                "d_router": self.d_router,
                "d_local": self.d_local,
                "d_global": self.d_global}
