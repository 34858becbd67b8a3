"""`tree` — the guide's homogeneous hierarchy behind the Topology contract.

A thin wrapper around :class:`repro_torch.core.hierarchy.Hierarchy`: the wrapped
object computes every distance, so results are bit-for-bit identical to
the legacy ``Hierarchy`` path (tested).  It also duck-types the hierarchy
attributes (``factors``, ``distances``, ``k``, ``strides``, ``oracle``) so
the factor-driven construction algorithms run their exact legacy code.
"""

from __future__ import annotations

import numpy as np

from ..core.hierarchy import DistanceOracle, Hierarchy
from .base import Topology, register_topology


@register_topology("tree")
class TreeTopology(Topology):
    """Homogeneous tree hierarchy (guide §2.2): ``factors`` a_1..a_k
    innermost first, ``distances`` d_1..d_k non-decreasing."""

    def __init__(self, factors=None, distances=None, *,
                 hierarchy: Hierarchy | None = None):
        if hierarchy is None:
            hierarchy = Hierarchy(tuple(int(f) for f in factors),
                                  tuple(float(d) for d in distances))
        self.hierarchy = hierarchy

    # ----------------------------------------------------- hierarchy duck
    @property
    def factors(self) -> tuple:
        return self.hierarchy.factors

    @property
    def distances(self) -> tuple:
        return self.hierarchy.distances

    @property
    def k(self) -> int:
        return self.hierarchy.k

    @property
    def strides(self) -> np.ndarray:
        return self.hierarchy.strides

    @property
    def oracle(self) -> DistanceOracle:
        """The wrapped hierarchy's cached oracle — shared with every other
        Mapper/TreeTopology over the same ``Hierarchy`` instance."""
        return self.hierarchy.oracle

    # ------------------------------------------------------------ contract
    @property
    def n_pe(self) -> int:
        return self.hierarchy.n_pe

    def distance(self, p, q):
        return self.hierarchy.distance(p, q)

    def distance_matrix(self) -> np.ndarray:
        return self.hierarchy.distance_matrix()

    def matrix(self) -> np.ndarray:
        return self.hierarchy.oracle.matrix()

    def kernel_params(self) -> tuple:
        strides, dists = self.hierarchy.oracle.kernel_params()
        return ("tree", strides, dists)

    def split(self, pe_ids: np.ndarray) -> "list[np.ndarray] | None":
        """Split a level-l subtree block into its a_l child subtrees.
        ``pe_ids`` must be a full subtree's PE set (the recursion only ever
        produces those); unstructured sets are leaves."""
        pe_ids = np.asarray(pe_ids, dtype=np.int64)
        s = len(pe_ids)
        strides = self.strides
        lvl = int(np.searchsorted(strides, s))
        if lvl >= len(strides) or strides[lvl] != s or lvl <= 1 \
                or s <= self.factors[0]:
            return None
        a = self.factors[lvl - 1]
        return list(pe_ids.reshape(a, s // a))

    def spec_params(self) -> dict:
        return {"factors": [int(f) for f in self.factors],
                "distances": [float(d) for d in self.distances]}
