"""Hierarchical machine topology and the online distance oracle.

Guide §2.2 and §4.1: the machine is described by
  hierarchy string  S = a_1:a_2:...:a_k   (a_1 cores/processor, a_2
                                           processors/node, a_3 nodes/rack, ...)
  distance string   D = d_1:d_2:...:d_k   (distance between PEs sharing a
                                           processor, a node, a rack, ...)

`--distance_construction_algorithm=hierarchy` materializes the full n×n
matrix; `hierarchyonline` computes distances on the fly — mandatory for the
n where a dense matrix would not fit.  Both are implemented; they agree
bit-for-bit (tested).

TPU fleet presets map the paper's supercomputer levels onto a v5e fleet:
chip → tray (ICI hop) → superblock (several ICI hops) → pod (DCN).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Hierarchy:
    """Homogeneous machine hierarchy with per-level distances."""

    factors: tuple[int, ...]     # a_1 .. a_k  (innermost first)
    distances: tuple[float, ...]  # d_1 .. d_k

    def __post_init__(self):
        if len(self.factors) != len(self.distances):
            raise ValueError("hierarchy and distance strings differ in length")
        if any(f <= 0 for f in self.factors):
            raise ValueError("hierarchy factors must be positive")
        if any(self.distances[i] > self.distances[i + 1]
               for i in range(len(self.distances) - 1)):
            raise ValueError("distances must be non-decreasing up the tree")

    # ------------------------------------------------------------ properties
    @property
    def n_pe(self) -> int:
        return int(np.prod(self.factors))

    @property
    def k(self) -> int:
        return len(self.factors)

    # strides[l] = number of PEs in a level-l subtree (strides[0]=1 core)
    # cached: the distance oracle reads strides on every call and this sits
    # in the innermost loop of every search driver.  Do not mutate.
    @functools.cached_property
    def strides(self) -> np.ndarray:
        s = np.concatenate([[1], np.cumprod(self.factors)]).astype(np.int64)
        s.setflags(write=False)
        return s

    # --------------------------------------------------------------- oracle
    def distance(self, p, q):
        """Online distance oracle D(p, q): vectorized, O(k), no n×n matrix.

        The distance is d_l where l is the *lowest* level at which p and q
        fall into the same subtree (i.e. the LCA level).  D(p, p) = 0.
        """
        p = np.asarray(p, dtype=np.int64)
        q = np.asarray(q, dtype=np.int64)
        out = np.zeros(np.broadcast(p, q).shape, dtype=np.float64)
        strides = self.strides
        # level l (1-based): same subtree iff p // strides[l] == q // strides[l]
        for lvl in range(self.k, 0, -1):
            same = (p // strides[lvl]) == (q // strides[lvl])
            out = np.where(same & (p != q), self.distances[lvl - 1], out)
        return out if out.ndim else float(out)

    def distance_matrix(self) -> np.ndarray:
        """Materialized D (the guide's `hierarchy` construction) — small n only."""
        idx = np.arange(self.n_pe)
        return self.distance(idx[:, None], idx[None, :])

    def lca_level(self, p, q):
        """Level (1-based) of the lowest common subtree; 0 for p == q."""
        p = np.asarray(p, dtype=np.int64)
        q = np.asarray(q, dtype=np.int64)
        out = np.full(np.broadcast(p, q).shape, self.k, dtype=np.int64)
        strides = self.strides
        for lvl in range(self.k - 1, 0, -1):
            same = (p // strides[lvl]) == (q // strides[lvl])
            out = np.where(same, lvl, out)
        return np.where(p == q, 0, out)

    # ---------------------------------------------------------------- parse
    @staticmethod
    def from_strings(hierarchy_parameter_string: str,
                     distance_parameter_string: str) -> "Hierarchy":
        """Parse the guide's ``2:2:...`` / ``1:10:...`` flag syntax."""
        f = tuple(int(x) for x in hierarchy_parameter_string.split(":") if x)
        d = tuple(float(x) for x in distance_parameter_string.split(":") if x)
        return Hierarchy(f, d)

    # --------------------------------------------------------- cached oracle
    @functools.cached_property
    def oracle(self) -> "DistanceOracle":
        """The precomputed distance oracle, built once per Hierarchy
        instance and shared by every Mapper session over it."""
        return DistanceOracle(self)


class DistanceOracle:
    """Precomputed distance-oracle state for one :class:`Hierarchy`.

    Holds the stride/distance arrays the online oracle needs (so hot loops
    never rebuild them) and memoizes the materialized n×n matrix (the
    guide's ``hierarchy`` distance construction) on first request.  Built
    at most once per ``Hierarchy`` via the cached ``Hierarchy.oracle``
    property; ``Mapper.cache_info()`` reports whether a session triggered
    that build.
    """

    def __init__(self, h: Hierarchy):
        self.hierarchy = h
        self.n_pe = h.n_pe
        self.strides = h.strides
        self.distances = np.asarray(h.distances, dtype=np.float64)
        self._matrix: np.ndarray | None = None

    def distance(self, p, q):
        """Same semantics as :meth:`Hierarchy.distance` (tested equal)."""
        return self.hierarchy.distance(p, q)

    def matrix(self) -> np.ndarray:
        """Materialized D, computed once and cached — small n only."""
        if self._matrix is None:
            self._matrix = self.hierarchy.distance_matrix()
            self._matrix.setflags(write=False)
        return self._matrix

    # static kernel parameters (hashable) for the CUDA objective kernel
    def kernel_params(self) -> tuple[tuple, tuple]:
        return tuple(int(s) for s in self.strides), tuple(self.hierarchy.distances)


# ----------------------------------------------------------------- presets
def tpu_v5e_fleet(pods: int = 2) -> Hierarchy:
    """A v5e fleet: 16 chips/tray-group, 4 groups/superblock, 4 superblocks/pod.

    Distances calibrated to relative link quality: 1 within a tray group
    (1 ICI hop), 2 within a superblock, 6 across superblocks (multi-hop ICI),
    60 across pods (DCN vs ICI is ~1-2 orders of magnitude).
    """
    if pods == 1:
        return Hierarchy((16, 4, 4), (1.0, 2.0, 6.0))
    return Hierarchy((16, 4, 4, pods), (1.0, 2.0, 6.0, 60.0))


def supermuc_like() -> Hierarchy:
    """The guide's motivating SuperMUC-style hierarchy (island/node/core)."""
    return Hierarchy((16, 32, 18), (1.0, 10.0, 100.0))
