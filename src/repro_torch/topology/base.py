"""The distance-oracle contract every machine model implements.

The guide frames process mapping as *sparse quadratic assignment against an
arbitrary distance matrix* — the machine model is whatever defines
D(p, q).  A :class:`Topology` is exactly that definition plus the three
hooks the rest of the framework needs:

  distance(p, q)     — vectorized online oracle (numpy, float64); the hot
                       path of every search driver, so no n×n materialize.
  matrix()           — the materialized D, cached (the guide's `hierarchy`
                       distance construction; small-n only).
  kernel_params()    — hashable descriptor of the device-side distance
                       representation.  ("tree", strides, dists) and
                       ("torus", dims, weights) select closed-form device
                       oracles computed in-register; ("matrix",
                       fingerprint) selects the gather path.  Both the
                       CUDA objective/gain kernels and the refinement
                       engine (``repro_torch.engine``) consume it, and the
                       Mapper keys its kernel and engine caches on it.
  split(pe_ids)      — the machine's natural recursive decomposition, used
                       by the top-down construction in place of hierarchy
                       factors.  Returns equal-size(±1) sub-groups of PE
                       ids, or None for a leaf.

Backends register with ``@register_topology("name")`` and become
addressable from :class:`~repro_torch.core.spec.TopologySpec`, the ``viem`` CLI
(``--topology=name``), and ``Mapper`` — the same plug-in pattern as
``@register_construction``.
"""

from __future__ import annotations

import abc
from typing import Callable

import numpy as np


class Topology(abc.ABC):
    """A machine model behind the distance-oracle contract.

    Subclasses must define ``kind`` (the registry name), ``n_pe`` and
    ``distance``; everything else has contract-respecting defaults.
    """

    kind: str = "abstract"

    # ------------------------------------------------------------- contract
    @property
    @abc.abstractmethod
    def n_pe(self) -> int:
        """Number of processing elements."""

    @abc.abstractmethod
    def distance(self, p, q):
        """Online distance oracle D(p, q): vectorized over numpy arrays,
        symmetric, zero on the diagonal, no n×n materialization."""

    def distance_matrix(self) -> np.ndarray:
        """Materialized D (computed fresh; see :meth:`matrix` for the
        cached form) — small n only."""
        idx = np.arange(self.n_pe)
        return self.distance(idx[:, None], idx[None, :])

    def matrix(self) -> np.ndarray:
        """Materialized D, computed once per instance and cached."""
        m = getattr(self, "_matrix", None)
        if m is None:
            m = self.distance_matrix()
            m.setflags(write=False)
            self._matrix = m
        return m

    def kernel_params(self) -> tuple:
        """Hashable device-side distance representation.  The default is
        the explicit-matrix path: the CUDA objective and the refinement
        engine gather from the materialized D (fingerprint keys the
        Mapper's kernel and engine caches)."""
        return ("matrix", self._fingerprint())

    def split(self, pe_ids: np.ndarray) -> "list[np.ndarray] | None":
        """Natural recursive decomposition of the PE set ``pe_ids``:
        a list of equal-size(±1) sub-arrays whose union is ``pe_ids``,
        or ``None`` when the set has no further structure (leaf — the
        construction assigns ranks arbitrarily)."""
        return None

    # ---------------------------------------------------------------- spec
    def spec_params(self) -> dict:
        """JSON-safe constructor parameters: ``make_topology(self.kind,
        **self.spec_params())`` rebuilds an equivalent topology."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support spec round-trips")

    # -------------------------------------------------------------- helpers
    def _fingerprint(self) -> int:
        fp = getattr(self, "_fp", None)
        if fp is None:
            fp = hash((self.kind, self.n_pe,
                       self.matrix().tobytes()))
            self._fp = fp
        return fp

    def validate(self) -> "Topology":
        """Cheap sanity checks of the contract on a small sample."""
        n = self.n_pe
        if n <= 0:
            raise ValueError(f"{self.kind}: n_pe must be positive, got {n}")
        idx = np.arange(min(n, 64))
        d_self = np.asarray(self.distance(idx, idx))
        if np.any(d_self != 0.0):
            raise ValueError(f"{self.kind}: D(p, p) must be 0")
        return self

    def __repr__(self):
        return f"<{type(self).__name__} kind={self.kind!r} n_pe={self.n_pe}>"


# ------------------------------------------------------------------ registry
TOPOLOGIES: dict[str, Callable[..., Topology]] = {}


def register_topology(name: str) -> Callable:
    """Register a ``Topology`` subclass (or factory) under ``name``.

    Registered names auto-populate the ``viem`` CLI ``--topology`` choices
    and are valid ``TopologySpec.kind`` values."""
    def deco(factory):
        if name in TOPOLOGIES:
            raise ValueError(f"topology {name!r} is already registered")
        TOPOLOGIES[name] = factory
        if isinstance(factory, type):
            factory.kind = name
        return factory
    return deco


def resolve_topology(name: str) -> Callable[..., Topology]:
    try:
        return TOPOLOGIES[name]
    except KeyError:
        raise ValueError(
            f"unknown topology {name!r}; registered: "
            f"{sorted(TOPOLOGIES)}") from None


def list_topologies() -> list[str]:
    return sorted(TOPOLOGIES)


def make_topology(kind: str, **params) -> Topology:
    """Build a registered topology from JSON-safe parameters."""
    return resolve_topology(kind)(**params)


def as_topology(machine) -> Topology:
    """Coerce a machine model to the Topology contract.

    ``Hierarchy`` instances wrap into a :class:`TreeTopology` sharing the
    *same* ``Hierarchy`` object (so its cached distance oracle is reused
    and results stay bit-for-bit identical); topologies pass through."""
    if isinstance(machine, Topology):
        return machine
    from ..core.hierarchy import Hierarchy
    if isinstance(machine, Hierarchy):
        from .tree import TreeTopology
        return TreeTopology(hierarchy=machine)
    raise TypeError(f"cannot interpret {type(machine).__name__} as a "
                    f"machine topology")


def balanced_halves(D: np.ndarray, pe_ids: np.ndarray) -> list[np.ndarray]:
    """Generic 2-way decomposition for matrix-defined machines: seed with
    an (approximate) farthest pair, then split the ids into two balanced
    halves by which seed each PE is closer to (ties/balance resolved by
    the margin ordering).  Deterministic."""
    ids = np.asarray(pe_ids, dtype=np.int64)
    sub = D[np.ix_(ids, ids)]
    s1 = int(np.argmax(sub[0]))
    s2 = int(np.argmax(sub[s1]))
    if s1 == s2:                       # all-zero distances: arbitrary halves
        mid = (len(ids) + 1) // 2
        return [ids[:mid], ids[mid:]]
    margin = sub[s1] - sub[s2]         # >0 → closer to seed 2
    order = np.argsort(margin, kind="stable")
    mid = (len(ids) + 1) // 2
    return [ids[np.sort(order[:mid])], ids[np.sort(order[mid:])]]
