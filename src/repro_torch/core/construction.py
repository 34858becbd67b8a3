"""Initial mapping construction algorithms (guide §2.2, §4.1).

``--construction_algorithm=`` one of
  identity, random, growing, hierarchybottomup, hierarchytopdown (default).

All return ``perm`` with perm[u] = PE assigned to process u (a bijection on
[0, n)).  n must equal the machine's PE count.

``h`` is the machine model: a legacy ``Hierarchy`` / tree-family topology
(runs the guide's exact factor-driven recursion) or any
:class:`~repro_torch.topology.Topology` — ``hierarchytopdown`` then recurses
through the topology's ``split()`` hook instead of hierarchy factors.

Algorithms live in a registry: decorate a ``fn(g, h, *, seed, cfg)`` with
``@register_construction("name")`` and it becomes addressable from
``MappingSpec``, the ``viem`` CLI (auto-populated ``choices``), and
``Mapper`` — no core edits needed.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from .graph import CommGraph, contract
from .hierarchy import Hierarchy
from .partition import PartitionConfig, partition


def quotient(g: CommGraph, labels: np.ndarray, k: int) -> CommGraph:
    """Cluster quotient graph: vertices = blocks, edge weights = summed
    inter-block communication (the guide's `generate_model` semantics).
    A thin alias of the shared :func:`repro_torch.core.graph.contract`."""
    return contract(g, labels, k)


# ---------------------------------------------------------------- registry
CONSTRUCTIONS: dict[str, Callable] = {}


def register_construction(name: str) -> Callable:
    """Register ``fn(g, h, *, seed, cfg)`` as a construction algorithm.

    Registered names auto-populate CLI ``choices`` and are valid
    ``MappingSpec.construction`` values."""
    def deco(fn: Callable) -> Callable:
        if name in CONSTRUCTIONS:
            raise ValueError(f"construction {name!r} is already registered")
        CONSTRUCTIONS[name] = fn
        return fn
    return deco


def resolve_construction(name: str) -> Callable:
    try:
        return CONSTRUCTIONS[name]
    except KeyError:
        raise ValueError(
            f"unknown construction algorithm {name!r}; registered: "
            f"{sorted(CONSTRUCTIONS)}") from None


def list_constructions() -> list[str]:
    return sorted(CONSTRUCTIONS)


# ------------------------------------------------------------ constructions
@register_construction("identity")
def identity_construction(g: CommGraph, h: Hierarchy, **_) -> np.ndarray:
    return np.arange(g.n, dtype=np.int64)


@register_construction("random")
def random_construction(g: CommGraph, h: Hierarchy, seed: int = 0,
                        **_) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.permutation(g.n).astype(np.int64)


@register_construction("growing")
def growing_construction(g: CommGraph, h: Hierarchy, seed: int = 0,
                         **_) -> np.ndarray:
    """Greedy graph growing: repeatedly take the unassigned process with the
    strongest communication to the already-assigned set and give it the next
    PE — consecutive PEs are hierarchy-close, so strongly-communicating
    processes land close."""
    rng = np.random.default_rng(seed)
    n = g.n
    perm = np.full(n, -1, dtype=np.int64)
    attraction = np.full(n, -np.inf)
    start = int(rng.integers(n))
    attraction[start] = 0.0
    for rank in range(n):
        u = int(np.argmax(attraction))
        if attraction[u] == -np.inf:   # disconnected component: restart
            u = int(np.nonzero(perm < 0)[0][0])
        perm[u] = rank
        attraction[u] = -np.inf
        nb, wt = g.neighbors(u), g.weights(u)
        una = perm[nb] < 0
        upd = nb[una]
        a = attraction[upd]
        attraction[upd] = np.where(a == -np.inf, wt[una], a + wt[una])
    return perm


@register_construction("hierarchytopdown")
def hierarchy_top_down(g: CommGraph, h, seed: int = 0,
                       cfg: PartitionConfig | None = None, **_) -> np.ndarray:
    """The guide's most successful strategy: recursively partition G_C into
    perfectly balanced blocks matching the machine's natural decomposition,
    assign each block to one machine sub-group, recurse; the base case
    assigns ranks arbitrarily (all intra-leaf distances are equal).

    Tree-family machines (anything exposing hierarchy ``factors``) run the
    guide's exact factor-driven recursion; every other topology drives the
    recursion through its ``split()`` hook (torus sub-boxes, matrix
    farthest-pair halves, ...)."""
    if g.n != h.n_pe:
        raise ValueError(f"n processes ({g.n}) != n PEs ({h.n_pe})")
    cfg = cfg or PartitionConfig()
    if not hasattr(h, "factors"):
        return _split_top_down(g, h, seed, cfg)
    perm = np.full(g.n, -1, dtype=np.int64)
    factors = h.factors

    def rec(nodes: np.ndarray, lvl: int, base: int, seed_: int):
        if lvl <= 1 or len(nodes) <= factors[0]:
            perm[nodes] = base + np.arange(len(nodes))
            return
        a = factors[lvl - 1]
        sub, back = g.subgraph(nodes)
        labels = partition(sub, a, cfg, seed=seed_)
        stride = len(nodes) // a
        for b in range(a):
            rec(back[labels == b], lvl - 1, base + b * stride, seed_ * a + b + 1)

    rec(np.arange(g.n, dtype=np.int64), h.k, 0, seed)
    return perm


def _fit_block_sizes(labels: np.ndarray, k: int,
                     sizes: np.ndarray) -> np.ndarray:
    """Force block cardinalities to the target ``sizes`` by moving
    vertices from over-full to under-full blocks (the partitioner balances
    to n/k ± 1; split() parts can differ by one for odd sets)."""
    counts = np.bincount(labels, minlength=k)
    if np.array_equal(counts, sizes):
        return labels
    labels = labels.copy()
    for b_u in range(k):
        while counts[b_u] < sizes[b_u]:
            b_o = next(b for b in range(k) if counts[b] > sizes[b])
            v = np.nonzero(labels == b_o)[0][-1]
            labels[v] = b_u
            counts[b_o] -= 1
            counts[b_u] += 1
    return labels


def _split_top_down(g: CommGraph, topo, seed: int,
                    cfg: PartitionConfig) -> np.ndarray:
    """Generic top-down recursion over the topology's ``split()`` hook:
    partition the processes into blocks sized like the machine's natural
    sub-groups, assign block b to sub-group b, recurse."""
    perm = np.full(g.n, -1, dtype=np.int64)

    def rec(nodes: np.ndarray, pes: np.ndarray, seed_: int):
        parts = topo.split(pes) if len(nodes) > 1 else None
        if not parts or len(parts) <= 1:
            perm[nodes] = pes[:len(nodes)]
            return
        a = len(parts)
        sizes = np.array([len(p) for p in parts])
        sub, back = g.subgraph(nodes)
        labels = _fit_block_sizes(partition(sub, a, cfg, seed=seed_),
                                  a, sizes)
        for b, part in enumerate(parts):
            rec(back[labels == b], part, seed_ * a + b + 1)

    rec(np.arange(g.n, dtype=np.int64),
        np.arange(topo.n_pe, dtype=np.int64), seed)
    return perm


@register_construction("hierarchybottomup")
def hierarchy_bottom_up(g: CommGraph, h, seed: int = 0,
                        cfg: PartitionConfig | None = None, **_) -> np.ndarray:
    """Bottom-up: cluster processes into processors (blocks of a_1), build
    the quotient graph, cluster processors into nodes (blocks of a_2), …
    PE index = mixed-radix digits collected along the way."""
    if not hasattr(h, "factors"):
        raise ValueError(
            "hierarchybottomup needs a tree-family machine (hierarchy "
            f"factors); topology kind {getattr(h, 'kind', '?')!r} has "
            "none — use hierarchytopdown (split-driven) or growing")
    if g.n != h.n_pe:
        raise ValueError(f"n processes ({g.n}) != n PEs ({h.n_pe})")
    cfg = cfg or PartitionConfig()
    strides = h.strides
    offset = np.zeros(g.n, dtype=np.int64)      # accumulated PE offset
    cluster = np.arange(g.n, dtype=np.int64)    # current cluster of process
    cur = g
    for lvl, a in enumerate(h.factors):
        n_blocks = cur.n // a
        if n_blocks <= 1:
            labels = np.zeros(cur.n, dtype=np.int64)
        else:
            labels = partition(cur, n_blocks, cfg, seed=seed + lvl)
        # digit = position of each cluster within its block (stable order)
        digit = np.zeros(cur.n, dtype=np.int64)
        for b in range(max(1, n_blocks)):
            members = np.nonzero(labels == b)[0]
            digit[members] = np.arange(len(members))
        offset += digit[cluster] * strides[lvl]
        cluster = labels[cluster]
        cur = quotient(cur, labels, max(1, n_blocks))
        # clusters are equal-sized by construction — balance currency for
        # the next level is cluster cardinality, so weights reset to 1.
        cur.vwgt = np.ones(cur.n)
    return offset


def construct(name: str, g: CommGraph, h: Hierarchy, seed: int = 0,
              preconfiguration: str = "eco") -> np.ndarray:
    fn = resolve_construction(name)
    cfg = PartitionConfig.preconfiguration(preconfiguration)
    return fn(g, h, seed=seed, cfg=cfg)
