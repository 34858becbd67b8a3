"""Pair-exchange local search (guide §2.1): the port's copy of the JAX
package's ``core/local_search.py`` — search statistics, the neighborhood
registry, the candidate-pair generators and the host search drivers
(``_cyclic_search``, ``local_search``, ``parallel_sweep_search``) behind
``engine="host"``.  The device engine (:mod:`repro_torch.engine`) is the
port's ``engine="device"`` search.

``--local_search_neighborhood=`` one of
  nsquare        — Heider's cyclic N² pair exchange,
  nsquarepruned  — Brandfass et al.'s pruned N²,
  communication  — the paper's N_C^d neighborhood over the communication
                   graph (default, with --communication_neighborhood_dist=10).

All variants use the paper's *sparse* O(deg) gain (objective.swap_gain) and
update the objective incrementally — the guide's central speedup over the
O(n)-per-swap dense formulation.

Neighborhoods live in a registry: ``@register_neighborhood("name")``
wraps a candidate-pair generator ``fn(g, *, dist, max_pairs)`` — plus a
``seed`` kwarg for randomized generators (auto-detected from the
signature; see :func:`register_neighborhood`) — and makes it addressable
from ``MappingSpec``, the ``viem`` CLI, and ``Mapper`` without touching
core dispatch.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from .graph import CommGraph, csr_expand
from .objective import batched_swap_gains, qap_objective, swap_gain


@dataclass
class SearchStats:
    swaps: int = 0
    evaluated: int = 0
    initial_objective: float = 0.0
    final_objective: float = 0.0
    objective_trace: list = field(default_factory=list)
    # engine counter telemetry (repro.obs.telemetry.EngineTelemetry) —
    # attached by the device engine when collection is requested; host
    # drivers leave it None
    telemetry: object = None


# ---------------------------------------------------------------- registry
@dataclass(frozen=True)
class Neighborhood:
    """A registered candidate-pair generator plus its driver policy
    (``shuffle`` — whether the sequential search visits pairs in random
    order, the guide's behavior for the communication neighborhood).
    ``weight_dependent`` declares that the generator reads edge weights;
    it widens the Mapper's candidate-pair cache key so same-structure,
    different-weight graphs are not served stale pairs.  ``seeded``
    declares that the generator reads its ``seed`` keyword; deterministic
    generators set it False, are called *without* a seed (so a signature
    cannot silently advertise randomness it does not have), and share one
    Mapper pair-cache entry across seeds."""
    name: str
    pairs: Callable          # fn(g, *, dist, max_pairs[, seed]) -> (P, 2) i64
    shuffle: bool = False
    weight_dependent: bool = False
    seeded: bool = False

    def generate(self, g: CommGraph, *, dist: int, seed: int,
                 max_pairs: int) -> np.ndarray:
        """Invoke the generator, forwarding ``seed`` only when it
        declares it uses one."""
        kw = {"dist": dist, "max_pairs": max_pairs}
        if self.seeded:
            kw["seed"] = seed
        return self.pairs(g, **kw)


NEIGHBORHOODS: dict[str, Neighborhood] = {}


def register_neighborhood(name: str, shuffle: bool = False,
                          weight_dependent: bool = False,
                          seeded: bool | None = None) -> Callable:
    """Register ``fn(g, *, dist, max_pairs)`` (or, when seeded,
    ``fn(g, *, dist, seed, max_pairs)``) as a local-search neighborhood.
    Registered names auto-populate CLI ``choices`` and are valid
    ``MappingSpec.neighborhood`` values.  Pass ``weight_dependent=True``
    if the generator reads ``g.adjwgt``.

    ``seeded`` defaults to signature inspection: a generator that names
    an explicit ``seed`` parameter receives the spec's seed (and its
    pair sets are cached per seed); one that does not is treated as
    deterministic — advertising a seed and silently ignoring it is no
    longer possible.  Pass ``seeded`` explicitly to override (e.g. a
    ``**kwargs`` generator that does sample)."""
    def deco(fn: Callable) -> Callable:
        if name in NEIGHBORHOODS:
            raise ValueError(f"neighborhood {name!r} is already registered")
        is_seeded = seeded
        if is_seeded is None:
            import inspect
            is_seeded = "seed" in inspect.signature(fn).parameters
        NEIGHBORHOODS[name] = Neighborhood(name, fn, shuffle,
                                           weight_dependent, is_seeded)
        return fn
    return deco


def resolve_neighborhood(name: str) -> Neighborhood:
    try:
        return NEIGHBORHOODS[name]
    except KeyError:
        raise ValueError(
            f"unknown local search neighborhood {name!r}; registered: "
            f"{sorted(NEIGHBORHOODS)}") from None


def list_neighborhoods() -> list[str]:
    return sorted(NEIGHBORHOODS)


def candidate_pairs(name: str, g: CommGraph, dist: int = 10, seed: int = 0,
                    max_pairs: int = 2_000_000) -> np.ndarray:
    """Candidate pairs of the named registered neighborhood."""
    return resolve_neighborhood(name).generate(
        g, dist=dist, seed=seed, max_pairs=max_pairs)


# ------------------------------------------------------------ neighborhoods
def communication_pairs(g: CommGraph, dist: int = 1,
                        max_pairs: int = 2_000_000) -> np.ndarray:
    """Candidate pairs of N_C^dist: processes with graph distance < dist+1
    ... precisely the guide's N_C for dist=1 (endpoints of an edge) and the
    augmented N_C^d for d=dist (graph distance <= dist, i.e. < d+1 hops;
    the guide's 'distance less than d' with its 1-based convention).

    BFS with depth cutoff from every vertex; deduplicated to u < v and
    returned in (u, v)-lexicographic order.  Fully deterministic — no
    seed parameter, and the registry entry declares ``seeded=False`` so
    sessions share one cached pair set across seeds.  If the candidate
    set would exceed ``max_pairs`` the BFS depth is reduced — N_C^d
    degenerates to N² for dense graphs and large d (guide §2.1:
    N_C ⊆ N_C^2 ⊆ … ⊆ N_C^n = N²), so capping is semantically a fallback
    to a smaller d.
    """
    if dist <= 1:
        u, v, _ = g.edge_list()
        return np.stack([u, v], axis=1)
    d = dist
    while True:
        pairs = _bfs_pairs(g, d, max_pairs)
        if pairs is not None:
            return pairs
        d -= 1


# flat neighbor expansions materialized per slice of a BFS level — bounds
# peak memory near the max_pairs cap instead of one whole dense level
_BFS_CHUNK = 4_000_000


def _bfs_pairs(g: CommGraph, depth: int, max_pairs: int) -> np.ndarray | None:
    """All-sources depth-limited BFS as CSR frontier expansion.

    All n BFS trees advance one level per iteration as flat
    (source, vertex) key arrays: a repeat/offset gather expands the
    frontier vertices' CSR rows, and sorted numpy set ops (``unique`` /
    ``isin`` / ``union1d``) deduplicate within the level and against
    everything already seen — no per-vertex Python loop.  Levels are
    expanded in ``_BFS_CHUNK``-bounded slices so the ``max_pairs`` cap
    can fire (returning ``None``; the caller retries with a smaller
    depth — same cap semantics as before) without first materializing a
    whole dense level.  Returns the u < v pairs sorted
    lexicographically."""
    n = g.n
    f_src = np.arange(n, dtype=np.int64)          # frontier: (source,
    f_v = f_src.copy()                            #            vertex) pairs
    seen = f_src * n + f_src                      # sorted unique keys
    out_u: list[np.ndarray] = []
    out_v: list[np.ndarray] = []
    total = 0
    for _ in range(depth):
        cnt_all = g.xadj[f_v + 1] - g.xadj[f_v]
        cum = np.cumsum(cnt_all)
        flat = int(cum[-1]) if len(cum) else 0
        if flat == 0:
            break
        splits = np.searchsorted(cum, np.arange(_BFS_CHUNK, flat,
                                                _BFS_CHUNK)) + 1
        bounds = [0, *splits.tolist(), len(f_v)]
        nxt_src: list[np.ndarray] = []
        nxt_v: list[np.ndarray] = []
        for lo, hi in zip(bounds, bounds[1:]):
            pos, _, cnt = csr_expand(g.xadj, f_v[lo:hi])
            if len(pos) == 0:
                continue
            key = np.unique(np.repeat(f_src[lo:hi], cnt) * n
                            + g.adjncy[pos])
            key = key[~np.isin(key, seen, assume_unique=True)]
            if len(key) == 0:
                continue
            seen = np.union1d(seen, key)
            s_new, v_new = key // n, key % n
            keep = v_new > s_new
            total += int(keep.sum())
            if total > max_pairs:
                return None
            out_u.append(s_new[keep])
            out_v.append(v_new[keep])
            nxt_src.append(s_new)
            nxt_v.append(v_new)
        if not nxt_src:
            break
        f_src = np.concatenate(nxt_src)           # order is irrelevant:
        f_v = np.concatenate(nxt_v)               # dedupe is via `seen`,
                                                  # output is lexsorted
    if total == 0:
        return np.zeros((0, 2), dtype=np.int64)
    pairs = np.stack([np.concatenate(out_u), np.concatenate(out_v)], axis=1)
    return pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))]


def nsquare_pairs(n: int) -> np.ndarray:
    iu, iv = np.triu_indices(n, k=1)
    return np.stack([iu, iv], axis=1).astype(np.int64)


def pruned_pairs(g: CommGraph) -> np.ndarray:
    """Brandfass-style pruning: skip pairs of two isolated processes (their
    swap can never change the objective)."""
    deg = np.diff(g.xadj)
    active = np.nonzero(deg > 0)[0]
    idle = np.nonzero(deg == 0)[0]
    iu, iv = np.triu_indices(len(active), k=1)
    pairs = [np.stack([active[iu], active[iv]], axis=1)]
    if len(idle):
        # active-idle pairs still matter (move an active process elsewhere)
        au = np.repeat(active, len(idle))
        iv2 = np.tile(idle, len(active))
        lo, hi = np.minimum(au, iv2), np.maximum(au, iv2)
        pairs.append(np.stack([lo, hi], axis=1))
    return np.concatenate(pairs, axis=0).astype(np.int64)


# None of the built-in generators is randomized (`seeded=False`): the
# pair sets are pure functions of the graph; the spec's seed drives only
# the sequential driver's shuffle order.
@register_neighborhood("communication", shuffle=True)
def _communication_neighborhood(g: CommGraph, *, dist: int = 10,
                                max_pairs: int = 2_000_000) -> np.ndarray:
    return communication_pairs(g, dist, max_pairs=max_pairs)


@register_neighborhood("nsquare")
def _nsquare_neighborhood(g: CommGraph, **_) -> np.ndarray:
    return nsquare_pairs(g.n)


@register_neighborhood("nsquarepruned")
def _pruned_neighborhood(g: CommGraph, **_) -> np.ndarray:
    return pruned_pairs(g)


# ------------------------------------------------------------------ drivers
def _cyclic_search(g: CommGraph, h, perm: np.ndarray,
                   pairs: np.ndarray, shuffle: bool, seed: int,
                   max_sweeps: int = 50) -> SearchStats:
    """Shared driver: visit candidate pairs cyclically (optionally in random
    order, re-shuffled per cycle), swap on positive gain, terminate after a
    full cycle (|pairs| tries) without success — the guide's termination
    rule ('local search terminates after m unsuccessful swaps')."""
    stats = SearchStats()
    stats.initial_objective = qap_objective(g, h, perm)
    cur = stats.initial_objective
    stats.objective_trace.append(cur)
    if len(pairs) == 0:
        stats.final_objective = cur
        return stats
    rng = np.random.default_rng(seed)
    unsuccessful = 0
    for _sweep in range(max_sweeps):
        order = rng.permutation(len(pairs)) if shuffle else np.arange(len(pairs))
        for idx in order:
            u, v = int(pairs[idx, 0]), int(pairs[idx, 1])
            gain = swap_gain(g, h, perm, u, v)
            stats.evaluated += 1
            if gain > 1e-12:
                perm[u], perm[v] = perm[v], perm[u]
                cur -= gain
                stats.swaps += 1
                stats.objective_trace.append(cur)
                unsuccessful = 0
            else:
                unsuccessful += 1
                if unsuccessful >= len(pairs):
                    stats.final_objective = cur
                    return stats
    stats.final_objective = cur
    return stats


def local_search(g: CommGraph, h, perm: np.ndarray,
                 neighborhood: str = "communication",
                 communication_neighborhood_dist: int = 10,
                 seed: int = 0, max_sweeps: int = 50,
                 max_pairs: int = 2_000_000) -> SearchStats:
    """Improve ``perm`` in place.  Mirrors the guide's §4.1 flags; the
    neighborhood is resolved through the registry."""
    nb = resolve_neighborhood(neighborhood)
    pairs = nb.generate(g, dist=communication_neighborhood_dist, seed=seed,
                        max_pairs=max_pairs)
    return _cyclic_search(g, h, perm, pairs, shuffle=nb.shuffle, seed=seed,
                          max_sweeps=max_sweeps)


# ----------------------------------------------- batched sweep (TPU-shaped)
def parallel_sweep_search(g: CommGraph, h, perm: np.ndarray,
                          pairs: np.ndarray, max_sweeps: int = 64,
                          seed: int = 0) -> SearchStats:
    """TPU-adapted search (DESIGN §3): per sweep, evaluate *all* candidate
    pair gains at once (vectorized sparse gains — or the Pallas swap-gain
    kernel on device for dense n), then greedily apply a maximal set of
    non-conflicting positive-gain swaps (each process in at most one swap).

    Gains of simultaneous swaps interact when the swapped pairs communicate
    or share PE-adjacency, so the batch gains are treated as a *priority
    order*: candidates are applied greedily in descending batched-gain
    order, each verified with an exact O(deg) recomputed gain right before
    application (skip if no longer positive).  The batch does the expensive
    wide evaluation (device-friendly); verification is a cheap sparse pass.
    Objective is monotone by construction.
    """
    stats = SearchStats()
    stats.initial_objective = qap_objective(g, h, perm)
    cur = stats.initial_objective
    stats.objective_trace.append(cur)
    if len(pairs) == 0:
        stats.final_objective = cur
        return stats
    for _sweep in range(max_sweeps):
        gains = batched_swap_gains(g, h, perm, pairs)
        stats.evaluated += len(pairs)
        pos = np.nonzero(gains > 1e-12)[0]
        if len(pos) == 0:
            break
        order = pos[np.argsort(-gains[pos], kind="stable")]
        applied = 0
        for idx in order:
            u, v = int(pairs[idx, 0]), int(pairs[idx, 1])
            exact = swap_gain(g, h, perm, u, v)
            if exact > 1e-12:
                perm[u], perm[v] = perm[v], perm[u]
                cur -= exact
                applied += 1
        if applied == 0:
            break
        stats.swaps += applied
        stats.objective_trace.append(cur)
    stats.final_objective = cur
    return stats
