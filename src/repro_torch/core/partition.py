"""Multilevel perfectly-balanced graph partitioning (KaHIP stand-in).

Guide §2.2: the top-down construction needs *perfectly balanced* partitions
("each block of the output partition has the specified amount of vertices")
— the Sanders–Schulz highly-balanced partitioning role.  KaHIP is external
C++, so we implement the full multilevel scheme in-framework:

  coarsening   : heavy-edge matching (sorted by rating w(e)/min(deg)) until
                 the graph is small or matching stalls,
  initial      : recursive bisection; each bisection seeds a BFS greedy
                 graph-growing region of exactly the target weight from the
                 best of several random seeds,
  refinement   : boundary pairwise-swap FM — moves are *swaps* of equal-
                 cardinality vertex pairs across the cut, so exact balance
                 is invariant at every step; with per-pass best-prefix
                 rollback (classic FM) and early stop.

`partition(g, k)` returns labels in [0,k) with |block| == n/k exactly when
k | n (the top-down construction's requirement), else ±1.

`preconfiguration` maps the guide's strong/eco/fast knobs onto (number of
initial-seed trials, FM passes, coarsening depth).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .graph import CommGraph, contract


@dataclass(frozen=True)
class PartitionConfig:
    seed_trials: int = 4       # greedy-growing restarts per bisection
    fm_passes: int = 3         # refinement passes per level
    coarsen_min: int = 64      # stop coarsening below this many vertices
    max_levels: int = 20

    @staticmethod
    def preconfiguration(name: str) -> "PartitionConfig":
        """The guide's --preconfiguration={strong,eco,fast} (§4.1/§4.2)."""
        if name == "strong":
            return PartitionConfig(seed_trials=12, fm_passes=8, coarsen_min=48)
        if name == "eco":
            return PartitionConfig()
        if name == "fast":
            return PartitionConfig(seed_trials=1, fm_passes=1, coarsen_min=128)
        raise ValueError(f"unknown preconfiguration {name!r}")


# ------------------------------------------------------------------ metrics
def cut_weight(g: CommGraph, labels: np.ndarray) -> float:
    u, v, w = g.edge_list()
    return float(np.sum(w[labels[u] != labels[v]]))


def block_sizes(labels: np.ndarray, k: int) -> np.ndarray:
    return np.bincount(labels, minlength=k)


# --------------------------------------------------------------- coarsening
def _heavy_edge_matching(g: CommGraph, rng: np.random.Generator) -> np.ndarray:
    """Greedy heavy-edge matching; returns match[u] = partner or u."""
    n = g.n
    match = np.arange(n)
    order = rng.permutation(n)
    matched = np.zeros(n, dtype=bool)
    for u in order:
        if matched[u]:
            continue
        nb = g.neighbors(u)
        wt = g.weights(u)
        if len(nb) == 0:
            continue
        free = ~matched[nb]
        if not free.any():
            continue
        cand_nb, cand_wt = nb[free], wt[free]
        v = int(cand_nb[np.argmax(cand_wt)])
        match[u], match[v] = v, u
        matched[u] = matched[v] = True
    return match


def _contract(g: CommGraph, match: np.ndarray
              ) -> tuple[CommGraph, np.ndarray]:
    """Contract matched pairs; returns (coarse graph, fine->coarse map).
    Edge collapsing is the shared :func:`repro_torch.core.graph.contract`."""
    rep = np.minimum(np.arange(g.n), match)     # pair representative
    uniq, cmap = np.unique(rep, return_inverse=True)
    return contract(g, cmap, len(uniq)), cmap


# ------------------------------------------------------ initial bisection
def _grow_region(g: CommGraph, target_n: float, rng: np.random.Generator,
                 trials: int) -> np.ndarray:
    """Greedy BFS graph-growing: returns bool mask of side-0 with exactly
    ``target_n`` vertices (best cut of `trials` seeds).

    Balance currency is vertex *cardinality*: the mapping use case assigns
    one process per vertex, and the bottom-up construction groups
    equal-sized clusters — in both cases blocks must have equal counts."""
    n = g.n
    target_n = int(round(target_n))
    best_mask, best_cut = None, np.inf
    for _ in range(max(1, trials)):
        seed = int(rng.integers(n))
        in_set = np.zeros(n, dtype=bool)
        gain = np.full(n, -np.inf)          # frontier attraction
        gain[seed] = 0.0
        count = 0
        for _step in range(n):
            if count >= target_n:
                break
            u = int(np.argmax(gain))
            if gain[u] == -np.inf:
                # disconnected: jump to any unused vertex
                rest = np.nonzero(~in_set)[0]
                if len(rest) == 0:
                    break
                u = int(rest[0])
            in_set[u] = True
            count += 1
            gain[u] = -np.inf
            nb, wt = g.neighbors(u), g.weights(u)
            upd = ~in_set[nb]
            gm = gain[nb[upd]]
            gain[nb[upd]] = np.where(gm == -np.inf, wt[upd], gm + wt[upd])
        u_, v_, w_ = g.edge_list()
        cut = float(np.sum(w_[in_set[u_] != in_set[v_]]))
        if cut < best_cut:
            best_cut, best_mask = cut, in_set.copy()
    return best_mask


# --------------------------------------------------- pairwise-swap FM
def _fm_swap_refine(g: CommGraph, side: np.ndarray, passes: int,
                    rng: np.random.Generator) -> np.ndarray:
    """Balance-invariant FM: each move swaps one boundary vertex from each
    side.  Per pass, do greedy best-swap with (vertex) locking and keep the
    best prefix.  O(passes * boundary * deg)."""
    n = g.n
    side = side.copy()

    def move_gains(s):
        # gain of moving u to the other side = ext(u) - int(u)
        gains = np.zeros(n)
        for u in range(n):
            nb, wt = g.neighbors(u), g.weights(u)
            ext = wt[s[nb] != s[u]].sum()
            ing = wt[s[nb] == s[u]].sum()
            gains[u] = ext - ing
        return gains

    for _ in range(max(0, passes)):
        s = side.copy()
        gains = move_gains(s)
        locked = np.zeros(n, dtype=bool)
        seq: list[tuple[int, int]] = []
        cum, best_cum, best_len = 0.0, 0.0, 0
        max_swaps = max(1, n // 2)
        for _step in range(max_swaps):
            g0 = np.where(~locked & ~s, gains, -np.inf)   # side 0 candidates
            g1 = np.where(~locked & s, gains, -np.inf)    # side 1 candidates
            u = int(np.argmax(g0))
            v = int(np.argmax(g1))
            if g0[u] == -np.inf or g1[v] == -np.inf:
                break
            # swap gain = gain(u) + gain(v) - 2*w(u,v) if adjacent
            nb_u, wt_u = g.neighbors(u), g.weights(u)
            wuv = float(wt_u[nb_u == v].sum())
            sg = gains[u] + gains[v] - 2.0 * wuv
            # apply
            s[u], s[v] = ~s[u], ~s[v]
            locked[u] = locked[v] = True
            seq.append((u, v))
            cum += sg
            if cum > best_cum + 1e-12:
                best_cum, best_len = cum, len(seq)
            # update neighbor gains
            for x in (u, v):
                nb, wt = g.neighbors(x), g.weights(x)
                for yy, ww in zip(nb, wt):
                    if locked[yy]:
                        continue
                    # recompute y's gain locally
                    nb2, wt2 = g.neighbors(yy), g.weights(yy)
                    ext = wt2[s[nb2] != s[yy]].sum()
                    ing = wt2[s[nb2] == s[yy]].sum()
                    gains[yy] = ext - ing
            gains[u] = -gains[u] - 0  # locked anyway
            gains[v] = -gains[v]
            if len(seq) - best_len > 16:   # early stop: no improvement window
                break
        # rollback to best prefix
        s2 = side.copy()
        for (u, v) in seq[:best_len]:
            s2[u], s2[v] = ~s2[u], ~s2[v]
        if best_cum <= 1e-12:
            break
        side = s2
    return side


# ------------------------------------------------------------- multilevel
def _bisect_multilevel(g: CommGraph, w_target0: float, cfg: PartitionConfig,
                       rng: np.random.Generator) -> np.ndarray:
    """Multilevel bisection into (side0 ~ w_target0, side1 = rest).
    Returns a bool array (True = side 1)."""
    graphs: list[CommGraph] = [g]
    maps: list[np.ndarray] = []
    cur = g
    for _ in range(cfg.max_levels):
        if cur.n <= cfg.coarsen_min:
            break
        match = _heavy_edge_matching(cur, rng)
        if np.all(match == np.arange(cur.n)):
            break
        coarse, cmap = _contract(cur, match)
        if coarse.n >= cur.n * 0.95:        # matching stalled
            break
        graphs.append(coarse)
        maps.append(cmap)
        cur = coarse

    # initial bisection on the coarsest level (vertex-weighted target)
    mask0 = _grow_region(cur, w_target0, rng, cfg.seed_trials)
    side = ~mask0  # True = side 1

    # uncoarsen + refine.  Swap-FM preserves per-level cardinality; coarse
    # vertices aggregate different numbers of finest vertices, so finest-
    # level balance can drift by a few — the exact rebalance below repairs
    # it before the final refinement pass.
    for lvl in range(len(maps) - 1, -1, -1):
        side = side[maps[lvl]]
        if graphs[lvl].n <= 4 * cfg.coarsen_min:   # refine cheap levels only
            side = _fm_swap_refine(graphs[lvl], side, cfg.fm_passes, rng)

    side = _exact_rebalance(g, side, w_target0)
    side = _fm_swap_refine(g, side, cfg.fm_passes, rng)
    side = _exact_rebalance(g, side, w_target0)   # FM swaps keep balance; belt+braces
    return side


def _exact_rebalance(g: CommGraph, side: np.ndarray,
                     n_target0: float) -> np.ndarray:
    """Move cheapest boundary-ish vertices until |side 0| == target count.
    Each move changes the count by exactly 1, so this terminates in
    |count - target| steps; a hard bound guards regardless."""
    side = side.copy()
    target0 = int(round(n_target0))
    for _ in range(g.n + 1):
        n0 = int(np.sum(~side))
        if n0 == target0:
            break
        move_from0 = n0 > target0
        cand = np.nonzero(~side if move_from0 else side)[0]
        if len(cand) == 0:
            break
        # pick candidate with max (external - internal) wrt its side
        best_u, best_g = -1, -np.inf
        for u in cand:
            nb, wt = g.neighbors(u), g.weights(u)
            ext = wt[side[nb] != side[u]].sum()
            ing = wt[side[nb] == side[u]].sum()
            gn = ext - ing
            if gn > best_g:
                best_g, best_u = gn, int(u)
        side[best_u] = ~side[best_u]
    return side


def partition(g: CommGraph, k: int, cfg: PartitionConfig | None = None,
              seed: int = 0) -> np.ndarray:
    """Perfectly balanced k-way partition by recursive bisection.

    Requires unit vertex weights at the top level (the mapping use case:
    one process per vertex).  When k | n every block has exactly n/k
    vertices; general k splits proportionally (±1).
    """
    cfg = cfg or PartitionConfig()
    rng = np.random.default_rng(seed)
    labels = np.zeros(g.n, dtype=np.int64)

    def rec(nodes: np.ndarray, kk: int, label_base: int):
        if kk == 1:
            labels[nodes] = label_base
            return
        sub, back = g.subgraph(nodes)
        k0 = kk // 2
        n0 = int(round(len(nodes) * k0 / kk))
        side = _bisect_multilevel(sub, float(n0), cfg, rng)
        part0 = back[~side]
        part1 = back[side]
        rec(part0, k0, label_base)
        rec(part1, kk - k0, label_base + k0)

    rec(np.arange(g.n, dtype=np.int64), k, 0)
    return labels
