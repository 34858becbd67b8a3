"""Device-side graph coarsening: heavy-edge matching + edge collapsing.

The port of the JAX package's ``kernels/contract.py``: plain device code
(no Pallas there, so no hand-written kernel here) run as torch ops on
the plan's device.  The multilevel V-cycle (:mod:`repro_torch.multilevel`)
contracts the communication graph level by level over the padded edge
tensors of a graph (``eu``/``ev``/``ew``, each undirected edge once,
zero-weight padding):

  1. **Matching** — greedy *maximal* matching by the heavy-edge rating
     r(e) = w(e) / min(deg u, deg v), in rounds of locally-dominant
     edges (highest rating at both endpoints, ties toward the lowest
     edge index), then the leftover vertices force-paired in index
     order, so the matching is a *perfect pairing* whenever n is even.
  2. **Collapsing** — edge endpoints mapped through the coarse labels,
     intra-pair edges and padding killed, duplicate coarse edges merged
     by a stable sort of the (lo·n + hi) keys and a sum over each run of
     equal keys.  Output tensors keep the padded length E; dead slots
     carry (0, 0, 0.0).

Where the reference leaves the order to XLA, the port fixes it:

  * the sort is ``torch.sort(stable=True)`` — labels and coarse edges
    are integer data and equal the reference's exactly;
  * each run of equal keys (and each cluster's vertex weights) is summed
    in index order, one position of every run per step, never by a
    scatter-add whose atomics land in any order: on integer weights the
    coarse graph equals the reference's, and on real weights it is the
    same from one run to the next;
  * the reference's ``mode="drop"`` scatters at index n land in a
    scratch slot n of (n+1)-long buffers.

Host syncs: the matching's ``while_loop`` condition is one counted read
a round, and each ordered sum one counted read (the longest run), all
through the caller's :class:`~repro_torch.runtime.Boundary`.
"""

from __future__ import annotations

__all__ = ["MAX_N", "coarsen_arrays", "contract_edges", "contract_vwgt",
           "edge_ratings", "heavy_edge_matching", "labels_of_matching"]

# edge keys are lo*n + hi with a sentinel at n*n: the reference keeps
# them in int32, so n must stay below floor(sqrt(2^31 - 1)); the host
# wrappers enforce it
MAX_N = 46_340


def edge_ratings(eu, ev, ew, n: int):
    """Heavy-edge ratings r(e) = w(e) / min(deg u, deg v); padding
    (w = 0) rates 0.  Degrees are counted from the live edges (integer
    counts: exact in any order)."""
    import torch
    live = (ew > 0).to(torch.float32)
    eu_l, ev_l = eu.long(), ev.long()
    deg = torch.zeros(n, dtype=torch.float32, device=ew.device)
    deg.index_add_(0, eu_l, live)
    deg.index_add_(0, ev_l, live)
    mindeg = torch.clamp(torch.minimum(deg[eu_l], deg[ev_l]), min=1.0)
    return torch.where(ew > 0, ew / mindeg, 0.0)


def heavy_edge_matching(eu, ev, ew, n: int, boundary):
    """Perfect pairing of ``n`` (even) vertices: greedy maximal matching
    by heavy-edge rating priority, then forced index-order pairing of the
    leftovers.  Returns ``match`` (n,) int32 — an involution with
    ``match[u] != u`` for every vertex.  Each round's condition (whether
    an eligible edge is left) is one ``boundary.read``."""
    import torch
    dev = ew.device
    e = eu.shape[0]
    rating = edge_ratings(eu, ev, ew, n)
    pos = rating > 0
    idx = torch.arange(e, device=dev)
    eu_l, ev_l = eu.long(), ev.long()
    oob = torch.full((e,), n, dtype=torch.long, device=dev)
    true_t = torch.ones((), dtype=torch.bool, device=dev)
    match0 = torch.arange(n, dtype=torch.int32, device=dev)
    match = torch.cat([match0, match0.new_zeros(1)])       # slot n: drop
    used = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    while True:
        elig = pos & ~used[eu_l] & ~used[ev_l]
        if not boundary.read(torch.any(elig)):
            break
        re = torch.where(elig, rating, float("-inf"))
        vmax = torch.full((n,), float("-inf"), dtype=torch.float32,
                          device=dev)
        vmax.scatter_reduce_(0, eu_l, re, "amax")
        vmax.scatter_reduce_(0, ev_l, re, "amax")
        cand = elig & (re >= vmax[eu_l]) & (re >= vmax[ev_l])
        masked_idx = torch.where(cand, idx, e)
        vmin = torch.full((n,), e, dtype=torch.long, device=dev)
        vmin.scatter_reduce_(0, eu_l, masked_idx, "amin")
        vmin.scatter_reduce_(0, ev_l, masked_idx, "amin")
        new = cand & (vmin[eu_l] == idx) & (vmin[ev_l] == idx)
        at_u, at_v = torch.where(new, eu_l, oob), torch.where(new, ev_l, oob)
        match[at_u] = ev.to(torch.int32)
        match[at_v] = eu.to(torch.int32)
        used.index_put_((at_u,), true_t)
        used.index_put_((at_v,), true_t)

    # forced pairing: the unmatched vertices, in index order, pair up
    # consecutively (rank r partners rank r^1) — n even keeps their count
    # even, so nobody is left single
    free = ~used[:n]
    rank = torch.cumsum(free.to(torch.int32), 0, dtype=torch.int32) - 1
    byrank = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    byrank[torch.where(free, rank.long(), n)] = match0
    # the rank of a matched vertex is never read (-1 before the first
    # free vertex: clamped, as the reference's gather wraps it)
    partner = byrank[torch.clamp(rank ^ 1, min=0).long()]
    return torch.where(free, partner, match[:n])


def labels_of_matching(match):
    """Coarse labels of a perfect pairing: pairs are numbered by the
    order of their smaller endpoint, so labels are 0..n/2-1 and
    deterministic.  (n,) int32."""
    import torch
    n = match.shape[0]
    ids = torch.arange(n, dtype=match.dtype, device=match.device)
    rep = torch.minimum(ids, match)
    is_rep = rep == ids
    lab_of_rep = torch.cumsum(is_rep.to(torch.int32), 0,
                              dtype=torch.int32) - 1
    return lab_of_rep[rep.long()]


def _sum_runs(values, seg, size: int, live, boundary):
    """out[s] = the sum of ``values[i]`` over the run of positions i with
    ``seg[i] == s`` (runs contiguous and ``seg`` non-decreasing), added
    left to right in index order from 0.0, for the ``live`` positions;
    out is (size,) and 0 elsewhere.  Step k adds the k-th element of
    every run at once (one unique target per run, so no two writes meet);
    the number of steps, the longest live run, is one ``boundary.read``."""
    import torch
    m = values.shape[0]
    dev = values.device
    pos = torch.arange(m, device=dev)
    head = torch.ones(m, dtype=torch.bool, device=dev)
    head[1:] = seg[1:] != seg[:-1]
    start = torch.cummax(torch.where(head, pos, 0), 0).values
    k_of = pos - start
    steps = int(boundary.read(torch.max(torch.where(live, k_of + 1, 0))))
    out = torch.zeros(size + 1, dtype=values.dtype, device=dev)
    for k in range(steps):
        at = torch.where(live & (k_of == k), seg, size)
        out[at] = out[at] + values
    return out[:size]


def contract_edges(eu, ev, ew, labels, n: int, boundary):
    """Sorted-run edge collapsing: coarse edge tensors of the same padded
    length E, duplicate coarse edges merged (weights summed in index
    order), intra-cluster edges (self-loops) and padding dead (endpoints
    (0, 0), weight 0.0).  The live prefix is invariant under further
    (0, 0, 0.0) edge padding."""
    import torch
    e = eu.shape[0]
    lab = labels.long()
    lu, lv = lab[eu.long()], lab[ev.long()]
    lo, hi = torch.minimum(lu, lv), torch.maximum(lu, lv)
    dead = (lu == lv) | (ew <= 0)
    sentinel = n * n
    key = torch.where(dead, sentinel, lo * n + hi)
    key_s, order = torch.sort(key, stable=True)
    w_s = torch.where(dead, 0.0, ew)[order]
    head = torch.ones(e, dtype=torch.bool, device=ew.device)
    head[1:] = key_s[1:] != key_s[:-1]
    seg = torch.cumsum(head.to(torch.int64), 0) - 1
    wsum = _sum_runs(w_s, seg, e, key_s != sentinel, boundary)
    # every element of a run carries the same key, so the writes agree
    keyrep = torch.zeros(e, dtype=torch.int64, device=ew.device)
    keyrep[seg] = key_s
    live = (keyrep != sentinel) & (wsum > 0)
    out_u = torch.where(live, keyrep // n, 0).to(eu.dtype)
    out_v = torch.where(live, keyrep % n, 0).to(ev.dtype)
    return out_u, out_v, torch.where(live, wsum, 0.0)


def contract_vwgt(vwgt, labels, boundary):
    """Per-cluster summed vertex weights, fixed output shape (n,) —
    entries at and beyond the cluster count are zero.  Each cluster's
    members are added in index order."""
    import torch
    n = vwgt.shape[0]
    lab_s, order = torch.sort(labels.long(), stable=True)
    live = torch.ones(n, dtype=torch.bool, device=vwgt.device)
    return _sum_runs(vwgt[order], lab_s, n, live, boundary)


def coarsen_arrays(eu, ev, ew, vwgt, boundary) -> tuple:
    """One full device contraction step: matching → labels → collapsed
    edges + vertex weights.  Returns ``(labels, ceu, cev, cew, cvw)``;
    the host syncs it makes are ``boundary.read``s."""
    n = vwgt.shape[0]
    match = heavy_edge_matching(eu, ev, ew, n, boundary)
    labels = labels_of_matching(match)
    ceu, cev, cew = contract_edges(eu, ev, ew, labels, n, boundary)
    return labels, ceu, cev, cew, contract_vwgt(vwgt, labels, boundary)
