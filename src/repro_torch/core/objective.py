"""Sparse QAP objective and O(deg) delta-gain machinery (guide §2.1): the
port's copy of the JAX package's ``core/objective.py``.

The paper's speedups over Brandfass et al.:
  * initial objective in O(m) over the edges of G_C instead of O(n²),
  * swap gain in O(deg(u) + deg(v)) with the online distance oracle instead
    of O(n) rows of dense matrices.

Conventions: ``perm[u]`` = PE assigned to process u (a bijection).  The
guide writes J(C,D,Π) = Σ C_{Π(i),Π(j)} D_{i,j} over PE pairs (i,j); with
perm as process→PE this is identically Σ_{(u,v)∈E[C]} C_uv · D(perm[u],
perm[v]) which is the form we compute (each undirected edge counted once;
multiply by 2 for the double-sum convention — we keep the single-count form
consistently across construction, search, evaluator, and tests).
"""

from __future__ import annotations

import numpy as np

from .graph import CommGraph, csr_expand
from .hierarchy import Hierarchy   # noqa: F401  (re-exported type hint)

__all__ = ["apply_swap", "batched_swap_gains", "dense_gain_matrix",
           "qap_objective", "qap_objective_dense", "swap_gain"]


def qap_objective(g: CommGraph, h, perm: np.ndarray) -> float:
    """J(C, D, Π) in O(m) using the online distance oracle.  ``h`` is any
    machine model with a vectorized ``distance`` (Hierarchy or
    :class:`~repro_torch.topology.Topology`)."""
    u, v, w = g.edge_list()
    return float(np.sum(w * h.distance(perm[u], perm[v])))


def qap_objective_dense(C: np.ndarray, D: np.ndarray,
                        perm: np.ndarray) -> float:
    """O(n²) dense reference (the Brandfass-et-al. formulation); used as the
    oracle in tests.  Counts each unordered pair once to match
    :func:`qap_objective`."""
    Dp = D[np.ix_(perm, perm)]
    return float(np.sum(np.triu(C * Dp, k=1)))


def swap_gain(g: CommGraph, h, perm: np.ndarray,
              u: int, v: int) -> float:
    """Gain (objective decrease, positive = improvement) of swapping the PEs
    assigned to processes u and v.  O(deg(u) + deg(v))."""
    pu, pv = perm[u], perm[v]
    gain = 0.0
    nb_u, w_u = g.neighbors(u), g.weights(u)
    mask = nb_u != v
    nb, w = nb_u[mask], w_u[mask]
    tgt = perm[nb]
    gain += float(np.sum(w * (h.distance(pu, tgt) - h.distance(pv, tgt))))
    nb_v, w_v = g.neighbors(v), g.weights(v)
    mask = nb_v != u
    nb, w = nb_v[mask], w_v[mask]
    tgt = perm[nb]
    gain += float(np.sum(w * (h.distance(pv, tgt) - h.distance(pu, tgt))))
    # the (u,v) edge itself contributes C_uv * D(pu,pv) before and after the
    # swap (D symmetric) — no delta.
    return gain


def apply_swap(perm: np.ndarray, u: int, v: int) -> None:
    perm[u], perm[v] = perm[v], perm[u]


def batched_swap_gains(g: CommGraph, h, perm: np.ndarray,
                       pairs: np.ndarray) -> np.ndarray:
    """Vectorized gains for many candidate pairs at once (host/numpy path).

    ``pairs``: (P, 2) int array of process pairs.  Complexity
    O(Σ deg(u)+deg(v)) — the paper's sparse bound, batched.
    """
    pairs = np.asarray(pairs, dtype=np.int64)
    if len(pairs) == 0:
        return np.zeros(0)
    us, vs = pairs[:, 0], pairs[:, 1]

    def side(a_arr, b_arr):
        # flattened neighbor expansion for all a in a_arr — one
        # repeat/offset gather, no per-pair Python loop on this hot path
        idx, _, cnt = csr_expand(g.xadj, a_arr)
        nb = g.adjncy[idx]
        w = g.adjwgt[idx]
        rep_a = np.repeat(a_arr, cnt)
        rep_b = np.repeat(b_arr, cnt)
        valid = nb != rep_b
        pa, pb, tgt = perm[rep_a], perm[rep_b], perm[nb]
        contrib = np.where(valid,
                           w * (h.distance(pa, tgt) - h.distance(pb, tgt)),
                           0.0)
        out = np.zeros(len(a_arr))
        seg = np.repeat(np.arange(len(a_arr)), cnt)
        np.add.at(out, seg, contrib)
        return out

    return side(us, vs) + side(vs, us)


def dense_gain_matrix(C: np.ndarray, D: np.ndarray,
                      perm: np.ndarray) -> np.ndarray:
    """Full pair-exchange gain matrix via the matmul formulation (DESIGN §3).

    Derivation (C, D symmetric, zero diagonal; B[u,v] = D[perm[u], perm[v]]):
      gain(u,v) = Σ_{k∉{u,v}} (C[u,k] − C[v,k]) (B[u,k] − B[v,k])
    Extending the sum over all k adds 2·C[u,v]·B[u,v], and with
    M := C @ B.T (M[a,b] = Σ_k C[a,k] B[b,k]):
      gain(u,v) = M[u,u] + M[v,v] − M[u,v] − M[v,u] − 2·C[u,v]·B[u,v]
    Positive = improvement (objective decreases by gain).

    This dense form is the TPU-friendly target of the Pallas kernel
    ``repro_torch.kernels.swap_gain`` (K3); this numpy version is its
    semantic spec.
    """
    B = D[np.ix_(perm, perm)]
    M = C @ B.T
    d = np.diag(M)
    G = d[:, None] + d[None, :] - M - M.T - 2.0 * C * B
    np.fill_diagonal(G, 0.0)
    return G
