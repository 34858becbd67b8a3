"""Plain PyTorch oracles for the kernels (the ground truth in tests): the
port of the JAX package's ``kernels/ref.py``."""

from __future__ import annotations

import numpy as np

__all__ = ["hier_distance_ref", "qap_objective_edges_ref",
           "swap_gain_matrix_ref"]


def swap_gain_matrix_ref(C, B):
    """Dense gain matrix: G[u,v] = M[u,u]+M[v,v]−M[u,v]−M[v,u]−2·C[u,v]·B[u,v],
    M = C @ Bᵀ; diagonal zeroed.  Mirrors objective.dense_gain_matrix."""
    import torch
    C = C.to(torch.float32)
    B = B.to(torch.float32)
    M = C @ B.T
    d = torch.diagonal(M)
    G = d[:, None] + d[None, :] - M - M.T - 2.0 * C * B
    n = C.shape[0]
    return G * (1.0 - torch.eye(n, dtype=torch.float32, device=C.device))


def hier_distance_ref(pu, pv, strides: tuple, dists: tuple):
    """Online hierarchical distance oracle, torch version."""
    import torch
    out = torch.zeros(torch.broadcast_shapes(pu.shape, pv.shape),
                      dtype=torch.float32, device=pu.device)
    k = len(dists)
    out = torch.where(pu != pv, np.float32(dists[k - 1]).item(), out)
    for lvl in range(k - 1, 0, -1):
        same = (pu // strides[lvl]) == (pv // strides[lvl])
        out = torch.where(same & (pu != pv), np.float32(dists[lvl - 1]).item(),
                          out)
    return out


def qap_objective_edges_ref(pu, pv, w, strides: tuple, dists: tuple):
    import torch
    return torch.sum(w.to(torch.float32)
                     * hier_distance_ref(pu, pv, strides, dists))
