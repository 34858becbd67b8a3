"""The mapping objective J = Σ_{(u, v) ∈ E} w_uv · D(π(u), π(v)), each
undirected edge once (the paper's double sum is twice this), in float64;
the control's bfloat16 twin; the bijection check."""

from __future__ import annotations

import numpy as np

__all__ = ["is_bijection", "objective", "objective_bf16"]


def is_bijection(perm, n: int) -> bool:
    """``perm`` maps the n processes onto the n PEs one to one."""
    perm = np.asarray(perm)
    if perm.shape != (n,) or not np.issubdtype(perm.dtype, np.integer):
        return False
    seen = np.zeros(n, dtype=bool)
    if perm.min(initial=0) < 0 or perm.max(initial=0) >= n:
        return False
    seen[perm] = True
    return bool(seen.all())


def objective(u, v, w, perm, dist) -> float:
    perm = np.asarray(perm, dtype=np.int64)
    return float(np.sum(np.asarray(w, np.float64) * dist(perm[u], perm[v])))


def objective_bf16(u, v, w, perm, dist) -> float:
    """J computed in bfloat16, the precision one step below the float32
    that the configurations state for the program's objective: the
    weights, distances and products rounded to bfloat16, then summed by
    pairs with every partial sum rounded to bfloat16."""
    import torch
    perm = np.asarray(perm, dtype=np.int64)
    w16 = torch.from_numpy(np.asarray(w, np.float32)).to(torch.bfloat16)
    d16 = torch.from_numpy(dist(perm[u], perm[v]).astype(np.float32)).to(
        torch.bfloat16)
    x = w16 * d16
    while x.numel() > 1:
        if x.numel() % 2:
            x = torch.cat([x, x.new_zeros(1)])
        x = x[0::2] + x[1::2]
    return float(x[0]) if x.numel() else 0.0
