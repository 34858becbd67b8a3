"""`torus` — k-ary n-cube with per-axis link weights.

The honest TPU ICI model: a v5e pod is a 16×16 2D torus, a v5p pod a 3D
torus — wraparound links, hop distance per axis, *not* a tree.  Distance
is the weighted Manhattan ring distance

    D(p, q) = Σ_a  w_a · min(|x_a − y_a|, k_a − |x_a − y_a|)

with PE index = mixed-radix coordinates (axis 0 innermost, matching the
hierarchy's innermost-first convention).  Closed-form, so the CUDA
objective kernel computes it arithmetically in-register — large n never
materializes n×n on host (``kernel_params`` = ("torus", dims, weights)).

``split`` halves the longest (weight-scaled) axis — the machine's natural
recursive decomposition for the top-down construction: blocks stay
compact sub-boxes, exactly the subtree analogue.
"""

from __future__ import annotations

import numpy as np

from .base import Topology, register_topology


def _smallest_factor(n: int) -> int:
    for f in range(2, int(n ** 0.5) + 1):
        if n % f == 0:
            return f
    return n


@register_topology("torus")
class TorusTopology(Topology):
    """k-ary n-cube: ``dims`` = (k_1, ..., k_n) PEs per axis (axis 0
    innermost in the PE index), ``weights`` = per-axis link weight
    (default 1.0 each — pure hop count)."""

    def __init__(self, dims, weights=None):
        self.dims = tuple(int(d) for d in dims)
        if not self.dims or any(d <= 0 for d in self.dims):
            raise ValueError(f"torus dims must be positive, got {dims}")
        if weights is None:
            weights = [1.0] * len(self.dims)
        self.weights = tuple(float(w) for w in weights)
        if len(self.weights) != len(self.dims):
            raise ValueError("torus dims and weights differ in length")
        if any(w < 0 for w in self.weights):
            raise ValueError("torus link weights must be >= 0")
        # strides[a] = PE-index stride of axis a (axis 0 innermost)
        self.strides = tuple(
            int(np.prod(self.dims[:a], dtype=np.int64))
            for a in range(len(self.dims)))

    # ------------------------------------------------------------ contract
    @property
    def n_pe(self) -> int:
        return int(np.prod(self.dims, dtype=np.int64))

    def coords(self, p) -> list[np.ndarray]:
        """Mixed-radix coordinates of PE index ``p``, one array per axis."""
        p = np.asarray(p, dtype=np.int64)
        return [(p // s) % d for s, d in zip(self.strides, self.dims)]

    def distance(self, p, q):
        p = np.asarray(p, dtype=np.int64)
        q = np.asarray(q, dtype=np.int64)
        out = np.zeros(np.broadcast(p, q).shape, dtype=np.float64)
        for s, d, w in zip(self.strides, self.dims, self.weights):
            delta = np.abs((p // s) % d - (q // s) % d)
            out += w * np.minimum(delta, d - delta)
        return out if out.ndim else float(out)

    def kernel_params(self) -> tuple:
        return ("torus", self.dims, self.weights)

    def split(self, pe_ids: np.ndarray) -> "list[np.ndarray] | None":
        """Split the sub-box along its longest (weight-scaled) axis into
        the axis extent's smallest prime factor many equal slabs."""
        pe_ids = np.asarray(pe_ids, dtype=np.int64)
        if len(pe_ids) <= 1:
            return None
        cs = self.coords(pe_ids)
        best_axis, best_cost, best_vals = -1, -1.0, None
        for a, (c, w) in enumerate(zip(cs, self.weights)):
            vals = np.unique(c)
            if len(vals) < 2:
                continue
            # span cost: how much distance the axis contributes
            cost = (len(vals) // 2) * max(w, 1e-12)
            if cost > best_cost:
                best_axis, best_cost, best_vals = a, cost, vals
        if best_axis < 0:
            return None
        f = _smallest_factor(len(best_vals))
        chunk = len(best_vals) // f
        c = cs[best_axis]
        parts = []
        for i in range(f):
            sel = np.isin(c, best_vals[i * chunk:(i + 1) * chunk])
            parts.append(pe_ids[sel])
        return parts

    def spec_params(self) -> dict:
        return {"dims": list(self.dims), "weights": list(self.weights)}
