"""The remap loop's live traffic, rebuilt from the windows fed to it.

The loop folds each window into an exponential moving average,

    live = (1 − α) · live + α · window,

drops an edge whose smoothed weight falls below ``min_weight`` (it counts
as 0 until traffic brings it back), and starts from the baseline graph
with the same pruning.  Over a fixed edge list each state is one weight
vector.
"""

from __future__ import annotations

import numpy as np

__all__ = ["edge_l1", "ema_windows"]


def ema_windows(base, windows, alpha: float, min_weight: float):
    """Yield the live weight vector after each of ``windows`` (weight
    vectors over the same edges as ``base``)."""
    live = np.where(np.asarray(base, np.float64) >= min_weight, base, 0.0)
    for win in windows:
        live = (1.0 - alpha) * live + alpha * np.asarray(win, np.float64)
        live = np.where(live >= min_weight, live, 0.0)
        yield live


def edge_l1(base, live) -> float:
    """Σ |live − base| over Σ base: 0 for the same traffic, 1 when all of
    the baseline's traffic moved."""
    base = np.asarray(base, np.float64)
    total = float(base.sum())
    return float(np.abs(np.asarray(live, np.float64) - base).sum()) / total
