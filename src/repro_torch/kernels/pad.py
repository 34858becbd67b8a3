"""Shared padding helpers for every kernel entry point.

All device kernels in this package consume *padded* tensors: ELL
neighbor rows, edge lists and candidate-pair lists.  The padding
invariants are the foundation of the plan/bucket machinery
(``ShapeBucket`` padding must be inert), so the helpers live in ONE
place and every kernel wrapper and :class:`~repro_torch.core.graph
.DeviceGraph` pads through them:

  * zero padding is inert for every distance form: an edge (0, 0, w=0)
    contributes w·D(p0, p0) = 0, a neighbor slot with w = 0 kills its
    term, and a candidate pair (u, u) has exactly zero gain;
  * padding only ever *appends* — the live prefix of a tensor never
    moves, so reductions visit live elements in the same order
    regardless of how much padding follows (what makes results
    bit-identical across tight/pow2/oversized buckets).
"""

from __future__ import annotations

import numpy as np


def round_up(x: int, quantum: int) -> int:
    """The smallest multiple of ``quantum`` that is >= max(x, 1)."""
    return -(-max(int(x), 1) // quantum) * quantum


def pad1(a, length: int):
    """Zero-pad a 1-D tensor to ``length`` (append only)."""
    import torch.nn.functional as F
    return F.pad(a, (0, length - a.shape[0]))


def pad2(a, rows: int, cols: int):
    """Zero-pad a 2-D tensor to (rows, cols) (append only)."""
    import torch.nn.functional as F
    return F.pad(a, (0, cols - a.shape[1], 0, rows - a.shape[0]))


def pad_to_lanes(arrs, e: int, lanes: int, block_rows: int = 1):
    """Zero-pad 1-D edge tensors of live length ``e`` to a lane multiple
    and reshape each to (rows, lanes), rows a multiple of ``block_rows``.
    The lane width is clamped so tiny edge lists do not blow up into one
    enormous padded row.  Zero padding is inert for every oracle form:
    pu == pv == 0 gives distance 0 for tree/torus/matrix, and w == 0
    kills the term regardless."""
    lanes = min(lanes, max(128, 1 << (max(e - 1, 1)).bit_length()))
    rows = round_up(round_up(e, lanes) // lanes, block_rows)
    e_pad = rows * lanes
    return [pad1(a, e_pad).reshape(rows, lanes) for a in arrs]


def pad_edge_arrays(u, v, w, base: int = 128, device="cuda"):
    """Host edge triplet → padded device tensors (eu, ev, ew): int32
    endpoints, float32 weights, length rounded up to a ``base`` multiple
    with inert (0, 0, 0.0) padding.  The one idiom behind
    ``DeviceGraph.from_comm`` and the plan's objective upload."""
    import torch
    u = np.asarray(u)
    e = round_up(len(u), base)
    pad = e - len(u)
    return (torch.from_numpy(np.pad(u, (0, pad)).astype(np.int32)).to(device),
            torch.from_numpy(np.pad(np.asarray(v), (0, pad))
                             .astype(np.int32)).to(device),
            torch.from_numpy(np.pad(np.asarray(w), (0, pad))
                             .astype(np.float32)).to(device))
