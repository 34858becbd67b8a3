"""Level pyramids: device graph contraction + machine-side PE pairing.

The port's copy of the JAX package's ``multilevel/coarsen.py``.  One
:class:`Level` holds everything the V-cycle needs at one scale: the
contracted communication graph, the matching machine model, the level's
own candidate pairs, and the projection arrays back to the next-finer
level.  Graph contraction runs on the plan's device
(:mod:`repro_torch.kernels.contract`, torch ops) with its host syncs
counted and one readback per level boundary to assemble the next
:class:`CommGraph`; machine coarsening is pure numpy over the topology's
online distance oracle (no n×n materialization of the *fine* machine —
only the coarse nc×nc matrices are ever built).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.graph import CommGraph, from_edges
from ..kernels.contract import MAX_N
from ..runtime.boundary import host_boundary
from ..runtime.device import resolve_device
from ..topology.base import Topology


@dataclass
class Level:
    """One scale of the V-cycle.  ``fine_u``/``fine_v`` (None at the
    finest level) give each coarse vertex's two members in the
    next-finer level, with ``fine_u < fine_v``."""
    graph: CommGraph
    machine: Topology
    pairs: np.ndarray
    fine_u: np.ndarray | None = None
    fine_v: np.ndarray | None = None
    # host syncs of the contraction that made this level (None at the
    # finest): {"reads": counted readbacks, "observed": syncs PyTorch
    # reported in that scope on a card, None elsewhere}
    syncs: dict | None = None


def coarsen_graph(g: CommGraph, device=None, syncs: dict | None = None
                  ) -> tuple[CommGraph, np.ndarray, np.ndarray]:
    """One device contraction step on ``device`` (``"cuda"`` unless the
    caller asks for ``"cpu"``): heavy-edge perfect pairing + sorted-run
    edge collapsing.  Returns ``(coarse graph,
    fine_u, fine_v)`` with coarse vertex c = fine pair (fine_u[c],
    fine_v[c]).  The contraction's host syncs are left in ``syncs``
    when a dict is given."""
    n = g.n
    if n % 2:
        raise ValueError(f"cannot pair-contract an odd vertex count ({n})")
    if n > MAX_N:
        raise ValueError(f"contraction keys need n <= {MAX_N}, got {n}")
    import torch

    from ..kernels.contract import coarsen_arrays
    from ..kernels.pad import pad_edge_arrays
    dev = resolve_device(device)
    u, v, w = g.edge_list()
    with host_boundary("coarsen.upload"):
        eu, ev, ew = pad_edge_arrays(u, v, w, device=dev)
        vw = torch.from_numpy(g.vwgt.astype(np.float32)).to(dev)
    with host_boundary("coarsen.contract", dev) as hb:
        labels, ceu, cev, cew, cvw = coarsen_arrays(eu, ev, ew, vw, hb)
    if syncs is not None:
        syncs.update(reads=hb.reads, observed=hb.syncs)
    with host_boundary("coarsen.rebuild") as rb:
        labels = rb.read(labels).astype(np.int64)
        ceu, cev = rb.read(ceu), rb.read(cev)
        cew, cvw = rb.read(cew), rb.read(cvw)
        nc = n // 2
        # stable sort by label: each label appears exactly twice,
        # members in ascending fine-vertex order
        members = np.argsort(labels, kind="stable")
        fine_u, fine_v = members[0::2].copy(), members[1::2].copy()
        cew = np.asarray(cew, dtype=np.float64)
        live = cew > 0
        coarse = from_edges(nc, np.asarray(ceu, np.int64)[live],
                            np.asarray(cev, np.int64)[live], cew[live],
                            vwgt=np.asarray(cvw, np.float64)[:nc])
    return coarse, fine_u, fine_v


def coarsen_machine(machine: Topology) -> Topology:
    """Pair PEs (2b, 2b+1) into one coarse PE; coarse distance = mean of
    the four cross distances (zero diagonal).  Consecutive PEs are
    lowest-level siblings in tree hierarchies and last-axis neighbors in
    even tori, so the pair is the machine's natural smallest group.
    Returns an explicit :class:`MatrixTopology` — the engine's matrix
    distance form refines coarse levels unchanged."""
    from ..topology.matrix import MatrixTopology
    n = machine.n_pe
    if n % 2:
        raise ValueError(f"cannot pair-coarsen an odd PE count ({n})")
    ia = np.arange(n // 2, dtype=np.int64) * 2

    def cross(da: int, db: int) -> np.ndarray:
        return np.asarray(machine.distance((ia + da)[:, None],
                                           (ia + db)[None, :]),
                          dtype=np.float64)

    Dc = (cross(0, 0) + cross(0, 1) + cross(1, 0) + cross(1, 1)) / 4.0
    # the four cross distances of (a, b) and (b, a) are the same values
    # summed in a different order — symmetrize away the float ULPs so
    # MatrixTopology's exact-symmetry validation holds
    Dc = (Dc + Dc.T) / 2.0
    np.fill_diagonal(Dc, 0.0)
    return MatrixTopology(matrix=Dc)


def pyramid_depth(n: int, levels: int, coarsen_min: int) -> int:
    """Number of levels the V-cycle will actually build: contract while
    the coarse size stays at or above ``coarsen_min``, the vertex count
    stays even, and the ``levels`` budget allows.  Depends only on n —
    same-n graphs always share one level geometry (what lets a batch of
    V-cycles share one engine call per level)."""
    depth = 1
    while depth < levels and n % 2 == 0 and n // 2 >= coarsen_min:
        n //= 2
        depth += 1
    return depth


def build_pyramid(g: CommGraph, machines: list[Topology], levels: int,
                  coarsen_min: int, pair_fn, device=None) -> list[Level]:
    """The graph-side pyramid, finest first.  ``machines`` is the
    machine-side pyramid (graph-independent, cached by the Mapper);
    ``pair_fn(graph)`` generates each level's candidate pairs; the
    contractions run on ``device`` (``"cuda"`` unless the caller asks
    for ``"cpu"``)."""
    depth = pyramid_depth(g.n, levels, coarsen_min)
    pyramid = [Level(g, machines[0], pair_fn(g))]
    for lvl in range(1, depth):
        syncs: dict = {}
        coarse, fine_u, fine_v = coarsen_graph(pyramid[-1].graph, device,
                                               syncs)
        pyramid.append(Level(coarse, machines[lvl], pair_fn(coarse),
                             fine_u, fine_v, syncs))
    return pyramid


def project_perm(coarse_perm: np.ndarray, fine_u: np.ndarray,
                 fine_v: np.ndarray) -> np.ndarray:
    """Uncoarsen one level: coarse vertex c on coarse PE b expands to its
    two members on fine PEs (2b, 2b+1).  A bijection on [0, 2·nc) for any
    bijective ``coarse_perm`` — the refinement engine only ever swaps, so
    validity is preserved at every level of the cycle."""
    nc = len(coarse_perm)
    perm = np.empty(2 * nc, dtype=np.int64)
    perm[fine_u] = 2 * coarse_perm
    perm[fine_v] = 2 * coarse_perm + 1
    return perm
