"""Multilevel mapping on the device: coarsen → map → uncoarsen.

The port of the JAX package's ``repro.multilevel``.  VieM is a
*multilevel* framework — the guide's core technique contracts the
communication graph, maps the coarsest level, then uncoarsens while
refining at every level ("Better Process Mapping and Sparse Quadratic
Assignment", Schulz & Träff 2017).  The flat device engine sweeps a
single level and stops at a local optimum of that level's candidate
set; this package wraps it in the V-cycle that lets local search escape
those optima.

The cycle coarsens *both* sides of the QAP:

  * **Graph side** — heavy-edge matchings and sorted-run edge collapsing
    run as torch ops on the plan's device
    (:mod:`repro_torch.kernels.contract`).  The matching is completed to
    a perfect pairing (leftovers force-paired in index order), so every
    coarse vertex holds exactly two fine processes and level sizes are
    n, n/2, n/4, … — identical across same-n graphs, which is what lets
    ``map_many`` run each level's refinement as ONE batched engine call
    (one sweep loop, one K2 launch a sweep for the whole batch).
  * **Machine side** — PEs pair symmetrically (2b, 2b+1): consecutive PEs
    are lowest-level siblings in tree hierarchies and last-axis neighbors
    in even tori.  The coarse machine is an explicit
    :class:`~repro_torch.topology.MatrixTopology` whose distance is the
    mean of the four cross distances — K1 and K2 refine coarse levels in
    their matrix form, float32 or the lossless int8/int16 packing
    ``kernels/config.py:quantize_table`` picks for the table.

V-cycle (:func:`repro_torch.multilevel.vcycle.vcycle_map`): the
coarsest level is constructed by any registered construction and
refined; each finer level starts from the projection of the coarser
permutation — process pair (u, v) on coarse PE b lands on fine PEs
(2b, 2b+1), a bijection by construction — and is refined over its own
candidate pairs.

Select it with ``MappingSpec(engine="device",
multilevel=MultilevelSpec())`` or ``viem --multilevel``;
``MultilevelSpec(levels=1)`` is the flat engine, bit for bit.  Results
equal the JAX package's exactly on integer data (tested on the CPU).
"""

from .coarsen import Level, build_pyramid, coarsen_graph, coarsen_machine, \
    pyramid_depth, project_perm
from .vcycle import vcycle_map, vcycle_map_batch

__all__ = [
    "Level", "build_pyramid", "coarsen_graph", "coarsen_machine",
    "project_perm", "pyramid_depth", "vcycle_map", "vcycle_map_batch",
]
