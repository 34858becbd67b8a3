"""Pluggable machine models behind one distance-oracle contract.

The guide frames process mapping as sparse quadratic assignment against an
*arbitrary* distance matrix; this package supplies the machine models:

    tree       — the guide's homogeneous hierarchy (wraps core.Hierarchy,
                 bit-identical),
    torus      — k-ary n-cube with per-axis link weights (TPU ICI),
    fattree    — k-ary fat-tree with per-level up-link costs,
    dragonfly  — hierarchical min-hop dragonfly (router/group/global),
    matrix     — explicit distance matrix (true general sparse QAP),
                 loadable from Metis/.npy/dense-text files.

Every backend implements :class:`Topology` — ``n_pe``, a vectorized online
``distance`` oracle, a cached materialized ``matrix()``, ``kernel_params``
selecting the device-side distance representation, and a ``split``
hook exposing the machine's natural recursive decomposition to the
top-down construction.  ``@register_topology`` makes third-party machine
models addressable from ``TopologySpec``, the ``viem`` CLI, and ``Mapper``
without touching core dispatch::

    from repro_torch.topology import make_topology, TorusTopology
    topo = make_topology("torus", dims=[16, 16])       # by name
    topo = TorusTopology((16, 16))                     # directly
    Mapper(topo, MappingSpec(...)).map(g)
"""

from .base import (Topology, as_topology, balanced_halves, list_topologies,
                   make_topology, register_topology, resolve_topology)
from .dragonfly import DragonflyTopology
from .fattree import FatTreeTopology
from .matrix import MatrixTopology, load_distance_matrix
from .presets import tpu_v5e_torus, tpu_v5p_torus
from .torus import TorusTopology
from .tree import TreeTopology

__all__ = [
    "Topology", "as_topology", "balanced_halves", "register_topology",
    "resolve_topology", "list_topologies", "make_topology",
    "TreeTopology", "TorusTopology", "FatTreeTopology",
    "DragonflyTopology", "MatrixTopology", "load_distance_matrix",
    "tpu_v5e_torus", "tpu_v5p_torus",
]
