"""Carry state from the JAX package into the port.

Everything here takes what ``repro`` holds *as numpy arrays or plain
dicts* (``np.asarray`` of a jax array, ``spec.to_dict()``,
``topology.spec_params()``) and returns the port's objects on a chosen
device.  The port never imports ``repro``: the caller does the
``np.asarray`` on its side, which keeps this module free of jax.

    spec  = convert.spec(repro_spec.to_dict())
    topo  = convert.topology(repro_topo.kind, repro_topo.spec_params())
    g     = convert.graph(g_ref.xadj, g_ref.adjncy, g_ref.adjwgt, g_ref.vwgt)
    dg    = convert.device_graph(*(np.asarray(a) for a in
                                   (dg_ref.nbr, dg_ref.wgt, dg_ref.eu,
                                    dg_ref.ev, dg_ref.ew)),
                                 n=dg_ref.n, num_edges=dg_ref.num_edges,
                                 device="cuda")
    us, vs = convert.pairs(np.asarray(us_ref), np.asarray(vs_ref), "cuda")
    perm  = convert.perm(np.asarray(perm_ref), "cuda")
"""

from __future__ import annotations

import numpy as np

from .core.graph import CommGraph, DeviceGraph
from .core.spec import MappingSpec, PlanSpec, TopologySpec
from .runtime.device import resolve_device

__all__ = ["device_graph", "graph", "pairs", "perm", "plan_spec", "spec",
           "topology", "topology_from_matrix"]


def spec(d: dict) -> MappingSpec:
    """A ``MappingSpec.to_dict()`` of the JAX package → the port's
    spec (the two share one dict form)."""
    return MappingSpec.from_dict(dict(d)).validate()


def plan_spec(d: dict) -> PlanSpec:
    """A ``PlanSpec.to_dict()`` (or a saved plan's JSON, parsed) → the
    port's plan spec."""
    return PlanSpec.from_dict(dict(d)).validate()


def topology(kind: str, params: dict):
    """A registered topology from its kind and ``spec_params()``."""
    return TopologySpec(kind=kind, params=dict(params)).build()


def topology_from_matrix(D) -> object:
    """An explicit-matrix topology over a (n, n) distance table."""
    from .topology import MatrixTopology
    return MatrixTopology(matrix=np.asarray(D, dtype=np.float64))


def graph(xadj, adjncy, adjwgt, vwgt=None) -> CommGraph:
    """CSR arrays → the port's :class:`CommGraph` (host, numpy)."""
    xadj = np.asarray(xadj, dtype=np.int64)
    n = len(xadj) - 1
    return CommGraph(
        xadj=xadj.copy(),
        adjncy=np.asarray(adjncy, dtype=np.int64).copy(),
        adjwgt=np.asarray(adjwgt, dtype=np.float64).copy(),
        vwgt=(np.ones(n) if vwgt is None
              else np.asarray(vwgt, dtype=np.float64).copy()))


def _tensor(a, dtype, device):
    import torch
    return torch.from_numpy(np.array(a, dtype=dtype)).to(device)


def device_graph(nbr, wgt, eu, ev, ew, n: int, num_edges: int,
                 device=None) -> DeviceGraph:
    """The JAX package's ``DeviceGraph`` arrays (as numpy) → the port's
    :class:`DeviceGraph` on ``device`` (``"cuda"`` by default)."""
    dev = resolve_device(device)
    return DeviceGraph(nbr=_tensor(nbr, np.int32, dev),
                       wgt=_tensor(wgt, np.float32, dev),
                       eu=_tensor(eu, np.int32, dev),
                       ev=_tensor(ev, np.int32, dev),
                       ew=_tensor(ew, np.float32, dev),
                       n=int(n), num_edges=int(num_edges))


def pairs(us, vs, device=None) -> tuple:
    """Padded candidate-pair arrays (as numpy) → int32 device tensors."""
    dev = resolve_device(device)
    return _tensor(us, np.int32, dev), _tensor(vs, np.int32, dev)


def perm(p, device=None):
    """A permutation (process → PE, as numpy) → an int32 device tensor."""
    return _tensor(p, np.int32, resolve_device(device))
