"""Public wrappers over the kernels, on an explicit device: the port of
the JAX package's ``kernels/ops.py``.

Each takes ``device`` (``"cuda"`` unless the caller asks for ``"cpu"``;
no card is an error, never a fallback).  On CUDA the wrappers launch the
hand-written kernels, on the CPU their plain versions; the ``*_ref``
functions run the plain oracles of :mod:`.ref` on the same device.
"""

from __future__ import annotations

import numpy as np

from ..runtime.boundary import host_boundary
from ..runtime.device import resolve_device
from . import ref
from .pad import pad_edge_arrays
from .qap_objective import qap_objective_edges
from .swap_gain import swap_gain_matrix

__all__ = ["comm_matrix", "gain_matrix", "gain_matrix_ref", "objective",
           "objective_ref", "permuted_distances"]


def _on(x, dev, dtype=None):
    """A tensor (kept as is) or an array-like (numpy's dtype kept) on
    ``dev``."""
    import torch
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))
    return t.to(dev) if dtype is None else t.to(dev, dtype)


def permuted_distances(D, perm):
    """B[u,v] = D[perm[u], perm[v]], gathered on D's device (the JAX
    package forms it the same way, outside its kernel)."""
    import torch
    p = _on(perm, D.device, torch.long)
    return D.index_select(0, p).index_select(1, p)


def comm_matrix(graph, device=None):
    """The dense communication matrix C (n, n) float32, scattered on the
    device from the graph's CSR arrays: equal to ``graph.to_dense()``
    cast to float32, without the host's n² float64 array."""
    import torch
    dev = resolve_device(device)
    n = graph.n
    src = np.repeat(np.arange(n, dtype=np.int64), np.diff(graph.xadj))
    C = torch.zeros((n, n), dtype=torch.float32, device=dev)
    C[_on(src, dev), _on(np.asarray(graph.adjncy, dtype=np.int64), dev)] = \
        _on(np.asarray(graph.adjwgt, dtype=np.float32), dev)
    return C


def gain_matrix(C, D, perm, tile: int = 128, device=None):
    """Gain matrix for all pair exchanges under assignment ``perm``.

    C: (n,n) symmetric communication matrix; D: (n,n) PE distances;
    perm: (n,) process→PE (arrays or tensors).  Returns (n,n) float32 on
    ``device``, G[u,v] = improvement from swapping u and v."""
    dev = resolve_device(device)
    D = _on(D, dev)
    return swap_gain_matrix(_on(C, dev), permuted_distances(D, perm),
                            tile=tile)


def gain_matrix_ref(C, D, perm, device=None):
    import torch
    dev = resolve_device(device)
    D = _on(D, dev, torch.float32)
    return ref.swap_gain_matrix_ref(_on(C, dev, torch.float32),
                                    permuted_distances(D, perm))


def _tree_params(hierarchy) -> tuple:
    return (tuple(int(s) for s in hierarchy.strides),
            tuple(float(d) for d in hierarchy.distances))


def objective(graph, hierarchy, perm, device=None) -> float:
    """Sparse QAP objective on the device (K1 on CUDA).  Accepts the core
    CommGraph/Hierarchy types; each undirected edge counted once."""
    import torch
    dev = resolve_device(device)
    u, v, w = graph.edge_list()
    eu, ev, ew = pad_edge_arrays(u, v, w, device=dev)
    p = _on(np.asarray(perm, dtype=np.int32), dev)
    D = torch.zeros((1, 1), dtype=torch.float32, device=dev)
    with host_boundary("objective.readback") as rb:
        return float(rb.read(qap_objective_edges(
            "tree", _tree_params(hierarchy), eu, ev, ew, p, D)))


def objective_ref(graph, hierarchy, perm, device=None) -> float:
    import torch
    dev = resolve_device(device)
    u, v, w = graph.edge_list()
    perm = np.asarray(perm)
    with host_boundary("objective.readback") as rb:
        return float(rb.read(ref.qap_objective_edges_ref(
            _on(perm[u], dev, torch.int32), _on(perm[v], dev, torch.int32),
            _on(w, dev, torch.float32), *_tree_params(hierarchy))))
