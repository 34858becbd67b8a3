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
    model = convert.lm_params(jax.tree.map(np.asarray, params_ref), cfg,
                              "cuda")
    caches = convert.lm_caches(jax.tree.map(np.asarray, caches_ref), cfg,
                               "cuda")
    state = convert.train_state(jax.tree.map(np.asarray, state_ref), cfg,
                                "cuda")

and back: ``reference_tree(state)`` is a port train state (or model) in
the JAX package's tree, which ``CheckpointManager`` saves as the JAX
package saves its own.
"""

from __future__ import annotations

import numpy as np

from .core.graph import CommGraph, DeviceGraph
from .core.spec import MappingSpec, PlanSpec, TopologySpec
from .runtime.device import resolve_device

__all__ = ["device_graph", "graph", "lm_caches", "lm_params", "pairs",
           "perm",
           "plan_spec", "reference_tree", "spec", "topology",
           "topology_from_matrix", "train_state"]


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


def _lm_tensor(a, device):
    """A numpy array of the JAX package's weights → a tensor of the same
    type; bfloat16 arrives as numpy's ``bfloat16`` extension type and is
    moved bit for bit."""
    import torch
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def lm_params(tree: dict, cfg, device=None):
    """The JAX package's ``init_params`` tree, as numpy arrays
    (``embeddings`` and ``periods[pos][name]`` stacked over n_periods) →
    the port's :class:`~repro_torch.models.transformer.Transformer` on
    ``device``.  Layer i = period·p + pos takes ``periods[pos]`` at index
    ``period``; its kind is ``cfg.layer_kind(i)``, and every leaf keeps
    its type: a bfloat16 model's float32 leaves (Mamba ``a_log`` and
    ``d_skip``, RWKV ``w0`` and ``u``, the MoE ``router``) stay
    float32."""
    from .models.transformer import Transformer
    dev = resolve_device(device)
    p = cfg.period
    emb = {k: _lm_tensor(a, dev) for k, a in tree["embeddings"].items()}

    def layer(i):
        period, pos = divmod(i, p)
        src = tree["periods"][pos]
        return {"norm1": _lm_tensor(src["norm1"][period], dev),
                "norm2": _lm_tensor(src["norm2"][period], dev),
                "mixer": {k: _lm_tensor(a[period], dev)
                          for k, a in src["mixer"].items()},
                "ffn": {k: _lm_tensor(a[period], dev)
                        for k, a in src["ffn"].items()}}

    return Transformer(cfg, emb, [layer(i) for i in range(cfg.n_layers)])


def lm_caches(tree: list, cfg, device=None) -> list:
    """The JAX package's decode caches (``init_caches``,
    ``prefill_with_cache``, ``decode_step``: one dict per period position,
    every leaf stacked over n_periods), as numpy arrays → the port's, one
    dict per layer (``attn`` {k, v}, ``mamba`` {conv, ssm}, ``rwkv``
    {x, s}, ``cmix`` {x}) on ``device``, with the layer mapping of
    :func:`lm_params`."""
    dev = resolve_device(device)
    p = cfg.period
    out = []
    for i in range(cfg.n_layers):
        period, pos = divmod(i, p)
        out.append({kind: {name: _lm_tensor(a[period], dev)
                           for name, a in leaves.items()}
                    for kind, leaves in tree[pos].items()})
    return out


def train_state(tree: dict, cfg, device=None) -> dict:
    """The JAX package's ``init_train_state`` tree, as numpy arrays
    (``params``, ``m`` and ``v`` stacked over n_periods, ``step``) → the
    port's train state on ``device``: the parameters trainable, ``m`` and
    ``v`` keyed by the parameters' names, the same layer mapping as
    :func:`lm_params`."""
    import torch
    dev = resolve_device(device)
    params = lm_params(tree["params"], cfg, dev)
    params.requires_grad_(True)

    def moments(t):
        return {k: p.detach() for k, p in
                lm_params(t, cfg, dev).named_parameters()}

    return {"params": params, "m": moments(tree["m"]),
            "v": moments(tree["v"]),
            "step": torch.tensor(int(np.asarray(tree["step"])),
                                 dtype=torch.int32).to(dev)}


def _stacked(named: dict, cfg) -> dict:
    """{name: tensor} keyed as a ``Transformer``'s ``named_parameters()``
    → the JAX package's tree, the inverse of :func:`lm_params`'s layer
    mapping: ``embeddings`` and ``periods[pos]``, layer i = period·p +
    pos at index ``period`` of each leaf (a ``checkpoint.Stacked``)."""
    from .checkpoint.checkpoint import Stacked
    p = cfg.period
    emb = {k.split(".", 1)[1]: t for k, t in named.items()
           if k.startswith("embeddings.")}
    periods = []
    for pos in range(p):
        first = f"layers.{pos}."
        tree = {}
        for name in (k[len(first):] for k in named if k.startswith(first)):
            *path, leaf = name.split(".")
            node = tree
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = Stacked(named[f"layers.{i}.{name}"]
                                 for i in range(pos, cfg.n_layers, p))
        periods.append(tree)
    return {"embeddings": emb, "periods": periods}


def reference_tree(tree):
    """A port model (``Transformer``) or train state (``{"params":
    Transformer, "m": {name: t}, "v": {name: t}, "step": t}``) in the JAX
    package's tree: the same paths (``['params']['periods'][0]['mixer']
    ['w_in']``), shapes and types, each layer leaf a ``Stacked`` of the
    port's tensors (no copy until a checkpoint snapshots it)."""
    from .models.transformer import Transformer
    if isinstance(tree, Transformer):
        return _stacked(dict(tree.named_parameters()), tree.cfg)
    cfg = tree["params"].cfg
    return dict(tree, params=reference_tree(tree["params"]),
                **{k: _stacked(tree[k], cfg) for k in ("m", "v")})
