"""Communication-graph extraction: compiled program text → VieM model —
the port's copy of the JAX package's ``core/comm_model.py``.

The paper's `generate_model` builds a model of computation and
communication by partitioning an application graph (guide §4.2) — the HPC
way, reproduced in :func:`generate_model` (the partitioner plus
``quotient``).  The framework way goes further: an SPMD program's
collectives *are* its communication pattern, so
:func:`device_comm_graph` parses the program's optimized HLO *text*
(:mod:`repro_torch.analysis.hlo`, which needs no XLA: the text comes
from a compiled program or a saved fixture) and builds the
per-device-pair traffic graph under ring collective algorithms (it also
takes the collectives themselves, as the port's dry-run records them:
``launch.dryrun.CollectiveRecord``):

  all-reduce       ring edges, 2(g−1)/g · bytes per link
  all-gather       ring edges, (g−1) · shard bytes per link
  reduce-scatter   ring edges, (g−1)/g · bytes per link
  all-to-all       clique edges, bytes/g per pair
  collective-permute  explicit source→target edges

The result is *sparse* (rings and small cliques — the paper's sparsity
assumption holds by construction for mesh-parallel programs), symmetric,
and ready for ``Mapper.map`` (or a pre-lowered ``MappingPlan``).
:func:`logical_traffic_summary` reports a mapping's traffic per
hierarchy level.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from ..analysis.hlo import collective_instances
from .construction import quotient
from .graph import CommGraph, from_edges
from .hierarchy import Hierarchy
from .partition import PartitionConfig, partition

__all__ = ["device_comm_graph", "generate_model",
           "logical_traffic_summary"]


def device_comm_graph(program, n_devices: int) -> CommGraph:
    """Per-device-pair traffic graph (bytes) from optimized SPMD HLO
    text, or from an iterable of ``(op, groups, operand_bytes,
    multiplier)`` instances as :func:`collective_instances` yields them
    (a ``launch.dryrun.CollectiveRecord``)."""
    instances = (collective_instances(program) if isinstance(program, str)
                 else program)
    acc: dict[tuple[int, int], float] = defaultdict(float)

    def add(a: int, b: int, w: float):
        if a == b or w <= 0:
            return
        key = (a, b) if a < b else (b, a)
        acc[key] += w

    for op, groups, nbytes, mult in instances:
        if op == "collective-permute":
            for pair in groups:
                if len(pair) == 2:
                    add(pair[0], pair[1], mult * nbytes)
            continue
        for grp in groups:
            g = len(grp)
            if g <= 1:
                continue
            if op == "all-reduce":
                per_link = 2.0 * (g - 1) / g * nbytes
            elif op == "all-gather":
                per_link = (g - 1) * nbytes
            elif op in ("reduce-scatter",):
                per_link = (g - 1) / g * nbytes
            elif op in ("all-to-all", "ragged-all-to-all"):
                per_pair = nbytes / g
                for i in range(g):
                    for j in range(i + 1, g):
                        add(grp[i], grp[j], mult * per_pair)
                continue
            else:  # collective-broadcast & friends: ring price
                per_link = nbytes
            for i in range(g):
                add(grp[i], grp[(i + 1) % g], mult * per_link)

    if not acc:
        return CommGraph(np.zeros(n_devices + 1, np.int64),
                         np.zeros(0, np.int64), np.zeros(0),
                         np.ones(n_devices))
    keys = np.asarray(list(acc.keys()), dtype=np.int64)
    w = np.asarray(list(acc.values()))
    return from_edges(n_devices, keys[:, 0], keys[:, 1], w)


def generate_model(app_graph: CommGraph, k: int,
                   preconfiguration: str = "eco",
                   imbalance: float = 0.03, seed: int = 0
                   ) -> tuple[CommGraph, np.ndarray]:
    """The guide's `generate_model` (§4.2): partition an application graph
    into k blocks, return the quotient model whose vertices are blocks and
    whose edge weights are the summed inter-block edge weights, plus the
    block labels.  (`imbalance` is accepted for CLI fidelity; the
    partitioner balances perfectly, which satisfies any ε ≥ 0.)"""
    del imbalance
    cfg = PartitionConfig.preconfiguration(preconfiguration)
    labels = partition(app_graph, k, cfg, seed=seed)
    model = quotient(app_graph, labels, k)
    return model, labels


def logical_traffic_summary(g: CommGraph, h: Hierarchy,
                            perm: np.ndarray) -> dict:
    """Traffic volume per hierarchy level under assignment ``perm`` —
    reported next to the QAP objective in benchmarks (bytes that cross a
    tray / superblock / pod boundary)."""
    u, v, w = g.edge_list()
    lvl = h.lca_level(perm[u], perm[v])
    out = {}
    for l in range(1, h.k + 1):
        out[f"level_{l}_bytes"] = float(np.sum(w[lvl == l]))
    return out
