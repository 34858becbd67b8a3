"""Live traffic ingestion: observations → windowed, smoothed CommGraph —
the port's copy of the JAX package's ``monitor/profiler.py``.

A :class:`TrafficProfiler` accumulates traffic observations for the
current window — compiled HLO text or a traced step's collective record
(priced through
:func:`~repro_torch.core.comm_model.device_comm_graph`'s ring-collective
model), an already-extracted :class:`~repro_torch.core.graph.CommGraph`, raw
``(u, v, bytes)`` edge observations, or recorded tracer spans carrying
``src``/``dst``/``bytes`` attributes — and on ``end_window()`` folds
them into an EMA-smoothed live graph:

    smoothed = alpha * window + (1 - alpha) * smoothed

Edges whose smoothed weight decays below ``min_weight`` are dropped, so
traffic that stops flowing eventually leaves the graph instead of
haunting the drift score forever.  Each window publishes gauges
(``monitor.traffic.bytes``, ``.edges``, ``.windows``) and an edge-bytes
histogram into the registry, so the live traffic shape is scrapeable
next to the decision counters.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from ..core.comm_model import device_comm_graph
from ..core.graph import CommGraph, from_edges
from ..obs import MetricsRegistry, get_tracer

_TR = get_tracer()


def _edge_dict(g: CommGraph) -> dict[tuple[int, int], float]:
    u, v, w = g.edge_list()
    return {(int(a), int(b)): float(c) for a, b, c in zip(u, v, w)}


def graph_from_dict(n: int, edges: dict[tuple[int, int], float]
                    ) -> CommGraph:
    """Build a CommGraph from an undirected ``{(u, v): w}`` dict
    (self-loops and non-positive weights dropped)."""
    keep = [(u, v, w) for (u, v), w in edges.items()
            if u != v and w > 0]
    if not keep:
        return CommGraph(np.zeros(n + 1, np.int64), np.zeros(0, np.int64),
                         np.zeros(0), np.ones(n))
    arr = np.asarray([(u, v) for u, v, _ in keep], dtype=np.int64)
    w = np.asarray([w for _, _, w in keep])
    return from_edges(n, arr[:, 0], arr[:, 1], w)


class TrafficProfiler:
    """Windowed EMA profiler over per-device-pair traffic (bytes).

    ``alpha`` is the EMA weight of the newest window (1.0 = no
    smoothing, each window stands alone); ``min_weight`` prunes decayed
    edges.  ``live()`` returns the current smoothed graph; windows with
    zero observations decay every edge toward zero.
    """

    def __init__(self, n_devices: int, alpha: float = 0.5,
                 min_weight: float = 1.0,
                 registry: MetricsRegistry | None = None):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.n = int(n_devices)
        self.alpha = float(alpha)
        self.min_weight = float(min_weight)
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.windows = 0
        self._window: dict[tuple[int, int], float] = defaultdict(float)
        self._smooth: dict[tuple[int, int], float] = {}

    # ------------------------------------------------------------- ingestion
    def _add(self, u: int, v: int, w: float) -> None:
        if u == v or w <= 0:
            return
        if not (0 <= u < self.n and 0 <= v < self.n):
            raise ValueError(f"edge ({u}, {v}) outside device range "
                             f"[0, {self.n})")
        self._window[(u, v) if u < v else (v, u)] += float(w)

    def ingest_edges(self, us, vs, ws) -> None:
        """Raw per-pair byte observations (directions folded)."""
        for u, v, w in zip(us, vs, ws):
            self._add(int(u), int(v), float(w))

    def ingest_graph(self, g: CommGraph) -> None:
        """An already-extracted traffic graph for this window."""
        if g.n != self.n:
            raise ValueError(f"graph has {g.n} vertices, profiler "
                             f"expects {self.n}")
        for (u, v), w in _edge_dict(g).items():
            self._add(u, v, w)

    def ingest_hlo(self, program) -> None:
        """Compiled HLO for one (re)compiled step, or the port's traced
        step's collective record (``launch.dryrun.CollectiveRecord``):
        collectives priced through the ring model into per-device-pair
        bytes."""
        self.ingest_graph(device_comm_graph(program, self.n))

    def ingest_spans(self, spans) -> None:
        """Recorded tracer spans carrying ``src``/``dst``/``bytes``
        attrs (e.g. a transport layer annotating sends)."""
        for sp in spans:
            attrs = getattr(sp, "attrs", None) or {}
            if {"src", "dst", "bytes"} <= set(attrs):
                self._add(int(attrs["src"]), int(attrs["dst"]),
                          float(attrs["bytes"]))

    def prime(self, g: CommGraph) -> None:
        """Seed the EMA so ``live()`` starts exactly at ``g`` (instead
        of ``alpha * g`` after one ingested window) — the monitor primes
        with the baseline so window one scores drift against it, not
        against a half-decayed copy."""
        if g.n != self.n:
            raise ValueError(f"graph has {g.n} vertices, profiler "
                             f"expects {self.n}")
        self._smooth = {k: w for k, w in _edge_dict(g).items()
                        if w >= self.min_weight}

    # --------------------------------------------------------------- windows
    def end_window(self) -> CommGraph:
        """Close the window: fold observations into the EMA, publish
        window metrics, return the smoothed live graph."""
        with _TR.span("monitor.window", n=self.n,
                      observed_edges=len(self._window)):
            a = self.alpha
            smooth = {k: (1 - a) * w for k, w in self._smooth.items()}
            for k, w in self._window.items():
                smooth[k] = smooth.get(k, 0.0) + a * w
            self._smooth = {k: w for k, w in smooth.items()
                            if w >= self.min_weight}
            self._window = defaultdict(float)
            self.windows += 1
            live = self.live()
            reg = self.registry
            with reg.lock:
                reg.counter("monitor.windows").inc()
                reg.gauge("monitor.traffic.bytes").set(
                    float(sum(self._smooth.values())))
                reg.gauge("monitor.traffic.edges").set(
                    float(len(self._smooth)))
                hist = reg.histogram("monitor.traffic.edge_bytes")
                for w in self._smooth.values():
                    hist.observe(w)
        return live

    def live(self) -> CommGraph:
        """The current EMA-smoothed traffic graph."""
        return graph_from_dict(self.n, self._smooth)

    def live_edges(self) -> dict[tuple[int, int], float]:
        return dict(self._smooth)
