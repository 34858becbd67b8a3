"""The closed loop: profile → detect drift → incremental remap →
what-if gate → commit or roll back — the port's copy of the JAX
package's ``monitor/loop.py``.

:class:`RemapMonitor` owns an incumbent permutation and the plan it was
lowered under, and advances in discrete windows: feed traffic
observations (``observe_hlo``/``observe_graph``/``observe_edges``),
then call ``tick()``.  Each tick closes the profiler window, scores
drift with hysteresis, and — only when the detector triggers — runs an
*incremental* remap: the dirty region's candidate pairs stay active,
everything else is masked to inert self-pairs, and the device engine
refines the incumbent in one warm call (``MappingPlan.execute_warm``:
on the card, K2's pair gains and K1's objective).  The pair array's
length P never changes, so no kernel is built after the first call and
the padded device shapes stay those of the plan; every host sync of the
warm call is a counted read (``engine.last_syncs``).  ``retraces`` is
kept for parity with the JAX package and is always 0 here (the eager
engine's ``trace_count``).  The refined
candidate must then clear the what-if replay margin before it replaces
the incumbent; a rejected candidate leaves the incumbent untouched and
the detector disarmed until traffic drifts further.

``handle_action`` feeds :class:`~repro_torch.runtime.fault_tolerance.Action`
signals through the *same* gate: ``REBALANCE`` marks the processes
mapped onto the slow hosts' PEs dirty and forces a gated remap attempt
at the next tick; ``EVICT_RESTART`` forces a full-region attempt.
``attach`` subscribes directly to a ``StragglerMonitor``'s ``on_action``
callback.  Every decision is spans + counters on the shared registry,
so ``viem remap-watch --profile`` shows the whole loop in Perfetto.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.graph import CommGraph
from ..obs import MetricsRegistry, get_tracer
from ..runtime.fault_tolerance import Action
from .drift import DriftDetector, DriftScore
from .profiler import TrafficProfiler
from .remap import dirty_pair_mask, dirty_vertices, expand_dirty
from .replay import ReplayVerdict, WhatIfReplay

_TR = get_tracer()


@dataclass(frozen=True)
class MonitorConfig:
    """Knobs of the closed loop (see README "Closed-loop remapping")."""
    alpha: float = 0.5            # profiler EMA weight of newest window
    min_weight: float = 1.0       # drop smoothed edges below this
    drift_high: float = 0.10      # trigger watermark on the drift score
    drift_low: float = 0.05       # re-arm watermark (hysteresis)
    drift_patience: int = 2       # consecutive hot windows to trigger
    replay_margin: float = 0.02   # required relative step-time win
    dirty_rel_tol: float = 0.05   # edge-weight change that marks dirty
    dirty_hops: int = 1           # halo growth around the dirty set
    telemetry: bool = False       # engine counters on warm remaps


@dataclass
class TickReport:
    """One window's decision record (also emitted as spans/counters)."""
    window: int
    drift: DriftScore
    triggered: bool
    remapped: bool
    verdict: ReplayVerdict | None = None
    dirty: int = 0
    active_pairs: int = 0
    remap_seconds: float = 0.0
    retraces: int = 0
    forced_by: str | None = None
    skipped: str | None = None


class RemapMonitor:
    """Profile-driven remapping loop over one lowered plan.

    ``plan`` must be lowered with a bucket that admits the traffic the
    loop will see (lower with ``schedule="pow2"`` for headroom);
    ``baseline`` is the graph the incumbent was mapped for; ``perm``
    the incumbent permutation (default: map ``baseline`` through the
    plan).  ``cost`` (an :class:`~repro_torch.analysis.hlo.HloCost`) anchors
    the replay's compute/memory terms; ``on_remap(perm, verdict)`` is
    called after every committed remap (wire it to the launcher's
    re-meshing).
    """

    def __init__(self, plan, baseline: CommGraph,
                 perm: np.ndarray | None = None,
                 config: MonitorConfig = MonitorConfig(),
                 cost=None, registry: MetricsRegistry | None = None,
                 on_remap=None, seed: int | None = None):
        self.plan = plan
        self.config = config
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.on_remap = on_remap
        self.seed = seed
        if perm is None:
            perm = plan.execute(baseline, seed=seed).perm
        self.incumbent = np.asarray(perm, dtype=np.int64).copy()
        self.baseline = baseline
        # the FIXED candidate set: masks vary per remap, the array (and
        # with it the padded device shape) never does
        self.pairs = plan.candidate_pairs(baseline, seed)
        self.profiler = TrafficProfiler(
            baseline.n, alpha=config.alpha, min_weight=config.min_weight,
            registry=self.registry)
        self.profiler.prime(baseline)
        self.detector = DriftDetector(
            baseline, self.incumbent, plan.objective,
            high=config.drift_high, low=config.drift_low,
            patience=config.drift_patience, registry=self.registry)
        self.replay = WhatIfReplay(
            plan.topology, margin=config.replay_margin, cost=cost,
            objective_fn=plan.objective, registry=self.registry)
        self.remaps = 0
        self.ticks = 0
        self._forced: list[tuple[str, np.ndarray]] = []
        self.history: list[TickReport] = []

    # ---------------------------------------------------------- observations
    def observe_hlo(self, program) -> None:
        """A (re)compiled step's HLO text or collective record."""
        self.profiler.ingest_hlo(program)

    def observe_graph(self, g: CommGraph) -> None:
        self.profiler.ingest_graph(g)

    def observe_edges(self, us, vs, ws) -> None:
        self.profiler.ingest_edges(us, vs, ws)

    # -------------------------------------------------------- fault signals
    def handle_action(self, action: Action, hosts=(),
                      pes_per_host: int | None = None) -> None:
        """Consume a fault-tolerance action: force a gated remap attempt
        at the next tick with the affected PEs' processes dirty.
        ``hosts`` are host indices; each host owns a contiguous block of
        ``pes_per_host`` PEs (default: evenly split)."""
        if action == Action.CONTINUE:
            return
        n = self.baseline.n
        dirty = np.zeros(n, dtype=bool)
        if action == Action.EVICT_RESTART or not len(list(hosts)):
            dirty[:] = True
        else:
            hosts = list(hosts)
            if pes_per_host is None:
                pes_per_host = max(1, n // max(1, max(hosts) + 1))
            pe_dirty = np.zeros(n, dtype=bool)
            for h in hosts:
                pe_dirty[h * pes_per_host:(h + 1) * pes_per_host] = True
            # processes currently mapped onto the slow hosts' PEs
            dirty = pe_dirty[self.incumbent]
        self._forced.append((action.value, dirty))
        self.registry.counter(f"monitor.action.{action.value}").inc()

    def attach(self, straggler_monitor) -> None:
        """Subscribe to a ``StragglerMonitor``'s action stream."""
        straggler_monitor.on_action = self.handle_action

    # ------------------------------------------------------------------ tick
    def tick(self) -> TickReport:
        """Close the window and run one decision round."""
        cfg = self.config
        self.ticks += 1
        with _TR.span("monitor.tick", window=self.ticks) as sp:
            live = self.profiler.end_window()
            score = self.detector.update(live)
            forced_by = self._forced[0][0] if self._forced else None
            triggered = score.triggered or bool(self._forced)
            report = TickReport(window=self.ticks, drift=score,
                                triggered=triggered, remapped=False,
                                forced_by=forced_by)
            if not triggered:
                sp.attrs.update(triggered=False, remapped=False)
                self.history.append(report)
                return report
            if self.plan.bucket is not None \
                    and not self.plan.bucket.admits(live):
                # live traffic outgrew the plan's padded shapes: an
                # incremental remap cannot keep them — defer to an
                # operator re-lower instead of silently re-padding
                self.registry.counter("monitor.bucket_exceeded").inc()
                report.skipped = "bucket_exceeded"
                self._forced.clear()
                sp.attrs.update(triggered=True, skipped=report.skipped)
                self.history.append(report)
                return report
            dirty = dirty_vertices(self.detector.baseline, live,
                                   rel_tol=cfg.dirty_rel_tol)
            for _, fd in self._forced:
                dirty |= fd
            self._forced.clear()
            dirty = expand_dirty(live, dirty, hops=cfg.dirty_hops)
            mask = dirty_pair_mask(self.pairs, dirty)
            report.dirty = int(dirty.sum())
            report.active_pairs = int(mask.sum())
            with _TR.span("monitor.remap", dirty=report.dirty,
                          active_pairs=report.active_pairs) as rsp:
                engines = self.plan.engines or []
                before = sum(e.trace_count() for e in engines)
                res = self.plan.execute_warm(
                    live, self.incumbent, pairs=self.pairs, active=mask,
                    seed=self.seed, telemetry=cfg.telemetry)
                report.retraces = \
                    sum(e.trace_count() for e in engines) - before
                rsp.attrs["retraces"] = report.retraces
            report.remap_seconds = rsp.dur
            verdict = self.replay.evaluate(
                live, self.incumbent, res.perm,
                j_incumbent=res.initial_objective,
                j_candidate=res.final_objective)
            report.verdict = verdict
            if verdict.accepted:
                self.incumbent = np.asarray(res.perm, np.int64).copy()
                self.baseline = live
                self.detector.rebaseline(live, self.incumbent)
                self.remaps += 1
                self.registry.counter("monitor.remaps.committed").inc()
                self.registry.histogram("monitor.remap_seconds") \
                    .observe(report.remap_seconds)
                report.remapped = True
                if self.on_remap is not None:
                    self.on_remap(self.incumbent, verdict)
            else:
                self.registry.counter("monitor.remaps.rolled_back").inc()
            sp.attrs.update(triggered=True, remapped=report.remapped,
                            dirty=report.dirty)
        self.history.append(report)
        return report
