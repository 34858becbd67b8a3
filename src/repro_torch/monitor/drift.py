"""Drift scoring with hysteresis: has traffic diverged enough from the
graph the incumbent plan was lowered for that a remap is worth trying?

Two complementary signals, both normalized so thresholds are
workload-independent:

* **edge-weight L1** — ``sum(|live - base|) / sum(base)`` over the
  union of edges.  Structure-sensitive: new flows and vanished flows
  both count, even when the incumbent objective happens not to move.
* **objective delta** — ``J_live(incumbent) / J_base(incumbent) - 1``,
  how much worse the *incumbent permutation* prices under live traffic.
  Placement-sensitive: a shift confined to already-colocated pairs
  scores near zero here, correctly reporting "drifted but still well
  mapped".

The detector triggers when the combined score holds at or above
``high`` for ``patience`` consecutive windows (jitter never
accumulates: one quiet window decays the streak), then *disarms* until
the score falls below ``low`` — the classic two-threshold hysteresis
loop, so one long drift episode yields one remap attempt, not one per
window.  ``rebaseline()`` (called when a remap commits) re-arms against
the new baseline.

The port's copy of the JAX package's ``monitor/drift.py``.  The monitor
passes ``plan.objective``: with ``backend="pallas"`` on the card that is
K1 (float32, one counted read a call), whose sum order differs from the
CPU's plain version on real weights in the last bits only.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..core.graph import CommGraph
from ..obs import MetricsRegistry, get_tracer
from .profiler import _edge_dict

_TR = get_tracer()


def edge_weight_l1(base: CommGraph, live: CommGraph) -> float:
    """Normalized L1 distance between edge-weight maps: 0 = identical,
    1 = all baseline traffic rerouted (can exceed 1 when live total
    outgrows the baseline)."""
    be, le = _edge_dict(base), _edge_dict(live)
    total = sum(be.values())
    if total <= 0:
        return 0.0 if not le else float("inf")
    l1 = 0.0
    for k in be.keys() | le.keys():
        l1 += abs(le.get(k, 0.0) - be.get(k, 0.0))
    return l1 / total


@dataclass
class DriftScore:
    """One window's drift measurement + detector state."""
    l1: float
    objective_delta: float
    score: float
    triggered: bool
    armed: bool
    streak: int


class DriftDetector:
    """Hysteresis drift detector over (baseline graph, incumbent perm).

    ``objective_fn(g, perm) -> float`` prices a permutation on a graph
    (pass ``plan.objective`` so the score uses the plan's backend).
    ``high``/``low`` are the trigger/re-arm watermarks on the combined
    score ``max(l1, objective_delta)``; ``patience`` is how many
    consecutive windows must hold at/above ``high`` before triggering.
    """

    def __init__(self, baseline: CommGraph, perm, objective_fn,
                 high: float = 0.10, low: float = 0.05,
                 patience: int = 2,
                 registry: MetricsRegistry | None = None):
        if low > high:
            raise ValueError(f"hysteresis needs low <= high, got "
                             f"low={low} high={high}")
        if patience < 1:
            raise ValueError("patience must be >= 1")
        self.high = float(high)
        self.low = float(low)
        self.patience = int(patience)
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self._objective = objective_fn
        self._streak = 0
        self._armed = True
        self.rebaseline(baseline, perm)

    def rebaseline(self, baseline: CommGraph, perm) -> None:
        """Adopt a new (graph, incumbent) reference — called after a
        committed remap; re-arms the trigger."""
        self.baseline = baseline
        self.perm = perm
        self.j_base = float(self._objective(baseline, perm))
        self._streak = 0
        self._armed = True

    def update(self, live: CommGraph) -> DriftScore:
        """Score one closed window; ``triggered`` fires at most once per
        excursion above ``high`` (re-arms below ``low``)."""
        with _TR.span("monitor.drift") as sp:
            l1 = edge_weight_l1(self.baseline, live)
            j_live = float(self._objective(live, self.perm))
            delta = (0.0 if self.j_base == 0
                     else j_live / self.j_base - 1.0)
            score = max(l1, delta)
            if score >= self.high:
                self._streak += 1
            else:
                self._streak = max(0, self._streak - 1)
            if score < self.low:
                self._armed = True
            triggered = (self._armed and self._streak >= self.patience)
            if triggered:
                self._armed = False
                self._streak = 0
            sp.attrs.update(l1=l1, objective_delta=delta, score=score,
                            triggered=triggered)
            reg = self.registry
            with reg.lock:
                reg.gauge("monitor.drift.l1").set(l1)
                reg.gauge("monitor.drift.objective_delta").set(delta)
                reg.gauge("monitor.drift.score").set(score)
                if triggered:
                    reg.counter("monitor.drift.triggers").inc()
        return DriftScore(l1=l1, objective_delta=delta, score=score,
                          triggered=triggered, armed=self._armed,
                          streak=self._streak)
