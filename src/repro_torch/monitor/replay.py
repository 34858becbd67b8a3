"""What-if replay: predict step-time under a candidate mapping BEFORE
committing it, byteprofile-analysis style.

The predictor is the three-term roofline (:mod:`repro_torch.analysis.
roofline`): compute and memory terms come from an optional
:class:`~repro_torch.analysis.hlo.HloCost` of the running program (zero when
profiling traffic alone), while the collective term is re-priced for a
*specific permutation* from the live traffic graph:

    comm_s(perm) = sum_e  w_e * d(perm[u_e], perm[v_e])
                   / (n_devices * link_bandwidth)

i.e. the QAP objective itself, interpreted as hop-weighted wire bytes
and normalized to per-device seconds — so "the candidate halves the
objective" translates directly into a predicted collective-term
speedup, and a compute-bound program correctly predicts *no* step-time
win (max-of-terms), gating pointless remaps off.

``evaluate`` is the accept/reject gate: a candidate is accepted only if
its predicted step time improves on the incumbent's by at least
``margin`` (relative) AND its objective strictly improves.  Every
verdict records a ``monitor.replay`` span (visible in the Perfetto
trace) plus accept/reject counters.

The port's copy of the JAX package's ``monitor/replay.py``.  The
roofline's constants are those of the *mapped fleet* (a TPU v5e's, see
:mod:`repro_torch.analysis.roofline`), kept so that the verdicts equal
the reference's; they say nothing of the card the port runs on.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..analysis.hlo import HloCost
from ..analysis.roofline import (HBM_BW, ICI_BW, PEAK_FLOPS_BF16,
                                 roofline_from_cost)
from ..core.graph import CommGraph
from ..core.objective import qap_objective
from ..obs import MetricsRegistry, get_tracer

_TR = get_tracer()


@dataclass
class ReplayVerdict:
    accepted: bool
    predicted_incumbent_s: float
    predicted_candidate_s: float
    predicted_improvement: float    # relative step-time win, >= 0 is better
    margin: float
    objective_incumbent: float
    objective_candidate: float

    def row(self) -> dict:
        return {
            "accepted": self.accepted,
            "predicted_incumbent_s": self.predicted_incumbent_s,
            "predicted_candidate_s": self.predicted_candidate_s,
            "predicted_improvement": self.predicted_improvement,
            "margin": self.margin,
            "objective_incumbent": self.objective_incumbent,
            "objective_candidate": self.objective_candidate,
        }


class WhatIfReplay:
    """Step-time predictor + margin gate for candidate mappings.

    ``topology`` supplies the distance oracle ``d``; ``cost`` (optional)
    the fixed compute/memory terms; ``objective_fn(g, perm)`` overrides
    the QAP pricing (pass ``plan.objective`` for backend parity —
    default is the host oracle).
    """

    def __init__(self, topology, margin: float = 0.02,
                 cost: HloCost | None = None, link_bw: float = ICI_BW,
                 objective_fn=None,
                 registry: MetricsRegistry | None = None):
        if margin < 0:
            raise ValueError("margin must be >= 0")
        self.topology = topology
        self.margin = float(margin)
        self.cost = cost
        self.link_bw = float(link_bw)
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self._objective = objective_fn if objective_fn is not None else \
            (lambda g, p: qap_objective(g, topology, p))

    # ------------------------------------------------------------ prediction
    def _fixed_terms(self) -> tuple[float, float]:
        if self.cost is None:
            return 0.0, 0.0
        r = roofline_from_cost(self.cost, peak_flops=PEAK_FLOPS_BF16,
                               hbm_bw=HBM_BW)
        return r.compute_s, r.memory_s

    def comm_seconds(self, live: CommGraph, perm: np.ndarray,
                     objective: float | None = None) -> float:
        """Hop-weighted wire-byte seconds per device for this mapping."""
        j = self._objective(live, perm) if objective is None \
            else float(objective)
        return j / (max(1, live.n) * self.link_bw)

    def predict_step_time(self, live: CommGraph, perm: np.ndarray,
                          objective: float | None = None) -> float:
        """max(compute, memory, comm(perm)) — perfect-overlap roofline."""
        compute_s, memory_s = self._fixed_terms()
        return max(compute_s, memory_s,
                   self.comm_seconds(live, perm, objective))

    # ------------------------------------------------------------------ gate
    def evaluate(self, live: CommGraph, incumbent: np.ndarray,
                 candidate: np.ndarray,
                 j_incumbent: float | None = None,
                 j_candidate: float | None = None) -> ReplayVerdict:
        """Accept the candidate iff predicted step time improves by
        >= ``margin`` (relative) and the objective strictly improves."""
        with _TR.span("monitor.replay", n=live.n,
                      margin=self.margin) as sp:
            ji = self._objective(live, incumbent) if j_incumbent is None \
                else float(j_incumbent)
            jc = self._objective(live, candidate) if j_candidate is None \
                else float(j_candidate)
            ti = self.predict_step_time(live, incumbent, objective=ji)
            tc = self.predict_step_time(live, candidate, objective=jc)
            win = 0.0 if ti <= 0 else 1.0 - tc / ti
            accepted = bool(win >= self.margin and jc < ji)
            sp.attrs.update(accepted=accepted,
                            predicted_incumbent_s=ti,
                            predicted_candidate_s=tc,
                            predicted_improvement=win,
                            objective_incumbent=ji,
                            objective_candidate=jc)
            reg = self.registry
            with reg.lock:
                reg.counter("monitor.replay.evaluated").inc()
                reg.counter("monitor.replay.accepted" if accepted
                            else "monitor.replay.rejected").inc()
                reg.gauge("monitor.replay.predicted_improvement").set(win)
        return ReplayVerdict(accepted=accepted,
                             predicted_incumbent_s=ti,
                             predicted_candidate_s=tc,
                             predicted_improvement=win,
                             margin=self.margin,
                             objective_incumbent=ji,
                             objective_candidate=jc)
