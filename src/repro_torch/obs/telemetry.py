"""Host-facing view of the engine counters — the port's copy of the JAX
package's ``obs/telemetry.py``.

The sweep loop (:func:`repro_torch.engine.sweep._make_refine`) keeps
fixed-shape counter tensors beside its state and returns them with the
permutation; they ride the same readback as the trace.  Collection is a
runtime flag: off, every counter stays zero and the search outputs are
identical to the untelemetered engine.

Counters are indexed by *gain pass* (one per sweep-loop body
iteration — every applied sweep plus the final pass that found no
eligible move when the loop converged before its budget, matching the
``SearchStats.evaluated`` accounting):

* ``exchanges[p]``    — pair exchanges applied at pass ``p`` (their sum
  is exactly ``SearchStats.swaps``),
* ``tabu_masked[p]``  — candidate pairs masked out by active tabu
  tenure at pass ``p``,
* ``aspirations[p]``  — tabu pairs *unmasked* because they would beat
  the best-seen objective (the aspiration criterion firing),
* ``match_rounds[p]`` — greedy maximal-matching rounds the conflict
  resolution ran at pass ``p``,
* ``downhill_escapes`` — sweeps that applied the best non-tabu move
  *downhill* (the robust-tabu escape out of a monotone local optimum),
* ``objective_trace`` — the carried device objective, one entry per
  applied sweep (entry 0 = initial).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = ["EngineTelemetry"]

# device-side counter keys, in the order the sweep fn returns them
COUNTER_KEYS = ("exchanges", "tabu_masked", "aspirations", "match_rounds")


@dataclass
class EngineTelemetry:
    """One refinement's engine counters (see module docstring).  Arrays
    are trimmed to the executed gain passes; scalars are host ints."""
    passes: int = 0
    sweeps: int = 0
    exchanges: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int64))
    tabu_masked: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int64))
    aspirations: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int64))
    match_rounds: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int64))
    downhill_escapes: int = 0
    objective_trace: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.float64))
    merged_from: int = 1        # >1 when lanes/levels were aggregated

    @classmethod
    def from_device(cls, tel: dict, objective_trace=None
                    ) -> "EngineTelemetry":
        """Build from the device counter dict (host numpy arrays) one
        engine call returned; arrays are trimmed to the executed
        passes."""
        passes = int(tel["passes"])
        sweeps = int(tel.get("sweeps", passes))

        def trim(key):
            return np.asarray(tel[key][:passes], np.int64)

        trace = (np.zeros(0, np.float64) if objective_trace is None
                 else np.asarray(objective_trace[:sweeps + 1], np.float64))
        return cls(passes=passes, sweeps=sweeps,
                   exchanges=trim("exchanges"),
                   tabu_masked=trim("tabu_masked"),
                   aspirations=trim("aspirations"),
                   match_rounds=trim("match_rounds"),
                   downhill_escapes=int(tel["downhill_escapes"]),
                   objective_trace=trace)

    @classmethod
    def merge(cls, parts: "list[EngineTelemetry]") -> "EngineTelemetry":
        """Aggregate several refinements (portfolio lanes, V-cycle
        levels): per-pass arrays are zero-padded to the longest part and
        summed, scalars summed, ``sweeps``/``passes`` take the maximum
        (the wall-clock-relevant depth of the vmapped call), and the
        objective trace is the elementwise minimum (the incumbent's
        envelope)."""
        parts = [p for p in parts if p is not None]
        if not parts:
            return cls()
        if len(parts) == 1:
            return parts[0]
        passes = max(p.passes for p in parts)

        def padsum(key):
            out = np.zeros(passes, np.int64)
            for p in parts:
                arr = getattr(p, key)
                out[:len(arr)] += arr
            return out

        depth = max(len(p.objective_trace) for p in parts)
        trace = np.full(depth, np.inf)
        for p in parts:
            t = p.objective_trace
            if len(t):
                ext = np.concatenate(
                    [t, np.full(depth - len(t), t[-1])])
                np.minimum(trace, ext, out=trace)
        return cls(passes=passes, sweeps=max(p.sweeps for p in parts),
                   exchanges=padsum("exchanges"),
                   tabu_masked=padsum("tabu_masked"),
                   aspirations=padsum("aspirations"),
                   match_rounds=padsum("match_rounds"),
                   downhill_escapes=sum(p.downhill_escapes
                                        for p in parts),
                   objective_trace=(np.zeros(0, np.float64)
                                    if depth == 0 else trace),
                   merged_from=sum(p.merged_from for p in parts))

    # ----------------------------------------------------------- derived
    @property
    def total_exchanges(self) -> int:
        return int(self.exchanges.sum())

    @property
    def aspiration_fires(self) -> int:
        return int(self.aspirations.sum())

    @property
    def tabu_masked_total(self) -> int:
        return int(self.tabu_masked.sum())

    @property
    def aspiration_rate(self) -> float:
        """Aspiration fires per executed gain pass."""
        return self.aspiration_fires / max(self.passes, 1)

    def summary(self) -> dict:
        """Scalar totals (JSON-safe) — span attributes and the
        ``stats()`` aggregates read this, not the raw arrays."""
        return {
            "passes": self.passes, "sweeps": self.sweeps,
            "exchanges": self.total_exchanges,
            "tabu_masked": self.tabu_masked_total,
            "aspiration_fires": self.aspiration_fires,
            "aspiration_rate": self.aspiration_rate,
            "downhill_escapes": self.downhill_escapes,
            "match_rounds": int(self.match_rounds.sum()),
            "merged_from": self.merged_from,
        }

    def to_dict(self) -> dict:
        """Full JSON-safe dump including the per-sweep arrays."""
        d = self.summary()
        d.update({
            "exchanges_per_sweep": self.exchanges.tolist(),
            "tabu_masked_per_sweep": self.tabu_masked.tolist(),
            "aspirations_per_sweep": self.aspirations.tolist(),
            "match_rounds_per_sweep": self.match_rounds.tolist(),
            "objective_trace": [float(x) for x in self.objective_trace],
        })
        return d
