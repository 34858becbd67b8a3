"""``correct``: the program's answers against the plain reference.

Every number compared has a limit of its own (``limits/<cell>.json``);
the run is correct when no number passes its limit.  Each traffic kind
judges its own window (``kinds/<kind>.py``: ``judge``) into a
:class:`Verdict`.  A number is computed once from the program's answers
(``control=False``) and, for the control, once with each value that the
program reports replaced by the reference's own value one precision step
below the configuration's: bfloat16 for the float32 objective, float32
for the host's float64 edge L1 (``control=True``).
"""

from __future__ import annotations

__all__ = ["Verdict", "rel"]


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-300)


class Verdict:
    """The numbers compared, each beside its limit, and the tallies."""

    def __init__(self, limits: dict):
        self.limits = limits
        self.values = {name: 0.0 for name in limits}
        self.attempted = 0
        self.failed = 0
        self.j_sums: dict = {}      # structure -> [Σ J(answer), Σ J(random)]
        self.notes: dict = {}       # readings beside the checks

    def add_j(self, structure: str, j: float, j_random: float) -> None:
        sums = self.j_sums.setdefault(structure, [0.0, 0.0])
        sums[0] += j
        sums[1] += j_random

    def worst(self, name: str, value: float) -> bool:
        """Record ``value`` for ``name``; True when it is within limit."""
        self.values[name] = max(self.values[name], float(value))
        return value <= self.limits[name]

    @property
    def correct(self) -> bool:
        return self.failed == 0 and all(
            self.values[k] <= self.limits[k] for k in self.limits)

    def checks(self) -> dict:
        return {k: {"value": self.values[k], "limit": self.limits[k]}
                for k in self.limits}

    @property
    def j_rel(self) -> float | None:
        """Σ J of the answers over Σ J of the run's random placement on
        the same graphs, per structure, averaged over the structures: a
        mix answered in other shares (the grid's maps take five times the
        random graph's) reads the same."""
        ratios = [a / b for a, b in self.j_sums.values() if b > 0]
        return sum(ratios) / len(ratios) if ratios else None
