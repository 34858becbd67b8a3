"""Portfolio search on the device: multistart lanes with tabu memory,
perturbation kicks and tournament selection.

The port of the JAX package's ``repro.portfolio``.  VieM's quality comes
from restarting construction + refinement and keeping the best result;
a :class:`PortfolioRunner` runs L restart *lanes* of the refinement
pipeline as ONE sweep loop per level over the shared graph (the graph
and candidate-pair tensors are read by every lane — K1 and K2 take them
without a lane axis — and only the permutations carry one), then runs
kick → refine → tournament rounds at the finest level: every lane is
kicked (:mod:`.kicks` — a random segment reversal or a swap storm),
re-refined, and the incumbent tournament-selected, stopping on
stagnation or the round budget.  Tabu tenure and don't-look bits
(:mod:`repro_torch.engine.sweep`) let lanes walk downhill out of the
local optima the monotone matching converges to.

Configured by :class:`repro_torch.core.spec.PortfolioSpec` inside a
``MappingSpec`` and lowered into :class:`repro_torch.core.plan
.MappingPlan`.  Kick draws come from numpy on the host
(:func:`.search.kick_draws`), not from JAX's threefry: fed the
reference's draws, the port's portfolio equals ``repro``'s exactly on
integer data.
"""

from .kicks import kick_length, make_kick
from .search import PortfolioRunner, RoundsResult, kick_draws

__all__ = ["kick_draws", "kick_length", "make_kick", "PortfolioRunner",
           "RoundsResult"]
