"""The V-cycle: construct at the coarsest level, refine while projecting
down.  The port's copy of the JAX package's ``multilevel/vcycle.py``:
pure orchestration — pyramids come from :mod:`.coarsen`, per-level
refinement is the :class:`~repro_torch.engine.RefinementEngine` (K1 and
K2 on a card), and the plan supplies one engine per level.

Timing flows through :mod:`repro_torch.obs` tracer spans: construction
and every per-level refinement record a span — with level geometry and
(when telemetry collection is on) the engine counter block — and the
result fields are read back off the spans' measured durations.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core.local_search import SearchStats
from ..core.objective import qap_objective
from ..obs import get_tracer
from .coarsen import Level, project_perm

_TR = get_tracer()


@dataclass
class VCycleResult:
    """``perm`` plus host-facing accounting: the finest level's
    refinement stats, the projected (pre-refinement) finest objective as
    the initial objective, and the per-level refined objectives
    (coarsest → finest) for diagnostics."""
    perm: np.ndarray
    initial_objective: float
    stats: SearchStats
    construction_seconds: float
    level_objectives: list[float] = field(default_factory=list)


def _engine_at(engine_of, lvl: int, machine):
    """Resolve a level's refinement engine: ``engine_of`` is either a
    per-level sequence (a :class:`~repro_torch.core.plan.MappingPlan`'s
    engines, indexed by level) or a callable ``machine → engine``."""
    if callable(engine_of):
        return engine_of(machine)
    return engine_of[lvl]


def vcycle_map(pyramid: list[Level], engine_of, construct_fn, cfg,
               seed: int = 0, objective0=None, bucket=None,
               telemetry: bool = False) -> VCycleResult:
    """Run one V-cycle over a built pyramid (finest first): the batch of
    one of :func:`vcycle_map_batch`.

    ``engine_of`` supplies each level's refinement engine (sequence or
    callable, see :func:`_engine_at`); ``construct_fn(g, machine, *,
    seed, cfg)`` maps the coarsest level; ``objective0(graph, perm)``
    scores the finest level (defaults to the host float64 objective).
    ``bucket`` is the plan's finest-level :class:`ShapeBucket` — coarse
    levels keep their own (graph-independent) geometry.  ``telemetry``
    threads the engine counter collection through every level's
    refinement (the finest level's counters ride the returned stats).
    """
    return vcycle_map_batch([pyramid], engine_of, construct_fn, cfg,
                            seed=seed, objective0=objective0, bucket=bucket,
                            telemetry=telemetry)[0]


def vcycle_map_batch(pyramids: list[list[Level]], engine_of, construct_fn,
                     cfg, seed: int = 0, objective0=None,
                     bucket=None, telemetry: bool = False
                     ) -> list[VCycleResult]:
    """Batched V-cycles over same-n graphs: the forced perfect pairing
    makes every pyramid the same depth with the same level sizes, so each
    level's refinement across the whole batch is ONE batched engine call
    (``refine_batch``).  Each graph's result equals its single
    :func:`vcycle_map` (the engine's lanes are independent).  Every
    level records a ``vcycle.refine`` span with its geometry, the lanes'
    pair counts and refined objectives, the engine's retraces and (when
    telemetry collection is on) the lanes' counter blocks."""
    if not pyramids:
        return []
    depths = {len(p) for p in pyramids}
    if len(depths) != 1:
        raise ValueError(f"batched V-cycles need one pyramid depth, "
                         f"got {sorted(depths)}")
    with _TR.span("vcycle.construct", level=len(pyramids[0]) - 1,
                  n=pyramids[0][-1].graph.n, batch=len(pyramids)) as sp:
        perms = [construct_fn(p[-1].graph, p[-1].machine, seed=seed, cfg=cfg)
                 for p in pyramids]
    t_cons = sp.dur / len(pyramids)

    level_objectives = [[] for _ in pyramids]
    stats_list = [SearchStats() for _ in pyramids]
    j0_fine = [0.0] * len(pyramids)
    for lvl in range(depths.pop() - 1, -1, -1):
        levels = [p[lvl] for p in pyramids]
        if lvl == 0 and objective0 is not None:
            j0s = [objective0(lv.graph, perm)
                   for lv, perm in zip(levels, perms)]
        else:
            j0s = [qap_objective(lv.graph, lv.machine, perm)
                   for lv, perm in zip(levels, perms)]
        if lvl == 0:
            j0_fine = j0s
        engine = _engine_at(engine_of, lvl, levels[0].machine)
        tc = getattr(engine, "trace_count", None)
        before = tc() if tc is not None else 0
        with _TR.span("vcycle.refine", level=lvl, n=levels[0].graph.n,
                      batch=len(levels),
                      pairs=[len(lv.pairs) for lv in levels]) as sp:
            stats_list = engine.refine_batch(
                [lv.graph for lv in levels], perms,
                [lv.pairs for lv in levels], j0s=j0s,
                bucket=bucket if lvl == 0 else None,
                telemetry=telemetry)
        if tc is not None:
            sp.attrs["retraces"] = tc() - before
        sp.attrs["final_objective"] = [st.final_objective
                                       for st in stats_list]
        if telemetry:
            sp.attrs["telemetry"] = [st.telemetry for st in stats_list]
        for i, st in enumerate(stats_list):
            level_objectives[i].append(st.final_objective)
        if lvl > 0:
            perms = [project_perm(perm, lv.fine_u, lv.fine_v)
                     for lv, perm in zip(levels, perms)]
    return [VCycleResult(perm=perm, initial_objective=j0, stats=st,
                         construction_seconds=t_cons, level_objectives=lo)
            for perm, j0, st, lo
            in zip(perms, j0_fine, stats_list, level_objectives)]
