"""The portfolio round loop and its host-side runner.

The port of the JAX package's ``portfolio/search.py``.  Starting from L
already-refined lane permutations of one graph, each round the worse half
of the population adopts the incumbent, every lane is kicked
(:mod:`.kicks`), every lane re-refines in one sweep loop over the shared
graph (``RefinementEngine`` with the graph and pair tensors passed once,
without a lane axis: K1 and K2 read them for every lane), the lanes'
objectives come from one K1 launch, and the incumbent is the first
argmin, replaced on strict improvement only.  The loop stops on the
round budget or after ``stagnation`` rounds without improving the
incumbent.

Where the reference runs the rounds as one ``lax.while_loop`` with no
host sync, the port's round loop is a host loop: each round reads back
one flag (whether the incumbent improved, which decides the stagnation
stop) through the round loop's :func:`host_boundary`, beside the sweep
loop's own counted reads.  Everything else stays on the device until the
incumbent is read back at the end.

Randomness: the reference draws its kicks from a threefry key, which
torch's Philox cannot repeat.  The runner draws every round's kicks on
the host before the loop (:func:`kick_draws`, numpy's default generator
seeded with the plan's seed) and uploads them once, with the start
permutations, through page-locked memory on a card — so a card run
draws what a CPU run draws, and the card's portfolio equals the CPU's
bit for bit.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from ..core.graph import CommGraph
from ..core.local_search import SearchStats
from ..engine.sweep import RefinementEngine
from ..runtime.boundary import host_boundary
from .kicks import make_kick

__all__ = ["PortfolioRunner", "RoundsResult", "kick_draws",
           "qap_objective_of"]


def kick_draws(seed: int, rounds: int, lanes: int, n: int,
               klen: int) -> tuple:
    """The kick draws of rounds 1 .. rounds-1 for ``lanes`` lanes of
    ``n``-element permutations, from ``numpy.random.default_rng(seed)``:
    ``(s, uv, coin)`` with ``s`` (rounds-1, lanes) int32 window starts
    in [0, n), ``uv`` (rounds-1, lanes, klen, 2) int32 transposition
    endpoints in [0, n) and ``coin`` (rounds-1, lanes) bool.  Rounds
    after an early stop leave theirs unused."""
    rng = np.random.default_rng(seed)
    r = max(int(rounds) - 1, 0)
    s = rng.integers(0, n, (r, lanes), dtype=np.int32)
    uv = rng.integers(0, n, (r, lanes, klen, 2), dtype=np.int32)
    coin = rng.random((r, lanes)) < 0.5
    return s, uv, coin


def _upload(perms, draws, device):
    """The start permutations and the kick draws in one int32 block: a
    page-locked one on a card, copied up without a sync (a pageable
    host-to-device copy syncs) in one ``host_boundary``.  Returns (the
    host block, which must outlive the copy; the (L, n) permutations;
    ``s``, ``uv``, ``coin`` on the device; the boundary)."""
    import torch
    s, uv, coin = draws
    r, lanes, klen = uv.shape[:3]
    n = perms[0].shape[0]
    size = lanes * n + r * lanes * (2 + 2 * klen)
    if device.type == "cuda":
        from ..core import pinned
        host = pinned.empty((size,), "int32")
    else:
        host = np.empty((size,), np.int32)
    head = lanes * n
    host[:head] = np.stack([np.asarray(p) for p in perms]).reshape(-1)
    body = host[head:].reshape(r, lanes, 2 + 2 * klen)
    body[..., 0] = s
    body[..., 1] = coin
    body[..., 2:] = uv.reshape(r, lanes, 2 * klen)
    with host_boundary("portfolio.upload", device) as hb:
        block = torch.from_numpy(host).to(device, non_blocking=True)
    perms_d = block[:head].view(lanes, n)
    draws_d = block[head:].view(r, lanes, 2 + 2 * klen)
    return (host, perms_d, draws_d[..., 0], draws_d[..., 2:].view(
        r, lanes, klen, 2), draws_d[..., 1].bool(), hb)


class _Timer:
    """Milliseconds of a stretch of device work: CUDA events on a card
    (read after the loop's last sync, so they add none), the host clock
    on the CPU, where the work is done when the call returns."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            import torch
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def spans_ms(self) -> list:
        """Milliseconds between marks 2i and 2i+1."""
        pairs = zip(self.marks[0::2], self.marks[1::2])
        if self.cuda:
            return [a.elapsed_time(b) for a, b in pairs]
        return [(b - a) * 1e3 for a, b in pairs]


@dataclass
class RoundsResult:
    """One portfolio run's host-facing accounting: the incumbent
    permutation, the per-round incumbent objectives (round 0 = the
    multistart best, truncated at the stop), executed rounds, and the
    sweep/swap totals across lanes and rounds."""
    perm: np.ndarray
    round_objectives: list[float] = field(default_factory=list)
    rounds: int = 1
    sweeps: int = 0
    swaps: int = 0


class PortfolioRunner:
    """Host glue between a plan and the portfolio round loop.

    Lowered once per (spec × engine): resolves the per-lane construction
    cycle against the registry and fixes the lane geometry and the tabu
    toggles.  Runtime inputs are the graph, the candidate pairs and the
    seed.  ``last_syncs`` holds the last :meth:`run_rounds`' host syncs
    (counted reads and, on a card, the syncs PyTorch observed, of the
    upload and of the round loop) and ``last_rounds`` each round's
    incumbent objective, kick milliseconds, wall seconds, reads and
    each lane's sweeps.
    """

    def __init__(self, engine: RefinementEngine, pspec, constructions):
        self.engine = engine
        self.pspec = pspec
        # (name, fn) per lane — the construction portfolio cycled across
        # the lane axis
        names = list(pspec.constructions or ()) or [constructions[0][0]]
        by_name = dict(constructions)
        self.lane_constructions = [
            (names[i % len(names)], by_name[names[i % len(names)]])
            for i in range(pspec.lanes)]
        # don't-look bits only matter alongside a nonzero tenure (without
        # it the sweep is monotone and stops at the first cold state)
        self.tabu_tenure = int(pspec.tabu_tenure)
        self.dlb = bool(pspec.dont_look) and self.tabu_tenure > 0
        self.last_syncs: dict = {}
        self.last_rounds: list = []

    # ------------------------------------------------------------ describe
    def describe(self) -> dict:
        """Lane geometry for ``plan.describe()``."""
        return {
            "lanes": self.pspec.lanes,
            "rounds": self.pspec.rounds,
            "tabu_tenure": self.tabu_tenure,
            "dont_look": self.dlb,
            "kick_strength": self.pspec.kick_strength,
            "stagnation": self.pspec.stagnation,
            "lane_constructions": [name for name, _
                                   in self.lane_constructions],
        }

    # ------------------------------------------------------------- stages
    def construct_lanes(self, g: CommGraph, machine, cfg,
                        seed: int) -> list[np.ndarray]:
        """Per-lane initial permutations: lane i runs its registered
        construction with seed ``seed + i``."""
        return [fn(g, machine, seed=seed + i, cfg=cfg)
                for i, (_, fn) in enumerate(self.lane_constructions)]

    def refine_lanes(self, g: CommGraph, perms, pairs, j0s=None,
                     bucket=None, engine: RefinementEngine | None = None,
                     telemetry: bool = False) -> list[SearchStats]:
        """One sweep loop over all lanes of the shared graph (round 0,
        and every coarse V-cycle level) — the engine's lane path with
        this portfolio's tabu toggles applied."""
        return (engine or self.engine).refine_lanes(
            g, perms, pairs, j0s=j0s, bucket=bucket,
            tabu_tenure=self.tabu_tenure, dlb=self.dlb,
            telemetry=telemetry)

    def run_rounds(self, g: CommGraph, perms, pairs, j0s,
                   bucket=None, seed: int = 0) -> RoundsResult:
        """The kick → refine → tournament round loop from the round-0
        refined lane ``perms``; ``j0s`` (the lanes' objectives before
        round 0) fix each lane's acceptance threshold, as in round 0.
        With ``rounds=1`` (or no candidate pairs) there is nothing to
        perturb: the incumbent is the host float64 argmin over the
        lanes, keeping the pure-multistart path free of kick noise."""
        import torch

        from ..kernels import pair_gain as pg
        eng = self.engine
        self.last_rounds = []
        if self.pspec.rounds <= 1 or len(pairs) == 0:
            js = [float(qap_objective_of(eng, g, p)) for p in perms]
            b = int(np.argmin(js))
            self.last_syncs = {"upload": None, "reads": 0, "observed": None}
            return RoundsResult(perm=np.asarray(perms[b]).copy(),
                                round_objectives=[js[b]], rounds=1)
        dev = eng.device
        lanes, rounds, n = len(perms), self.pspec.rounds, g.n
        kick = make_kick(n, self.pspec.kick_strength)
        dg, us, vs = eng.shared_inputs(g, pairs, bucket)
        host, ps, s_d, uv_d, coin_d, up = _upload(
            [np.asarray(p, dtype=np.int32) for p in perms],
            kick_draws(seed, rounds, lanes, n, kick.klen), dev)
        eps = [eng._eps(j) for j in j0s]
        half = (lanes + 1) // 2             # lanes=1 → nobody adopts

        def objective(p):
            return pg.edge_objective(eng.kind, eng.params, dg.eu, dg.ev,
                                     dg.ew, p, eng._D,
                                     config=eng.kernel_config)

        kick_t = _Timer(dev)
        rows = []
        with host_boundary("portfolio.rounds", dev) as hb:
            js = objective(ps)
            b = torch.argmin(js)[None]      # the first minimum, like jnp
            inc_perm, inc_j = ps.index_select(0, b), js.index_select(0, b)
            round_js = torch.full((rounds,), float("nan"),
                                  dtype=torch.float32, device=dev)
            round_js[:1] = inc_j
            swaps = torch.zeros((), dtype=torch.int64, device=dev)
            sweeps, stall, r = 0, 0, 1
            while r < rounds and stall < self.pspec.stagnation:
                # the round's wall time: the round ends at its counted
                # read, so the host clock spans the card's work
                t0 = time.perf_counter()  # viem: noqa[VIEM001] wall time
                reads0 = hb.reads
                # tournament seeding: the worse half of the population
                # restarts from the incumbent (rank 0 = best lane;
                # jnp.argsort is stable)
                rank = torch.argsort(torch.argsort(js, stable=True),
                                     stable=True)
                ps = torch.where((rank >= half)[:, None], inc_perm, ps)
                kick_t.mark()
                ps = kick(ps, s_d[r - 1], uv_d[r - 1], coin_d[r - 1])
                kick_t.mark()
                # telemetry stays off inside the round loop, as in the
                # reference; the rounds' sweep/swap totals are kept
                ps, _, sw, sp, _ = eng._refine(
                    dg.nbr, dg.wgt, dg.eu, dg.ev, dg.ew, us, vs, ps,
                    eng._D, eps, self.tabu_tenure, self.dlb, False, hb)
                js = objective(ps)
                b = torch.argmin(js)[None]
                jb = js.index_select(0, b)
                improved = jb < inc_j
                inc_perm = torch.where(improved[:, None],
                                       ps.index_select(0, b), inc_perm)
                inc_j = torch.where(improved, jb, inc_j)
                round_js[r:r + 1] = inc_j
                sweeps += int(sw.sum())
                swaps += sp.sum()
                # the round's one read: the stagnation stop
                stall = 0 if hb.read(improved[0]) else stall + 1
                dt = time.perf_counter() - t0  # viem: noqa[VIEM001] wall time
                rows.append({"round": r, "seconds": dt,
                             "reads": hb.reads - reads0,
                             "lane_sweeps": sw.tolist()})
                r += 1
        with host_boundary("portfolio.readback") as rb:
            perm_h = rb.read(inc_perm[0]).astype(np.int64)
            round_h = rb.read(round_js[:r])
            swaps_h = int(rb.read(swaps))
        del host                            # the copy is long done
        for row, ms, j in zip(rows, kick_t.spans_ms(), round_h[1:]):
            row.update(kick_ms=ms, incumbent=float(j))
        self.last_rounds = rows
        self.last_syncs = {"upload": up.syncs, "reads": hb.reads,
                           "observed": hb.syncs}
        return RoundsResult(perm=perm_h,
                            round_objectives=[float(x) for x in round_h],
                            rounds=r, sweeps=sweeps, swaps=swaps_h)


def qap_objective_of(engine: RefinementEngine, g: CommGraph,
                     perm) -> float:
    """Host float64 objective against the engine's topology."""
    from ..core.objective import qap_objective
    return qap_objective(g, engine.topology, perm)
