"""The eager sweep loop and its session wrapper (see package docstring).

``_make_refine`` builds the sweep function — a loop from initial
permutations to converged permutations over a lane axis of graphs, or of
permutations of one shared graph — for one distance form;
:class:`RefinementEngine` wraps it with host glue: DeviceGraph/pair
uploads (cached per graph structure) padded to the batch's common shapes,
eps selection, and :class:`SearchStats` reporting against host float64
objectives.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np

from ..core.graph import CommGraph, DeviceGraph, device_pairs
from ..core.local_search import SearchStats
from ..core.objective import qap_objective
from ..runtime.boundary import host_boundary
from ..runtime.device import resolve_device

# Gain/acceptance threshold relative to |J0|: must sit above the f32
# noise of the device objective (~1e-7 · J0 for the edge-sum) while not
# swallowing genuine gains — the JAX package's value, kept so both
# engines take the same moves.
_EPS_REL = 1e-6


def _make_refine(kind: str, params: tuple, max_sweeps: int, config=None):
    """The sweep fn for one distance form, over a lane axis of B
    instances (B = 1 for a single refinement).

    Signature: ``(nbr, wgt, eu, ev, ew, us, vs, perm0, D, eps, tenure,
    dlb, collect, boundary) -> (perm, trace, sweeps, swaps, tel)``.
    ``nbr``/``wgt`` are (B, n, K), ``eu``/``ev``/``ew`` (B, E),
    ``us``/``vs`` (B, P) and ``perm0`` (B, n) tensors on one device — or,
    for B permutations of one graph (``refine_lanes``), the graph and
    pair tensors without the lane axis ((n, K), (E,), (P,)), read by
    every lane and never copied (K1 and K2 take them so);
    ``D`` is shared; ``eps`` is a sequence of B host floats;
    ``tenure``/``dlb``/``collect`` are host values; ``boundary`` is the
    :class:`~repro_torch.runtime.Boundary` every deliberate readback
    goes through.  Outputs: the (B, n) best permutations, the (B,
    max_sweeps + 1) float32 objective traces (NaN past convergence),
    host (B,) sweep counts, device (B,) swap counts and the telemetry.

    It is the JAX package's ``lax.while_loop`` run eagerly, step for
    step, and its batch form is that loop under ``jax.vmap``: every
    sweep computes the gains of all candidate pairs of all lanes (one K2
    launch), masks tabu / don't-look pairs, builds each lane's greedy
    maximal matching of positive pairs by rounds of locally dominant
    pairs, applies it when the recomputed objective (one K1 launch for
    the batch) beats the lane's best single swap, else falls back to
    that swap, and keeps the best permutation seen.  A lane whose loop
    has ended (no move, or the sweep budget spent) is frozen — its perm,
    objective, trace, swaps, tabu memory and don't-look bits no longer
    change — while the others run on, as under ``vmap``.  Matching
    rounds are counted per lane: a lane with no eligible pair left
    selects nothing in the batch's further rounds.  See the JAX
    package's ``engine/sweep.py`` for the tabu, aspiration, don't-look
    and telemetry semantics, which are the same here.

    Layout: the matching's scatter buffers treat the batch as a disjoint
    union — lane b's vertex u is ``b·n + u`` in buffers of length
    ``B·n + 1`` — and the reference's out-of-range scatter index
    (``mode="drop"`` at ``n``) lands in the scratch slot ``B·n``.

    Host syncs: the reference never leaves its device loop; this loop
    reads back one (B,) vector per sweep (each lane's best masked gain,
    which decides whether the lane moves and whether the matching runs)
    and one flag per matching round (whether any lane has an eligible
    pair left), whatever B is.  A sweep with ``r`` matching rounds
    therefore costs ``1 + r`` syncs; the counts are in
    ``boundary.reads``.  Everything else stays on the device.
    """
    import torch

    from ..kernels import pair_gain as pg

    neg_inf = float("-inf")

    def refine_fn(nbr, wgt, eu, ev, ew, us, vs, perm0, D, eps, tenure,
                  dlb, collect, boundary):
        dev = perm0.device
        b_, n = perm0.shape
        p = us.shape[-1]
        lanes = torch.arange(b_, device=dev)
        base = (lanes * n)[:, None]
        us_l, vs_l = us.long(), vs.long()
        # disjoint-union ids (B, P); shared pairs broadcast to the lanes
        us_f, vs_f = us_l + base, vs_l + base
        idx = torch.arange(p, device=dev)
        oob = torch.full((b_, p), b_ * n, dtype=torch.long, device=dev)
        tabu_on = int(tenure) > 0
        eps_h = np.asarray(eps, dtype=np.float32)   # float32-exact already
        # fills, not a host tensor (nor an element assignment from the
        # host): a pageable H2D copy would sync
        eps_t = torch.cat([torch.full((1,), e, dtype=torch.float32,
                                      device=dev) for e in eps_h.tolist()])
        eps_c = eps_t[:, None]
        true_t = torch.ones((), dtype=torch.bool, device=dev)
        rows = lanes * (max_sweeps + 1)

        def objective(perm):
            return pg.edge_objective(kind, params, eu, ev, ew, perm, D,
                                     config=config)

        def scatter_true(buf, where_, index):
            buf.index_put_((torch.where(where_, index, oob).reshape(-1),),
                           true_t)

        def decide(gbest, done, sweeps, eps):
            """A sweep's per-lane control from its best masked gains:
            the same expressions on the host copy (numpy, which steers
            the loop) and on the device (torch, which masks), so the
            two stay in step.  Returns (active, any_pos, fall_down,
            moved)."""
            act = ~done & (sweeps < max_sweeps)
            any_pos = act & (gbest > eps)
            fall_down = act & ~any_pos & (gbest > neg_inf) if tabu_on \
                else any_pos & False
            return act, any_pos, fall_down, any_pos | fall_down

        def advance(done, sweeps, act, moved):
            """A lane that was active and did not move has ended; one
            that moved took a sweep."""
            return done | (act & ~moved), sweeps + moved

        def at_sweep(buf, col, val, act):
            """buf[b, col[b]] = val[b] for the active lanes."""
            flat = buf.view(-1)
            where_ = rows + col
            flat[where_] = torch.where(act, val, flat[where_])

        j0 = objective(perm0)
        trace = torch.full((b_, max_sweeps + 1), float("nan"),
                           dtype=torch.float32, device=dev)
        trace[:, 0] = j0
        perm, j = perm0, j0
        best_perm, best_j = perm0, j0
        swaps = torch.zeros(b_, dtype=torch.int32, device=dev)
        tabu_until = torch.zeros((b_, p), dtype=torch.int32, device=dev)
        cold = torch.zeros((b_, n), dtype=torch.bool, device=dev)
        tel = {key: torch.zeros((b_, max_sweeps + 1), dtype=torch.int32,
                                device=dev)
               for key in ("exchanges", "tabu_masked", "aspirations",
                           "match_rounds")}
        downhill = np.zeros(b_, np.int64)
        passes = np.zeros(b_, np.int64)
        # the loop state twice: on the host (for control) and on the
        # device (for masking, so no host value is ever copied up); both
        # move only through decide() and advance()
        sweeps = np.zeros(b_, np.int64)
        done = np.zeros(b_, bool)
        sweeps_d = torch.zeros(b_, dtype=torch.int32, device=dev)
        done_d = torch.zeros(b_, dtype=torch.bool, device=dev)
        while not np.all(done | (sweeps >= max_sweeps)):
            g = pg.pair_gains(kind, params, nbr, wgt, perm, us, vs, D,
                              config=config)
            # ---- tabu / don't-look masking (identity when both are off)
            blocked = None
            if tabu_on:
                aspire = (j[:, None] - g) < (best_j - eps_t)[:, None]
                tabu_active = tabu_until > sweeps_d[:, None]
                blocked = (tabu_active & ~aspire) | (us == vs)
            if dlb:
                cold_f = cold.reshape(-1)
                cold_pair = cold_f[us_f] & cold_f[vs_f]
                blocked = cold_pair if blocked is None else blocked | cold_pair
            g_m = g if blocked is None else torch.where(blocked, neg_inf, g)
            best = torch.argmax(g_m, dim=1)         # first max, like jnp
            gbest = g_m.gather(1, best[:, None]).squeeze(1)
            gbest_h = boundary.read(gbest)          # sync 1 of the sweep
            act_h, any_pos_h, fall_down_h, moved_h = decide(
                gbest_h, done, sweeps, eps_h)
            act, any_pos, fall_down, moved = decide(gbest, done_d, sweeps_d,
                                                    eps_t)

            # ---- greedy maximal matching by gain priority (rounds of
            # locally-dominant positive pairs; a lane with no positive
            # pair takes no round, as the reference's first round
            # condition is already false there)
            pos = (g_m > eps_c) & any_pos[:, None]
            sel = torch.zeros((b_, p), dtype=torch.bool, device=dev)
            used = torch.zeros(b_ * n + 1, dtype=torch.bool, device=dev)
            rounds = torch.zeros(b_, dtype=torch.int32, device=dev)
            live = any_pos
            elig = pos if any_pos_h.any() else None
            while elig is not None:
                if collect:
                    rounds += live.to(torch.int32)
                ge = torch.where(elig, g_m, neg_inf)
                vmax = torch.full((b_ * n,), neg_inf, dtype=torch.float32,
                                  device=dev)
                vmax.scatter_reduce_(0, us_f.reshape(-1), ge.reshape(-1),
                                     "amax")
                vmax.scatter_reduce_(0, vs_f.reshape(-1), ge.reshape(-1),
                                     "amax")
                cand = elig & (ge >= vmax[us_f]) & (ge >= vmax[vs_f])
                masked_idx = torch.where(cand, idx, p)
                vmin = torch.full((b_ * n,), p, dtype=torch.long,
                                  device=dev)
                vmin.scatter_reduce_(0, us_f.reshape(-1),
                                     masked_idx.reshape(-1), "amin")
                vmin.scatter_reduce_(0, vs_f.reshape(-1),
                                     masked_idx.reshape(-1), "amin")
                new = cand & (vmin[us_f] == idx) & (vmin[vs_f] == idx)
                scatter_true(used, new, us_f)
                scatter_true(used, new, vs_f)
                sel |= new
                elig = pos & ~used[us_f] & ~used[vs_f]
                live = torch.any(elig & ~sel, dim=1)
                if not boundary.read(torch.any(live)):
                    elig = None

            # ---- apply the matching (each vertex in ≤ 1 selected pair;
            # without a positive pair it is empty and never taken)
            perm_f0 = perm.reshape(-1)
            if any_pos_h.any():
                pu, pv = perm_f0[us_f], perm_f0[vs_f]
                perm_m = torch.cat([perm_f0, perm_f0.new_zeros(1)])
                perm_m[torch.where(sel, us_f, oob)] = pv
                perm_m[torch.where(sel, vs_f, oob)] = pu
                perm_m = perm_m[:b_ * n].view(b_, n)
                j_m = objective(perm_m)         # swaps of a matching
                take = any_pos & (j_m < j - gbest)      # interact: verify
            else:
                perm_m, j_m = perm, j
                take = torch.zeros_like(any_pos)

            # ---- fallback: the single best pair, exact incremental gain
            ub = us_f.gather(1, best[:, None]).squeeze(1)
            vb = vs_f.gather(1, best[:, None]).squeeze(1)
            perm_f = perm_f0.clone()
            perm_f.index_copy_(0, ub, perm_f0.index_select(0, vb))
            perm_f.index_copy_(0, vb, perm_f0.index_select(0, ub))
            perm_f = perm_f.view(b_, n)
            fall = (any_pos & ~take) | fall_down

            perm_n = torch.where(take[:, None], perm_m,
                                 torch.where(fall[:, None], perm_f, perm))
            j_n = torch.where(take, j_m, torch.where(fall, j - gbest, j))
            exch = torch.where(take, sel.sum(dim=1, dtype=torch.int32),
                               fall.to(torch.int32))
            swaps = swaps + exch
            sweeps_n = sweeps_d + moved.to(torch.int32)
            at_sweep(trace, sweeps_n, j_n, act)

            # ---- tabu memory: applied pairs reject their reversal
            applied = torch.where(take[:, None], sel,
                                  (idx == best[:, None]) & fall[:, None])
            if tabu_on:
                tabu_until = torch.where(
                    applied, sweeps_n[:, None] + int(tenure), tabu_until)

            # ---- don't-look bits (selection-level masking only; the
            # reference updates them even with dlb off, where they are
            # never read)
            if dlb:
                pos_raw = (g > eps_c).to(torch.int32).reshape(-1)
                warm = torch.zeros(b_ * n, dtype=torch.int32, device=dev)
                warm.scatter_reduce_(0, us_f.reshape(-1), pos_raw, "amax")
                warm.scatter_reduce_(0, vs_f.reshape(-1), pos_raw, "amax")
                moved_v = torch.zeros(b_ * n + 1, dtype=torch.bool,
                                      device=dev)
                scatter_true(moved_v, applied, us_f)
                scatter_true(moved_v, applied, vs_f)
                moved_v = moved_v[:b_ * n]
                nbr_f = nbr.long() + base[:, :, None]
                wake = moved_v.view(b_, n) | torch.any(
                    moved_v[nbr_f] & (wgt > 0), dim=2)
                cold_n = torch.where(wake, False,
                                     cold | ~(warm.view(b_, n) > 0))
                cold = torch.where(act[:, None], cold_n, cold)

            # ---- telemetry (never read by the search)
            if collect:
                at_sweep(tel["exchanges"], sweeps_d, exch, act)
                if tabu_on:
                    at_sweep(tel["tabu_masked"], sweeps_d, torch.sum(
                        tabu_active & ~aspire, dim=1, dtype=torch.int32),
                        act)
                    at_sweep(tel["aspirations"], sweeps_d, torch.sum(
                        tabu_active & aspire, dim=1, dtype=torch.int32),
                        act)
                at_sweep(tel["match_rounds"], sweeps_d, rounds, act)
                downhill += fall_down_h
                passes += act_h

            # ---- best-seen tracking (with tabu off, j is monotone)
            improved = j_n < best_j
            best_perm = torch.where(improved[:, None], perm_n, best_perm)
            best_j = torch.where(improved, j_n, best_j)
            perm, j = perm_n, j_n
            done_d, sweeps_d = advance(done_d, sweeps_d, act, moved)
            done, sweeps = advance(done, sweeps, act_h, moved_h)
        tel_out = dict(tel)
        tel_out.update(downhill_escapes=downhill, passes=passes,
                       sweeps=sweeps)
        return best_perm, trace, sweeps, swaps, tel_out

    return refine_fn


class RefinementEngine:
    """The sweep loop for one machine topology on one device.

    One instance per (``kernel_params()``, ``max_sweeps``,
    ``kernel_config``, device) — the Mapper keys its engine pool so.
    ``device`` is ``"cuda"`` unless the caller asks for ``"cpu"``: on
    CUDA the gains and objectives go through the hand-written kernels,
    on the CPU through their plain versions.  ``kernel_config`` (a
    :class:`~repro_torch.kernels.config.KernelConfig`, normally derived
    at ``Mapper.lower`` time) fixes the plain versions' tile geometry
    and, for matrix-form topologies with a ``dist_dtype``, stores the
    distance table in its lossless int8/int16 packing — results
    bit-identical, gathers 2–4× narrower.
    """

    def __init__(self, topology, max_sweeps: int = 64,
                 eps_rel: float = _EPS_REL, cache_caps: dict | None = None,
                 kernel_config=None, device=None):
        import torch
        self.device = resolve_device(device)
        kp = topology.kernel_params()
        self.topology = topology
        self.kind = kp[0]
        self.max_sweeps = int(max_sweeps)
        self.eps_rel = float(eps_rel)
        self.kernel_config = kernel_config
        if self.kind == "matrix":
            params = ()
            dist_dtype = getattr(kernel_config, "dist_dtype", None)
            if dist_dtype is not None:
                from ..kernels.config import quantize_table
                packed, _ = quantize_table(topology.matrix(), dist_dtype)
                table = torch.from_numpy(np.ascontiguousarray(packed))
            else:
                table = torch.from_numpy(
                    np.asarray(topology.matrix(), dtype=np.float32))
            self._D = table.to(self.device)
        else:
            params = kp[1:]
            self._D = torch.zeros((1, 1), dtype=torch.float32,
                                  device=self.device)    # ignored dummy
        self.params = params
        self._refine = _make_refine(self.kind, params, self.max_sweeps,
                                    config=kernel_config)
        # internal LRU caps: session-level `cache_caps` plumbing (Mapper
        # passes {"graphs": ..., "pairs": ...}); evictions surface in
        # cache_info()
        self._caps = {"graphs": 16, "pairs": 16}
        if cache_caps:
            unknown = sorted(set(cache_caps) - set(self._caps))
            if unknown:
                raise ValueError(f"unknown engine cache_caps keys "
                                 f"{unknown}; known: "
                                 f"{sorted(self._caps)}")
            self._caps.update({k: int(v) for k, v in cache_caps.items()})
        self._evictions = {"graphs": 0, "pairs": 0}
        # device uploads keyed by full array content (LRU): graph ELL/edge
        # arrays and candidate-pair arrays — the pair tensors alone reach
        # ~15 MB at n = 4096, so neither re-transfers per request
        self._dg_cache: "OrderedDict[tuple, DeviceGraph]" = OrderedDict()
        self._pair_cache: "OrderedDict[tuple, tuple]" = OrderedDict()
        # bucketed pair-length high-water marks, one per bucket shape:
        # under a ShapeBucket with dynamic P, never shrink the padded
        # pair shape below one already used for that (K, E), so mixed
        # candidate sets keep one set of shapes (inert padding)
        self._p_hwm: dict = {}
        # host syncs of the last refine: readbacks made through the
        # boundary, and (CUDA) syncs PyTorch reported inside it
        self.last_syncs: dict = {}

    # ------------------------------------------------------------- host glue
    def _lru_get(self, cache: OrderedDict, key: tuple, build, cap: str):
        """Bounded fetch-or-build against ``self._caps[cap]``; drops
        surface as ``cache_info()[f"{cap[:-1]}_evictions"]``."""
        val = cache.get(key)
        if val is None:
            val = build()
            cache[key] = val
            if len(cache) > self._caps[cap]:
                cache.popitem(last=False)
                self._evictions[cap] += 1
        else:
            cache.move_to_end(key)
        return val

    def cache_info(self) -> dict:
        """Device-upload cache accounting: live entry counts plus the
        evictions forced by the ``cache_caps`` bounds."""
        return {
            "graph_entries": len(self._dg_cache),
            "graph_evictions": self._evictions["graphs"],
            "pair_entries": len(self._pair_cache),
            "pair_evictions": self._evictions["pairs"],
        }

    def trace_count(self) -> int:
        """Compiled-executable traces: always 0 — the port runs eagerly,
        so toggling ``tabu_tenure``/``dlb``/``telemetry`` builds
        nothing (kept for ``describe()`` parity with the JAX engine)."""
        return 0

    def _device_graph(self, g: CommGraph, k: int | None = None,
                      e: int | None = None) -> DeviceGraph:
        """Cached device upload of a graph, optionally re-padded into a
        plan bucket's (K, E) — padding is inert, so only the shapes
        change, never the result."""
        key = (g.n, hash(g.xadj.tobytes()), hash(g.adjncy.tobytes()),
               hash(np.asarray(g.adjwgt).tobytes()), k, e)

        def build():
            with host_boundary("engine.upload"):
                dg = DeviceGraph.from_comm(g, device=self.device)
            if k is not None or e is not None:
                dg = dg.pad_to(k if k is not None else dg.max_deg,
                               e if e is not None else dg.eu.shape[0])
            return dg

        return self._lru_get(self._dg_cache, key, build, "graphs")

    def _device_pairs(self, pairs: np.ndarray, pad_to: int = 128) -> tuple:
        pairs = np.asarray(pairs)
        key = (pad_to, pairs.shape[0], hash(pairs.tobytes()))

        def build():
            with host_boundary("engine.upload"):
                return device_pairs(pairs, pad_to=pad_to, device=self.device)

        return self._lru_get(self._pair_cache, key, build, "pairs")

    def _bucket_p(self, bucket, n_pairs: int) -> int:
        key = (bucket.max_deg, bucket.num_edges, bucket.num_pairs,
               bucket.schedule)
        p = max(bucket.pair_pad(n_pairs), self._p_hwm.get(key, 0))
        self._p_hwm[key] = p
        return p

    def _eps(self, j0: float) -> float:
        """The acceptance threshold, rounded to float32 as the device
        compares in float32."""
        return float(np.float32(self.eps_rel * max(1.0, abs(j0))))

    def _stats(self, g: CommGraph, perm: np.ndarray, j0: float,
               trace: np.ndarray, sweeps: int, swaps: int,
               n_pairs: int, telemetry=None) -> SearchStats:
        stats = SearchStats()
        stats.initial_objective = j0
        stats.final_objective = qap_objective(g, self.topology, perm)
        stats.swaps = int(swaps)
        # gain passes actually run: one per applied sweep, plus the final
        # pass that found no positive gain when the loop converged before
        # the budget
        passes = int(sweeps) + (1 if int(sweeps) < self.max_sweeps else 0)
        stats.evaluated = passes * n_pairs
        stats.objective_trace = [float(x) for x in trace[:int(sweeps) + 1]]
        if telemetry is not None:
            from ..obs.telemetry import EngineTelemetry
            stats.telemetry = EngineTelemetry.from_device(telemetry, trace)
        return stats

    @staticmethod
    def _unmoved(j0: float, telemetry: bool) -> SearchStats:
        stats = SearchStats()
        stats.initial_objective = stats.final_objective = j0
        stats.objective_trace = [j0]
        if telemetry:
            from ..obs.telemetry import EngineTelemetry
            stats.telemetry = EngineTelemetry(
                objective_trace=np.asarray([j0]))
        return stats

    # ------------------------------------------------------------------ API
    def refine(self, g: CommGraph, perm: np.ndarray, pairs: np.ndarray,
               j0: float | None = None, bucket=None,
               tabu_tenure: int = 0, dlb: bool = False,
               telemetry: bool = False) -> SearchStats:
        """Refine ``perm`` in place over the candidate ``pairs`` on the
        engine's device.  ``j0`` is the caller's already-computed
        objective of ``perm`` (used for eps scaling and the reported
        initial objective); omitted, it is recomputed on host.
        ``bucket`` (a :class:`~repro_torch.core.spec.ShapeBucket`) pads
        the device tensors to the plan's fixed shapes — inert, results
        unchanged.  ``tabu_tenure``/``dlb`` enable the tabu memory and
        don't-look bits; ``telemetry`` attaches an
        :class:`~repro_torch.obs.telemetry.EngineTelemetry` to the
        stats.  The host syncs the loop made are left in
        ``self.last_syncs``.  It is :meth:`refine_batch` of one graph."""
        return self.refine_batch([g], [perm], [pairs],
                                 j0s=None if j0 is None else [j0],
                                 bucket=bucket, tabu_tenure=tabu_tenure,
                                 dlb=dlb, telemetry=telemetry)[0]

    def refine_batch(self, graphs, perms, pairs_list, j0s=None,
                     bucket=None, tabu_tenure: int = 0, dlb: bool = False,
                     telemetry: bool = False) -> list[SearchStats]:
        """Refine a batch of graphs over one machine in ONE sweep loop:
        every sweep is one K2 launch and at most one K1 launch for the
        whole batch, one counted readback of the (B,) best gains, and one
        counted flag per matching round (``self.last_syncs`` then holds
        the batch's counts, and ``sweeps``/``passes`` per lane).

        Per-graph tensors are padded to the batch's common (K, E, P)
        maxima — or, given a ``bucket``, to the plan's fixed shapes —
        inert by the DeviceGraph/pair padding invariants, so each result
        matches the corresponding single :meth:`refine`.  Each ``perm``
        is refined in place.  ``j0s`` are the callers' already-computed
        initial objectives (recomputed on host when omitted).  With no
        candidate pair in any lane nothing can move: no loop runs, and
        each lane reports its j0."""
        import torch
        graphs = list(graphs)
        if not graphs:
            return []
        if j0s is None:
            j0s = [qap_objective(g, self.topology, p)
                   for g, p in zip(graphs, perms)]
        if not any(len(p) for p in pairs_list):
            self._no_loop(len(graphs))
            return [self._unmoved(j0, telemetry) for j0 in j0s]
        p_raw = max(max((len(p) for p in pairs_list), default=1), 1)
        if bucket is not None:
            k_max, e_max = bucket.max_deg, bucket.num_edges
            p_max = self._bucket_p(bucket, p_raw)
            dgs = [self._device_graph(g, k=k_max, e=e_max) for g in graphs]
        else:
            dgs = [self._device_graph(g) for g in graphs]
            k_max = max(dg.max_deg for dg in dgs)
            e_max = max(dg.eu.shape[0] for dg in dgs)
            p_max = -(-p_raw // 128) * 128      # same bucketing as refine()
            dgs = [dg if (dg.max_deg, dg.eu.shape[0]) == (k_max, e_max)
                   else dg.pad_to(k_max, e_max) for dg in dgs]
        dev_pairs = [self._device_pairs(p, pad_to=p_max)
                     for p in pairs_list]

        def stack(tensors):
            return tensors[0][None] if len(tensors) == 1 \
                else torch.stack(tensors)

        return self._sweep(
            graphs, perms, [len(p) for p in pairs_list], j0s,
            (stack([dg.nbr for dg in dgs]), stack([dg.wgt for dg in dgs]),
             stack([dg.eu for dg in dgs]), stack([dg.ev for dg in dgs]),
             stack([dg.ew for dg in dgs]),
             stack([u for u, _ in dev_pairs]),
             stack([v for _, v in dev_pairs])),
            tabu_tenure, dlb, telemetry)

    def refine_lanes(self, g: CommGraph, perms, pairs: np.ndarray,
                     j0s=None, bucket=None, tabu_tenure: int = 0,
                     dlb: bool = False,
                     telemetry: bool = False) -> list[SearchStats]:
        """Refine L restart *lanes* of ONE graph in one sweep loop — the
        portfolio's counterpart of :meth:`refine_batch`: the graph and
        candidate-pair tensors are uploaded once and passed without a
        lane axis, so K1 and K2 read them for every lane and no lane
        copy is made (the JAX package's ``in_axes=None``); only the
        permutations and eps thresholds carry a lane axis.  Each lane's
        result equals a single :meth:`refine` of that lane's
        permutation, and ``self.last_syncs`` counts the loop's reads as
        :meth:`refine_batch` does.  Each ``perm`` is refined in place.
        With no candidate pair nothing moves: each lane reports its j0
        (without telemetry, as the JAX package's ``refine_lanes``)."""
        perms = list(perms)
        if not perms:
            return []
        if j0s is None:
            j0s = [qap_objective(g, self.topology, p) for p in perms]
        if len(pairs) == 0:
            self._no_loop(len(perms))
            return [self._unmoved(j0, False) for j0 in j0s]
        dg, us, vs = self.shared_inputs(g, pairs, bucket)
        return self._sweep([g] * len(perms), perms, [len(pairs)] * len(perms),
                           j0s, (dg.nbr, dg.wgt, dg.eu, dg.ev, dg.ew, us, vs),
                           tabu_tenure, dlb, telemetry)

    def shared_inputs(self, g: CommGraph, pairs: np.ndarray,
                      bucket=None) -> tuple:
        """The cached device graph and pair tensors of one graph, padded
        as a single :meth:`refine` pads them (into ``bucket`` when one is
        given): ``(DeviceGraph, us, vs)``."""
        if bucket is not None:
            dg = self._device_graph(g, k=bucket.max_deg, e=bucket.num_edges)
            p_max = self._bucket_p(bucket, max(len(pairs), 1))
        else:
            dg = self._device_graph(g)
            p_max = -(-max(len(pairs), 1) // 128) * 128
        return (dg, *self._device_pairs(pairs, pad_to=p_max))

    def _no_loop(self, lanes: int) -> None:
        self.last_syncs = {"sweeps": 0, "passes": 0,
                           "lane_sweeps": [0] * lanes, "reads": 0,
                           "observed": None}

    def _sweep(self, graphs, perms, n_pairs, j0s, tensors, tabu_tenure,
               dlb, telemetry) -> list[SearchStats]:
        """Run the sweep loop over ``tensors`` (nbr, wgt, eu, ev, ew, us,
        vs: stacked lanes or one shared graph) from ``perms``, write the
        results into ``perms`` and report each lane's stats against its
        graph; the loop's syncs go to ``self.last_syncs``."""
        import torch
        with host_boundary("engine.upload"):
            perm0 = torch.from_numpy(np.stack(
                [np.asarray(p, dtype=np.int32) for p in perms])).to(
                    self.device)
        with host_boundary("engine.sweeps", self.device) as hb:
            out_perm, trace, sweeps, swaps, tel = self._refine(
                *tensors, perm0, self._D, [self._eps(j) for j in j0s],
                tabu_tenure, dlb, telemetry, hb)
        with host_boundary("engine.readback") as rb:
            perm_h = rb.read(out_perm)
            trace_h = rb.read(trace)
            swaps_h = rb.read(swaps)
            tel_h = {k: (rb.read(v) if isinstance(v, torch.Tensor)
                         else v) for k, v in tel.items()}
        passes = sweeps + (sweeps < self.max_sweeps)
        self.last_syncs = {"sweeps": int(sweeps.max()),
                           "passes": int(passes.max()),
                           "lane_sweeps": sweeps.tolist(),
                           "reads": hb.reads, "observed": hb.syncs}
        out = []
        for i, (g, perm) in enumerate(zip(graphs, perms)):
            perm[:] = perm_h[i].astype(perm.dtype)
            out.append(self._stats(
                g, perm, j0s[i], trace_h[i], int(sweeps[i]),
                int(swaps_h[i]), n_pairs[i],
                telemetry={k: v[i] for k, v in tel_h.items()}
                if telemetry else None))
        return out
