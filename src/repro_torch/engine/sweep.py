"""The eager sweep loop and its session wrapper (see package docstring).

``_make_refine`` builds the sweep function — a loop from initial
permutation to converged permutation — for one distance form;
:class:`RefinementEngine` wraps it with host glue: DeviceGraph/pair
uploads (cached per graph structure), eps selection, and
:class:`SearchStats` reporting against host float64 objectives.
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
    """The sweep fn for one distance form.

    Signature: ``(nbr, wgt, eu, ev, ew, us, vs, perm0, D, eps, tenure,
    dlb, collect, boundary) -> (perm, trace, sweeps, swaps, tel)``.  The
    tensors live on one device; ``tenure``/``dlb``/``collect`` are host
    values; ``boundary`` is the :class:`~repro_torch.runtime.Boundary`
    every deliberate readback goes through.  The trace is the carried
    float32 objective after each sweep (NaN past convergence).

    It is the JAX package's ``lax.while_loop`` run eagerly, step for
    step: every sweep computes the gains of all candidate pairs (K2 on
    CUDA), masks tabu / don't-look pairs, builds a greedy maximal
    matching of positive pairs by rounds of locally dominant pairs,
    applies it when the recomputed objective (K1 on CUDA) beats the best
    single swap, else falls back to that swap, and keeps the best
    permutation seen.  See the JAX package's ``engine/sweep.py`` for the
    tabu, aspiration, don't-look and telemetry semantics, which are the
    same here.

    Host syncs: the reference never leaves its device loop; this loop
    reads back one scalar per sweep (the best masked gain, which decides
    whether the sweep moves and whether the matching runs) and one flag
    per matching round (whether an eligible pair is left).  A sweep with
    ``r`` matching rounds therefore costs ``1 + r`` syncs; the counts
    are in ``boundary.reads``.  Everything else stays on the device.
    Out-of-range scatters (the reference's ``mode="drop"`` index ``n``)
    land in a scratch slot ``n`` of (n+1)-long buffers.
    """
    import torch

    from ..kernels import pair_gain as pg

    neg_inf = float("-inf")

    def refine_fn(nbr, wgt, eu, ev, ew, us, vs, perm0, D, eps, tenure,
                  dlb, collect, boundary):
        dev = perm0.device
        n = perm0.shape[0]
        p = us.shape[0]
        us_l, vs_l = us.long(), vs.long()
        idx = torch.arange(p, device=dev)
        oob = torch.full((p,), n, dtype=torch.long, device=dev)
        tabu_on = int(tenure) > 0
        eps_h = float(eps)                   # eps is float32-exact already
        # fills, not host tensors: a pageable H2D copy would sync
        eps_t = torch.full((), eps_h, dtype=torch.float32, device=dev)
        true_t = torch.ones((), dtype=torch.bool, device=dev)

        def objective(perm):
            return pg.edge_objective(kind, params, eu, ev, ew, perm, D,
                                     config=config)

        def scatter_true(buf, where_, index):
            buf.index_put_((torch.where(where_, index, oob),), true_t)

        j0 = objective(perm0)
        trace = torch.full((max_sweeps + 1,), float("nan"),
                           dtype=torch.float32, device=dev)
        trace[0] = j0
        perm, j = perm0, j0
        best_perm, best_j = perm0, j0
        swaps = torch.zeros((), dtype=torch.int32, device=dev)
        tabu_until = torch.zeros(p, dtype=torch.int32, device=dev)
        cold = torch.zeros(n, dtype=torch.bool, device=dev)
        tel = {key: torch.zeros(max_sweeps + 1, dtype=torch.int32,
                                device=dev)
               for key in ("exchanges", "tabu_masked", "aspirations")}
        match_rounds = np.zeros(max_sweeps + 1, np.int32)
        downhill = passes = 0
        sweeps = 0
        while sweeps < max_sweeps:
            g = pg.pair_gains(kind, params, nbr, wgt, perm, us, vs, D,
                              config=config)
            # ---- tabu / don't-look masking (identity when both are off)
            blocked = None
            if tabu_on:
                aspire = (j - g) < best_j - eps_t
                tabu_active = tabu_until > sweeps
                blocked = (tabu_active & ~aspire) | (us == vs)
            if dlb:
                cold_pair = cold[us_l] & cold[vs_l]
                blocked = cold_pair if blocked is None else blocked | cold_pair
            g_m = g if blocked is None else torch.where(blocked, neg_inf, g)
            best = torch.argmax(g_m).reshape(1)     # first max, like jnp
            gbest = g_m.index_select(0, best).reshape(())
            gbest_h = boundary.read(gbest)          # sync 1 of the sweep
            any_pos = gbest_h > eps_h
            fall_down = tabu_on and not any_pos and gbest_h > neg_inf
            moved = any_pos or fall_down

            # ---- greedy maximal matching by gain priority (rounds of
            # locally-dominant positive pairs; with no positive pair the
            # reference's first round condition is already false)
            pos = g_m > eps_t
            sel = torch.zeros(p, dtype=torch.bool, device=dev)
            used = torch.zeros(n + 1, dtype=torch.bool, device=dev)
            rounds = 0
            elig = pos if any_pos else None
            while elig is not None:
                ge = torch.where(elig, g_m, neg_inf)
                vmax = torch.full((n,), neg_inf, dtype=torch.float32,
                                  device=dev)
                vmax.scatter_reduce_(0, us_l, ge, "amax")
                vmax.scatter_reduce_(0, vs_l, ge, "amax")
                cand = elig & (ge >= vmax[us_l]) & (ge >= vmax[vs_l])
                masked_idx = torch.where(cand, idx, p)
                vmin = torch.full((n,), p, dtype=torch.long, device=dev)
                vmin.scatter_reduce_(0, us_l, masked_idx, "amin")
                vmin.scatter_reduce_(0, vs_l, masked_idx, "amin")
                new = cand & (vmin[us_l] == idx) & (vmin[vs_l] == idx)
                scatter_true(used, new, us_l)
                scatter_true(used, new, vs_l)
                sel |= new
                rounds += 1
                elig = pos & ~used[us_l] & ~used[vs_l]
                if not boundary.read(torch.any(elig & ~sel)):
                    elig = None

            # ---- apply the matching (each vertex in ≤ 1 selected pair;
            # without a positive pair it is empty and never taken)
            if any_pos:
                pu, pv = perm[us_l], perm[vs_l]
                perm_m = torch.cat([perm, perm.new_zeros(1)])
                perm_m[torch.where(sel, us_l, oob)] = pv
                perm_m[torch.where(sel, vs_l, oob)] = pu
                perm_m = perm_m[:n]
                j_m = objective(perm_m)         # swaps of a matching
                take = j_m < j - gbest          # interact: verify
            else:
                perm_m, j_m = perm, j
                take = torch.zeros((), dtype=torch.bool, device=dev)

            # ---- fallback: the single best pair, exact incremental gain
            ub, vb = us_l.index_select(0, best), vs_l.index_select(0, best)
            perm_f = perm.clone()
            perm_f.index_copy_(0, ub, perm.index_select(0, vb))
            perm_f.index_copy_(0, vb, perm.index_select(0, ub))
            fall = ~take if any_pos else torch.full(
                (), fall_down, dtype=torch.bool, device=dev)

            perm_n = torch.where(take, perm_m, torch.where(fall, perm_f, perm))
            j_n = torch.where(take, j_m, torch.where(fall, j - gbest, j))
            exch = torch.where(take, sel.sum(dtype=torch.int32),
                               fall.to(torch.int32))
            swaps = swaps + exch
            sweeps_n = sweeps + 1 if moved else sweeps
            trace[sweeps_n] = j_n

            # ---- tabu memory: applied pairs reject their reversal
            applied = torch.where(take, sel, (idx == best) & fall)
            if tabu_on:
                tabu_until = torch.where(applied, sweeps_n + int(tenure),
                                         tabu_until)

            # ---- don't-look bits (selection-level masking only; the
            # reference updates them even with dlb off, where they are
            # never read)
            if dlb:
                pos_raw = (g > eps_t).to(torch.int32)
                warm = torch.zeros(n, dtype=torch.int32, device=dev)
                warm.scatter_reduce_(0, us_l, pos_raw, "amax")
                warm.scatter_reduce_(0, vs_l, pos_raw, "amax")
                moved_v = torch.zeros(n + 1, dtype=torch.bool, device=dev)
                scatter_true(moved_v, applied, us_l)
                scatter_true(moved_v, applied, vs_l)
                moved_v = moved_v[:n]
                wake = moved_v | torch.any(moved_v[nbr.long()] & (wgt > 0),
                                           dim=1)
                cold = torch.where(wake, False, cold | ~(warm > 0))

            # ---- telemetry (never read by the search)
            if collect:
                tel["exchanges"][sweeps] = exch
                if tabu_on:
                    tel["tabu_masked"][sweeps] = torch.sum(
                        tabu_active & ~aspire, dtype=torch.int32)
                    tel["aspirations"][sweeps] = torch.sum(
                        tabu_active & aspire, dtype=torch.int32)
                match_rounds[sweeps] = rounds
                downhill += int(fall_down)
                passes += 1

            # ---- best-seen tracking (with tabu off, j is monotone)
            improved = j_n < best_j
            best_perm = torch.where(improved, perm_n, best_perm)
            best_j = torch.where(improved, j_n, best_j)
            perm, j, sweeps = perm_n, j_n, sweeps_n
            if not moved:
                break
        tel_out = dict(tel)
        tel_out.update(match_rounds=match_rounds, downhill_escapes=downhill,
                       passes=passes, sweeps=sweeps)
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
            dg = DeviceGraph.from_comm(g, device=self.device)
            if k is not None or e is not None:
                dg = dg.pad_to(k if k is not None else dg.max_deg,
                               e if e is not None else dg.eu.shape[0])
            return dg

        return self._lru_get(self._dg_cache, key, build, "graphs")

    def _device_pairs(self, pairs: np.ndarray, pad_to: int = 128) -> tuple:
        pairs = np.asarray(pairs)
        key = (pad_to, pairs.shape[0], hash(pairs.tobytes()))
        return self._lru_get(
            self._pair_cache, key,
            lambda: device_pairs(pairs, pad_to=pad_to, device=self.device),
            "pairs")

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
        ``self.last_syncs``."""
        import torch
        if j0 is None:
            j0 = qap_objective(g, self.topology, perm)
        if len(pairs) == 0:
            stats = SearchStats()
            stats.initial_objective = stats.final_objective = j0
            stats.objective_trace = [j0]
            if telemetry:
                from ..obs.telemetry import EngineTelemetry
                stats.telemetry = EngineTelemetry(
                    objective_trace=np.asarray([j0]))
            return stats
        if bucket is not None:
            dg = self._device_graph(g, k=bucket.max_deg,
                                    e=bucket.num_edges)
            us, vs = self._device_pairs(pairs,
                                        pad_to=self._bucket_p(
                                            bucket, len(pairs)))
        else:
            dg = self._device_graph(g)
            us, vs = self._device_pairs(pairs)
        perm0 = torch.from_numpy(np.asarray(perm, dtype=np.int32)).to(
            self.device)
        with host_boundary("engine.sweeps", self.device) as hb:
            out_perm, trace, sweeps, swaps, tel = self._refine(
                dg.nbr, dg.wgt, dg.eu, dg.ev, dg.ew, us, vs, perm0,
                self._D, self._eps(j0), tabu_tenure, dlb, telemetry, hb)
        with host_boundary("engine.readback"):
            perm[:] = out_perm.cpu().numpy().astype(perm.dtype)
            trace_h = trace.cpu().numpy()
            swaps_h = int(swaps.cpu())
            tel_h = {k: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                         else v) for k, v in tel.items()}
        passes = sweeps + (1 if sweeps < self.max_sweeps else 0)
        self.last_syncs = {"sweeps": sweeps, "passes": passes,
                           "reads": hb.reads, "observed": hb.syncs}
        return self._stats(g, perm, j0, trace_h, sweeps, swaps_h,
                           len(pairs), telemetry=tel_h if telemetry
                           else None)

