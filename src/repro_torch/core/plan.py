"""`MappingPlan` — the lowered artifact between ``Mapper.lower()`` and the
``execute()`` hot path, on one device.

The guide's workflow is "build the machine model once, map many
communication graphs against it"; the staged API makes that split
explicit:

    plan = mapper.lower(ShapeBucket.of(g))      # resolve + bind kernels
    result = plan.execute(g)                    # hot path: pad + run
    results = plan.execute_batch(graphs)        # one batched sweep loop
    result = plan.execute_warm(g, perm, active=mask)   # warm-start remap

``lower`` resolves everything that does not depend on the individual
graph — the construction/neighborhood registry handles, the partition
config, the multilevel machine pyramid and its coarse machines, one
:class:`~repro_torch.engine.RefinementEngine` per level, the kernel
configuration of each level, and the objective kernel for the
``pallas`` backend (in this port: the hand-written CUDA objective, K1)
— so ``execute`` pads the graph into the plan's
:class:`~repro_torch.core.spec.ShapeBucket` (inert by the DeviceGraph
padding invariants) and runs the pipeline.  The seed is a runtime input
(``execute(g, seed=)``).

This is the port of the JAX package's ``core/plan.py``: the flat
pipeline on both engines (``device``: the refinement engine; ``host``:
the numpy search drivers of :mod:`.local_search`), the multilevel
V-cycle (:mod:`repro_torch.multilevel`), batches (``execute_batch``:
every level's refinement is one batched engine call), warm starts
(``execute_warm``) and the dense gain matrix (``gain_matrix``: K3 on the
``pallas`` backend).  Lowering a spec with a portfolio block raises
``NotImplementedError`` naming its ROADMAP item.

A plan is portable: ``to_json()``/``save()`` serialize its
:class:`~repro_torch.core.spec.PlanSpec` (spec + machine model +
bucket) in the JAX package's format, and ``from_json()``/``load()``/
pickle rebuild the live plan on a chosen device, reproducing the
original mappings.  ``describe()`` reports what was lowered without
executing anything.
"""

from __future__ import annotations

import json
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np

from ..obs import get_tracer
from ..runtime.boundary import host_boundary
from ..runtime.device import resolve_device
from .construction import resolve_construction
from .graph import CommGraph
from .local_search import (SearchStats, _cyclic_search,
                           parallel_sweep_search, resolve_neighborhood)
from .objective import dense_gain_matrix, qap_objective
from .partition import PartitionConfig
from .spec import MappingSpec, PlanSpec, ShapeBucket, TopologySpec

_TR = get_tracer()


@dataclass
class MappingResult:
    perm: np.ndarray
    initial_objective: float
    final_objective: float
    construction_seconds: float
    search_seconds: float
    search_stats: SearchStats | None

    @property
    def improvement(self) -> float:
        if self.initial_objective == 0:
            return 0.0
        return 1.0 - self.final_objective / self.initial_objective


# device-engine sweep budget per preconfiguration when the spec leaves
# max_sweeps=None (eco keeps the engine's historical default of 64)
_PRECONF_SWEEPS = {"fast": 32, "eco": 64, "strong": 128}


def sweep_budget(spec: MappingSpec) -> int:
    """Device-engine sweep budget: the spec's explicit ``max_sweeps``,
    else the preconfiguration's (fast 32, eco 64, strong 128)."""
    if spec.max_sweeps is not None:
        return spec.max_sweeps
    return _PRECONF_SWEEPS.get(spec.preconfiguration, 64)


class _LRU:
    """Bounded LRU mapping with visible accounting: ``builds`` counts
    misses, ``hits`` counts reuses, ``evictions`` counts entries dropped
    at the cap — surfaced through ``cache_info()``."""

    def __init__(self, cap: int, on_evict=None):
        self.cap = int(cap)
        self.builds = 0
        self.hits = 0
        self.evictions = 0
        self._on_evict = on_evict
        self._data: OrderedDict = OrderedDict()

    def __len__(self) -> int:
        return len(self._data)

    def values(self):
        return self._data.values()

    def items(self):
        return self._data.items()

    def clear(self):
        self._data.clear()

    def get_or_build(self, key, build):
        val = self._data.get(key)
        if val is not None:
            self._data.move_to_end(key)
            self.hits += 1
            return val
        val = build()
        self.builds += 1
        self._data[key] = val
        while len(self._data) > self.cap:
            _, dropped = self._data.popitem(last=False)
            self.evictions += 1
            if self._on_evict is not None:
                self._on_evict(dropped)
        return val


def _structure_key(g: CommGraph, with_weights: bool = False) -> tuple:
    """Adjacency-structure fingerprint; weights are included only for
    neighborhoods that declare ``weight_dependent``."""
    key = (g.n, int(g.xadj[-1]), hash(g.xadj.tobytes()),
           hash(g.adjncy.tobytes()))
    if with_weights:
        key += (hash(np.asarray(g.adjwgt).tobytes()),)
    return key


def build_objective_kernel(topology, config=None, device=None):
    """The edge-list QAP objective for the topology's distance form, bound
    to ``device``: ``fn(eu, ev, ew, perm) -> 0-d float32 tensor`` over
    padded int32/float32 device tensors.  On CUDA it launches the K1
    kernel, on the CPU its plain version.  ``config`` (a
    :class:`~repro_torch.kernels.config.KernelConfig`) stores a matrix
    table in its lossless int8/int16 packing — bit-identical
    objectives, narrower gathers."""
    import functools

    import torch

    from ..kernels.qap_objective import qap_objective_edges
    dev = resolve_device(device)
    kp = topology.kernel_params()
    kind = kp[0]
    if kind in ("tree", "torus"):
        params = kp[1:]
        D = torch.zeros((1, 1), dtype=torch.float32, device=dev)
    elif kind == "matrix":
        params = ()
        dist_dtype = getattr(config, "dist_dtype", None)
        if dist_dtype is not None:
            from ..kernels.config import quantize_table
            table = np.ascontiguousarray(
                quantize_table(topology.matrix(), dist_dtype)[0])
        else:
            table = np.asarray(topology.matrix(), dtype=np.float32)
        D = torch.from_numpy(table).to(dev)
    else:
        raise ValueError(f"unknown kernel_params kind {kind!r}")
    return functools.partial(qap_objective_edges, kind, params, D=D)


def build_swap_gain_kernel(topology, device=None):
    """The dense gain matrix for the topology, bound to ``device``:
    ``fn(g, perm) -> (n, n) float32 tensor``.  D is uploaded once, as
    float32; C is scattered and B = D[perm][:, perm] gathered on the
    device per call.  On CUDA it launches the K3 kernel, on the CPU its
    plain version."""
    import torch

    from ..kernels.ops import comm_matrix, permuted_distances
    from ..kernels.swap_gain import swap_gain_matrix
    dev = resolve_device(device)
    D = torch.from_numpy(np.asarray(topology.matrix(),
                                    dtype=np.float32)).to(dev)

    def gain_matrix(g: CommGraph, perm: np.ndarray):
        return swap_gain_matrix(comm_matrix(g, dev),
                                permuted_distances(D, perm))
    return gain_matrix


def read_back(G) -> np.ndarray:
    """G as a float32 numpy array that the caller owns.  A CUDA tensor is
    copied into a page-locked block of the port's own pool
    (``core/pinned.py``) and the array is a view of it, which keeps it
    pinned; a pageable ``.cpu()`` copy runs at a fraction of the link's
    rate.  A CPU tensor is returned as its own view.

    When the caller drops the array the block goes back to the pool,
    which keeps one free block of each size for the next call and frees
    the rest: a warm call whose earlier result was dropped pays no
    ``cudaHostAlloc``.  No other page-locked memory of the process is
    touched (PyTorch's caching host allocator is neither used nor
    emptied)."""
    if G.device.type != "cuda":
        return G.numpy()
    import torch

    from . import pinned
    host = pinned.empty(tuple(G.shape), str(G.dtype).replace("torch.", ""))
    torch.from_numpy(host).copy_(G)
    return host


def empty_host_cache() -> None:
    """Hand every free block of PyTorch's caching host allocator back to
    the driver (blocks in use stay).  The port never calls it; a caller
    that wants PyTorch's cache empty may."""
    import torch
    accel = getattr(torch, "accelerator", None)
    fn = getattr(accel, "empty_host_cache", None)
    (fn or torch._C._host_emptyCache)()


_PLAN_CACHE_CAPS = {"pairs": 16, "pyramids": 8}


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md queue 1, "
        f"item {item}); use the JAX package (repro) for it")


class MappingPlan:
    """One lowered (machine × spec × bucket × device) pipeline — see
    module docstring.  Build via ``Mapper.lower(...)`` (session-cached)
    or directly; rebuild a serialized plan with ``from_dict``/``load``.
    ``device`` is ``"cuda"`` unless the caller asks for ``"cpu"``."""

    def __init__(self, machine, spec: MappingSpec | None = None,
                 bucket: ShapeBucket | None = None,
                 cache_caps: dict | None = None, engine_factory=None,
                 machine_factory=None, device=None):
        with _TR.span("plan.lower") as sp:
            self._lower(machine, spec, bucket, cache_caps, engine_factory,
                        machine_factory, device)
            sp.attrs["machine"] = self.topology.kind
            sp.attrs["engine"] = self.spec.engine
            sp.attrs["bucket"] = (None if self.bucket is None
                                  else self.bucket.tag())
        self.lower_seconds = sp.dur

    def _lower(self, machine, spec, bucket, cache_caps, engine_factory,
               machine_factory, device):
        from ..kernels.config import derive_kernel_config
        from ..topology.base import as_topology
        self.device = resolve_device(device)
        self.topology = as_topology(machine)
        self.spec = (spec or MappingSpec()).validate()
        self.bucket = None if bucket is None else bucket.validate()
        if self.spec.portfolio is not None:
            raise _not_ported("portfolio search", 3)
        caps = dict(_PLAN_CACHE_CAPS)
        caps.update(cache_caps or {})
        # --- stage 1 (lower): resolve every handle the hot path needs
        self._construct = resolve_construction(self.spec.construction)
        self._cfg = PartitionConfig.preconfiguration(
            self.spec.preconfiguration)
        self._nb = (None if self.spec.neighborhood is None else
                    resolve_neighborhood(self.spec.neighborhood))
        self.max_sweeps = sweep_budget(self.spec)
        self._ml = self.spec.resolved_multilevel()
        # machine-side level pyramid: level l pairs the PEs (2b, 2b+1)
        # of level l-1 (graph-independent, fixed by n and the V-cycle
        # knobs).  ``machine_factory(depth)`` lets a Mapper session share
        # the chain across plans (coarsening materializes O(n²) coarse
        # distance matrices); a standalone plan builds its own
        machines = [self.topology]
        if self._ml is not None:
            from ..multilevel.coarsen import coarsen_machine, pyramid_depth
            depth = pyramid_depth(self.topology.n_pe, *self._ml)
            if machine_factory is not None:
                machines = list(machine_factory(depth))
            else:
                for _ in range(depth - 1):
                    machines.append(coarsen_machine(machines[-1]))
        self.machines = machines
        # kernel geometry: ONE KernelConfig per pyramid level, derived
        # from the plan bucket + device type (overridable via spec.kernel)
        # at lower time, reported by describe() under "kernels".  A coarse
        # matrix machine whose averaged distances are no longer exact
        # integers derives dist_dtype=None (a float32 table): the packing
        # is decided per level
        self.kernel_backend = self.device.type
        kspec = self.spec.kernel
        kover = {} if kspec is None else {
            "block_rows": kspec.block_rows, "lanes": kspec.lanes,
            "acc_dtype": kspec.acc_dtype, "quantize": kspec.quantize}
        self.kernel_configs = []
        for m in machines:
            kind = m.kernel_params()[0]
            self.kernel_configs.append(derive_kernel_config(
                kind, bucket=self.bucket, backend=self.kernel_backend,
                table=m.matrix() if kind == "matrix" else None, **kover))
        # one refinement engine per level (device engine only).
        # ``engine_factory(machine, max_sweeps, kernel_config) -> (engine,
        # built)`` lets a Mapper session pool engines across plans; a
        # standalone plan builds its own
        self.engine_builds = 0
        self.engines = None
        if self.spec.engine == "device":
            if engine_factory is None:
                from ..engine import RefinementEngine
                dev = self.device

                def engine_factory(m, sweeps, config=None):
                    return RefinementEngine(m, max_sweeps=sweeps,
                                            kernel_config=config,
                                            device=dev), True
            self.engines = []
            for m, cfg in zip(machines, self.kernel_configs):
                eng, built = engine_factory(m, self.max_sweeps, cfg)
                self.engine_builds += bool(built)
                self.engines.append(eng)
        self.kernel_compiles = 0
        self._objective_fn = None
        if self.spec.backend == "pallas":
            self._objective_fn = build_objective_kernel(
                self.topology, config=self.kernel_configs[0],
                device=self.device)
            self.kernel_compiles += 1
        self._swap_gain_fn = None
        # --- per-request state (graph-content keyed, LRU-bounded)
        self._pairs_lru = _LRU(caps["pairs"])
        self._pyramids = _LRU(caps["pyramids"])
        self.executes = 0
        self.execute_seconds_total = 0.0

    # -------------------------------------------------------------- describe
    def describe(self) -> dict:
        """Structured report of what was lowered — per level: size,
        machine kind, device kernel form, kernel configuration, sweep
        budget."""
        n = self.topology.n_pe
        levels = [{
            "level": i,
            "n": n >> i,
            "machine_kind": m.kind,
            "kernel_form": m.kernel_params()[0],
            "kernel_config": self.kernel_configs[i].tag(),
            "engine_compiled": self.engines is not None,
            "max_sweeps": (self.max_sweeps if self.engines is not None
                           else self.spec.max_sweeps),
        } for i, m in enumerate(self.machines)]
        return {
            "machine": {"kind": self.topology.kind, "n_pe": n},
            "bucket": None if self.bucket is None else self.bucket.to_dict(),
            "construction": self.spec.construction,
            "neighborhood": self.spec.neighborhood,
            "neighborhood_dist": self.spec.neighborhood_dist,
            "preconfiguration": self.spec.preconfiguration,
            "engine": self.spec.engine,
            "backend": self.spec.backend,
            "device": str(self.device),
            "multilevel": (None if self._ml is None else
                           {"levels": self._ml[0],
                            "coarsen_min": self._ml[1]}),
            "portfolio": None,
            "kernels": {
                "backend": self.kernel_backend,
                "configs": [cfg.to_dict() for cfg in self.kernel_configs],
                "quantized": any(cfg.dist_dtype is not None
                                 for cfg in self.kernel_configs),
            },
            "levels": levels,
            "compiled": {"engines": self.engine_builds,
                         "kernels": self.kernel_compiles},
            "timings": {
                "lower_seconds": self.lower_seconds,
                "executes": self.executes,
                "execute_seconds_total": self.execute_seconds_total,
                "engine_traces": [eng.trace_count()
                                  for eng in (self.engines or [])],
            },
        }

    def cache_info(self) -> dict:
        return {
            "engine_builds": self.engine_builds,
            "kernel_compiles": self.kernel_compiles,
            "pair_builds": self._pairs_lru.builds,
            "pair_hits": self._pairs_lru.hits,
            "pair_evictions": self._pairs_lru.evictions,
            "pyramid_builds": self._pyramids.builds,
            "pyramid_hits": self._pyramids.hits,
            "pyramid_evictions": self._pyramids.evictions,
            "executes": self.executes,
        }

    def clear_request_caches(self) -> None:
        """Drop all per-request state (candidate pairs, pyramids, device
        uploads) while keeping the lowered artifacts — benchmarks use
        this to time the full per-graph cost honestly."""
        self._pairs_lru.clear()
        self._pyramids.clear()
        for eng in (self.engines or []):
            eng._dg_cache.clear()
            eng._pair_cache.clear()

    # --------------------------------------------------------- serialization
    def plan_spec(self) -> PlanSpec:
        """The serializable identity (spec + machine + bucket)."""
        mspec = self.spec
        if mspec.topology is None:
            mspec = mspec.replace(topology=TopologySpec.of(self.topology))
        return PlanSpec(mapping=mspec, bucket=self.bucket).validate()

    def to_dict(self) -> dict:
        return self.plan_spec().to_dict()

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @classmethod
    def from_dict(cls, d: dict, device=None) -> "MappingPlan":
        ps = PlanSpec.from_dict(d).validate()
        return cls(ps.mapping.topology.build(), ps.mapping, ps.bucket,
                   device=device)

    @classmethod
    def from_json(cls, text: str, device=None) -> "MappingPlan":
        return cls.from_dict(json.loads(text), device=device)

    def save(self, path) -> None:
        with open(path, "w") as fh:
            fh.write(self.to_json())

    @classmethod
    def load(cls, path, device=None) -> "MappingPlan":
        with open(path) as fh:
            return cls.from_json(fh.read(), device=device)

    def __reduce__(self):
        return (_plan_from_dict, (self.to_dict(), str(self.device)))

    # ------------------------------------------------------------- hot path
    def _check(self, g: CommGraph) -> None:
        if g.n != self.topology.n_pe:
            raise ValueError(f"graph has {g.n} processes but the machine "
                             f"has {self.topology.n_pe} PEs — they must "
                             f"match (guide §4.1)")
        if self.bucket is not None and not self.bucket.admits(g):
            raise ValueError(
                f"graph (max_deg="
                f"{int(np.diff(g.xadj).max(initial=0))}, "
                f"E={g.num_edges}) exceeds the plan bucket "
                f"{self.bucket.tag()} — lower a larger plan")

    def _pairs(self, g: CommGraph, seed: int) -> np.ndarray:
        nb = self._nb
        # unseeded (deterministic) generators share one cache entry
        # across seeds — only genuinely randomized ones key on the seed
        key = ((seed if nb.seeded else None,)
               + _structure_key(g, nb.weight_dependent))
        return self._pairs_lru.get_or_build(
            key, lambda: nb.generate(g, dist=self.spec.neighborhood_dist,
                                     seed=seed,
                                     max_pairs=self.spec.max_pairs))

    def objective(self, g: CommGraph, perm: np.ndarray) -> float:
        """J(C, D, Π) via the plan's backend: host numpy float64, or the
        objective kernel bound at lower time (float32 on the device)."""
        if self._objective_fn is not None:
            import torch

            from ..kernels.pad import pad_edge_arrays
            u, v, w = g.edge_list()
            eu, ev, ew = pad_edge_arrays(u, v, w, device=self.device)
            p = torch.from_numpy(np.asarray(perm, dtype=np.int32)).to(
                self.device)
            with host_boundary("plan.objective"):
                return float(self._objective_fn(eu, ev, ew, p))
        return qap_objective(g, self.topology, perm)

    def gain_matrix(self, g: CommGraph, perm: np.ndarray) -> np.ndarray:
        """Full pair-exchange gain matrix via the plan's backend (dense —
        small/medium n): the K3 kernel on the plan's device (``pallas``,
        float32) or the host float64 ``dense_gain_matrix`` (``numpy``).
        From the card, G is read back into page-locked host memory that
        stays pinned while the caller holds the array (``read_back``)."""
        perm = np.asarray(perm, dtype=np.int64)
        if self.spec.backend == "pallas":
            if self._swap_gain_fn is None:
                self._swap_gain_fn = build_swap_gain_kernel(
                    self.topology, device=self.device)
                self.kernel_compiles += 1
            G = self._swap_gain_fn(g, perm)
            with host_boundary("plan.gain_matrix"):
                return read_back(G)
        return dense_gain_matrix(g.to_dense(), self.topology.matrix(), perm)

    def _construct_one(self, g: CommGraph, seed: int
                       ) -> tuple[np.ndarray, float, float]:
        with _TR.span("plan.construct", n=g.n,
                      construction=self.spec.construction) as sp:
            perm = self._construct(g, self.topology, seed=seed,
                                   cfg=self._cfg)
        return perm, sp.dur, self.objective(g, perm)

    def _finish(self, g: CommGraph, perm: np.ndarray, j0: float,
                t_cons: float, t_search: float,
                stats: SearchStats | None) -> MappingResult:
        """Result assembly: the final objective is the search's host
        float64 value on the ``numpy`` backend and recomputed through
        the plan backend otherwise, so j0 and jf stay comparable."""
        if stats is None:
            jf = j0
        elif self.spec.backend == "numpy":
            jf = stats.final_objective
        else:
            jf = self.objective(g, perm)
        return MappingResult(perm=perm, initial_objective=j0,
                             final_objective=jf,
                             construction_seconds=t_cons,
                             search_seconds=t_search, search_stats=stats)

    def execute(self, g: CommGraph, seed: int | None = None,
                telemetry: bool = False) -> MappingResult:
        """Map one graph through the lowered pipeline.  ``seed`` is the
        runtime seed (defaults to the plan spec's) — it steers the
        construction and any seeded neighborhood.  ``telemetry`` asks
        the device engine to collect its per-sweep counters
        (``result.search_stats.telemetry``)."""
        seed = self.spec.seed if seed is None else int(seed)
        self._check(g)
        self.executes += 1
        with _TR.span("plan.execute", n=g.n, engine=self.spec.engine,
                      seed=seed) as sp:
            if self._ml is not None:
                res = self._execute_batch_multilevel([g], seed,
                                                     telemetry)[0]
            else:
                res = self._execute_flat(g, seed, telemetry)
            sp.attrs["final_objective"] = res.final_objective
        self.execute_seconds_total += sp.dur
        return res

    def _execute_flat(self, g: CommGraph, seed: int,
                      telemetry: bool) -> MappingResult:
        perm, t_cons, j0 = self._construct_one(g, seed)
        stats = None
        with _TR.span("plan.refine", n=g.n,
                      engine=self.spec.engine) as rsp:
            if self._nb is not None:
                pairs = self._pairs(g, seed)
                rsp.attrs["pairs"] = len(pairs)
                kw = {} if self.spec.max_sweeps is None else \
                    {"max_sweeps": self.spec.max_sweeps}
                if self.spec.engine == "device":
                    eng = self.engines[0]
                    stats = eng.refine(g, perm, pairs, j0=j0,
                                       bucket=self.bucket,
                                       telemetry=telemetry)
                    rsp.attrs["syncs"] = dict(eng.last_syncs)
                    if stats.telemetry is not None:
                        rsp.attrs["telemetry"] = stats.telemetry
                elif self.spec.parallel_sweeps:
                    stats = parallel_sweep_search(g, self.topology, perm,
                                                  pairs, seed=seed, **kw)
                else:
                    stats = _cyclic_search(g, self.topology, perm, pairs,
                                           shuffle=self._nb.shuffle,
                                           seed=seed, **kw)
        return self._finish(g, perm, j0, t_cons, rsp.dur, stats)

    def candidate_pairs(self, g: CommGraph,
                        seed: int | None = None) -> np.ndarray:
        """The plan's candidate exchange pairs for this graph — the same
        (p, 2) array ``execute`` refines over, LRU-cached per structure.
        Exposed so incremental callers (a remap monitor) can build a
        runtime activity mask over a *fixed* pair set and keep the padded
        pair shape unchanged across warm re-executions."""
        if self._nb is None:
            return np.zeros((0, 2), np.int64)
        seed = self.spec.seed if seed is None else int(seed)
        return self._pairs(g, seed)

    def execute_warm(self, g: CommGraph, perm: np.ndarray,
                     pairs: np.ndarray | None = None,
                     active: np.ndarray | None = None,
                     seed: int | None = None,
                     telemetry: bool = False) -> MappingResult:
        """Warm-start: refine an incumbent ``perm`` on ``g`` with NO
        construction phase — the incremental-remap hot path.

        ``pairs`` fixes the candidate set (default: the plan's own
        ``candidate_pairs(g)``); ``active`` is an optional boolean mask
        over it.  Inactive pairs are replaced by inert ``(u, u)``
        self-pairs — exactly the engine's padding convention, zero gain
        and never selected — so the array length and the padded pair
        shape P are unchanged.  Dirty-region remaps pass the mask of
        pairs touching drifted vertices and leave the rest of the mapping
        frozen in place by construction of the sweep.

        The incumbent is *not* mutated; the result carries the refined
        copy.  ``initial_objective`` is the incumbent's objective on
        ``g``, so ``result.improvement`` reads as recovered drift."""
        seed = self.spec.seed if seed is None else int(seed)
        self._check(g)
        self.executes += 1
        perm = np.array(perm, dtype=np.int64, copy=True)
        with _TR.span("plan.execute_warm", n=g.n, engine=self.spec.engine,
                      seed=seed) as sp:
            j0 = self.objective(g, perm)
            stats = None
            with _TR.span("plan.refine", n=g.n, engine=self.spec.engine,
                          warm=True) as rsp:
                if pairs is None:
                    pairs = self.candidate_pairs(g, seed)
                pairs = np.asarray(pairs, dtype=np.int64)
                if active is not None:
                    active = np.asarray(active, dtype=bool)
                    if active.shape != (len(pairs),):
                        raise ValueError(
                            f"active mask shape {active.shape} does not "
                            f"match {len(pairs)} candidate pairs")
                    masked = np.where(active[:, None], pairs,
                                      pairs[:, [0, 0]])
                else:
                    masked = pairs
                rsp.attrs["pairs"] = len(pairs)
                rsp.attrs["active"] = (len(pairs) if active is None
                                       else int(active.sum()))
                if len(pairs) and self.spec.engine == "device":
                    eng = self.engines[0]
                    stats = eng.refine(g, perm, masked, j0=j0,
                                       bucket=self.bucket,
                                       telemetry=telemetry)
                    rsp.attrs["syncs"] = dict(eng.last_syncs)
                    if stats.telemetry is not None:
                        rsp.attrs["telemetry"] = stats.telemetry
                elif len(pairs):
                    live = masked if active is None else pairs[active]
                    kw = {} if self.spec.max_sweeps is None else \
                        {"max_sweeps": self.spec.max_sweeps}
                    stats = parallel_sweep_search(g, self.topology, perm,
                                                  live, seed=seed, **kw)
            res = self._finish(g, perm, j0, 0.0, rsp.dur, stats)
            sp.attrs["final_objective"] = res.final_objective
        self.execute_seconds_total += sp.dur
        return res

    def execute_batch(self, graphs, seed: int | None = None,
                      telemetry: bool = False) -> list[MappingResult]:
        """Map a batch through one batched sweep loop per level (one K2
        launch a sweep for the whole batch on the card).

        Every graph must fit the plan bucket (they need not be
        structurally identical — padding into the common bucket is
        inert), so each result equals the graph's single ``execute``."""
        graphs = list(graphs)
        if not graphs:
            return []
        seed = self.spec.seed if seed is None else int(seed)
        if self._ml is not None:
            for g in graphs:
                self._check(g)
            self.executes += len(graphs)
            with _TR.span("plan.execute_batch", batch=len(graphs),
                          n=graphs[0].n) as bsp:
                out = self._execute_batch_multilevel(graphs, seed, telemetry)
            self.execute_seconds_total += bsp.dur
            return out
        if self.spec.engine != "device" or self._nb is None:
            return [self.execute(g, seed=seed, telemetry=telemetry)
                    for g in graphs]
        for g in graphs:
            self._check(g)
        self.executes += len(graphs)
        with _TR.span("plan.execute_batch", batch=len(graphs),
                      n=graphs[0].n) as bsp:
            # duplicate lanes (a caller padding its batch by repeating
            # graphs) share one construction; every lane still gets its
            # own perm array because the engine refines in place
            memo: dict = {}
            prepped = []
            for g in graphs:
                hit = memo.get(id(g))
                if hit is None:
                    hit = memo[id(g)] = self._construct_one(g, seed)
                else:
                    hit = (hit[0].copy(), hit[1], hit[2])
                prepped.append(hit)
            perms = [perm for perm, _, _ in prepped]
            # timed window matches execute()'s: pair gen + refinement
            eng = self.engines[0]
            with _TR.span("plan.refine", batch=len(graphs)) as rsp:
                pairs_list = [self._pairs(g, seed) for g in graphs]
                stats_list = eng.refine_batch(
                    graphs, perms, pairs_list,
                    j0s=[j0 for _, _, j0 in prepped],
                    bucket=self.bucket, telemetry=telemetry)
                rsp.attrs["syncs"] = dict(eng.last_syncs)
            t_search = rsp.dur / len(graphs)
        self.execute_seconds_total += bsp.dur
        return [self._finish(g, perm, j0, t_cons, t_search, stats)
                for g, (perm, t_cons, j0), stats
                in zip(graphs, prepped, stats_list)]

    # ------------------------------------------------------------ multilevel
    def _pyramid(self, g: CommGraph, seed: int) -> list:
        """The graph-side level pyramid, LRU-cached per (graph structure
        *and weights* — the heavy-edge matching reads them, seed for
        seeded neighborhoods); its contractions run on the plan's
        device."""
        from ..multilevel.coarsen import build_pyramid
        levels, cmin = self._ml
        if self._nb is None:
            pair_fn = lambda gg: np.zeros((0, 2), np.int64)  # noqa: E731
            skey = None
        else:
            nb = self._nb
            pair_fn = lambda gg: nb.generate(        # noqa: E731
                gg, dist=self.spec.neighborhood_dist, seed=seed,
                max_pairs=self.spec.max_pairs)
            skey = seed if nb.seeded else None
        key = (("pyramid", skey)
               + _structure_key(g, with_weights=True))
        return self._pyramids.get_or_build(
            key, lambda: build_pyramid(g, self.machines, levels, cmin,
                                       pair_fn, device=self.device))

    def _execute_batch_multilevel(self, graphs, seed: int,
                                  telemetry: bool = False
                                  ) -> list[MappingResult]:
        """The coarsen → map → uncoarsen V-cycles (:mod:`repro_torch
        .multilevel`) of a batch — one graph for ``execute`` — over the
        plan's per-level engines.  The forced perfect pairing gives every
        same-n graph the same level geometry, so each level's refinement
        runs as ONE batched engine call across the whole batch.  The
        reported initial objective is the projected (pre-refinement)
        finest-level objective."""
        from ..multilevel import vcycle_map_batch
        n = graphs[0].n
        with _TR.span("plan.pyramid", n=n, batch=len(graphs)):
            pyramids = [self._pyramid(g, seed) for g in graphs]
        with _TR.span("plan.vcycle", n=n, batch=len(graphs),
                      levels=len(pyramids[0])) as sp:
            results = vcycle_map_batch(
                pyramids, self.engines, self._construct, self._cfg,
                seed=seed, objective0=self.objective, bucket=self.bucket,
                telemetry=telemetry)
        elapsed = sp.dur / len(graphs)
        return [self._finish(g, r.perm, r.initial_objective,
                             r.construction_seconds,
                             elapsed - r.construction_seconds, r.stats)
                for g, r in zip(graphs, results)]


def _plan_from_dict(d: dict, device=None) -> MappingPlan:
    """Module-level pickle entry (``MappingPlan.__reduce__``)."""
    return MappingPlan.from_dict(d, device=device)
