"""Top-level mapping API — `Mapper` sessions driven by `MappingSpec`,
staged through `MappingPlan` artifacts, on one device.

    spec = MappingSpec(engine="device", backend="pallas")
    mapper = Mapper(machine, spec)           # machine: Hierarchy or Topology
    plan = mapper.lower(ShapeBucket.of(g))   # stage 1: lower
    result = plan.execute(g)                 # stage 2: run
    result = mapper.map(g)                   # thin wrapper: lower-or-fetch
    results = mapper.map_many(gs)            # one plan, one batched loop
    with mapper.serve() as svc:              # a worker thread drains a queue
        ticket = svc.submit(g)

A `Mapper` owns one machine model — a :class:`Hierarchy` (wrapped into
the ``tree`` topology) or any registered
:class:`~repro_torch.topology.Topology` — plus ONE LRU cache of lowered
:class:`~repro_torch.core.plan.MappingPlan` artifacts keyed by
(seed-free spec, :class:`ShapeBucket`), and a pool of refinement engines
shared by its plans.  ``device`` is ``"cuda"`` unless the caller passes
``"cpu"``; it is a constructor argument, not a spec field, so spec dicts
round-trip with the JAX package unchanged.

This is the port of the JAX package's ``core/mapping.py``: ``map``,
``map_many``, ``objective``, ``gain_matrix`` and the request-queue hook
``serve`` / :class:`MapperService` (its worker maps through the same
Mapper, so on the Mapper's device).  The shape-bucketed, batching
service is :class:`repro_torch.launch.serve.MappingService`.
"""

from __future__ import annotations

import itertools
import json
import queue
import threading
from collections import Counter

from ..runtime.device import resolve_device
from .graph import CommGraph
from .plan import MappingPlan, MappingResult, _LRU
from .spec import MappingSpec, ShapeBucket

__all__ = ["Mapper", "MapperService", "MappingResult", "MappingPlan",
           "ShapeBucket"]

# default caps for the session caches (override via Mapper(cache_caps=...)):
# "plans" bounds the Mapper's plan LRU; "engines" bounds the shared
# engine pool; "pairs"/"pyramids" bound each plan's per-request
# graph-content caches; "engine_graphs"/"engine_pairs" bound each pooled
# engine's device-upload LRUs (see RefinementEngine)
_DEFAULT_CACHE_CAPS = {"plans": 8, "engines": 8, "pairs": 16,
                       "pyramids": 8, "engine_graphs": 16,
                       "engine_pairs": 16}


class Mapper:
    """A mapping session over one machine model on one device (see
    module docstring)."""

    def __init__(self, machine, spec: MappingSpec | None = None,
                 cache_caps: dict | None = None, device=None):
        from ..topology.base import as_topology
        self.device = resolve_device(device)
        self.topology = as_topology(machine)
        self.h = self.topology
        self.spec = (spec or MappingSpec()).validate()
        self.oracle, self._oracle_builds = self._claim_oracle()
        caps = dict(_DEFAULT_CACHE_CAPS)
        if cache_caps:
            unknown = sorted(set(cache_caps) - set(caps))
            if unknown:
                raise ValueError(f"unknown cache_caps keys {unknown}; "
                                 f"known: {sorted(caps)}")
            caps.update(cache_caps)
        self._plan_caps = {"pairs": caps["pairs"],
                           "pyramids": caps["pyramids"]}
        self._engine_caps = {"graphs": caps["engine_graphs"],
                             "pairs": caps["engine_pairs"]}
        # THE session cache: lowered plans keyed by (seed-free spec,
        # bucket).  Evicted plans retire their counters into _retired so
        # cache_info() stays monotone.
        self._retired: Counter = Counter()
        self._plans = _LRU(caps["plans"], on_evict=self._retire_plan)
        # engines are bucket-agnostic (the bucket is a per-call
        # argument), so plans over the same (machine kernel form, sweep
        # budget, kernel config) share one instance
        self._engine_pool = _LRU(caps["engines"])
        # machine-side coarse pyramid (graph-independent, fixed by the
        # topology): grown lazily, shared by every multilevel plan
        self._ml_machines: list = [self.topology]
        self._requests = 0

    def _shared_engine(self, machine, max_sweeps: int, kernel_config=None):
        """Plan engine factory: one RefinementEngine per (machine kernel
        form, sweep budget, kernel config), shared by every plan this
        session lowers.  Returns (engine, built)."""
        from ..engine import RefinementEngine
        before = self._engine_pool.builds
        cfg_key = None if kernel_config is None else kernel_config.key()
        eng = self._engine_pool.get_or_build(
            (machine.kernel_params(), int(max_sweeps), cfg_key),
            lambda: RefinementEngine(machine, max_sweeps=max_sweeps,
                                     cache_caps=self._engine_caps,
                                     kernel_config=kernel_config,
                                     device=self.device))
        return eng, self._engine_pool.builds > before

    def _coarse_machines(self, depth: int) -> list:
        """The machine-side pyramid up to ``depth`` levels — level l
        pairs the PEs (2b, 2b+1) of level l-1.  Coarsening materializes
        O(n²) coarse distance matrices, so the chain is built once per
        session and shared by every plan over this machine."""
        from ..multilevel.coarsen import coarsen_machine
        while len(self._ml_machines) < depth:
            self._ml_machines.append(coarsen_machine(self._ml_machines[-1]))
        return self._ml_machines[:depth]

    @classmethod
    def from_spec(cls, spec: MappingSpec, device=None) -> "Mapper":
        """Build the machine from the spec's serialized
        :class:`TopologySpec` and open a session over it."""
        spec = spec.validate()
        if spec.topology is None:
            raise ValueError("MappingSpec.topology is not set; pass the "
                             "machine explicitly: Mapper(machine, spec)")
        return cls(spec.topology.build(), spec, device=device)

    def _claim_oracle(self):
        """The machine's distance-oracle state, built at most once per
        machine instance and shared across sessions over it.  Returns
        (oracle, builds_counted_against_this_session)."""
        topo = self.topology
        if hasattr(topo, "hierarchy"):            # tree family
            already = "oracle" in topo.hierarchy.__dict__
            return topo.hierarchy.oracle, 0 if already else 1
        already = getattr(topo, "_oracle_claimed", False)
        topo._oracle_claimed = True
        return topo, 0 if already else 1

    # ------------------------------------------------------------ stage 1
    def bucket_of(self, g: CommGraph,
                  schedule: str = "tight") -> ShapeBucket:
        """The :class:`ShapeBucket` this graph pads into under
        ``schedule``."""
        return ShapeBucket.of(g, schedule=schedule)

    def lower(self, bucket: ShapeBucket | None,
              spec: MappingSpec | None = None) -> MappingPlan:
        """Stage 1: fetch-or-build the lowered :class:`MappingPlan` for
        (spec, bucket).  The cache key drops the spec's seed — the seed
        is a runtime input of ``plan.execute``."""
        spec = self.spec if spec is None else spec.validate()
        return self._plans.get_or_build(
            self._plan_key(spec, bucket),
            lambda: MappingPlan(self.topology, spec, bucket,
                                cache_caps=self._plan_caps,
                                engine_factory=self._shared_engine,
                                machine_factory=self._coarse_machines,
                                device=self.device))

    def lower_for(self, g: CommGraph, spec: MappingSpec | None = None,
                  schedule: str = "tight") -> MappingPlan:
        """``lower`` with the bucket derived from a concrete graph."""
        self._check_size(g)
        return self.lower(self.bucket_of(g, schedule=schedule), spec)

    @staticmethod
    def _plan_key(spec: MappingSpec, bucket: ShapeBucket | None) -> tuple:
        d = spec.to_dict()
        d.pop("seed")
        return (json.dumps(d, sort_keys=True), bucket)

    def _retire_plan(self, plan: MappingPlan) -> None:
        self._retired.update(plan.cache_info())

    # ------------------------------------------------------------- caching
    def cache_info(self) -> dict:
        """Session amortization counters: the plan cache (builds =
        lowers, hits, evictions, per-bucket breakdown) plus the per-plan
        counters aggregated across live and retired plans, and requests
        served."""
        agg = Counter(self._retired)
        per_bucket: dict = {}
        for (_spec_key, bucket), plan in list(self._plans.items()):
            info = plan.cache_info()
            agg.update(info)
            tag = "dynamic" if bucket is None else bucket.tag()
            while tag in per_bucket:
                tag += "'"               # same bucket, different spec
            per_bucket[tag] = info
        return {
            "oracle_builds": self._oracle_builds,
            "plan_builds": self._plans.builds,
            "plan_hits": self._plans.hits,
            "plan_evictions": self._plans.evictions,
            "plans": per_bucket,
            "engine_pool_evictions": self._engine_pool.evictions,
            "engine_graph_evictions": sum(
                e.cache_info()["graph_evictions"]
                for e in list(self._engine_pool.values())),
            "engine_pair_evictions": sum(
                e.cache_info()["pair_evictions"]
                for e in list(self._engine_pool.values())),
            "engine_builds": agg["engine_builds"],
            "kernel_compiles": agg["kernel_compiles"],
            "pair_cache_builds": agg["pair_builds"],
            "pair_cache_hits": agg["pair_hits"],
            "pair_cache_evictions": agg["pair_evictions"],
            "pyramid_builds": agg["pyramid_builds"],
            "pyramid_hits": agg["pyramid_hits"],
            "pyramid_evictions": agg["pyramid_evictions"],
            "requests": self._requests,
        }

    # ----------------------------------------------------------- objective
    def _eval_plan(self, spec: MappingSpec) -> MappingPlan:
        """A lean evaluation-only plan (no engine, dynamic bucket): a
        standalone objective only depends on (machine, backend)."""
        spec = spec.replace(neighborhood=None, engine="host",
                            multilevel=None, portfolio=None,
                            parallel_sweeps=False)
        return self.lower(None, spec)

    def objective(self, g: CommGraph, perm,
                  spec: MappingSpec | None = None) -> float:
        """J(C, D, Π) via the spec's backend: ``numpy`` host evaluation or
        the objective kernel (``pallas``)."""
        spec = self.spec if spec is None else spec.validate()
        return self._eval_plan(spec).objective(g, perm)

    def gain_matrix(self, g: CommGraph, perm,
                    spec: MappingSpec | None = None):
        """Full pair-exchange gain matrix via the spec's backend (dense —
        small/medium n): the K3 kernel on the session's device
        (``pallas``) or the host float64 formula (``numpy``).  From the
        card the (n, n) float32 array is a view of a page-locked block
        of n²·4 bytes, pinned while the caller holds it and reused by the
        next call once dropped (``core/plan.py:read_back``)."""
        spec = self.spec if spec is None else spec.validate()
        return self._eval_plan(spec).gain_matrix(g, perm)

    # ----------------------------------------------------------------- map
    def map(self, g: CommGraph, spec: MappingSpec | None = None,
            telemetry: bool = False) -> MappingResult:
        """Compute a process→PE mapping for one graph: lower-or-fetch the
        plan for the graph's tight bucket, then ``execute``.
        ``telemetry`` collects the engine's per-sweep counters on
        ``result.search_stats.telemetry``."""
        spec = self.spec if spec is None else spec.validate()
        self._check_size(g)
        self._requests += 1
        plan = self.lower(self.bucket_of(g), spec)
        return plan.execute(g, seed=spec.seed, telemetry=telemetry)

    def map_many(self, graphs, spec: MappingSpec | None = None,
                 telemetry: bool = False) -> list[MappingResult]:
        """Map a batch of graphs through one plan.

        Graphs must agree on process count (and therefore PE count); the
        batch is lowered into the union bucket, so device-engine batches
        run as ONE batched sweep loop per level (one K2 launch a sweep
        for all of them on the card).  Each result equals the graph's
        :meth:`map` (the padding into the union bucket is inert).
        """
        graphs = list(graphs)
        if not graphs:
            return []
        ns = {g.n for g in graphs}
        if len(ns) != 1:
            raise ValueError(f"map_many requires same-shape graphs; got "
                             f"process counts {sorted(ns)}")
        spec = self.spec if spec is None else spec.validate()
        for g in graphs:
            self._check_size(g)
        self._requests += len(graphs)
        bucket = self.bucket_of(graphs[0])
        for g in graphs[1:]:
            bucket = bucket.union(self.bucket_of(g))
        return self.lower(bucket, spec).execute_batch(
            graphs, seed=spec.seed, telemetry=telemetry)

    def _check_size(self, g: CommGraph) -> None:
        if g.n != self.h.n_pe:
            raise ValueError(f"graph has {g.n} processes but the machine "
                             f"has {self.h.n_pe} PEs — they must match "
                             f"(guide §4.1)")

    # --------------------------------------------------------------- serve
    def serve(self, requests: "queue.Queue | None" = None,
              results: "queue.Queue | None" = None) -> "MapperService":
        """Start a request-queue serving session over this Mapper."""
        return MapperService(self, requests=requests, results=results)


class MapperService:
    """Request-queue serving hook: a daemon thread drains graphs through
    one :class:`Mapper` session, so plan lowering (oracle, kernels,
    engines) is paid once for the whole queue.  For shape-bucketed
    dynamic batching use :class:`repro_torch.launch.serve.MappingService`.

    ``submit(g)`` returns a ticket; ``(ticket, MappingResult)`` tuples (or
    ``(ticket, Exception)`` on per-request failure) arrive on ``results``.
    ``close()`` — or exiting the context manager — stops the thread after
    draining already-queued requests.

    The worker runs every map on the Mapper's device, launching on its
    own thread's current CUDA stream.  While it runs, other threads
    should leave that Mapper's device work to it: the kernels' launch
    counts and the sync-counting scopes (``runtime/boundary.py``) are
    process-wide and meant for one launching thread at a time.
    """

    def __init__(self, mapper: Mapper,
                 requests: "queue.Queue | None" = None,
                 results: "queue.Queue | None" = None):
        self.mapper = mapper
        self.requests = requests if requests is not None else queue.Queue()
        self.results = results if results is not None else queue.Queue()
        self._tickets = itertools.count()
        self._closed = False
        self._lock = threading.Lock()   # makes submit vs close atomic
        self._thread = threading.Thread(target=self._drain,
                                        name="viem-mapper", daemon=True)
        self._thread.start()

    def submit(self, g: CommGraph,
               spec: MappingSpec | None = None) -> int:
        with self._lock:
            if self._closed:
                raise RuntimeError("MapperService is closed; requests "
                                   "submitted now would never be served")
            ticket = next(self._tickets)
            self.requests.put((ticket, g, spec))
        return ticket

    def _drain(self):
        while True:
            item = self.requests.get()
            if item is None:
                break
            ticket, g, spec = item
            try:
                out: object = self.mapper.map(g, spec=spec)
            except Exception as exc:   # per-request isolation
                out = exc
            self.results.put((ticket, out))

    def close(self, timeout: float | None = None):
        with self._lock:
            if not self._closed:
                self._closed = True
                self.requests.put(None)
        self._thread.join(timeout)

    def __enter__(self) -> "MapperService":
        return self

    def __exit__(self, *exc):
        self.close()
