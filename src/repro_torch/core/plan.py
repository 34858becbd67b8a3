"""`MappingPlan` — the lowered artifact between ``Mapper.lower()`` and the
``execute()`` hot path, on one device.

The guide's workflow is "build the machine model once, map many
communication graphs against it"; the staged API makes that split
explicit:

    plan = mapper.lower(ShapeBucket.of(g))      # resolve + bind kernels
    result = plan.execute(g)                    # hot path: pad + run

``lower`` resolves everything that does not depend on the individual
graph — the construction/neighborhood registry handles, the partition
config, the :class:`~repro_torch.engine.RefinementEngine`, the kernel
configuration, and the objective kernel for the ``pallas`` backend (in
this port: the hand-written CUDA objective, K1) — so ``execute`` pads
the graph into the plan's :class:`~repro_torch.core.spec.ShapeBucket`
(inert by the DeviceGraph padding invariants) and runs the pipeline.
The seed is a runtime input (``execute(g, seed=)``).

This is the port of the JAX package's ``core/plan.py`` for the flat
pipeline, on both engines (``device``: the refinement engine; ``host``:
the numpy search drivers of :mod:`.local_search`), and for the dense
gain matrix (``gain_matrix``: K3 on the ``pallas`` backend).  Lowering a
spec with a multilevel (more than one level) or portfolio block raises
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

    def values(self):
        return self._data.values()

    def items(self):
        return self._data.items()

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
    copied into page-locked host memory and the array is a view of it,
    which keeps it alive; a pageable ``.cpu()`` copy runs at a fraction
    of the link's rate.  A CPU tensor is returned as its own view.

    The page-locked block comes from PyTorch's caching host allocator,
    its size rounded up to a power of two (n = 4096: 64 MiB; n = 1000:
    4 MiB for 3.8 MiB), and stays pinned while the caller holds the
    array.  A block the caller has dropped is reused by the next call of
    its size, so a warm call pays no ``cudaHostAlloc``; every other free
    cached block is handed back to the driver right after the copy
    (``empty_host_cache``, process-wide).  So at the end of a call the
    process pins no more host memory than the arrays still held, and
    between calls at most what the caller held at once since the last
    one."""
    if G.device.type != "cuda":
        return G.numpy()
    import torch
    host = torch.empty(G.shape, dtype=G.dtype, pin_memory=True)
    host.copy_(G)
    empty_host_cache()
    return host.numpy()


def empty_host_cache() -> None:
    """Hand every free block of PyTorch's caching host allocator back to
    the driver (blocks in use stay)."""
    import torch
    accel = getattr(torch, "accelerator", None)
    fn = getattr(accel, "empty_host_cache", None)
    (fn or torch._C._host_emptyCache)()


_PLAN_CACHE_CAPS = {"pairs": 16}


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
                 device=None):
        with _TR.span("plan.lower") as sp:
            self._lower(machine, spec, bucket, cache_caps, engine_factory,
                        device)
            sp.attrs["machine"] = self.topology.kind
            sp.attrs["engine"] = self.spec.engine
            sp.attrs["bucket"] = (None if self.bucket is None
                                  else self.bucket.tag())
        self.lower_seconds = sp.dur

    def _lower(self, machine, spec, bucket, cache_caps, engine_factory,
               device):
        from ..kernels.config import derive_kernel_config
        from ..topology.base import as_topology
        self.device = resolve_device(device)
        self.topology = as_topology(machine)
        self.spec = (spec or MappingSpec()).validate()
        self.bucket = None if bucket is None else bucket.validate()
        if self.spec.portfolio is not None:
            raise _not_ported("portfolio search", 3)
        if self.spec.resolved_multilevel() is not None:
            raise _not_ported("multilevel mapping", 2)
        caps = dict(_PLAN_CACHE_CAPS)
        caps.update(cache_caps or {})
        # --- stage 1 (lower): resolve every handle the hot path needs
        self._construct = resolve_construction(self.spec.construction)
        self._cfg = PartitionConfig.preconfiguration(
            self.spec.preconfiguration)
        self._nb = (None if self.spec.neighborhood is None else
                    resolve_neighborhood(self.spec.neighborhood))
        self.max_sweeps = sweep_budget(self.spec)
        self.machines = [self.topology]
        # kernel geometry: derived from the plan bucket + device type
        # (overridable via spec.kernel) at lower time, reported by
        # describe() under "kernels"
        self.kernel_backend = self.device.type
        kspec = self.spec.kernel
        kover = {} if kspec is None else {
            "block_rows": kspec.block_rows, "lanes": kspec.lanes,
            "acc_dtype": kspec.acc_dtype, "quantize": kspec.quantize}
        kind = self.topology.kernel_params()[0]
        self.kernel_configs = [derive_kernel_config(
            kind, bucket=self.bucket, backend=self.kernel_backend,
            table=self.topology.matrix() if kind == "matrix" else None,
            **kover)]
        # the refinement engine (device engine only).  ``engine_factory
        # (machine, max_sweeps, kernel_config) -> (engine, built)`` lets a
        # Mapper session pool engines across plans; a standalone plan
        # builds its own
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
            eng, built = engine_factory(self.topology, self.max_sweeps,
                                        self.kernel_configs[0])
            self.engine_builds += bool(built)
            self.engines = [eng]
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
        self.executes = 0
        self.execute_seconds_total = 0.0

    # -------------------------------------------------------------- describe
    def describe(self) -> dict:
        """Structured report of what was lowered — size, machine kind,
        device kernel form, kernel configuration, sweep budget."""
        n = self.topology.n_pe
        levels = [{
            "level": 0,
            "n": n,
            "machine_kind": self.topology.kind,
            "kernel_form": self.topology.kernel_params()[0],
            "kernel_config": self.kernel_configs[0].tag(),
            "engine_compiled": self.engines is not None,
            "max_sweeps": (self.max_sweeps if self.engines is not None
                           else self.spec.max_sweeps),
        }]
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
            "multilevel": None,
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
            "executes": self.executes,
        }

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


def _plan_from_dict(d: dict, device=None) -> MappingPlan:
    """Module-level pickle entry (``MappingPlan.__reduce__``)."""
    return MappingPlan.from_dict(d, device=device)
