"""`MappingSpec` — the one declarative config language for mappings.

Every way of asking for a mapping (library calls, the `viem` CLI, launch
specs, benchmarks, the serving queue) builds the same frozen, serializable
spec:

    spec = MappingSpec(construction="hierarchytopdown",
                       neighborhood="communication", neighborhood_dist=10)
    spec.to_dict() / MappingSpec.from_dict(d)     # JSON-safe round trip
    MappingSpec.from_flags(args)                  # the guide's §4.1 flags

Algorithm names are resolved against the registries in
:mod:`repro_torch.core.construction`, :mod:`repro_torch.core.local_search`, and
:mod:`repro_torch.topology`, so a third-party ``@register_construction`` /
``@register_topology`` plug-in is immediately addressable from a spec (and
from the CLI) without touching this file.

A spec may carry the machine model itself as a :class:`TopologySpec`
(kind + JSON-safe constructor params); ``Mapper.from_spec(spec)`` then
builds both the topology and the session from the one serialized object.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field

_NONE_ALIASES = (None, "none", "None", "")


@dataclass(frozen=True)
class TopologySpec:
    """Declarative machine model: a registered topology ``kind`` plus the
    JSON-safe constructor parameters its factory takes, e.g.::

        TopologySpec("tree",  {"factors": [4, 4], "distances": [1, 10]})
        TopologySpec("torus", {"dims": [16, 16]})
        TopologySpec("matrix", {"file": "D.metis"})

    ``build()`` resolves the kind against the ``@register_topology``
    registry and returns the live :class:`~repro_torch.topology.Topology`.
    """

    kind: str = "tree"
    params: dict = field(default_factory=dict)

    def validate(self) -> "TopologySpec":
        from ..topology.base import resolve_topology
        resolve_topology(self.kind)
        return self

    def build(self):
        from ..topology.base import make_topology
        return make_topology(self.kind, **self.params)

    def to_dict(self) -> dict:
        return {"kind": self.kind, "params": dict(self.params)}

    @classmethod
    def from_dict(cls, d: dict) -> "TopologySpec":
        unknown = sorted(set(d) - {"kind", "params"})
        if unknown:
            raise ValueError(f"unknown TopologySpec keys {unknown}; "
                             f"known keys: ['kind', 'params']")
        return cls(kind=d.get("kind", "tree"),
                   params=dict(d.get("params", {})))

    @classmethod
    def of(cls, topology) -> "TopologySpec":
        """Spec of a live topology (via its ``spec_params``)."""
        return cls(kind=topology.kind, params=topology.spec_params())


# ----------------------------------------------------------- shape buckets
# base quanta for the padded device shapes — the DeviceGraph/device_pairs
# padding defaults, so a "tight" bucket reproduces the pre-plan shapes
# bit-for-bit
_DEG_BASE = 8
_EDGE_BASE = 128
_PAIR_BASE = 128


def bucket_round(x: int, schedule: str, base: int) -> int:
    """Round a raw size up by a bucket schedule.

    ``"tight"`` → the next multiple of ``base`` (the device-array padding
    quantum — exactly the shapes the engine would pick per graph);
    ``"pow2"`` → the next power of two, at least ``base`` (few, coarse
    buckets — the serving default, so mixed traffic collapses onto a
    handful of compiled executables); ``"mult:<k>"`` → the next multiple
    of ``k`` (a custom linear schedule).
    """
    x = max(int(x), 1)
    if schedule == "tight":
        return max(base, -(-x // base) * base)
    if schedule == "pow2":
        return max(base, 1 << (x - 1).bit_length())
    if schedule.startswith("mult:"):
        k = int(schedule.split(":", 1)[1])
        if k < 1:
            raise ValueError(f"mult bucket schedule needs k >= 1, got {k}")
        # never below the tight rounding: device arrays are padded to
        # ``base`` quanta regardless, and a bucket smaller than that
        # padding could not hold the graph it was derived from
        return max(-(-x // k) * k, max(base, -(-x // base) * base))
    raise ValueError(f"unknown bucket schedule {schedule!r}; choose "
                     f"'tight', 'pow2', or 'mult:<k>'")


@dataclass(frozen=True)
class ShapeBucket:
    """Padded device-shape geometry of a :class:`~repro_torch.core.plan.MappingPlan`.

    ``max_deg`` (K) and ``num_edges`` (E) fix the ELL neighbor width and
    padded edge-list length every graph is padded into; ``num_pairs`` (P)
    fixes the candidate-pair length, or ``None`` to round each request's
    pair count by ``schedule`` (pairs are generated per request, so their
    count is not known at lower time).  Padding into a bucket is inert —
    the DeviceGraph/pair padding invariants guarantee results identical
    to exact shapes — so the only effect of a coarser schedule is fewer
    distinct compiled executables.
    """

    max_deg: int
    num_edges: int
    num_pairs: int | None = None
    schedule: str = "tight"

    def validate(self) -> "ShapeBucket":
        if self.max_deg < 1 or self.num_edges < 1:
            raise ValueError("ShapeBucket sizes must be >= 1")
        if self.num_pairs is not None and self.num_pairs < 1:
            raise ValueError("ShapeBucket num_pairs must be None or >= 1")
        bucket_round(1, self.schedule, 1)    # schedule name check
        return self

    @classmethod
    def of(cls, g, schedule: str = "tight",
           num_pairs: int | None = None) -> "ShapeBucket":
        """The bucket a graph pads into under ``schedule``."""
        import numpy as np
        deg = int(np.diff(g.xadj).max(initial=0))
        return cls(
            max_deg=bucket_round(deg, schedule, _DEG_BASE),
            num_edges=bucket_round(g.num_edges, schedule, _EDGE_BASE),
            num_pairs=(None if num_pairs is None else
                       bucket_round(num_pairs, schedule, _PAIR_BASE)),
            schedule=schedule)

    def admits(self, g) -> bool:
        """Whether the graph fits this bucket's padded shapes."""
        import numpy as np
        return (int(np.diff(g.xadj).max(initial=0)) <= self.max_deg
                and g.num_edges <= self.num_edges)

    def union(self, other: "ShapeBucket") -> "ShapeBucket":
        """Elementwise-max bucket admitting everything both admit."""
        pairs = (None if self.num_pairs is None or other.num_pairs is None
                 else max(self.num_pairs, other.num_pairs))
        return ShapeBucket(max(self.max_deg, other.max_deg),
                           max(self.num_edges, other.num_edges),
                           pairs, self.schedule)

    def pair_pad(self, n_pairs: int) -> int:
        """Padded pair-array length for a request with ``n_pairs``
        candidates: the fixed P when set, else the schedule's rounding."""
        if self.num_pairs is not None:
            if n_pairs > self.num_pairs:
                raise ValueError(f"{n_pairs} candidate pairs exceed the "
                                 f"plan bucket's num_pairs="
                                 f"{self.num_pairs}")
            return self.num_pairs
        return bucket_round(n_pairs, self.schedule, _PAIR_BASE)

    def tag(self) -> str:
        p = "dyn" if self.num_pairs is None else str(self.num_pairs)
        return f"K{self.max_deg}:E{self.num_edges}:P{p}"

    def to_dict(self) -> dict:
        return {"max_deg": self.max_deg, "num_edges": self.num_edges,
                "num_pairs": self.num_pairs, "schedule": self.schedule}

    @classmethod
    def from_dict(cls, d: dict) -> "ShapeBucket":
        known = {"max_deg", "num_edges", "num_pairs", "schedule"}
        unknown = sorted(set(d) - known)
        if unknown:
            raise ValueError(f"unknown ShapeBucket keys {unknown}; "
                             f"known keys: {sorted(known)}")
        return cls(max_deg=d["max_deg"], num_edges=d["num_edges"],
                   num_pairs=d.get("num_pairs"),
                   schedule=d.get("schedule", "tight"))


# --preconfiguration → V-cycle knobs: (levels, coarsen_min).  The same
# flag that tunes the internal partitioner (seed trials, FM passes) and
# the device engine's sweep budget also scales the multilevel pyramid —
# one flag, coherent partition/engine/multilevel settings.
_ML_PRECONF = {
    "fast": (2, 128),
    "eco": (4, 64),
    "strong": (6, 32),
}


@dataclass(frozen=True)
class MultilevelSpec:
    """V-cycle knobs for the multilevel mapping subsystem
    (:mod:`repro_torch.multilevel`).

    ``levels`` is the maximum number of graph scales including the finest
    (1 = no coarsening: the parity escape hatch — bit-for-bit the flat
    device engine); ``coarsen_min`` stops contraction once the coarse
    level would drop below that many vertices.  Fields left ``None``
    resolve from the spec's ``preconfiguration``
    (fast → (2, 128), eco → (4, 64), strong → (6, 32)).
    """

    levels: int | None = None
    coarsen_min: int | None = None

    def validate(self) -> "MultilevelSpec":
        if self.levels is not None and self.levels < 1:
            raise ValueError("multilevel levels must be None or >= 1")
        if self.coarsen_min is not None and self.coarsen_min < 2:
            raise ValueError("multilevel coarsen_min must be None or >= 2")
        return self

    def resolve(self, preconfiguration: str) -> tuple[int, int]:
        """Concrete ``(levels, coarsen_min)`` for a preconfiguration."""
        d_levels, d_cmin = _ML_PRECONF.get(preconfiguration,
                                           _ML_PRECONF["eco"])
        return (self.levels if self.levels is not None else d_levels,
                self.coarsen_min if self.coarsen_min is not None
                else d_cmin)

    def to_dict(self) -> dict:
        return {"levels": self.levels, "coarsen_min": self.coarsen_min}

    @classmethod
    def from_dict(cls, d: dict) -> "MultilevelSpec":
        known = {"levels", "coarsen_min"}
        unknown = sorted(set(d) - known)
        if unknown:
            raise ValueError(f"unknown MultilevelSpec keys {unknown}; "
                             f"known keys: {sorted(known)}")
        return cls(levels=d.get("levels"), coarsen_min=d.get("coarsen_min"))


@dataclass(frozen=True)
class PortfolioSpec:
    """Knobs for the device-side portfolio search (parsed and
    serialized; lowering raises ``NotImplementedError`` until ROADMAP
    queue 1, item 3 lands): ``lanes`` restart trajectories run as ONE
    vmapped engine call per level, then ``rounds - 1`` perturb→refine
    rounds at the finest level with device-side tournament selection of
    the incumbent.

    ``tabu_tenure`` sweeps of tabu memory per applied exchange (0 turns
    the tabu masking off — bit-for-bit the monotone sweep);
    ``dont_look`` enables the don't-look bits (only active alongside a
    nonzero tenure); ``kick_strength`` is the fraction of vertices each
    between-round perturbation kick touches; ``stagnation`` stops the
    round loop after that many rounds without improving the incumbent.
    ``constructions`` optionally names a per-lane construction portfolio
    (cycled across lanes); ``None`` seeds every lane from the spec's one
    ``construction`` with per-lane seeds.

    ``lanes=1`` with ``rounds=1`` and ``tabu_tenure=0`` is the
    degeneracy escape hatch: bit-for-bit the non-portfolio pipeline.
    """

    lanes: int = 8
    rounds: int = 4
    tabu_tenure: int = 8
    kick_strength: float = 0.15
    stagnation: int = 3
    dont_look: bool = True
    constructions: tuple | None = None

    def __post_init__(self):
        if isinstance(self.constructions, list):
            object.__setattr__(self, "constructions",
                               tuple(self.constructions))

    def validate(self) -> "PortfolioSpec":
        from .construction import resolve_construction
        if self.lanes < 1:
            raise ValueError("portfolio lanes must be >= 1")
        if self.rounds < 1:
            raise ValueError("portfolio rounds must be >= 1")
        if self.tabu_tenure < 0:
            raise ValueError("portfolio tabu_tenure must be >= 0")
        if not 0.0 <= self.kick_strength <= 1.0:
            raise ValueError("portfolio kick_strength must be in [0, 1]")
        if self.stagnation < 1:
            raise ValueError("portfolio stagnation must be >= 1")
        if self.constructions is not None:
            if not self.constructions:
                raise ValueError("portfolio constructions must be None "
                                 "or a non-empty sequence of names")
            for name in self.constructions:
                resolve_construction(name)
        return self

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        if self.constructions is not None:
            d["constructions"] = list(self.constructions)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "PortfolioSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - known)
        if unknown:
            raise ValueError(f"unknown PortfolioSpec keys {unknown}; "
                             f"known keys: {sorted(known)}")
        return cls(**d)

    def replace(self, **changes) -> "PortfolioSpec":
        return dataclasses.replace(self, **changes)


@dataclass(frozen=True)
class KernelSpec:
    """User-facing kernel-geometry overrides (all optional — the plan
    derives concrete :class:`~repro_torch.kernels.config.KernelConfig` values
    from its :class:`ShapeBucket` and the device at ``lower`` time;
    anything set here wins over derivation).

    ``block_rows``/``lanes`` pin the reduction-tile geometry (lanes must
    be a multiple of 128); ``acc_dtype`` pins the tiled-reduction
    accumulator; ``quantize`` controls the matrix-topology distance-table
    packing: ``"auto"`` (the default) packs to int8/int16 when lossless,
    ``"off"`` keeps float32 tables, and an explicit ``"int8"``/``"int16"``
    forces that width (raising at lower time if the table does not fit —
    a forced packing must never silently change results).
    """

    block_rows: int | None = None
    lanes: int | None = None
    acc_dtype: str | None = None
    quantize: str = "auto"

    def validate(self) -> "KernelSpec":
        if self.block_rows is not None and self.block_rows < 1:
            raise ValueError("kernel block_rows must be None or >= 1")
        if self.lanes is not None and (self.lanes < 128 or self.lanes % 128):
            raise ValueError("kernel lanes must be None or a positive "
                             "multiple of 128")
        if self.acc_dtype not in (None, "float32", "float64"):
            raise ValueError(f"unknown kernel acc_dtype "
                             f"{self.acc_dtype!r}; choose None, "
                             f"'float32', or 'float64'")
        if self.quantize not in ("auto", "off", "int8", "int16"):
            raise ValueError(f"unknown kernel quantize mode "
                             f"{self.quantize!r}; choose from "
                             f"['auto', 'off', 'int8', 'int16']")
        return self

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "KernelSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - known)
        if unknown:
            raise ValueError(f"unknown KernelSpec keys {unknown}; "
                             f"known keys: {sorted(known)}")
        return cls(**d)

    def replace(self, **changes) -> "KernelSpec":
        return dataclasses.replace(self, **changes)


@dataclass(frozen=True)
class MappingSpec:
    """Declarative description of one mapping computation (guide §4.1).

    ``neighborhood=None`` skips local search (construction only).
    ``parallel_sweeps`` selects the batched sweep over the paper's
    sequential search.  ``engine`` selects where the refinement loop
    runs: ``"host"`` (the numpy drivers of
    :mod:`repro_torch.core.local_search`) or ``"device"`` (the
    :mod:`repro_torch.engine` sweep loop —
    graph, perm, pairs, and objective stay in device tensors; implies
    the batched-sweep semantics, so ``parallel_sweeps`` is moot with it).
    ``backend`` selects how standalone objective evaluations are computed:
    ``"numpy"`` (host, float64 — bit-identical to the legacy pre-session
    path) or ``"pallas"`` — the serialized name is kept so spec dicts
    round-trip with the JAX package; in this port it selects the
    hand-written CUDA edge-list objective kernel
    (:mod:`repro_torch.kernels.qap_objective`), bound at ``lower`` time
    and carried by the :class:`MappingPlan`, and the dense gain-matrix
    kernel (:mod:`repro_torch.kernels.swap_gain`) for ``gain_matrix``.
    ``max_sweeps=None`` keeps each search driver's own default budget
    (for the device engine the budget then follows ``preconfiguration``:
    fast 32, eco 64, strong 128 sweeps).  ``multilevel`` enables the
    coarsen → map → uncoarsen V-cycle over the device engine
    (:mod:`repro_torch.multilevel`); ``None`` (the default) keeps the flat
    single-level pipeline, and ``MultilevelSpec(levels=1)`` is
    bit-for-bit identical to it.  ``portfolio`` enables the vmapped
    multistart search with tabu memory (not ported yet); ``None``
    keeps the single-trajectory pipeline, and
    ``PortfolioSpec(lanes=1, rounds=1, tabu_tenure=0)`` is bit-for-bit
    identical to it.
    """

    construction: str = "hierarchytopdown"
    neighborhood: str | None = "communication"
    neighborhood_dist: int = 10
    preconfiguration: str = "eco"
    parallel_sweeps: bool = False
    engine: str = "host"
    backend: str = "numpy"
    seed: int = 0
    max_sweeps: int | None = None
    max_pairs: int = 2_000_000
    topology: TopologySpec | None = None
    multilevel: MultilevelSpec | None = None
    portfolio: PortfolioSpec | None = None
    kernel: KernelSpec | None = None

    def __post_init__(self):
        if self.neighborhood in _NONE_ALIASES:
            object.__setattr__(self, "neighborhood", None)
        if isinstance(self.topology, dict):
            object.__setattr__(self, "topology",
                               TopologySpec.from_dict(self.topology))
        if isinstance(self.multilevel, dict):
            object.__setattr__(self, "multilevel",
                               MultilevelSpec.from_dict(self.multilevel))
        if isinstance(self.portfolio, dict):
            object.__setattr__(self, "portfolio",
                               PortfolioSpec.from_dict(self.portfolio))
        if isinstance(self.kernel, dict):
            object.__setattr__(self, "kernel",
                               KernelSpec.from_dict(self.kernel))

    # ------------------------------------------------------------ validation
    def validate(self) -> "MappingSpec":
        """Resolve every algorithm name against its registry; raise
        ``ValueError`` naming the offender (and what *is* registered)."""
        from .construction import resolve_construction
        from .local_search import resolve_neighborhood
        from .partition import PartitionConfig

        resolve_construction(self.construction)
        if self.neighborhood is not None:
            resolve_neighborhood(self.neighborhood)
        PartitionConfig.preconfiguration(self.preconfiguration)
        if self.backend not in ("numpy", "pallas"):
            raise ValueError(f"unknown backend {self.backend!r}; "
                             f"choose from ['numpy', 'pallas']")
        if self.engine not in ("host", "device"):
            raise ValueError(f"unknown engine {self.engine!r}; "
                             f"choose from ['host', 'device']")
        if self.neighborhood_dist < 1:
            raise ValueError("neighborhood_dist must be >= 1")
        if self.max_pairs < 1:
            raise ValueError("max_pairs must be >= 1")
        if self.max_sweeps is not None and self.max_sweeps < 0:
            raise ValueError("max_sweeps must be None or >= 0")
        if self.topology is not None:
            self.topology.validate()
        if self.multilevel is not None:
            self.multilevel.validate()
            if self.engine != "device" and \
                    self.multilevel.resolve(self.preconfiguration)[0] > 1:
                raise ValueError(
                    "multilevel mapping runs the device refinement "
                    "engine at every level; set engine='device' "
                    "(or pass --engine=device)")
        if self.portfolio is not None:
            self.portfolio.validate()
            if self.engine != "device":
                raise ValueError(
                    "portfolio search runs the vmapped device refinement "
                    "engine; set engine='device' (or pass --engine=device)")
        if self.kernel is not None:
            self.kernel.validate()
        return self

    # ------------------------------------------------------- dict/json forms
    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        if self.topology is not None:
            d["topology"] = self.topology.to_dict()
        if self.multilevel is not None:
            d["multilevel"] = self.multilevel.to_dict()
        if self.portfolio is not None:
            d["portfolio"] = self.portfolio.to_dict()
        if self.kernel is not None:
            d["kernel"] = self.kernel.to_dict()
        return d

    # -------------------------------------------------------- resolution
    def resolved_multilevel(self) -> "tuple[int, int] | None":
        """Concrete V-cycle knobs ``(levels, coarsen_min)``, or ``None``
        when the spec maps flat (no multilevel block, or an escape-hatch
        ``levels=1``)."""
        if self.multilevel is None:
            return None
        levels, cmin = self.multilevel.resolve(self.preconfiguration)
        return None if levels <= 1 else (levels, cmin)

    @classmethod
    def from_dict(cls, d: dict) -> "MappingSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - known)
        if unknown:
            raise ValueError(f"unknown MappingSpec keys {unknown}; "
                             f"known keys: {sorted(known)}")
        return cls(**d)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "MappingSpec":
        return cls.from_dict(json.loads(text))

    # -------------------------------------------------------------- flags
    #  legacy guide flag            -> spec field
    _FLAG_FIELDS = (
        ("construction_algorithm", "construction"),
        ("local_search_neighborhood", "neighborhood"),
        ("communication_neighborhood_dist", "neighborhood_dist"),
        ("preconfiguration_mapping", "preconfiguration"),
        ("parallel_sweeps", "parallel_sweeps"),
        ("engine", "engine"),
        ("backend", "backend"),
        ("seed", "seed"),
    )

    @classmethod
    def from_flags(cls, args, base: "MappingSpec | None" = None
                   ) -> "MappingSpec":
        """Build a spec from an ``argparse`` namespace using the guide's
        §4.1 flag names.  Flags left at ``None`` fall back to ``base``
        (e.g. a spec loaded from ``--config``), so explicit flags override
        a config file."""
        spec = base or cls()
        overrides = {}
        for flag, field in cls._FLAG_FIELDS:
            val = getattr(args, flag, None)
            if val is not None:
                overrides[field] = val
        ml_on = getattr(args, "multilevel", None)
        ml_levels = getattr(args, "multilevel_levels", None)
        ml_cmin = getattr(args, "multilevel_coarsen_min", None)
        if ml_on is False:
            overrides["multilevel"] = None           # --no-multilevel
        elif ml_on or ml_levels is not None or ml_cmin is not None:
            ml = spec.multilevel or MultilevelSpec()
            if ml_levels is not None or ml_cmin is not None:
                ml = dataclasses.replace(
                    ml,
                    levels=ml_levels if ml_levels is not None else ml.levels,
                    coarsen_min=(ml_cmin if ml_cmin is not None
                                 else ml.coarsen_min))
            overrides["multilevel"] = ml
            # the V-cycle runs over the device engine; an explicit
            # --engine still wins (validate() rejects host + multilevel)
            if getattr(args, "engine", None) is None and \
                    spec.engine == "host":
                overrides["engine"] = "device"
        pf_on = getattr(args, "portfolio", None)
        pf_flags = {
            "lanes": getattr(args, "portfolio_lanes", None),
            "rounds": getattr(args, "portfolio_rounds", None),
            "tabu_tenure": getattr(args, "portfolio_tabu_tenure", None),
            "kick_strength": getattr(args, "portfolio_kick", None),
            "stagnation": getattr(args, "portfolio_stagnation", None),
        }
        pf_set = {k: v for k, v in pf_flags.items() if v is not None}
        if pf_on is False:
            overrides["portfolio"] = None            # --no-portfolio
        elif pf_on or pf_set:
            pf = spec.portfolio or PortfolioSpec()
            if pf_set:
                pf = pf.replace(**pf_set)
            overrides["portfolio"] = pf
            # the portfolio runs over the device engine; an explicit
            # --engine still wins (validate() rejects host + portfolio)
            if getattr(args, "engine", None) is None and \
                    overrides.get("engine", spec.engine) == "host":
                overrides["engine"] = "device"
        kn_flags = {
            "block_rows": getattr(args, "kernel_block_rows", None),
            "lanes": getattr(args, "kernel_lanes", None),
            "quantize": getattr(args, "kernel_quantize", None),
        }
        kn_set = {k: v for k, v in kn_flags.items() if v is not None}
        if kn_set:
            kn = spec.kernel or KernelSpec()
            overrides["kernel"] = kn.replace(**kn_set)
        return spec.replace(**overrides) if overrides else spec

    def replace(self, **changes) -> "MappingSpec":
        return dataclasses.replace(self, **changes)


@dataclass(frozen=True)
class PlanSpec:
    """The serializable identity of a :class:`~repro_torch.core.plan.MappingPlan`:
    the full :class:`MappingSpec` (machine model included as its
    :class:`TopologySpec`) plus the :class:`ShapeBucket` the plan was
    lowered for.  ``MappingPlan.from_dict`` / ``.load`` rebuild the live
    plan — topology, level pyramid machines, kernels, refinement
    engines — from this spec alone, which is what makes plans
    pickle/JSON-portable across processes.
    """

    mapping: MappingSpec
    bucket: ShapeBucket | None = None

    def __post_init__(self):
        if isinstance(self.mapping, dict):
            object.__setattr__(self, "mapping",
                               MappingSpec.from_dict(self.mapping))
        if isinstance(self.bucket, dict):
            object.__setattr__(self, "bucket",
                               ShapeBucket.from_dict(self.bucket))

    def validate(self) -> "PlanSpec":
        self.mapping.validate()
        if self.mapping.topology is None:
            raise ValueError(
                "PlanSpec needs the machine model inside the MappingSpec "
                "(spec.topology) so the plan can be rebuilt on load")
        if self.bucket is not None:
            self.bucket.validate()
        return self

    def to_dict(self) -> dict:
        return {"mapping": self.mapping.to_dict(),
                "bucket": None if self.bucket is None
                else self.bucket.to_dict()}

    @classmethod
    def from_dict(cls, d: dict) -> "PlanSpec":
        known = {"mapping", "bucket"}
        unknown = sorted(set(d) - known)
        if unknown:
            raise ValueError(f"unknown PlanSpec keys {unknown}; "
                             f"known keys: {sorted(known)}")
        return cls(mapping=d["mapping"], bucket=d.get("bucket"))

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "PlanSpec":
        return cls.from_dict(json.loads(text))
