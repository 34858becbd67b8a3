"""VieM core of the PyTorch/CUDA port: the staged mapping API over the
flat and multilevel pipelines (device or host search), batches, warm
starts and the dense gain matrix.

    from repro_torch.core import Hierarchy, Mapper, MappingSpec, grid3d

    h = Hierarchy.from_strings("4:16:64", "1:10:100")
    spec = MappingSpec(engine="device", backend="pallas")
    result = Mapper(h, spec).map(grid3d(16, 16, 16))   # on cuda
    result = Mapper(h, spec, device="cpu").map(g)      # plain versions

Modules (the host ones are copies of the JAX package's, so both packages
construct the same permutations and candidate pairs):
  spec         — MappingSpec/PlanSpec/ShapeBucket, the JAX package's dict
                 and JSON forms
  plan         — MappingPlan: the lowered artifact + execute hot path
  mapping      — Mapper sessions (one LRU plan cache, one engine pool),
                 the MapperService request queue
  pinned       — the port's own page-locked host blocks (the gain call's
                 readback), with their counts
  graph        — CSR communication graphs, Metis IO, generators, and the
                 torch DeviceGraph / device_pairs
  hierarchy    — hierarchical topologies + cached online distance oracle
  objective    — the host float64 QAP objective, sparse swap gains and the
                 dense gain matrix
  partition    — multilevel perfectly-balanced partitioner
  construction — registered constructions
  local_search — SearchStats, the registered neighborhoods and the host
                 search drivers
  comm_model   — traffic graphs from HLO text, the guide's generate_model,
                 per-level traffic of a mapping
"""

from .construction import list_constructions, register_construction
from .graph import CommGraph, DeviceGraph, GraphFormatError, device_pairs, \
    from_dense, from_edges, grid3d, random_geometric, read_metis, validate, \
    write_metis
from .hierarchy import DistanceOracle, Hierarchy, supermuc_like, \
    tpu_v5e_fleet
from .local_search import list_neighborhoods, register_neighborhood
from .mapping import Mapper, MapperService
from .objective import dense_gain_matrix, qap_objective, \
    qap_objective_dense, swap_gain
from .plan import MappingPlan, MappingResult
from .spec import MappingSpec, MultilevelSpec, PlanSpec, ShapeBucket, \
    TopologySpec

__all__ = [
    "CommGraph", "DeviceGraph", "GraphFormatError", "device_pairs",
    "from_dense", "from_edges", "grid3d",
    "random_geometric", "read_metis", "validate", "write_metis",
    "DistanceOracle", "Hierarchy", "supermuc_like", "tpu_v5e_fleet",
    "Mapper", "MapperService", "MappingPlan", "MappingResult",
    "MappingSpec", "MultilevelSpec", "PlanSpec", "ShapeBucket",
    "TopologySpec",
    "list_constructions", "register_construction",
    "list_neighborhoods", "register_neighborhood",
    "dense_gain_matrix", "qap_objective", "qap_objective_dense", "swap_gain",
]
