"""Production mesh construction, VieM-optimized device placement for a
fleet, and its closed loop — the port's copy of the JAX package's
``launch/mesh.py``.

``make_production_mesh`` builds the logical mesh as a torch
``DeviceMesh``:
  single-pod: (data=16, model=16)            — 256 ranks
  multi-pod:  (pod=2, data=16, model=16)     — 512 ranks
over a process group of that many ranks (a real one on a fleet, the
``"fake"`` backend in the dry-run); importing this module touches no
process group.

``viem_device_order`` is the paper integrated as a launch feature: given a
compiled step's HLO text, or the port's own sharded step's collective
record (``launch.dryrun.CollectiveRecord``: ``--save-collectives``,
``load_collectives``), extract the logical-device traffic graph
(core.comm_model), model the physical fleet — either the paper-style tree
hierarchy (core.hierarchy.tpu_v5e_fleet) or the honest ICI model, a 2D
torus per pod (repro_torch.topology.tpu_v5e_torus) — and solve the sparse
QAP for the logical→physical assignment.  ``fleet_monitor`` maps once and
keeps watching (:mod:`repro_torch.monitor`).

Every function here takes ``device=``: ``"cuda"`` unless the caller asks
for ``"cpu"``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["fleet_model", "fleet_monitor", "make_production_mesh",
           "viem_device_order"]


def make_production_mesh(*, multi_pod: bool = False, devices=None,
                         device=None):
    """The production ``DeviceMesh``: (16, 16) over ("data", "model"), or
    (2, 16, 16) over ("pod", "data", "model").  ``devices`` is
    :func:`viem_device_order`'s order (``devices[i]`` the rank that
    logical device i uses), which becomes the mesh's rank layout; by
    default ranks are laid out in order.  Needs an initialised process
    group of 256 or 512 ranks; ``device`` is the mesh's device type,
    ``cuda`` unless the caller asks for ``cpu``."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from ..runtime.device import resolve_device
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = int(np.prod(shape))
    if not dist.is_initialized() or dist.get_world_size() != n:
        have = dist.get_world_size() if dist.is_initialized() else None
        raise RuntimeError(f"make_production_mesh: needs a process group "
                           f"of {n} ranks, have {have}")
    ranks = (torch.arange(n) if devices is None
             else torch.as_tensor(np.asarray(devices, dtype=np.int64)))
    if sorted(ranks.tolist()) != list(range(n)):
        raise ValueError(f"make_production_mesh: devices must order the "
                         f"{n} ranks")
    return DeviceMesh(resolve_device(device).type, ranks.reshape(shape),
                      mesh_dim_names=axes)


def fleet_model(machine_model: str = "tree", pods: int = 2):
    """The physical-fleet machine model by name: ``tree`` (the paper-style
    nested distance classes), ``torus`` (the honest per-pod 2D ICI torus
    with a DCN pod axis), or any registered topology name (built with its
    default parameters).  A live ``Topology``/``Hierarchy`` passes
    through."""
    if not isinstance(machine_model, str):
        return machine_model
    if machine_model == "tree":
        from ..core import tpu_v5e_fleet
        return tpu_v5e_fleet(pods=pods)
    if machine_model == "torus":
        from ..topology import tpu_v5e_torus
        return tpu_v5e_torus(pods=pods)
    from ..topology import make_topology
    return make_topology(machine_model)


def viem_device_order(program, n_devices: int, pods: int = 2,
                      preconfiguration: str = "eco",
                      neighborhood_dist: int = 10, seed: int = 0,
                      machine_model: str = "tree", device=None):
    """Logical→physical assignment minimizing modeled collective cost.

    ``program`` is HLO text or a collective record (anything
    ``core.comm_model.device_comm_graph`` takes).  ``machine_model``
    selects the fleet model (see :func:`fleet_model`); the default stays
    the paper-style tree hierarchy.

    Returns (device_order, result): ``device_order[i]`` is the physical
    chip that logical device i should use — pass it to
    :func:`make_production_mesh` as ``devices``.
    """
    from ..core import Mapper, MappingSpec
    from ..core.comm_model import device_comm_graph

    g = device_comm_graph(program, n_devices)
    h = fleet_model(machine_model, pods=pods)
    if h.n_pe != n_devices:
        raise ValueError(f"fleet has {h.n_pe} PEs but program uses "
                         f"{n_devices} devices")
    spec = MappingSpec(construction="hierarchytopdown",
                       neighborhood="communication",
                       neighborhood_dist=neighborhood_dist,
                       preconfiguration=preconfiguration, seed=seed)
    res = Mapper(h, spec, device=device).map(g)
    # res.perm[logical] = physical  →  device_order[logical] = physical
    return np.asarray(res.perm, dtype=np.int64), res


def fleet_monitor(program, n_devices: int, pods: int = 2,
                  preconfiguration: str = "eco",
                  neighborhood_dist: int = 10, seed: int = 0,
                  machine_model: str = "tree", config=None,
                  cost=None, registry=None, on_remap=None, device=None):
    """Closed-loop counterpart of :func:`viem_device_order`: map once,
    then keep watching.  ``program`` is HLO text or a collective record.

    Builds a :class:`~repro_torch.monitor.RemapMonitor` whose incumbent
    is the initial VieM device order for this program, lowered with
    ``pow2`` bucket headroom so drifted traffic keeps fitting the plan's
    padded shapes.  Feed it windows (``observe_hlo`` on recompiles,
    ``observe_edges`` from transport counters), ``tick()`` per window,
    and ``attach(straggler_monitor)`` so ``REBALANCE`` signals flow
    through the same replay gate.  Committed remaps invoke
    ``on_remap(device_order, verdict)`` — rebuild the mesh with
    ``make_production_mesh(devices=device_order)``.

    Returns ``(monitor, device_order)``.
    """
    from ..core import Mapper, MappingSpec
    from ..core.comm_model import device_comm_graph
    from ..monitor import MonitorConfig, RemapMonitor

    g = device_comm_graph(program, n_devices)
    h = fleet_model(machine_model, pods=pods)
    if h.n_pe != n_devices:
        raise ValueError(f"fleet has {h.n_pe} PEs but program uses "
                         f"{n_devices} devices")
    spec = MappingSpec(construction="hierarchytopdown",
                       neighborhood="communication",
                       neighborhood_dist=neighborhood_dist,
                       preconfiguration=preconfiguration, seed=seed,
                       engine="device")
    plan = Mapper(h, spec, device=device).lower_for(g, schedule="pow2")
    monitor = RemapMonitor(plan, g,
                           config=config or MonitorConfig(),
                           cost=cost, registry=registry,
                           on_remap=on_remap, seed=seed)
    return monitor, monitor.incumbent.copy()
