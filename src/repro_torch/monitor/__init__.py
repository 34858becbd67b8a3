"""Closed-loop remapping: live traffic profiling → drift detection →
what-if replay → incremental remap — the port's copy of the JAX
package's ``monitor`` package, over a port plan (whose warm remaps run
K1 and K2 on the card).

The guide's premise is that the communication graph of a running
program should drive its process-to-PE mapping; this package keeps
driving it *after* launch.  Four stages, each independently usable:

* :class:`TrafficProfiler` (:mod:`.profiler`) — windowed ingestion of
  live traffic (compiled HLO via :func:`~repro_torch.core.comm_model.
  device_comm_graph`, recorded spans, or raw edge observations) into an
  EMA-smoothed live :class:`~repro_torch.core.graph.CommGraph` per window,
  published as gauges/histograms in a
  :class:`~repro_torch.obs.MetricsRegistry`.
* :class:`DriftDetector` (:mod:`.drift`) — scores divergence between
  the live graph and the baseline the incumbent plan was lowered for
  (normalized edge-weight L1 plus objective-under-incumbent delta) with
  hysteresis (trigger high-watermark, re-arm low-watermark, patience)
  so jitter never triggers remaps.
* :class:`WhatIfReplay` (:mod:`.replay`) — predicts step-time under a
  candidate mapping with the roofline/comm model *before* committing,
  and accepts only if the predicted improvement clears a configurable
  margin.  Every verdict is a span + counters, exportable to the
  existing Perfetto trace.
* :class:`RemapMonitor` (:mod:`.loop`) — the loop: profile → detect →
  incremental warm remap of only the dirty region (an inert-pair
  runtime mask on the plan's fixed candidate set —
  ``MappingPlan.execute_warm`` — masking, the pair shape fixed) → replay
  gate → commit or roll back.  ``handle_action`` consumes
  :class:`~repro_torch.runtime.fault_tolerance.Action` signals so straggler
  ``REBALANCE``/eviction flows through the same accept/reject gate.
"""

from .drift import DriftDetector, DriftScore, edge_weight_l1
from .loop import MonitorConfig, RemapMonitor, TickReport
from .profiler import TrafficProfiler
from .remap import dirty_pair_mask, dirty_vertices, expand_dirty
from .replay import ReplayVerdict, WhatIfReplay

__all__ = [
    "DriftDetector", "DriftScore", "edge_weight_l1",
    "MonitorConfig", "RemapMonitor", "TickReport",
    "TrafficProfiler",
    "dirty_pair_mask", "dirty_vertices", "expand_dirty",
    "ReplayVerdict", "WhatIfReplay",
]
