"""Observability of the port: engine telemetry, tracing spans, the
metrics registry and the exporters.

* :mod:`.telemetry` — :class:`EngineTelemetry`, the host-facing view of
  the counters the sweep loop (:mod:`repro_torch.engine.sweep`) keeps:
  gain passes, exchanges applied per sweep, tabu-masked pairs,
  aspiration fires, downhill escapes, matching rounds and the objective
  trajectory.  Collection is a runtime toggle (``telemetry=True`` on
  ``refine``/``execute``/``map``) and never changes the search.
* :mod:`.trace` — :class:`Span`/:class:`Tracer`, the context-manager
  tracing API with a bounded ring buffer; spans always measure
  wall-time and are recorded only when the tracer is enabled.
* :mod:`.export` / :mod:`.metrics` — ``write_chrome_trace`` (Perfetto /
  ``chrome://tracing`` ``trace_event`` JSON, per-sweep engine counters
  as counter tracks), ``write_jsonl`` and ``span_breakdown``;
  :class:`MetricsRegistry` (counters, gauges and histograms behind one
  lock, deep-copied snapshots, Prometheus text) and
  ``parse_prometheus``.

All are copies of the JAX package's ``obs`` modules.  Surfaces: ``viem
--profile out.trace.json`` / ``--metrics-out`` / ``--telemetry`` and
``viem remap-watch``.
"""

from .export import (chrome_trace_events, span_breakdown,
                     write_chrome_trace, write_jsonl)
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      parse_prometheus)
from .telemetry import EngineTelemetry
from .trace import Span, Tracer, get_tracer, traced

__all__ = [
    "Counter", "EngineTelemetry", "Gauge", "Histogram", "MetricsRegistry",
    "Span", "Tracer", "chrome_trace_events", "get_tracer",
    "parse_prometheus", "span_breakdown", "traced", "write_chrome_trace",
    "write_jsonl",
]
