"""Observability of the port: engine telemetry and tracing spans.

* :mod:`.telemetry` — :class:`EngineTelemetry`, the host-facing view of
  the counters the sweep loop (:mod:`repro_torch.engine.sweep`) keeps:
  gain passes, exchanges applied per sweep, tabu-masked pairs,
  aspiration fires, downhill escapes, matching rounds and the objective
  trajectory.  Collection is a runtime toggle (``telemetry=True`` on
  ``refine``/``execute``/``map``) and never changes the search.
* :mod:`.trace` — :class:`Span`/:class:`Tracer`, the context-manager
  tracing API with a bounded ring buffer; spans always measure
  wall-time and are recorded only when the tracer is enabled.

Both are copies of the JAX package's ``obs`` modules; the exporters and
the metrics registry are not ported yet.
"""

from .telemetry import EngineTelemetry
from .trace import Span, Tracer, get_tracer, traced

__all__ = ["EngineTelemetry", "Span", "Tracer", "get_tracer", "traced"]
