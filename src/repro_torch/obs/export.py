"""Exporters: Chrome ``trace_event`` JSON, JSON-lines, and span
aggregation.

``write_chrome_trace`` emits the JSON-object flavor of the Trace Event
Format (``{"traceEvents": [...]}``) that Perfetto and
``chrome://tracing`` load directly: every span becomes a complete
(``ph: "X"``) event on its thread's track, and spans carrying an
:class:`~repro_torch.obs.telemetry.EngineTelemetry` in ``attrs["telemetry"]``
additionally emit per-sweep *counter* (``ph: "C"``) tracks — objective,
exchanges, tabu-masked pairs, aspiration fires — spread evenly across
the span's wall-clock window (the device loop has no host timestamps;
the spacing is presentational, the per-sweep values are exact).

``span_breakdown`` aggregates spans by name (count/total/mean/max
seconds) — the per-kernel-form timing block stamped into every
``BENCH_*.json``.

The port's copy of the JAX package's ``obs/export.py``; its
``sanitize_attrs`` lives in :mod:`.trace` (which ``Span.to_dict`` uses)
and is re-exported here.
"""

from __future__ import annotations

import json

from .trace import sanitize_attrs

__all__ = ["chrome_trace_events", "sanitize_attrs", "span_breakdown",
           "write_chrome_trace", "write_jsonl"]

# telemetry counter tracks: (track name, EngineTelemetry array field)
_COUNTER_TRACKS = (("engine/exchanges", "exchanges"),
                   ("engine/tabu_masked", "tabu_masked"),
                   ("engine/aspirations", "aspirations"),
                   ("engine/match_rounds", "match_rounds"))


def _counter_events(sp, ts: float, dur: float, pid: int) -> list:
    """Per-sweep counter tracks from a span's attached telemetry."""
    tel = sp.attrs.get("telemetry")
    if tel is None or getattr(tel, "passes", 0) <= 0:
        return []
    events = []
    step = dur / max(tel.passes, 1)
    for p in range(tel.passes):
        t = ts + (p + 0.5) * step
        for track, attr in _COUNTER_TRACKS:
            arr = getattr(tel, attr)
            if p < len(arr):
                events.append({"name": track, "ph": "C", "ts": t,
                               "pid": pid, "args": {"value": int(arr[p])}})
    trace = tel.objective_trace
    if len(trace):
        tstep = dur / max(len(trace) - 1, 1)
        for i, j in enumerate(trace):
            events.append({"name": "engine/objective", "ph": "C",
                           "ts": ts + i * tstep, "pid": pid,
                           "args": {"value": float(j)}})
    return events


def chrome_trace_events(spans, pid: int = 0) -> dict:
    """Trace Event Format JSON object for a span list (see module
    docstring)."""
    spans = list(spans)
    events = []
    t0 = min((sp.t0 for sp in spans), default=0.0)
    tids = {}
    for sp in spans:
        tid = tids.setdefault(sp.tid, len(tids))
        ts = (sp.t0 - t0) * 1e6
        dur = sp.dur * 1e6
        events.append({"name": sp.name, "cat": sp.cat or "viem",
                       "ph": "X", "ts": ts, "dur": dur,
                       "pid": pid, "tid": tid,
                       "args": sanitize_attrs(sp.attrs)})
        events.extend(_counter_events(sp, ts, dur, pid))
    meta = [{"name": "process_name", "ph": "M", "pid": pid,
             "args": {"name": "viem"}}]
    for ident, tid in tids.items():
        meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                     "tid": tid, "args": {"name": f"thread-{ident}"}})
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def write_chrome_trace(spans, path) -> int:
    """Write a Perfetto-loadable ``.trace.json``; returns the number of
    events written."""
    payload = chrome_trace_events(spans)
    with open(path, "w") as fh:
        json.dump(payload, fh)
    return len(payload["traceEvents"])


def write_jsonl(spans, path) -> int:
    """One JSON object per span (append-friendly event log)."""
    n = 0
    with open(path, "w") as fh:
        for sp in spans:
            fh.write(json.dumps(sp.to_dict()) + "\n")
            n += 1
    return n


def span_breakdown(spans) -> dict:
    """Aggregate spans by name: ``{name: {count, total_s, mean_s,
    max_s}}`` — the timing block the benchmark JSONs embed."""
    agg: dict = {}
    for sp in spans:
        a = agg.setdefault(sp.name, {"count": 0, "total_s": 0.0,
                                     "max_s": 0.0})
        a["count"] += 1
        a["total_s"] += sp.dur
        a["max_s"] = max(a["max_s"], sp.dur)
    for a in agg.values():
        a["mean_s"] = a["total_s"] / a["count"]
    return agg
