"""Counters, gauges, and histograms behind one registry lock — the port's
copy of the JAX package's ``obs/metrics.py``.

:class:`MetricsRegistry` is the store the closed remapping loop
(:mod:`repro_torch.monitor`) and ``viem --metrics-out`` write into.  Two
guarantees:

* **Atomic multi-metric updates** — every metric holds the registry's
  re-entrant lock while mutating, and call sites that must update
  several metrics as one observable step (e.g. ``served`` + the latency
  histogram) take ``registry.lock`` around the group.  ``snapshot()``
  acquires the same lock, so a monitoring thread can never read a
  half-applied update.
* **Snapshots are deep copies** — ``snapshot()`` returns fresh dicts and
  scalars only; mutating a snapshot (or the registry afterwards) never
  leaks into a previously returned one.

Histograms keep a bounded sliding window (deque) for percentiles — the
recent-window semantics — plus
monotone ``count``/``sum`` over the full lifetime.
"""

from __future__ import annotations

import threading
from collections import deque

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "parse_prometheus"]


class Counter:
    """Monotone counter."""

    def __init__(self, lock: threading.RLock):
        self._lock = lock
        self.value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n

    def snapshot(self):
        with self._lock:
            return self.value

    def reset(self) -> None:
        with self._lock:
            self.value = 0


class Gauge:
    """Last-value gauge with a high-water helper (``set_max``)."""

    def __init__(self, lock: threading.RLock):
        self._lock = lock
        self.value = 0.0

    def set(self, v) -> None:
        with self._lock:
            self.value = v

    def set_max(self, v) -> None:
        with self._lock:
            if v > self.value:
                self.value = v

    def snapshot(self):
        with self._lock:
            return self.value

    def reset(self) -> None:
        with self._lock:
            self.value = 0.0


class Histogram:
    """Lifetime ``count``/``sum``/``min``/``max`` plus a bounded sliding
    window for percentiles (recent behavior, not the first N forever)."""

    def __init__(self, lock: threading.RLock, window: int = 65536):
        self._lock = lock
        self.window = int(window)
        self.reset()

    def reset(self) -> None:
        # RLock: re-enters cleanly from __init__ and registry holders
        with self._lock:
            self.count = 0
            self.total = 0.0
            self.min = None
            self.max = None
            self._recent: deque = deque(maxlen=self.window)

    def observe(self, v: float) -> None:
        with self._lock:
            self.count += 1
            self.total += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)
            self._recent.append(v)

    def percentile(self, q: float) -> float:
        with self._lock:
            lat = sorted(self._recent)
        if not lat:
            return 0.0
        return lat[min(len(lat) - 1, int(q * len(lat)))]

    def snapshot(self) -> dict:
        # one lock scope: count/sum/min/max and the percentile window
        # come from the same instant (and sorted(_recent) must not race
        # a concurrent observe() append)
        with self._lock:
            return {
                "count": self.count, "sum": self.total,
                "min": 0.0 if self.min is None else self.min,
                "max": 0.0 if self.max is None else self.max,
                "mean": self.total / self.count if self.count else 0.0,
                "p50": self._pct_locked(0.50),
                "p99": self._pct_locked(0.99),
                "window": len(self._recent),
            }

    def _pct_locked(self, q: float) -> float:
        # callers already hold the registry lock (snapshot path)
        lat = sorted(self._recent)
        if not lat:
            return 0.0
        return lat[min(len(lat) - 1, int(q * len(lat)))]


class MetricsRegistry:
    """Named metric store (see module docstring).  Metrics are created
    on first access (``counter``/``gauge``/``histogram``) and live for
    the registry's lifetime; ``reset()`` zeroes values but keeps the
    registrations."""

    def __init__(self):
        self.lock = threading.RLock()
        self._metrics: dict = {}

    def _get(self, name: str, kind, **kw):
        with self.lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = kind(self.lock, **kw)
            elif not isinstance(m, kind):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{type(m).__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, window: int = 65536) -> Histogram:
        return self._get(name, Histogram, window=window)

    def snapshot(self) -> dict:
        """Deep-copied point-in-time view: ``{name: value-or-dict}``,
        taken atomically under the registry lock."""
        with self.lock:
            return {name: m.snapshot()
                    for name, m in sorted(self._metrics.items())}

    def reset(self) -> None:
        """Zero every metric atomically (registrations survive)."""
        with self.lock:
            for m in self._metrics.values():
                m.reset()

    def to_prometheus(self, prefix: str = "viem_") -> str:
        """Prometheus text exposition (one atomic snapshot).

        Counters/gauges map 1:1; histograms expose as summaries
        (``_count``/``_sum`` plus p50/p99 quantile samples from the
        sliding window).  Metric names sanitize dots to underscores
        under ``prefix`` — ``monitor.drift.score`` scrapes as
        ``viem_monitor_drift_score``.  Round-trips through
        :func:`parse_prometheus`.
        """
        with self.lock:
            metrics = sorted(self._metrics.items())
            lines: list[str] = []
            for name, m in metrics:
                pname = prefix + name.replace(".", "_").replace("-", "_")
                if isinstance(m, Counter):
                    lines.append(f"# TYPE {pname} counter")
                    lines.append(f"{pname} {m.snapshot()}")
                elif isinstance(m, Gauge):
                    lines.append(f"# TYPE {pname} gauge")
                    lines.append(f"{pname} {m.snapshot()}")
                else:
                    snap = m.snapshot()
                    lines.append(f"# TYPE {pname} summary")
                    lines.append(f'{pname}{{quantile="0.5"}} '
                                 f'{snap["p50"]}')
                    lines.append(f'{pname}{{quantile="0.99"}} '
                                 f'{snap["p99"]}')
                    lines.append(f"{pname}_count {snap['count']}")
                    lines.append(f"{pname}_sum {snap['sum']}")
        return "\n".join(lines) + ("\n" if lines else "")


def parse_prometheus(text: str) -> dict:
    """Parse the subset of the Prometheus text format
    :meth:`MetricsRegistry.to_prometheus` emits, back into
    ``{name: {"type": ..., "samples": {label-or-"": value}}}`` — the
    round-trip check scrapers rely on."""
    out: dict = {}
    types: dict = {}
    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
            continue
        name_part, value = line.rsplit(" ", 1)
        if "{" in name_part:
            name, labels = name_part.split("{", 1)
            labels = labels.rstrip("}")
        else:
            name, labels = name_part, ""
        base = name
        for suffix in ("_count", "_sum"):
            if name.endswith(suffix) and name[:-len(suffix)] in types:
                base = name[:-len(suffix)]
                labels = suffix[1:]
                break
        entry = out.setdefault(base, {"type": types.get(base, "untyped"),
                                      "samples": {}})
        entry["samples"][labels] = float(value)
    return out
