"""Structured tracing spans: a context-manager/decorator API over a
bounded in-memory ring buffer — the port's copy of the JAX package's
``obs/trace.py`` (with ``sanitize_attrs`` from its ``obs/export.py``).

Design constraints, in order:

1. **The disabled path is the hot path.**  ``span()`` always measures
   wall-time — result accounting (``MappingResult.construction_seconds``
   etc.) reads ``span.dur`` whether or not tracing is on — but the span
   is only appended to the ring buffer when the tracer is enabled, so
   serving traffic pays one ``perf_counter`` pair per span, exactly what
   the ad-hoc timing it replaced cost.
2. **Bounded memory.**  The buffer is a ``deque(maxlen=capacity)``;
   long-lived services drop the *oldest* spans (``dropped`` counts them)
   instead of growing without bound.
3. **Thread-safe.**  Spans record the emitting thread; nesting depth is
   tracked per-thread, so a service worker's spans interleave cleanly
   with client-thread spans in the exported trace.

One process-global tracer (``get_tracer()``) is shared by every layer so
a single ``enable()`` captures lower/construct/refine/execute/tick spans
end to end; independent ``Tracer`` instances remain available for tests
and embedded use.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from functools import wraps

__all__ = ["Span", "Tracer", "get_tracer", "sanitize_attrs", "traced"]

_MAX_LIST = 512     # cap exported array attributes (ring buffer ≠ dump)


@dataclass
class Span:
    """One recorded operation: name, category, wall-clock window
    (``t0``/``dur`` in ``perf_counter`` seconds), emitting thread,
    per-thread nesting depth, and free-form attributes."""
    name: str
    cat: str = "viem"
    t0: float = 0.0
    dur: float = 0.0
    tid: int = 0
    depth: int = 0
    attrs: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {"name": self.name, "cat": self.cat, "t0": self.t0,
                "dur": self.dur, "tid": self.tid, "depth": self.depth,
                "attrs": sanitize_attrs(self.attrs)}


def sanitize_attrs(attrs: dict) -> dict:
    """JSON-safe view of span attributes: numpy scalars → Python,
    arrays → capped lists, telemetry objects → scalar summaries,
    everything else unknown → ``repr``."""
    import numpy as np
    out = {}
    for k, v in attrs.items():
        if hasattr(v, "summary") and callable(v.summary):   # telemetry
            out[k] = v.summary()
        elif isinstance(v, np.ndarray):
            out[k] = v[:_MAX_LIST].tolist()
        elif isinstance(v, (np.integer,)):
            out[k] = int(v)
        elif isinstance(v, (np.floating,)):
            out[k] = float(v)
        elif isinstance(v, (list, tuple)):
            out[k] = list(v)[:_MAX_LIST]
        elif v is None or isinstance(v, (bool, int, float, str, dict)):
            out[k] = v
        else:
            out[k] = repr(v)
    return out


class Tracer:
    """Span recorder with a bounded ring buffer (see module docstring).

    ``span(name, **attrs)`` is a context manager yielding the live
    :class:`Span` — callers may add attributes inside the block and read
    ``span.dur`` after it.  ``wrap(name)`` is the decorator form.
    """

    def __init__(self, capacity: int = 65536, enabled: bool = False):
        self.capacity = int(capacity)
        self.enabled = bool(enabled)
        self.dropped = 0
        self._buf: "deque[Span]" = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._local = threading.local()

    # ------------------------------------------------------------ control
    def enable(self, capacity: int | None = None) -> "Tracer":
        """Start recording (optionally resizing the ring buffer)."""
        if capacity is not None:
            # compare-and-resize under one lock scope: the bare-read
            # check raced a concurrent enable() resizing the buffer
            with self._lock:
                if int(capacity) != self.capacity:
                    self.capacity = int(capacity)
                    self._buf = deque(self._buf, maxlen=self.capacity)
        self.enabled = True
        return self

    def disable(self) -> "Tracer":
        self.enabled = False
        return self

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self.dropped = 0

    # ------------------------------------------------------------ record
    @contextmanager
    def span(self, name: str, cat: str = "viem", **attrs):
        sp = Span(name=name, cat=cat, t0=time.perf_counter(),
                  tid=threading.get_ident(),
                  depth=getattr(self._local, "depth", 0), attrs=attrs)
        self._local.depth = sp.depth + 1
        try:
            yield sp
        finally:
            self._local.depth = sp.depth
            sp.dur = time.perf_counter() - sp.t0
            if self.enabled:
                with self._lock:
                    if len(self._buf) == self._buf.maxlen:
                        self.dropped += 1
                    self._buf.append(sp)

    def record(self, name: str, dur: float, cat: str = "viem",
               t0: float | None = None, **attrs) -> Span:
        """Record an already-measured interval (for code that cannot
        wrap the work in a ``with`` block)."""
        sp = Span(name=name, cat=cat, dur=float(dur),
                  t0=time.perf_counter() - float(dur) if t0 is None
                  else float(t0),
                  tid=threading.get_ident(),
                  depth=getattr(self._local, "depth", 0), attrs=attrs)
        if self.enabled:
            with self._lock:
                if len(self._buf) == self._buf.maxlen:
                    self.dropped += 1
                self._buf.append(sp)
        return sp

    def wrap(self, name: str | None = None, cat: str = "viem"):
        """Decorator form: ``@tracer.wrap("stage")``."""
        def deco(fn):
            label = name or fn.__qualname__

            @wraps(fn)
            def inner(*args, **kwargs):
                with self.span(label, cat=cat):
                    return fn(*args, **kwargs)
            return inner
        return deco

    # ------------------------------------------------------------ inspect
    def spans(self) -> "list[Span]":
        """Snapshot of the ring buffer (oldest first)."""
        with self._lock:
            return list(self._buf)

    def drain(self) -> "list[Span]":
        """Snapshot and clear in one atomic step."""
        with self._lock:
            out = list(self._buf)
            self._buf.clear()
            return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)


_GLOBAL = Tracer(enabled=False)


def get_tracer() -> Tracer:
    """The process-global tracer every pipeline layer records into.  It
    is a stable singleton — hold the reference; ``enable()``/``disable``
    toggle recording without invalidating it."""
    return _GLOBAL


def traced(name: str | None = None, cat: str = "viem"):
    """Decorator recording into the *global* tracer:
    ``@traced("stage")``."""
    return _GLOBAL.wrap(name, cat=cat)
