"""What a ``--trace 1`` run records, and what it reads from it.

:class:`KernelCalls` wraps the program's K1 and K2 entry points (the
Python functions that launch ``csrc/qap_objective.cu`` and
``csrc/pair_gain.cu``) and its plan entries, and notes while the window
is open each call's lanes and pairs and the structure each lane maps:
the benchmark's own record, from which :mod:`portbench.readers` counts
the work with the structures' sizes from the benchmark's own graphs.
It changes no argument and no result.

:class:`Capture` opens and closes the traced window: the program's span
tracer (``repro_torch.obs``), the kernel-call record and, on the card,
``torch.profiler`` with CUDA activity only.  :func:`device_summary`
turns the profiler's events into the device's busy seconds, the seconds
by kernel name, and the idle gaps, each named by the innermost program
span open at its middle.
"""

from __future__ import annotations

import time
from collections import defaultdict

__all__ = ["Capture", "KernelCalls", "device_summary"]


class KernelCalls:
    """The K1 and K2 calls made while ``on``: each call's lanes (and K2's
    pairs), with the structure of each lane, taken from the graphs handed
    to the plan entry (``execute``, ``execute_batch``) that made the call:
    one graph a lane, in order, cycled where the call has more lanes than
    the entry has graphs (a portfolio's lanes of one graph).  A call made
    outside any entry has lanes of no known structure.
    ``structure_of(graph)`` names a graph's structure (the traffic kind's
    driver knows it)."""

    def __init__(self):
        self.on = False
        self.structure_of = lambda g: None
        self.k1: list = []     # (lanes, structures)
        self.k2: list = []     # (lanes, pairs, structures)
        self._entry: tuple = ()
        self._undo: list = []

    def lanes_of(self, lanes: int) -> tuple:
        entry = self._entry or (None,)
        return tuple(entry[i % len(entry)] for i in range(lanes))

    def install(self) -> None:
        """Wrap the entry points; call before any plan is lowered (a
        plan binds its objective kernel when it is built)."""
        from repro_torch.core.plan import MappingPlan
        from repro_torch.kernels import pair_gain, qap_objective
        rec = self

        def wrap_k1(fn):
            def k1(kind, params, eu, ev, ew, perm, D):
                if rec.on:
                    lanes = perm.shape[0] if perm.dim() == 2 else 1
                    rec.k1.append((lanes, rec.lanes_of(lanes)))
                return fn(kind, params, eu, ev, ew, perm, D)
            return k1

        def wrap_k2(fn):
            def k2(kind, params, nbr, wgt, perm, us, vs, D, config=None):
                if rec.on:
                    lanes = perm.shape[0] if perm.dim() == 2 else 1
                    rec.k2.append((lanes, int(us.shape[-1]),
                                   rec.lanes_of(lanes)))
                return fn(kind, params, nbr, wgt, perm, us, vs, D,
                          config=config)
            return k2

        def wrap_entry(fn, batched):
            def entry(plan, first, *a, **kw):
                if not rec.on:
                    return fn(plan, first, *a, **kw)
                if batched:
                    first = list(first)
                outer = rec._entry
                rec._entry = tuple(rec.structure_of(g) for g in
                                   (first if batched else [first]))
                try:
                    return fn(plan, first, *a, **kw)
                finally:
                    rec._entry = outer
            return entry

        for owner, name, wrap in (
                (qap_objective, "qap_objective_edges", wrap_k1),
                (pair_gain, "qap_objective_edges", wrap_k1),
                (pair_gain, "pair_gains", wrap_k2),
                (MappingPlan, "execute", lambda f: wrap_entry(f, False)),
                (MappingPlan, "execute_batch",
                 lambda f: wrap_entry(f, True))):
            orig = owner.__dict__[name]
            self._undo.append((owner, name, orig))
            setattr(owner, name, wrap(orig))

    def uninstall(self) -> None:
        for owner, name, orig in reversed(self._undo):
            setattr(owner, name, orig)
        self._undo.clear()


class Capture:
    """The traced window: spans, kernel calls and (on the card) the
    device's activity between :meth:`start` and :meth:`stop`."""

    def __init__(self, calls: KernelCalls, device: str):
        self.calls = calls
        self.device = device
        self.running = False
        self.spans: list = []
        self.dropped = 0
        self.events = None
        self.t0 = self.t1 = 0.0
        self.cost: dict = {}
        self._prof = None

    def start(self) -> None:
        from repro_torch.obs import get_tracer
        tracer = get_tracer()
        tracer.clear()
        tracer.enable()
        if self.device == "cuda":
            import torch
            from torch.profiler import ProfilerActivity, profile
            torch.cuda.synchronize()
            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.__enter__()
            torch.cuda.synchronize()
            # the profiler's clock is the wall clock in ns; the spans'
            # is perf_counter: the smallest of a few paired reads
            self._offset_ns = min(
                time.time_ns() - time.perf_counter_ns() for _ in range(5))
        self.calls.on = True
        self.running = True
        self.t0 = time.perf_counter()

    def close(self) -> None:
        """Close the window: the spans and kernel calls so far are its;
        the profiler runs on until :meth:`stop` (its device events are
        cut at the close)."""
        from repro_torch.obs import get_tracer
        self.t1 = time.perf_counter()
        self.calls.on = False
        self.running = False
        tracer = get_tracer()
        tracer.disable()
        self.dropped = tracer.dropped
        self.spans = tracer.drain()

    def stop(self) -> None:
        """Stop the profiler (tens of seconds for a million events: call
        it once nothing else waits on the run) and read its events."""
        if self.running:
            self.close()
        if self._prof is not None:
            import torch
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            self._prof.__exit__(None, None, None)
            t1 = time.perf_counter()
            self.events = _device_events(self._prof, self._offset_ns)
            self._prof = None
            self.cost = {"profiler_stop_s": t1 - t0,
                         "events_s": time.perf_counter() - t1,
                         "events": len(self.events)}


def _device_events(prof, offset_ns: int) -> list:
    """(start, end, name) of every device activity, in perf_counter
    seconds."""
    from torch.autograd import DeviceType
    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CUDA:
            continue
        start = (ev.start_ns() - offset_ns) * 1e-9
        out.append((start, start + ev.duration_ns() * 1e-9, ev.name()))
    out.sort()
    return out


def _innermost_segments(spans) -> list:
    """(start, end, name) pieces of time, each under one innermost
    program span (the deepest open; of equal depth, the latest opened);
    time under no span is left out."""
    bounds = sorted({t for sp in spans for t in (sp.t0, sp.t0 + sp.dur)})
    opens = sorted(spans, key=lambda sp: sp.t0)
    out, active, i = [], [], 0
    for a, b in zip(bounds, bounds[1:]):
        while i < len(opens) and opens[i].t0 <= a:
            active.append(opens[i])
            i += 1
        active = [sp for sp in active if sp.t0 + sp.dur > a]
        if active:
            top = max(active, key=lambda sp: (sp.depth, sp.t0))
            out.append((a, b, top.name))
    return out


def _attribute(gaps, segments) -> dict:
    """Seconds of each gap under each innermost span; the rest under
    ``"(no program span)"``."""
    idle: dict = defaultdict(float)
    j = 0
    for a, b in gaps:
        covered = 0.0
        while j < len(segments) and segments[j][1] <= a:
            j += 1
        k = j
        while k < len(segments) and segments[k][0] < b:
            s0, s1, name = segments[k]
            part = min(b, s1) - max(a, s0)
            if part > 0:
                idle[name] += part
                covered += part
            k += 1
        idle["(no program span)"] += (b - a) - covered
    return idle


def device_summary(capture: Capture, top: int = 10) -> dict | None:
    """Busy seconds (the union of device activity inside the window),
    seconds by kernel name, and the idle gaps by the innermost program
    span; None off the card."""
    if capture.events is None:
        return None
    t0, t1 = capture.t0, capture.t1
    by_name: dict = defaultdict(float)
    busy = 0.0
    gaps = []
    edge = t0
    for start, end, name in capture.events:
        s, e = max(start, t0), min(end, t1)
        if e <= s:
            continue
        by_name[name] += e - s
        if s > edge:
            gaps.append((edge, s))
        if e > edge:
            busy += e - max(s, edge)
            edge = e
    if t1 > edge:
        gaps.append((edge, t1))
    idle = _attribute(gaps, _innermost_segments(capture.spans))
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {"busy_s": busy, "window_s": t1 - t0, "by_name": dict(by_name),
            "device_ops": [[n[:160], s] for n, s in ops[:top]],
            "idle_gaps": [[n, s] for n, s in sorted(
                idle.items(), key=lambda kv: -kv[1])[:top]]}
