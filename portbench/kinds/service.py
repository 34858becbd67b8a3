"""The ``service`` traffic kind: clients in a closed loop against the
program's ``MappingService`` (``launch/serve.py``).

Traffic.  ``structures`` lists the graphs' structures
(:func:`portbench.graphs.build`); each block of ``block`` consecutive
requests holds each structure equally often, in a seeded order, so every
seed sends the same mix while a short run of requests is as mixed as
independent draws.  Each request draws fresh integer weights in
``weights`` = [low, high] for its edges.  ``clients`` hold one request
each.

Set-up builds one ``Mapper`` over the configuration's machine and spec,
starts the service with the configuration's ``service`` settings, and
warms every shape the traffic uses: per structure one request alone (one
lane) and one burst of ``max_batch`` (the full batch), so that the pair
search of every structure, the device uploads and both lane shapes of K1
and K2 are done before the window opens.

In the window every client holds one request: it submits, waits for the
answer, submits its next.  One thread drives all clients.  A request's
latency runs from just before ``submit`` to the moment its answer is
taken off the results queue.  At ``seconds`` no client submits again;
the window closes with the first answer after that, at the end of the
service tick then running, so that a rate over the window counts whole
ticks.  The requests still out are waited for, a minute at most, and
judged with the rest.

Judged: each request submitted in the window must be answered (an
exception or no answer a minute past the close counts as
``unanswered``), with a bijection, with a reported objective equal to
the reference's J of that request's own graph under the answer's
permutation (``objective_gap``, relative), and refined: J below
``refined_below`` × J under the run's random placement (the answers
that are not: ``unrefined``).
"""

from __future__ import annotations

import queue
import time
from dataclasses import dataclass, field

import numpy as np

from portbench import graphs, reference
from portbench.generator import ORDER, WEIGHTS, random_perm, rng
from portbench.judge import Verdict, rel

__all__ = ["Driver", "Traffic", "end_to_end", "judge"]

DRAIN_S = 60.0
SAME_TICK_S = 0.05


class Traffic:
    def __init__(self, params: dict, seed: int):
        self.params = params
        self.seed = int(seed)
        self.names = [s["name"] for s in params["structures"]]
        self.shapes = [graphs.build(s) for s in params["structures"]]
        self.structures = dict(zip(self.names, self.shapes))
        self.low, self.high = params["weights"]
        self.clients = int(params["clients"])
        self.block = int(params["block"])
        if self.block % len(self.shapes):
            raise ValueError("a block must hold each structure equally "
                             "often")

    def structure_of(self, k: int) -> int:
        s = len(self.shapes)
        block = rng(self.seed, ORDER, k // self.block).permutation(
            np.arange(self.block) % s)
        return int(block[k % self.block])

    def weights(self, k: int) -> np.ndarray:
        """Request k's edge weights, over its structure's edges."""
        _, u, _ = self.shapes[self.structure_of(k)]
        return rng(self.seed, WEIGHTS, k).integers(
            self.low, self.high, size=len(u), endpoint=True
        ).astype(np.float64)

    def request(self, k: int) -> tuple[int, np.ndarray]:
        return self.structure_of(k), self.weights(k)


@dataclass
class Request:
    k: int
    structure: int
    t_submit: float
    t_answer: float | None = None
    answer: object = None          # MappingResult, Exception or None


@dataclass
class Window:
    seconds: float
    t_open: float = 0.0
    t_close: float = 0.0        # the first answer at or after the close
    requests: list = field(default_factory=list)
    stats: dict = field(default_factory=dict)

    def answered(self) -> int:
        """The answers taken off the queue in the window."""
        return sum(1 for r in self.requests
                   if r.t_answer is not None and r.t_answer <= self.t_close)


class Driver:
    """One configuration's service under one mix of this kind."""

    def __init__(self, config: dict, params: dict, device: str):
        from repro_torch.core import MappingSpec
        from repro_torch.topology import make_topology
        machine = dict(config["machine"])
        self.topology = make_topology(machine.pop("kind"), **machine)
        self.spec = MappingSpec(**config["spec"]).validate()
        self.knobs = dict(config["service"])
        self.device = device
        self.mapper = None
        self.service = None
        self.phases: dict = {}
        self._templates = None
        self._keys: dict = {}

    def _graph(self, structure: int, weights: np.ndarray):
        from repro_torch.core.graph import CommGraph
        g0, slot = self._templates[structure]
        return CommGraph(g0.xadj, g0.adjncy, weights[slot], g0.vwgt)

    def structure_of(self, g) -> str | None:
        return self._keys.get(graphs.content_key(g.xadj, g.adjncy))

    def setup(self, traffic: Traffic, seed: int) -> None:
        """Start the service (once per driver) and warm it up for this
        seed's spec."""
        from repro_torch.core import Mapper, from_edges
        from repro_torch.launch.serve import MappingService
        t0 = time.perf_counter()
        if self.service is None:
            self._templates = []
            for name, (n, u, v) in zip(traffic.names, traffic.shapes):
                if n != self.topology.n_pe:
                    raise ValueError(f"a structure of {n} processes on a "
                                     f"machine of {self.topology.n_pe}")
                g0 = from_edges(n, u, v, np.arange(1.0, len(u) + 1.0))
                self._templates.append((g0, g0.adjwgt.astype(np.int64) - 1))
                self._keys[graphs.content_key(g0.xadj, g0.adjncy)] = name
            self.mapper = Mapper(self.topology, self.spec, device=self.device)
            self.service = MappingService(self.mapper, **self.knobs)
        self.run_spec = self.spec.replace(seed=int(seed))
        draw = np.random.default_rng([int(seed), 99])
        self.phases = {"structures": time.perf_counter() - t0}
        for s, (n, u, _) in enumerate(traffic.shapes):
            for lanes in (1, self.knobs["max_batch"]):
                t0 = time.perf_counter()
                burst = [self._graph(s, draw.integers(
                    traffic.low, traffic.high, size=len(u),
                    endpoint=True).astype(np.float64))
                    for _ in range(lanes)]
                tickets = {self.service.submit(g, spec=self.run_spec)
                           for g in burst}
                while tickets:
                    t, res = self.service.results.get(timeout=600)
                    if isinstance(res, Exception):
                        raise res
                    tickets.discard(t)
                self.phases[f"{traffic.names[s]}x{lanes}"] = \
                    time.perf_counter() - t0
        self.service.reset_stats()

    def window(self, traffic: Traffic, seconds: float,
               capture=None) -> Window:
        svc = self.service
        out = Window(seconds=seconds)
        out_by_ticket: dict = {}
        k = 0

        def submit():
            nonlocal k
            s, w = traffic.request(k)
            g = self._graph(s, w)
            req = Request(k=k, structure=s, t_submit=time.perf_counter())
            out_by_ticket[svc.submit(g, spec=self.run_spec)] = req
            out.requests.append(req)
            k += 1

        if capture is not None:
            capture.start()
        out.t_open = time.perf_counter()
        close = out.t_open + seconds
        for _ in range(traffic.clients):
            submit()
        waiting = traffic.clients
        closing = True
        while waiting:
            now = time.perf_counter()
            limit = close if now < close else close + DRAIN_S
            try:
                ticket, res = svc.results.get(timeout=max(limit - now,
                                                          1e-3))
            except queue.Empty:
                if time.perf_counter() >= close + DRAIN_S:
                    break
                continue
            req = out_by_ticket.pop(ticket)
            req.t_answer = time.perf_counter()
            req.answer = res
            waiting -= 1
            if req.t_answer < close:
                submit()
                waiting += 1
            elif not out.t_close or (closing and req.t_answer - out.t_close
                                     <= SAME_TICK_S):
                # the closing tick's answers come within microseconds of
                # each other; the next tick's a map's time later
                out.t_close = req.t_answer
            else:
                closing = False
            if out.t_close and capture is not None and capture.running:
                capture.close()
        if not out.t_close:
            out.t_close = time.perf_counter()
        if capture is not None:
            capture.stop()
        out.stats = svc.stats()
        return out

    def close(self) -> None:
        if self.service is not None:
            self.service.close()
            self.service = None


def judge(window: Window, traffic: Traffic, cell, seed: int,
          control: bool = False) -> Verdict:
    dist, n = reference.distance_fn(cell.config["machine"])
    rand = random_perm(seed, n)
    out = Verdict(cell.limits)
    quality: dict = {name: [] for name in traffic.names}
    for req in window.requests:
        out.attempted += 1
        ok = True
        res = req.answer
        if res is None or isinstance(res, Exception):
            out.values["unanswered"] += 1
            out.failed += 1
            continue
        perm = np.asarray(res.perm)
        if not reference.is_bijection(perm, n):
            out.values["not_bijection"] += 1
            out.failed += 1
            continue
        _, u, v = traffic.shapes[req.structure]
        w = traffic.weights(req.k)
        j = reference.objective(u, v, w, perm, dist)
        j_rand = reference.objective(u, v, w, rand, dist)
        reported = (reference.objective_bf16(u, v, w, perm, dist) if control
                    else float(res.final_objective))
        ok &= out.worst("objective_gap", rel(reported, j))
        quality[traffic.names[req.structure]].append(j / j_rand)
        if j / j_rand >= cell.judge_params["refined_below"]:
            out.values["unrefined"] += 1
            ok = False
        out.add_j(traffic.names[req.structure], j, j_rand)
        out.failed += not ok
    out.notes["quality"] = {
        name: {"answers": len(q), "min": min(q), "max": max(q),
               "mean": sum(q) / len(q)} for name, q in quality.items() if q}
    return out


def end_to_end(window: Window, verdict: Verdict, setup_s: float) -> dict:
    return {"setup_s": setup_s, "j_rel": verdict.j_rel,
            "maps_per_s": window.answered() / (window.t_close
                                               - window.t_open)}
