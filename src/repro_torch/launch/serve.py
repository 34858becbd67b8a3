"""Serving driver: batched prefill + greedy decode loop with KV caches,
plus the shape-bucketed fleet-placement `MappingService` — the port of
the JAX package's ``launch/serve.py``.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b \
        --batch 4 --prompt-len 2048 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b \
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --placement-smoke \
        [--device cpu]

Every shipped config serves, whatever its layer kinds (attention,
Mamba or RWKV mixers; MLP, MoE or channel-mix FFNs).  The prefill's
attention is K4 on the card (its plain version on the CPU).  The decode
loop stays on the device: the next token is an argmax on the device fed
straight into the next step, and nothing is read back
to the host until the final ``tokens``.  On CUDA a second, untimed pass
of the loop runs inside a ``host_boundary`` scope, which counts the syncs
PyTorch sees there (``decode_syncs``).

`MappingService` is the high-throughput front end of the staged
``lower → MappingPlan → execute`` API: incoming graphs are bucketed by
padded device shape (configurable schedule, pow2 by default), same-bucket
requests are dynamically batched into ONE ``plan.execute_batch`` per tick
(max-batch/max-wait knobs; on the card one K1/K2 launch a sweep with a
lane per graph), repeat graphs are answered from a warm result cache
keyed on graph content, and queue-depth backpressure is visible through
``stats()``.  Its worker thread maps on the Mapper's device — the card
unless the Mapper was given ``device="cpu"``.  ``placement_spec()`` maps
on the host engine (no kernel runs); a device-engine spec, or the
``"strong"`` quality class (which forces ``engine="device"``), runs K1
and K2.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import itertools
import queue
import threading
import time
from collections import OrderedDict

import torch

from ..configs import get_config, get_smoke_config
from ..models.transformer import init_params, prefill_with_cache
from ..obs import MetricsRegistry, get_tracer
from ..runtime.boundary import host_boundary
from ..runtime.device import resolve_device
from ..train.steps import serve_step

__all__ = ["MappingService", "make_prompts", "placement_service", "serve",
           "serve_model"]

_TR = get_tracer()


def make_prompts(cfg, batch: int, prompt_len: int, seed: int, device):
    """(batch, prompt_len) int32 token ids, uniform over the vocabulary,
    from a generator seeded with ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                         generator=gen, device=device, dtype=torch.int32)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(arch: str, batch: int, prompt_len: int, gen: int,
          smoke: bool = False, seed: int = 0, device=None) -> dict:
    """:func:`serve_model` of ``arch``'s config (its smoke config with
    ``smoke``): every shipped config, of any layer kind, runs through the
    same code."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    return serve_model(cfg, batch, prompt_len, gen, seed=seed,
                       device=device)


def serve_model(cfg, batch: int, prompt_len: int, gen: int, seed: int = 0,
                device=None) -> dict:
    """Random weights and prompts from ``seed`` (both, as the JAX package
    uses one key for both), one prefill of ``batch`` prompts and ``gen``
    greedy tokens each.  Returns ``tokens`` (batch, gen) int32 on the
    device, ``prefill_s``, ``decode_s``, ``decode_tok_per_s`` and
    ``decode_syncs`` (None off CUDA)."""
    dev = resolve_device(device)
    with torch.inference_mode():
        params = init_params(seed, cfg, device=dev)
        max_len = prompt_len + gen
        prompts = make_prompts(cfg, batch, prompt_len, seed, dev)

        _sync(dev)
        t0 = time.perf_counter()
        logits, caches = prefill_with_cache(params, prompts, cfg, max_len)
        next_tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        del logits
        _sync(dev)
        t_prefill = time.perf_counter() - t0

        def decode(tok):
            out = [tok]
            for i in range(gen - 1):
                tok, _ = serve_step(params, tok, caches, prompt_len + i, cfg)
                out.append(tok)
            return torch.cat(out, dim=1)

        t0 = time.perf_counter()
        tokens = decode(next_tok)
        _sync(dev)
        t_decode = time.perf_counter() - t0
        # the syncs are counted on a second pass of the same loop (same
        # steps and shapes, tokens discarded; the recurrent layers' states
        # go on from where the first pass left them), so the debug mode
        # that counts them stays out of the timed pass
        with host_boundary("serve.decode", dev) as hb:
            if dev.type == "cuda":
                decode(next_tok)
        _sync(dev)
    return {
        "tokens": tokens,
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "decode_tok_per_s": batch * (gen - 1) / max(t_decode, 1e-9),
        "decode_syncs": hb.syncs,
    }


# ------------------------------------------------------- mapping service
class MappingService:
    """Shape-bucketed, dynamically-batched mapping service over one
    :class:`~repro_torch.core.Mapper` session (see module docstring).

    ``submit(g)`` returns a ticket; ``(ticket, MappingResult)`` tuples
    (or ``(ticket, Exception)`` on per-request failure) arrive on
    ``results``.  Per tick the worker drains up to ``max_batch`` requests
    (waiting at most ``max_wait_s`` for stragglers), answers repeats from
    the warm result cache, groups the rest by (spec, shape bucket, seed),
    and runs each group through one ``plan.execute_batch`` — so
    steady-state traffic executes lowered plans with no Python-side
    rebuild.  ``max_pending > 0`` bounds the request queue: ``submit``
    then blocks when the service falls behind (backpressure), and
    ``stats()`` exposes queue depth, batch shape, cache hits, and latency
    percentiles.

    ``quality_classes`` maps per-request quality names to
    :class:`~repro_torch.core.spec.PortfolioSpec` overlays (``None`` =
    strip any portfolio — the single-trajectory fast path).  ``submit(g,
    quality="strong")`` rewrites the request's spec with that overlay, so
    both classes share the one plan cache (distinct specs, distinct
    plans) and the fast path stays zero-overhead.  Defaults:
    ``{"fast": None, "strong": PortfolioSpec()}``.

    Accounting lives in ``self.metrics`` — a
    :class:`~repro_torch.obs.MetricsRegistry`; ``stats()`` is the legacy
    dict view over its snapshot.  ``collect_telemetry=True`` asks every
    executed plan for device engine counters, aggregated into
    ``engine_*`` metrics (a runtime toggle).

    The worker thread does all of the Mapper's device work: it launches
    on its own thread's current CUDA stream, and a tick that fails on the
    card surfaces per request (an exception in ``results``, counted in
    ``errors``), after a retry of each request through ``mapper.map`` on
    the same device — never on the CPU or a plain version.  Client
    threads only enqueue and read results; while the service runs they
    should leave the Mapper's device to the worker (the kernels' launch
    counts and the sync-counting scopes are process-wide).
    """

    def __init__(self, mapper, *, schedule: str = "pow2",
                 max_batch: int = 8, max_wait_s: float = 0.005,
                 result_cache_size: int = 256, max_pending: int = 0,
                 quality_classes: "dict | None" = None,
                 collect_telemetry: bool = False,
                 requests: "queue.Queue | None" = None,
                 results: "queue.Queue | None" = None):
        from ..core.spec import PortfolioSpec
        self.mapper = mapper
        self.schedule = schedule
        self.quality_classes = (
            {"fast": None, "strong": PortfolioSpec()}
            if quality_classes is None else dict(quality_classes))
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_s)
        self.collect_telemetry = bool(collect_telemetry)
        self.requests = (requests if requests is not None else
                         queue.Queue(maxsize=max_pending))
        self.results = results if results is not None else queue.Queue()
        self._result_cache: OrderedDict = OrderedDict()
        self._result_cache_size = int(result_cache_size)
        self._tickets = itertools.count()
        self._closed = False
        self._lock = threading.Lock()
        self.metrics = MetricsRegistry()
        m = self.metrics
        self._c_served = m.counter("served")
        self._c_batches = m.counter("batches")
        self._c_batched = m.counter("batched_requests")
        self._c_cache_hits = m.counter("result_cache_hits")
        self._c_deduped = m.counter("in_tick_deduped")
        self._c_errors = m.counter("errors")
        self._g_max_batch = m.gauge("max_batch_seen")
        self._g_peak_depth = m.gauge("peak_queue_depth")
        # engine aggregates (sweeps from every result's objective trace;
        # the rest only when collect_telemetry attaches engine counters)
        self._c_sweeps = m.counter("engine_sweeps")
        self._c_passes = m.counter("engine_passes")
        self._c_exchanges = m.counter("engine_exchanges")
        self._c_aspirations = m.counter("engine_aspirations")
        self._c_downhill = m.counter("engine_downhill_escapes")
        self._c_telemetry = m.counter("telemetry_requests")
        # sliding latency window: long-lived services keep reporting
        # *recent* p50/p99, not the first N requests forever
        self._h_latency = m.histogram("latency_s", window=65536)
        self._thread = threading.Thread(target=self._run,
                                        name="viem-mapping-service",
                                        daemon=True)
        self._thread.start()

    # ------------------------------------------------------------- client
    def submit(self, g, spec=None, quality: str | None = None,
               timeout: float | None = None) -> int:
        """Enqueue one graph; blocks when ``max_pending`` is set and the
        queue is full (backpressure) — ``timeout`` bounds that wait
        (``queue.Full`` on expiry; no ticket was consumed from the
        caller's perspective).  ``quality`` selects a quality class from
        ``quality_classes`` (``None`` = the spec as-is).  The put happens
        under the close lock so an accepted ticket can never race the
        shutdown sentinel onto a dead queue (close() waits on the same
        lock; the worker keeps draining meanwhile, so a full queue cannot
        deadlock)."""
        if quality is not None and quality not in self.quality_classes:
            raise ValueError(f"unknown quality class {quality!r}; "
                             f"registered: "
                             f"{sorted(self.quality_classes)}")
        with self._lock:
            if self._closed:
                raise RuntimeError("MappingService is closed; requests "
                                   "submitted now would never be served")
            ticket = next(self._tickets)
            self.requests.put(
                (ticket, g, spec, quality, time.perf_counter()),
                timeout=timeout)
        self._g_peak_depth.set_max(self.requests.qsize())
        return ticket

    def map(self, g, spec=None, quality: str | None = None,
            timeout: float | None = None):
        """Synchronous convenience: submit one graph and wait for its
        result (other clients' results are requeued, so concurrent use is
        safe only through ``submit``/``results``).  ``timeout`` bounds
        the TOTAL wait — backpressure on submit included — and raises
        ``TimeoutError`` when it expires."""
        deadline = (None if timeout is None
                    else time.perf_counter() + timeout)
        try:
            ticket = self.submit(g, spec, quality=quality,
                                 timeout=timeout)
        except queue.Full:
            raise TimeoutError(
                f"MappingService.map: request queue still full after "
                f"{timeout}s (backpressure)") from None
        while True:
            remaining = (None if deadline is None
                         else deadline - time.perf_counter())
            if remaining is not None and remaining <= 0:
                raise TimeoutError(
                    f"MappingService.map: no result for ticket {ticket} "
                    f"within {timeout}s")
            try:
                t, res = self.results.get(timeout=remaining)
            except queue.Empty:
                continue                      # deadline check re-raises
            if t == ticket:
                if isinstance(res, Exception):
                    raise res
                return res
            self.results.put((t, res))
            time.sleep(0.001)    # don't spin hot on a foreign result

    def reset_stats(self) -> None:
        """Zero every metric in the registry — counters, gauges, the
        latency window, engine aggregates — atomically (keeps
        caches/plans); call after warm-up so ``stats()`` reflects steady
        state."""
        self.metrics.reset()

    def prometheus(self) -> str:
        """The registry as Prometheus text exposition — serve this at a
        ``/metrics`` endpoint (or dump via ``viem --metrics-out``) so
        service and monitor counters are scrapeable."""
        return self.metrics.to_prometheus()

    def stats(self) -> dict:
        """Legacy-keyed view over ``self.metrics.snapshot()``.

        The snapshot is taken atomically under the registry lock and is
        a deep copy — the returned dict never aliases live state, and
        grouped updates (``served`` + latency, see ``_emit``) are always
        observed together: a monitoring thread polling during a burst
        never sees ``served`` ahead of the latency count."""
        snap = self.metrics.snapshot()
        lat = snap["latency_s"]
        served = snap["served"]
        passes = snap["engine_passes"]
        return {
            "served": served,
            "batches": snap["batches"],
            "batched_requests": snap["batched_requests"],
            "max_batch_seen": int(snap["max_batch_seen"]),
            "result_cache_hits": snap["result_cache_hits"],
            "in_tick_deduped": snap["in_tick_deduped"],
            "result_cache_size": len(self._result_cache),
            "errors": snap["errors"],
            "quality_served": {
                name.split(".", 1)[1]: v for name, v in snap.items()
                if name.startswith("quality_served.")},
            "queue_depth": self.requests.qsize(),
            "peak_queue_depth": int(snap["peak_queue_depth"]),
            "latency_p50_s": lat["p50"],
            "latency_p99_s": lat["p99"],
            "latency_count": lat["count"],
            # engine aggregates (sweeps for every request; the counter
            # block only when collect_telemetry is on)
            "engine_sweeps_total": snap["engine_sweeps"],
            "engine_mean_sweeps_per_request":
                snap["engine_sweeps"] / served if served else 0.0,
            "engine_exchanges_total": snap["engine_exchanges"],
            "engine_downhill_escapes": snap["engine_downhill_escapes"],
            "aspiration_rate":
                snap["engine_aspirations"] / passes if passes else 0.0,
            "telemetry_requests": snap["telemetry_requests"],
        }

    def close(self, timeout: float | None = None):
        with self._lock:
            if not self._closed:
                self._closed = True
                self.requests.put(None)
        self._thread.join(timeout)

    def __enter__(self) -> "MappingService":
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------- worker
    def _gather(self) -> "tuple[list, bool]":
        """One tick's worth of requests: block for the first, then wait
        up to ``max_wait_s`` for up to ``max_batch`` total."""
        item = self.requests.get()
        if item is None:
            return [], True
        batch = [item]
        deadline = time.perf_counter() + self.max_wait_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                nxt = self.requests.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                return batch, True
            batch.append(nxt)
        return batch, False

    def _run(self):
        while True:
            batch, stop = self._gather()
            if batch:
                with _TR.span("service.tick", batch=len(batch)):
                    self._process(batch)
            if stop:
                break

    def _resolve_quality(self, spec, quality):
        """Overlay a quality class onto a request spec: ``None`` strips
        the portfolio (fast path), a PortfolioSpec enables it (forcing
        the device engine it requires)."""
        overlay = self.quality_classes[quality]
        spec = spec.replace(portfolio=overlay)
        if overlay is not None and spec.engine != "device":
            spec = spec.replace(engine="device")
        return spec

    def _process(self, batch):
        """Answer warm repeats from the result cache, then group misses
        by (resolved spec, shape bucket, seed) and run each group through
        one ``plan.execute_batch``.  Quality classes resolve here, once
        per (spec, quality) per tick — both classes share the one plan
        cache."""
        from ..core.plan import _structure_key
        groups: "OrderedDict[tuple, list]" = OrderedDict()
        resolved: dict = {}    # (id(spec), quality) → (spec, spec key)
        for ticket, g, spec, quality, t_sub in batch:
            spec = self.mapper.spec if spec is None else spec
            try:
                rkey = (id(spec), quality)
                hit = resolved.get(rkey)
                if hit is None:
                    eff = spec.validate()
                    if quality is not None:
                        eff = self._resolve_quality(eff, quality
                                                    ).validate()
                    hit = (eff, self.mapper._plan_key(eff, None)[0])
                    resolved[rkey] = hit
                spec, skey = hit
                self.mapper._check_size(g)
                ckey = (skey, spec.seed,
                        _structure_key(g, with_weights=True))
                qname = quality or "default"
                self.metrics.counter(f"quality_served.{qname}").inc()
            except Exception as exc:
                self._emit(ticket, exc, t_sub)
                continue
            hit = self._result_cache.get(ckey)
            if hit is not None:
                self._result_cache.move_to_end(ckey)
                self._c_cache_hits.inc()
                self._emit(ticket, self._copy_result(hit), t_sub)
                continue
            bucket = self.mapper.bucket_of(g, schedule=self.schedule)
            # the plan key is seed-free (plans are shared across seeds),
            # but a group executes with ONE runtime seed — so the seed
            # is part of the grouping identity
            groups.setdefault((skey, bucket, spec.seed), []
                              ).append((ticket, g, spec, t_sub, ckey))
        for (_, bucket, _), items in groups.items():
            self._execute_group(items, bucket)

    def _execute_group(self, items, bucket):
        """All items share one (spec, bucket, seed) group key — one
        lower (or plan-cache hit), one batched call.  Identical graphs
        inside the tick (same content key) execute once and fan out.
        Multi-request batches are padded to exactly ``max_batch`` lanes
        (cycling the tick's own graphs) so the batch axis is bucketed
        too: per plan there are exactly two lane shapes — single and
        full batch — whatever the tick holds."""
        spec = items[0][2]
        tel = self.collect_telemetry
        uniq: "OrderedDict[tuple, object]" = OrderedDict()
        for _, g, _, _, ckey in items:
            uniq.setdefault(ckey, g)
        graphs = list(uniq.values())
        try:
            plan = self.mapper.lower(bucket, spec)
            b = len(graphs)
            if plan.engines is None:
                # host engine executes serially — no batched sweep loop,
                # so neither lane padding nor batching helps
                results = [plan.execute(g, seed=spec.seed, telemetry=tel)
                           for g in graphs]
            elif 2 * b > self.max_batch:
                # at least half the padded lanes are real work: one
                # batched call wins; padding the batch axis to exactly
                # max_batch keeps a single batch shape
                lanes = graphs + [graphs[i % b]
                                  for i in range(self.max_batch - b)]
                results = plan.execute_batch(lanes, seed=spec.seed,
                                             telemetry=tel)[:b]
                self._c_batches.inc()
                self._c_batched.inc(len(items))
                self._g_max_batch.set_max(len(items))
            else:
                # under-utilized batch: padded lanes would outweigh the
                # dispatch savings, so run the few uniques singly (they
                # still share the plan)
                results = [plan.execute(g, seed=spec.seed, telemetry=tel)
                           for g in graphs]
            self.mapper._requests += len(graphs)
        except Exception:
            # batch-level failure: isolate per request, on the same
            # device and kernels
            results = []
            for ckey, g in uniq.items():
                try:
                    results.append(self.mapper.map(g, spec=spec,
                                                   telemetry=tel))
                except Exception as exc:
                    results.append(exc)
        by_key = dict(zip(uniq.keys(), results))
        for ticket, g, sp, t_sub, ckey in items:
            res = by_key[ckey]
            if not isinstance(res, Exception):
                self._result_cache[ckey] = self._copy_result(res)
                while len(self._result_cache) > self._result_cache_size:
                    self._result_cache.popitem(last=False)
                res = self._copy_result(res)
            self._emit(ticket, res, t_sub)
        self._c_deduped.inc(len(items) - len(graphs))

    @staticmethod
    def _copy_result(res):
        """Results are shared between the warm cache and (possibly many)
        clients — hand out copies so nobody can mutate cached state
        (the perm array *and* the SearchStats with its trace list).
        Everything in a result is on the host already: ``perm`` is
        numpy, the stats hold floats and the telemetry's numpy arrays."""
        return dataclasses.replace(
            res, perm=res.perm.copy(),
            search_stats=copy.deepcopy(res.search_stats))

    def _emit(self, ticket, res, t_sub):
        # one lock around the whole group: served, errors, the latency
        # histogram, and the engine aggregates land as ONE observable
        # step — stats() can never catch served ahead of latency_count
        lat = time.perf_counter() - t_sub
        with self.metrics.lock:
            self._c_served.inc()
            if isinstance(res, Exception):
                self._c_errors.inc()
            else:
                st = getattr(res, "search_stats", None)
                trace = None if st is None else \
                    getattr(st, "objective_trace", None)
                if trace is not None and len(trace) > 1:
                    self._c_sweeps.inc(len(trace) - 1)
                tel = None if st is None else \
                    getattr(st, "telemetry", None)
                if tel is not None:
                    self._c_telemetry.inc()
                    self._c_passes.inc(int(tel.passes))
                    self._c_exchanges.inc(int(tel.total_exchanges))
                    self._c_aspirations.inc(int(tel.aspiration_fires))
                    self._c_downhill.inc(int(tel.downhill_escapes))
            self._h_latency.observe(lat)
        self.results.put((ticket, res))


# ------------------------------------------------------ placement service
def placement_service(hierarchy=None, spec=None, requests=None,
                      results=None, device=None, **knobs):
    """Long-lived device-placement service for the serving fleet.

    One `Mapper` session per fleet hierarchy, on ``device`` (the card
    unless ``"cpu"`` is asked for): plans (distance oracle, kernels,
    engines) are lowered once per shape bucket, then every traffic graph
    pushed onto the request queue (e.g. extracted from newly compiled
    serving programs via
    ``repro_torch.core.comm_model.device_comm_graph``) executes a lowered
    plan — same-bucket bursts batch into one ``execute_batch``.  Returns
    the started :class:`MappingService`.  ``placement_spec()``, the
    default, maps on the host engine.
    """
    from ..core import Mapper, tpu_v5e_fleet
    from .specs import placement_service_config, placement_spec
    h = hierarchy if hierarchy is not None else tpu_v5e_fleet(pods=2)
    cfg = placement_service_config()
    cfg.update(knobs)
    return MappingService(Mapper(h, spec or placement_spec(), device=device),
                          requests=requests, results=results, **cfg)


def _placement_smoke(device=None):
    """Round-trip a few synthetic fleet traffic graphs through the
    placement queue and print objectives vs identity placement, plus the
    session's plan-cache and service accounting."""
    import numpy as np

    from ..core import from_edges, qap_objective, tpu_v5e_fleet

    h = tpu_v5e_fleet(pods=1)   # 256 PEs
    n = h.n_pe
    graphs = []
    for shift in (1, 2, 4):
        us = np.arange(n)
        vs = (us + shift * 16) % n
        graphs.append(from_edges(n, us, vs, np.full(n, 1e6)))
    graphs.append(graphs[0])    # a repeat: exercises the warm cache
    with placement_service(h, device=device) as svc:
        tickets = {}
        for g in graphs:
            tickets[svc.submit(g)] = g
        for _ in tickets:
            ticket, res = svc.results.get(timeout=300)
            if isinstance(res, Exception):
                raise res
            g = tickets[ticket]
            j_id = qap_objective(g, h, np.arange(n))
            print(f"request {ticket}: J={res.final_objective:.3e} "
                  f"(identity {j_id:.3e}, "
                  f"{res.final_objective / j_id:.2f}x)")
        stats = svc.stats()
        info = svc.mapper.cache_info()
    print(f"service: served={stats['served']} "
          f"batches={stats['batches']} "
          f"warm_hits={stats['result_cache_hits']} "
          f"peak_queue_depth={stats['peak_queue_depth']} "
          f"p50={stats['latency_p50_s']:.3f}s "
          f"p99={stats['latency_p99_s']:.3f}s")
    print(f"plan cache: builds={info['plan_builds']} "
          f"hits={info['plan_hits']} evictions={info['plan_evictions']}")
    for tag, pinfo in info["plans"].items():
        print(f"  bucket {tag}: executes={pinfo['executes']} "
              f"pair_hits={pinfo['pair_hits']} "
              f"engines={pinfo['engine_builds']}")
    print("placement service:", "ok")


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Prefill + greedy decode of a randomly initialised "
                    "LM on the port, or the placement service's smoke "
                    "run.")
    ap.add_argument("--arch")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--placement-smoke", action="store_true",
                    help="exercise the Mapper placement queue and exit")
    args = ap.parse_args(argv)
    if args.placement_smoke:
        _placement_smoke(device=args.device)
        return
    if not args.arch:
        ap.error("--arch is required unless --placement-smoke")
    out = serve(args.arch, args.batch, args.prompt_len, args.gen,
                smoke=args.smoke, seed=args.seed, device=args.device)
    print(f"prefill {out['prefill_s']:.2f}s, "
          f"decode {out['decode_tok_per_s']:.1f} tok/s")
    print("sample:", out["tokens"][0, :12].tolist())


if __name__ == "__main__":
    main()
