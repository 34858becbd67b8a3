"""Serving benchmark of the PyTorch/CUDA port — the shape-bucketed
`MappingService` vs per-request ``Mapper.map`` on mixed-shape traffic,
on one device (the card unless ``--device cpu``).

The port of ``benchmarks/bench_serve.py``, with the same traffic,
warm-up, baseline and payload keys.  The traffic model is a serving
fleet's steady state: a handful of distinct communication patterns
(graphs of different densities, so they land in different shape buckets)
recur across requests — recompiled serving programs usually re-emit the
pattern they had before.  Both sides get the same shuffled request
stream and a warm-up on *separate* graphs (the warm result cache starts
cold, so every hit it scores during the timed run is earned from the
traffic's own repeats):

  * baseline — one ``Mapper`` session, sequential ``map()`` per request
    (plans are cached, so the baseline already amortizes lowering);
  * service — ``MappingService`` with the fleet's
    ``placement_service_config()``: pow2 buckets, dynamic batching into
    ``execute_batch`` calls (one K1/K2 launch a sweep for the batch's
    lanes on the card), in-tick dedup, warm result cache.

Prints one JSON payload: wall-clock throughput, per-request p50/p99
latency, batch/cache accounting, the K1/K2 launches of each timed side,
the device, and the headline ``throughput_speedup``.  ``--out`` also
writes it to a file.

    PYTHONPATH=src python benchmarks/bench_port_serve.py [--smoke] \
        [--device cpu] [--out serve.json]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.core import CommGraph, Hierarchy, Mapper, MappingSpec, \
    random_geometric, tpu_v5e_fleet
from repro_torch.kernels import KERNELS
from repro_torch.launch.serve import MappingService
from repro_torch.launch.specs import placement_service_config
from repro_torch.runtime.device import resolve_device

REPEATS = 8          # requests per distinct traffic pattern
STRUCTURES = 6       # distinct patterns (≈3 pow2 buckets at these radii)


def _machine(smoke: bool):
    return (Hierarchy((4, 4, 4), (1.0, 10.0, 100.0)) if smoke
            else tpu_v5e_fleet(pods=1))


def _spec() -> MappingSpec:
    return MappingSpec(construction="random", neighborhood="communication",
                       neighborhood_dist=2, preconfiguration="fast",
                       engine="device", seed=0)


def _traffic(n: int, rng: np.random.Generator):
    """Mixed-shape request stream: STRUCTURES distinct densities (so the
    service sees several shape buckets), REPEATS requests each,
    shuffled."""
    base = 0.8 / np.sqrt(n)
    distinct = [random_geometric(n, base * (1.0 + 0.35 * i), seed=100 + i)
                for i in range(STRUCTURES)]
    stream = [g for g in distinct for _ in range(REPEATS)]
    rng.shuffle(stream)
    return distinct, stream


def _pct(lat, q):
    lat = sorted(lat)
    return lat[min(len(lat) - 1, int(q * len(lat)))] if lat else 0.0


def _launches() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


def run(report, smoke: bool = False, out: str | None = None,
        device=None) -> dict:
    dev = resolve_device(device)
    machine = _machine(smoke)
    spec = _spec()
    rng = np.random.default_rng(0)
    distinct, stream = _traffic(machine.n_pe, rng)

    # warm-up on weight-perturbed copies: same buckets, shapes and plans,
    # different content — the warm result cache starts cold for the
    # timed stream, so every hit it scores is earned
    def _perturb(scale):
        return [CommGraph(g.xadj.copy(), g.adjncy.copy(),
                          g.adjwgt * scale, g.vwgt.copy())
                for g in distinct]

    warm_single = _perturb(1.5)
    warm_burst = _perturb(2.0)

    # ---- baseline: sequential per-request Mapper.map
    base_mapper = Mapper(machine, spec, device=dev)
    for g in warm_single:
        base_mapper.map(g)
    lat_base = []
    k0 = _launches()
    t0 = time.perf_counter()
    for g in stream:
        t1 = time.perf_counter()
        base_mapper.map(g)
        lat_base.append(time.perf_counter() - t1)
    t_base = time.perf_counter() - t0
    k1 = _launches()

    # ---- service: shape-bucketed dynamic batching + warm cache
    cfg = placement_service_config()
    svc = MappingService(Mapper(machine, spec, device=dev), **cfg)
    try:
        # warm both lane shapes per bucket: singles first, then one burst
        # of fresh content so each bucket's padded batch runs too (a
        # repeat burst would just hit the result cache)
        for g in warm_single:
            svc.map(g, timeout=600)
        burst = [svc.submit(g) for g in warm_burst]
        for _ in burst:
            svc.results.get(timeout=600)
        svc.reset_stats()
        k2 = _launches()
        t0 = time.perf_counter()
        tickets = [svc.submit(g) for g in stream]
        done = 0
        while done < len(tickets):
            _, res = svc.results.get(timeout=600)
            if isinstance(res, Exception):
                raise res
            done += 1
        t_serve = time.perf_counter() - t0
        k3 = _launches()
        stats = svc.stats()
        info = svc.mapper.cache_info()
    finally:
        svc.close()

    n_req = len(stream)
    thr_base = n_req / max(t_base, 1e-9)
    thr_serve = n_req / max(t_serve, 1e-9)
    speedup = thr_serve / max(thr_base, 1e-9)
    device_info = {"type": dev.type}
    if dev.type == "cuda":
        import torch
        device_info["name"] = torch.cuda.get_device_name(dev)
    payload = {
        "mode": "smoke" if smoke else "full",
        "device": device_info,
        "n_pe": machine.n_pe,
        "requests": n_req,
        "distinct_structures": STRUCTURES,
        "repeats_per_structure": REPEATS,
        "service_config": cfg,
        "baseline": {
            "seconds": t_base,
            "throughput_rps": thr_base,
            "latency_p50_s": _pct(lat_base, 0.50),
            "latency_p99_s": _pct(lat_base, 0.99),
            "kernel_launches": {k: k1[k] - k0[k] for k in k0},
        },
        "service": {
            "seconds": t_serve,
            "throughput_rps": thr_serve,
            "latency_p50_s": stats["latency_p50_s"],
            "latency_p99_s": stats["latency_p99_s"],
            "batches": stats["batches"],
            "batched_requests": stats["batched_requests"],
            "max_batch_seen": stats["max_batch_seen"],
            "result_cache_hits": stats["result_cache_hits"],
            "in_tick_deduped": stats["in_tick_deduped"],
            "errors": stats["errors"],
            "peak_queue_depth": stats["peak_queue_depth"],
            "plan_builds": info["plan_builds"],
            "plan_buckets": sorted(info["plans"]),
            "kernel_launches": {k: k3[k] - k2[k] for k in k2},
        },
        "headline": {
            "throughput_speedup": speedup,
            "meets_3x": speedup >= 3.0,
        },
    }
    if out is not None:
        with open(out, "w") as fh:
            json.dump(payload, fh, indent=2)
    report("serve/baseline/us_per_req", t_base / n_req * 1e6,
           f"p99={_pct(lat_base, 0.99):.3f}s")
    report("serve/service/us_per_req", t_serve / n_req * 1e6,
           f"p99={stats['latency_p99_s']:.3f}s;"
           f"batches={stats['batches']};"
           f"warm_hits={stats['result_cache_hits']}")
    report("serve/speedup", 0,
           f"x{speedup:.2f};meets_3x={speedup >= 3.0}")
    return payload


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="64-PE machine (CI)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--out", default=None,
                    help="also write the JSON payload to this file")
    args = ap.parse_args(argv)
    payload = run(lambda n, us, d: print(f"{n},{us:.0f},{d}", flush=True),
                  smoke=args.smoke, out=args.out, device=args.device)
    print(json.dumps(payload), flush=True)


if __name__ == "__main__":
    main()
