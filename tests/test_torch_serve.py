"""The port's mapping service against the JAX package, on the CPU.

``repro_torch.launch.serve.MappingService`` (the shape-bucketed,
batching service), ``placement_service`` and ``--placement-smoke``,
``repro_torch.launch.specs`` and ``Mapper.serve``/``MapperService``,
everything on ``device="cpu"`` (the kernels' plain versions).  The JAX
package's own service tests (``tests/test_plan.py``,
``tests/test_mapping_spec.py``, ``tests/test_obs.py``,
``tests/test_portfolio.py``) run here against the port, and the same
bursts go through ``repro``'s service and the port's: per ticket the
permutations are equal exactly and the objectives equal (integer
weights: every float32 sum is exact), ``stats()`` has the same keys and
counts and ``prometheus()`` the same metric names.  Bursts that are
compared tick for tick are submitted whole into one tick (``max_wait_s``
of a second, no more requests than ``max_batch``), so the grouping does
not depend on timing.
"""

import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as rc
import repro_torch.core as tc
from repro.launch import serve as ref_serve
from repro.launch import specs as ref_specs
from repro_torch.core.spec import PortfolioSpec
from repro_torch.launch import specs as port_specs
from repro_torch.launch.serve import MappingService, placement_service
from repro_torch.obs import parse_prometheus
from repro_torch.portfolio import search as port_search
from repro_torch.testing import tensors_in
from test_torch_portfolio import jax_kick_draws

REPO = Path(__file__).resolve().parents[1]
H64 = tc.Hierarchy((4, 4, 4), (1.0, 10.0, 100.0))
REF_H64 = rc.Hierarchy((4, 4, 4), (1.0, 10.0, 100.0))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _dev_spec(**kw):
    base = dict(construction="random", neighborhood="communication",
                neighborhood_dist=2, preconfiguration="fast",
                engine="device", seed=1)
    base.update(kw)
    return tc.MappingSpec(**base)


def _ref_spec(spec):
    return rc.MappingSpec.from_dict(spec.to_dict())


def _mapper(spec, machine=H64, **kw):
    return tc.Mapper(machine, spec, device="cpu", **kw)


def _service(mapper, **kw):
    kw.setdefault("max_wait_s", 0.05)
    return MappingService(mapper, **kw)


def _weighted_grids(count):
    out = []
    for i in range(count):
        g = tc.grid3d(4, 4, 4)
        g.adjwgt = g.adjwgt * (1.0 + 0.5 * i)
        out.append(g)
    return out


def _workload(seed=3):
    return tc.random_geometric(64, 0.3, seed=seed)


def _ref_graph(g):
    return rc.CommGraph(g.xadj.copy(), g.adjncy.copy(), g.adjwgt.copy(),
                        g.vwgt.copy())


def _integer_burst():
    """Three stencils with seeded integer weights (one bucket), the first
    repeated right after the second, then two random geometric graphs
    with integer weights (other buckets): the first tick of four holds
    the stencils."""
    rng = np.random.default_rng(9)
    stencil = tc.grid3d(4, 4, 4)
    u, v, _ = stencil.edge_list()
    s0, s1, s2 = [tc.from_edges(64, u, v, rng.integers(1, 10, len(u)) * 1.0)
                  for _ in range(3)]
    graphs = [s0, s1, s0, s2]
    for seed, radius in ((3, 0.25), (5, 0.3)):
        g = tc.random_geometric(64, radius, seed=seed)
        gu, gv, _ = g.edge_list()
        graphs.append(tc.from_edges(64, gu, gv,
                                    rng.integers(1, 10, len(gu)) * 1.0))
    return graphs


def _drain(svc, tickets, timeout=300):
    return dict(svc.results.get(timeout=timeout) for _ in tickets)


def _assert_same_result(a, b):
    assert np.array_equal(np.asarray(a.perm), np.asarray(b.perm))
    assert a.initial_objective == b.initial_objective
    assert a.final_objective == b.final_objective


# ------------------------------------------------- the port against repro
@pytest.mark.parametrize("quality", [None, "fast"])
def test_service_burst_equals_repro_per_ticket(quality):
    """One burst through both services, submitted whole before the first
    tick closes: a tick of same-bucket stencils with an in-tick repeat
    (the batch branch: 3 uniques padded to 4 lanes), then a tick of
    other-bucket singles, a second seed, a warm-cache repeat and a size
    mismatch.  Per ticket the same permutation and objectives, the same
    error type; the same accounting, ``stats()`` keys and metric
    names."""
    spec = _dev_spec(seed=0)
    graphs = _integer_burst()
    knobs = dict(max_batch=4, max_wait_s=1.0)
    runs = {}
    for side in ("ref", "port"):
        if side == "ref":
            svc = ref_serve.MappingService(
                rc.Mapper(REF_H64, _ref_spec(spec)), **knobs)
            gs = [_ref_graph(g) for g in graphs]
            bad, other = rc.grid3d(3, 3, 3), _ref_spec(spec.replace(seed=7))
        else:
            svc = MappingService(_mapper(spec), **knobs)
            gs, bad, other = graphs, tc.grid3d(3, 3, 3), spec.replace(seed=7)
        with svc:
            tickets = [svc.submit(g, quality=quality) for g in gs]
            tickets.append(svc.submit(gs[4], other, quality=quality))
            tickets.append(svc.submit(gs[1], quality=quality))
            tickets.append(svc.submit(bad, quality=quality))
            got = _drain(svc, tickets)
            stats = svc.stats()
            metrics = set(parse_prometheus(svc.prometheus()))
        runs[side] = (tickets, got, stats, metrics)
    (t_ref, ref, s_ref, m_ref), (t_port, port, s_port, m_port) = \
        runs["ref"], runs["port"]
    assert t_ref == t_port
    for t in t_port[:-1]:
        _assert_same_result(ref[t], port[t])
        assert sorted(port[t].perm.tolist()) == list(range(64))
    assert isinstance(ref[t_ref[-1]], ValueError)
    assert isinstance(port[t_port[-1]], ValueError)
    assert set(s_port) == set(s_ref)
    for key in ("served", "batches", "batched_requests", "max_batch_seen",
                "result_cache_hits", "in_tick_deduped", "errors",
                "result_cache_size", "quality_served",
                "engine_sweeps_total"):
        assert s_port[key] == s_ref[key], key
    assert (s_port["batches"], s_port["batched_requests"],
            s_port["in_tick_deduped"], s_port["result_cache_hits"],
            s_port["errors"]) == (1, 4, 1, 1, 1)
    assert m_port == m_ref


def test_service_results_hold_no_device_tensors():
    """What the service hands out (and caches) lives on the host: a numpy
    perm and stats of floats and numpy arrays, telemetry included."""
    with _service(_mapper(_dev_spec()), collect_telemetry=True) as svc:
        first = svc.map(_workload(), timeout=300)
        again = svc.map(_workload(), timeout=300)     # from the cache
        cached = list(svc._result_cache.values())
    for res in [first, again] + cached:
        assert isinstance(res.perm, np.ndarray)
        assert res.search_stats.telemetry is not None
        assert tensors_in(res) == 0


def test_service_batch_failure_isolates_per_request_on_same_device(
        monkeypatch):
    """A batch that fails is retried request by request through
    ``mapper.map`` (same Mapper, same device); a request that fails
    again surfaces as its own exception and in ``errors``, the others
    still get their mappings."""
    mapper = _mapper(_dev_spec())
    graphs = _weighted_grids(3)
    poisoned = graphs[1]
    calls = []
    orig_map = mapper.map

    def failing_batch(self, *a, **kw):
        raise RuntimeError("kernel launch failed")

    def map_once(g, spec=None, telemetry=False):
        calls.append(g)
        if g is poisoned:
            raise RuntimeError("kernel launch failed again")
        return orig_map(g, spec=spec, telemetry=telemetry)

    monkeypatch.setattr(tc.MappingPlan, "execute_batch", failing_batch)
    monkeypatch.setattr(mapper, "map", map_once)
    with _service(mapper, max_batch=4, max_wait_s=1.0) as svc:
        tickets = [svc.submit(g) for g in graphs]
        got = _drain(svc, tickets)
        stats = svc.stats()
    assert calls == graphs
    assert isinstance(got[tickets[1]], RuntimeError)
    want = _mapper(_dev_spec())
    for t, g in ((tickets[0], graphs[0]), (tickets[2], graphs[2])):
        assert np.array_equal(got[t].perm, want.map(g).perm)
    assert stats["errors"] == 1 and stats["served"] == 3
    assert stats["batches"] == 0


def test_mapper_serve_equals_repro():
    spec = _dev_spec(neighborhood_dist=2)
    graphs = _integer_burst()
    with _mapper(spec).serve() as svc:
        tickets = [svc.submit(g) for g in graphs]
        got = _drain(svc, tickets, timeout=120)
    with rc.Mapper(REF_H64, _ref_spec(spec)).serve() as ref:
        rt = [ref.submit(_ref_graph(g)) for g in graphs]
        want = _drain(ref, rt, timeout=120)
    assert tickets == rt
    for t in tickets:
        _assert_same_result(want[t], got[t])


def test_placement_defaults_equal_repro():
    assert port_specs.placement_service_config() == \
        ref_specs.placement_service_config()
    assert port_specs.placement_spec().to_dict() == \
        ref_specs.placement_spec().to_dict()
    assert port_specs.placement_spec(5).to_dict() == \
        ref_specs.placement_spec(5).to_dict()
    assert port_specs.placement_spec().engine == "host"
    with placement_service(device="cpu") as svc:
        h, ref_h = svc.mapper.h, rc.tpu_v5e_fleet(pods=2)
        assert svc.mapper.device.type == "cpu"
        assert isinstance(svc, MappingService)
        assert (svc.max_batch, svc.max_wait_s, svc.schedule,
                svc._result_cache_size) == (4, 0.005, "pow2", 256)
    assert h.n_pe == ref_h.n_pe == 512
    assert tuple(h.hierarchy.factors) == tuple(ref_h.factors)
    assert tuple(h.hierarchy.distances) == tuple(ref_h.distances)


def test_placement_smoke_cli_equals_repro():
    """``--placement-smoke --device cpu`` prints the reference's lines:
    the same J and identity ratios, the same accounting."""
    def run(args, module):
        env = {"PYTHONPATH": str(REPO / "src"), "JAX_PLATFORMS": "cpu",
               "PATH": "/usr/bin:/bin"}
        out = subprocess.run([sys.executable, "-m", module, *args],
                             capture_output=True, text=True, env=env,
                             cwd=REPO, timeout=300)
        assert out.returncode == 0, out.stderr
        return out.stdout.splitlines()

    port = run(["--placement-smoke", "--device", "cpu"],
               "repro_torch.launch.serve")
    ref = run(["--placement-smoke"], "repro.launch.serve")

    def stable(lines):
        return [ln.split(" p50=")[0] for ln in lines]
    assert stable(port) == stable(ref)
    assert port[-1] == "placement service: ok"
    assert sum(ln.startswith("request ") for ln in port) == 4


def test_bench_port_serve_smoke_accounting(tmp_path):
    out = tmp_path / "serve.json"
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"}
    run = subprocess.run(
        [sys.executable, "benchmarks/bench_port_serve.py", "--smoke",
         "--device", "cpu", "--out", str(out)], capture_output=True,
        text=True, env=env, cwd=REPO, timeout=300)
    assert run.returncode == 0, run.stderr
    payload = json.loads(out.read_text())
    assert json.loads(run.stdout.splitlines()[-1]) == payload
    ref_keys = {"mode", "n_pe", "requests", "distinct_structures",
                "repeats_per_structure", "service_config", "baseline",
                "service", "headline"}
    assert ref_keys <= set(payload)
    svc = payload["service"]
    assert payload["device"] == {"type": "cpu"}
    assert payload["requests"] == 48 and payload["n_pe"] == 64
    assert svc["errors"] == 0
    assert svc["result_cache_hits"] + svc["in_tick_deduped"] == \
        payload["requests"] - payload["distinct_structures"]
    assert svc["kernel_launches"]["pair_gains"] == 0     # the CPU
    assert payload["service_config"] == \
        port_specs.placement_service_config()


# ------------------------------------- the JAX package's service tests
def test_service_batching_matches_sequential_singles():
    spec = _dev_spec()
    graphs = _weighted_grids(4) + [tc.random_geometric(64, 0.25, seed=7)]
    singles = [_mapper(spec).map(g) for g in graphs]
    with _service(_mapper(spec)) as svc:
        tickets = [svc.submit(g) for g in graphs]
        got = _drain(svc, tickets)
    for t, want in zip(tickets, singles):
        res = got[t]
        assert not isinstance(res, Exception)
        assert sorted(res.perm.tolist()) == list(range(64))
        assert res.final_objective == pytest.approx(want.final_objective,
                                                    rel=1e-5)


def test_service_warm_cache_answers_repeats_exactly():
    spec = _dev_spec()
    g = tc.grid3d(4, 4, 4)
    with _service(_mapper(spec)) as svc:
        first = svc.map(g, timeout=300)
        again = svc.map(g, timeout=300)
        stats = svc.stats()
    assert stats["result_cache_hits"] >= 1
    assert np.array_equal(first.perm, again.perm)
    assert first.final_objective == again.final_objective
    # cached results are copies: mutating one must not poison the cache
    again.perm[:] = -1
    assert sorted(first.perm.tolist()) == list(range(64))


def test_service_burst_of_mixed_shapes_orders_and_isolates():
    spec = _dev_spec()
    graphs = (_weighted_grids(3)
              + [tc.random_geometric(64, 0.3, seed=i) for i in range(3)]
              + [tc.grid3d(4, 4, 4)] * 3)       # repeats inside the burst
    with _service(_mapper(spec), max_pending=64) as svc:
        tickets = [svc.submit(g) for g in graphs]
        bad = svc.submit(tc.grid3d(3, 3, 3))    # size mismatch mid-burst
        tickets.append(bad)
        got = _drain(svc, tickets)
        stats = svc.stats()
    # exactly one result per ticket, in whatever completion order
    assert sorted(got) == sorted(tickets)
    assert isinstance(got[bad], ValueError)
    for t in tickets[:-1]:
        assert not isinstance(got[t], Exception), got[t]
    assert stats["served"] == len(tickets)
    assert stats["errors"] == 1
    assert stats["peak_queue_depth"] >= 1
    assert (stats["result_cache_hits"] + stats["in_tick_deduped"]) >= 2
    assert stats["latency_p99_s"] >= stats["latency_p50_s"] >= 0.0


def test_service_groups_by_seed_and_never_cross_serves():
    """Same spec, different seeds, one burst: each ticket must get its
    own seed's mapping, and the warm cache must not cross-pollinate."""
    spec = _dev_spec(construction="random", seed=0)
    g = tc.grid3d(4, 4, 4)
    want0 = _mapper(spec).map(g)
    want7 = _mapper(spec.replace(seed=7)).map(g)
    assert not np.array_equal(want0.perm, want7.perm)
    with _service(_mapper(spec)) as svc:
        t0 = svc.submit(g)
        t7 = svc.submit(g, spec.replace(seed=7))
        got = dict(svc.results.get(timeout=300) for _ in range(2))
        # and again after the cache is warm
        again7 = svc.map(g, spec.replace(seed=7), timeout=300)
    assert np.array_equal(got[t0].perm, want0.perm)
    assert np.array_equal(got[t7].perm, want7.perm)
    assert np.array_equal(again7.perm, want7.perm)


def test_service_backpressure_bounds_queue_and_close_rejects():
    spec = tc.MappingSpec(construction="identity", neighborhood=None,
                          preconfiguration="fast")
    svc = _service(_mapper(spec), max_pending=2)
    assert svc.requests.maxsize == 2
    with svc:
        t = svc.submit(tc.grid3d(4, 4, 4))
        _, res = svc.results.get(timeout=300)
        assert not isinstance(res, Exception)
        assert t == 0
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit(tc.grid3d(4, 4, 4))


def test_service_map_timeout_is_a_deadline():
    """map()'s timeout bounds the total wait even while foreign results
    cycle through the queue."""
    from repro_torch.core.construction import CONSTRUCTIONS, \
        register_construction

    @register_construction("_test_slow")
    def _slow(g, h, **_):
        time.sleep(1.5)
        return np.arange(g.n, dtype=np.int64)

    try:
        spec = tc.MappingSpec(construction="_test_slow", neighborhood=None,
                              preconfiguration="fast")
        with _service(_mapper(spec), max_wait_s=0.001) as svc:
            svc.results.put((999_999, "foreign"))  # never-matching ticket
            t0 = time.perf_counter()
            with pytest.raises(TimeoutError, match="within"):
                svc.map(tc.grid3d(4, 4, 4), timeout=0.3)
            assert time.perf_counter() - t0 < 1.2   # fired at the
            # deadline, not after the worker finally answered
    finally:
        del CONSTRUCTIONS["_test_slow"]


def test_placement_service_runs_on_mapping_service():
    h = tc.Hierarchy((4, 4), (1.0, 10.0))
    with placement_service(h, spec=tc.MappingSpec(preconfiguration="fast",
                                                  neighborhood=None),
                           device="cpu") as svc:
        assert isinstance(svc, MappingService)
        res = svc.map(tc.grid3d(4, 4, 1), timeout=300)
    assert sorted(res.perm.tolist()) == list(range(16))


def test_serve_queue_matches_map():
    mapper = _mapper(tc.MappingSpec(neighborhood="communication",
                                    neighborhood_dist=2,
                                    preconfiguration="fast"))
    graphs = _weighted_grids(3)
    want = {i: mapper.map(g) for i, g in enumerate(graphs)}
    with mapper.serve() as svc:
        tickets = [svc.submit(g) for g in graphs]
        got = _drain(svc, tickets, timeout=120)
    assert sorted(got) == tickets
    for i in tickets:
        assert np.array_equal(got[i].perm, want[i].perm)
        assert got[i].final_objective == want[i].final_objective


def test_serve_isolates_per_request_failures():
    mapper = _mapper(tc.MappingSpec(preconfiguration="fast",
                                    neighborhood=None))
    with mapper.serve() as svc:
        bad = svc.submit(tc.grid3d(3, 3, 3))  # size mismatch → error result
        good = svc.submit(tc.grid3d(4, 4, 4))
        got = dict(svc.results.get(timeout=120) for _ in range(2))
    assert isinstance(got[bad], ValueError)
    assert sorted(got[good].perm.tolist()) == list(range(64))


def test_serve_rejects_submit_after_close():
    svc = _mapper(tc.MappingSpec(neighborhood=None,
                                 preconfiguration="fast")).serve()
    svc.close()
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit(tc.grid3d(4, 4, 4))


def test_service_prometheus_exposes_served_counters():
    with _service(_mapper(_dev_spec()), max_wait_s=0.002) as svc:
        svc.map(_workload(), timeout=300)
        text = svc.prometheus()
    back = parse_prometheus(text)
    assert back["viem_served"]["samples"][""] >= 1.0
    assert back["viem_served"]["type"] == "counter"
    assert back["viem_latency_s"]["type"] == "summary"


def test_service_stats_compat_keys_and_engine_aggregates():
    legacy = {"served", "batches", "batched_requests", "max_batch_seen",
              "result_cache_hits", "in_tick_deduped",
              "result_cache_size", "errors", "quality_served",
              "queue_depth", "peak_queue_depth", "latency_p50_s",
              "latency_p99_s"}
    with _service(_mapper(_dev_spec()), max_wait_s=0.002,
                  collect_telemetry=True) as svc:
        for s in (3, 5, 3):
            svc.map(_workload(s), timeout=300)
        stats = svc.stats()
    assert legacy <= set(stats)
    assert stats["served"] == 3
    assert stats["latency_count"] == 3
    assert stats["telemetry_requests"] >= 1
    assert stats["engine_sweeps_total"] > 0
    assert stats["engine_mean_sweeps_per_request"] > 0
    assert stats["quality_served"] == {"default": 3}


def test_service_reset_stats_zeroes_registry():
    with _service(_mapper(_dev_spec()), max_wait_s=0.002) as svc:
        svc.map(_workload(), timeout=300)
        assert svc.stats()["served"] == 1
        svc.reset_stats()
        stats = svc.stats()
    assert stats["served"] == 0
    assert stats["latency_count"] == 0
    assert stats["latency_p99_s"] == 0.0
    assert stats["quality_served"] == {"default": 0}


def test_service_stats_never_tear_under_burst():
    """A monitoring thread polling during a burst must always observe
    served == latency_count (they update under one registry lock)."""
    torn = []
    stop = threading.Event()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with _service(_mapper(_dev_spec()), max_wait_s=0.002) as svc:
            svc.map(_workload(), timeout=300)      # warm the plan first

            def monitor():
                while not stop.is_set():
                    s = svc.stats()
                    if s["served"] != s["latency_count"]:
                        torn.append((s["served"], s["latency_count"]))

            t = threading.Thread(target=monitor)
            t.start()
            try:
                tickets = [svc.submit(_workload(i % 4)) for i in range(24)]
                for _ in tickets:
                    _, res = svc.results.get(timeout=300)
                    assert not isinstance(res, Exception)
            finally:
                stop.set()
                t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(switch)
    assert torn == []


def test_service_without_telemetry_keeps_counters_quiet():
    with _service(_mapper(_dev_spec()), max_wait_s=0.002) as svc:
        svc.map(_workload(), timeout=300)
        stats = svc.stats()
    assert stats["telemetry_requests"] == 0
    assert stats["engine_exchanges_total"] == 0
    assert stats["engine_sweeps_total"] > 0   # from the objective trace


def test_service_quality_classes_share_one_plan_cache(monkeypatch):
    """The JAX package's quality-class test, and with the port's kick
    draws replaced by the reference's (here only) each class's result
    equal to ``repro``'s service."""
    monkeypatch.setattr(port_search, "kick_draws", jax_kick_draws)
    g = tc.grid3d(4, 4, 4)
    spec = _dev_spec()
    mapper = _mapper(spec)
    strong = PortfolioSpec(lanes=2, rounds=2, stagnation=1)
    with MappingService(mapper, max_wait_s=0.05,
                        quality_classes={"fast": None,
                                         "strong": strong}) as svc:
        rf = svc.map(g, quality="fast", timeout=300)
        rs = svc.map(g, quality="strong", timeout=300)
        rd = svc.map(g, timeout=300)            # spec as-is = fast path
        stats = svc.stats()
        with pytest.raises(ValueError, match="quality"):
            svc.submit(g, quality="turbo")
    assert stats["quality_served"] == {"fast": 1, "strong": 1,
                                       "default": 1}
    # the default request is answered by the fast class's plan/cache
    assert np.array_equal(rd.perm, rf.perm)
    assert rs.final_objective <= rf.final_objective + 1e-9
    # fast + default share one plan; strong adds exactly one more
    assert mapper.cache_info()["plan_builds"] == 2

    from repro.core.spec import PortfolioSpec as RefPortfolioSpec
    ref_strong = RefPortfolioSpec(lanes=2, rounds=2, stagnation=1)
    with ref_serve.MappingService(
            rc.Mapper(REF_H64, _ref_spec(spec)), max_wait_s=0.05,
            quality_classes={"fast": None, "strong": ref_strong}) as ref:
        want_f = ref.map(_ref_graph(g), quality="fast", timeout=300)
        want_s = ref.map(_ref_graph(g), quality="strong", timeout=300)
    _assert_same_result(want_f, rf)
    _assert_same_result(want_s, rs)
    assert want_s.search_stats.objective_trace == \
        rs.search_stats.objective_trace


def test_strong_request_on_host_spec_forces_the_device_engine():
    """A "strong" request over a host-engine spec (``placement_spec()``'s
    engine) runs the portfolio on the device engine, as the reference
    resolves it."""
    spec = tc.MappingSpec(construction="random", neighborhood_dist=2,
                          preconfiguration="fast", seed=0)
    assert spec.engine == "host"
    mapper = _mapper(spec)
    svc = MappingService(mapper, max_wait_s=0.01,
                         quality_classes={"strong": PortfolioSpec(
                             lanes=2, rounds=2)})
    with svc:
        svc.map(tc.grid3d(4, 4, 4), quality="strong", timeout=300)
    ((_, bucket), plan), = list(mapper._plans.items())
    assert plan.spec.engine == "device" and plan.portfolio is not None
    assert bucket is not None and bucket.schedule == "pow2"
