"""The port's closed remapping loop (``repro_torch.monitor``), its
metrics and exporters (``repro_torch.obs``), the fault signals
(``repro_torch.runtime.fault_tolerance``), ``fleet_monitor`` and ``viem
remap-watch`` against the JAX package's, on the CPU.

Every comparison feeds the same seeded numpy inputs through the
reference and the port and is exact unless it says otherwise: the loop's
tick reports (every field but ``remap_seconds``, a wall time), final
incumbents and remap counts are equal on all five topologies, and the
drift scores are equal to the last bit because both sides price with the
same float64 host objective (``backend="numpy"``) or, with
``backend="pallas"``, with K1 on integer weights, where every float32
sum is exact.  The CLI's lines are held exactly with ``--jitter 0`` and
to a relative 1e-6 per number otherwise; Prometheus text is held byte
for byte except the samples of time-valued (``*_seconds``) summaries,
which are wall times, and whose sample counts are held.
"""

import dataclasses
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as rc
import repro.monitor as rm
import repro.obs as ro
import repro.runtime.fault_tolerance as rft
import repro.topology as rt
import repro_torch.core as tc
import repro_torch.monitor as tm
import repro_torch.obs as to
import repro_torch.runtime.fault_tolerance as tft
import repro_torch.topology as tt
from repro_torch import convert

FIXTURE = Path(__file__).parent / "fixtures" / "collectives.hlo"
SRC = str(Path(__file__).parents[1] / "src")
TOPOLOGIES = ["tree", "torus", "fattree", "dragonfly", "matrix"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _machine(mod, core, name):
    if name == "tree":
        return mod.TreeTopology(hierarchy=core.Hierarchy(
            (4, 4, 4), (1.0, 10.0, 100.0)))
    if name == "torus":
        return mod.make_topology("torus", dims=[8, 8])
    if name == "fattree":
        return mod.FatTreeTopology((4, 4, 4), (1.0, 2.0, 5.0))
    if name == "dragonfly":
        return mod.DragonflyTopology(4, 4, 4)
    torus = mod.TorusTopology((4, 4, 4))
    return mod.MatrixTopology(matrix=torus.distance_matrix() * 3.0)


def _port_graph(g):
    return convert.graph(g.xadj, g.adjncy, g.adjwgt, g.vwgt)


def _scaled(g, vertices, factor):
    """Scale every edge incident to ``vertices`` by ``factor``."""
    u, v, w = g.edge_list()
    m = np.zeros(g.n, bool)
    m[list(vertices)] = True
    return rc.from_edges(g.n, u, v, np.where(m[u] | m[v], w * factor, w))


def _plans(name, schedule="pow2", backend="numpy"):
    spec = rc.MappingSpec(construction="hierarchytopdown",
                          neighborhood="communication", neighborhood_dist=10,
                          engine="device", backend=backend, seed=0)
    g = rc.grid3d(4, 4, 4)
    ref = rc.Mapper(_machine(rt, rc, name), spec).lower_for(
        g, schedule=schedule)
    port = tc.Mapper(_machine(tt, tc, name), convert.spec(spec.to_dict()),
                     device="cpu").lower_for(_port_graph(g),
                                             schedule=schedule)
    return ref, port, g


def _row(report) -> dict:
    row = dataclasses.asdict(report)
    del row["remap_seconds"]                    # a wall time
    return row


# ----------------------------------------------------------------- the loop
def _episode(name):
    """(windows, actions, config overrides, schedule) of one episode:
    ``actions[t]`` is applied before window t's tick."""
    g = rc.grid3d(4, 4, 4)
    u, v, w = g.edge_list()
    if name == "quiet":
        rng = np.random.default_rng(1)
        wins = [rc.from_edges(g.n, u, v, w * rng.uniform(0.99, 1.01, len(w)))
                for _ in range(6)]
        return wins, {}, {}, "pow2"
    if name == "shift":
        # a seeded quarter of the vertices: a shift the incumbent does
        # not already absorb on any of the five machines
        hot = np.random.default_rng(0).permutation(g.n)[:16]
        return [_scaled(g, hot, 8.0)] * 4, {}, {}, "pow2"
    if name == "rebalance":
        # a straggler flags host 1 (attach), then a second tenant surges
        return ([g] + [_scaled(g, range(40, 56), 8.0)] * 3,
                {1: "straggler"}, {}, "pow2")
    if name == "evict":
        return ([g] + [_scaled(g, range(8, 24), 4.0)] * 2,
                {1: "evict"}, {}, "pow2")
    # bucket_exceeded: a clique over the first 16 vertices outgrows the
    # tight bucket
    uu, vv = np.triu_indices(16, k=1)
    live = rc.from_edges(g.n, np.concatenate([u, uu]),
                         np.concatenate([v, vv]),
                         np.concatenate([w, np.full(len(uu), 50.0)]))
    return [live, g], {}, {"drift_patience": 1}, "tight"


def _run_loop(plan, g, windows, actions, overrides, port):
    mon_mod, ft = (tm, tft) if port else (rm, rft)
    kw = dict(drift_patience=2, min_weight=0.01)
    kw.update(overrides)
    conv = _port_graph if port else (lambda x: x)
    committed = []
    mon = mon_mod.RemapMonitor(plan, conv(g),
                               config=mon_mod.MonitorConfig(**kw), seed=0,
                               on_remap=lambda p, v: committed.append(
                                   p.copy()))
    rows = []
    for t, win in enumerate(windows):
        act = actions.get(t)
        if act == "straggler":
            sm = ft.StragglerMonitor(n_hosts=4, patience=2)
            mon.attach(sm)
            for _ in range(3):
                sm.record_step({h: (3.0 if h == 1 else 1.0)
                                for h in range(4)})
        elif act == "evict":
            mon.handle_action(ft.Action.EVICT_RESTART, [0])
        mon.observe_graph(conv(win))
        rows.append(_row(mon.tick()))
    return {"rows": rows, "incumbent": mon.incumbent.copy(),
            "remaps": mon.remaps, "committed": committed,
            "pairs": np.array(mon.pairs),
            "metrics": mon.registry.snapshot()}


def _both(name, episode, backend="numpy"):
    windows, actions, overrides, schedule = _episode(episode)
    ref_plan, port_plan, g = _plans(name, schedule, backend)
    ref = _run_loop(ref_plan, g, windows, actions, overrides, False)
    port = _run_loop(port_plan, g, windows, actions, overrides, True)
    assert port["rows"] == ref["rows"]
    np.testing.assert_array_equal(port["pairs"], ref["pairs"])
    np.testing.assert_array_equal(port["incumbent"], ref["incumbent"])
    assert port["remaps"] == ref["remaps"]
    assert len(port["committed"]) == len(ref["committed"])
    for a, b in zip(port["committed"], ref["committed"]):
        np.testing.assert_array_equal(a, b)
    # the registries agree on every counter and gauge; the remap-seconds
    # histogram holds wall times, so only its count is held
    rsnap, psnap = ref["metrics"], port["metrics"]
    assert set(psnap) == set(rsnap)
    for key, val in rsnap.items():
        if key == "monitor.remap_seconds":
            assert psnap[key]["count"] == val["count"]
        else:
            assert psnap[key] == val, key
    return port


@pytest.mark.parametrize("name", TOPOLOGIES)
def test_loop_shift_equals_reference(name):
    port = _both(name, "shift")
    # detected, gated and committed
    assert port["remaps"] >= 1
    assert any(r["triggered"] and r["verdict"]["accepted"]
               for r in port["rows"])


def test_loop_quiet_jitter_equals_reference_with_zero_remaps():
    port = _both("torus", "quiet")
    assert port["remaps"] == 0
    assert not any(r["triggered"] for r in port["rows"])


def test_loop_rebalance_through_attach_equals_reference():
    port = _both("torus", "rebalance")
    assert port["rows"][1]["forced_by"] == "rebalance"
    assert port["rows"][1]["verdict"] is not None
    assert port["metrics"]["monitor.action.rebalance"] >= 1


def test_loop_evict_restart_equals_reference():
    port = _both("torus", "evict")
    forced = port["rows"][1]
    assert forced["forced_by"] == "evict_restart"
    assert forced["dirty"] == 64                 # the whole region
    assert forced["active_pairs"] == len(port["pairs"])


def test_loop_bucket_exceeded_equals_reference():
    port = _both("torus", "bucket")
    assert port["rows"][0]["skipped"] == "bucket_exceeded"
    assert not port["rows"][0]["remapped"]
    assert port["metrics"]["monitor.bucket_exceeded"] == 1


@pytest.mark.parametrize("name", ["tree", "matrix"])
def test_loop_shift_through_the_objective_kernel_equals_reference(name):
    """``backend="pallas"``: drift and replay price with K1 (its plain
    version here, the Pallas kernel in interpret mode in the reference);
    integer weights, so every float32 sum is exact."""
    port = _both(name, "shift", backend="pallas")
    assert port["remaps"] >= 1


def test_loop_remaps_keep_the_pair_shape_and_freeze_the_rest():
    """Each warm remap refines the fixed pair array (P unchanged), moves
    no vertex outside the active pairs, and the engine's device-graph
    cache evicts rather than grows over a long watch."""
    _, plan, g = _plans("torus")
    calls = []
    orig = plan.execute_warm

    def recording(live, perm, pairs=None, active=None, **kw):
        res = orig(live, perm, pairs=pairs, active=active, **kw)
        calls.append((np.array(perm), np.array(pairs), np.array(active),
                      res.perm.copy()))
        return res

    plan.execute_warm = recording
    mon = tm.RemapMonitor(plan, _port_graph(g), config=tm.MonitorConfig(
        drift_patience=1, min_weight=0.01), seed=0)
    rng = np.random.default_rng(4)
    for _ in range(24):
        # a new window graph every tick, and a forced (REBALANCE) attempt
        # on a random host, so every tick runs a warm remap
        hot = rng.permutation(g.n)[:8]
        mon.handle_action(tft.Action.REBALANCE, [int(rng.integers(4))],
                          pes_per_host=16)
        mon.observe_graph(_port_graph(_scaled(g, hot, rng.uniform(2, 8))))
        mon.tick()
    assert len(calls) == 24
    eng = plan.engines[0]
    info = eng.cache_info()
    assert info["graph_entries"] <= eng._caps["graphs"]
    assert info["graph_evictions"] >= len(calls) - eng._caps["graphs"]
    for perm, pairs, active, out in calls:
        np.testing.assert_array_equal(pairs, mon.pairs)
        movable = np.zeros(g.n, bool)
        movable[pairs[active].ravel()] = True
        np.testing.assert_array_equal(out[~movable], perm[~movable])
        assert sorted(out.tolist()) == list(range(g.n))


# ------------------------------------------------- profiler, drift, dirty
def _random_graph(seed, n=24, m=60, integer=False):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n, m)
    v = rng.integers(0, n, m)
    keep = u != v
    w = (rng.integers(1, 20, m) * 1.0 if integer
         else rng.uniform(0.5, 30.0, m))
    return rc.from_edges(n, u[keep], v[keep], w[keep])


def _profile(mod, graph_conv):
    p = mod.TrafficProfiler(8, alpha=0.6, min_weight=0.5)
    rng = np.random.default_rng(7)
    lives = []
    for t in range(5):
        p.ingest_edges(rng.integers(0, 8, 12), rng.integers(0, 8, 12),
                       rng.uniform(0, 40, 12))
        if t % 2 == 0:
            p.ingest_hlo(FIXTURE.read_text())
        if t == 1:
            p.ingest_graph(graph_conv(_random_graph(3, n=8, m=20)))
        if t == 3:
            p.ingest_spans([_span(1, 5, 77.0), _span(2, 2, 5.0),
                            _span(None, None, None)])
        lives.append(p.end_window())
    return p, lives


def _span(src, dst, nbytes):
    attrs = {} if src is None else {"src": src, "dst": dst, "bytes": nbytes}
    return to.Span(name="send", attrs=attrs)


def test_profiler_equals_reference():
    rp, rl = _profile(rm, lambda g: g)
    pp, pl = _profile(tm, _port_graph)
    assert pp.live_edges() == rp.live_edges()
    assert pp.windows == rp.windows == 5
    for a, b in zip(pl, rl):
        for attr in ("xadj", "adjncy", "adjwgt", "vwgt"):
            np.testing.assert_array_equal(getattr(a, attr), getattr(b, attr))
    assert pp.registry.snapshot() == rp.registry.snapshot()
    assert pp.registry.to_prometheus() == rp.registry.to_prometheus()


def test_graph_from_dict_equals_reference():
    from repro.monitor.profiler import graph_from_dict as ref_fn
    from repro_torch.monitor.profiler import graph_from_dict as port_fn
    for edges in ({}, {(0, 1): 2.0, (2, 2): 5.0, (1, 3): -1.0},
                  {(3, 1): 4.5, (0, 2): 1.0}):
        a, b = port_fn(4, edges), ref_fn(4, edges)
        for attr in ("xadj", "adjncy", "adjwgt", "vwgt"):
            np.testing.assert_array_equal(getattr(a, attr), getattr(b, attr))


@pytest.mark.parametrize("seed", range(4))
def test_drift_and_dirty_sets_equal_reference(seed):
    base = _random_graph(seed)
    rng = np.random.default_rng(100 + seed)
    u, v, w = base.edge_list()
    lives = [rc.from_edges(base.n, u, v, w * rng.uniform(0.9, 1.6, len(w)))
             for _ in range(4)] + [_random_graph(seed + 50), base]
    perm = rng.permutation(base.n)
    topo_r = rt.make_topology("torus", dims=[4, 6])
    topo_p = tt.make_topology("torus", dims=[4, 6])
    det_r = rm.DriftDetector(base, perm,
                             lambda g, p: rc.qap_objective(g, topo_r, p),
                             high=0.2, low=0.1, patience=2)
    det_p = tm.DriftDetector(_port_graph(base), perm,
                             lambda g, p: tc.qap_objective(g, topo_p, p),
                             high=0.2, low=0.1, patience=2)
    pairs = np.stack([rng.integers(0, base.n, 40),
                      rng.integers(0, base.n, 40)], axis=1)
    for live in lives:
        pl = _port_graph(live)
        assert dataclasses.asdict(det_p.update(pl)) == \
            dataclasses.asdict(det_r.update(live))
        assert tm.edge_weight_l1(_port_graph(base), pl) == \
            rm.edge_weight_l1(base, live)
        for tol in (0.05, 0.3):
            d_r = rm.dirty_vertices(base, live, rel_tol=tol)
            d_p = tm.dirty_vertices(_port_graph(base), pl, rel_tol=tol)
            np.testing.assert_array_equal(d_p, d_r)
            for hops in (0, 1, 3):
                e_r = rm.expand_dirty(live, d_r, hops=hops)
                e_p = tm.expand_dirty(pl, d_p, hops=hops)
                np.testing.assert_array_equal(e_p, e_r)
                np.testing.assert_array_equal(
                    tm.dirty_pair_mask(pairs, e_p),
                    rm.dirty_pair_mask(pairs, e_r))
    assert det_p.registry.snapshot() == det_r.registry.snapshot()
    assert tm.dirty_pair_mask(np.zeros((0, 2), int), d_p).shape == (0,)


# ------------------------------------------------------------------ replay
@pytest.mark.parametrize("cost", ["none", "comm-bound", "compute-bound"])
def test_replay_verdicts_equal_reference(cost):
    from repro.analysis import analyze as ref_analyze
    from repro.analysis.hlo import HloCost as RefCost
    from repro_torch.analysis import analyze as port_analyze
    from repro_torch.analysis.hlo import HloCost as PortCost
    g = rc.grid3d(4, 4, 4)
    costs = {"none": (None, None),
             "comm-bound": (ref_analyze(FIXTURE.read_text()),
                            port_analyze(FIXTURE.read_text())),
             "compute-bound": (RefCost(flops=1e18), PortCost(flops=1e18))}
    rcost, pcost = costs[cost]
    rep_r = rm.WhatIfReplay(rt.make_topology("torus", dims=[8, 8]),
                            margin=0.02, cost=rcost)
    rep_p = tm.WhatIfReplay(tt.make_topology("torus", dims=[8, 8]),
                            margin=0.02, cost=pcost)
    rng = np.random.default_rng(5)
    perms = [np.arange(64), np.roll(np.arange(64), 7)] + \
        [rng.permutation(64) for _ in range(3)]
    for a in perms:
        for b in perms:
            vr = rep_r.evaluate(g, a, b)
            vp = rep_p.evaluate(_port_graph(g), a, b)
            assert vp.row() == vr.row()
            assert rep_p.predict_step_time(_port_graph(g), b) == \
                rep_r.predict_step_time(g, b)
    vr = rep_r.evaluate(g, perms[1], perms[0], j_incumbent=9.0,
                        j_candidate=4.0)
    vp = rep_p.evaluate(_port_graph(g), perms[1], perms[0],
                        j_incumbent=9.0, j_candidate=4.0)
    assert vp.row() == vr.row()
    assert rep_p.registry.snapshot() == rep_r.registry.snapshot()
    with pytest.raises(ValueError, match="margin"):
        tm.WhatIfReplay(tt.make_topology("torus", dims=[8, 8]), margin=-1)


# ----------------------------------------------------------------- metrics
def _fill(reg):
    with reg.lock:
        reg.counter("run.count").inc()
        reg.counter("engine.sweeps").inc(7)
        reg.gauge("monitor.drift.score").set(0.125)
        reg.gauge("service.queue-depth").set_max(3.0)
        reg.gauge("service.queue-depth").set_max(2.0)
        h = reg.histogram("monitor.traffic.edge_bytes", window=5)
        for x in (3.0, 1.5, 9.0, 2.25, 7.0, 0.5, 4.0):
            h.observe(x)
        reg.histogram("empty.hist")


def test_metrics_registry_and_prometheus_equal_reference():
    r, p = ro.MetricsRegistry(), to.MetricsRegistry()
    _fill(r)
    _fill(p)
    assert p.snapshot() == r.snapshot()
    text = p.to_prometheus()
    assert text == r.to_prometheus()                 # byte for byte
    assert to.parse_prometheus(text) == ro.parse_prometheus(text)
    parsed = to.parse_prometheus(text)
    assert parsed["viem_engine_sweeps"] == {"type": "counter",
                                            "samples": {"": 7.0}}
    assert parsed["viem_monitor_traffic_edge_bytes"]["samples"]["count"] \
        == 7.0
    snap = p.snapshot()
    snap["run.count"] = 99
    assert p.snapshot()["run.count"] == 1            # a deep copy
    p.reset()
    r.reset()
    assert p.snapshot() == r.snapshot()
    assert p.to_prometheus() == r.to_prometheus()
    with pytest.raises(TypeError):
        p.gauge("run.count")
    assert to.MetricsRegistry().to_prometheus() == \
        ro.MetricsRegistry().to_prometheus() == ""


# --------------------------------------------------------------- exporters
def _spans():
    tel = to.EngineTelemetry(
        passes=3, sweeps=2, exchanges=np.array([4, 2, 0]),
        tabu_masked=np.array([0, 1, 0]), aspirations=np.array([0, 0, 1]),
        match_rounds=np.array([2, 1, 1]), downhill_escapes=1,
        objective_trace=np.array([90.0, 80.0, 75.5]))
    return [to.Span("plan.execute", t0=10.0, dur=0.5, tid=11, attrs={
                "n": np.int64(64), "j": np.float32(1.5)}),
            to.Span("plan.refine", t0=10.1, dur=0.3, tid=11, depth=1,
                    attrs={"telemetry": tel, "pairs": np.arange(600),
                           "syncs": {"reads": 3}, "obj": object()}),
            to.Span("monitor.tick", cat="monitor", t0=11.0, dur=0.2, tid=22,
                    attrs={"levels": (1, 2), "none": None})]


def test_chrome_trace_and_jsonl_equal_reference(tmp_path):
    spans = _spans()
    port = to.chrome_trace_events(spans, pid=3)
    ref = ro.chrome_trace_events(spans, pid=3)
    # the "obj" attribute is a repr with an address that is the same
    # object on both sides
    assert port == ref
    names = [e["name"] for e in port["traceEvents"]]
    assert names.count("engine/objective") == 3
    assert names.count("engine/exchanges") == 3
    assert port["traceEvents"][0]["ph"] == "M"
    assert to.write_chrome_trace(spans, tmp_path / "p.json") == \
        ro.write_chrome_trace(spans, tmp_path / "r.json")
    assert (tmp_path / "p.json").read_text() == \
        (tmp_path / "r.json").read_text()
    assert to.write_jsonl(spans, tmp_path / "p.jsonl") == \
        ro.write_jsonl(spans, tmp_path / "r.jsonl") == 3
    assert (tmp_path / "p.jsonl").read_text() == \
        (tmp_path / "r.jsonl").read_text()
    assert to.span_breakdown(spans + spans[:1]) == \
        ro.span_breakdown(spans + spans[:1])
    assert to.chrome_trace_events([]) == ro.chrome_trace_events([])


# ---------------------------------------------------------- fault signals
def _straggler_stream(ft):
    got = []
    sm = ft.StragglerMonitor(n_hosts=4, threshold=1.5, patience=2,
                             evict_after=4, max_missed=3,
                             on_action=lambda a, h: got.append((a.value, h)))
    rng = np.random.default_rng(9)
    returns = []
    for step in range(14):
        times = {h: float(rng.uniform(0.9, 1.1)) for h in range(4)}
        if 3 <= step < 11:
            times[1] = 2.5
        if step >= 8:
            times[3] = 2.0
        a, hosts = sm.record_step(times)
        returns.append((a.value, hosts))
    for _ in range(3):
        returns.append((sm.heartbeat_missed(2).value, [2]))
    queued = [(a.value, h) for a, h in sm.drain_actions()]
    return returns, got, queued, sm.drain_actions()


def test_straggler_monitor_action_stream_equals_reference():
    port = _straggler_stream(tft)
    assert port == _straggler_stream(rft)
    returns, got, queued, empty = port
    assert {"rebalance", "evict_restart"} <= {a for a, _ in got}
    assert queued == got and empty == []
    assert [a.value for a in tft.Action] == [a.value for a in rft.Action]


def test_restart_policy_and_run_with_restarts_equal_reference():
    def drive(ft):
        policy = ft.RestartPolicy(max_restarts=4, backoff_s=2.0,
                                  backoff_mult=3.0, max_backoff_s=20.0)
        delays = [policy.next_delay() for _ in range(6)]
        slept, calls = [], []

        def train(state):
            calls.append(state)
            if len(calls) < 3:
                raise RuntimeError("lost a host")
            return ("done", state)

        out = ft.run_with_restarts(train, lambda: len(calls),
                                   ft.RestartPolicy(backoff_s=1.0),
                                   sleep=slept.append)

        def always(state):
            raise RuntimeError("down")
        with pytest.raises(RuntimeError):
            ft.run_with_restarts(always, lambda: 0,
                                 ft.RestartPolicy(max_restarts=2),
                                 sleep=slept.append)
        stats = ft.HostStats()
        for dt in (3.0, 1.0, 2.0):
            stats.push(dt)
        return delays, out, calls, slept, stats.median
    assert drive(tft) == drive(rft)


# ------------------------------------------------------------ fleet_monitor
def test_fleet_monitor_equals_reference():
    from repro.launch.mesh import fleet_monitor as ref_fleet
    from repro_torch.launch.mesh import fleet_monitor as port_fleet
    text = FIXTURE.read_text()
    ref_mon, ref_order = ref_fleet(
        text, 8, machine_model=rt.make_topology("torus", dims=[4, 2]))
    port_mon, port_order = port_fleet(
        text, 8, machine_model=tt.make_topology("torus", dims=[4, 2]),
        device="cpu")
    np.testing.assert_array_equal(port_order, ref_order)
    assert sorted(port_order) == list(range(8))
    assert port_mon.plan.device.type == "cpu"
    rows = []
    for mon, conv in ((ref_mon, lambda x: x), (port_mon, _port_graph)):
        u, v, w = ref_mon.baseline.edge_list()
        base = rc.from_edges(8, u, v, w)
        live = conv(_scaled(base, [0, 1, 2, 3], 16.0))
        out = []
        for _ in range(4):
            mon.observe_graph(live)
            out.append(_row(mon.tick()))
        rows.append((out, mon.incumbent.copy(), mon.ticks))
    assert rows[1][0] == rows[0][0]
    np.testing.assert_array_equal(rows[1][1], rows[0][1])
    assert rows[1][2] == rows[0][2] == 4


def test_viem_device_order_and_fleet_model_equal_reference():
    from repro.launch.mesh import fleet_model as ref_model
    from repro.launch.mesh import viem_device_order as ref_order
    from repro_torch.launch.mesh import fleet_model as port_model
    from repro_torch.launch.mesh import viem_device_order as port_order
    text = FIXTURE.read_text()
    for machine in ("torus", "tree"):
        a, b = ref_model(machine, pods=2), port_model(machine, pods=2)
        assert a.n_pe == b.n_pe
        np.testing.assert_array_equal(b.distance_matrix(),
                                      a.distance_matrix())
    ref, _ = ref_order(text, 8, machine_model=rt.make_topology(
        "torus", dims=[2, 4]))
    port, res = port_order(text, 8, machine_model=tt.make_topology(
        "torus", dims=[2, 4]), device="cpu")
    np.testing.assert_array_equal(port, ref)
    with pytest.raises(ValueError, match="fleet has"):
        port_order(text, 16, machine_model=tt.make_topology(
            "torus", dims=[2, 4]), device="cpu")


def test_fleet_monitor_defaults_to_cuda():
    from repro_torch.launch.mesh import fleet_monitor
    machine = tt.make_topology("torus", dims=[4, 2])
    if torch.cuda.is_available():
        mon, _ = fleet_monitor(FIXTURE.read_text(), 8, machine_model=machine)
        assert mon.plan.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fleet_monitor(FIXTURE.read_text(), 8, machine_model=machine)


# --------------------------------------------------------------------- CLIs
def _cli(pkg, args, cwd):
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-m", f"{pkg}.cli.viem", *args],
                         cwd=cwd, env=env, capture_output=True, text=True,
                         timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    return run.stdout


_NUM = re.compile(r"[-+]?\d+(?:\.\d+)?(?:e[-+]?\d+)?%?")


def _close_lines(port: str, ref: str, rel: float) -> None:
    """Equal line for line: the text between numbers exactly, each number
    within ``rel`` relative."""
    pl, rl = port.splitlines(), ref.splitlines()
    assert len(pl) == len(rl)
    for a, b in zip(pl, rl):
        assert _NUM.sub("#", a) == _NUM.sub("#", b), (a, b)
        for x, y in zip(_NUM.findall(a), _NUM.findall(b)):
            fx, fy = float(x.rstrip("%")), float(y.rstrip("%"))
            assert abs(fx - fy) <= rel * max(abs(fx), abs(fy)), (a, b)


def _prometheus_equal(port: str, ref: str) -> None:
    """Byte for byte, but for the samples of time-valued summaries
    (wall times), whose ``_count`` is held."""
    pl, rl = port.splitlines(), ref.splitlines()
    assert len(pl) == len(rl)
    for a, b in zip(pl, rl):
        name = a.split("{")[0].split(" ")[0]
        timed = "_seconds" in name and not a.startswith("#") \
            and not name.endswith("_count")
        if timed:
            assert a.split(" ")[0] == b.split(" ")[0]
        else:
            assert a == b


@pytest.fixture(scope="module")
def watch_graph(tmp_path_factory):
    path = tmp_path_factory.mktemp("watch") / "g.metis"
    rc.write_metis(rc.grid3d(4, 4, 4), path)
    return path


_WATCH = ["--topology=torus", '--topology_params={"dims": [8, 8]}',
          "--windows=8", "--inject-shift=3", "--evict-host=1"]


@pytest.mark.parametrize("jitter", ["0", "0.01"])
def test_remap_watch_cli_equals_reference(tmp_path, watch_graph, jitter):
    args = ["remap-watch", str(watch_graph), *_WATCH, f"--jitter={jitter}"]
    ref = _cli("repro", args, tmp_path)
    port = _cli("repro_torch", args + ["--device", "cpu"], tmp_path)
    if jitter == "0":
        assert port == ref
    else:
        _close_lines(port, ref, 1e-6)
    assert "remapped" in port and "forced=rebalance" in port


def test_remap_watch_profile_and_metrics_out_equal_reference(tmp_path,
                                                             watch_graph):
    out = {}
    for pkg, extra in (("repro", []), ("repro_torch", ["--device=cpu"])):
        stdout = _cli(pkg, ["remap-watch", str(watch_graph), *_WATCH,
                            f"--profile={pkg}.json",
                            f"--metrics-out={pkg}.prom", *extra], tmp_path)
        trace = json.loads((tmp_path / f"{pkg}.json").read_text())
        out[pkg] = (stdout, trace,
                    (tmp_path / f"{pkg}.prom").read_text())
    (p_out, p_trace, p_prom), (r_out, r_trace, r_prom) = \
        out["repro_torch"], out["repro"]
    assert p_out.replace("repro_torch", "repro") == r_out
    names = {e["name"] for e in p_trace["traceEvents"] if e["ph"] == "X"}
    assert names == {e["name"] for e in r_trace["traceEvents"]
                     if e["ph"] == "X"}
    assert {"monitor.tick", "monitor.window", "monitor.drift",
            "monitor.remap", "monitor.replay"} <= names
    ticks = [e for e in p_trace["traceEvents"] if e["name"] == "monitor.tick"]
    assert len(ticks) == 8
    _prometheus_equal(p_prom, r_prom)
    assert to.parse_prometheus(p_prom)["viem_monitor_windows"][
        "samples"][""] == 8.0


def test_viem_profile_and_metrics_out_equal_reference(tmp_path,
                                                      watch_graph):
    out = {}
    for pkg, extra in (("repro", []), ("repro_torch", ["--device=cpu"])):
        _cli(pkg, [str(watch_graph), "--hierarchy_parameter_string=4:4:4",
                   "--distance_parameter_string=1:10:100", "--engine=device",
                   f"--profile={pkg}.json", f"--metrics-out={pkg}.prom",
                   f"--output_filename={pkg}.perm", *extra], tmp_path)
        out[pkg] = [(tmp_path / f"{pkg}.{ext}").read_text()
                    for ext in ("json", "prom", "perm")]
    (p_json, p_prom, p_perm), (r_json, r_prom, r_perm) = \
        out["repro_torch"], out["repro"]
    assert p_perm == r_perm
    _prometheus_equal(p_prom, r_prom)
    p_ev, r_ev = (json.loads(t)["traceEvents"] for t in (p_json, r_json))
    assert [(e["name"], e["ph"]) for e in p_ev] == \
        [(e["name"], e["ph"]) for e in r_ev]
    # the engine's counter tracks carry the same per-sweep values
    assert [e["args"] for e in p_ev if e["ph"] == "C"] == \
        [e["args"] for e in r_ev if e["ph"] == "C"]
