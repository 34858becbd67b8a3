"""The port's batches and warm starts against the JAX package, on the CPU.

K1's and K2's plain versions with a lane axis equal the single call on
each lane; ``RefinementEngine.refine_batch`` equals a single ``refine``
on each lane and the JAX package's ``refine_batch`` (tabu and don't-look
bits on and off, lanes of different K, E and P); ``Mapper.map_many`` —
flat and multilevel — equals its single maps and ``repro``'s
``map_many`` on all five topologies, structurally different graphs
included; ``MappingPlan.execute_warm`` reproduces the JAX package's
warm-start cases (``tests/test_monitor.py``) and results; and
``repro.monitor.RemapMonitor``, imported here and never by the port,
drives a port plan unchanged.  Integer weights and distances: every
float32 sum is exact, so all of it must agree exactly.
"""

import functools

import numpy as np
import pytest
import torch

import repro.core as rc
import repro.topology as rt
import repro_torch.core as tc
import repro_torch.topology as tt
from repro.engine import RefinementEngine as RefEngine
from repro.monitor import (MonitorConfig, RemapMonitor, dirty_pair_mask,
                           dirty_vertices, expand_dirty)
from repro_torch import convert
from repro_torch.core.local_search import communication_pairs
from repro_torch.engine import RefinementEngine
from repro_torch.kernels import (edge_objective, pair_gains,
                                 pair_gains_plain, qap_objective_edges,
                                 qap_objective_plain)
from repro_torch.kernels.config import KernelConfig

N = 64
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
        return mod.TorusTopology((4, 4, 4), (1.0, 2.0, 1.0))
    if name == "fattree":
        return mod.FatTreeTopology((4, 4, 4), (1.0, 2.0, 5.0))
    if name == "dragonfly":
        return mod.DragonflyTopology(4, 4, 4)
    torus = mod.TorusTopology((4, 4, 4))
    return mod.MatrixTopology(matrix=torus.distance_matrix() * 3.0)


def _port_graph(g):
    return convert.graph(g.xadj, g.adjncy, g.adjwgt, g.vwgt)


def _reweighted(g, seed):
    u, v, _ = g.edge_list()
    w = np.random.default_rng(seed).integers(1, 10, len(u)) * 1.0
    return rc.from_edges(g.n, u, v, w)


def _batch():
    """Structurally different same-n graphs: two stencils with their own
    integer weights, two random geometric graphs (different K, E and
    candidate-pair counts)."""
    return [_reweighted(rc.grid3d(4, 4, 4), 1), _reweighted(
        rc.grid3d(4, 4, 4), 2), rc.random_geometric(N, 0.25, seed=3),
        rc.random_geometric(N, 0.18, seed=8)]


# ------------------------------------------------- lane-axis plain versions
def _lanes(seed=0, b=3, n=40, k=6, p=50, e=70):
    rng = np.random.default_rng(seed)
    t = torch.from_numpy
    nbr = t(rng.integers(0, n, (b, n, k)).astype(np.int32))
    wgt = t(rng.integers(0, 5, (b, n, k)).astype(np.float32))
    perm = t(np.stack([rng.permutation(n) for _ in range(b)])
             .astype(np.int32))
    us = t(rng.integers(0, n, (b, p)).astype(np.int32))
    vs = t(rng.integers(0, n, (b, p)).astype(np.int32))
    eu = t(rng.integers(0, n, (b, e)).astype(np.int32))
    ev = t(rng.integers(0, n, (b, e)).astype(np.int32))
    ew = t(rng.integers(0, 9, (b, e)).astype(np.float32))
    return nbr, wgt, perm, us, vs, eu, ev, ew


def _forms(n):
    d = np.abs(np.subtract.outer(np.arange(n), np.arange(n))) % 7 * 1.0
    return [("tree", ((1, 4, 20, 40), (1.0, 10.0, 100.0)),
             torch.zeros((1, 1))),
            ("torus", ((5, 8), (1.0, 2.0)), torch.zeros((1, 1))),
            ("matrix", (), torch.from_numpy(d.astype(np.float32))),
            ("matrix", (), torch.from_numpy(d.astype(np.int8)))]


@pytest.mark.parametrize("form", range(4))
def test_lane_axis_plain_versions_equal_single_calls(form):
    nbr, wgt, perm, us, vs, eu, ev, ew = _lanes(form)
    kind, params, D = _forms(perm.shape[1])[form]
    cfg = KernelConfig(block_rows=8, lanes=128)
    g = pair_gains_plain(kind, params, nbr, wgt, perm, us, vs, D)
    assert g.shape == us.shape
    assert torch.equal(g, pair_gains(kind, params, nbr, wgt, perm, us, vs,
                                     D))
    j = qap_objective_plain(kind, params, eu, ev, ew, perm, D)
    assert j.shape == (3,)
    assert torch.equal(j, qap_objective_edges(kind, params, eu, ev, ew,
                                              perm, D))
    jc = edge_objective(kind, params, eu, ev, ew, perm, D, config=cfg)
    for b in range(3):
        single = (kind, params, nbr[b], wgt[b], perm[b], us[b], vs[b], D)
        assert torch.equal(g[b], pair_gains_plain(*single))
        assert torch.equal(g[b], pair_gains_plain(*single, config=cfg))
        assert torch.equal(j[b], qap_objective_plain(
            kind, params, eu[b], ev[b], ew[b], perm[b], D))
        assert torch.equal(jc[b], edge_objective(
            kind, params, eu[b], ev[b], ew[b], perm[b], D, config=cfg))


# ------------------------------------------------------------ refine_batch
@functools.lru_cache(maxsize=None)
def _engines(name, max_sweeps=12):
    return (RefEngine(_machine(rt, rc, name), max_sweeps=max_sweeps),
            RefinementEngine(_machine(tt, tc, name), max_sweeps=max_sweeps,
                             device="cpu"))


def _refine_inputs(graphs, dist=3):
    rng = np.random.default_rng(11)
    perms = [rng.permutation(N) for _ in graphs]
    pairs = [communication_pairs(_port_graph(g), dist) for g in graphs]
    return perms, pairs


@pytest.mark.parametrize("knobs", [{}, {"tabu_tenure": 3},
                                   {"tabu_tenure": 2, "dlb": True},
                                   {"dlb": True}])
@pytest.mark.parametrize("name", ["tree", "matrix"])
def test_refine_batch_equals_singles_and_reference(name, knobs):
    ref, eng = _engines(name)
    graphs = _batch()
    gps = [_port_graph(g) for g in graphs]
    perms, pairs = _refine_inputs(graphs)
    batch = [p.copy() for p in perms]
    stats = eng.refine_batch(gps, batch, pairs, telemetry=True, **knobs)
    syncs = dict(eng.last_syncs)
    ref_perms = [p.copy() for p in perms]
    ref_stats = ref.refine_batch(graphs, ref_perms, pairs, telemetry=True,
                                 **knobs)
    rounds = []
    for i, g in enumerate(gps):
        single = perms[i].copy()
        s1 = eng.refine(g, single, pairs[i], telemetry=True, **knobs)
        for other, so in ((single, s1), (ref_perms[i], ref_stats[i])):
            assert np.array_equal(batch[i], other)
            assert stats[i].objective_trace == so.objective_trace
            assert stats[i].swaps == so.swaps
            assert stats[i].evaluated == so.evaluated
            assert stats[i].final_objective == so.final_objective
            for key in ("exchanges", "tabu_masked", "aspirations",
                        "match_rounds"):
                assert np.array_equal(getattr(stats[i].telemetry, key),
                                      getattr(so.telemetry, key)), key
            assert stats[i].telemetry.downhill_escapes == \
                so.telemetry.downhill_escapes
        rounds.append(stats[i].telemetry.match_rounds)
    # one counted read a pass for the whole batch, plus one a matching
    # round, the batch's rounds being its slowest lane's
    passes = max(s.telemetry.passes for s in stats)
    per_pass = np.zeros(passes, np.int64)
    for r in rounds:
        per_pass[:len(r)] = np.maximum(per_pass[:len(r)], r)
    assert syncs["passes"] == passes
    assert syncs["reads"] == passes + int(per_pass.sum())
    assert syncs["lane_sweeps"] == [s.telemetry.sweeps for s in stats]


def test_refine_batch_of_duplicates_and_bucket_is_inert():
    _, eng = _engines("torus")
    g = _port_graph(_batch()[2])
    perms, pairs = _refine_inputs([g, g])
    bucket = tc.ShapeBucket.of(g, schedule="pow2")
    single = perms[0].copy()
    s1 = eng.refine(g, single, pairs[0])
    batch = [perms[0].copy(), perms[0].copy()]
    out = eng.refine_batch([g, g], batch, [pairs[0], pairs[0]],
                           bucket=bucket)
    for p, s in zip(batch, out):
        assert np.array_equal(p, single)
        assert s.objective_trace == s1.objective_trace


# ---------------------------------------------------------------- map_many
def _spec(**kw):
    kw = dict(dict(engine="device", backend="pallas", max_sweeps=8,
                   neighborhood_dist=3), **kw)
    return rc.MappingSpec(**kw)


@pytest.mark.parametrize("multilevel", [False, True])
@pytest.mark.parametrize("name", TOPOLOGIES)
def test_map_many_equals_singles_and_reference(name, multilevel):
    spec = _spec(multilevel=rc.MultilevelSpec(levels=3, coarsen_min=8)
                 if multilevel else None)
    graphs = _batch()
    ref = rc.Mapper(_machine(rt, rc, name), spec)
    port = tc.Mapper(_machine(tt, tc, name), convert.spec(spec.to_dict()),
                     device="cpu")
    gps = [_port_graph(g) for g in graphs]
    want = ref.map_many(graphs)
    got = port.map_many(gps)
    assert port.cache_info()["requests"] == len(graphs)
    for g, a, b in zip(gps, want, got):
        single = port.map(g)
        for other in (a, single):
            assert np.array_equal(b.perm, other.perm)
            assert b.initial_objective == other.initial_objective
            assert b.final_objective == other.final_objective
            assert b.search_stats.swaps == other.search_stats.swaps
            assert (b.search_stats.objective_trace
                    == other.search_stats.objective_trace)


def test_map_many_rejects_mixed_sizes_and_passes_empty():
    port = tc.Mapper(_machine(tt, tc, "tree"),
                     convert.spec(_spec().to_dict()), device="cpu")
    assert port.map_many([]) == []
    with pytest.raises(ValueError, match="same-shape"):
        port.map_many([_port_graph(rc.grid3d(4, 4, 4)),
                       _port_graph(rc.grid3d(4, 4, 2))])


def test_execute_batch_shares_duplicate_constructions():
    port = tc.Mapper(_machine(tt, tc, "torus"),
                     convert.spec(_spec().to_dict()), device="cpu")
    g = _port_graph(_batch()[0])
    plan = port.lower_for(g)
    res = plan.execute_batch([g, g, g])
    assert plan.cache_info()["executes"] == 3
    assert all(np.array_equal(r.perm, res[0].perm) for r in res)
    assert res[0].perm is not res[1].perm
    assert np.array_equal(res[0].perm, plan.execute(g).perm)
    # the host engine maps a batch one graph at a time
    host = tc.Mapper(_machine(tt, tc, "torus"), convert.spec(
        _spec(engine="host", parallel_sweeps=True).to_dict()), device="cpu")
    hres = host.map_many([g, g])
    assert np.array_equal(hres[0].perm, host.map(g).perm)


# ------------------------------------------------------------- warm start
def _plans(engine="device"):
    spec = rc.MappingSpec(construction="hierarchytopdown",
                          neighborhood="communication", neighborhood_dist=10,
                          engine=engine, parallel_sweeps=engine == "host",
                          seed=0)
    g = rc.grid3d(4, 4, 4)
    ref = rc.Mapper(rt.make_topology("torus", dims=[8, 8]),
                    spec).lower_for(g, schedule="pow2")
    port = tc.Mapper(tt.make_topology("torus", dims=[8, 8]),
                     convert.spec(spec.to_dict()),
                     device="cpu").lower_for(_port_graph(g), schedule="pow2")
    return ref, port, g


def _scaled(g, vertices, factor):
    u, v, w = g.edge_list()
    m = np.zeros(g.n, bool)
    m[list(vertices)] = True
    return rc.from_edges(g.n, u, v, np.where(m[u] | m[v], w * factor, w))


def _warm_pair(ref, port, live, perm, **kw):
    a = ref.execute_warm(live, perm, **kw)
    b = port.execute_warm(_port_graph(live), perm, **kw)
    assert np.array_equal(a.perm, b.perm)
    assert a.initial_objective == b.initial_objective
    assert a.final_objective == b.final_objective
    return b


def test_execute_warm_full_mask_matches_unmasked():
    ref, plan, g = _plans()
    res0 = plan.execute(_port_graph(g))
    live = _scaled(g, range(16), 8.0)
    pairs = plan.candidate_pairs(_port_graph(g))
    assert np.array_equal(pairs, ref.candidate_pairs(g))
    r_none = _warm_pair(ref, plan, live, res0.perm, pairs=pairs)
    r_all = _warm_pair(ref, plan, live, res0.perm, pairs=pairs,
                       active=np.ones(len(pairs), bool))
    assert np.array_equal(r_none.perm, r_all.perm)
    assert r_none.final_objective == r_all.final_objective
    assert r_none.final_objective <= r_none.initial_objective
    assert r_none.construction_seconds == 0.0


def test_execute_warm_does_not_mutate_incumbent():
    _, plan, g = _plans()
    res0 = plan.execute(_port_graph(g))
    incumbent = res0.perm.copy()
    plan.execute_warm(_port_graph(_scaled(g, range(16), 8.0)), res0.perm)
    assert np.array_equal(res0.perm, incumbent)


def test_execute_warm_mask_freezes_untouched_vertices():
    ref, plan, g = _plans()
    res0 = plan.execute(_port_graph(g))
    live = _scaled(g, range(8), 8.0)
    pairs = plan.candidate_pairs(_port_graph(g))
    dirty = expand_dirty(live, dirty_vertices(g, live), hops=1)
    mask = dirty_pair_mask(pairs, dirty)
    eng = plan.engines[0]
    res = _warm_pair(ref, plan, live, res0.perm, pairs=pairs, active=mask)
    # P is unchanged: the inactive pairs became inert (u, u) pairs
    assert eng.cache_info()["pair_entries"] >= 1
    movable = np.zeros(g.n, bool)
    movable[pairs[mask].ravel()] = True
    frozen = ~movable
    assert np.array_equal(res.perm[frozen], res0.perm[frozen])


def test_execute_warm_rejects_bad_mask_shape():
    _, plan, g = _plans()
    res0 = plan.execute(_port_graph(g))
    with pytest.raises(ValueError, match="active mask"):
        plan.execute_warm(_port_graph(g), res0.perm,
                          active=np.ones(3, bool))


def test_execute_warm_host_engine_parity():
    ref, plan, g = _plans(engine="host")
    res0 = plan.execute(_port_graph(g))
    live = _scaled(g, range(16), 8.0)
    res = _warm_pair(ref, plan, live, res0.perm)
    assert res.final_objective <= res.initial_objective


# ----------------------------------------------------------------- monitor
def test_remap_monitor_drives_a_port_plan_unchanged():
    """ROADMAP item 1's gate: the JAX package's closed-loop monitor (no
    jax inside it) over a port plan commits what it commits over the
    reference plan, tick for tick."""
    ref, port, g = _plans()
    runs = []
    for plan in (ref, port):
        mon = RemapMonitor(plan, g, config=MonitorConfig(
            drift_patience=2, min_weight=0.01), seed=0)
        reports = []
        for factor in (8.0, 8.0, 8.0, 0.5):
            mon.observe_graph(_scaled(g, range(16), factor))
            r = mon.tick()
            reports.append((r.triggered, r.remapped, r.dirty,
                            r.active_pairs, r.drift.score, r.retraces))
        runs.append((reports, mon.incumbent.copy(), mon.remaps))
    (rep_a, inc_a, n_a), (rep_b, inc_b, n_b) = runs
    assert rep_a == rep_b
    assert np.array_equal(inc_a, inc_b)
    assert n_a == n_b >= 1
