"""The port's portfolio search against the JAX package, on the CPU.

K1's and K2's plain versions over one graph shared by B lanes equal the
stacked-lane calls and the single calls (real weights too); the port's
kick, fed the reference's own threefry draws, equals
``repro.portfolio.make_kick`` bit for bit; ``refine_lanes`` equals each
lane's single ``refine`` and ``repro``'s ``refine_lanes``;
``PortfolioSpec(lanes=1, rounds=1, tabu_tenure=0)`` is the flat and the
multilevel pipeline; and with :func:`repro_torch.portfolio.kick_draws`
replaced (here only) by the draws the reference's round loop takes from
its key, ``Mapper.map`` with a portfolio spec equals ``repro``'s —
permutation, objectives, objective trace, rounds, sweeps and swaps — on
all five topologies, flat and multilevel, as do ``viem --portfolio`` and
``evaluator --compare_spec``.  Integer weights and distances: every
float32 sum is exact, so all of it must agree exactly.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as rc
import repro.topology as rt
import repro_torch.core as tc
import repro_torch.topology as tt
from repro.core.spec import PortfolioSpec
from repro.engine import RefinementEngine as RefEngine
from repro.portfolio import make_kick as ref_make_kick
from repro_torch import convert
from repro_torch.core.local_search import communication_pairs
from repro_torch.core.spec import PortfolioSpec as PortSpec
from repro_torch.engine import RefinementEngine
from repro_torch.kernels import (edge_objective, pair_gains,
                                 pair_gains_plain, qap_objective_edges,
                                 qap_objective_plain)
from repro_torch.kernels.config import KernelConfig
from repro_torch.portfolio import kick_draws, kick_length, make_kick
from repro_torch.portfolio import search as port_search

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


def _graph():
    """A random geometric graph with seeded integer weights in [1, 9]."""
    g = rc.random_geometric(N, 0.25, seed=3)
    u, v, _ = g.edge_list()
    w = np.random.default_rng(4).integers(1, 10, len(u)) * 1.0
    return rc.from_edges(N, u, v, w)


# ------------------------------------------------- the reference's draws
def _ref_lane_draws(key, n, klen):
    """One lane's kick draws from its key, as ``repro.portfolio.kicks``
    takes them."""
    kc, ks, kw = jax.random.split(key, 3)
    return (jax.random.randint(ks, (), 0, n, dtype=jnp.int32),
            jax.random.randint(kw, (klen, 2), 0, n, dtype=jnp.int32),
            jax.random.bernoulli(kc))


def jax_kick_draws(seed, rounds, lanes, n, klen):
    """What ``repro.portfolio.search._make_rounds`` draws from
    ``PRNGKey(seed)``: each round ``key, kk = split(key)``, the lanes'
    keys ``split(kk, lanes)``, and each lane's kick draws from its key —
    in :func:`repro_torch.portfolio.kick_draws`' layout."""
    key = jax.random.PRNGKey(seed)
    r = max(rounds - 1, 0)
    s = np.zeros((r, lanes), np.int32)
    uv = np.zeros((r, lanes, klen, 2), np.int32)
    coin = np.zeros((r, lanes), bool)
    draw = jax.vmap(lambda k: _ref_lane_draws(k, n, klen))
    for i in range(r):
        key, kk = jax.random.split(key)
        a, b, c = draw(jax.random.split(kk, lanes))
        s[i], uv[i], coin[i] = np.asarray(a), np.asarray(b), np.asarray(c)
    return s, uv, coin


@pytest.fixture
def reference_draws(monkeypatch):
    monkeypatch.setattr(port_search, "kick_draws", jax_kick_draws)


# ------------------------------------------ shared-graph plain versions
def _forms(n):
    d = np.abs(np.subtract.outer(np.arange(n), np.arange(n))) % 7 * 1.0
    return [("tree", ((1, 4, 20, 40), (1.0, 10.0, 100.0)),
             torch.zeros((1, 1))),
            ("torus", ((5, 8), (1.0, 2.0)), torch.zeros((1, 1))),
            ("matrix", (), torch.from_numpy(d.astype(np.float32))),
            ("matrix", (), torch.from_numpy(d.astype(np.int8)))]


@pytest.mark.parametrize("real", [False, True], ids=["integer", "real"])
@pytest.mark.parametrize("form", range(4))
def test_shared_graph_plain_versions_equal_stacked_and_singles(form, real):
    """One graph (n, K) / (E,) and one pair list (P,) shared by B = 3
    permutations: K2's and K1's plain versions (and ``edge_objective``,
    flat and chunked) equal the same graph stacked once a lane and the
    single call on each lane, bit for bit, on real weights too."""
    rng = np.random.default_rng(form)
    n, k, p, e, b = 40, 6, 50, 70, 3
    t = torch.from_numpy
    nbr = t(rng.integers(0, n, (n, k)).astype(np.int32))
    wgt = t((rng.random((n, k)) * 5.0 if real
             else rng.integers(0, 5, (n, k))).astype(np.float32))
    perm = t(np.stack([rng.permutation(n) for _ in range(b)])
             .astype(np.int32))
    us = t(rng.integers(0, n, p).astype(np.int32))
    vs = t(rng.integers(0, n, p).astype(np.int32))
    eu = t(rng.integers(0, n, e).astype(np.int32))
    ev = t(rng.integers(0, n, e).astype(np.int32))
    ew = t((rng.random(e) * 9.0 if real
            else rng.integers(0, 9, e)).astype(np.float32))
    kind, params, D = _forms(n)[form]
    cfg = KernelConfig(block_rows=8, lanes=4)

    def lanes(x):
        return x[None].expand(b, *x.shape).contiguous()

    g = pair_gains(kind, params, nbr, wgt, perm, us, vs, D)
    assert g.shape == (b, p)
    assert torch.equal(g, pair_gains_plain(kind, params, lanes(nbr),
                                           lanes(wgt), perm, lanes(us),
                                           lanes(vs), D))
    j = qap_objective_edges(kind, params, eu, ev, ew, perm, D)
    assert j.shape == (b,)
    assert torch.equal(j, qap_objective_plain(kind, params, lanes(eu),
                                              lanes(ev), lanes(ew), perm,
                                              D))
    jc = edge_objective(kind, params, eu, ev, ew, perm, D, config=cfg)
    assert torch.equal(jc, edge_objective(kind, params, lanes(eu),
                                          lanes(ev), lanes(ew), perm, D,
                                          config=cfg))
    for i in range(b):
        assert torch.equal(g[i], pair_gains_plain(kind, params, nbr, wgt,
                                                  perm[i], us, vs, D))
        assert torch.equal(g[i], pair_gains_plain(kind, params, nbr, wgt,
                                                  perm[i], us, vs, D,
                                                  config=cfg))
        assert torch.equal(j[i], qap_objective_plain(kind, params, eu, ev,
                                                     ew, perm[i], D))
        assert torch.equal(jc[i], edge_objective(kind, params, eu, ev, ew,
                                                 perm[i], D, config=cfg))


# ---------------------------------------------------------------- kicks
@pytest.mark.parametrize("frac", [0.0, 0.2, 1.0])
@pytest.mark.parametrize("n", [2, 37, 64])
def test_kick_equals_reference_on_its_draws(n, frac):
    """Fed the draws the reference's kick takes from its key, the port's
    kick equals ``repro.portfolio.make_kick``'s output bit for bit, for
    every lane at once; klen 2 (n = 2, or frac 0) and klen n included,
    both coin sides taken; every output is a bijection."""
    ref = ref_make_kick(n, frac)
    kick = make_kick(n, frac)
    assert kick.klen == ref.klen == kick_length(n, frac)
    keys = [jax.random.PRNGKey(s) for s in range(12)]
    rng = np.random.default_rng(n)
    perms = np.stack([rng.permutation(n) for _ in keys]).astype(np.int32)
    draws = [_ref_lane_draws(k, n, kick.klen) for k in keys]
    s = torch.tensor([int(d[0]) for d in draws], dtype=torch.int32)
    uv = torch.from_numpy(np.stack([np.asarray(d[1]) for d in draws]))
    coin = torch.tensor([bool(d[2]) for d in draws])
    assert 0 < int(coin.sum()) < len(keys)          # both kinds of kick
    got = kick(torch.from_numpy(perms), s, uv, coin).numpy()
    for i, key in enumerate(keys):
        want = np.asarray(ref(jnp.asarray(perms[i]), key))
        assert np.array_equal(got[i], want)
        assert sorted(got[i].tolist()) == list(range(n))


def test_kick_draws_are_seeded_and_in_range():
    s, uv, coin = kick_draws(5, 4, 3, 37, 7)
    assert s.shape == (3, 3) and uv.shape == (3, 3, 7, 2)
    assert coin.shape == (3, 3) and coin.dtype == bool
    assert s.dtype == uv.dtype == np.int32
    assert 0 <= s.min() and s.max() < 37 and 0 <= uv.min() < uv.max() < 37
    again = kick_draws(5, 4, 3, 37, 7)
    other = kick_draws(6, 4, 3, 37, 7)
    assert all(np.array_equal(a, b) for a, b in zip((s, uv, coin), again))
    assert not np.array_equal(uv, other[1])
    assert [x.shape[0] for x in kick_draws(5, 1, 3, 37, 7)] == [0, 0, 0]


# --------------------------------------------------------- refine_lanes
@functools.lru_cache(maxsize=None)
def _engines(name, max_sweeps=16):
    return (RefEngine(_machine(rt, rc, name), max_sweeps=max_sweeps),
            RefinementEngine(_machine(tt, tc, name), max_sweeps=max_sweeps,
                             device="cpu"))


@pytest.mark.parametrize("name,knobs", [
    (name, knobs) for name in TOPOLOGIES
    for knobs in ({}, {"tabu_tenure": 6, "dlb": True})]
    + [("tree", {"tabu_tenure": 3}), ("tree", {"dlb": True})])
def test_refine_lanes_equals_singles_and_reference(name, knobs):
    """4 lanes of one graph in one sweep loop: each lane equals its
    single ``refine`` and ``repro``'s ``refine_lanes`` (permutation,
    trace, swaps, evaluated, telemetry), and the loop's counted reads
    equal those of the same lanes as a stacked batch."""
    ref, eng = _engines(name)
    g = _graph()
    gp = _port_graph(g)
    pairs = communication_pairs(gp, 2)
    rng = np.random.default_rng(1)
    perms0 = [rng.permutation(N) for _ in range(4)]
    lanes = [p.copy() for p in perms0]
    stats = eng.refine_lanes(gp, lanes, pairs, telemetry=True, **knobs)
    syncs = dict(eng.last_syncs)
    ref_lanes = [p.copy() for p in perms0]
    ref_stats = ref.refine_lanes(g, ref_lanes, pairs, telemetry=True,
                                 **knobs)
    batch = [p.copy() for p in perms0]
    eng.refine_batch([gp] * 4, batch, [pairs] * 4, telemetry=True, **knobs)
    assert eng.last_syncs == syncs
    for i, p0 in enumerate(perms0):
        single = p0.copy()
        s1 = eng.refine(gp, single, pairs, telemetry=True, **knobs)
        for other, so in ((single, s1), (ref_lanes[i], ref_stats[i])):
            assert np.array_equal(lanes[i], other)
            assert stats[i].objective_trace == so.objective_trace
            assert stats[i].swaps == so.swaps
            assert stats[i].evaluated == so.evaluated
            assert stats[i].final_objective == so.final_objective
            for key in ("exchanges", "tabu_masked", "aspirations",
                        "match_rounds"):
                assert np.array_equal(getattr(stats[i].telemetry, key),
                                      getattr(so.telemetry, key)), key
        assert np.array_equal(batch[i], lanes[i])
    assert sum(s.swaps for s in stats) > 0


def test_refine_lanes_without_pairs_moves_nothing():
    _, eng = _engines("torus")
    gp = _port_graph(_graph())
    perms = [np.random.default_rng(s).permutation(N) for s in range(3)]
    before = [p.copy() for p in perms]
    stats = eng.refine_lanes(gp, perms, np.zeros((0, 2), np.int64))
    assert eng.last_syncs["reads"] == 0
    for p, q, st in zip(perms, before, stats):
        assert np.array_equal(p, q)
        assert st.objective_trace == [st.initial_objective]
        assert st.telemetry is None
    assert eng.refine_lanes(gp, [], np.zeros((0, 2), np.int64)) == []


# ------------------------------------------------------------ portfolio
def _spec(**kw):
    base = dict(construction="random", neighborhood="communication",
                neighborhood_dist=2, preconfiguration="fast",
                engine="device", backend="pallas", seed=1)
    base.update(kw)
    return rc.MappingSpec(**base)


_ML = {"levels": 2, "coarsen_min": 8}
_PF = PortfolioSpec(lanes=4, rounds=4, tabu_tenure=4, kick_strength=0.2,
                    stagnation=2)


def _mappers(name, spec):
    return (rc.Mapper(_machine(rt, rc, name), spec),
            tc.Mapper(_machine(tt, tc, name), convert.spec(spec.to_dict()),
                      device="cpu"))


def _assert_same(a, b):
    assert np.array_equal(a.perm, b.perm)
    assert sorted(b.perm.tolist()) == list(range(len(b.perm)))
    assert b.initial_objective == a.initial_objective
    assert b.final_objective == a.final_objective
    sa, sb = a.search_stats, b.search_stats
    assert sb.objective_trace == sa.objective_trace
    assert sb.swaps == sa.swaps and sb.evaluated == sa.evaluated


@pytest.mark.parametrize("multilevel", [False, True])
def test_lanes1_tabu_off_reproduces_execute_bit_for_bit(multilevel):
    """``PortfolioSpec(1, 1, 0)`` is the escape hatch: the port's
    portfolio path gives the same permutation and objectives as its own
    flat / multilevel pipeline and as ``repro``'s (the reference's
    ``tests/test_portfolio.py`` case)."""
    flat = _spec(multilevel=_ML if multilevel else None)
    one = flat.replace(portfolio=PortfolioSpec(
        lanes=1, rounds=1, tabu_tenure=0, dont_look=False))
    g = rc.grid3d(4, 4, 4)
    gp = _port_graph(g)
    ref, port = _mappers("tree", one)
    want = port.map(gp, spec=convert.spec(flat.to_dict()))
    got = port.map(gp)
    assert np.array_equal(want.perm, got.perm)
    assert want.final_objective == got.final_objective
    assert want.initial_objective == got.initial_objective
    r = ref.map(g)
    assert np.array_equal(r.perm, got.perm)
    assert r.final_objective == got.final_objective
    assert r.initial_objective == got.initial_objective


@pytest.mark.parametrize("multilevel", [False, True])
@pytest.mark.parametrize("name", TOPOLOGIES)
def test_portfolio_map_equals_reference(name, multilevel, reference_draws):
    """On the reference's draws, ``Mapper.map`` with a portfolio spec
    equals ``repro``'s exactly: permutation, initial and final
    objective, objective trace (round 0 and every round's incumbent),
    rounds, sweeps (``evaluated``) and swaps."""
    spec = _spec(multilevel=_ML if multilevel else None, portfolio=_PF)
    ref, port = _mappers(name, spec)
    g = _graph()
    want, got = ref.map(g), port.map(_port_graph(g))
    _assert_same(want, got)
    assert len(got.search_stats.objective_trace) >= 3    # rounds ran


@pytest.mark.parametrize("multilevel", [False, True])
def test_portfolio_stops_on_stagnation_as_reference(multilevel,
                                                    reference_draws):
    """A spec whose incumbent stalls: the round loop stops before its
    budget at the same round as the reference's, with the same trace."""
    spec = _spec(multilevel=_ML if multilevel else None, max_sweeps=4,
                 portfolio=PortfolioSpec(lanes=3, rounds=12, tabu_tenure=0,
                                         dont_look=False, kick_strength=0.05,
                                         stagnation=1))
    ref, port = _mappers("torus", spec)
    g = _graph()
    want, got = ref.map(g), port.map(_port_graph(g))
    _assert_same(want, got)
    rounds = len(got.search_stats.objective_trace) - 1
    assert rounds < 12
    runner = port.lower_for(_port_graph(g)).portfolio
    assert len(runner.last_rounds) == rounds - 1


def test_portfolio_describe_equals_reference():
    spec = _spec(portfolio=PortfolioSpec(
        lanes=3, rounds=2, constructions=("random", "growing")))
    ref, port = _mappers("tree", spec)
    g = rc.grid3d(4, 4, 4)
    want = ref.lower_for(g).describe()["portfolio"]
    got = port.lower_for(_port_graph(g)).describe()
    assert got["portfolio"] == want
    assert want["lane_constructions"] == ["random", "growing", "random"]
    json.dumps(got)


def test_portfolio_map_many_runs_each_graphs_own(reference_draws):
    spec = _spec(portfolio=PortfolioSpec(lanes=2, rounds=3, stagnation=2))
    ref, port = _mappers("dragonfly", spec)
    graphs = [_graph(), rc.random_geometric(N, 0.2, seed=8)]
    gps = [_port_graph(g) for g in graphs]
    many = port.map_many(gps)
    for g, gp, b in zip(graphs, gps, many):
        _assert_same(port.map(gp), b)
        _assert_same(ref.map(g), b)


def test_portfolio_never_loses_to_its_own_lane0():
    """With the port's own draws: lane 0 shares the single pipeline's
    construction seed, and the incumbent only improves, so the portfolio
    is never worse than the single-trajectory map (the reference's
    ``tests/test_portfolio.py`` invariant)."""
    g = _port_graph(rc.random_geometric(N, 0.25, seed=3))
    single = convert.spec(_spec(seed=0).to_dict())
    pf = single.replace(portfolio=PortSpec(
        lanes=4, rounds=3, tabu_tenure=0, dont_look=False,
        kick_strength=0.2, stagnation=2))
    mapper = tc.Mapper(_machine(tt, tc, "tree"), single, device="cpu")
    js = mapper.map(g).final_objective
    res = mapper.map(g, spec=pf)
    assert res.final_objective <= js
    assert sorted(res.perm.tolist()) == list(range(N))
    assert res.final_objective == tc.qap_objective(
        g, _machine(tt, tc, "tree"), res.perm)


def test_run_rounds_reads_once_a_round_beside_the_sweeps():
    """The round loop's counted reads are one a round (the stagnation
    stop) plus the sweep loop's own, each round's recorded; a spec of
    one round, or no pairs, reads nothing and returns the host argmin."""
    spec = convert.spec(_spec(portfolio=_PF).to_dict())
    mapper = tc.Mapper(_machine(tt, tc, "torus"), spec, device="cpu")
    gp = _port_graph(_graph())
    plan = mapper.lower_for(gp)
    eng = plan.engines[0]
    sweep_reads = []
    orig = eng._refine

    def counting(*a):
        hb = a[-1]
        before = hb.reads
        out = orig(*a)
        sweep_reads.append(hb.reads - before)
        return out
    eng._refine = counting
    res = plan.execute(gp)
    runner = plan.portfolio
    rounds = len(res.search_stats.objective_trace) - 2
    sweep_reads = sweep_reads[1:]           # the first: round 0's lanes
    assert len(runner.last_rounds) == len(sweep_reads) == rounds > 0
    assert [r["reads"] for r in runner.last_rounds] == \
        [1 + x for x in sweep_reads]
    assert runner.last_syncs["reads"] == rounds + sum(sweep_reads)
    assert runner.last_syncs["observed"] is None          # CPU
    assert [r["incumbent"] for r in runner.last_rounds] == \
        res.search_stats.objective_trace[2:]
    assert all(r["kick_ms"] >= 0 for r in runner.last_rounds)
    perms = [np.random.default_rng(s).permutation(N) for s in range(3)]
    out = runner.run_rounds(gp, perms, np.zeros((0, 2), np.int64),
                            [0.0] * 3)
    js = [tc.qap_objective(gp, eng.topology, p) for p in perms]
    assert out.rounds == 1 and out.round_objectives == [min(js)]
    assert np.array_equal(out.perm, perms[int(np.argmin(js))])
    assert runner.last_syncs["reads"] == 0


# ------------------------------------------------------------ the CLIs
def test_cli_portfolio_writes_the_reference_permutation(tmp_path, capsys,
                                                        reference_draws):
    from repro.cli import viem as ref_cli
    from repro_torch.cli import viem as port_cli
    graph = tmp_path / "g.metis"
    rc.write_metis(_graph(), graph)
    common = [str(graph), "--hierarchy_parameter_string=4:4:4",
              "--distance_parameter_string=1:10:100", "--portfolio",
              "--portfolio_lanes=3", "--portfolio_rounds=3",
              "--portfolio_kick=0.25", "--communication_neighborhood_dist=2",
              "--seed=2", "--preconfiguration_mapping=fast"]
    ref_cli.main(common + [f"--output_filename={tmp_path / 'ref'}"])
    port_cli.main(common + ["--device=cpu",
                            f"--output_filename={tmp_path / 'port'}"])
    assert "final objective" in capsys.readouterr().out
    assert (tmp_path / "ref").read_text() == (tmp_path / "port").read_text()


def test_evaluator_compare_spec_with_portfolio(tmp_path, capsys,
                                               reference_draws):
    from repro.cli import evaluator as ref_eval
    from repro_torch.cli import evaluator as port_eval
    g = _graph()
    graph, perm, spec_path = (tmp_path / "g.metis", tmp_path / "perm",
                              tmp_path / "spec.json")
    rc.write_metis(g, graph)
    np.savetxt(perm, np.random.default_rng(0).permutation(N), fmt="%d")
    spec_path.write_text(_spec(portfolio=_PF, seed=3).to_json())
    args = [str(graph), f"--input_mapping={perm}",
            "--hierarchy_parameter_string=4:4:4",
            "--distance_parameter_string=1:10:100",
            f"--compare_spec={spec_path}", "--seeds=2"]
    ref_eval.main(args)
    want = capsys.readouterr().out
    port_eval.main(args + ["--device=cpu"])
    got = capsys.readouterr().out
    assert got == want and "viem best/median" in got
