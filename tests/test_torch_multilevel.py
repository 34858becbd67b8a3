"""The port's multilevel V-cycle against the JAX package, on the CPU.

The contraction (``repro_torch.kernels.contract``: edge ratings, the
heavy-edge perfect pairing, labels, collapsed edges and vertex weights),
``coarsen_graph`` (coarse graph, ``fine_u``/``fine_v``),
``coarsen_machine`` on all five topologies, and the V-cycle itself
(permutation, per-level objectives, objective trace, telemetry) must
equal ``repro``'s *exactly* on integer weights and distances, where
every float32 sum is exact; the JAX side runs its jnp contraction and
its Pallas kernels in interpret mode, as its own tests do.  On real
weights the port's contraction must give the same bits from one run to
the next (it sums each run of merged edges in index order).  Also the
``MultilevelSpec`` and ``viem --multilevel`` parity cases that replace
the port's former "not ported" cases, plan geometry, caches and the
contraction's counted host syncs.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as rc
import repro.topology as rt
import repro_torch.core as tc
import repro_torch.topology as tt
from repro.kernels import contract as ck_ref
from repro.multilevel import coarsen as cz_ref
from repro.multilevel import vcycle as vc_ref
from repro_torch import convert
from repro_torch.kernels import contract as ck
from repro_torch.multilevel import coarsen as cz
from repro_torch.multilevel import vcycle as vc
from repro_torch.runtime.boundary import Boundary

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


def _weighted(g, seed, real=False):
    """``g`` with seeded weights: integers in [1, 9], or reals."""
    rng = np.random.default_rng(seed)
    u, v, _ = g.edge_list()
    w = (rng.random(len(u)) * 7.0 + 0.5 if real
         else rng.integers(1, 10, len(u)).astype(np.float64))
    vw = rng.integers(1, 4, g.n).astype(np.float64)
    return rc.from_edges(g.n, u, v, w, vwgt=vw)


def _graphs():
    """Integer-weight instances: a random geometric graph (isolated and
    low-degree vertices), a weighted stencil, and a sparse path-like
    graph whose matching leaves many vertices to the forced pairing."""
    path = rc.from_edges(N, np.arange(0, N - 1, 3), np.arange(1, N, 3),
                         np.arange(1, len(range(0, N - 1, 3)) + 1) * 1.0)
    return {"geometric": _weighted(rc.random_geometric(N, 0.2, seed=3), 1),
            "stencil": _weighted(rc.grid3d(4, 4, 4), 2),
            "sparse": path}


def _padded(g, extra=0):
    u, v, w = g.edge_list()
    e = max(128, -(-max(len(u), 1) // 128) * 128) + extra
    pad = e - len(u)
    arrs = (np.pad(u, (0, pad)).astype(np.int32),
            np.pad(v, (0, pad)).astype(np.int32),
            np.pad(w, (0, pad)).astype(np.float32))
    return [jnp.asarray(a) for a in arrs], [torch.from_numpy(a)
                                            for a in arrs]


# --------------------------------------------------------- contraction
@pytest.mark.parametrize("name", ["geometric", "stencil", "sparse"])
def test_contraction_equals_reference_exactly(name):
    g = _graphs()[name]
    (ju, jv, jw), (tu, tv, tw) = _padded(g)
    n = g.n
    hb = Boundary("test")
    assert np.array_equal(np.asarray(ck_ref.edge_ratings(ju, jv, jw, n)),
                          ck.edge_ratings(tu, tv, tw, n).numpy())
    m_ref = np.asarray(ck_ref.heavy_edge_matching(ju, jv, jw, n))
    match = ck.heavy_edge_matching(tu, tv, tw, n, hb)
    assert match.dtype == torch.int32
    m = match.numpy()
    assert np.array_equal(m, m_ref)
    assert np.all(m != np.arange(n)) and np.all(m[m] == np.arange(n))
    lab_ref = ck_ref.labels_of_matching(jnp.asarray(m_ref))
    labels = ck.labels_of_matching(match)
    assert np.array_equal(labels.numpy(), np.asarray(lab_ref))
    assert np.all(np.bincount(labels.numpy(), minlength=n // 2) == 2)
    want = [np.asarray(x) for x in ck_ref.contract_edges(ju, jv, jw,
                                                         lab_ref, n)]
    got = [x.numpy() for x in ck.contract_edges(tu, tv, tw, labels, n, hb)]
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    vw = g.vwgt.astype(np.float32)
    assert np.array_equal(
        ck.contract_vwgt(torch.from_numpy(vw), labels, hb).numpy(),
        np.asarray(ck_ref.contract_vwgt(jnp.asarray(vw), lab_ref)))
    # every host sync of the contraction went through the boundary
    assert hb.reads >= 4


@pytest.mark.parametrize("name", ["geometric", "stencil"])
def test_coarsen_arrays_and_graph_equal_reference(name):
    g = _graphs()[name]
    (ju, jv, jw), (tu, tv, tw) = _padded(g)
    vw = g.vwgt.astype(np.float32)
    want = ck_ref.coarsen_arrays(ju, jv, jw, jnp.asarray(vw))
    got = ck.coarsen_arrays(tu, tv, tw, torch.from_numpy(vw),
                            Boundary("test"))
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))
    ref_c, ref_u, ref_v = cz_ref.coarsen_graph(g)
    syncs = {}
    c, fu, fv = cz.coarsen_graph(_port_graph(g), "cpu", syncs)
    assert np.array_equal(fu, ref_u) and np.array_equal(fv, ref_v)
    for key in ("xadj", "adjncy", "adjwgt", "vwgt"):
        assert np.array_equal(getattr(c, key), getattr(ref_c, key)), key
    assert syncs["reads"] > 0 and syncs["observed"] is None


def test_contraction_is_padding_inert_and_deterministic_on_real_weights():
    g = _weighted(rc.random_geometric(N, 0.25, seed=5), 4, real=True)
    _, (tu, tv, tw) = _padded(g)
    _, (bu, bv, bw) = _padded(g, extra=256)
    vw = torch.from_numpy(g.vwgt.astype(np.float32))
    first = ck.coarsen_arrays(tu, tv, tw, vw, Boundary("a"))
    again = ck.coarsen_arrays(tu, tv, tw, vw, Boundary("b"))
    big = ck.coarsen_arrays(bu, bv, bw, vw, Boundary("c"))
    e = tu.shape[0]
    for a, b, c in zip(first, again, big):
        assert torch.equal(a, b)
        assert torch.equal(c[:a.shape[0]], a)
    assert torch.all(big[3][e:] == 0.0)
    # merged runs are summed in index order: check against a numpy
    # left-to-right sum over the reference's sorted keys
    labels = first[0].numpy().astype(np.int64)
    u, v, w = g.edge_list()
    lo = np.minimum(labels[u], labels[v])
    hi = np.maximum(labels[u], labels[v])
    keep = lo != hi
    key = lo[keep] * g.n + hi[keep]
    w32 = w[keep].astype(np.float32)
    order = np.argsort(key, kind="stable")
    sums = {}
    for k, x in zip(key[order], w32[order]):
        sums[k] = np.float32(sums.get(k, np.float32(0.0)) + x)
    live = first[3].numpy() > 0
    got = dict(zip((first[1].numpy()[live].astype(np.int64) * g.n
                    + first[2].numpy()[live]).tolist(),
                   first[3].numpy()[live].tolist()))
    assert got == {k: float(s) for k, s in sums.items()}


def test_contraction_rejects_odd_and_oversized_graphs():
    with pytest.raises(ValueError, match="odd"):
        cz.coarsen_graph(_port_graph(rc.grid3d(3, 3, 1)), "cpu")
    assert ck.MAX_N == ck_ref.MAX_N


def test_contraction_device_defaults_to_cuda(monkeypatch):
    """``coarsen_graph`` and ``build_pyramid`` resolve their device as
    every entry point does: cuda unless the caller asks for the CPU, and
    without a card that default raises rather than falling back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = _port_graph(_graphs()["stencil"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cz.coarsen_graph(g)
    machines = [tt.TorusTopology((4, 4, 4))] * 2
    no_pairs = lambda gg: np.zeros((0, 2), np.int64)  # noqa: E731
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cz.build_pyramid(g, machines, 2, 8, no_pairs)
    assert len(cz.build_pyramid(g, machines, 2, 8, no_pairs,
                                device="cpu")) == 2


@pytest.mark.parametrize("name", TOPOLOGIES)
def test_coarsen_machine_equals_reference(name):
    ref, port = _machine(rt, rc, name), _machine(tt, tc, name)
    for _ in range(3):
        ref, port = (cz_ref.coarsen_machine(ref),
                     cz.coarsen_machine(port))
        assert port.kind == ref.kind == "matrix"
        assert np.array_equal(port.matrix(), ref.matrix())
    for n in (64, 48, 10, 7):
        for levels, cmin in ((4, 8), (6, 2), (2, 64)):
            assert cz.pyramid_depth(n, levels, cmin) == \
                cz_ref.pyramid_depth(n, levels, cmin)
    perm = np.random.default_rng(1).permutation(8)
    fu, fv = np.arange(0, 16, 2), np.arange(1, 16, 2)
    assert np.array_equal(cz.project_perm(perm, fu, fv),
                          cz_ref.project_perm(perm, fu, fv))


# ------------------------------------------------------------- V-cycle
def _spec(**kw):
    kw.setdefault("multilevel", rc.MultilevelSpec(levels=3, coarsen_min=8))
    return rc.MappingSpec(engine="device", backend="pallas", max_sweeps=8,
                          neighborhood_dist=3, **kw)


@functools.lru_cache(maxsize=None)
def _mappers(name):
    spec = _spec()
    return (rc.Mapper(_machine(rt, rc, name), spec),
            tc.Mapper(_machine(tt, tc, name), convert.spec(spec.to_dict()),
                      device="cpu"))


def _assert_same_result(a, b):
    assert np.array_equal(a.perm, b.perm)
    assert sorted(b.perm.tolist()) == list(range(len(b.perm)))
    assert b.initial_objective == a.initial_objective
    assert b.final_objective == a.final_objective
    sa, sb = a.search_stats, b.search_stats
    assert sb.swaps == sa.swaps and sb.evaluated == sa.evaluated
    assert sb.objective_trace == sa.objective_trace


def _record_swaps(monkeypatch, engines, method):
    """Wrap each engine's ``method`` (``refine`` for ``repro``'s single
    V-cycle, ``refine_batch`` for the port's) to append each call's swap
    counts — one call a level, coarsest first."""
    swaps = []
    for eng in engines:
        orig = getattr(eng, method)

        def recording(*a, _orig=orig, **kw):
            out = _orig(*a, **kw)
            swaps.append([s.swaps for s in out] if isinstance(out, list)
                         else [out.swaps])
            return out
        monkeypatch.setattr(eng, method, recording)
    return swaps


@pytest.mark.parametrize("name", TOPOLOGIES)
def test_vcycle_equals_reference_exactly(name, monkeypatch):
    ref, port = _mappers(name)
    g = _graphs()["geometric"]
    gp = _port_graph(g)
    p_ref, p_port = ref.lower_for(g), port.lower_for(gp)
    swaps_ref = _record_swaps(monkeypatch, p_ref.engines, "refine")
    swaps = _record_swaps(monkeypatch, p_port.engines, "refine_batch")
    pyr_ref, pyr = p_ref._pyramid(g, 0), p_port._pyramid(gp, 0)
    assert len(pyr) == len(pyr_ref) == 3
    for a, b in zip(pyr_ref, pyr):
        assert np.array_equal(a.pairs, b.pairs)
        assert np.array_equal(a.graph.adjwgt, b.graph.adjwgt)
        assert np.array_equal(a.machine.matrix(), b.machine.matrix())
    want = vc_ref.vcycle_map(pyr_ref, p_ref.engines, p_ref._construct,
                             p_ref._cfg, seed=0, objective0=p_ref.objective,
                             bucket=p_ref.bucket, telemetry=True)
    got = vc.vcycle_map(pyr, p_port.engines, p_port._construct,
                        p_port._cfg, seed=0, objective0=p_port.objective,
                        bucket=p_port.bucket, telemetry=True)
    assert np.array_equal(got.perm, want.perm)
    assert got.level_objectives == want.level_objectives
    assert got.initial_objective == want.initial_objective
    assert got.stats.objective_trace == want.stats.objective_trace
    assert np.array_equal(got.stats.telemetry.match_rounds,
                          want.stats.telemetry.match_rounds)
    # the comparisons above are of refinements that moved: every level's
    # swaps equal the reference's, the finest level swaps on every
    # topology, and a coarse level too on the torus and the matrix
    assert swaps == swaps_ref and len(swaps) == 3
    assert swaps[-1][0] > 0
    if name in ("torus", "matrix"):
        assert swaps[0][0] > 0 and swaps[1][0] > 0
    _assert_same_result(ref.map(g), port.map(gp))


def _chip_smoke():
    """``chip_smoke.py`` as a module (its constants only: importing it
    runs nothing)."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_eco_main_cell_levels_equal_reference(monkeypatch):
    """The card's multilevel cell on the CPU: ``eco`` on 4:16:64 /
    1:10:100 with the 16³ stencil (n = 4096 → 512, 4 levels).  The
    port's V-cycle equals ``repro``'s level by level — start and refined
    objectives and swap counts — and its permutation; the card's run of
    the same call is held to the port's CPU refinement level by level
    (``chip_smoke.py``, phase multilevel), so this is the reference's
    word on what that run's levels should do."""
    d = dict(rc.MappingSpec(engine="device", backend="pallas",
                            multilevel=rc.MultilevelSpec(),
                            preconfiguration="eco").to_dict())
    g = rc.grid3d(16, 16, 16)
    gp = _port_graph(g)
    ref = rc.Mapper(rc.Hierarchy((4, 16, 64), (1.0, 10.0, 100.0)),
                    rc.MappingSpec.from_dict(d))
    port = tc.Mapper(tc.Hierarchy((4, 16, 64), (1.0, 10.0, 100.0)),
                     convert.spec(d), device="cpu")
    p_ref, p_port = ref.lower_for(g), port.lower_for(gp)
    assert len(p_port.engines) == len(p_ref.engines) == 4
    levels_ref, levels = [], []
    for engines, method, out in ((p_ref.engines, "refine", levels_ref),
                                 (p_port.engines, "refine_batch", levels)):
        for eng in engines:
            orig = getattr(eng, method)

            def recording(*a, _orig=orig, _out=out, **kw):
                res = _orig(*a, **kw)
                for st in (res if isinstance(res, list) else [res]):
                    _out.append((st.initial_objective, st.final_objective,
                                 st.swaps))
                return res
            monkeypatch.setattr(eng, method, recording)
    a, b = ref.map(g), port.map(gp)
    assert levels == levels_ref and len(levels) == 4
    assert np.array_equal(a.perm, b.perm)
    assert b.final_objective == a.final_objective
    # the values the card's run is held to
    smoke = _chip_smoke()
    assert levels_ref == list(smoke.ML_REFERENCE_LEVELS)


@pytest.mark.parametrize("block", [{"levels": 3},
                                   {"levels": 2, "coarsen_min": 8},
                                   {}])
def test_multilevel_specs_equal_reference(block):
    """The specs the port once refused (and the preconfiguration's
    default block) map as ``repro`` maps them."""
    d = dict(_spec().to_dict(), multilevel=block)
    spec = rc.MappingSpec.from_dict(d)
    g = _graphs()["stencil"]
    a = rc.Mapper(_machine(rt, rc, "tree"), spec).map(g)
    port = tc.Mapper(_machine(tt, tc, "tree"), convert.spec(d),
                     device="cpu")
    b = port.map(_port_graph(g))
    _assert_same_result(a, b)
    plan = port.lower_for(_port_graph(g))
    assert plan.describe()["multilevel"] == {
        "levels": spec.resolved_multilevel()[0],
        "coarsen_min": spec.resolved_multilevel()[1]}


def test_levels_one_is_the_flat_engine():
    g = _port_graph(_graphs()["stencil"])
    flat = convert.spec(_spec(multilevel=None).to_dict())
    port = tc.Mapper(_machine(tt, tc, "tree"), flat, device="cpu")
    one = flat.replace(multilevel=tc.MultilevelSpec(levels=1))
    a, b = port.map(g), port.map(g, spec=one)
    assert np.array_equal(a.perm, b.perm)
    assert a.search_stats.objective_trace == b.search_stats.objective_trace


@pytest.mark.parametrize("name", ["tree", "matrix"])
def test_multilevel_describe_matches_reference(name):
    ref, port = _mappers(name)
    g = _graphs()["geometric"]
    a = ref.lower_for(g).describe()
    b = port.lower_for(_port_graph(g)).describe()
    for key in ("machine", "bucket", "multilevel", "kernels"):
        assert a[key] == b[key], key
    strip = ("engine_compiled",)
    assert [{k: v for k, v in lv.items() if k not in strip}
            for lv in a["levels"]] == \
        [{k: v for k, v in lv.items() if k not in strip}
         for lv in b["levels"]]
    assert b["device"] == "cpu"


def test_multilevel_caches_and_clear():
    _, port = _mappers("torus")
    gp = _port_graph(_graphs()["stencil"])
    plan = port.lower_for(gp)
    first = port.map(gp)
    before = plan.cache_info()
    again = port.map(gp)
    after = plan.cache_info()
    assert np.array_equal(first.perm, again.perm)
    assert after["pyramid_hits"] == before["pyramid_hits"] + 1
    assert after["pyramid_builds"] == before["pyramid_builds"]
    assert port.cache_info()["pyramid_builds"] >= 1
    plan.clear_request_caches()
    assert len(plan._pyramids) == 0 and len(plan._pairs_lru) == 0
    assert all(len(e._dg_cache) == 0 for e in plan.engines)
    assert np.array_equal(port.map(gp).perm, first.perm)
    # the machine pyramid is built once a session, shared by plans
    assert port._ml_machines[1] is plan.machines[1]


def test_pyramid_levels_record_counted_contraction_syncs():
    _, port = _mappers("tree")
    gp = _port_graph(_graphs()["geometric"])
    pyr = port.lower_for(gp)._pyramid(gp, 0)
    assert pyr[0].syncs is None
    for level in pyr[1:]:
        assert level.syncs["reads"] >= 4      # matching rounds + 2 sums
        assert level.syncs["observed"] is None            # no card here


def test_cli_multilevel_writes_the_reference_permutation(tmp_path, capsys):
    from repro.cli import viem as ref_cli
    from repro_torch.cli import viem as port_cli
    graph = tmp_path / "g.metis"
    rc.write_metis(rc.grid3d(4, 4, 4), graph)
    common = [str(graph), "--hierarchy_parameter_string=4:4:4",
              "--distance_parameter_string=1:10:100", "--multilevel",
              "--multilevel_levels=3", "--multilevel_coarsen_min=8",
              "--communication_neighborhood_dist=3", "--seed=1"]
    ref_cli.main(common + [f"--output_filename={tmp_path / 'ref'}"])
    port_cli.main(common + ["--device=cpu",
                            f"--output_filename={tmp_path / 'port'}"])
    assert "final objective" in capsys.readouterr().out
    assert (tmp_path / "ref").read_text() == (tmp_path / "port").read_text()
