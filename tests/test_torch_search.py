"""The port's host search path against the JAX package: the sparse gain
machinery of ``core/objective.py``, the host drivers behind
``engine="host"`` (the default ``MappingSpec``), the ``viem`` CLI's
default invocation, ``logical_traffic_summary`` and the ``evaluator``
CLI.

The host code is numpy in both packages and the port's copy is
verbatim, so every comparison is exact: permutations, objectives,
search statistics and objective traces are identical, and the CLIs
print the same lines.
"""

import json

import numpy as np
import pytest
import torch

import repro.core as rc
import repro.topology as rt
import repro_torch.core as tc
import repro_torch.topology as tt
from repro.core import objective as robj
from repro_torch import convert
from repro_torch.core import objective as tobj

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


def _graphs():
    g = rc.random_geometric(N, 0.25, seed=3)
    return g, convert.graph(g.xadj, g.adjncy, g.adjwgt, g.vwgt)


# ------------------------------------------------------ objective module
@pytest.mark.parametrize("name", TOPOLOGIES)
def test_sparse_gains_equal_reference(name):
    h_ref, h_port = _machine(rt, rc, name), _machine(tt, tc, name)
    g_ref, g_port = _graphs()
    rng = np.random.default_rng(5)
    perm = rng.permutation(N)
    pairs = rc.local_search.communication_pairs(g_ref, 3)
    assert np.array_equal(tc.local_search.communication_pairs(g_port, 3),
                          pairs)
    want = robj.batched_swap_gains(g_ref, h_ref, perm, pairs)
    got = tobj.batched_swap_gains(g_port, h_port, perm, pairs)
    assert np.array_equal(got, want)
    for u, v in pairs[rng.choice(len(pairs), 40, replace=False)]:
        assert (tobj.swap_gain(g_port, h_port, perm, u, v)
                == robj.swap_gain(g_ref, h_ref, perm, u, v))
    assert tobj.batched_swap_gains(g_port, h_port, perm,
                                   np.zeros((0, 2), int)).shape == (0,)
    C, D = g_ref.to_dense(), h_ref.distance_matrix()
    assert (tobj.qap_objective_dense(C, D, perm)
            == robj.qap_objective_dense(C, D, perm)
            == rc.qap_objective(g_ref, h_ref, perm))
    p_ref, p_port = perm.copy(), perm.copy()
    robj.apply_swap(p_ref, 3, 17)
    tobj.apply_swap(p_port, 3, 17)
    assert np.array_equal(p_port, p_ref)
    assert tc.dense_gain_matrix is tobj.dense_gain_matrix
    assert np.array_equal(tobj.dense_gain_matrix(C, D, perm),
                          robj.dense_gain_matrix(C, D, perm))


# ---------------------------------------------------------- host drivers
def _host_spec(neighborhood, parallel, backend="numpy"):
    return rc.MappingSpec(neighborhood=neighborhood, neighborhood_dist=3,
                          parallel_sweeps=parallel, backend=backend,
                          max_sweeps=6, seed=1)


def _assert_same_map(a, b):
    assert np.array_equal(b.perm, a.perm)
    assert b.initial_objective == a.initial_objective
    assert b.final_objective == a.final_objective
    sa, sb = a.search_stats, b.search_stats
    assert (sb.swaps, sb.evaluated) == (sa.swaps, sa.evaluated)
    assert sb.objective_trace == sa.objective_trace
    assert sb.initial_objective == sa.initial_objective
    assert sb.final_objective == sa.final_objective


@pytest.mark.parametrize("parallel", [False, True], ids=["cyclic",
                                                         "parallel"])
@pytest.mark.parametrize("name,neighborhood", [
    *((t, "communication") for t in TOPOLOGIES),
    ("tree", "nsquare"), ("matrix", "nsquare"),
    ("tree", "nsquarepruned"), ("torus", "nsquarepruned"),
])
def test_host_engine_map_equals_reference(name, neighborhood, parallel):
    spec = _host_spec(neighborhood, parallel)
    ref = rc.Mapper(_machine(rt, rc, name), spec)
    port = tc.Mapper(_machine(tt, tc, name), convert.spec(spec.to_dict()),
                     device="cpu")
    g_ref, g_port = _graphs()
    a, b = ref.map(g_ref), port.map(g_port)
    _assert_same_map(a, b)
    assert b.search_stats.swaps > 0
    assert port.lower_for(g_port).engines is None     # no device engine


def test_host_engine_with_the_objective_kernel_equals_reference():
    """``backend="pallas"``: j0 and jf through K1's plain version."""
    spec = _host_spec("communication", False, backend="pallas")
    ref = rc.Mapper(_machine(rt, rc, "torus"), spec)
    port = tc.Mapper(_machine(tt, tc, "torus"),
                     convert.spec(spec.to_dict()), device="cpu")
    g_ref, g_port = _graphs()
    _assert_same_map(ref.map(g_ref), port.map(g_port))


def test_default_spec_maps_on_the_host_engine():
    """The default ``MappingSpec()`` (host engine, communication
    neighborhood) lowers and maps in the port."""
    spec = tc.MappingSpec()
    assert (spec.engine, spec.neighborhood) == ("host", "communication")
    g_ref, g_port = _graphs()
    a = rc.Mapper(_machine(rt, rc, "tree")).map(g_ref)
    b = tc.Mapper(_machine(tt, tc, "tree"), device="cpu").map(g_port)
    _assert_same_map(a, b)


def test_local_search_equals_reference():
    g_ref, g_port = _graphs()
    h_ref, h_port = _machine(rt, rc, "fattree"), _machine(tt, tc, "fattree")
    perm0 = np.random.default_rng(8).permutation(N)
    p_ref, p_port = perm0.copy(), perm0.copy()
    kw = dict(neighborhood="communication",
              communication_neighborhood_dist=2, seed=4, max_sweeps=5)
    sa = rc.local_search.local_search(g_ref, h_ref, p_ref, **kw)
    sb = tc.local_search.local_search(g_port, h_port, p_port, **kw)
    assert np.array_equal(p_port, p_ref)
    assert sb.objective_trace == sa.objective_trace
    assert (sb.swaps, sb.evaluated) == (sa.swaps, sa.evaluated)


def test_logical_traffic_summary_equals_reference():
    from repro.core.comm_model import logical_traffic_summary as ref_lts
    from repro_torch.core.comm_model import logical_traffic_summary
    g_ref, g_port = _graphs()
    perm = np.random.default_rng(2).permutation(N)
    h_ref = rc.Hierarchy((4, 4, 4), (1.0, 10.0, 100.0))
    h_port = tc.Hierarchy((4, 4, 4), (1.0, 10.0, 100.0))
    assert (logical_traffic_summary(g_port, h_port, perm)
            == ref_lts(g_ref, h_ref, perm))


# ------------------------------------------------------------------ CLIs
def test_viem_default_invocation_writes_the_reference_permutation(
        tmp_path, capsys):
    from repro.cli import viem as ref_cli
    from repro_torch.cli import viem as port_cli
    graph = tmp_path / "g.metis"
    rc.write_metis(rc.random_geometric(N, 0.25, seed=3), graph)
    common = [str(graph), "--hierarchy_parameter_string=4:4:4",
              "--distance_parameter_string=1:10:100",
              "--communication_neighborhood_dist=3", "--seed=2"]
    ref_cli.main(common + [f"--output_filename={tmp_path / 'ref'}"])
    port_cli.main(common + ["--device=cpu",
                            f"--output_filename={tmp_path / 'port'}"])
    assert "device               = cpu" in capsys.readouterr().out
    assert (tmp_path / "ref").read_text() == (tmp_path / "port").read_text()


def _evaluator_inputs(tmp_path):
    g = rc.random_geometric(N, 0.25, seed=3)
    graph = tmp_path / "g.metis"
    rc.write_metis(g, graph)
    mapping = tmp_path / "perm.txt"
    np.savetxt(mapping, np.random.default_rng(6).permutation(N), fmt="%d")
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps(rc.MappingSpec(
        neighborhood_dist=3, max_sweeps=6, seed=3).to_dict()))
    return graph, mapping, spec


@pytest.mark.parametrize("extra", [
    [], ["--compare_spec"], ["--compare_spec", "--seeds=2"],
    ["--topology=torus", '--topology_params={"dims": [4, 4, 4]}'],
], ids=["objective", "compare", "compare-seeds", "torus"])
def test_evaluator_prints_the_reference_lines(tmp_path, capsys, extra):
    from repro.cli import evaluator as ref_cli
    from repro_torch.cli import evaluator as port_cli
    graph, mapping, spec = _evaluator_inputs(tmp_path)
    argv = [str(graph), f"--input_mapping={mapping}"]
    if not any(a.startswith("--topology") for a in extra):
        argv += ["--hierarchy_parameter_string=4:4:4",
                 "--distance_parameter_string=1:10:100"]
    for flag in extra:
        argv += [f"--compare_spec={spec}"] if flag == "--compare_spec" \
            else [flag]
    ref_cli.main(argv)
    want = capsys.readouterr().out
    port_cli.main(argv + ["--device=cpu"])
    got = capsys.readouterr().out
    assert got.splitlines() == want.splitlines()
    assert "objective J(C,D,Pi)" in got
    if "--compare_spec" in extra:
        assert "given/viem ratio" in got


def test_evaluator_without_a_card_exits(tmp_path):
    from repro_torch.cli import evaluator as port_cli
    graph, mapping, spec = _evaluator_inputs(tmp_path)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(SystemExit) as exc:
        port_cli.main([str(graph), f"--input_mapping={mapping}",
                       "--hierarchy_parameter_string=4:4:4",
                       "--distance_parameter_string=1:10:100",
                       f"--compare_spec={spec}"])
    assert "no CUDA device" in str(exc.value.code)
