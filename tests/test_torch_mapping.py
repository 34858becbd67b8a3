"""The port's mapping path end to end against the JAX package.

``repro_torch`` ``Mapper(..., device="cpu").map`` with ``engine="device"``
and backend ``"pallas"`` (the objective kernel's plain version here) or
``"numpy"`` must give the JAX package's permutation, initial and final
objective and search statistics *exactly* on all five topologies
(integer weights and distances: every float32 sum is exact).  Also:
spec and plan-spec dict round trips, plan save/load, the ``viem`` CLI's
permutation file, and the unported CLI paths exiting (the host engine
is ported: ``tests/test_torch_search.py``; the multilevel V-cycle:
``tests/test_torch_multilevel.py``; batches and warm starts:
``tests/test_torch_batch.py``; the portfolio search:
``tests/test_torch_portfolio.py``).
"""

import functools
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as rc
import repro.topology as rt
import repro_torch.core as tc
import repro_torch.topology as tt
from repro.core.spec import KernelSpec, PortfolioSpec
from repro_torch import convert

N = 64
TOPOLOGIES = ["tree", "torus", "fattree", "dragonfly", "matrix"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run tiny tensors: one intra-op thread, so
    parallel test workers do not oversubscribe the CPU."""
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


def _spec(backend, **kw):
    return rc.MappingSpec(engine="device", backend=backend, max_sweeps=8,
                          neighborhood_dist=3, **kw)


@functools.lru_cache(maxsize=None)
def _mappers(name):
    """One session per package and topology, shared by both backends (so
    the JAX engine compiles once per topology)."""
    ref = rc.Mapper(_machine(rt, rc, name), _spec("pallas"))
    port = tc.Mapper(_machine(tt, tc, name),
                     convert.spec(_spec("pallas").to_dict()), device="cpu")
    return ref, port


def _graphs():
    g = rc.random_geometric(N, 0.25, seed=3)
    return g, convert.graph(g.xadj, g.adjncy, g.adjwgt, g.vwgt)


@pytest.mark.parametrize("backend", ["pallas", "numpy"])
@pytest.mark.parametrize("name", TOPOLOGIES)
def test_map_equals_reference(name, backend):
    ref, port = _mappers(name)
    g_ref, g_port = _graphs()
    spec = _spec(backend)
    a = ref.map(g_ref, spec=spec)
    b = port.map(g_port, spec=convert.spec(spec.to_dict()), telemetry=True)
    assert np.array_equal(a.perm, b.perm)
    assert sorted(b.perm.tolist()) == list(range(N))
    assert b.initial_objective == a.initial_objective
    assert b.final_objective == a.final_objective
    assert b.final_objective <= b.initial_objective
    sa, sb = a.search_stats, b.search_stats
    assert sb.swaps == sa.swaps and sb.evaluated == sa.evaluated
    assert sb.objective_trace == sa.objective_trace
    assert sb.final_objective == sa.final_objective
    assert sb.telemetry.total_exchanges == sb.swaps
    if name == "matrix":        # integer table: packed losslessly in both
        assert port.lower_for(g_port).describe()["kernels"]["quantized"]


@pytest.mark.parametrize("name", ["tree", "matrix"])
def test_describe_geometry_matches_reference(name):
    ref, port = _mappers(name)
    g_ref, g_port = _graphs()
    a = ref.lower_for(g_ref).describe()
    b = port.lower_for(g_port).describe()
    for key in ("machine", "bucket", "construction", "neighborhood",
                "engine", "backend", "kernels"):
        assert a[key] == b[key], key
    assert a["levels"][0]["kernel_config"] == b["levels"][0]["kernel_config"]
    assert b["device"] == "cpu"


def test_objective_backends_agree():
    ref, port = _mappers("torus")
    g_ref, g_port = _graphs()
    perm = np.random.default_rng(5).permutation(N)
    for backend in ("pallas", "numpy"):
        spec = _spec(backend)
        assert (port.objective(g_port, perm, convert.spec(spec.to_dict()))
                == ref.objective(g_ref, perm, spec))


# ------------------------------------------------------------ spec forms
def test_mapping_spec_and_plan_spec_round_trip():
    full = rc.MappingSpec(
        engine="device", backend="pallas", seed=7, max_sweeps=12,
        topology=rc.TopologySpec("torus", {"dims": [4, 4, 4]}),
        multilevel=rc.MultilevelSpec(levels=3, coarsen_min=16),
        portfolio=PortfolioSpec(lanes=2, rounds=2, constructions=("random",)),
        kernel=KernelSpec(block_rows=16, quantize="off"))
    d = full.to_dict()
    spec = convert.spec(d)
    assert spec.to_dict() == d
    assert tc.MappingSpec.from_json(spec.to_json()) == spec
    assert rc.MappingSpec.from_dict(spec.to_dict()) == full
    bucket = rc.ShapeBucket.of(rc.grid3d(4, 4, 4), num_pairs=300)
    ps = rc.PlanSpec(mapping=full, bucket=bucket)
    port_ps = convert.plan_spec(ps.to_dict())
    assert port_ps.to_dict() == ps.to_dict()
    assert tc.PlanSpec.from_json(port_ps.to_json()) == port_ps


def test_plan_save_load_reproduces_mapping(tmp_path):
    _, g_port = _graphs()
    spec = convert.spec(_spec("pallas").to_dict())
    mapper = tc.Mapper(_machine(tt, tc, "torus"), spec, device="cpu")
    plan = mapper.lower_for(g_port)
    first = plan.execute(g_port)
    path = tmp_path / "plan.json"
    plan.save(path)
    loaded = tc.MappingPlan.load(path, device="cpu")
    again = loaded.execute(g_port)
    assert np.array_equal(first.perm, again.perm)
    assert first.final_objective == again.final_objective
    assert loaded.to_dict() == plan.to_dict()
    import pickle
    clone = pickle.loads(pickle.dumps(plan))
    assert np.array_equal(clone.execute(g_port).perm, first.perm)
    # the JAX package loads the same plan file
    assert rc.MappingPlan.load(path).to_dict() == plan.to_dict()


def test_cli_writes_the_reference_permutation(tmp_path, capsys):
    from repro.cli import viem as ref_cli
    from repro_torch.cli import viem as port_cli
    graph = tmp_path / "g.metis"
    rc.write_metis(rc.random_geometric(N, 0.25, seed=3), graph)
    common = [str(graph), "--hierarchy_parameter_string=4:4:4",
              "--distance_parameter_string=1:10:100", "--engine=device",
              "--communication_neighborhood_dist=3", "--seed=2"]
    ref_cli.main(common + [f"--output_filename={tmp_path / 'ref'}"])
    port_cli.main(common + ["--device=cpu", "--telemetry",
                            f"--output_filename={tmp_path / 'port'}"])
    out = capsys.readouterr().out
    assert "engine sweeps" in out and "device               = cpu" in out
    assert (tmp_path / "ref").read_text() == (tmp_path / "port").read_text()


# ``--multilevel`` (flags0) and ``--portfolio`` (flags1) are ported:
# their parity tests are tests/test_torch_multilevel.py::
# test_cli_multilevel_writes_the_reference_permutation and
# tests/test_torch_portfolio.py::
# test_cli_portfolio_writes_the_reference_permutation.  ``--metrics-out``
# (flags2) and ``--profile`` (flags3) are ported too (their parity with
# ``repro.cli.viem`` is tests/test_torch_monitor.py::
# test_viem_profile_and_metrics_out_equal_reference); the ids and the
# name are kept, and each case now checks that its flag no longer exits
# and writes its file.
@pytest.mark.parametrize("flags,item", [
    pytest.param(["--metrics-out=m.json"], "item 10", id="flags2"),
    pytest.param(["--profile=t.json"], "item 10", id="flags3")])
def test_cli_unported_flags_exit(tmp_path, monkeypatch, flags, item):
    del item                        # the ROADMAP item is done
    from repro_torch.cli import viem as port_cli
    monkeypatch.chdir(tmp_path)
    graph = tmp_path / "g.metis"
    rc.write_metis(rc.grid3d(4, 4, 4), graph)
    port_cli.main([str(graph), "--hierarchy_parameter_string=4:4:4",
                   "--distance_parameter_string=1:10:100",
                   "--device=cpu"] + flags)
    text = (tmp_path / flags[0].split("=", 1)[1]).read_text()
    if flags[0].startswith("--metrics-out"):
        assert "viem_run_final_objective" in text
    else:
        assert json.loads(text)["traceEvents"]


# Both subcommands are ported now, and each case keeps its id:
# ``remap-watch`` (ROADMAP item 10; its parity tests are in
# tests/test_torch_monitor.py) reaches its own parser, which wants the
# graph file; ``lint`` (item 8; tests/test_torch_staticcheck.py) reaches
# the port's lint, which exits 0 on src/repro_torch.
@pytest.mark.parametrize("command,item", [("remap-watch", "item 10"),
                                          ("lint", "item 8")])
def test_cli_unported_commands_name_their_item(command, item, capsys):
    from repro_torch.cli import viem as port_cli
    root = Path(__file__).resolve().parents[1]
    extra = ["--root", str(root)] if command == "lint" else []
    with pytest.raises(SystemExit) as exc:
        port_cli.main([command, *extra])
    if command == "remap-watch":
        assert exc.value.code == 2                  # argparse: no file
        assert "the following arguments are required: file" \
            in capsys.readouterr().err
        return
    assert exc.value.code == 0
    out = capsys.readouterr().out
    assert "0 active finding(s)" in out
    assert "not ported" not in out


# ------------------------------------------------------ ported pipelines
# Every pipeline a spec selects is ported: the multilevel blocks' parity
# tests are tests/test_torch_multilevel.py::
# test_multilevel_specs_equal_reference, the portfolio block's
# tests/test_torch_portfolio.py::test_portfolio_map_equals_reference.


def test_flat_escape_hatches_are_allowed():
    """``MultilevelSpec(levels=1)`` is the flat pipeline, bit for bit."""
    _, g_port = _graphs()
    flat = convert.spec(_spec("pallas").to_dict())
    one = flat.replace(multilevel=tc.MultilevelSpec(levels=1))
    mapper = tc.Mapper(_machine(tt, tc, "tree"), flat, device="cpu")
    assert np.array_equal(mapper.map(g_port).perm,
                          mapper.map(g_port, spec=one).perm)


def test_default_device_is_cuda_and_never_falls_back():
    spec = convert.spec(_spec("pallas").to_dict())
    machine = _machine(tt, tc, "tree")
    if torch.cuda.is_available():
        assert tc.Mapper(machine, spec).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tc.Mapper(machine, spec)
    assert json.dumps(spec.to_dict())        # device is not a spec field
    assert "device" not in spec.to_dict()
