"""The port's HLO-text analysis (``repro_torch.analysis``), its traffic
graphs and model generation (``repro_torch.core.comm_model``) and the
guide's ``graphchecker`` / ``generate_model`` CLIs against the JAX
package's, exactly.

The HLO texts: the committed fixture ``tests/fixtures/collectives.hlo``,
the synthetic module of ``tests/test_analysis.py``, and two programs
compiled by jax here (a scanned matmul in this process, and a
``shard_map`` program with an all-reduce in a scan, a collective-permute
and an all-gather over 8 forced CPU devices in a subprocess).  The test
imports jax; the port never does.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import repro.analysis as ra
import repro.analysis.hlo as rhlo
import repro.core as rc
from repro.core import comm_model as rcm
import repro_torch.analysis as ta
import repro_torch.analysis.hlo as thlo
import repro_torch.core as tc
from repro_torch.core import comm_model as tcm

from test_analysis import SYNTH
from test_comm_model import EXPECTED

FIXTURE = Path(__file__).parent / "fixtures" / "collectives.hlo"

_SHARDED_PROBE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("x", "y"))
def f(a, w):
    def body(c, wl):
        return jax.lax.psum(jnp.tanh(c @ wl), "y") + c, ()
    h, _ = jax.lax.scan(body, a, w)
    h = jax.lax.ppermute(h, "x", [(0, 1), (1, 0)])
    return jax.lax.all_gather(h, "y", tiled=True)
g = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=(P("x", "y"), P()),
                          out_specs=P("x", None), check_vma=False))
c = g.lower(jax.ShapeDtypeStruct((16, 32), jnp.float32),
            jax.ShapeDtypeStruct((3, 8, 8), jnp.float32)).compile()
sys.stdout.write(c.as_text())
"""


def _scan_module() -> str:
    import jax
    import jax.numpy as jnp
    d = 64

    def step(w, x):
        def body(c, wl):
            return jnp.tanh(c @ wl), ()
        h, _ = jax.lax.scan(body, x, w)
        return jnp.sum(h)
    return jax.jit(step).lower(
        jax.ShapeDtypeStruct((5, d, d), jnp.float32),
        jax.ShapeDtypeStruct((8, d), jnp.float32)).compile().as_text()


def _sharded_module() -> str:
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", _SHARDED_PROBE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


@pytest.fixture(scope="module")
def modules():
    return {"fixture": FIXTURE.read_text(), "synthetic": SYNTH,
            "compiled-scan": _scan_module(),
            "compiled-sharded": _sharded_module()}


SOURCES = ["fixture", "synthetic", "compiled-scan", "compiled-sharded"]


def _cost_view(cost) -> dict:
    return dict(dataclasses.asdict(cost), ici_bytes=cost.ici_bytes,
                dcn_bytes=cost.dcn_bytes,
                collective_bytes=cost.collective_bytes,
                by_type=cost.by_type())


# ---------------------------------------------------------------- hlo.py
@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("pod_size", [4, 256])
def test_analyze_equals_reference(modules, source, pod_size):
    text = modules[source]
    ref = _cost_view(ra.analyze(text, pod_size=pod_size))
    port = _cost_view(ta.analyze(text, pod_size=pod_size))
    assert port == ref
    if source != "fixture":
        return
    assert port["trip_counts"] == {"w": 4}


@pytest.mark.parametrize("source", SOURCES)
def test_parse_module_equals_reference(modules, source):
    ref = ra.parse_module(modules[source])
    port = ta.parse_module(modules[source])
    assert list(port) == list(ref)
    for name, comp in ref.items():
        assert dataclasses.asdict(port[name]) == dataclasses.asdict(comp)
        assert [i.operands for i in port[name].instructions] == \
            [i.operands for i in comp.instructions]


@pytest.mark.parametrize("source", SOURCES)
def test_collective_instances_equal_reference(modules, source):
    ref = list(rhlo.collective_instances(modules[source]))
    port = list(thlo.collective_instances(modules[source]))
    assert port == ref
    if source == "compiled-sharded":
        assert {op for op, *_ in port} == {"all-reduce", "all-gather",
                                           "collective-permute"}


def test_hlo_helpers_equal_reference():
    for shape in ("f32[8,16]{1,0}", "bf16[2,3]", "(s32[], bf16[4,4]{1,0})",
                  "pred[]", "f8e4m3fn[3,5]", ""):
        assert thlo.shape_numel_bytes(shape) == rhlo.shape_numel_bytes(shape)
    for op in ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute"):
        for g in (1, 2, 16):
            assert thlo._ring_factor(op, g) == rhlo._ring_factor(op, g)
    for rest in ("%y), replica_groups=[16,32]<=[32,16]T(1,0), x",
                 "%y), replica_groups={{0,1,2},{3,4,5}}, x",
                 "%y), replica_groups=[32,16]<=[512], x"):
        for pod in (4, 256):
            a = thlo._replica_group_info(
                thlo.Instruction("x", "f32[4]", "all-reduce", rest), pod)
            b = rhlo._replica_group_info(
                rhlo.Instruction("x", "f32[4]", "all-reduce", rest), pod)
            assert a == b


# ------------------------------------------------------------ roofline.py
@pytest.mark.parametrize("source", SOURCES)
def test_roofline_from_cost_equals_reference(modules, source):
    text = modules[source]
    for model_flops in (0.0, 1e6):
        ref = ra.roofline_from_cost(ra.analyze(text), model_flops)
        port = ta.roofline_from_cost(ta.analyze(text), model_flops)
        assert port.row() == ref.row()
        assert port.mfu_bound == ref.mfu_bound


def test_roofline_constants_and_terms_equal_reference():
    from repro.analysis import roofline as rr
    from repro_torch.analysis import roofline as tr
    for name in ("PEAK_FLOPS_BF16", "HBM_BW", "ICI_BW", "DCN_BW"):
        assert getattr(tr, name) == getattr(rr, name)
    cost = dict(flops=197e12, hbm_bytes=819e9 * 2)
    ref = ra.roofline_from_cost(rhlo.HloCost(**cost), 98.5e12)
    port = ta.roofline_from_cost(thlo.HloCost(**cost), 98.5e12)
    assert port.row() == ref.row() and port.bound == "memory"


# ---------------------------------------------------------- comm_model.py
def _edges(g) -> dict:
    u, v, w = g.edge_list()
    return {(int(a), int(b)): float(c) for a, b, c in zip(u, v, w)}


def _same_graph(port, ref) -> None:
    assert port.n == ref.n
    for attr in ("xadj", "adjncy", "adjwgt", "vwgt"):
        np.testing.assert_array_equal(getattr(port, attr),
                                      getattr(ref, attr))


def test_device_comm_graph_fixture_equals_reference_and_hand_prices():
    text = FIXTURE.read_text()
    port = tcm.device_comm_graph(text, 8)
    _same_graph(port, rcm.device_comm_graph(text, 8))
    assert _edges(port) == pytest.approx(EXPECTED)
    tc.validate(port)


@pytest.mark.parametrize("source,n", [("synthetic", 512),
                                      ("compiled-scan", 4),
                                      ("compiled-sharded", 8)])
def test_device_comm_graph_equals_reference(modules, source, n):
    _same_graph(tcm.device_comm_graph(modules[source], n),
                rcm.device_comm_graph(modules[source], n))


def test_device_comm_graph_no_collectives_equals_reference():
    text = ("HloModule empty\n\nENTRY %main () -> f32[] {\n"
            "  ROOT %c = f32[] constant(0)\n}\n")
    port = tcm.device_comm_graph(text, 4)
    _same_graph(port, rcm.device_comm_graph(text, 4))
    assert port.num_edges == 0


@pytest.mark.parametrize("pre", ["fast", "eco", "strong"])
@pytest.mark.parametrize("k", [4, 8])
def test_generate_model_equals_reference(pre, k):
    g = rc.random_geometric(64, radius=0.3, seed=3)
    ref_model, ref_labels = rcm.generate_model(g, k, preconfiguration=pre,
                                               seed=1)
    port_model, port_labels = tcm.generate_model(
        tc.CommGraph(g.xadj, g.adjncy, g.adjwgt, g.vwgt), k,
        preconfiguration=pre, seed=1)
    np.testing.assert_array_equal(port_labels, ref_labels)
    _same_graph(port_model, ref_model)


def test_logical_traffic_summary_on_the_fixture_equals_reference():
    text = FIXTURE.read_text()
    perm = np.array([1, 0, 3, 2, 5, 4, 7, 6])
    ref = rcm.logical_traffic_summary(
        rcm.device_comm_graph(text, 8),
        rc.Hierarchy((2, 2, 2), (1.0, 10.0, 100.0)), perm)
    port = tcm.logical_traffic_summary(
        tcm.device_comm_graph(text, 8),
        tc.Hierarchy((2, 2, 2), (1.0, 10.0, 100.0)), perm)
    assert port == ref


# ------------------------------------------------------------------ CLIs
def _cli(module: str, args, cwd) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).parents[1] / "src"),
               JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", module, *args], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


@pytest.mark.parametrize("case", ["valid", "corrupt"])
def test_graphchecker_cli_equals_reference(tmp_path, case):
    path = tmp_path / "g.graph"
    rc.write_metis(rc.grid3d(3, 3, 2), path)
    if case == "corrupt":
        lines = path.read_text().splitlines()
        lines[1] = lines[1] + " 99"          # an edge to no vertex
        path.write_text("\n".join(lines) + "\n")
    ref = _cli("repro.cli.graphchecker", [str(path)], tmp_path)
    port = _cli("repro_torch.cli.graphchecker", [str(path)], tmp_path)
    assert (port.returncode, port.stdout) == (ref.returncode, ref.stdout)
    assert ("corrupt" in port.stdout) == (case == "corrupt")


@pytest.mark.parametrize("pre", ["eco", "fastsocial"])
def test_generate_model_cli_equals_reference(tmp_path, pre):
    path = tmp_path / "app.graph"
    rc.write_metis(rc.random_geometric(96, radius=0.25, seed=5), path)
    outs = {}
    for pkg in ("repro", "repro_torch"):
        out = tmp_path / f"{pkg}.model"
        run = _cli(f"{pkg}.cli.generate_model",
                   [str(path), "--k=8", "--seed=2", f"--preconfiguration={pre}",
                    f"--output_filename={out}"], tmp_path)
        assert run.returncode == 0, run.stderr
        outs[pkg] = (run.stdout.replace(str(out), "OUT"), out.read_text())
    assert outs["repro_torch"] == outs["repro"]
