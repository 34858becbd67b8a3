"""The port's own traffic graph: the dry-run's collectives resolved by
their ranks and recorded as the instances ``device_comm_graph`` takes
(``repro_torch.launch.dryrun.CollectiveRecord``), against the JAX
package's graph of HLO text with the same replica groups.

The fake process group runs in subprocesses (``tests/_traffic_worker.py``
and ``python -m repro_torch.launch.dryrun``), never in the test process:

  * each collective kind over each mesh dim of a (2, 2, 4) ("pod",
    "data", "model") mesh and over (pod, data) flattened: the port's
    graph of the record equals ``repro.core.comm_model.device_comm_graph``
    of HLO text whose replica groups are listed explicitly and in iota
    form (exact); a group that is no product of mesh dims raises;
  * two cells traced in one process (granite-3-2b at one layer,
    train_4k then decode_32k on the multi mesh) give the rows and
    records of each traced first in a fresh process (exact);
  * a cell traced on a seeded placement of the mesh gives the identity
    layout's record (exact);
  * ``--save-collectives``'s file loads back to the same graph (exact);
  * the whole chain: ``viem_device_order`` and ``fleet_monitor`` on a
    small sharded step's record equal the JAX package's on HLO text
    written from the same instances (order and J exact), and a quiet
    ``observe_hlo`` + ``tick`` commits no remap in either.
"""

import itertools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import repro.core as rc
from repro.core import comm_model as rcm
import repro_torch.core as tc
from repro_torch.core import comm_model as tcm
from repro_torch.launch.dryrun import CollectiveRecord, load_collectives

import _traffic_worker as worker
from test_torch_analysis import _same_graph

_ROOT = Path(__file__).resolve().parents[1]
_ENV = dict(os.environ, PYTHONPATH=str(_ROOT / "src"))
_HLO_OPS = {"all_gather_into_tensor": "all-gather",
            "reduce_scatter_tensor": "reduce-scatter",
            "all_reduce": "all-reduce", "all_to_all_single": "all-to-all",
            "shard_dim_alltoall": "all-to-all"}
CASES = [(op, span) for op in worker.OPS for span in worker.SPANS]
HIERARCHY = ("4:2:2", "1:10:100")       # 16 PEs: the small mesh's devices


def _run(cmd, timeout=600):
    proc = subprocess.run(cmd, env=_ENV, capture_output=True, text=True,
                          timeout=timeout, cwd=_ROOT)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    out = tmp_path_factory.mktemp("traffic")
    _run([sys.executable, str(Path(worker.__file__)), str(out)])
    return out, json.loads((out / "worker.json").read_text())


# ------------------------------------------------------------ HLO text
def _groups(shape, names, dims) -> list:
    """Every group over ``dims`` in logical ids, row-major over ``dims``
    (enumerated here, not taken from the port)."""
    span = [names.index(d) for d in dims]
    rest = [i for i in range(len(shape)) if i not in span]
    out = []
    for fixed in itertools.product(*(range(shape[i]) for i in rest)):
        grp = []
        for moving in itertools.product(*(range(shape[i]) for i in span)):
            coord = [0] * len(shape)
            for i, c in zip(rest, fixed):
                coord[i] = c
            for i, c in zip(span, moving):
                coord[i] = c
            grp.append(int(np.ravel_multi_index(coord, shape)))
        out.append(grp)
    return out


def _replica_groups(shape, names, dims, form) -> str:
    if form == "explicit":
        return "{" + ",".join("{" + ",".join(map(str, g)) + "}"
                              for g in _groups(shape, names, dims)) + "}"
    span = [names.index(d) for d in dims]
    perm = [i for i in range(len(shape)) if i not in span] + span
    g = int(np.prod([shape[i] for i in span]))
    dims_s = ",".join(map(str, shape))
    return (f"[{int(np.prod(shape)) // g},{g}]<=[{dims_s}]"
            f"T({','.join(map(str, perm))})")


def _hlo(record: dict, form: str) -> str:
    """HLO text holding each instance of ``record`` as a while loop whose
    trip count is its multiplier and whose body runs the collective on a
    ``u8[operand_bytes]`` parameter, in the record's order."""
    shape, names = tuple(record["shape"]), tuple(record["dim_names"])
    bodies, entry = [], []
    for k, inst in enumerate(record["instances"]):
        n, op = inst["operand_bytes"], inst["op"]
        rg = _replica_groups(shape, names, inst["dims"], form)
        g = int(np.prod([shape[names.index(d)] for d in inst["dims"]]))
        out = {"all-gather": n * g, "reduce-scatter": n // g}.get(op, n)
        bodies.append(
            f"%body{k} (p{k}: u8[{n}]) -> u8[{out}] {{\n"
            f"  %p{k} = u8[{n}]{{0}} parameter(0)\n"
            f"  ROOT %c{k} = u8[{out}]{{0}} {op}(u8[{n}]{{0}} %p{k}), "
            f"channel_id={k + 1}, replica_groups={rg}, dimensions={{0}}, "
            f"use_global_device_ids=true\n}}\n")
        mult = inst["multiplier"]
        assert mult == int(mult)
        entry.append(
            f"  %a{k} = u8[{n}]{{0}} parameter({k})\n"
            f"  %w{k} = u8[{out}]{{0}} while(u8[{n}]{{0}} %a{k}), "
            f"body=%body{k}, backend_config={{\"known_trip_count\":"
            f"{{\"n\":\"{int(mult)}\"}}}}\n")
    return ("HloModule record\n\n" + "\n".join(bodies)
            + "\nENTRY %main () -> u8[1] {\n" + "".join(entry)
            + "  ROOT %z = u8[1]{0} constant({0})\n}\n")


# ---------------------------------------------------- each collective
@pytest.mark.parametrize("form", ["explicit", "iota"])
@pytest.mark.parametrize("op,span", CASES,
                         ids=[f"{o}-{'+'.join(s)}" for o, s in CASES])
def test_collective_graph_equals_reference(traced, op, span, form):
    _, out = traced
    rec = out["cases"][f"{op}:{'+'.join(span)}"]
    shape, names = worker.MESH
    assert tuple(rec["shape"]) == shape and tuple(rec["dim_names"]) == names
    (inst,) = rec["instances"]
    assert inst["op"] == _HLO_OPS[op] and tuple(inst["dims"]) == span
    assert inst["operand_bytes"] == int(np.prod(worker.OPERAND)) * 2
    assert inst["multiplier"] == 1.0
    assert inst["groups"] == _groups(shape, names, span)
    port = tcm.device_comm_graph(CollectiveRecord.from_json(rec), 16)
    assert port.num_edges > 0
    _same_graph(port, rcm.device_comm_graph(_hlo(rec, form), 16))


def test_group_off_the_mesh_dims_raises(traced):
    _, out = traced
    assert out["bad"] is not None and "[0, 1, 4]" in out["bad"], out["bad"]


# -------------------------------------------- item 7: cells in one process
def _dryrun(shapes, out_dir):
    _run([sys.executable, "-m", "repro_torch.launch.dryrun",
          "--arch", "granite-3-2b", "--shape", ",".join(shapes),
          "--mesh", "multi", "--overrides", json.dumps(worker.ONE_LAYER),
          "--out", str(out_dir), "--save-collectives"])
    rows = {}
    for s in shapes:
        stem = f"granite-3-2b__{s}__multi"
        rows[s] = (json.loads((out_dir / f"{stem}.json").read_text()),
                   load_collectives(out_dir / "collectives"
                                    / f"{stem}.collectives.json"))
    return rows


def test_cells_in_one_process_equal_each_alone(tmp_path):
    """train_4k traced first is the cell alone in a fresh process;
    decode_32k after it must equal decode_32k alone."""
    both = _dryrun(["train_4k", "decode_32k"], tmp_path / "both")
    alone = _dryrun(["decode_32k"], tmp_path / "alone")
    for shape in ("train_4k", "decode_32k"):
        row, record = both[shape]
        assert row["status"] == "ok", row
        for inst in record.instances:
            _, dims, groups, _, mult = inst
            size = int(np.prod([record.shape[record.dim_names.index(d)]
                                for d in dims]))
            assert len(groups) * size == 512 and mult > 0, inst[:2]
            assert all(len(g) == size for g in groups)
    row, record = both["decode_32k"]
    row1, record1 = alone["decode_32k"]
    for key in ("collectives_by_type", "ici_s", "dcn_s", "collective_calls"):
        assert row[key] == row1[key], key
    assert record == record1
    # the collectives DTensor reuses from the first cell's mesh include
    # all-gathers over "data": each over its 16 ranks
    assert any(i[0] == "all-gather" and i[1] == ("data",)
               and len(i[2][0]) == 16 for i in record.instances)


# ------------------------------------------------ placed mesh, save/load
def test_placed_mesh_record_equals_identity(traced):
    _, out = traced
    assert out["placed"]["record"] == out["identity"]["record"]
    assert (out["placed"]["collectives_by_type"]
            == out["identity"]["collectives_by_type"])
    assert out["identity"]["record"]["instances"]


def test_saved_record_round_trips(traced):
    out_dir, out = traced
    path = (out_dir / "collectives"
            / "granite-3-2b__decode_32k__multi.collectives.json")
    loaded = load_collectives(path)
    assert loaded == CollectiveRecord.from_json(out["identity"]["record"])
    want = np.load(out_dir / "graph.npz")
    got = tcm.device_comm_graph(loaded, 512)
    for attr in ("xadj", "adjncy", "adjwgt", "vwgt"):
        np.testing.assert_array_equal(getattr(got, attr), want[attr])


# ---------------------------------------------------- the whole chain
def test_placement_chain_equals_reference(traced):
    from repro.launch.mesh import fleet_monitor as ref_fleet
    from repro.launch.mesh import viem_device_order as ref_order
    from repro_torch.launch.mesh import fleet_monitor as port_fleet
    from repro_torch.launch.mesh import viem_device_order as port_order
    _, out = traced
    step = out["step"]
    assert len(step["instances"]) > 1
    record = CollectiveRecord.from_json(step)
    text = _hlo(step, "iota")
    _same_graph(tcm.device_comm_graph(record, 16),
                rcm.device_comm_graph(text, 16))
    ref, ref_res = ref_order(text, 16, machine_model=rc.Hierarchy
                             .from_strings(*HIERARCHY))
    port, port_res = port_order(record, 16, machine_model=tc.Hierarchy
                                .from_strings(*HIERARCHY), device="cpu")
    np.testing.assert_array_equal(port, ref)
    assert port_res.final_objective == ref_res.final_objective
    assert sorted(port.tolist()) == list(range(16))
    ref_mon, ref_inc = ref_fleet(text, 16, machine_model=rc.Hierarchy
                                 .from_strings(*HIERARCHY))
    port_mon, port_inc = port_fleet(record, 16, machine_model=tc.Hierarchy
                                    .from_strings(*HIERARCHY), device="cpu")
    np.testing.assert_array_equal(port_inc, ref_inc)
    ref_mon.observe_hlo(text)
    port_mon.observe_hlo(record)
    a, b = ref_mon.tick(), port_mon.tick()
    assert not a.remapped and not b.remapped
    assert a.drift.score == b.drift.score
    np.testing.assert_array_equal(port_mon.incumbent, ref_mon.incumbent)
