"""Run by ``tests/test_torch_traffic.py`` in a subprocess (the fake process
group never enters the test process): ``python tests/_traffic_worker.py
OUT``.  Traces collectives under ``repro_torch.launch.dryrun.TraceCost``
and writes what the tests compare to ``OUT/worker.json``:

  * ``cases``: one record per (collective, mesh dims) on the (2, 2, 4)
    ("pod", "data", "model") mesh over 16 fake ranks, each a single call
    on a meta tensor of ``OPERAND``;
  * ``bad``: the error a group that is no product of mesh dims raises;
  * ``step``: the record of a small sharded train step on that mesh
    (granite-3-2b's smoke config), traced once;
  * ``identity`` / ``placed``: the granite-3-2b decode_32k cell at one
    layer on the (2, 16, 16) mesh over 512 fake ranks, traced on the
    identity layout and on a seeded permutation of it; the identity
    cell's record is also saved (``--save-collectives``'s file) under
    ``OUT/collectives/``, and the graph ``device_comm_graph`` builds from
    it in memory goes to ``OUT/graph.npz``.

Torch only: imports nothing of jax or of the JAX package."""

import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch import dryrun as dr  # noqa: E402

MESH = ((2, 2, 4), ("pod", "data", "model"))
OPERAND = (16, 24)                   # bf16: 768 bytes
SPANS = (("pod",), ("data",), ("model",), ("pod", "data"))
OPS = ("all_gather_into_tensor", "reduce_scatter_tensor", "all_reduce",
       "all_to_all_single", "shard_dim_alltoall")
PLACED_SEED = 5
ONE_LAYER = {"n_layers": 1}


def _group(mesh, span) -> str:
    """The process group over ``span`` through rank 0: the mesh's own for
    one dim, a new group over the flattened dims otherwise."""
    import torch.distributed as dist
    names = mesh.mesh_dim_names
    if len(span) == 1:
        return mesh.get_group(names.index(span[0])).group_name
    here = [int(i) for i in np.argwhere(mesh.mesh.numpy() == 0)[0]]
    idx = tuple(slice(None) if n in span else here[i]
                for i, n in enumerate(names))
    return dist.new_group(sorted(mesh.mesh[idx].ravel().tolist())).group_name


def _call(op, x, g: int, name: str):
    c10d = torch.ops._c10d_functional
    if op == "all_gather_into_tensor":
        return c10d.all_gather_into_tensor(x, g, name)
    if op == "reduce_scatter_tensor":
        return c10d.reduce_scatter_tensor(x, "sum", g, name)
    if op == "all_reduce":
        return c10d.all_reduce(x, "sum", name)
    if op == "all_to_all_single":
        split = [x.shape[0] // g] * g
        return c10d.all_to_all_single(x, split, split, name)
    return torch.ops._dtensor.shard_dim_alltoall(x, 0, 1, name)


def small_mesh_records(out: dict) -> None:
    import dataclasses

    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.configs import get_smoke_config
    dr.init_fake_group(16)
    mesh = DeviceMesh("cuda", torch.arange(16).reshape(MESH[0]),
                      mesh_dim_names=MESH[1])
    out["cases"] = {}
    for op in OPS:
        for span in SPANS:
            name = _group(mesh, span)
            g = int(np.prod([mesh.size(MESH[1].index(d)) for d in span]))
            rec = dr.TraceCost(mesh)
            with rec:
                _call(op, torch.empty(OPERAND, dtype=torch.bfloat16,
                                      device="meta"), g, name)
            out["cases"][f"{op}:{'+'.join(span)}"] = dr.collective_record(
                rec.instances, mesh).to_json()
    bad = dist.new_group([0, 1, 4]).group_name
    try:
        with dr.TraceCost(mesh):
            _call("all_reduce", torch.empty(OPERAND, device="meta"), 3, bad)
        out["bad"] = None
    except ValueError as e:
        out["bad"] = str(e)
    cfg = dataclasses.replace(get_smoke_config("granite-3-2b"), n_layers=1)
    rec = dr.TraceCost(mesh)
    dr._trace(cfg, "decode_32k", mesh, rec, 8, 1)
    out["step"] = dr.collective_record(rec.instances, mesh).to_json()


def placed_records(out: dict, out_dir: Path) -> None:
    from repro_torch.core.comm_model import device_comm_graph
    dr.init_fake_group(512)
    perm = np.random.default_rng(PLACED_SEED).permutation(512)
    rows = {}
    for label, devices in (("identity", None), ("placed", perm)):
        row = dr.run_cell("granite-3-2b", "decode_32k", True, save=False,
                          overrides=ONE_LAYER, devices=devices,
                          out_dir=out_dir,
                          save_collectives=devices is None)
        assert row["status"] == "ok", row
        rows[label] = row
        out[label] = {"record": row["collective_record"].to_json(),
                      "collectives_by_type": row["collectives_by_type"]}
    g = device_comm_graph(rows["identity"]["collective_record"], 512)
    np.savez(out_dir / "graph.npz", xadj=g.xadj, adjncy=g.adjncy,
             adjwgt=g.adjwgt, vwgt=g.vwgt)


def main(out_dir: str) -> None:
    import logging
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    out_dir = Path(out_dir)
    out = {}
    small_mesh_records(out)
    placed_records(out, out_dir)
    (out_dir / "worker.json").write_text(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1])
