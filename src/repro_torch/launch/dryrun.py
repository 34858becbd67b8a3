"""Multi-pod dry-run: trace every (arch × shape × mesh) cell on shape-only
inputs over a fake process group — the port's counterpart of the JAX
package's ``launch/dryrun.py`` (lower + compile).

For each cell this proves the sharding plan is coherent at production
scale (the sharded step runs end to end on meta DTensors over 256 or 512
ranks) and extracts the memory and roofline terms from the trace: the
step is built with the sharded builders (``train.steps.build_*_step`` on
``launch.mesh.make_production_mesh``), its inputs are the stand-ins of
``launch.specs`` placed on the mesh, and one call runs under
``CommDebugMode`` and :class:`TraceCost`, a dispatch mode that sees each
rank-local op below DTensor.  Row fields, as the reference's:

  * ``arg_bytes`` / ``out_bytes``: the local shard bytes of the step's
    inputs and outputs at the builder's specs; ``alias_bytes`` the state
    (or caches) the step updates in place; ``temp_bytes`` the traced
    peak of the tensors the step makes beyond its arguments;
  * flops: each local matmul's count (``torch.utils.flop_counter``'s
    formulas; it has none for elementwise ops, which the reference's
    HLO count adds), K4's analytic count where the trace reaches K4
    (``kernels.flash_attention.META_OBSERVERS``); ``hbm_bytes``: each
    eager op's operand and result bytes (views move nothing; nothing is
    fused, so this is the eager port's traffic), as
    ``analysis.hlo._hbm_traffic`` prices an instruction;
  * collectives: each of the record's collectives (below), its
    operand bytes times its calls times ``analysis.hlo._ring_factor``
    for its group size.  A collective's
    process group is resolved by its ranks (:func:`mesh_span`): mapped
    through the inverse of the mesh's rank layout to logical
    coordinates, they give the mesh dims S the group spans, and the
    group must be the product of S through this rank's coordinates or
    the cell fails with the group's ranks — no group is priced by a
    default size, whichever mesh object's groups DTensor reuses.  A
    group whose S holds ``pod`` (a bare ``pod`` group, or one flattened
    over (``pod``, ``data``)) counts as DCN, all others as ICI;
  * the roofline row through ``analysis.roofline_from_cost``.  Its
    constants and the 16 GiB of ``fits_16g`` are the mapped TPU fleet's
    (v5e), not the card's.

The collective record (:class:`CollectiveRecord`) is the counterpart of
the reference's saved HLO: each distinct (collective, S, operand bytes)
with every parallel group over S in logical device ids (positions in
the mesh's row-major layout) and its calls a step, extrapolated to the
config's depth and microbatches as the row's numbers are.  It yields
what ``analysis.hlo.collective_instances`` yields from HLO, so
``core.comm_model.device_comm_graph``, ``launch.mesh.viem_device_order``
and ``fleet_monitor`` take it in place of HLO text.  It is in logical
ids, so a cell traced on a placed mesh (``run_cell(..., devices=order)``)
gives the same record.  ``--save-collectives`` writes it per ok cell to
``<out>/collectives/<arch>__<shape>__<mesh>.collectives.json``, and
:func:`load_collectives` reads it back.

The fake process group is set up before anything else, as the reference
sets ``XLA_FLAGS`` first.  Rows land in
``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json`` and a summary
line is printed per cell; the CLI exits non-zero if any cell failed.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-8b \\
        --shape train_4k --mesh single          # one cell
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh both]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-2b \\
        --shape train_4k --mesh multi --save-collectives   # and its record
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import time
import traceback
import weakref
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..analysis.hlo import CollectiveStat, HloCost, _ring_factor
from ..analysis.roofline import roofline_from_cost
from ..configs import ARCHS, SHAPES, get_config, supports_shape

__all__ = ["CollectiveRecord", "TraceCost", "init_fake_group",
           "load_collectives", "local_bytes", "main", "mesh_span",
           "run_cell"]

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / \
    "dryrun_torch"
FIT_BYTES = 16 * 1024 ** 3          # a v5e chip's HBM: the mapped fleet's

_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-broadcast",
    "shard_dim_alltoall": "all-to-all",       # DTensor's own op
}


def init_fake_group(world: int) -> None:
    """A ``"fake"`` process group of ``world`` ranks in this process (this
    process is rank 0; collectives move nothing), replacing one of
    another size."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def parallel_groups(shape, span) -> list:
    """Every group over the mesh dims ``span`` (indices into ``shape``)
    in logical device ids (positions in the mesh's row-major layout),
    each in ring order: row-major over ``span`` — what HLO's iota
    ``replica_groups=[n/g,g]<=[shape]T(perm)`` lists, ``perm`` the other
    dims, then ``span``."""
    span = list(span)
    rest = [i for i in range(len(shape)) if i not in span]
    g = int(np.prod([shape[i] for i in span], dtype=np.int64))
    ids = np.arange(int(np.prod(shape))).reshape(shape)
    return ids.transpose(rest + span).reshape(-1, g).tolist()


def mesh_span(mesh, group_name: str) -> tuple:
    """The names of the mesh dims process group ``group_name`` spans.
    The group is resolved to its ranks, the ranks to
    logical coordinates through the inverse of ``mesh.mesh``; the dims
    along which they vary are the span, and the group must be the
    product of the span through this rank's coordinates, or this
    raises with the group's ranks.  Any group over the same ranks
    resolves alike, whichever mesh object made it."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    ranks = dist.get_process_group_ranks(_resolve_process_group(group_name))
    if mesh is None:
        raise ValueError(f"a collective over ranks {ranks} in a call "
                         f"traced without a mesh")
    shape = tuple(mesh.mesh.shape)
    where = {int(r): i for i, r in enumerate(mesh.mesh.flatten().tolist())}
    me = dist.get_rank()
    if me not in where or any(r not in where for r in ranks):
        raise ValueError(f"a collective over ranks {ranks}: not all on "
                         f"the mesh {mesh.mesh_dim_names} {shape}")
    here = np.unravel_index(where[me], shape)
    coords = np.unravel_index([where[r] for r in ranks], shape)
    span = [i for i in range(len(shape))
            if (np.asarray(coords[i]) != here[i]).any()]
    through = np.arange(len(where)).reshape(shape)[tuple(
        slice(None) if i in span else here[i] for i in range(len(shape)))]
    if sorted(where[r] for r in ranks) != sorted(through.ravel().tolist()):
        raise ValueError(
            f"a collective over ranks {ranks} is no product of mesh dims "
            f"through rank {me} on the mesh {mesh.mesh_dim_names} "
            f"{shape}")
    return tuple(mesh.mesh_dim_names[i] for i in span)


@dataclasses.dataclass
class CollectiveRecord:
    """A traced step's collectives: the port's counterpart of the
    compiled step's HLO for the placement chain.  ``instances`` holds
    ``(op, dims, groups, operand_bytes, multiplier)``: ``dims`` the
    mesh dims the collective spans, ``groups`` every parallel group over
    them in logical device ids (:func:`parallel_groups`; one rank's
    trace stands for all, as SPMD runs the same collective in each),
    ``operand_bytes`` one rank's input, ``multiplier`` the calls a step.
    Iterating yields ``(op, groups, operand_bytes, multiplier)``, what
    ``analysis.hlo.collective_instances`` yields from HLO text, so
    ``core.comm_model.device_comm_graph`` and everything built on it
    (``launch.mesh.viem_device_order``, ``fleet_monitor``,
    ``RemapMonitor.observe_hlo``) take a record as they take HLO."""
    shape: tuple
    dim_names: tuple
    instances: list

    def __iter__(self):
        for op, _, groups, nbytes, mult in self.instances:
            yield op, groups, nbytes, mult

    def to_json(self) -> dict:
        return {"shape": list(self.shape), "dim_names": list(self.dim_names),
                "instances": [{"op": op, "dims": list(dims), "groups": groups,
                               "operand_bytes": nbytes, "multiplier": mult}
                              for op, dims, groups, nbytes, mult
                              in self.instances]}

    @classmethod
    def from_json(cls, d: dict) -> CollectiveRecord:
        return cls(tuple(d["shape"]), tuple(d["dim_names"]),
                   [(i["op"], tuple(i["dims"]), i["groups"],
                     int(i["operand_bytes"]), float(i["multiplier"]))
                    for i in d["instances"]])


def collective_record(counts: dict, mesh) -> CollectiveRecord:
    """The record of ``counts`` ((op, dims, operand bytes) → calls a
    step) on ``mesh``'s layout, sorted by key."""
    shape = tuple(mesh.mesh.shape)
    names = tuple(mesh.mesh_dim_names)
    out = []
    for (op, dims, nbytes), calls in sorted(counts.items()):
        if calls < 0:
            raise ValueError(f"{op} over {dims} of {nbytes} bytes: "
                             f"{calls} calls a step")
        if calls:
            groups = parallel_groups(shape, [names.index(d) for d in dims])
            out.append((op, tuple(dims), groups, int(nbytes), float(calls)))
    return CollectiveRecord(shape, names, out)


def load_collectives(path) -> CollectiveRecord:
    """A record written by ``--save-collectives``."""
    return CollectiveRecord.from_json(json.loads(Path(path).read_text()))


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class TraceCost(TorchDispatchMode):
    """Counts the rank-local ops of a traced call on ``mesh``: flops, HBM
    bytes, the calls of each collective by the mesh dims it spans and its
    operand bytes (the record's counts), and the peak of live bytes the
    call made.
    DTensor-level ops are passed to DTensor (``NotImplemented``), so the
    mode sees the local ops and collectives DTensor issues; the fake
    tensors of DTensor's sharding propagation are skipped."""

    def __init__(self, mesh=None):
        super().__init__()
        self.mesh = mesh                 # the DeviceMesh of the traced call
        self.flops = 0.0
        self.dot_flops = 0.0
        self.hbm_bytes = 0.0
        # (op, dims spanned, operand bytes) → calls: the record's counts
        self.instances: dict = defaultdict(int)
        self._spans: dict = {}
        self.live = 0
        self.peak = 0
        self._seen: dict = {}
        self._paused = 0
        self._orig = None

    _PROPAGATION = ("propagate", "propagate_op_sharding_non_cached")

    def __enter__(self):
        # DTensor's sharding propagation makes tensors of its own (once
        # per op signature): not the step's work
        from torch.distributed.tensor._sharding_prop import (
            ShardingPropagator)
        self._orig = {n: getattr(ShardingPropagator, n)
                      for n in self._PROPAGATION}
        for name, orig in self._orig.items():
            setattr(ShardingPropagator, name, self._pausing(orig))
        return super().__enter__()

    def _pausing(self, orig):
        def wrapped(*args, **kwargs):
            self._paused += 1
            try:
                return orig(*args, **kwargs)
            finally:
                self._paused -= 1
        return wrapped

    def __exit__(self, *exc):
        from torch.distributed.tensor._sharding_prop import (
            ShardingPropagator)
        for name, orig in self._orig.items():
            setattr(ShardingPropagator, name, orig)
        return super().__exit__(*exc)

    def _track(self, t):
        key = t.untyped_storage()._cdata
        if key in self._seen:
            self._seen[key][0] += 1
        else:
            self._seen[key] = [1, t.untyped_storage().nbytes()]
            self.live += self._seen[key][1]
            self.peak = max(self.peak, self.live)
        weakref.finalize(t, self._release, key)

    def _release(self, key):
        ent = self._seen.get(key)
        if ent is None:
            return
        ent[0] -= 1
        if ent[0] == 0:
            self.live -= ent[1]
            del self._seen[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self._paused:
            return out
        ins = list(_tensors(args)) + list(_tensors(kwargs))
        if any(isinstance(t, FakeTensor) for t in ins):
            return out
        name = func.overloadpacket.__name__
        if func.namespace in ("_c10d_functional", "_dtensor"):
            if name in _COLLECTIVES:
                self._collective(_COLLECTIVES[name], args)
            return out
        outs = list(_tensors(out))
        self._count_flops(func, args, kwargs, out)
        if not func.is_view:
            self.hbm_bytes += sum(_nbytes(t) for t in ins + outs)
        for t in outs:
            self._track(t)
        return out

    def _count_flops(self, func, args, kwargs, out):
        from torch.utils.flop_counter import flop_registry
        fn = flop_registry.get(func.overloadpacket)
        if fn is None:
            return
        n = float(fn(*args, **kwargs, out_val=out))
        self.flops += n
        self.dot_flops += n

    def _collective(self, op: str, args):
        self.instances[(op, self._span(args[-1]), _nbytes(args[0]))] += 1

    def _span(self, group_name: str) -> tuple:
        """The mesh dims a process group spans, from the group's ranks:
        they must be the product of those dims through this rank's
        coordinates (a group a cached DTensor spec carries from another
        mesh over the same ranks resolves as well)."""
        if group_name not in self._spans:
            self._spans[group_name] = mesh_span(self.mesh, group_name)
        return self._spans[group_name]

    def add_flash(self, q, k, v, window):
        from ..kernels.flash_attention import flash_flops
        b, t, h, hd = q.shape
        n = float(flash_flops(b, t, h, hd, window))
        self.flops += n
        self.dot_flops += n
        self.hbm_bytes += sum(_nbytes(x) for x in (q, k, v)) + _nbytes(q)


def local_bytes(mesh, shape, dtype, spec) -> int:
    """The bytes of one rank's shard of a tensor of ``shape`` at
    ``spec`` (the largest shard: ranks are equal when dims divide)."""
    from ..models import sharding as shd
    n = 1
    for d, size in enumerate(shape):
        e = spec[d] if d < len(spec) else None
        axes = () if e is None else ((e,) if isinstance(e, str) else e)
        parts = 1
        for a in axes:
            parts *= shd.mesh_size(mesh, a)
        n *= -(-int(size) // parts)
    return n * torch.empty((), dtype=dtype).element_size()


def _tree_bytes(mesh, tensors: dict, specs: dict) -> int:
    return sum(local_bytes(mesh, t.shape, t.dtype, specs[k])
               for k, t in tensors.items())


def _state_bytes(mesh, cfg, state) -> int:
    from ..train.steps import param_placements
    specs = param_placements(cfg, mesh)
    params = dict(state["params"].named_parameters())
    return (_tree_bytes(mesh, params, specs)
            + _tree_bytes(mesh, state["m"], specs)
            + _tree_bytes(mesh, state["v"], specs)
            + _nbytes(state["step"]))


def _cache_bytes(mesh, cfg, caches, batch: int) -> int:
    from ..train.steps import cache_placements
    specs = cache_placements(cfg, mesh, batch, seq_shard=batch == 1)
    return sum(local_bytes(mesh, t.shape, t.dtype, specs[i][kind][k])
               for i, layer in enumerate(caches)
               for kind, c in layer.items() for k, t in c.items())


def _numbers(rec: TraceCost) -> dict:
    """A trace's additive quantities: flops, HBM bytes, the peak, and the
    calls per (collective, dims, operand bytes)."""
    out = {"flops": rec.flops, "dot_flops": rec.dot_flops,
           "hbm_bytes": rec.hbm_bytes, "peak": float(rec.peak)}
    for key, calls in rec.instances.items():
        out[("calls", *key)] = float(calls)
    return out


def _extrapolate(at: dict, periods: int) -> dict:
    """The quantities at ``periods`` from traces at 1 and 2 periods
    (linear: a constant part and a part per period; exact for flops,
    bytes and collectives, and the peak's growth with depth)."""
    if 2 not in at:
        return dict(at[1])
    keys = set(at[1]) | set(at[2])
    return {k: at[1].get(k, 0.0) + (at[2].get(k, 0.0) - at[1].get(k, 0.0))
            * (periods - 1) for k in keys}


def _microbatched(step: dict, opt: dict, microbatches: int) -> dict:
    """A step's quantities with ``microbatches`` microbatches, from a
    one-microbatch step and its optimizer update alone: the forward and
    backward ``microbatches`` times, the update once (the peak is one
    microbatch's: they run one after another)."""
    keys = set(step) | set(opt)
    out = {k: microbatches * (step.get(k, 0.0) - opt.get(k, 0.0))
           + opt.get(k, 0.0) for k in keys}
    out["peak"] = step["peak"]
    return out


def _cost(nums: dict, record: CollectiveRecord,
          trip_counts: dict) -> HloCost:
    """The row's cost: ``nums``' flops and bytes, and each of the
    record's collectives priced as its operand bytes times its calls
    times ``_ring_factor`` for its group size, DCN where it spans
    ``pod``, ICI otherwise."""
    colls = []
    for op, dims, groups, nbytes, calls in record.instances:
        raw = float(nbytes) * calls
        wire = raw * _ring_factor(op, len(groups[0]))
        cross = "pod" in dims
        colls.append(CollectiveStat(
            op=op, wire_bytes=wire, raw_bytes=raw, count=calls,
            group_size=len(groups[0]), cross_pod=cross,
            ici_wire=0.0 if cross else wire, dcn_wire=wire if cross else 0.0))
    return HloCost(flops=nums["flops"], dot_flops=nums["dot_flops"],
                   hbm_bytes=nums["hbm_bytes"], collectives=colls,
                   trip_counts=dict(trip_counts))


def _io_bytes(cfg, shape_name: str, mesh):
    """(kind, arg, out, alias bytes) of the full-depth cell, from its
    stand-ins and the builder's specs (no trace)."""
    from ..models import sharding as shd
    from ..train import steps
    from . import specs as sp
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        state, batch = sp.train_input_specs(cfg, shape_name)
        bspec = shd.train_batch_specs(mesh, cfg.frontend_tokens > 0)
        arg_state = _state_bytes(mesh, cfg, state)
        arg = arg_state + sum(local_bytes(mesh, t.shape, t.dtype, bspec[k])
                              for k, t in batch.items())
        # the metrics: ce, aux, loss, grad_norm, lr float32, tokens int32
        return "train_step", arg, arg_state + 24, arg_state
    if shape.kind == "prefill":
        params, batch = sp.prefill_input_specs(cfg, shape_name)
        bspec = shd.train_batch_specs(mesh, cfg.frontend_tokens > 0)
        specs = steps.param_placements(cfg, mesh)
        arg = (_tree_bytes(mesh, dict(params.named_parameters()), specs)
               + sum(local_bytes(mesh, t.shape, t.dtype, bspec[k])
                     for k, t in batch.items()))
        out_spec = (shd._entry(shd.batch_axes(mesh)), None, None)
        out = local_bytes(mesh, (shape.global_batch, 1, cfg.padded_vocab),
                          cfg.torch_dtype, out_spec)
        return "prefill_step", arg, out, 0
    b, s = shape.global_batch, shape.seq_len
    _, _, _, tok_spec = steps.build_serve_step(cfg, mesh, b, s)
    params, token, caches, _ = sp.serve_input_specs(cfg, shape_name)
    cache_b = _cache_bytes(mesh, cfg, caches, b)
    tok_b = local_bytes(mesh, token.shape, token.dtype, tok_spec)
    arg = (_tree_bytes(mesh, dict(params.named_parameters()),
                       steps.param_placements(cfg, mesh))
           + cache_b + tok_b + 4)          # + the int32 step
    return "serve_step", arg, tok_b + cache_b, cache_b


def _trace(cfg, shape_name: str, mesh, rec: TraceCost, gb: int,
           microbatches: int, opt_only: bool = False) -> None:
    """One call of the cell's step on stand-ins of global batch ``gb``
    (train: in ``microbatches``; ``opt_only``: the AdamW update alone, on
    zero gradients), its inputs placed first, under ``rec``."""
    from ..train import steps
    from ..train.optimizer import OptConfig, adamw_update
    from . import specs as sp
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        gsd = torch.bfloat16 if os.environ.get("DRYRUN_GRAD_BF16") else None
        fn, _, _ = steps.build_train_step(
            cfg, mesh, donate=True, global_batch=gb,
            microbatches=microbatches, grad_sync_dtype=gsd)
        state, batch = sp.train_input_specs(cfg, shape_name, batch=gb)
        steps.place_train_state(state, cfg, mesh)
        if opt_only:
            from torch.distributed.tensor.experimental import (
                implicit_replication)
            grads = {k: torch.zeros_like(p, dtype=torch.float32)
                     for k, p in state["params"].named_parameters()}
            with rec, implicit_replication():
                adamw_update(state["params"], grads, state, OptConfig())
            return
        with rec:
            fn(state, batch)
    elif shape.kind == "prefill":
        fn, _, _ = steps.build_prefill_step(cfg, mesh, global_batch=gb)
        params, batch = sp.prefill_input_specs(cfg, shape_name)
        steps.place_params(params, cfg, mesh)
        with rec:
            fn(params, batch)
    else:
        b, s = shape.global_batch, shape.seq_len
        fn, *_ = steps.build_serve_step(cfg, mesh, b, s, donate=True)
        params, token, caches, step = sp.serve_input_specs(cfg, shape_name)
        steps.place_params(params, cfg, mesh)
        caches = steps.place_caches(caches, cfg, mesh, b, seq_shard=b == 1)
        with rec:
            fn(params, token, caches, step)


def _run(cfg, shape_name: str, mesh):
    """The cell's (kind, arg, out, alias bytes, cost, temp bytes,
    collective record): the step traced at one and two periods of layers
    (training: with one microbatch of the default count's size, and its
    AdamW update alone), extrapolated to the config's depth and
    microbatch count — the port's counterpart of the reference's scan
    bodies priced times their trip counts (the record's multipliers
    likewise)."""
    from ..kernels import flash_attention as fa
    from ..train import steps
    shape = SHAPES[shape_name]
    kind, arg, out, alias = _io_bytes(cfg, shape_name, mesh)
    n_periods = cfg.n_periods
    mb = (steps.default_microbatches(cfg, mesh, shape.global_batch)
          if shape.kind == "train" else 1)
    per_mb = shape.global_batch // mb

    def traced(sub, opt_only=False):
        rec = TraceCost(mesh)
        fa.META_OBSERVERS.append(rec.add_flash)
        try:
            _trace(sub, shape_name, mesh, rec, per_mb, 1, opt_only)
        finally:
            fa.META_OBSERVERS.remove(rec.add_flash)
        return _numbers(rec)

    at = {}
    for p in ((1, 2) if n_periods > 1 else (1,)):
        sub = dataclasses.replace(cfg, n_layers=cfg.period * p)
        at[p] = traced(sub)
        if mb > 1:
            at[p] = _microbatched(at[p], traced(sub, opt_only=True), mb)
    trips = {"periods": n_periods, "microbatches": mb}
    nums = _extrapolate(at, n_periods)
    record = collective_record({k[1:]: v for k, v in nums.items()
                                if isinstance(k, tuple) and k[0] == "calls"},
                               mesh)
    return (kind, arg, out, alias, _cost(nums, record, trips),
            int(nums["peak"]), record)


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             save: bool = True, overrides: dict | None = None,
             tag: str = "", out_dir: Path | None = None, devices=None,
             save_collectives: bool = False) -> dict:
    """One cell's row.  ``devices``: the mesh's rank layout, as
    ``make_production_mesh`` takes it (default: in order).  An ``ok``
    row carries the step's :class:`CollectiveRecord` under
    ``collective_record`` (left out of the saved row;
    ``save_collectives`` writes it to
    ``<out>/collectives/<arch>__<shape>__<mesh>.collectives.json``)."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor.debug import CommDebugMode

    from .mesh import make_production_mesh
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    mesh_name = ("multi" if multi_pod else "single") + (
        f"+{tag}" if tag else "")
    ok, why = supports_shape(cfg, shape_name)
    row = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    if not ok:
        row["status"] = "skipped"
        row["reason"] = why
        _save(row, save, out_dir)
        return row
    shape = SHAPES[shape_name]
    n_chips = 512 if multi_pod else 256
    init_fake_group(n_chips)
    t0 = time.time()
    try:
        # the fleet's mesh is a CUDA one (on a CPU mesh DTensor gathers
        # where a fleet runs an all-to-all); over the fake group on meta
        # tensors it needs no card
        mesh = make_production_mesh(multi_pod=multi_pod, devices=devices,
                                    device="cpu")
        mesh = DeviceMesh("cuda", mesh.mesh,
                          mesh_dim_names=mesh.mesh_dim_names)
        comm = CommDebugMode()
        with comm:
            kind, arg, out, alias, cost, temp, record = _run(
                cfg, shape_name, mesh)
        t_trace = time.time() - t0
    except Exception as e:  # sharding bug — fail loudly with context
        row["status"] = "FAILED"
        row["error"] = f"{type(e).__name__}: {e}"
        row["traceback"] = traceback.format_exc()[-2000:]
        _save(row, save, out_dir)
        return row

    # analytic model flops (per device): tokens/step × flops/token / chips
    if shape.kind == "train":
        mf = shape.global_batch * shape.seq_len * \
            cfg.model_flops_per_token("train")
    elif shape.kind == "prefill":
        mf = shape.global_batch * shape.seq_len * \
            cfg.model_flops_per_token("infer")
    else:
        mf = shape.global_batch * cfg.model_flops_per_token("infer")
    rl = roofline_from_cost(cost, model_flops_per_device=mf / n_chips)
    per_dev = arg + temp + out - alias
    row.update({
        "status": "ok", "kind": kind,
        "trace_s": round(t_trace, 1),
        "arg_bytes": arg, "temp_bytes": temp, "out_bytes": out,
        "alias_bytes": alias, "per_device_bytes": per_dev,
        "fits_16g": bool(per_dev < FIT_BYTES),
        "collectives_by_type": cost.by_type(),
        "collective_calls": {str(k): v for k, v in
                             comm.get_comm_counts().items()},
        "trip_counts": cost.trip_counts,
        **{k: (round(v, 6) if isinstance(v, float) else v)
           for k, v in rl.row().items()},
    })
    _save(row, save, out_dir)
    if save_collectives:
        d = Path(out_dir or OUT_DIR) / "collectives"
        d.mkdir(parents=True, exist_ok=True)
        (d / f"{arch}__{shape_name}__{mesh_name}.collectives.json"
         ).write_text(json.dumps(record.to_json()))
    row["collective_record"] = record
    return row


def _save(row: dict, save: bool, out_dir: Path | None = None) -> None:
    if save:
        d = Path(out_dir or OUT_DIR)
        d.mkdir(parents=True, exist_ok=True)
        (d / f"{row['arch']}__{row['shape']}__{row['mesh']}.json"
         ).write_text(json.dumps(row, indent=1, default=str))


def fmt_row(r: dict) -> str:
    if r["status"] == "skipped":
        return (f"{r['arch']:18s} {r['shape']:12s} {r['mesh']:6s} SKIP "
                f"({r['reason'][:60]})")
    if r["status"] != "ok":
        return (f"{r['arch']:18s} {r['shape']:12s} {r['mesh']:6s} FAIL "
                f"{r['error'][:90]}")
    return (f"{r['arch']:18s} {r['shape']:12s} {r['mesh']:6s} ok "
            f"mem={r['per_device_bytes']/2**30:5.1f}G "
            f"c={r['compute_s']*1e3:8.2f}ms m={r['memory_s']*1e3:8.2f}ms "
            f"i={r['ici_s']*1e3:7.2f}ms d={r['dcn_s']*1e3:7.2f}ms "
            f"{r['bound'][:4]:4s} rf={r['roofline_fraction']:.2f} "
            f"(trace {r['trace_s']}s)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--pad-heads", type=int, default=0,
                    help="pad attention heads to this multiple")
    ap.add_argument("--flash", action="store_true",
                    help="cfg.use_flash_kernel (the port's prefill is K4 "
                         "either way)")
    ap.add_argument("--remat", default=None)
    ap.add_argument("--microbatches", type=int, default=0)
    ap.add_argument("--capacity", type=float, default=0.0)
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=None,
                    help=f"directory of the rows (default {OUT_DIR})")
    ap.add_argument("--save-collectives", action="store_true",
                    help="write each ok cell's collective record to "
                         "<out>/collectives/ (load_collectives reads it)")
    ap.add_argument("--overrides", default="",
                    help="JSON of further config fields, e.g. "
                         "'{\"n_layers\": 8}'")
    args = ap.parse_args(argv)
    # DTensor warns at each multi-step redistribution; the rows say more
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    overrides = json.loads(args.overrides) if args.overrides else {}
    if args.pad_heads:
        overrides["pad_heads_to"] = args.pad_heads
    if args.flash:
        overrides["use_flash_kernel"] = True
    if args.remat:
        overrides["remat"] = args.remat
    if args.microbatches:
        overrides["train_microbatches"] = args.microbatches
    if args.capacity:
        overrides["capacity_factor"] = args.capacity

    archs = ARCHS if args.all or not args.arch else args.arch.split(",")
    shapes = (list(SHAPES) if args.all or not args.shape
              else args.shape.split(","))
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    init_fake_group(512 if meshes[0] else 256)

    failures = 0
    for mp in meshes:
        for arch in archs:
            for shape in shapes:
                r = run_cell(arch, shape, mp, overrides=overrides or None,
                             tag=args.tag, out_dir=args.out,
                             save_collectives=args.save_collectives)
                print(fmt_row(r), flush=True)
                if r["status"] == "FAILED":
                    print(r["traceback"], flush=True)
                failures += r["status"] == "FAILED"
    if failures:
        raise SystemExit(f"{failures} dry-run cells FAILED")


if __name__ == "__main__":
    main()
