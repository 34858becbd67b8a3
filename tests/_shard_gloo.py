"""The ranks' side of the gloo tests (``tests/test_torch_shard_gloo.py``:
granite-3-2b and mixtral-8x7b, the cross-pod mean and the elastic
restore; ``tests/test_torch_shard_gloo_hybrid.py``: jamba-v0.1-52b;
``tests/test_torch_shard_gloo_rwkv.py``: rwkv6-3b): 4 ``gloo`` ranks
spawned on the CPU over a (2, 2) ("data", "model") mesh or a (2, 1, 2)
("pod", "data", "model") one.

For each config every rank:
  * runs two sharded ``build_train_step`` calls (microbatches 2, float32)
    on its smoke widths beside the unsharded port step on the same state
    and batches, and compares each parameter and each moment (relative
    Frobenius error, limit 1e-5, or where ``spread`` is given the larger
    of 1e-5 and that multiple of the unsharded step's own float32 error
    against a float64 run of it) and the MoE routes and drops of its own
    rows;
  * counts, under ``launch.dryrun.TraceCost``, its local matmul flops in
    the sharded step against the unsharded step's, and records the
    collectives under ``CommDebugMode``;
  * runs the sharded prefill against the unsharded one (logits, 1e-5),
    and four sharded greedy decode steps against the unsharded ones
    (tokens equal, caches within 1e-5: the Mamba and RWKV states' write
    back included);
  * records, in the train, prefill and decode steps, every all-gather
    that materialises a whole tensor of a parameter's global shape
    (:class:`WholeGathers`) and classes the parameter by its reference
    spec (:func:`leaf_classes`).

Each rank writes its findings to a JSON file; the tests assert on them.
"""

import dataclasses
import json
import math
import os
import weakref

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

MESHES = {"single": ((2, 2), ("data", "model")),
          "multi": ((2, 1, 2), ("pod", "data", "model"))}
B, T = 8, 64
TOL = 1e-5
GRAD_SHAPES = {"a": (6, 5), "b": {"c": (17,), "d": (3, 4, 2)}}

# The parameters that the port may gather whole at use although the
# reference keeps a dim of them over "model": none.
KNOWN = ()

# rwkv6-3b's and jamba-v0.1-52b's train steps are held per tensor to
# max(1e-5, KIND_SPREAD × the unsharded float32 step's own error against
# the same steps in float64; tests/_train_kinds.py's REF_RATIO), not to a
# flat 1e-5: a sharded step sums each batch shard's weight gradient
# across ranks where the unsharded step sums over the whole batch at
# once.  RWKV's ``u`` gets its gradient through the factored WKV chunk,
# which is ill-conditioned in float32 (the JAX package's own float32 step
# puts rwkv's moments up to 5.2e-5 from float64, the error
# tests/test_torch_train_rwkv.py holds the port to): u's second moment
# moved 3.5e-5 from the unsharded one on these ranks.  Jamba's Mamba
# sums d_inner in two partial sums all-reduced, and its first Adam steps
# on a zero-initialised ``conv_b`` put the unsharded float32 step 1.1e-5
# from float64.  A fault in a sharded gradient (a shard missing or
# doubled) moves a tensor by O(1).
KIND_SPREAD = 2.5


def cfg_of(arch):
    from repro_torch.configs import get_smoke_config
    return dataclasses.replace(get_smoke_config(arch), dtype="float32")


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def _rows(mesh, b):
    """This rank's rows of a batch of ``b`` sharded over the batch
    axes."""
    names = mesh.mesh_dim_names
    coord = mesh.get_coordinate()
    blk, n = 0, 1
    for a in ("pod", "data"):
        if a in names:
            i = names.index(a)
            blk = blk * mesh.size(i) + coord[i]
            n *= mesh.size(i)
    size = b // n
    return slice(blk * size, (blk + 1) * size)


def leaf_classes(cfg, mesh) -> dict:
    """{name: class} of the port's parameters by their reference spec on
    ``mesh``: "sharded" (a dim over a "model" dim of size > 1: never to be
    gathered whole) or "gathered" (no dim over "model": the reference too
    gathers it whole at use, as ZeRO-3 does)."""
    from repro_torch.models import sharding as shd
    from repro_torch.train.steps import param_placements
    model = shd.mesh_size(mesh, "model")
    out = {}
    for name, spec in param_placements(cfg, mesh).items():
        axes = [a for e in spec if e is not None
                for a in ((e,) if isinstance(e, str) else e)]
        out[name] = ("sharded" if "model" in axes and model > 1
                     else "gathered")
    return out


class WholeGathers(TorchDispatchMode):
    """Records every tensor that a DTensor redistribution all-gathers
    whole on this rank (an all-gather whose result has the redistributed
    tensor's global element count): the transient of a weight replicated
    at use.  DTensor's three call sites of ``redistribute_local_tensor``
    (explicit redistributions, the dispatcher's implicit ones and the
    gradients' placements) are wrapped to tell the mode which tensor is
    on the move: its global shape and, where it is a parameter or a
    redistribution of one (``track``), the parameter's name."""

    _SITES = ("torch.distributed.tensor._redistribute",
              "torch.distributed.tensor._dispatch",
              "torch.distributed.tensor._api")

    def __init__(self):
        super().__init__()
        self.moving = []
        self.found = set()        # (parameter name or None, global shape)
        self._origin = {}
        self._orig = {}

    def track(self, module):
        """Name the local tensors of ``module``'s DTensor parameters."""
        for n, p in module.named_parameters():
            if hasattr(p, "_local_tensor"):
                self._mark(p._local_tensor, n)

    def _mark(self, t, name):
        self._origin[id(t)] = (weakref.ref(t), name)

    def _name(self, t):
        ref, name = self._origin.get(id(t), (None, None))
        return name if ref is not None and ref() is t else None

    def __enter__(self):
        import importlib
        for site in self._SITES:
            mod = importlib.import_module(site)
            orig = mod.redistribute_local_tensor
            self._orig[site] = orig
            mod.redistribute_local_tensor = self._wrap(orig)
        return super().__enter__()

    def __exit__(self, *exc):
        import importlib
        for site, orig in self._orig.items():
            importlib.import_module(site).redistribute_local_tensor = orig
        return super().__exit__(*exc)

    def _wrap(self, orig):
        def wrapped(local, current, target, *args, **kwargs):
            name = self._name(local)
            self.moving.append((name, tuple(current.tensor_meta.shape)))
            try:
                out = orig(local, current, target, *args, **kwargs)
            finally:
                self.moving.pop()
            if name is not None:
                self._mark(out, name)
            return out
        return wrapped

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if (func.namespace == "_c10d_functional"
                and func.overloadpacket.__name__ == "all_gather_into_tensor"
                and self.moving
                and out.numel() == math.prod(self.moving[-1][1])):
            self.found.add(self.moving[-1])
        return out


def whole_gather_report(rec, classes, shapes) -> dict:
    """The parameters a :class:`WholeGathers` saw gathered whole, by
    class: by name where the gathered tensor came from a parameter, else
    (a gradient, say) by global shape; ``ambiguous``: an unnamed shape
    shared by a "sharded" parameter and one of another class (the test
    refuses them)."""
    by_shape = {}
    for name, cls in classes.items():
        by_shape.setdefault(shapes[name], []).append(name)
    seen, ambiguous = {}, []
    for name, shape in rec.found:
        names = [name] if name is not None else by_shape.get(shape, [])
        kinds = {classes[n] for n in names}
        if "sharded" in kinds and len(kinds) > 1:
            ambiguous.append([list(shape), sorted(names)])
        for n in names:
            seen.setdefault(classes[n], []).append(n)
    return {k: sorted(v) for k, v in seen.items()} | {"ambiguous": ambiguous}


def _param_shapes(params) -> dict:
    return {n: tuple(p.shape) for n, p in params.named_parameters()}


def _merge(a: dict, b: dict) -> dict:
    out = dict(a)
    for k, v in b.items():
        out[k] = sorted(set(out.get(k, [])) | set(map(str, v))) \
            if k != "ambiguous" else out.get(k, []) + v
    return out


def _truth_errors(cfg, toks, ref) -> dict:
    """Per key, the unsharded float32 state ``ref``'s relative error
    against the same two steps in float64 (``testing.float64_evaluation``
    on ``widen_train_state``): the float32 step's own rounding."""
    from repro_torch.testing import float64_evaluation, widen_train_state
    from repro_torch.train import steps
    truth = widen_train_state(steps.init_train_state(0, cfg, device="cpu"))
    fn, _, _ = steps.build_train_step(cfg, None, global_batch=B,
                                      microbatches=2)
    with float64_evaluation():
        for i in range(2):
            truth, _ = fn(truth, {"tokens": toks[i],
                                  "labels": torch.roll(toks[i], -1, 1)})
    return _errors(ref, truth)


def _errors(got, want) -> dict:
    """Relative Frobenius error per parameter and moment (``got`` may
    hold DTensors)."""
    def whole(t):
        t = t.detach()
        return t.full_tensor() if hasattr(t, "full_tensor") else t
    wp = dict(want["params"].named_parameters())
    out = {}
    for n, p in got["params"].named_parameters():
        out[f"p:{n}"] = _rel(whole(p), wp[n].detach())
        for part in ("m", "v"):
            out[f"{part}:{n}"] = _rel(whole(got[part][n]), want[part][n])
    return out


def _train(arch, mesh, out, spread=None):
    """``spread``: hold each key of the sharded state to max(1e-5,
    ``spread`` × the unsharded float32 state's own error against float64)
    from the unsharded one, in place of a flat 1e-5."""
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.launch.dryrun import TraceCost
    from repro_torch.testing import moe_routes
    from repro_torch.train import steps
    cfg = cfg_of(arch)
    classes = leaf_classes(cfg, mesh)
    g = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (2, B, T), generator=g)
    ref = steps.init_train_state(0, cfg, device="cpu")
    st = steps.init_train_state(0, cfg, device="cpu")
    shapes = _param_shapes(ref["params"])
    fn0, _, _ = steps.build_train_step(cfg, None, global_batch=B,
                                       microbatches=2)
    fn1, _, _ = steps.build_train_step(cfg, mesh, global_batch=B,
                                       microbatches=2)
    r0, r1 = TraceCost(), TraceCost(mesh)
    steps.place_train_state(st, cfg, mesh)
    route_err = []
    whole = {}
    for i in range(2):
        batch = {"tokens": toks[i], "labels": torch.roll(toks[i], -1, 1)}
        with moe_routes() as p0, r0:
            ref, m0 = fn0(ref, batch)
        comm, rec = CommDebugMode(), WholeGathers()
        rec.track(st["params"])
        with moe_routes() as p1, r1, comm, rec:
            st, m1 = fn1(st, batch)
        whole = _merge(whole, whole_gather_report(rec, classes, shapes))
        assert len(p0) == len(p1)
        for a, b_ in zip(p0, p1):
            # each microbatch's rows of this rank: (se, st, keep) equal
            rows = _rows(mesh, a[0].shape[0])
            for j in (0, 1, 4):
                route_err.append(int(not torch.equal(a[j][rows], b_[j])))
        counts = {str(k): v for k, v in comm.get_comm_counts().items()}
        out.setdefault("comm", []).append(counts)
        out.setdefault("loss", []).append((float(m0["loss"]),
                                           float(m1["loss"])))
    errs = _errors(st, ref)
    own = _truth_errors(cfg, toks, ref) if spread else {}
    limits = {k: max(TOL, spread * own[k]) if spread else TOL
              for k in errs}
    key = max(errs, key=lambda k: errs[k] / limits[k])
    out["worst"] = (key, errs[key], limits[key])
    out["route_mismatches"] = sum(route_err)
    out["routes_compared"] = len(route_err)
    out["flops_share"] = r1.dot_flops / max(r0.dot_flops, 1.0)
    out["whole_gathers"] = whole


def _prefill(arch, mesh, out):
    from repro_torch.models.transformer import init_params
    from repro_torch.train import steps
    cfg = cfg_of(arch)
    toks = torch.randint(0, cfg.vocab_size, (4, T),
                         generator=torch.Generator().manual_seed(5))
    f0, _, _ = steps.build_prefill_step(cfg, None)
    f1, _, _ = steps.build_prefill_step(cfg, mesh, global_batch=4)
    a = f0(init_params(0, cfg, device="cpu"), {"tokens": toks})
    p1 = steps.place_params(init_params(0, cfg, device="cpu"), cfg, mesh)
    rec = WholeGathers()
    rec.track(p1)
    with rec:
        b = f1(p1, {"tokens": toks})
    out["prefill_rel"] = _rel(b, a)
    out["whole_gathers"] = _merge(out.get("whole_gathers", {}),
                                  whole_gather_report(
                                      rec, leaf_classes(cfg, mesh),
                                      _param_shapes(p1)))


def _decode(arch, mesh, out):
    """Four sharded greedy decode steps (``build_serve_step`` with the
    mesh: caches at ``cache_specs``, written in place) against the
    unsharded ones after one prefill: tokens equal, caches within 1e-5."""
    from repro_torch.models.transformer import (init_params,
                                                prefill_with_cache)
    from repro_torch.train import steps
    cfg = cfg_of(arch)
    toks = torch.randint(0, cfg.vocab_size, (4, T),
                         generator=torch.Generator().manual_seed(6))
    p0 = init_params(0, cfg, device="cpu")
    p1 = init_params(0, cfg, device="cpu")
    shapes = _param_shapes(p1)
    _, c0 = prefill_with_cache(p0, toks, cfg, T + 8)
    _, c1 = prefill_with_cache(p1, toks, cfg, T + 8)
    s0, _, _, _ = steps.build_serve_step(cfg, None)
    s1, _, _, _ = steps.build_serve_step(cfg, mesh, 4, T + 8)
    t0 = t1 = toks[:, -1:]
    same = []
    steps.place_params(p1, cfg, mesh)
    rec = WholeGathers()
    rec.track(p1)
    for i in range(4):
        t0, c0 = s0(p0, t0, c0, T + i)
        with rec:
            t1, c1 = s1(p1, t1, c1, T + i)
        same.append(bool(torch.equal(t0, t1)))
    out["decode_tokens_equal"] = all(same)
    out["decode_cache_rel"] = max(
        _rel(l1[kind][name].full_tensor(), l0[kind][name])
        for l0, l1 in zip(c0, c1) for kind in l0 for name in l0[kind])
    out["whole_gathers"] = _merge(out.get("whole_gathers", {}),
                                  whole_gather_report(
                                      rec, leaf_classes(cfg, mesh), shapes))


def _cross_pod(mesh, tmp, out):
    from repro_torch.train.compression import cross_pod_mean
    data = np.load(os.path.join(tmp, "grads.npz"))
    pod = mesh.get_coordinate()[mesh.mesh_dim_names.index("pod")]

    def tree(prefix):
        return {"a": torch.from_numpy(data[f"{prefix}a"][pod]),
                "b": {"c": torch.from_numpy(data[f"{prefix}b.c"][pod]),
                      "d": torch.from_numpy(data[f"{prefix}b.d"][pod])}}
    mean, err = cross_pod_mean(tree("g."), tree("e."), mesh)
    if torch.distributed.get_rank() == 0:
        np.savez(os.path.join(tmp, "port_mean.npz"),
                 **{"a": mean["a"].numpy(), "b.c": mean["b"]["c"].numpy(),
                    "b.d": mean["b"]["d"].numpy(),
                    "err.a": err["a"].numpy()})
    out["cross_pod"] = True


def _restore(tmp, out):
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.checkpoint.checkpoint import (CheckpointManager,
                                                   tree_leaves)
    from repro_torch.convert import reference_tree
    from repro_torch.train import steps
    cfg = cfg_of("granite-3-2b")
    saved = np.load(os.path.join(tmp, "ckpt", "step_00000007",
                                 "shard_0.npz"))
    mgr = CheckpointManager(os.path.join(tmp, "ckpt"))
    ok = []
    for shape in ((2, 2), (4, 1)):
        mesh = DeviceMesh("cpu", torch.arange(4).reshape(shape),
                          mesh_dim_names=("data", "model"))
        target = reference_tree(steps.init_train_state(1, cfg,
                                                       device="cpu"))
        got = mgr.restore(7, target, mesh=mesh,
                          shardings=steps.train_state_specs(cfg, mesh))
        leaves = tree_leaves(got)
        same = all(
            np.array_equal(x.full_tensor().numpy(), saved[f"leaf_{i}"])
            for i, x in enumerate(leaves))
        sharded = sum(x.to_local().numel() < x.numel() for x in leaves)
        ok.append((list(shape), same, sharded, len(leaves)))
    out["restore"] = ok


def _settled(mesh, out):
    """``transformer._Settled``'s backward on this rank's gradient of a
    (4, 3) activation in the row layout, placed ``Partial`` over
    "model": it must come back in the row layout, each rank's part the
    sum of its model group's parts; one already in the row layout must
    pass unchanged."""
    import types

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Partial

    from repro_torch.models import sharding as shd
    from repro_torch.models.transformer import _Settled
    rank = dist.get_rank()
    rows = shd.rows_of(mesh, torch.empty((4, 3)))
    ctx = types.SimpleNamespace(mesh=mesh, pl=rows)
    part = torch.arange(6.0).reshape(2, 3) * (rank + 1)
    g = DTensor.from_local(part, mesh, shd.with_model(mesh, rows, Partial()))
    got = _Settled.backward(ctx, g)[0]
    group = dist.get_process_group_ranks(mesh.get_group("model"))
    want = torch.arange(6.0).reshape(2, 3) * sum(r + 1 for r in group)
    same = DTensor.from_local(part, mesh, rows)
    out["settled"] = {
        "placements": [str(p) for p in got.placements] == [
            str(p) for p in rows],
        "err": float((got.to_local() - want).abs().max()),
        "passed_as_is": _Settled.backward(ctx, same)[0] is same}


def worker(rank, world, mesh_name, tmp, archs, extras, spread):
    """One rank: each config of ``archs`` through train (``spread``:
    :func:`_train`'s), prefill and decode; then, with ``extras``, the
    cross-pod mean on the pod mesh or the elastic restore on the
    other."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world)
    torch.set_num_threads(1)
    shape, names = MESHES[mesh_name]
    mesh = DeviceMesh("cpu", torch.arange(world).reshape(shape),
                      mesh_dim_names=names)
    out = {}
    try:
        for arch in archs:
            out[arch] = {}
            _train(arch, mesh, out[arch], spread)
            _prefill(arch, mesh, out[arch])
            _decode(arch, mesh, out[arch])
        if extras:
            _settled(mesh, out)
        if extras and "pod" in names:
            _cross_pod(mesh, tmp, out)
        elif extras:
            _restore(tmp, out)
    finally:
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
        dist.destroy_process_group()


def spawn(tmp_path, mesh_name, archs, extras=False, spread=None) -> list:
    """The 4 ranks' findings (one dict a rank)."""
    import torch.multiprocessing as mp
    mp.spawn(worker, args=(4, mesh_name, str(tmp_path), archs, extras,
                           spread), nprocs=4, join=True)
    return [json.loads((tmp_path / f"rank{r}.json").read_text())
            for r in range(4)]


def check_arch(r, arch, o, moe: bool):
    """The numbers every config must meet on rank ``r``: parameters and
    moments within their limits (:func:`_train`), losses within 1e-5, routes equal (compared only on a MoE
    config), prefill and decode equal, and no parameter that the
    reference keeps over "model" gathered whole outside :data:`KNOWN`."""
    name, err, limit = o["worst"]
    assert err <= limit, (r, arch, name, err, limit)
    for l0, l1 in o["loss"]:
        assert abs(l0 - l1) <= TOL * abs(l0), (r, arch, o["loss"])
    assert (o["routes_compared"] > 0) == moe
    assert o["route_mismatches"] == 0, (r, arch)
    assert o["prefill_rel"] <= TOL, (r, arch, o["prefill_rel"])
    assert o["decode_tokens_equal"], (r, arch)
    assert o["decode_cache_rel"] <= TOL, (r, arch, o["decode_cache_rel"])
    whole = o["whole_gathers"]
    assert not whole["ambiguous"], (r, arch, whole["ambiguous"])
    assert not whole.get("sharded"), (r, arch, whole["sharded"])
    assert set(whole) - {"ambiguous"} <= set(KNOWN) | {"gathered"}, whole
    for counts in o["comm"]:
        kinds = " ".join(counts)
        assert "all_gather" in kinds and "reduce_scatter" in kinds, counts
