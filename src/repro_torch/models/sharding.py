"""Sharding plans: parameter / cache / batch specs and their DTensor
placements — the JAX package's ``models/sharding.py`` on a torch
``DeviceMesh``.

Axes: ``model`` = tensor parallel, ``data`` = FSDP (params) + batch,
``pod`` = pure DP across DCN.  Rules are divisibility-aware: dims that
don't divide the axis (e.g. 8 KV heads on a 16-way model axis, RWKV's 40
heads) fall back to replication on that axis — Megatron-style KV
replication — rather than relying on padded sharding.

A *spec* is a tuple with one entry per tensor dim, each ``None``, a mesh
dim name or a tuple of names, as a ``PartitionSpec`` holds them (a
one-name tuple is written as the name).  The spec functions read only
the mesh's dim names and sizes, so they take a ``DeviceMesh`` or a
:class:`MeshShape` (the counterpart of JAX's ``AbstractMesh``).
:func:`named` turns a spec tree into DTensor placements, one per mesh
dim: a dim sharded over (``data``, ``model``) is ``Shard(d)`` on both
mesh dims, so rank (i, j) holds block i·|model| + j, the reference's
major-to-minor order.

The mesh travels explicitly, as an argument of the step builders and
of the sharded attention (PyTorch's idiom): the JAX package's
``set_flash_mesh``/``FLASH_MESH`` global has no counterpart here.  The
constrainers return functions that redistribute a DTensor to the
reference's target placements (``jax.lax.with_sharding_constraint``);
each carries its target as ``.spec`` (a function of the tensor's shape
for ``ep_c``), which the tests hold against the reference's.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["BlockPlan", "MeshShape", "activation_constrainer", "batch_axes",
           "block_plan", "cache_specs", "gathered", "is_dtensor",
           "layer_specs", "local_blocks", "local_rows", "mesh_size",
           "model_blocks", "moe_constrainers", "n_batch", "named",
           "param_specs", "placements", "rows_of", "shard_input",
           "train_batch_specs", "weight_grad", "with_model"]


@dataclass(frozen=True)
class MeshShape:
    """A mesh's dim names and sizes without devices or a process group
    (JAX's ``AbstractMesh``): what the spec functions read."""
    shape: tuple
    mesh_dim_names: tuple

    @property
    def ndim(self) -> int:
        return len(self.shape)


def _names(mesh) -> tuple:
    return tuple(mesh.mesh_dim_names)


def mesh_size(mesh, axis: str) -> int:
    """The size of the mesh dim named ``axis``."""
    return tuple(mesh.shape)[_names(mesh).index(axis)]


def batch_axes(mesh) -> tuple:
    return ("pod", "data") if "pod" in _names(mesh) else ("data",)


def n_batch(mesh) -> int:
    """The number of batch shards: the product of the batch axes."""
    n = 1
    for a in batch_axes(mesh):
        n *= mesh_size(mesh, a)
    return n


def _entry(axes):
    """A spec entry for the mesh dims ``axes``: None, a name, or a tuple
    of names (PartitionSpec's normal form)."""
    if axes is None:
        return None
    if isinstance(axes, str):
        return axes
    axes = tuple(axes)
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


def _div(n: int, mesh, axis: str) -> bool:
    return n % mesh_size(mesh, axis) == 0


def param_specs(cfg, mesh):
    """The reference's spec tree (``{"embeddings": {...}, "periods":
    [...]}``, each period position's specs with the stacked period axis
    in front), so that it compares with the JAX package's by equality.
    :func:`layer_specs` gives one layer's specs without that axis, as the
    port's per-layer tensors take them.

    Layout rule (the reference's dry-run finding): the FSDP (``data``)
    shard goes on a non-contracting dim of every forward matmul, so the
    only strategy is to all-gather the (small) weight shards at use —
    ZeRO-3.  TP (``model``) stays on the conventional Megatron dims
    (heads / d_ff / d_inner)."""
    periods = [_with_lead(layer_specs(cfg, mesh, kind), lead=1)
               for kind in cfg.period_kinds()]
    return {
        "embeddings": {
            # vocab over `data` (FSDP) with d_model replicated
            "embed": ("data" if _div(cfg.padded_vocab, mesh, "data")
                      else None, None),
            # lm_head contracts d_model: vocab over both axes
            "lm_head": (_dm(cfg, mesh, cfg.padded_vocab), None),
            "final_norm": (None,),
        },
        "periods": periods,
    }


def _with_lead(tree, lead: int = 0):
    """``tree`` with ``lead`` replicated dims put in front of each spec."""
    if isinstance(tree, dict):
        return {k: _with_lead(v, lead) for k, v in tree.items()}
    return (None,) * lead + tuple(tree)


def _dm(cfg, mesh, n: int):
    """(data, model) two-axis storage sharding for an output dim."""
    if n % (mesh_size(mesh, "data") * mesh_size(mesh, "model")) == 0:
        return ("data", "model")
    return "model" if _div(n, mesh, "model") else None


def layer_specs(cfg, mesh, kind) -> dict:
    """One layer's specs of kind (mixer, ffn), without the period axis:
    {norm1, norm2, mixer: {...}, ffn: {...}}."""
    da = "data" if _div(cfg.d_model, mesh, "data") else None
    hda = "data" if _div(cfg.head_dim_, mesh, "data") else None
    mixer, ffn = kind
    spec = {"norm1": (None,), "norm2": (None,)}
    if mixer == "attn":
        kv_ok = _div(cfg.n_kv_heads, mesh, "model")
        h_ok = _div(cfg.n_heads_eff, mesh, "model")
        spec["mixer"] = {
            "wq": (None, "model" if h_ok else None, hda),
            "wk": (None, "model" if kv_ok else None, hda),
            "wv": (None, "model" if kv_ok else None, hda),
            "wo": ("model" if h_ok else None, None, da),
        }
    elif mixer == "mamba":
        ma = "model" if _div(cfg.d_inner, mesh, "model") else None
        spec["mixer"] = {
            "w_in": (None, _dm(cfg, mesh, 2 * cfg.d_inner)),
            "conv_w": (None, ma), "conv_b": (ma,),
            "w_x": (ma, "data" if _div(cfg.dt_rank_ + 2 * cfg.mamba_d_state,
                                       mesh, "data") else None),
            "w_dt": (None, _dm(cfg, mesh, cfg.d_inner)), "b_dt": (ma,),
            "a_log": (ma, None), "d_skip": (ma,),
            "w_out": (ma, da),
        }
    elif mixer == "rwkv":
        # heads rarely divide the model axis → FSDP-only projections
        spec["mixer"] = {
            "mu_r": (None,), "mu_k": (None,), "mu_v": (None,),
            "mu_g": (None,), "mu_w": (None,),
            "wr": (None, da), "wk": (None, da), "wv": (None, da),
            "wg": (None, da), "wo": (None, da),
            "w0": (None,), "w_lora_a": (None, None),
            "w_lora_b": (None, da),
            "u": (None, None), "ln_g": (None,), "ln_b": (None,),
        }
    fa_use = "model" if _div(cfg.d_ff, mesh, "model") else None
    if ffn == "mlp":
        s = {"w1": (None, _dm(cfg, mesh, cfg.d_ff)), "w2": (fa_use, da)}
        if cfg.mlp_type == "swiglu":
            s["w3"] = (None, _dm(cfg, mesh, cfg.d_ff))
        spec["ffn"] = s
    elif ffn == "moe":
        # virtual-expert EP: weights (E_v, D, F/s) live E_v@data
        ev = cfg.moe_experts * cfg.moe_ep_split
        fs = cfg.d_ff // cfg.moe_ep_split
        ea = "data" if _div(ev, mesh, "data") else None
        fa = "model" if fs % mesh_size(mesh, "model") == 0 else None
        spec["ffn"] = {"router": (None, None), "w1": (ea, None, fa),
                       "w2": (ea, fa, None), "w3": (ea, None, fa)}
    elif ffn == "channelmix":
        spec["ffn"] = {"mu_k": (None,), "mu_r": (None,),
                       "wk": (None, _dm(cfg, mesh, cfg.d_ff)),
                       "wv": (fa_use, da), "wr": (None, da)}
    return spec


def cache_specs(cfg, mesh, batch: int, seq_shard: bool = False):
    """Decode-cache specs (a list over period positions, period axis in
    front, as the reference's).

    KV heads rarely divide the model axis, so the cache's *sequence* dim
    is sharded over ``model`` instead (flash-decode).  With
    ``seq_shard=True`` (long-context B=1 — batch can't shard) the
    sequence is sharded over both (``data``, ``model``)."""
    ba = batch_axes(mesh)
    b_ok = batch % n_batch(mesh) == 0 and not seq_shard
    bsp = _entry(ba) if b_ok else None
    kva = "model" if _div(cfg.n_kv_heads, mesh, "model") else None
    seq = None
    if seq_shard:
        seq = ("data", "model") if kva is None else "data"
    elif kva is None:
        seq = "model"           # heads can't shard → shard the sequence
    ma = "model" if _div(cfg.d_inner, mesh, "model") else None

    caches = []
    for mixer, ffn in cfg.period_kinds():
        c = {}
        if mixer == "attn":
            c["attn"] = {"k": (None, bsp, seq, kva, None),
                         "v": (None, bsp, seq, kva, None)}
        elif mixer == "mamba":
            c["mamba"] = {"conv": (None, bsp, None, ma),
                          "ssm": (None, bsp, ma, None)}
        elif mixer == "rwkv":
            c["rwkv"] = {"x": (None, bsp, None),
                         "s": (None, bsp, None, None, None)}
        if ffn == "channelmix":
            c["cmix"] = {"x": (None, bsp, None)}
        caches.append(c)
    return caches


def train_batch_specs(mesh, has_frontend: bool = False):
    ba = _entry(batch_axes(mesh))
    spec = {"tokens": (ba, None), "labels": (ba, None)}
    if has_frontend:
        spec["frontend"] = (ba, None, None)
    return spec


def placements(mesh, spec) -> tuple:
    """DTensor placements (one per mesh dim) of one spec.  A tensor dim
    sharded over several mesh dims is ``Shard`` on each of them; they
    must come in mesh order (DTensor shards left to right, JAX major to
    minor), else the layout would need a ``_StridedShard``.  A mesh dim
    of size 1 is ``Replicate`` (the same layout; DTensor refuses some
    views of a dim sharded over one rank)."""
    from torch.distributed.tensor import Replicate, Shard
    names = _names(mesh)
    out = [Replicate() for _ in names]
    for d, e in enumerate(spec):
        if e is None:
            continue
        axes = (e,) if isinstance(e, str) else tuple(e)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: dim {d} shards over {axes}, "
                             f"out of the mesh's order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec}: mesh dim {names[i]} "
                                 f"shards two tensor dims")
            if tuple(mesh.shape)[i] > 1:
                out[i] = Shard(d)
    return tuple(out)


def named(mesh, spec_tree):
    """A spec tree's placements, leaf by leaf (dicts and lists kept)."""
    if isinstance(spec_tree, dict):
        return {k: named(mesh, v) for k, v in spec_tree.items()}
    if isinstance(spec_tree, list):
        return [named(mesh, v) for v in spec_tree]
    return placements(mesh, spec_tree)


def _constrainer(mesh, spec_of):
    """A function redistributing a DTensor to the placements of
    ``spec_of(shape)``; ``.spec`` is ``spec_of``."""
    def constrain(z):
        return z.redistribute(mesh, placements(mesh, spec_of(z.shape)))
    constrain.spec = spec_of
    return constrain


def moe_constrainers(cfg, mesh, batch: int):
    """(ep_constrain, batch_constrain) for (B, E_v, cap, D) MoE buffers,
    or None (no MoE, or E_v does not divide the data axis).

    ep_constrain reshards to E_v@data (the EP all-to-all: tokens travel
    to the experts); the last dim is pinned to ``model`` when it is the
    expert hidden F/s.  batch_constrain brings the result back to
    B@batch-axes; when the batch does not divide them it is ep_c itself.
    With a ``pod`` axis, B stays pod-sharded throughout."""
    if not cfg.moe_experts:
        return None
    ev = cfg.moe_experts * cfg.moe_ep_split
    if ev % mesh_size(mesh, "data") != 0:
        return None
    ba = batch_axes(mesh)
    pod = ("pod" if "pod" in _names(mesh)
           and batch % mesh_size(mesh, "pod") == 0 else None)
    fs = cfg.d_ff // cfg.moe_ep_split
    fa = "model" if fs % mesh_size(mesh, "model") == 0 else None

    def ep_spec(shape):
        return (pod, "data", None, fa if shape[-1] == fs else None)

    ep_c = _constrainer(mesh, ep_spec)
    if batch % n_batch(mesh) == 0:
        bt_c = _constrainer(mesh, lambda shape: (_entry(ba), None, None,
                                                 None))
    else:
        bt_c = ep_c          # keep EP layout; combine handles it
    return ep_c, bt_c


def activation_constrainer(mesh, batch: int):
    """Pin (B, T, D) / (B, T) activations to batch-over-(pod, data).
    Batch sizes that don't divide the batch axes (long-context B=1)
    return the identity (with ``.spec`` None)."""
    if batch % n_batch(mesh) != 0:
        def ident(x):
            return x
        ident.spec = None
        return ident
    ba = _entry(batch_axes(mesh))
    return _constrainer(mesh, lambda shape: (ba,) + (None,) * (len(shape)
                                                                - 1))


# ------------------------------------------------------ DTensor helpers
def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


class BlockPlan(NamedTuple):
    """How one ``model`` rank assembles its rows of a dim stored over
    (``data``, ``model``) (:func:`block_plan`).  Row orders are lists of
    runs ``(start, stop)`` taken from a buffer in turn (:func:`_take`).

    Forward: the rank's stored block all-gathered over ``data`` (its
    ``data`` ranks' blocks in rank order), ``send`` taken from it,
    exchanged over ``model`` (``send_counts`` rows to each model rank,
    ``recv_counts`` from each), ``assemble`` taken from what came.
    Backward: ``back_send`` taken from the rows' gradient, exchanged with
    the counts swapped, ``back_place`` taken from what came: the gathered
    rows' gradient, which a reduce-scatter over ``data`` takes home."""
    send: tuple
    send_counts: tuple
    recv_counts: tuple
    assemble: tuple
    back_send: tuple
    back_place: tuple


def _runs(idx) -> tuple:
    """An index array as runs of consecutive indices ``(start, stop)``."""
    idx = np.asarray(idx, dtype=np.int64)
    cut = np.flatnonzero(np.diff(idx) != 1) + 1
    starts = np.concatenate([[0], cut])
    stops = np.concatenate([cut, [idx.size]])
    return tuple((int(idx[a]), int(idx[b - 1]) + 1)
                 for a, b in zip(starts, stops))


def _inverse(perm):
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    return inv


def _model_rows(n: int, model: int, parts: int, j: int):
    """The logical rows that model rank ``j`` computes with: part p's
    model block j for each of ``parts`` equal parts of the dim, in part
    order (``parts`` 1: rows [j·n/model, (j+1)·n/model))."""
    span, blk = n // parts, n // (parts * model)
    return np.concatenate([np.arange(p * span + j * blk,
                                     p * span + (j + 1) * blk)
                           for p in range(parts)])


@functools.lru_cache(maxsize=None)
def block_plan(n: int, data: int, model: int, j: int,
               parts: int = 1) -> BlockPlan:
    """Model rank ``j``'s :class:`BlockPlan` for a dim of ``n`` rows
    stored over (``data``, ``model``): rank (i, j) holds block i·model + j
    of n/(data·model) rows, the reference's major-to-minor order.  The
    target of model rank j is :func:`_model_rows` (``parts`` = 2: the x
    and z halves of Mamba's ``w_in``, each rank's block of both).  Every
    rank receives exactly its n/model target rows; ``data`` 1 is a dim
    over ``model`` alone.  Pure index arithmetic, the same on every data
    rank."""
    if n % (data * model) or n % (parts * model):
        raise ValueError(f"block_plan: {n} rows do not split over data "
                         f"{data} x model {model} in {parts} parts")
    s = n // (data * model)
    rows = np.arange(n)
    owner = (rows // s) % model          # the model rank holding a row
    held = np.flatnonzero(owner == j)    # rank j's rows once gathered
    pos = np.full(n, -1)
    pos[held] = np.arange(held.size)
    send, send_counts = [], []
    for m in range(model):
        at = pos[_model_rows(n, model, parts, m)]
        at = at[at >= 0]
        send.append(at)
        send_counts.append(int(at.size))
    send = np.concatenate(send)
    want = _model_rows(n, model, parts, j)
    order = np.argsort(owner[want], kind="stable")   # arrival order
    recv_counts = np.bincount(owner[want], minlength=model)
    return BlockPlan(send=_runs(send),
                     send_counts=tuple(send_counts),
                     recv_counts=tuple(int(c) for c in recv_counts),
                     assemble=_runs(_inverse(order)),
                     back_send=_runs(order), back_place=_runs(_inverse(send)))


def _take(buf, runs):
    """The rows of ``buf`` (dim 0) in the order of ``runs``: ``buf``
    itself when that is all of it in order, else one copy."""
    if len(runs) == 1 and runs[0] == (0, buf.shape[0]):
        return buf
    return torch.cat([buf[a:b] for a, b in runs])


def _collective(name, x, *args, mesh, dim):
    """``torch.ops._c10d_functional.<name>(x, *args)`` over mesh dim
    ``dim``'s group, waited for (what DTensor issues, so
    ``CommDebugMode`` counts it)."""
    group = mesh.get_group(dim).group_name
    op = getattr(torch.ops._c10d_functional, name)
    return torch.ops._c10d_functional.wait_tensor(
        op(x.contiguous(), *args, group))


def _exchange(x, send_counts, recv_counts, mesh, dim):
    """An all-to-all of ``x``'s rows over mesh dim ``dim`` (``send_counts``
    rows to each rank in turn, ``recv_counts`` from each)."""
    return _collective("all_to_all_single", x, list(recv_counts),
                       list(send_counts), mesh=mesh, dim=dim)


class _ModelBlocks(torch.autograd.Function):
    """:func:`model_blocks`: all-gather over ``data``, one exchange
    over ``model``; backward the exchange reversed, then a
    reduce-scatter over ``data`` back to the stored layout."""

    @staticmethod
    def forward(ctx, t, mesh, dim, parts):
        from torch.distributed.tensor import DTensor, Replicate, Shard
        names = _names(mesh)
        di, mi = names.index("data"), names.index("model")
        pl = tuple(t.placements)
        data = mesh.size(di) if pl[di] == Shard(dim) else 1
        j = mesh.get_local_rank("model")
        plan = block_plan(t.shape[dim], data, mesh.size(mi), j, parts)
        x = t.to_local().movedim(dim, 0)
        if data > 1:
            x = _collective("all_gather_into_tensor", x, data, mesh=mesh,
                            dim=di)
        # one buffer of N/|model| rows besides the result at a time
        x = _take(x, plan.send)
        x = _exchange(x, plan.send_counts, plan.recv_counts, mesh, mi)
        x = _take(x, plan.assemble)
        ctx.args = (mesh, dim, plan, pl, data, di, mi)
        out = tuple(Replicate() if i == di else p
                    for i, p in enumerate(pl))
        return DTensor.from_local(x.movedim(0, dim), mesh, out,
                                  run_check=False)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor, Replicate, Shard
        mesh, dim, plan, pl, data, di, mi = ctx.args
        # the gradient in the compute layout: partial over the dims
        # that shard the batch, the model block over "model"
        want = tuple(Shard(dim) if i == mi else
                     (p if p.is_partial() else Replicate())
                     for i, p in enumerate(g.placements))
        if tuple(g.placements) != want:
            g = g.redistribute(mesh, want)
        x = g.to_local().movedim(dim, 0)
        x = _take(x, plan.back_send)
        x = _exchange(x, plan.recv_counts, plan.send_counts, mesh, mi)
        x = _take(x, plan.back_place)
        got = list(want)
        if data > 1:
            if want[di].is_partial():
                x = _collective("reduce_scatter_tensor", x, "sum", data,
                                mesh=mesh, dim=di)
            else:
                s = x.shape[0] // data
                i = mesh.get_local_rank("data")
                x = x[i * s:(i + 1) * s]
            got[di] = Shard(dim)
        grad = DTensor.from_local(x.movedim(0, dim), mesh, tuple(got),
                                  run_check=False)
        if tuple(got) != pl:        # e.g. partial over "pod"
            grad = grad.redistribute(mesh, pl)
        return grad, None, None, None


def model_blocks(t, mesh, dim: int, parts: int = 1):
    """Leaf ``t``'s rows of tensor dim ``dim`` that this ``model`` rank
    computes with, replicated over ``data``: a DTensor ``Shard(dim)`` over
    ``model``, ``Replicate`` over the rest.  ``t``'s dim is stored over
    ``model`` and, optionally, ``data`` (rank (i, j) holding block
    i·|model| + j).  Model rank j gets rows [j·N/|model|, (j+1)·N/|model|)
    — with ``parts`` = 2 part p's block j of each half in turn, so that
    the result's local tensor is Mamba's [x_j | z_j] (its global order is
    then the halves' blocks interleaved: only a ``local_map`` region
    reads it).  An all-gather over ``data`` of the stored block and one
    all-to-all over ``model`` (:func:`block_plan`): the transient is the
    model block and one send buffer of that size, never the whole
    tensor.  The backward reverses the exchange and reduce-scatters the
    gradient over ``data`` to the stored layout."""
    return _ModelBlocks.apply(t, mesh, dim, parts)


def gathered(t, mesh, keep_data: bool = False):
    """A stored parameter in its compute layout: its ``data`` (FSDP)
    shard all-gathered, its ``model`` (TP) shard kept — the ZeRO-3
    gather at use.  A dim stored over both (``data``, ``model``) comes
    back as this rank's contiguous model block (:func:`model_blocks`),
    never whole.  ``keep_data`` keeps the data shard too (the MoE
    experts' E_v@data: dispatch travels, weights don't).  A plain tensor
    passes through; the backward reduce-scatters the gradient back to
    the stored layout."""
    if not is_dtensor(t) or keep_data:
        return t
    from torch.distributed.tensor import Replicate
    names = _names(mesh)
    if "data" in names and "model" in names:
        d, m = (t.placements[names.index(a)] for a in ("data", "model"))
        if d.is_shard() and d == m:
            return model_blocks(t, mesh, d.dim)
    pl = tuple(Replicate() if names[i] == "data" else p
               for i, p in enumerate(t.placements))
    return t if pl == tuple(t.placements) else t.redistribute(mesh, pl)


def with_model(mesh, pl, p) -> tuple:
    """Placements ``pl`` with the ``model`` mesh dim's replaced by
    ``p``."""
    mi = _names(mesh).index("model")
    return tuple(p if i == mi else q for i, q in enumerate(pl))


def weight_grad(rows, pl) -> tuple:
    """The placements of the gradient of a weight at ``pl`` used by rows
    at ``rows`` in a ``local_map`` region: each rank's gradient covers its
    own rows, so it is partial over the mesh dims that shard them."""
    from torch.distributed.tensor import Partial
    return tuple(Partial() if r.is_shard() else p for r, p in zip(rows, pl))


def local_blocks(fn, mesh, args, in_pl, grad_pl, out_pl):
    """``fn`` on each rank's local tensors of ``args`` (a ``local_map``),
    input i at placements ``in_pl[i]`` (redistributed there if it is not)
    with its gradient at ``grad_pl[i]``; ``out_pl`` holds one placements
    tuple per output of ``fn`` (one output: ``fn`` returns a tensor)."""
    from torch.distributed.tensor.experimental import local_map
    # one output takes a list: local_map reads a tuple as one per output
    out = list(out_pl[0]) if len(out_pl) == 1 else tuple(out_pl)
    return local_map(fn, out_placements=out, in_placements=tuple(in_pl),
                     in_grad_placements=tuple(grad_pl), device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def local_rows(fn, mesh, rows, acts, weights=(), n_out: int = 1):
    """``fn(*acts, *weights)`` on each rank's local tensors
    (:func:`local_blocks`): the activations in ``rows`` (the batch rows
    sharded over the batch axes, replicated over ``model``), the weights
    replicated.  Each rank's weight gradient covers its own rows, so it
    comes back partial over the mesh dims that shard the rows.  Every
    output (``n_out`` of them) is row-sharded like the activations.
    With no mesh (plain tensors) ``fn`` runs as it is."""
    if mesh is None:
        return fn(*acts, *weights)
    from torch.distributed.tensor import Replicate
    rows = tuple(rows)
    rep = tuple(Replicate() for _ in rows)
    return local_blocks(
        fn, mesh, tuple(acts) + tuple(weights),
        (rows,) * len(acts) + (rep,) * len(weights),
        (rows,) * len(acts) + (weight_grad(rows, rep),) * len(weights),
        (rows,) * n_out)


def rows_of(mesh, x) -> tuple:
    """The row layout of activation ``x``: its batch dim over the batch
    axes when the batch divides them, replicated otherwise."""
    ba = batch_axes(mesh)
    spec = ((_entry(ba) if x.shape[0] % n_batch(mesh) == 0 else None),)
    return placements(mesh, spec + (None,) * (x.ndim - 1))


def shard_input(x, mesh, spec):
    """A global tensor that every rank holds alike, as a DTensor of
    ``spec``: each rank keeps its own shard, with no communication."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(x, mesh, placements(mesh, spec),
                             src_data_rank=None)
