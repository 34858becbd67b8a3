"""Decoder: embeddings + a list of layers + LM head — the JAX package's
``models/transformer.py``.

The JAX model stacks each period position's parameters over n_periods
and scans over them; the port holds one :class:`DecoderLayer` per layer
in a ``ModuleList`` and runs a Python loop over them.  Layer i of the
port is period i // p, position i % p of the JAX model
(``convert.lm_params`` carries the JAX weights across that way), and its
kind is ``cfg.layer_kind(i)``: a mixer (``attn``, ``mamba`` or ``rwkv``)
and an FFN (``mlp``, ``moe`` or ``channelmix``).  :func:`forward` takes
a modality frontend's (B, F, D) embeddings and puts them in front of the
tokens'; its aux loss is the MoE layers' load-balance losses summed.

Parameters are frozen (``requires_grad=False``) as built; serving runs
them under ``inference_mode``.  ``train.steps.init_train_state`` makes a
training copy's parameters trainable (every layer kind), and
``forward(..., train=True)`` is the training forward: attention through
the blocked twin (``attention.blocked_flash_attention``, which autograd
follows), the Mamba, RWKV and MoE layers through the same torch ops as
serving, and each layer rematerialised as ``cfg.remat`` says:

  "full" — ``torch.utils.checkpoint.checkpoint`` around each layer
           (non-reentrant): only the layer's input is kept, the layer
           runs again in the backward;
  "dots" — a selective checkpoint around each layer that keeps the
           outputs of the projection matmuls and recomputes the rest,
           the counterpart of ``dots_with_no_batch_dims_saveable``;
  "none" — autograd keeps every activation.

The reference checkpoints a whole period (jamba's is 8 layers); the port
checkpoints each layer.  Both recompute the same ops on the same inputs,
so the values and gradients are the same, and the port's peak is lower:
one layer's activations are live in the backward, not a period's.  A
recomputed MoE layer routes its tokens again from the same saved input
through the same ops, so it routes them as the forward did.

On a device mesh (``forward(..., mesh=)``, the parameters and the batch
DTensors placed by ``models.sharding``, as ``train.steps``' builders
place them) each layer takes its weights in their compute layout
(``sharding.gathered``: the FSDP shard all-gathered, the TP shard kept;
the MoE experts stay E_v@data), ``constrain`` pins the (B, T, D)
activations to batch-over-(pod, data) after the embedding and after
each layer (the reference pins them at each period's ends; the extra
pins are no-ops), and ``moe_c`` = (ep_c, bt_c) is handed to the MoE
FFNs.  A dim stored over (``data``, ``model``) comes to each rank as its
model block (``sharding.model_blocks``), never whole.  Attention goes
through ``attention.flash_attention_sharded``; the Mamba and RWKV
time-mix mixers, whose scan, ``torch.cat`` steps and cumulative sums
DTensor has no strategy for, run in ``local_map`` regions: the Mamba
mixer with d_inner over ``model``, as the reference keeps it
(:func:`_mamba_sharded`: two regions, the partial projection between
them all-reduced), the RWKV time mix per batch shard with its weights
gathered whole (``sharding.local_rows``: the reference's RWKV
projections are FSDP-only, so that is its layout); the MLP and
channel-mix FFNs, the norms and the LM head run on the DTensors.

Decode caches are a list with one dict per layer, keyed by what the
layer carries: ``attn`` {k, v}, ``mamba`` {conv, ssm}, ``rwkv`` {x, s}
and ``cmix`` {x}; :func:`prefill_with_cache` fills them and
:func:`decode_step` writes into them in place.
"""

from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..runtime.device import resolve_device
from . import sharding as shd
from .attention import (NEG_INF, _qkv, attention_block,
                        decode_attention_block,
                        flash_attention, init_attention, init_kv_cache)
from .layers import (embed_tokens, init_embeddings, init_mlp, lm_logits, mlp,
                     rms_norm)
from .mamba import (_mamba_prefill, decode_mamba_block, init_mamba,
                    init_mamba_cache, mamba_block, mamba_split_in,
                    mamba_split_out)
from .moe import init_moe, moe_ffn
from .rwkv import (decode_rwkv_channel_mix, decode_rwkv_time_mix,
                   init_rwkv_channel_mix, init_rwkv_time_mix,
                   rwkv_channel_mix, rwkv_time_mix)

__all__ = ["DecoderLayer", "Transformer", "check_supported", "decode_step",
           "forward", "init_caches", "init_params", "prefill_with_cache",
           "replace_parameters"]

MIXERS = ("attn", "mamba", "rwkv")
FFNS = ("mlp", "moe", "channelmix")


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` if a layer of ``cfg`` has a mixer or
    FFN kind the port does not run (every shipped config runs)."""
    for i in range(cfg.n_layers):
        mixer, ffn = cfg.layer_kind(i)
        if mixer not in MIXERS or ffn not in FFNS:
            raise NotImplementedError(
                f"{cfg.name}: layer {i} is ({mixer}, {ffn}); the port runs "
                f"mixers {MIXERS} and FFNs {FFNS}")


def _frozen(t):
    return nn.Parameter(t, requires_grad=False)


class DecoderLayer(nn.Module):
    """One layer of kind ``(mixer, ffn)``: norm1, norm2 and the mixer's
    and FFN's tensors in ``mixer`` and ``ffn``, held as frozen
    parameters in their own types (a bfloat16 layer's Mamba ``a_log`` and
    ``d_skip``, RWKV ``w0`` and ``u`` and MoE ``router`` are float32)."""

    def __init__(self, p: dict, kind: tuple):
        super().__init__()
        self.kind = tuple(kind)
        self.norm1 = _frozen(p["norm1"])
        self.norm2 = _frozen(p["norm2"])
        self.mixer = nn.ParameterDict({k: _frozen(t)
                                       for k, t in p["mixer"].items()})
        self.ffn = nn.ParameterDict({k: _frozen(t)
                                     for k, t in p["ffn"].items()})


class Transformer(nn.Module):
    """The model's parameters: ``embeddings`` {embed, lm_head,
    final_norm} and ``layers``, layer i of kind ``cfg.layer_kind(i)``.
    Calling it runs :func:`forward`."""

    def __init__(self, cfg, embeddings: dict, layers: list):
        super().__init__()
        check_supported(cfg)
        if len(layers) != cfg.n_layers:
            raise ValueError(f"{cfg.name}: {len(layers)} layers, expected "
                             f"{cfg.n_layers}")
        self.cfg = cfg
        self.embeddings = nn.ParameterDict({k: _frozen(t)
                                            for k, t in embeddings.items()})
        self.layers = nn.ModuleList(DecoderLayer(p, cfg.layer_kind(i))
                                    for i, p in enumerate(layers))

    def forward(self, tokens, frontend=None, logits_last_only: bool = False):
        return forward(self, tokens, self.cfg, frontend=frontend,
                       logits_last_only=logits_last_only)


def replace_parameters(module, fn) -> None:
    """Each parameter of ``module`` replaced, in place, by a parameter
    holding ``fn(name, tensor)`` (``requires_grad`` kept): the parameter
    dicts' entries by key, other modules' by attribute."""
    with torch.no_grad():
        for name, p in list(module.named_parameters()):
            mod_name, _, leaf = name.rpartition(".")
            mod = module.get_submodule(mod_name)
            new = nn.Parameter(fn(name, p.detach()),
                               requires_grad=p.requires_grad)
            if isinstance(mod, nn.ParameterDict):
                mod[leaf] = new
            else:
                setattr(mod, leaf, new)


# ---------------------------------------------------------------- params
_MIXER_INIT = {"attn": init_attention, "mamba": init_mamba,
               "rwkv": init_rwkv_time_mix}


def _init_ffn(gen, cfg, ffn):
    if ffn == "mlp":
        return init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_type,
                        cfg.torch_dtype)
    if ffn == "moe":
        return init_moe(gen, cfg, split=cfg.moe_ep_split)
    return init_rwkv_channel_mix(gen, cfg)


def init_params(seed: int, cfg, device=None) -> Transformer:
    """Random weights from a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (the JAX package's initialisers and scales; other numbers
    than its PRNG keys give)."""
    check_supported(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = cfg.torch_dtype
    emb = init_embeddings(gen, cfg.padded_vocab, cfg.d_model, dt)
    layers = []
    for i in range(cfg.n_layers):
        mixer, ffn = cfg.layer_kind(i)
        ones = torch.ones((cfg.d_model,), dtype=dt, device=device)
        layers.append({"norm1": ones, "norm2": ones.clone(),
                       "mixer": _MIXER_INIT[mixer](gen, cfg),
                       "ffn": _init_ffn(gen, cfg, ffn)})
    return Transformer(cfg, emb, layers)


def _positions(b: int, t: int, device):
    return torch.arange(t, device=device).expand(b, t)


class _Settled(torch.autograd.Function):
    """Redistribute to ``pl`` (partial sums all-reduced); the gradient
    passes back replicated over ``model`` — as the logical gradient of a
    sum of partials is: as it comes, or all-reduced where it comes
    partial (the Mamba projection's, whose users each hold a slice of
    d_inner; DTensor versions differ on whether a ``local_map`` output
    placed ``Partial`` all-reduces such a gradient itself).  (A plain
    redistribute would hand back a partial gradient, for which DTensor
    gathers the whole weight of the projection before it.)"""

    @staticmethod
    def forward(ctx, h, mesh, pl):
        ctx.mesh, ctx.pl = mesh, pl
        return h.redistribute(mesh, pl)

    @staticmethod
    def backward(ctx, g):
        if any(p.is_partial() for p in g.placements):
            g = g.redistribute(ctx.mesh, ctx.pl)
        return g, None, None


class _Entered(torch.autograd.Function):
    """The identity, whose gradient is settled to ``pl`` (Megatron's f:
    the partial input gradients of the projections that follow are
    all-reduced once, here; left partial, DTensor would gather whole
    weights to take them further back)."""

    @staticmethod
    def forward(ctx, x, mesh, pl):
        ctx.mesh, ctx.pl = mesh, pl
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(ctx.mesh, ctx.pl), None, None


def _enter(x, mesh):
    """A sublayer's input on a mesh (:class:`_Entered`)."""
    return _Entered.apply(x, mesh, shd.rows_of(mesh, x))


def _settle(h, mesh):
    """An activation in the row layout (batch over the batch axes,
    replicated elsewhere): partial sums all-reduced."""
    return _Settled.apply(h, mesh, shd.rows_of(mesh, h))


def _embed_sharded(tokens, table, mesh):
    """The token rows of a vocab-sharded table (a masked partial sum over
    ``data``), reduced to the row layout."""
    return _settle(torch.nn.functional.embedding(tokens, table), mesh)


class _Compute:
    """A layer's tensors in their compute layout on ``mesh``
    (``sharding.gathered``); the MoE experts keep their E_v@data, and
    Mamba's ``w_in`` stays as stored for :func:`_mamba_sharded`, which
    takes both of its halves' model blocks."""

    def __init__(self, p, mesh):
        self.kind = p.kind
        self.norm1 = shd.gathered(p.norm1, mesh)
        self.norm2 = shd.gathered(p.norm2, mesh)
        self.mixer = {k: t if (p.kind[0], k) == ("mamba", "w_in")
                      else shd.gathered(t, mesh)
                      for k, t in p.mixer.items()}
        keep = p.kind[1] == "moe"
        self.ffn = {k: shd.gathered(t, mesh, keep_data=keep and k != "router")
                    for k, t in p.ffn.items()}


def _whole(t, mesh):
    """A weight replicated on every rank (a ``local_map`` region's)."""
    from torch.distributed.tensor import Replicate
    return t.redistribute(mesh, (Replicate(),) * mesh.ndim)


def _mixer_local(fn, params, x, cfg, mesh):
    """``fn(params, x, cfg)`` (the RWKV time-mix block's output) per batch
    shard, its weights gathered whole (the reference's RWKV projections
    are FSDP-only)."""
    names = list(params)

    def local(xl, *ws):
        return fn(dict(zip(names, ws)), xl, cfg)
    return shd.local_rows(local, mesh, shd.rows_of(mesh, x), (x,),
                          tuple(_whole(params[k], mesh) for k in names))


_MAMBA_IN = ("w_in", "conv_w", "conv_b", "w_x")
_MAMBA_OUT = ("w_dt", "b_dt", "a_log", "d_skip", "w_out")


def _mamba_sharded(params, x, cfg, mesh, state=None):
    """The Mamba mixer on a mesh with d_inner over ``model``, as the
    reference's specs place it, in two ``local_map`` regions
    (``sharding.local_blocks``):

      1. ``mamba_split_in`` on x in the row layout, this rank's columns of
         both halves of ``w_in`` (``sharding.model_blocks``, parts 2),
         ``conv_w``, ``conv_b`` and ``w_x``'s rows at their shards: xc and
         z at d_inner@``model`` and the projection xc @ w_x partial over
         ``model``, settled (all-reduced) between the regions;
      2. ``mamba_split_out``: the scan over this rank's d_inner/|model|
         channels with ``w_dt``'s model block, ``b_dt``, ``a_log`` and
         ``d_skip`` at their shards, and y @ w_out partial over
         ``model`` (the layer settles it).

    With ``state`` (a decode cache {conv, ssm} at d_inner@``model``) one
    token steps from it and the new states are written into the cache's
    own slices.  Where d_inner is not split over ``model`` (a model dim
    of one rank, or one it does not divide) the same regions run on the
    whole of it."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    rows = shd.rows_of(mesh, x)
    split = any(p.is_shard() for p in params["conv_b"].placements)
    w = dict(params)
    w["w_in"] = (shd.model_blocks(params["w_in"], mesh, 1, parts=2) if split
                 else _whole(params["w_in"], mesh))
    part = shd.with_model(mesh, rows, Partial() if split else Replicate())

    def cols(d):                    # an activation with d_inner at dim d
        return shd.with_model(mesh, rows, Shard(d) if split else Replicate())

    def weights(names):
        ts = tuple(w[k] for k in names)
        return (ts, tuple(t.placements for t in ts),
                tuple(shd.weight_grad(rows, t.placements) for t in ts))

    ws, w_pl, w_grad = weights(_MAMBA_IN)
    st = (state["conv"],) if state else ()
    st_pl = (cols(2),) * len(st)

    def first(xl, *ts):
        xc, z, proj, conv = mamba_split_in(dict(zip(_MAMBA_IN, ts)), xl,
                                           cfg, *ts[len(_MAMBA_IN):])
        return (xc, z, proj) + ((conv,) if state else ())
    xc, z, proj, *conv = shd.local_blocks(
        first, mesh, (x,) + ws + st, (rows,) + w_pl + st_pl,
        (part,) + w_grad + st_pl, (cols(2), cols(2), part) + st_pl)
    proj = _settle(proj, mesh)

    ws, w_pl, w_grad = weights(_MAMBA_OUT)
    st = (state["ssm"],) if state else ()
    st_pl = (cols(1),) * len(st)

    def second(xcl, zl, pl_, *ts):
        out, h = mamba_split_out(dict(zip(_MAMBA_OUT, ts)), xcl, zl, pl_,
                                 cfg, *ts[len(_MAMBA_OUT):])
        return (out, h) if state else out
    res = shd.local_blocks(
        second, mesh, (xc, z, proj) + ws + st,
        (cols(2), cols(2), rows) + w_pl + st_pl,
        (cols(2), cols(2), part) + w_grad + st_pl, (part,) + st_pl)
    if not state:
        return res
    _write_back(state, {"conv": conv[0], "ssm": res[1]})
    return res[0]


def _rwkv(params, x, cfg):
    return rwkv_time_mix(params, x, cfg)[0]


def _layer_apply(p, h, positions, cfg, train: bool = False, moe_c=None,
                 mesh=None):
    """One layer of the forward: (h, the MoE aux loss or None).  On a
    mesh each sublayer's output is settled to the row layout (the TP
    all-reduce of a projection's partial sums) before its residual
    add."""
    settle = _settle if mesh is not None else (lambda t, m: t)
    enter = _enter if mesh is not None else (lambda t, m: t)
    if mesh is not None:
        p = _Compute(p, mesh)
    mixer, ffn = p.kind
    x = enter(rms_norm(h, p.norm1), mesh)
    if mixer == "attn":
        out = attention_block(p.mixer, x, positions, cfg, train=train,
                              mesh=mesh)
    elif mesh is None:
        out = (mamba_block if mixer == "mamba" else _rwkv)(p.mixer, x, cfg)
    elif mixer == "mamba":
        out = _mamba_sharded(p.mixer, x, cfg, mesh)
    else:
        out = _mixer_local(_rwkv, p.mixer, x, cfg, mesh)
    h = h + settle(out, mesh)
    x = enter(rms_norm(h, p.norm2), mesh)
    aux = None
    if ffn == "mlp":
        out = mlp(p.ffn, x, cfg.mlp_type)
    elif ffn == "moe":
        ep_c, bt_c = moe_c if moe_c else (None, None)
        out, aux = moe_ffn(p.ffn, x, cfg, ep_constrain=ep_c,
                           batch_constrain=bt_c, mesh=mesh)
    else:
        out = rwkv_channel_mix(p.ffn, x)[0]
    return h + settle(out, mesh), aux


def _dots_policy(ctx, op, *args, **kwargs):
    """Keep the projection matmuls' outputs, recompute the rest.  The
    projections reach the dispatcher as ``mm`` (``x @ w``: the attention,
    MLP, Mamba ``w_in``/``w_x``/``w_dt``/``w_out``, RWKV and router
    projections) or as a ``bmm`` of one batch (an einsum without batch
    axes); the batched einsums are ``bmm`` over their batch axes and are
    recomputed like the JAX policy's batched dots: the attention's over
    B·KV·q blocks, the MoE experts' over E_v, the Mamba readout's over
    B·T and the RWKV chunk's over B·H (a call whose batch is 1 would
    keep them too: more memory, the same values)."""
    if op is torch.ops.aten.mm.default or (
            op is torch.ops.aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_DOTS = functools.partial(create_selective_checkpoint_contexts, _dots_policy)


def _train_layer(p, h, positions, cfg, moe_c=None, mesh=None):
    """One layer of the training forward under ``cfg.remat`` (on a mesh
    the weights' gather is inside the checkpoint: the backward gathers
    again, as ZeRO-3 does)."""
    if cfg.remat == "none":
        return _layer_apply(p, h, positions, cfg, True, moe_c, mesh)
    if cfg.remat not in ("full", "dots"):
        raise ValueError(f"{cfg.name}: remat {cfg.remat!r}; choose none, "
                         f"dots or full")
    # the layer draws no random numbers: no RNG state to keep
    extra = {"context_fn": _DOTS} if cfg.remat == "dots" else {}
    return checkpoint(_layer_apply, p, h, positions, cfg, True, moe_c, mesh,
                      use_reentrant=False, preserve_rng_state=False,
                      **extra)


# --------------------------------------------------------------- forward
def forward(params, tokens, cfg, frontend=None,
            logits_last_only: bool = False, train: bool = False,
            constrain=None, moe_c=None, mesh=None):
    """Train/prefill forward.  tokens: (B, T) int; ``frontend``: optional
    (B, F, D) modality embeddings put in front of the tokens'.
    ``logits_last_only``: the projection runs on the last position only.
    ``train``: the training forward (blocked attention under autograd,
    ``cfg.remat``); otherwise attention is K4.  ``constrain``, ``moe_c``
    and ``mesh``: the sharding hooks (module docstring).  Returns (logits
    (B, F + T, V_padded), aux_loss: the MoE layers' summed, float32)."""
    constrain = constrain or (lambda x: x)
    if mesh is None:
        h = embed_tokens(params.embeddings, tokens)
        emb = params.embeddings
    else:
        # the vocab-sharded table's row gather (a masked partial sum)
        emb = {k: shd.gathered(t, mesh) if k != "embed" else t
               for k, t in params.embeddings.items()}
        h = _embed_sharded(tokens, emb["embed"], mesh)
    if frontend is not None:
        h = torch.cat([frontend.to(h.dtype), h], dim=1)
    h = constrain(h)
    b, t, _ = h.shape
    positions = _positions(b, t, h.device)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for p in params.layers:
        h, a = (_train_layer(p, h, positions, cfg, moe_c, mesh) if train
                else _layer_apply(p, h, positions, cfg, moe_c=moe_c,
                                  mesh=mesh))
        h = constrain(h)
        if a is not None:
            aux = aux + a
    if logits_last_only:
        h = h[:, -1:]
    logits = lm_logits(emb, h, cfg.vocab_size)
    return logits, aux


# ---------------------------------------------------------------- decode
def init_caches(batch: int, cfg, max_len: int, device=None):
    """Zeroed decode caches, one dict per layer (module docstring)."""
    check_supported(cfg)
    device = resolve_device(device)
    dt = cfg.torch_dtype
    d = cfg.d_model
    caches = []
    for i in range(cfg.n_layers):
        mixer, ffn = cfg.layer_kind(i)
        c = {}
        if mixer == "attn":
            c["attn"] = init_kv_cache(batch, cfg, max_len, dt, device)
        elif mixer == "mamba":
            c["mamba"] = init_mamba_cache(batch, cfg, dt, device)
        else:
            hd = cfg.rwkv_head_size
            c["rwkv"] = {
                "x": torch.zeros((batch, d), dtype=dt, device=device),
                "s": torch.zeros((batch, d // hd, hd, hd),
                                 dtype=torch.float32, device=device)}
        if ffn == "channelmix":
            c["cmix"] = {"x": torch.zeros((batch, d), dtype=dt,
                                          device=device)}
        caches.append(c)
    return caches


def _rows_cache(c, mesh, rows):
    """A layer's small decode state (RWKV, channel mix) in the row
    layout ``rows`` of the step: batch over the batch axes, the rest
    whole."""
    return {k: t.redistribute(mesh, rows) for k, t in c.items()}


def _write_back(c, new):
    """Copy a row-layout state back into the cache's own placements
    (a local slice: no communication)."""
    for k, t in c.items():
        t.copy_(new[k].redistribute(t.device_mesh, t.placements))


def _decode_attention_sharded(params, x, cache, step: int, cfg, mesh):
    """One-token attention against a cache sharded by
    ``sharding.cache_specs``: KV heads over ``model`` when they divide
    it, else the sequence over ``model`` (and over ``data`` too for a
    batch of one) — flash-decode.  Each rank writes the new key and
    value into its own cache slice if the slot is there, scores its
    slice, and the softmax's max and sums are all-reduced over the mesh
    dims that shard the sequence."""
    from torch.distributed._functional_collectives import all_reduce
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    from torch.distributed.tensor.experimental import local_map

    b = x.shape[0]
    positions = torch.full((b, 1), step, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(params, x, positions, cfg)
    ck, cv = cache["k"], cache["v"]
    s_cache = ck.shape[1]
    slot = step % s_cache if cfg.sliding_window else step
    g = q.shape[2] // cfg.n_kv_heads
    hd = cfg.head_dim_
    pl = ck.placements
    seq_dims = [i for i, p_ in enumerate(pl) if p_.is_shard(1)]
    head_dims = [i for i, p_ in enumerate(pl) if p_.is_shard(2)]
    _, (_, s0, kv0, _) = compute_local_shape_and_global_offset(
        ck.shape, mesh, pl)
    rows = tuple(p_ if p_.is_shard(0) else Replicate() for p_ in pl)
    out_pl = tuple(Replicate() if i not in head_dims else p_
                   for i, p_ in enumerate(pl))
    out_pl = tuple(rows[i] if rows[i].is_shard(0) else p_
                   for i, p_ in enumerate(out_pl))

    def local(ql, kl, vl, ckl, cvl):
        s_l, kv_l = ckl.shape[1], ckl.shape[2]
        if s0 <= slot < s0 + s_l:
            ckl[:, slot - s0] = kl[:, 0, kv0:kv0 + kv_l]
            cvl[:, slot - s0] = vl[:, 0, kv0:kv0 + kv_l]
        qg = ql[:, :, kv0 * g:(kv0 + kv_l) * g].reshape(
            ql.shape[0], 1, kv_l, g, hd).permute(0, 2, 3, 1, 4)
        sc = torch.einsum("bkgqh,bskh->bkgqs", qg, ckl).to(torch.float32)
        sc = sc * hd ** -0.5
        idx = s0 + torch.arange(s_l, device=ql.device)
        valid = idx <= slot
        if cfg.sliding_window and step >= s_cache:
            valid = torch.ones_like(valid)
        sc = torch.where(valid, sc, NEG_INF)
        m = sc.amax(dim=-1, keepdim=True)
        for i in seq_dims:
            m = all_reduce(m, "max", (mesh, i))
        p_ = torch.exp(sc - m)
        den = p_.sum(dim=-1, keepdim=True)
        o = torch.einsum("bkgqs,bskh->bkgqh", p_, cvl.to(torch.float32))
        for i in seq_dims:
            den = all_reduce(den, "sum", (mesh, i))
            o = all_reduce(o, "sum", (mesh, i))
        o = (o / den).to(cvl.dtype)
        return o.permute(0, 3, 1, 2, 4).reshape(ql.shape[0], 1, kv_l * g, hd)

    o = local_map(local, out_placements=list(out_pl),
                  in_placements=(rows, rows, rows, pl, pl), device_mesh=mesh,
                  redistribute_inputs=True)(q, k, v, ck, cv)
    return torch.einsum("bthk,hkd->btd", o, params["wo"])


def _decode_recurrent(mixer, params, x, c, cfg, mesh):
    """A Mamba or RWKV time-mix layer's one-token step; its state in
    ``c`` is updated in place.  On a mesh the Mamba step keeps d_inner
    over ``model`` (:func:`_mamba_sharded`: its states stay in their
    cache slices); the RWKV state (small, per row) is taken in the row
    layout, the step runs per batch shard on whole weights, and the new
    state is written back into the cache's own slices."""
    if mixer == "mamba":
        if mesh is None:
            return decode_mamba_block(params, x, c["mamba"], cfg)[0]
        return _mamba_sharded(params, x, cfg, mesh, state=c["mamba"])
    if mesh is None:
        return decode_rwkv_time_mix(params, x, c["rwkv"], cfg)[0]
    rows = shd.rows_of(mesh, x)
    state = _rows_cache(c["rwkv"], mesh, rows)
    names, wnames = list(state), list(params)

    def local(xl, *ts):
        st = dict(zip(names, ts[:len(names)]))
        o, st = decode_rwkv_time_mix(dict(zip(wnames, ts[len(names):])), xl,
                                     st, cfg)
        return (o,) + tuple(st[n] for n in names)
    res = shd.local_rows(local, mesh, rows,
                         (x,) + tuple(state[n] for n in names),
                         tuple(_whole(params[n], mesh) for n in wnames),
                         n_out=1 + len(names))
    _write_back(c["rwkv"], dict(zip(names, res[1:])))
    return res[0]


def _decode_channel_mix(params, x, c, mesh):
    """The channel mix's one-token step; its shift state in ``c``
    updated in place (on a mesh through the row layout, as
    :func:`_decode_recurrent`)."""
    if mesh is None:
        return decode_rwkv_channel_mix(params, x, c)[0]
    state = _rows_cache(c, mesh, shd.rows_of(mesh, x))
    out, last = rwkv_channel_mix(params, x, shift_state=state["x"])
    _write_back(c, {"x": last})
    return out


def decode_step(params, token, caches, step: int, cfg, constrain=None,
                moe_c=None, mesh=None):
    """One decode step.  token: (B, 1) int; ``step``: host int, the tokens
    already in the caches (updated in place).  Returns (logits (B, 1, V),
    caches).  On a mesh the parameters, token and caches are DTensors
    (``sharding.cache_specs``) and the hooks are :func:`forward`'s;
    attention is :func:`_decode_attention_sharded` (flash-decode over the
    cache's shards), the rest the same code."""
    constrain = constrain or (lambda x: x)
    settle = _settle if mesh is not None else (lambda t, m: t)
    if mesh is None:
        emb = params.embeddings
        h = embed_tokens(emb, token)
    else:
        emb = {k: shd.gathered(t, mesh) if k != "embed" else t
               for k, t in params.embeddings.items()}
        h = _embed_sharded(token, emb["embed"], mesh)
    h = constrain(h)
    for p, c in zip(params.layers, caches):
        if mesh is not None:
            p = _Compute(p, mesh)
        mixer, ffn = p.kind
        x = rms_norm(h, p.norm1)
        if mixer != "attn":
            out = _decode_recurrent(mixer, p.mixer, x, c, cfg, mesh)
        elif mesh is None:
            out = decode_attention_block(p.mixer, x, c["attn"], step, cfg)[0]
        else:
            out = _decode_attention_sharded(p.mixer, x, c["attn"], step, cfg,
                                            mesh)
        h = constrain(h + settle(out, mesh))
        x = rms_norm(h, p.norm2)
        if ffn == "mlp":
            out = mlp(p.ffn, x, cfg.mlp_type)
        elif ffn == "moe":
            ep_c, bt_c = moe_c if moe_c else (None, None)
            out = moe_ffn(p.ffn, x, cfg, ep_constrain=ep_c,
                          batch_constrain=bt_c, mesh=mesh)[0]
        else:
            out = _decode_channel_mix(p.ffn, x, c["cmix"], mesh)
        h = constrain(h + settle(out, mesh))
    logits = lm_logits(emb, h, cfg.vocab_size)
    return logits, caches


# -------------------------------------------------- prefill with cache
def prefill_with_cache(params, tokens, cfg, max_len: int):
    """Forward pass that also fills the decode caches (serving path);
    attention is K4.  Returns (logits (B, T, V_padded), caches)."""
    b, t = tokens.shape
    h = embed_tokens(params.embeddings, tokens)
    positions = _positions(b, t, h.device)
    caches = init_caches(b, cfg, max_len, h.device)
    for p, c in zip(params.layers, caches):
        mixer, ffn = p.kind
        x = rms_norm(h, p.norm1)
        if mixer == "attn":
            q, k, v = _qkv(p.mixer, x, positions, cfg)
            ck, cv = c["attn"]["k"], c["attn"]["v"]
            s_cache = ck.shape[1]
            if cfg.sliding_window and t > s_cache:
                ck.copy_(k[:, -s_cache:])
                cv.copy_(v[:, -s_cache:])
            else:
                ck[:, :t] = k
                cv[:, :t] = v
            o = flash_attention(q, k, v, cfg)
            h = h + torch.einsum("bthk,hkd->btd", o, p.mixer["wo"])
        elif mixer == "mamba":
            out, state = _mamba_prefill(p.mixer, x, cfg)
            for name, a in state.items():
                c["mamba"][name].copy_(a)
            h = h + out
        else:
            out, (last_x, s_f) = rwkv_time_mix(p.mixer, x, cfg)
            c["rwkv"]["x"].copy_(last_x)
            c["rwkv"]["s"].copy_(s_f)
            h = h + out
        x = rms_norm(h, p.norm2)
        if ffn == "mlp":
            h = h + mlp(p.ffn, x, cfg.mlp_type)
        elif ffn == "moe":
            h = h + moe_ffn(p.ffn, x, cfg)[0]
        else:
            out, last_x = rwkv_channel_mix(p.ffn, x)
            c["cmix"]["x"].copy_(last_x)
            h = h + out
    logits = lm_logits(params.embeddings, h, cfg.vocab_size)
    return logits, caches
