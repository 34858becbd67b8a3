"""Step functions: train, prefill, decode — the JAX package's
``train/steps.py`` on torch tensors, on one card or on a device mesh.

The JAX package's ``build_*`` functions return a jitted function with its
shardings; here each returns the step with ``cfg``, the optimizer and
the sharding hooks bound, and the same specs (``models.sharding``'s
tuples): ``build_train_step`` → (fn, state specs, batch specs),
``build_prefill_step`` → (fn, param specs, batch specs),
``build_serve_step`` → (fn, param specs, cache specs, token spec).  With
``mesh=None`` the step runs on one device without placements and the
specs are None.  With a ``DeviceMesh`` the step takes the state (or
params, caches) as DTensors on it (:func:`place_train_state`,
:func:`place_params`; a step places plain ones on its first call, as
the jit's ``in_shardings`` would), and the batch as global tensors that
every rank holds alike: each rank keeps its own rows.  The step runs
under ``implicit_replication`` (plain tensors such as positions and
masks count as replicated); its metrics and outputs come back as plain
tensors, the same on every rank.

The JAX jit donates the train state; :func:`train_step` updates it in
place instead and returns the same objects (``donate`` is accepted for
the reference's signature).  Every shipped config trains: attention,
Mamba and RWKV mixers, MLP, MoE and channel-mix FFNs, with a modality
frontend's embeddings in the batch.

A train state is ``{"params": Transformer, "m": {name: f32}, "v":
{name: f32}, "step": int32 0-d}``, the moments named as the module's
``named_parameters()``.
"""

from __future__ import annotations

import contextlib
import functools

import torch

from ..models import sharding as shd
from ..models.transformer import (decode_step, forward, init_params,
                                  replace_parameters)
from .loss import lm_loss
from .optimizer import (OptConfig, adamw_update, init_opt_state,
                        named_params)

__all__ = ["build_prefill_step", "build_serve_step", "build_train_step",
           "cache_placements", "default_microbatches", "gather_train_state",
           "init_train_state",
           "param_placements", "place_caches", "place_params",
           "place_train_state", "prefill_step",
           "serve_step", "train_state_specs", "train_step"]


def train_state_specs(cfg, mesh):
    pspec = shd.param_specs(cfg, mesh)
    return {"params": pspec, "m": pspec, "v": pspec, "step": ()}


def param_placements(cfg, mesh) -> dict:
    """{name: spec} of the port's named parameters (``embeddings.*`` and
    ``layers.i.*``): layer i takes its period position's specs without
    the stacked period axis."""
    ps = shd.param_specs(cfg, mesh)
    out = {f"embeddings.{k}": v for k, v in ps["embeddings"].items()}
    for i in range(cfg.n_layers):
        spec = shd.layer_specs(cfg, mesh, cfg.layer_kind(i))
        for k, v in spec.items():
            if isinstance(v, dict):
                out.update({f"layers.{i}.{k}.{n}": s for n, s in v.items()})
            else:
                out[f"layers.{i}.{k}"] = v
    return out


def _on_mesh(x, mesh, spec):
    if shd.is_dtensor(x):
        return x.redistribute(mesh, shd.placements(mesh, spec))
    return shd.shard_input(x, mesh, spec)


def place_params(params, cfg, mesh):
    """The model's parameters as DTensors of their specs, in place (each
    rank keeps its own shards of the tensors it holds); returns
    ``params``."""
    specs = param_placements(cfg, mesh)
    replace_parameters(params, lambda n, t: _on_mesh(t, mesh, specs[n]))
    return params


def place_train_state(state, cfg, mesh):
    """A train state's parameters, moments and step as DTensors of
    :func:`train_state_specs` on ``mesh``, in place; returns ``state``.
    The target mesh may differ from the one the state was on."""
    place_params(state["params"], cfg, mesh)
    specs = param_placements(cfg, mesh)
    for part in ("m", "v"):
        state[part] = {k: _on_mesh(t, mesh, specs[k])
                       for k, t in state[part].items()}
    state["step"] = _on_mesh(state["step"], mesh, ())
    return state


def gather_train_state(state):
    """A placed train state back as plain tensors, in place (each leaf's
    ``full_tensor()``: a collective every rank takes part in); returns
    ``state``."""
    replace_parameters(state["params"], lambda n, t: _local(t))
    for part in ("m", "v"):
        state[part] = {k: _local(t) for k, t in state[part].items()}
    state["step"] = _local(state["step"])
    return state


def cache_placements(cfg, mesh, batch: int, seq_shard: bool = False):
    """The specs of the port's decode caches (one dict per layer, layer i
    taking its period position's ``cache_specs`` without the period
    axis)."""
    specs = shd.cache_specs(cfg, mesh, batch, seq_shard=seq_shard)

    def drop(tree):
        if isinstance(tree, dict):
            return {k: drop(v) for k, v in tree.items()}
        return tuple(tree[1:])
    return [drop(specs[i % cfg.period]) for i in range(cfg.n_layers)]


def place_caches(caches, cfg, mesh, batch: int, seq_shard: bool = False):
    """Decode caches as DTensors of :func:`cache_placements` (each rank
    keeping its own slices); returns the new list."""
    specs = cache_placements(cfg, mesh, batch, seq_shard)
    return [{kind: {k: _on_mesh(t, mesh, specs[i][kind][k])
                    for k, t in c.items()} for kind, c in layer.items()}
            for i, layer in enumerate(caches)]


def _placed(state) -> bool:
    return shd.is_dtensor(state["step"])


def _local(x):
    """A replicated (or partial) DTensor's value as a plain tensor."""
    return x.full_tensor() if shd.is_dtensor(x) else x


def _replicated(mesh):
    """``implicit_replication`` on a mesh, nothing without one."""
    if mesh is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def init_train_state(seed: int, cfg, device=None):
    """Random parameters from ``seed`` (``init_params``), made trainable,
    zero moments and step 0.  Every layer kind the port runs
    (``models.transformer.check_supported``) trains."""
    params = init_params(seed, cfg, device=device)
    params.requires_grad_(True)
    opt = init_opt_state(params)
    return {"params": params, "m": opt["m"], "v": opt["v"],
            "step": opt["step"]}


def _loss_and_grads(params, leaves, mb, cfg, fwd):
    """Loss, metrics and the parameters' gradients (in the parameters'
    type) of one (micro)batch through the training forward."""
    loss, metrics = lm_loss(params, mb, cfg, fwd)
    grads = torch.autograd.grad(loss, leaves)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def train_step(state, batch, cfg, opt: OptConfig, microbatches: int = 1,
               grad_sync_dtype=None, constrain=None, moe_c=None,
               grad_constrain=None, mesh=None, batch_spec=None):
    """Forward + backward + AdamW, with gradient accumulation.

    ``microbatches`` > 1 runs the batch in that many slices along its
    first axis, accumulating float32 gradients (each slice's gradients,
    cast to ``grad_sync_dtype`` first when given, are added to the
    float32 sums; the sums are divided by the count) — the production
    memory lever: live activations shrink by the microbatch factor while
    the optimizer still sees the full global batch.  The loss is the mean
    over the slices; ``ce``, ``aux`` and ``tokens`` are the last slice's.

    Updates ``state`` in place and returns (state, metrics); every
    metric (``ce``, ``aux``, ``tokens``, ``loss``, ``grad_norm``,
    ``lr``) is a device tensor.  The MoE layers' aux loss enters the
    loss (``lm_loss``'s weight 0.01), so the router's gradient carries
    it; a dropped MoE assignment gets no gradient.

    On a ``mesh`` (the state placed, :func:`place_train_state`) each
    microbatch of the global batch is placed by ``batch_spec``, the
    forward takes ``constrain`` and ``moe_c``, and ``grad_constrain``
    pins each microbatch's float32 gradients to the parameters'
    placements (the reduce-scatter to the FSDP layout); the metrics come
    back as plain tensors."""
    with _replicated(mesh):
        state, metrics = _train_step(state, batch, cfg, opt, microbatches,
                                     grad_sync_dtype, constrain, moe_c,
                                     grad_constrain, mesh, batch_spec)
    if mesh is not None:
        metrics = {k: _local(v) for k, v in metrics.items()}
    return state, metrics


def _train_step(state, batch, cfg, opt, microbatches, grad_sync_dtype,
                constrain, moe_c, grad_constrain, mesh, batch_spec):
    params = state["params"]
    named = named_params(params)
    names, leaves = list(named), list(named.values())
    fwd = functools.partial(forward, train=True, constrain=constrain,
                            moe_c=moe_c, mesh=mesh)
    gc = grad_constrain or (lambda names, g: g)

    def place(mb):
        if mesh is None:
            return mb
        return {k: _on_mesh(x, mesh, batch_spec[k]) for k, x in mb.items()}

    if microbatches <= 1:
        loss, metrics, g = _loss_and_grads(params, leaves, place(batch), cfg,
                                           fwd)
        grads = gc(names, [x.to(torch.float32) for x in g])
        del g
    else:
        b = batch["tokens"].shape[0]
        if b % microbatches:
            raise ValueError(f"train_step: batch {b} does not split into "
                             f"{microbatches} microbatches")
        size = b // microbatches
        grads = gc(names, [torch.zeros_like(p, dtype=torch.float32)
                           for p in leaves])
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
        for i in range(microbatches):
            mb = {k: _local(x)[i * size:(i + 1) * size]
                  for k, x in batch.items()}
            loss, metrics, g = _loss_and_grads(params, leaves, place(mb),
                                               cfg, fwd)
            if grad_sync_dtype is not None:
                g = [x.to(grad_sync_dtype) for x in g]
            for acc, x in zip(grads, gc(names, g)):
                acc.add_(x)             # x widened to float32 exactly
            del g
            loss_sum = loss_sum + loss
        for acc in grads:
            acc.div_(microbatches)
        loss = loss_sum / microbatches

    _, _, opt_metrics = adamw_update(
        params, dict(zip(names, grads)), state, opt)
    del grads
    return state, dict(metrics, loss=loss, **opt_metrics)


@torch.no_grad()
def prefill_step(params, batch, cfg, constrain=None, moe_c=None, mesh=None,
                 batch_spec=None):
    """Prefill forward: last-position logits (serving semantics), through
    K4 (on a mesh, each rank's own heads: ``flash_attention_sharded``).
    The lm_head projection runs on the last position only — the full
    (B, T, V) logits tensor never exists.  On a mesh the batch is
    placed by ``batch_spec`` and the logits come back whole."""
    if mesh is not None:
        batch = {k: _on_mesh(x, mesh, batch_spec[k])
                 for k, x in batch.items()}
    with _replicated(mesh):
        logits, _ = forward(params, batch["tokens"], cfg,
                            frontend=batch.get("frontend"),
                            logits_last_only=True, constrain=constrain,
                            moe_c=moe_c, mesh=mesh)
    return _local(logits)


def serve_step(params, token, caches, step_idx: int, cfg, constrain=None,
               moe_c=None, mesh=None, tok_spec=None):
    """One greedy decode step against the caches.  ``step_idx`` is a host
    int.  Returns (next token (B, 1) int32, caches); the argmax keeps the
    first maximum, as ``jnp.argmax`` does.  On a mesh the token is
    placed by ``tok_spec``, the caches are DTensors of
    ``sharding.cache_specs`` (written in place) and the next token comes
    back whole."""
    if mesh is not None:
        token = _on_mesh(token, mesh, tok_spec)
    with _replicated(mesh):
        logits, caches = decode_step(params, token, caches, step_idx, cfg,
                                     constrain=constrain, moe_c=moe_c,
                                     mesh=mesh)
    next_token = torch.argmax(_local(logits[:, -1]), dim=-1).to(torch.int32)
    return next_token[:, None], caches


# ------------------------------------------------------ build_* functions
def default_microbatches(cfg, mesh, global_batch: int) -> int:
    """Largest accumulation factor keeping ≥1 example per data shard
    (one card, ``mesh=None``, is one data shard)."""
    n_b = 1 if mesh is None else shd.n_batch(mesh)
    target = cfg.train_microbatches or 8
    mb = 1
    while (global_batch % (mb * 2) == 0
           and (global_batch // (mb * 2)) % n_b == 0 and mb < target):
        mb *= 2
    return mb


def _placing(fn, place):
    """``fn`` that first places a state not yet on the mesh."""
    @functools.wraps(fn)
    def step(state, *args):
        place(state)
        return fn(state, *args)
    return step


def build_train_step(cfg, mesh=None, opt: OptConfig | None = None,
                     donate: bool = True, global_batch: int | None = None,
                     microbatches: int | None = None,
                     grad_sync_dtype=None):
    """``train_step`` with ``cfg``, ``opt`` (default ``OptConfig()``), the
    microbatch count (default :func:`default_microbatches` of
    ``global_batch``: one example per batch shard by default) and, on a
    ``mesh``, the activation and MoE constrainers of one microbatch and
    the gradients' pin bound.  Returns (``fn(state, batch)``, state
    specs, batch specs); the specs are None without a mesh.  ``donate``
    is the reference's argument and is not read: the step updates the
    state in place."""
    opt = opt or OptConfig()
    n_b = 1 if mesh is None else shd.n_batch(mesh)
    gb = global_batch or n_b
    if microbatches is None:
        microbatches = default_microbatches(cfg, mesh, gb)
    fn = functools.partial(train_step, cfg=cfg, opt=opt,
                           microbatches=microbatches,
                           grad_sync_dtype=grad_sync_dtype)
    if mesh is None:
        return fn, None, None
    sspec = train_state_specs(cfg, mesh)
    bspec = shd.train_batch_specs(mesh,
                                  has_frontend=cfg.frontend_tokens > 0)
    mb_batch = gb // microbatches if gb % microbatches == 0 else gb
    specs = param_placements(cfg, mesh)

    def grad_constrain(names, grads):
        return [g.redistribute(mesh, shd.placements(mesh, specs[k]))
                for k, g in zip(names, grads)]

    fn = functools.partial(
        fn, constrain=shd.activation_constrainer(mesh, mb_batch),
        moe_c=shd.moe_constrainers(cfg, mesh, mb_batch),
        grad_constrain=grad_constrain, mesh=mesh, batch_spec=bspec)

    def place(state):
        if not _placed(state):
            place_train_state(state, cfg, mesh)
    return _placing(fn, place), sspec, bspec


def build_prefill_step(cfg, mesh=None, global_batch: int | None = None):
    """``prefill_step`` with ``cfg`` and, on a ``mesh``, the activation
    and MoE constrainers of ``global_batch`` bound.  Returns
    (``fn(params, batch)``, param specs, batch specs); the specs are None
    without a mesh."""
    fn = functools.partial(prefill_step, cfg=cfg)
    if mesh is None:
        return fn, None, None
    pspec = shd.param_specs(cfg, mesh)
    bspec = shd.train_batch_specs(mesh,
                                  has_frontend=cfg.frontend_tokens > 0)
    bspec = {k: v for k, v in bspec.items() if k != "labels"}
    gb = global_batch or shd.n_batch(mesh)
    fn = functools.partial(
        fn, constrain=shd.activation_constrainer(mesh, gb),
        moe_c=shd.moe_constrainers(cfg, mesh, gb), mesh=mesh,
        batch_spec=bspec)

    def place(params):
        if not shd.is_dtensor(params.embeddings["embed"]):
            place_params(params, cfg, mesh)
    return _placing(fn, place), pspec, bspec


def build_serve_step(cfg, mesh=None, batch: int = 1, max_len: int = 0,
                     donate: bool = True):
    """``serve_step`` with ``cfg`` and, on a ``mesh``, the constrainers of
    ``batch`` bound; the cache's sequence is sharded when ``batch == 1``
    (long context).  Returns (``fn(params, token, caches, step_idx)``,
    param specs, cache specs, token spec); the specs are None without a
    mesh.  ``max_len`` and ``donate`` are the reference's arguments and
    are not read: the caches come sized (the reference does not read
    ``max_len`` either) and are written in place."""
    fn = functools.partial(serve_step, cfg=cfg)
    if mesh is None:
        return fn, None, None, None
    seq_shard = batch == 1
    pspec = shd.param_specs(cfg, mesh)
    cspec = shd.cache_specs(cfg, mesh, batch, seq_shard=seq_shard)
    n_b = shd.n_batch(mesh)
    tok_spec = ((shd._entry(shd.batch_axes(mesh)), None)
                if batch % n_b == 0 and batch >= n_b else (None, None))
    fn = functools.partial(
        fn, constrain=shd.activation_constrainer(mesh, batch),
        moe_c=shd.moe_constrainers(cfg, mesh, batch), mesh=mesh,
        tok_spec=tok_spec)

    @functools.wraps(fn)
    def step(params, token, caches, step_idx):
        if not shd.is_dtensor(params.embeddings["embed"]):
            place_params(params, cfg, mesh)
        if not shd.is_dtensor(caches[0][next(iter(caches[0]))]
                              [next(iter(next(iter(caches[0].values()))))]):
            caches = place_caches(caches, cfg, mesh, batch, seq_shard)
        return fn(params, token, caches, step_idx)
    return step, pspec, cspec, tok_spec
