"""Step functions: train, prefill, decode — the JAX package's
``train/steps.py`` on one card.

The JAX package's ``build_*`` functions return a jitted function with its
shardings; here they return the step with ``cfg`` and the optimizer
bound, since one card has no mesh (``train_state_specs`` and the
``build_*`` sharding outputs wait with the XLA-bound part of ROADMAP queue
1 item 7).  The JAX jit donates the train state; :func:`train_step`
updates it in place instead and returns the same objects.  Every shipped
config trains: attention, Mamba and RWKV mixers, MLP, MoE and
channel-mix FFNs, with a modality frontend's embeddings in the batch.

A train state is ``{"params": Transformer, "m": {name: f32}, "v":
{name: f32}, "step": int32 0-d}``, the moments named as the module's
``named_parameters()``.
"""

from __future__ import annotations

import functools

import torch

from ..models.transformer import decode_step, forward, init_params
from .loss import lm_loss
from .optimizer import (OptConfig, adamw_update, init_opt_state,
                        named_params)

__all__ = ["build_prefill_step", "build_serve_step", "build_train_step",
           "default_microbatches", "init_train_state", "prefill_step",
           "serve_step", "train_step"]


def init_train_state(seed: int, cfg, device=None):
    """Random parameters from ``seed`` (``init_params``), made trainable,
    zero moments and step 0.  Every layer kind the port runs
    (``models.transformer.check_supported``) trains."""
    params = init_params(seed, cfg, device=device)
    params.requires_grad_(True)
    opt = init_opt_state(params)
    return {"params": params, "m": opt["m"], "v": opt["v"],
            "step": opt["step"]}


def _loss_and_grads(params, leaves, mb, cfg):
    """Loss, metrics and the parameters' gradients (in the parameters'
    type) of one (micro)batch through the training forward."""
    loss, metrics = lm_loss(params, mb, cfg,
                            functools.partial(forward, train=True))
    grads = torch.autograd.grad(loss, leaves)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def train_step(state, batch, cfg, opt: OptConfig, microbatches: int = 1,
               grad_sync_dtype=None):
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
    it; a dropped MoE assignment gets no gradient."""
    params = state["params"]
    named = named_params(params)
    names, leaves = list(named), list(named.values())
    if microbatches <= 1:
        loss, metrics, g = _loss_and_grads(params, leaves, batch, cfg)
        grads = [x.to(torch.float32) for x in g]
        del g
    else:
        b = batch["tokens"].shape[0]
        if b % microbatches:
            raise ValueError(f"train_step: batch {b} does not split into "
                             f"{microbatches} microbatches")
        size = b // microbatches
        grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in leaves]
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
        for i in range(microbatches):
            mb = {k: x[i * size:(i + 1) * size] for k, x in batch.items()}
            loss, metrics, g = _loss_and_grads(params, leaves, mb, cfg)
            for acc, x in zip(grads, g):
                if grad_sync_dtype is not None:
                    x = x.to(grad_sync_dtype)
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
def prefill_step(params, batch, cfg):
    """Prefill forward: last-position logits (serving semantics), through
    K4.  The lm_head projection runs on the last position only — the
    full (B, T, V) logits tensor never exists."""
    logits, _ = forward(params, batch["tokens"], cfg,
                        frontend=batch.get("frontend"),
                        logits_last_only=True)
    return logits


def serve_step(params, token, caches, step_idx: int, cfg):
    """One greedy decode step against the caches.  ``step_idx`` is a host
    int.  Returns (next token (B, 1) int32, caches); the argmax keeps the
    first maximum, as ``jnp.argmax`` does."""
    logits, caches = decode_step(params, token, caches, step_idx, cfg)
    next_token = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    return next_token[:, None], caches


# ------------------------------------------------------ build_* functions
def default_microbatches(cfg, global_batch: int) -> int:
    """Largest accumulation factor keeping ≥1 example per data shard; one
    card is one data shard."""
    n_b = 1
    target = cfg.train_microbatches or 8
    mb = 1
    while (global_batch % (mb * 2) == 0
           and (global_batch // (mb * 2)) % n_b == 0 and mb < target):
        mb *= 2
    return mb


def build_train_step(cfg, opt: OptConfig | None = None,
                     global_batch: int | None = None,
                     microbatches: int | None = None,
                     grad_sync_dtype=None):
    """``train_step`` with ``cfg``, ``opt`` (default ``OptConfig()``) and
    the microbatch count (default :func:`default_microbatches` of
    ``global_batch``, 1 example by default) bound: ``fn(state, batch)``."""
    opt = opt or OptConfig()
    if microbatches is None:
        microbatches = default_microbatches(cfg, global_batch or 1)
    return functools.partial(train_step, cfg=cfg, opt=opt,
                             microbatches=microbatches,
                             grad_sync_dtype=grad_sync_dtype)


def build_prefill_step(cfg):
    """``prefill_step`` with ``cfg`` bound: ``fn(params, batch)``."""
    return functools.partial(prefill_step, cfg=cfg)


def build_serve_step(cfg):
    """``serve_step`` with ``cfg`` bound: ``fn(params, token, caches,
    step_idx)``."""
    return functools.partial(serve_step, cfg=cfg)
