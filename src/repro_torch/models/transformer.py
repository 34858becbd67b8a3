"""Dense decoder: embeddings + a list of (attention, MLP) layers + LM head
— the JAX package's ``models/transformer.py`` for dense decoders.

The JAX model stacks each period position's parameters over n_periods
and scans over them; the port holds one :class:`DecoderLayer` per layer
in a ``ModuleList`` and runs a Python loop over them.  Layer i of the
port is period i // p, position i % p of the JAX model
(``convert.lm_params`` carries the JAX weights across that way).

Only the (attn, mlp) layer kind is ported: Mamba, RWKV and MoE layers
and modality frontends raise ``NotImplementedError`` (ROADMAP item 7).

Parameters are frozen (``requires_grad=False``) as built; serving runs
them under ``inference_mode``.  ``train.steps.init_train_state`` makes a
training copy's parameters trainable, and ``forward(..., train=True)``
is the training forward: attention through the blocked twin
(``attention.blocked_flash_attention``, which autograd follows) and each
layer rematerialised as ``cfg.remat`` says (a period is one layer in a
dense decoder):

  "full" — ``torch.utils.checkpoint.checkpoint`` around each layer
           (non-reentrant): only the layer's input is kept, the layer
           runs again in the backward;
  "dots" — a selective checkpoint around each layer that keeps the
           outputs of the projection matmuls and recomputes the rest,
           the counterpart of ``dots_with_no_batch_dims_saveable``;
  "none" — autograd keeps every activation.

Decode caches are a list with one ``{"attn": {"k", "v"}}`` per layer;
:func:`decode_step` writes into them in place.
"""

from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..runtime.device import resolve_device
from .attention import (_qkv, attention_block, decode_attention_block,
                        flash_attention, init_attention, init_kv_cache)
from .layers import (embed_tokens, init_embeddings, init_mlp, lm_logits, mlp,
                     rms_norm)

__all__ = ["DecoderLayer", "Transformer", "check_supported", "decode_step",
           "forward", "init_caches", "init_params", "prefill_with_cache"]


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` unless every layer of ``cfg`` is an
    attention + MLP layer and no modality frontend is configured."""
    kinds = sorted({cfg.layer_kind(i) for i in range(cfg.n_layers)})
    if kinds != [("attn", "mlp")] or cfg.frontend_tokens:
        raise NotImplementedError(
            f"{cfg.name}: layer kinds {kinds}, frontend_tokens="
            f"{cfg.frontend_tokens}; the port runs dense (attn, mlp) "
            f"decoders only — Mamba, RWKV, MoE and modality frontends wait "
            f"for ROADMAP item 7")


def _frozen(t):
    return nn.Parameter(t, requires_grad=False)


class DecoderLayer(nn.Module):
    """One (attention, MLP) layer: norm1, norm2, ``mixer`` {wq, wk, wv,
    wo} and ``ffn`` {w1, w2[, w3]}, held as frozen parameters."""

    def __init__(self, p: dict):
        super().__init__()
        self.norm1 = _frozen(p["norm1"])
        self.norm2 = _frozen(p["norm2"])
        self.mixer = nn.ParameterDict({k: _frozen(t)
                                       for k, t in p["mixer"].items()})
        self.ffn = nn.ParameterDict({k: _frozen(t)
                                     for k, t in p["ffn"].items()})


class Transformer(nn.Module):
    """The model's parameters: ``embeddings`` {embed, lm_head,
    final_norm} and ``layers``.  Calling it runs :func:`forward`."""

    def __init__(self, cfg, embeddings: dict, layers: list):
        super().__init__()
        check_supported(cfg)
        if len(layers) != cfg.n_layers:
            raise ValueError(f"{cfg.name}: {len(layers)} layers, expected "
                             f"{cfg.n_layers}")
        self.cfg = cfg
        self.embeddings = nn.ParameterDict({k: _frozen(t)
                                            for k, t in embeddings.items()})
        self.layers = nn.ModuleList(DecoderLayer(p) for p in layers)

    def forward(self, tokens, logits_last_only: bool = False):
        return forward(self, tokens, self.cfg,
                       logits_last_only=logits_last_only)


# ---------------------------------------------------------------- params
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
    for _ in range(cfg.n_layers):
        ones = torch.ones((cfg.d_model,), dtype=dt, device=device)
        layers.append({"norm1": ones, "norm2": ones.clone(),
                       "mixer": init_attention(gen, cfg),
                       "ffn": init_mlp(gen, cfg.d_model, cfg.d_ff,
                                       cfg.mlp_type, dt)})
    return Transformer(cfg, emb, layers)


def _positions(b: int, t: int, device):
    return torch.arange(t, device=device).expand(b, t)


def _layer_apply(p, h, positions, cfg, train: bool = False):
    h = h + attention_block(p.mixer, rms_norm(h, p.norm1), positions, cfg,
                            train=train)
    return h + mlp(p.ffn, rms_norm(h, p.norm2), cfg.mlp_type)


def _dots_policy(ctx, op, *args, **kwargs):
    """Keep the projection matmuls' outputs, recompute the rest.  The
    projections reach the dispatcher as ``mm`` (``x @ w``) or as a
    ``bmm`` of one batch (an einsum without batch axes); the attention's
    einsums are ``bmm`` over B·KV·q blocks, recomputed like the JAX
    policy's batched dots (a call with B·KV·blocks = 1 would keep them
    too: more memory, the same values)."""
    if op is torch.ops.aten.mm.default or (
            op is torch.ops.aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_DOTS = functools.partial(create_selective_checkpoint_contexts, _dots_policy)


def _train_layer(p, h, positions, cfg):
    """One layer of the training forward under ``cfg.remat``."""
    if cfg.remat == "none":
        return _layer_apply(p, h, positions, cfg, train=True)
    if cfg.remat not in ("full", "dots"):
        raise ValueError(f"{cfg.name}: remat {cfg.remat!r}; choose none, "
                         f"dots or full")
    # the layer draws no random numbers: no RNG state to keep
    extra = {"context_fn": _DOTS} if cfg.remat == "dots" else {}
    return checkpoint(_layer_apply, p, h, positions, cfg, True,
                      use_reentrant=False, preserve_rng_state=False,
                      **extra)


# --------------------------------------------------------------- forward
def forward(params, tokens, cfg, frontend=None,
            logits_last_only: bool = False, train: bool = False):
    """Train/prefill forward.  tokens: (B, T) int.  ``logits_last_only``:
    the projection runs on the last position only.  ``train``: the
    training forward (blocked attention under autograd, ``cfg.remat``);
    otherwise attention is K4.  A modality ``frontend`` is not ported.
    Returns (logits (B, T, V_padded), aux_loss 0)."""
    if frontend is not None:
        raise NotImplementedError(
            f"{cfg.name}: modality frontends wait for ROADMAP item 7")
    h = embed_tokens(params.embeddings, tokens)
    b, t, _ = h.shape
    positions = _positions(b, t, h.device)
    for p in params.layers:
        h = (_train_layer(p, h, positions, cfg) if train
             else _layer_apply(p, h, positions, cfg))
    if logits_last_only:
        h = h[:, -1:]
    logits = lm_logits(params.embeddings, h, cfg.vocab_size)
    return logits, torch.zeros((), dtype=torch.float32, device=h.device)


# ---------------------------------------------------------------- decode
def init_caches(batch: int, cfg, max_len: int, device=None):
    check_supported(cfg)
    return [{"attn": init_kv_cache(batch, cfg, max_len, cfg.torch_dtype,
                                   device)}
            for _ in range(cfg.n_layers)]


def decode_step(params, token, caches, step: int, cfg):
    """One decode step.  token: (B, 1) int; ``step``: host int, the
    tokens already in the caches (updated in place).  Returns (logits
    (B, 1, V), caches)."""
    h = embed_tokens(params.embeddings, token)
    for p, c in zip(params.layers, caches):
        out, c["attn"] = decode_attention_block(
            p.mixer, rms_norm(h, p.norm1), c["attn"], step, cfg)
        h = h + out
        h = h + mlp(p.ffn, rms_norm(h, p.norm2), cfg.mlp_type)
    logits = lm_logits(params.embeddings, h, cfg.vocab_size)
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
        x = rms_norm(h, p.norm1)
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
        h = h + mlp(p.ffn, rms_norm(h, p.norm2), cfg.mlp_type)
    logits = lm_logits(params.embeddings, h, cfg.vocab_size)
    return logits, caches
