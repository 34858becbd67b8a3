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
from .attention import (_qkv, attention_block, decode_attention_block,
                        flash_attention, init_attention, init_kv_cache)
from .layers import (embed_tokens, init_embeddings, init_mlp, lm_logits, mlp,
                     rms_norm)
from .mamba import (_mamba_prefill, decode_mamba_block, init_mamba,
                    init_mamba_cache, mamba_block)
from .moe import init_moe, moe_ffn
from .rwkv import (decode_rwkv_channel_mix, decode_rwkv_time_mix,
                   init_rwkv_channel_mix, init_rwkv_time_mix,
                   rwkv_channel_mix, rwkv_time_mix)

__all__ = ["DecoderLayer", "Transformer", "check_supported", "decode_step",
           "forward", "init_caches", "init_params", "prefill_with_cache"]

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


def _layer_apply(p, h, positions, cfg, train: bool = False):
    """One layer of the forward: (h, the MoE aux loss or None)."""
    mixer, ffn = p.kind
    x = rms_norm(h, p.norm1)
    if mixer == "attn":
        h = h + attention_block(p.mixer, x, positions, cfg, train=train)
    elif mixer == "mamba":
        h = h + mamba_block(p.mixer, x, cfg)
    else:
        h = h + rwkv_time_mix(p.mixer, x, cfg)[0]
    x = rms_norm(h, p.norm2)
    if ffn == "mlp":
        return h + mlp(p.ffn, x, cfg.mlp_type), None
    if ffn == "moe":
        out, aux = moe_ffn(p.ffn, x, cfg)
        return h + out, aux
    return h + rwkv_channel_mix(p.ffn, x)[0], None


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
    """Train/prefill forward.  tokens: (B, T) int; ``frontend``: optional
    (B, F, D) modality embeddings put in front of the tokens'.
    ``logits_last_only``: the projection runs on the last position only.
    ``train``: the training forward (blocked attention under autograd,
    ``cfg.remat``); otherwise attention is K4.  Returns (logits (B, F +
    T, V_padded), aux_loss: the MoE layers' summed, float32)."""
    h = embed_tokens(params.embeddings, tokens)
    if frontend is not None:
        h = torch.cat([frontend.to(h.dtype), h], dim=1)
    b, t, _ = h.shape
    positions = _positions(b, t, h.device)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for p in params.layers:
        h, a = (_train_layer(p, h, positions, cfg) if train
                else _layer_apply(p, h, positions, cfg))
        if a is not None:
            aux = aux + a
    if logits_last_only:
        h = h[:, -1:]
    logits = lm_logits(params.embeddings, h, cfg.vocab_size)
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


def decode_step(params, token, caches, step: int, cfg):
    """One decode step.  token: (B, 1) int; ``step``: host int, the
    tokens already in the caches (updated in place).  Returns (logits
    (B, 1, V), caches)."""
    h = embed_tokens(params.embeddings, token)
    for p, c in zip(params.layers, caches):
        mixer, ffn = p.kind
        x = rms_norm(h, p.norm1)
        if mixer == "attn":
            out, _ = decode_attention_block(p.mixer, x, c["attn"], step, cfg)
        elif mixer == "mamba":
            out, _ = decode_mamba_block(p.mixer, x, c["mamba"], cfg)
        else:
            out, _ = decode_rwkv_time_mix(p.mixer, x, c["rwkv"], cfg)
        h = h + out
        x = rms_norm(h, p.norm2)
        if ffn == "mlp":
            h = h + mlp(p.ffn, x, cfg.mlp_type)
        elif ffn == "moe":
            h = h + moe_ffn(p.ffn, x, cfg)[0]
        else:
            h = h + decode_rwkv_channel_mix(p.ffn, x, c["cmix"])[0]
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
