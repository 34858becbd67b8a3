"""Shared model layers: norms, MLPs, rotary embeddings, embeddings — the
JAX package's ``models/layers.py`` on torch tensors.

Initialisers draw from a ``torch.Generator`` (the JAX package splits
PRNG keys), so the same seed gives other weights than the JAX package's;
tests carry the JAX weights across with ``convert.lm_params``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def normal(gen, shape, scale: float, dtype):
    """N(0, 1)·scale in float32 from ``gen``, cast to ``dtype`` on the
    generator's device."""
    return (torch.randn(shape, generator=gen, device=gen.device,
                        dtype=torch.float32) * scale).to(dtype)


def rms_norm(x, scale, eps: float = 1e-6):
    """RMS norm computed in float32, cast back to x's type."""
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * scale.to(torch.float32)).to(dt)


def silu(x):
    """SiLU as ``jax.nn.silu`` rounds it: x·(1 / (1 + e^−x)), each of
    its steps rounded to x's type, bit for bit the reference's in
    bfloat16.  ``F.silu`` rounds once; over jamba's Mamba, SwiGLU and
    expert SiLUs that puts a bfloat16 train step's grad norm ~7× as far
    from the reference's as the reference's own rounding spread.
    float32 takes ``F.silu``."""
    if x.dtype == torch.float32:
        return F.silu(x)
    return x * (1 / (1 + torch.exp(-x)))


def init_mlp(gen, d_model: int, d_ff: int, mlp_type: str, dtype):
    s_in = d_model ** -0.5
    s_out = d_ff ** -0.5
    p = {"w1": normal(gen, (d_model, d_ff), s_in, dtype),
         "w2": normal(gen, (d_ff, d_model), s_out, dtype)}
    if mlp_type == "swiglu":
        p["w3"] = normal(gen, (d_model, d_ff), s_in, dtype)
    return p


def mlp(params, x, mlp_type: str):
    if mlp_type == "swiglu":
        h = silu(x @ params["w1"]) * (x @ params["w3"])
    else:  # gelu: jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ params["w1"], approximate="tanh")
    return h @ params["w2"]


# -------------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float):
    """x: (..., T, H, hd); positions: broadcastable to (..., T)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # (hd/2,)
    ang = positions[..., None].to(torch.float32) * freqs    # (..., T, hd/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# -------------------------------------------------------------- embeddings
def init_embeddings(gen, padded_vocab: int, d_model: int, dtype):
    return {
        "embed": normal(gen, (padded_vocab, d_model), 0.02, dtype),
        "lm_head": normal(gen, (padded_vocab, d_model), d_model ** -0.5,
                          dtype),
        "final_norm": torch.ones((d_model,), dtype=dtype, device=gen.device),
    }


def embed_tokens(params, tokens):
    return params["embed"][tokens]


def lm_logits(params, h, vocab_size: int):
    """Final norm + projection; the padded vocab tail is set to the
    type's lowest value."""
    h = rms_norm(h, params["final_norm"])
    logits = h @ params["lm_head"].T
    padded = logits.shape[-1]
    if padded > vocab_size:
        mask = torch.arange(padded, device=logits.device) < vocab_size
        logits = torch.where(mask, logits,
                             torch.finfo(logits.dtype).min)
    return logits
