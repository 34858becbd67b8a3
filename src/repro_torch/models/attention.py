"""GQA attention: K4 flash attention for prefill, cached decode step — the
JAX package's ``models/attention.py`` on torch tensors.

Layouts are the JAX package's: projections wq (d, H, hd), wk and wv
(d, KV, hd), wo (H, hd, d); q (B, T, H, hd); k, v and the caches
(B, S, KV, hd).

  * prefill attention is K4 (:func:`~repro_torch.kernels.flash_attention.
    flash_attention_kernel`) for both :func:`attention_block` and the
    model's prefill; on one card there is no mesh, so the JAX package's
    pure-JAX blocked ``flash_attention`` and its sharded Pallas branch
    collapse into this one core (CPU tensors take K4's plain version),
  * decode attends a (B, 1) query against the cache with torch ops, as
    the JAX package's einsums do; ``step`` is a host int, so choosing the
    cache slot costs no sync, and the cache is updated in place (the JAX
    package returns a new one).
"""

from __future__ import annotations

import torch

from ..kernels.flash_attention import flash_attention_kernel
from .layers import apply_rope, normal

NEG_INF = -1e30


def init_attention(gen, cfg):
    d, kv, hd = cfg.d_model, cfg.n_kv_heads, cfg.head_dim_
    h = cfg.n_heads_eff
    s = d ** -0.5
    so = (cfg.n_heads * hd) ** -0.5 / (2 * cfg.n_layers) ** 0.5
    dt = cfg.torch_dtype
    wq = normal(gen, (d, h, hd), s, dt)
    wk = normal(gen, (d, kv, hd), s, dt)
    wv = normal(gen, (d, kv, hd), s, dt)
    wo = normal(gen, (h, hd, d), so, dt)
    if h != cfg.n_heads:
        # padded heads sit at the tail of each KV group (head layout is
        # (kv, g)-major); zero wo rows make them exactly inert
        g_eff = h // kv
        g_real = cfg.n_heads // kv
        inert = (torch.arange(h, device=wo.device) % g_eff) >= g_real
        wo = torch.where(inert[:, None, None], 0.0, wo)
    return {"wq": wq, "wk": wk, "wv": wv, "wo": wo}


def _qkv(params, x, positions, cfg):
    q = torch.einsum("btd,dhk->bthk", x, params["wq"])
    k = torch.einsum("btd,dhk->bthk", x, params["wk"])
    v = torch.einsum("btd,dhk->bthk", x, params["wv"])
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def flash_attention(q, k, v, cfg, q_offset: int = 0):
    """Causal (optionally sliding-window) attention through K4.

    q: (B, T, H, hd); k, v: (B, T, KV, hd).  Returns (B, T, H, hd).  A
    prefill continuation (``q_offset`` ≠ 0) is not ported: nothing on the
    serving path uses it."""
    if q_offset:
        raise NotImplementedError(
            f"flash_attention: q_offset={q_offset} (prefill continuation) "
            f"is not ported; K4 attends positions 0..T-1 of q over the same "
            f"positions of k and v")
    return flash_attention_kernel(q.contiguous(), k.contiguous(),
                                  v.contiguous(), window=cfg.sliding_window)


def attention_block(params, x, positions, cfg):
    """Full attention sub-layer for prefill: qkv → K4 → out proj."""
    q, k, v = _qkv(params, x, positions, cfg)
    o = flash_attention(q, k, v, cfg)
    return torch.einsum("bthk,hkd->btd", o, params["wo"])


# ------------------------------------------------------------------ decode
def init_kv_cache(batch: int, cfg, max_len: int, dtype, device):
    """Cache length: SWA models only keep the window (ring buffer)."""
    s = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    kv, hd = cfg.n_kv_heads, cfg.head_dim_
    return {"k": torch.zeros((batch, s, kv, hd), dtype=dtype, device=device),
            "v": torch.zeros((batch, s, kv, hd), dtype=dtype, device=device)}


def decode_attention_block(params, x, cache, step: int, cfg):
    """One-token decode.  x: (B, 1, D); ``step``: host int, the tokens
    already in the cache.  Writes this token's k and v into ``cache`` in
    place and returns (out (B, 1, D), cache)."""
    b = x.shape[0]
    s_cache = cache["k"].shape[1]
    positions = torch.full((b, 1), step, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(params, x, positions, cfg)
    slot = step % s_cache if cfg.sliding_window else step
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    ck, cv = cache["k"], cache["v"]

    h, kvh, hd = q.shape[2], cfg.n_kv_heads, cfg.head_dim_
    g = h // kvh
    qg = q.reshape(b, 1, kvh, g, hd).permute(0, 2, 3, 1, 4)
    # scores in the cache's type, then float32, as the JAX einsum
    s = torch.einsum("bkgqh,bskh->bkgqs", qg, ck).to(torch.float32)
    s = s * hd ** -0.5
    idx = torch.arange(s_cache, device=x.device)
    valid = idx <= slot
    if cfg.sliding_window and step >= s_cache:
        valid = torch.ones_like(valid)
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskh->bkgqh", p.to(cv.dtype), cv)
    o = o.permute(0, 3, 1, 2, 4).reshape(b, 1, h, hd)
    out = torch.einsum("bthk,hkd->btd", o, params["wo"])
    return out, cache
