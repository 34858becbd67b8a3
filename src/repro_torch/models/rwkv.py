"""RWKV-6 (Finch) block: data-dependent decay time-mix and channel-mix —
the JAX package's ``models/rwkv.py`` on torch tensors.

The recurrence S_t = diag(w_t)·S_{t−1} + k_t⊗v_t is evaluated in chunks
(GLA-style), as in the reference: within a chunk every pairwise decay
factor is an exponential of a non-positive log-decay difference, and the
intra-chunk scores factor through the mid-chunk cumulative log-decay
(exponents bounded by |LOG_W_MIN|·c/2), so the (c, c, K) pairwise tensor
is never formed; across chunks a loop carries the (B, H, K, V) float32
state.

Types follow the reference: the token mixes, the projections and the
gate g stay in the layer's type; r, k, v and the decay are float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import normal, silu

__all__ = ["LOG_W_MAX", "LOG_W_MIN", "decode_rwkv_channel_mix",
           "decode_rwkv_time_mix", "init_rwkv_channel_mix",
           "init_rwkv_time_mix", "rwkv_channel_mix", "rwkv_time_mix"]

LOG_W_MIN = -5.0        # decay floor: w ≥ e^-5 ≈ 0.007 — bounds the
LOG_W_MAX = -1e-4       # factored-chunk exponents to e^{|min|·c/2} ≤ e^80


def init_rwkv_time_mix(gen, cfg):
    d = cfg.d_model
    hd = cfg.rwkv_head_size
    h = d // hd
    dt = cfg.torch_dtype
    dev = gen.device
    lora = 64

    def half():
        return torch.full((d,), 0.5, dtype=dt, device=dev)

    return {"mu_r": half(), "mu_k": half(), "mu_v": half(), "mu_g": half(),
            "mu_w": half(),
            "wr": normal(gen, (d, d), d ** -0.5, dt),
            "wk": normal(gen, (d, d), d ** -0.5, dt),
            "wv": normal(gen, (d, d), d ** -0.5, dt),
            "wg": normal(gen, (d, d), d ** -0.5, dt),
            "wo": normal(gen, (d, d),
                         d ** -0.5 / (2 * cfg.n_layers) ** 0.5, dt),
            "w0": torch.zeros((d,), dtype=torch.float32, device=dev),
            "w_lora_a": normal(gen, (d, lora), d ** -0.5, dt),
            "w_lora_b": normal(gen, (lora, d), lora ** -0.5, dt),
            "u": normal(gen, (h, hd), 0.1, torch.float32),
            "ln_g": torch.ones((d,), dtype=dt, device=dev),
            "ln_b": torch.zeros((d,), dtype=dt, device=dev)}


def _shift(x, state=None):
    """Token shift: previous token's features (0 / carried state at t=0)."""
    if state is None:
        return F.pad(x[:, :-1], (0, 0, 1, 0))
    return torch.cat([state[:, None], x[:, :-1]], dim=1)


def _heads(x, hd):
    b, t, d = x.shape
    return x.reshape(b, t, d // hd, hd)


def _group_norm(y, gamma, beta, eps=1e-5):
    """Per-head normalization over the head dim, float32.  y: (B, T, H,
    hd) → (B, T, H·hd)."""
    yf = y.to(torch.float32)
    mu = yf.mean(-1, keepdim=True)
    var = yf.var(-1, keepdim=True, unbiased=False)
    yn = (yf - mu) * torch.rsqrt(var + eps)
    b_, t, h, hd = y.shape
    yn = yn.reshape(b_, t, h * hd)
    return yn * gamma.to(torch.float32) + beta.to(torch.float32)


def _clip_log_w(x):
    """``jnp.clip(x, LOG_W_MIN, LOG_W_MAX)``: min(max(x, lo), hi), whose
    gradient at a bound is 0.5 (``lax.max`` and ``lax.min`` split a tie,
    as ``torch.maximum`` and ``torch.minimum`` do; ``torch.clamp``'s
    would be 1).  The bounds are filled on the device: a copy from the
    host would sync."""
    lo, hi = (torch.full((), b, dtype=x.dtype, device=x.device)
              for b in (LOG_W_MIN, LOG_W_MAX))
    return torch.minimum(torch.maximum(x, lo), hi)


def _rkvgw(params, x, xx, cfg):
    def mix(mu):
        return x + (xx - x) * mu
    hd = cfg.rwkv_head_size
    r = _heads(mix(params["mu_r"]) @ params["wr"], hd)
    k = _heads(mix(params["mu_k"]) @ params["wk"], hd)
    v = _heads(mix(params["mu_v"]) @ params["wv"], hd)
    g = silu(mix(params["mu_g"]) @ params["wg"])
    w_pre = params["w0"] + (torch.tanh(mix(params["mu_w"])
                                       @ params["w_lora_a"])
                            @ params["w_lora_b"]).to(torch.float32)
    log_w = _clip_log_w(-torch.exp(w_pre))
    return (r.to(torch.float32), k.to(torch.float32), v.to(torch.float32),
            g, _heads(log_w, hd))


def _cumulative(lw):
    """Λ, the cumulative log-decays along a chunk (dim 1), each prefix
    the sum of the one before and the next term in lw's type, as
    ``jnp.cumsum`` (a reduce_window) and CUDA's ``torch.cumsum`` add
    them.  The CPU's ``torch.cumsum`` adds in float64 and rounds each
    prefix on its own, so that a difference Λ_i − Λ_j, an exponent of
    the factored scores, carries two roundings of |Λ| instead of those
    of the terms between j and i: it put rwkv6-3b's float32 gradient
    2.4× as far from the float64 one as the reference's."""
    if lw.device.type != "cpu":
        return torch.cumsum(lw, dim=1)
    out = [lw[:, 0]]
    for i in range(1, lw.shape[1]):
        out.append(out[-1] + lw[:, i])
    return torch.stack(out, dim=1)


def _wkv_chunk(r, k, v, lw, u, s0):
    """One chunk, GLA-style factored matmuls.

    r/k/lw: (B, c, H, K); v: (B, c, H, V); s0: (B, H, K, V).
    Intra-chunk scores factor as
      sc[i,j] = Σ_k (r_i e^{Λ_{i−1}−Λ̄}) (k_j e^{Λ̄−Λ_j})
    with Λ̄ the mid-chunk cumulative log-decay: exponents are bounded by
    |LOG_W_MIN|·c/2 ≤ 80, safe in float32.  Returns (y (B, c, H, V),
    s_end)."""
    c = r.shape[1]
    lam = _cumulative(lw)                    # Λ_i inclusive
    lam_m1 = lam - lw                        # Λ_{i-1} (Λ_0 = 0)
    base = lam[:, c // 2][:, None]           # Λ̄ per (B, 1, H, K)
    # state passthrough: exp(Λ_{i-1}) ≤ 1, always safe
    y = torch.einsum("bchk,bhkv->bchv", r * torch.exp(lam_m1), s0)
    # intra-chunk pairs j < i via two bounded factors
    r_f = r * torch.exp(lam_m1 - base)       # (B, c, H, K)
    k_f = k * torch.exp(base - lam)          # (B, c, H, K)
    sc = torch.einsum("bihk,bjhk->bhij", r_f, k_f)     # (B, H, c, c)
    mask = torch.ones((c, c), dtype=torch.bool,
                      device=r.device).tril(diagonal=-1)
    sc = torch.where(mask, sc, 0.0)
    # diagonal bonus u
    bonus = (r * u * k).sum(-1)              # (B, c, H)
    y = y + torch.einsum("bhij,bjhv->bihv", sc, v) + bonus[..., None] * v
    # state update: S' = exp(Λ_last)∘S0 + Σ_j exp(Λ_last − Λ_j) k_j ⊗ v_j
    k_dec = k * torch.exp(lam[:, -1:] - lam)  # exponents ≤ 0, safe
    s_end = (torch.exp(lam[:, -1])[..., None] * s0
             + torch.einsum("bjhk,bjhv->bhkv", k_dec, v))
    return y, s_end


def rwkv_time_mix(params, x, cfg, shift_state=None, wkv_state=None):
    """x: (B, T, D) → (out, (last_x, wkv_state)).  The chunk is
    ``cfg.time_chunk`` (at most T), halved until it divides T."""
    b, t, d = x.shape
    hd = cfg.rwkv_head_size
    h = d // hd
    xx = _shift(x, shift_state)
    r, k, v, g, lw = _rkvgw(params, x, xx, cfg)
    c = min(cfg.time_chunk, t)
    while t % c:
        c //= 2
    s = (torch.zeros((b, h, hd, hd), dtype=torch.float32, device=x.device)
         if wkv_state is None else wkv_state)
    y, s = _wkv(r, k, v, lw, params["u"], s, c)
    y = _group_norm(y, params["ln_g"], params["ln_b"])
    out = (y.to(x.dtype) * g) @ params["wo"]
    return out, (x[:, -1], s)


def _wkv(r, k, v, lw, u, s, c: int):
    """The recurrence over T in chunks of c (c divides T): (y (B, T, H,
    V), final state)."""
    ys = []
    for start in range(0, r.shape[1], c):
        y, s = _wkv_chunk(*(a[:, start:start + c] for a in (r, k, v, lw)),
                          u, s)
        ys.append(y)
    return torch.cat(ys, dim=1), s


def decode_rwkv_time_mix(params, x, cache, cfg):
    """One token.  x: (B, 1, D); cache: {"x": (B, D), "s": (B, H, K, V)},
    updated in place.  Returns (out (B, 1, D), cache)."""
    xx = cache["x"][:, None]
    r, k, v, g, lw = _rkvgw(params, x, xx, cfg)
    s = cache["s"]
    kv = torch.einsum("bchk,bchv->bhkv", k, v)          # c = 1
    y = (torch.einsum("bchk,bhkv->bchv", r, s)
         + (r * params["u"] * k).sum(-1)[..., None] * v)
    s_new = torch.exp(lw[:, 0])[..., None] * s + kv
    y = _group_norm(y, params["ln_g"], params["ln_b"])
    out = (y.to(x.dtype) * g) @ params["wo"]
    cache["x"].copy_(x[:, -1])
    cache["s"].copy_(s_new)
    return out, cache


# ------------------------------------------------------------ channel mix
def init_rwkv_channel_mix(gen, cfg):
    d, f = cfg.d_model, cfg.d_ff
    dt = cfg.torch_dtype
    return {"mu_k": torch.full((d,), 0.5, dtype=dt, device=gen.device),
            "mu_r": torch.full((d,), 0.5, dtype=dt, device=gen.device),
            "wk": normal(gen, (d, f), d ** -0.5, dt),
            "wv": normal(gen, (f, d), f ** -0.5, dt),
            "wr": normal(gen, (d, d), d ** -0.5, dt)}


def rwkv_channel_mix(params, x, shift_state=None):
    """x: (B, T, D) → (out, last_x)."""
    xx = _shift(x, shift_state)
    xk = x + (xx - x) * params["mu_k"]
    xr = x + (xx - x) * params["mu_r"]
    kk = torch.square(torch.relu(xk @ params["wk"]))
    return torch.sigmoid(xr @ params["wr"]) * (kk @ params["wv"]), x[:, -1]


def decode_rwkv_channel_mix(params, x, cache):
    """One token; ``cache`` {"x": (B, D)} updated in place."""
    out, last = rwkv_channel_mix(params, x, shift_state=cache["x"])
    cache["x"].copy_(last)
    return out, cache
