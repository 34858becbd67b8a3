"""Mamba-1 selective SSM block (Jamba's sequence mixer) — the JAX
package's ``models/mamba.py`` on torch tensors.

The selective scan is *time-chunked*, as in the reference: a loop over
T/chunk chunks carrying the (B, d_inner, d_state) float32 state, with a
parallel prefix scan inside each chunk.  The reference's
``lax.associative_scan`` becomes a Hillis–Steele scan over the chunk
axis (log₂ chunk passes) with the same combine, (a_l, b_l), (a_r, b_r) →
(a_r·a_l, a_r·b_l + b_r); it adds the same float32 terms in another
order.  Only one chunk's (B, c, d_inner, d_state) tensors are live at a
time.  The depthwise causal conv is d_conv static shifts, computed in
float32 and cast back.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import normal, silu

__all__ = ["decode_mamba_block", "init_mamba", "init_mamba_cache",
           "mamba_block"]


def init_mamba(gen, cfg):
    d, di = cfg.d_model, cfg.d_inner
    ds, dc, dr = cfg.mamba_d_state, cfg.mamba_d_conv, cfg.dt_rank_
    dt = cfg.torch_dtype
    dev = gen.device
    # S4D-real A init: -(1..ds) per channel
    a = torch.arange(1, ds + 1, dtype=torch.float32,
                     device=dev)[None, :].repeat(di, 1)
    return {"w_in": normal(gen, (d, 2 * di), d ** -0.5, dt),
            "conv_w": normal(gen, (dc, di), dc ** -0.5, dt),
            "conv_b": torch.zeros((di,), dtype=dt, device=dev),
            "w_x": normal(gen, (di, dr + 2 * ds), di ** -0.5, dt),
            "w_dt": normal(gen, (dr, di), dr ** -0.5, dt),
            "b_dt": torch.full((di,), -4.6, dtype=dt, device=dev),
            "a_log": torch.log(a),                   # (di, ds) float32
            "d_skip": torch.ones((di,), dtype=torch.float32, device=dev),
            "w_out": normal(gen, (di, d), di ** -0.5, dt)}


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv via static shifts.  x: (B, T, di); w:
    (dc, di); state: (B, dc − 1, di) trailing context or None.  Returns
    (out in x's type, new state (B, dc − 1, di))."""
    dc = w.shape[0]
    if state is not None:
        x_ext = torch.cat([state, x], dim=1)
    else:
        x_ext = F.pad(x, (0, 0, dc - 1, 0))
    t = x.shape[1]
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(dc):
        out = out + x_ext[:, i:i + t].to(torch.float32) \
            * w[i].to(torch.float32)
    new_state = x_ext[:, -(dc - 1):] if dc > 1 else None
    return (out + b.to(torch.float32)).to(x.dtype), new_state


def _ssm_params(params, xc, cfg):
    """Per-token SSM tensors from the conv output xc (B, T, di): the
    decay abar and input bx (B, T, di, ds) and C (B, T, ds), float32.
    The projections run in the layer's type, softplus in float32."""
    ds, dr = cfg.mamba_d_state, cfg.dt_rank_
    proj = xc @ params["w_x"]                        # (B, T, dr + 2ds)
    dt_r, b_mat, c_mat = torch.split(proj, [dr, ds, ds], dim=-1)
    delta = F.softplus((dt_r @ params["w_dt"]).to(torch.float32)
                       + params["b_dt"].to(torch.float32))  # (B, T, di)
    a = -torch.exp(params["a_log"])                  # (di, ds)
    abar = torch.exp(delta[..., None] * a)           # (B, T, di, ds)
    bx = (delta[..., None] * b_mat[:, :, None, :].to(torch.float32)
          * xc[..., None].to(torch.float32))         # (B, T, di, ds)
    return abar, bx, c_mat.to(torch.float32)


def _prefix_scan(a, b):
    """Inclusive scan over axis 1 of h_t = a_t·h_{t−1} + b_t from h = 0:
    Hillis–Steele, log₂ c passes of the combine (a_l, b_l), (a_r, b_r) →
    (a_r·a_l, a_r·b_l + b_r).  Returns (Π a, h) at every step."""
    c = a.shape[1]
    s = 1
    while s < c:
        b = torch.cat([b[:, :s], a[:, s:] * b[:, :-s] + b[:, s:]], dim=1)
        a = torch.cat([a[:, :s], a[:, s:] * a[:, :-s]], dim=1)
        s *= 2
    return a, b


def _chunk_len(cfg, t: int) -> int:
    """``cfg.time_chunk`` (at most T), halved until it divides T."""
    c = min(cfg.time_chunk, t)
    while t % c:
        c //= 2
    return c


def _chunked_ssm(params, xc, cfg, h0):
    """y_t = C_t·h_t, h_t = abar_t∘h_{t−1} + bx_t — chunked scan.

    The (B, c, di, ds) decay and input tensors are built inside the loop
    from a (B, c, di) slice of xc, so only one chunk's 4-D tensors are
    live.  xc: (B, T, di); h0: (B, di, ds).  Returns (y (B, T, di)
    float32, h_final)."""
    t = xc.shape[1]
    c = _chunk_len(cfg, t)
    h = h0
    ys = []
    for start in range(0, t, c):
        # a contiguous chunk: its projection reaches the dispatcher as one
        # ``mm`` (a strided slice would make it a ``bmm`` over B, which
        # the "dots" remat policy recomputes; the reference's keeps it)
        abar, bx, cm = _ssm_params(
            params, xc[:, start:start + c].contiguous(), cfg)
        aa, bb = _prefix_scan(abar, bx)
        h_all = aa * h[:, None] + bb                 # states at each step
        ys.append(torch.einsum("btds,bts->btd", h_all, cm))
        h = h_all[:, -1]
    return torch.cat(ys, dim=1), h


def mamba_block(params, x, cfg):
    """Train/prefill: x (B, T, D) → (B, T, D)."""
    out, _ = _mamba_prefill(params, x, cfg)
    return out


def _mamba_prefill(params, x, cfg):
    """The block over a whole prompt, and the decode cache it leaves:
    the last d_conv − 1 inputs of the conv (zeros in front when T is
    shorter) and the final SSM state."""
    b, t, _ = x.shape
    dc = cfg.mamba_d_conv
    xz = x @ params["w_in"]
    x_p, z = torch.chunk(xz, 2, dim=-1)
    xc, _ = _causal_conv(x_p, params["conv_w"], params["conv_b"])
    conv_state = F.pad(x_p, (0, 0, max(dc - 1 - t, 0), 0))[:, -(dc - 1):]
    xc = silu(xc)
    h0 = torch.zeros((b, cfg.d_inner, cfg.mamba_d_state),
                     dtype=torch.float32, device=x.device)
    y, h_f = _chunked_ssm(params, xc, cfg, h0)
    y = y + params["d_skip"] * xc.to(torch.float32)
    y = y.to(x.dtype) * silu(z)
    return y @ params["w_out"], {"conv": conv_state, "ssm": h_f}


# ------------------------------------------------------------------ decode
def init_mamba_cache(batch: int, cfg, dtype, device):
    di, ds, dc = cfg.d_inner, cfg.mamba_d_state, cfg.mamba_d_conv
    return {"conv": torch.zeros((batch, dc - 1, di), dtype=dtype,
                                device=device),
            "ssm": torch.zeros((batch, di, ds), dtype=torch.float32,
                               device=device)}


def decode_mamba_block(params, x, cache, cfg):
    """One-token step.  x: (B, 1, D).  Writes the new conv and SSM state
    into ``cache`` in place and returns (out (B, 1, D), cache)."""
    xz = x @ params["w_in"]
    x_p, z = torch.chunk(xz, 2, dim=-1)
    xc, conv_state = _causal_conv(x_p, params["conv_w"], params["conv_b"],
                                  state=cache["conv"])
    xc = silu(xc)
    abar, bx, c_mat = _ssm_params(params, xc, cfg)     # T = 1
    h = abar[:, 0] * cache["ssm"] + bx[:, 0]           # (B, di, ds)
    y = torch.einsum("bds,bs->bd", h, c_mat[:, 0])[:, None]
    y = y + params["d_skip"] * xc.to(torch.float32)
    y = y.to(x.dtype) * silu(z)
    out = y @ params["w_out"]
    cache["conv"].copy_(conv_state)
    cache["ssm"].copy_(h)
    return out, cache
