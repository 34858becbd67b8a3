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

Every step but two is elementwise in d_inner: ``w_x`` contracts it (the
projection to dt_rank + 2·d_state) and ``w_out`` does.  The block is
therefore two halves, :func:`mamba_split_in` and :func:`mamba_split_out`,
which run on a slice of d_inner and each return its slice's part of
those two sums.  :func:`mamba_block` and :func:`decode_mamba_block` run
them on the whole of d_inner; on a mesh with d_inner over ``model`` each
rank runs them on its slice and the parts are summed by two all-reduces
(``models.transformer._mamba_sharded``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import normal, silu

__all__ = ["decode_mamba_block", "init_mamba", "init_mamba_cache",
           "mamba_block", "mamba_split_in", "mamba_split_out"]


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


def _ssm_params(params, xc, proj, cfg):
    """Per-token SSM tensors from the conv output xc (B, T, di) and the
    summed projection ``proj`` = xc @ w_x (B, T, dr + 2ds): the decay
    abar and input bx (B, T, di, ds) and C (B, T, ds), float32.  The
    projection to delta runs in the layer's type, softplus in float32."""
    ds, dr = cfg.mamba_d_state, cfg.dt_rank_
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


def _chunked_ssm(params, xc, proj, cfg, h0):
    """y_t = C_t·h_t, h_t = abar_t∘h_{t−1} + bx_t — chunked scan.

    The (B, c, di, ds) decay and input tensors are built inside the loop
    from a (B, c, di) slice of xc and of ``proj`` = xc @ w_x (B, T, dr +
    2ds), so only one chunk's 4-D tensors are live.  h0: (B, di, ds).
    Returns (y (B, T, di) float32, h_final)."""
    t = xc.shape[1]
    c = _chunk_len(cfg, t)
    h = h0
    ys = []
    for start in range(0, t, c):
        # a contiguous chunk of the projection: dt_r @ w_dt reaches the
        # dispatcher as one ``mm`` (a strided slice would make it a
        # ``bmm`` over B, which the "dots" remat policy recomputes; the
        # reference's keeps it)
        abar, bx, cm = _ssm_params(params, xc[:, start:start + c],
                                   proj[:, start:start + c].contiguous(), cfg)
        aa, bb = _prefix_scan(abar, bx)
        h_all = aa * h[:, None] + bb                 # states at each step
        ys.append(torch.einsum("btds,bts->btd", h_all, cm))
        h = h_all[:, -1]
    return torch.cat(ys, dim=1), h


def _ssm_step(params, xc, proj, cfg, h):
    """One token's scan step from state h (B, di, ds): (y (B, 1, di), the
    new state)."""
    abar, bx, c_mat = _ssm_params(params, xc, proj, cfg)     # T = 1
    h = abar[:, 0] * h + bx[:, 0]                      # (B, di, ds)
    return torch.einsum("bds,bs->bd", h, c_mat[:, 0])[:, None], h


def mamba_split_in(params, x, cfg, conv_state=None):
    """The block's first half — the input projection, the causal conv and
    xc @ w_x — on a slice of d_inner (the whole of it, or the
    reference's d_inner over ``model``): ``params`` hold the slice's
    columns of both halves of ``w_in`` side by side ([x_j | z_j]), of
    ``conv_w`` and ``conv_b``, and its rows of ``w_x``; ``conv_state`` is
    the slice's decode state or None.  Returns (xc = silu(conv(x_p)), z,
    the slice's part of the projection xc @ w_x — the parts sum to the
    whole block's — and the conv's new state (B, dc − 1, di))."""
    xz = x @ params["w_in"]
    x_p, z = torch.chunk(xz, 2, dim=-1)
    xc, conv_state = _causal_conv(x_p, params["conv_w"], params["conv_b"],
                                  state=conv_state)
    xc = silu(xc)
    return xc, z, xc @ params["w_x"], conv_state


def mamba_split_out(params, xc, z, proj, cfg, ssm=None):
    """The block's second half — the scan, the skip, the gate and the
    output projection — on a slice of d_inner, from the summed projection
    ``proj``: ``params`` hold the slice's columns of ``w_dt``, its
    ``b_dt``, ``a_log`` and ``d_skip`` and its rows of ``w_out``.
    Returns (the slice's part of the output — the parts sum to the whole
    block's — and its final SSM state): a scan from zeros, or with
    ``ssm`` (the slice's decode state, T = 1) one step from it."""
    if ssm is None:
        h0 = torch.zeros((xc.shape[0], xc.shape[-1], cfg.mamba_d_state),
                         dtype=torch.float32, device=xc.device)
        y, h = _chunked_ssm(params, xc, proj, cfg, h0)
    else:
        y, h = _ssm_step(params, xc, proj, cfg, ssm)
    y = y + params["d_skip"] * xc.to(torch.float32)
    return (y.to(z.dtype) * silu(z)) @ params["w_out"], h


def mamba_block(params, x, cfg):
    """Train/prefill: x (B, T, D) → (B, T, D)."""
    out, _ = _mamba_prefill(params, x, cfg)
    return out


def _mamba_prefill(params, x, cfg):
    """The block over a whole prompt, and the decode cache it leaves:
    the last d_conv − 1 inputs of the conv (zeros in front when T is
    shorter) and the final SSM state."""
    xc, z, proj, conv_state = mamba_split_in(params, x, cfg)
    out, h_f = mamba_split_out(params, xc, z, proj, cfg)
    return out, {"conv": conv_state, "ssm": h_f}


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
    xc, z, proj, conv_state = mamba_split_in(params, x, cfg, cache["conv"])
    out, h = mamba_split_out(params, xc, z, proj, cfg, ssm=cache["ssm"])
    cache["conv"].copy_(conv_state)
    cache["ssm"].copy_(h)
    return out, cache
