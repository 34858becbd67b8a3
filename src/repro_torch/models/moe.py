"""Top-k routed mixture-of-experts FFN with virtual experts — the JAX
package's ``models/moe.py`` on torch tensors.

Each expert's FFN dim may be split into s virtual experts (w1: (E, D, F)
→ (E·s, D, F/s)); a token routed to expert e is dispatched to all s of
its halves, and w2's contraction sums over the halves in the combine.
SwiGLU splits elementwise over F, so the math is exact.  The reference
picks s so that E·s equals its data axis (``cfg.moe_ep_split``); the port
keeps the same split, which fixes the weights' layout and the combine's
terms on any mesh, one card's included.

Dataflow per layer, the reference's with its ``jax.vmap`` over batch rows
as a leading batch axis:

  tokens (B@batch, T, D)
    → route (:func:`_route`: a stable sort per row)
    → scatter into buf (B, E_v, cap + 1, D); the last slot takes the
      tokens past capacity and is cut off
    → ep_constrain: buf to E_v@data                              [a2a]
    → expert einsums over (B, E_v, cap, D), E_v@data, F/s@model local;
      h and y pinned by ep_constrain too
    → batch_constrain: y back to B@batch                         [a2a back]
    → gather from y with a zero slot appended (a dropped token reads 0)
      and a weighted combine, each token's k·s terms added in a fixed
      order (:func:`_combine`)

On a device mesh (``mesh=``, x and the weights DTensors) the constrainers
are ``models.sharding.moe_constrainers``' redistributions, and the
route, scatter and combine, which DTensor has no strategy for (a stable
sort, a ``cap + 1``-slot scatter), run per batch shard in a
``local_map`` (``sharding.local_rows``); the expert einsums run on the
DTensors.  Without a mesh the hooks are the identity.

Nothing here reads a value back to the host: capacity, the drop slot
and every index are computed on the device.
"""

from __future__ import annotations

import torch

from .layers import normal, silu

__all__ = ["capacity", "ep_split", "init_moe", "moe_ffn"]


def ep_split(cfg, n_data: int) -> int:
    """Virtual-expert split factor: E·s == data axis when possible."""
    e = cfg.moe_experts
    if e >= n_data:
        return 1
    if n_data % e == 0:
        return n_data // e
    return 1


def init_moe(gen, cfg, split: int = 1):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe_experts
    dt = cfg.torch_dtype
    ev, fs = e * split, f // split
    return {"router": normal(gen, (d, e), d ** -0.5, torch.float32),
            "w1": normal(gen, (ev, d, fs), d ** -0.5, dt),
            "w2": normal(gen, (ev, fs, d), f ** -0.5, dt),
            "w3": normal(gen, (ev, d, fs), d ** -0.5, dt)}


def capacity(cfg, t: int) -> int:
    """Slots per virtual expert and batch row for T tokens: ⌈factor·k·T/E⌉
    rounded up to a multiple of 8 (at least 8), at most T·k — the
    reference's formula, ``int(x + 0.999)`` for the ceiling included."""
    e, k = cfg.moe_experts, cfg.moe_top_k
    cap = int(cfg.capacity_factor * k * t / e + 0.999)
    cap = max(8, -(-cap // 8) * 8)
    return min(cap, t * k)


def _route(x, router, e: int, k: int, cap: int, split: int):
    """Per-row dispatch plan over *virtual* experts.  x: (B, T, D).

    Returns (se, st, sw, pos, keep, order, aux): the assignments sorted
    by virtual expert (stably, so tokens keep their order within an
    expert), each one's token, weight, position within its expert and
    whether that position is under ``cap``, each row's sort order over
    the (T·k·s,) flat assignments, and the load-balance loss per row.

    ``jax.lax.top_k`` puts the lower expert first on a tie; a stable
    descending sort does the same (``torch.topk`` promises no order)."""
    b, t, _ = x.shape
    dev = x.device
    logits = x.to(torch.float32) @ router                  # (B, T, E)
    probs = torch.softmax(logits, dim=-1)
    topw, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = topw[..., :k], topi[..., :k]              # (B, T, k)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    # expand to virtual experts: assignment (token, e) → s × (token, e·s+j)
    flat_e = (topi[..., None] * split
              + torch.arange(split, device=dev)).reshape(b, -1)
    flat_w = topw[..., None].expand(b, t, k, split).reshape(b, -1)
    flat_t = torch.arange(t, device=dev)[:, None].expand(
        t, k * split).reshape(-1)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, 1, order)
    st = flat_t[order]
    sw = torch.gather(flat_w, 1, order)
    first = torch.searchsorted(se, se, side="left")
    pos = torch.arange(se.shape[1], device=dev) - first    # in its expert
    keep = pos < cap
    aux = _load_balance_loss(probs, topi, e)
    return se, st, sw, pos, keep, order, aux


def _load_balance_loss(probs, topi, e: int):
    """Switch-style auxiliary loss per row: E · Σ_e f_e · P_e.
    probs: (B, T, E); topi: (B, T, k)."""
    idx = topi.reshape(topi.shape[0], -1)
    # sums of ones: exact in float32 in any order
    counts = torch.zeros((idx.shape[0], e), dtype=torch.float32,
                         device=idx.device).scatter_add_(
        1, idx, torch.ones(idx.shape, dtype=torch.float32,
                           device=idx.device))                 # (B, E)
    f = counts / torch.clamp(counts.sum(-1, keepdim=True), min=1.0)
    p = probs.mean(1)
    return e * torch.sum(f * p, dim=-1)


def _combine(y, se, sw, pos_c, order, t: int, terms: int):
    """out[b, tok] = Σ sw·y[b, se, pos] over the token's ``terms`` (k·s)
    assignments, a dropped one (pos_c = cap) reading 0.

    The reference scatter-adds the weighted rows in sorted order (rising
    virtual expert within each token), in the activation's type.  On a
    card a scatter-add (``index_add_``) adds in whatever order its
    atomics land, which would make the bfloat16 result, and the decode
    tokens after it, vary between runs; here each token's terms are
    gathered to (B, T, terms, D) in the reference's order and added one
    after another in y's type."""
    b, ev, cap, d = y.shape
    y_pad = torch.cat([y, y.new_zeros((b, ev, 1, d))], dim=2)
    idx = se * (cap + 1) + pos_c                          # (B, N)
    gathered = torch.gather(y_pad.reshape(b, ev * (cap + 1), d), 1,
                            idx[..., None].expand(-1, -1, d))
    weighted = sw[..., None].to(y.dtype) * gathered        # (B, N, D)
    # sorted position of each flat assignment t·terms + i, then each
    # token's positions in rising order: rising virtual expert
    inv = torch.argsort(order, dim=-1)
    slots = torch.sort(inv.reshape(b, t, terms), dim=-1).values
    parts = torch.gather(weighted, 1,
                         slots.reshape(b, t * terms)[..., None]
                         .expand(-1, -1, d)).reshape(b, t, terms, d)
    out = parts[:, :, 0]
    for i in range(1, terms):
        out = out + parts[:, :, i]
    return out


def _dispatch(x, se, st, pos_c, ev: int, cap: int):
    """Scatter each kept assignment's token row into its expert's slot:
    buf (B, E_v, cap, D).  The buffer has cap + 1 slots; every dropped
    assignment (pos_c = cap) lands in the last one, which is cut off (the
    reference's ``mode="drop"``)."""
    b, _, d = x.shape
    buf = x.new_zeros((b, ev * (cap + 1), d))
    rows = torch.gather(x, 1, st[..., None].expand(-1, -1, d))
    buf.scatter_(1, (se * (cap + 1) + pos_c)[..., None].expand(-1, -1, d),
                 rows)
    return buf.reshape(b, ev, cap + 1, d)[:, :, :cap]


def _experts(params, buf, ep_constrain=None):
    """The SwiGLU expert FFNs on every slot: (B, E_v, cap, D) → same;
    ``ep_constrain`` pins h and y to the EP layout (pinning h pins the
    backward cotangent too)."""
    c = ep_constrain or (lambda z: z)
    h = torch.einsum("becd,edf->becf", buf, params["w1"])
    h = c(silu(h) * torch.einsum("becd,edf->becf", buf, params["w3"]))
    return c(torch.einsum("becf,efd->becd", h, params["w2"]))


def moe_ffn(params, x, cfg, ep_constrain=None, batch_constrain=None,
            mesh=None):
    """x: (B, T, D) → (out (B, T, D), aux_loss scalar float32).

    ``ep_constrain`` pins (B, E_v, cap, ·) buffers to E_v@data (the a2a);
    ``batch_constrain`` pins them back to B@batch after expert compute;
    ``mesh``: x and the weights are DTensors on it (module docstring)."""
    from .sharding import local_rows, rows_of
    t = x.shape[1]
    e, k = cfg.moe_experts, cfg.moe_top_k
    ev = params["w1"].shape[0]
    split = ev // e
    cap = capacity(cfg, t)
    ep_constrain = ep_constrain or (lambda z: z)
    batch_constrain = batch_constrain or (lambda z: z)
    rows = rows_of(mesh, x) if mesh is not None else None

    def plan(xl, router):
        se, st, sw, pos, keep, order, aux = _route(xl, router, e, k, cap,
                                                   split)
        pos_c = torch.where(keep, pos, cap)               # cap → dropped
        return (_dispatch(xl, se, st, pos_c, ev, cap), se, sw, pos_c,
                order, aux)

    buf, se, sw, pos_c, order, aux = local_rows(
        plan, mesh, rows, (x,), (params["router"],), n_out=6)
    y = _experts(params, ep_constrain(buf), ep_constrain)  # E_v@data
    y = batch_constrain(y)                                # → B@batch
    out = local_rows(
        lambda yl, sel, swl, pcl, ol: _combine(yl, sel, swl, pcl, ol, t,
                                               k * split),
        mesh, rows, (y, se, sw, pos_c, order))
    return out, aux.mean()
