"""GQA attention: K4 flash attention for prefill, a blocked attention in
torch ops for training, cached decode step — the JAX package's
``models/attention.py`` on torch tensors.

Layouts are the JAX package's: projections wq (d, H, hd), wk and wv
(d, KV, hd), wo (H, hd, d); q (B, T, H, hd); k, v and the caches
(B, S, KV, hd).

  * prefill attention is K4 (:func:`~repro_torch.kernels.flash_attention.
    flash_attention_kernel`) for both :func:`attention_block` and the
    model's prefill (CPU tensors take K4's plain version); a prefill
    continuation (``q_offset`` ≠ 0) attends through
    :func:`blocked_flash_attention`, the reference's blocked core,
  * on a device mesh (``attention_block(..., mesh=)``, q, k and v
    DTensors) :func:`flash_attention_sharded` is the JAX package's
    ``_flash_kernel_sharded``: heads@``model``, batch@batch axes, each
    rank expanding its own heads' KV and running K4 (or, training, the
    blocked core) on its local tensors,
  * training (``attention_block(..., train=True)``) differentiates
    through :func:`blocked_flash_attention`, a torch-ops twin of the
    JAX package's blocked ``flash_attention`` — the core the reference
    trains through (its Pallas branch needs a flash mesh, and the JAX
    package has no backward kernel); K4 has no backward and raises
    under autograd,
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
    """Causal (optionally sliding-window) attention.

    q: (B, T, H, hd); k, v: (B, S, KV, hd).  ``q_offset``: the position
    of q[0] within the keys (a prefill continuation).  Returns (B, T, H,
    hd).  Self-attention (q_offset 0, S = T) runs through K4; a
    continuation through :func:`blocked_flash_attention`, as the
    reference serves it through its blocked core (its Pallas kernel has
    no offset either)."""
    if q_offset or k.shape[1] != q.shape[1]:
        return blocked_flash_attention(q, k, v, cfg, q_offset=q_offset)
    return flash_attention_kernel(q.contiguous(), k.contiguous(),
                                  v.contiguous(), window=cfg.sliding_window)


def _blocks(t: int, s_len: int, cfg):
    """The reference's static blocking: (qb, kb, n_kb, window, span) —
    q blocks of ``cfg.q_block`` halved until they divide T; with a
    sliding window shorter than the keys, a static span of window + qb
    keys per q block in kv blocks dividing it, else kv blocks of
    ``cfg.kv_block`` dividing S."""
    qb = min(cfg.q_block, t)
    while t % qb:
        qb //= 2
    window = cfg.sliding_window
    if window and window < s_len:
        span = window + qb
        kb = min(cfg.kv_block, span)
        while span % kb:
            kb //= 2
        return qb, kb, span // kb, window, span
    kb = min(cfg.kv_block, s_len)
    while s_len % kb:
        kb //= 2
    return qb, kb, s_len // kb, 0, s_len


def blocked_flash_attention(q, k, v, cfg, q_offset: int = 0):
    """Causal (optionally sliding-window) blocked attention in torch ops,
    differentiable through autograd: the JAX package's
    ``flash_attention`` (``models/attention.py:75``, ``_online_block``
    ``:61``).

    q: (B, T, H, hd); k, v: (B, S, KV, hd); ``q_offset``: the position of
    q[0] within the keys.  Returns (B, T, H, hd) in q's type.  Each q
    block of ``qb`` rows runs an online softmax over
    ``n_kb`` kv blocks of ``kb`` keys, as the reference does: scores
    q·kᵀ in the inputs' type, then float32 and scaled, masked −1e30;
    running max, sum and accumulator in float32; p cast to v's type
    before p·v.  Every q block visits every kv block of its span, fully
    masked ones included.  With a window, q block i's span starts at
    max(0, q_offset + (i + 1)·qb − span); a kv block that would run past
    the keys reads the last ``kb`` keys, while its mask keeps the
    unclamped positions (the reference's ``dynamic_slice`` clamps the
    slice, not the positions).

    The q blocks run side by side (a block axis n): each block's
    arithmetic is the reference's, and one kv step is one launch of each
    op for all q blocks — n_kb steps a call."""
    b, t, h, hd = q.shape
    s_len, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = hd ** -0.5
    qb, kb, n_kb, window, span = _blocks(t, s_len, cfg)
    n_qb = t // qb
    dev = q.device
    f32 = torch.float32

    # (B, KV, G, n, qb, hd) grouped layout; k and v (B, KV, S, hd)
    qg = q.reshape(b, n_qb, qb, kvh, g, hd).permute(0, 3, 4, 1, 2, 5)
    kg = k.permute(0, 2, 1, 3)
    vg = v.permute(0, 2, 1, 3)
    # each q block's span starts at max(0, q_offset + (i + 1)·qb − span)
    # with a window, at 0 without one; as host ints for the slices, on
    # the device for the masks
    if window:
        starts = [max(0, q_offset + (i + 1) * qb - span)
                  for i in range(n_qb)]
        start_pos = torch.clamp(torch.arange(1, n_qb + 1, device=dev) * qb
                                + (q_offset - span), min=0)
    else:
        starts = [0] * n_qb
        start_pos = torch.zeros(n_qb, dtype=torch.int64, device=dev)
    q_pos = (torch.arange(t, device=dev) + q_offset).reshape(n_qb, qb)

    m = torch.full((b, kvh, g, n_qb, qb), NEG_INF, dtype=f32, device=dev)
    l = torch.zeros((b, kvh, g, n_qb, qb), dtype=f32, device=dev)
    acc = torch.zeros((b, kvh, g, n_qb, qb, hd), dtype=f32, device=dev)
    for ki in range(n_kb):
        firsts = [min(s + ki * kb, s_len - kb) for s in starts]
        kblk = torch.stack([kg[:, :, f:f + kb] for f in firsts], dim=2)
        vblk = torch.stack([vg[:, :, f:f + kb] for f in firsts], dim=2)
        # (n, kb) positions from the unclamped starts
        k_pos = (start_pos + ki * kb)[:, None] + torch.arange(kb,
                                                              device=dev)
        diff = q_pos[:, :, None] - k_pos[:, None, :]       # (n, qb, kb)
        mask = diff >= 0
        if window:
            mask &= diff < window
        s = torch.einsum("bkgnqh,bknth->bkgnqt", qg, kblk).to(f32) * scale
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgnqt,bknth->bkgnqh", p.to(v.dtype), vblk).to(f32)
        m = m_new
    out = (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
    # (B, KV, G, n, qb, hd) -> (B, T, H, hd)
    return out.permute(0, 3, 4, 1, 2, 5).reshape(b, t, h, hd)


def sharded_layout(cfg, mesh, batch: int):
    """The sharded attention's layout, the reference's
    (``models/attention.py:156–170``): (q spec, k/v spec, ``kv_ids``),
    q at heads@``model`` when the heads divide it and batch@batch axes
    (replicated when ``batch`` does not divide them), k and v at
    batch@batch axes; ``kv_ids(rank_model, h_local)`` the KV heads a
    rank expands for its own heads, ``(rank_model · h_local +
    arange(h_local)) // g``."""
    from . import sharding as shd
    ba = shd.batch_axes(mesh)
    if batch % shd.n_batch(mesh):
        ba = ()                  # small batch: replicate
    h_ok = cfg.n_heads_eff % shd.mesh_size(mesh, "model") == 0
    bsp = shd._entry(ba)
    g = cfg.n_heads_eff // cfg.n_kv_heads

    def kv_ids(rank_model: int, h_local: int, device=None):
        base = rank_model * h_local if h_ok else 0
        return (base + torch.arange(h_local, device=device)) // g

    return ((bsp, None, "model" if h_ok else None, None),
            (bsp, None, None, None), kv_ids)


def flash_attention_sharded(q, k, v, cfg, mesh, train: bool = False):
    """Attention over a mesh, the JAX package's ``_flash_kernel_sharded``
    (``models/attention.py:144``) as a ``local_map`` over
    :func:`sharded_layout`: each rank expands its own heads' KV and runs
    K4 (``train`` False) or :func:`blocked_flash_attention` (``train``
    True, which autograd follows) on its local tensors; the result is a
    DTensor with q's placements.  Each rank's k and v gradients cover its
    own heads only, so they come back partial over ``model``."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    from . import sharding as shd
    qspec, kvspec, kv_ids = sharded_layout(cfg, mesh, q.shape[0])
    qp, kvp = shd.placements(mesh, qspec), shd.placements(mesh, kvspec)
    kv_grad = kvp
    rank = 0
    if qspec[2] is not None:
        i = tuple(mesh.mesh_dim_names).index("model")
        kv_grad = kvp[:i] + (Partial(),) + kvp[i + 1:]
        rank = mesh.get_local_rank("model")

    def local(ql, kl, vl):
        # made on the device: a host copy would sync
        ids = kv_ids(rank, ql.shape[2], ql.device)
        kl, vl = kl.index_select(2, ids), vl.index_select(2, ids)
        if train:
            return blocked_flash_attention(ql, kl, vl, cfg)
        return flash_attention_kernel(ql.contiguous(), kl.contiguous(),
                                      vl.contiguous(),
                                      window=cfg.sliding_window)

    return local_map(local, out_placements=list(qp),
                     in_placements=(qp, kvp, kvp),
                     in_grad_placements=(qp, kv_grad, kv_grad),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)


def attention_block(params, x, positions, cfg, train: bool = False,
                    mesh=None):
    """Full attention sub-layer: qkv → attention → out proj.  Prefill
    (``train`` False) attends through K4; training (``train`` True)
    through :func:`blocked_flash_attention`, which autograd can follow.
    With a ``mesh`` (x and the weights DTensors) the attention is
    :func:`flash_attention_sharded`."""
    q, k, v = _qkv(params, x, positions, cfg)
    if mesh is not None:
        o = flash_attention_sharded(q, k, v, cfg, mesh, train=train)
    elif train:
        o = blocked_flash_attention(q, k, v, cfg)
    else:
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
