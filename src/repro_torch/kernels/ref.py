"""Plain PyTorch oracles for the kernels (the ground truth in tests): the
port of the JAX package's ``kernels/ref.py``, and K4's plain version
:func:`flash_attention_plain`."""

from __future__ import annotations

import numpy as np

__all__ = ["SWAP_GAIN_REL", "flash_attention_plain", "flash_bf16_limits",
           "hier_distance_ref", "qap_objective_edges_ref",
           "swap_gain_limits", "swap_gain_matrix_ref"]

NEG_INF = -1e30
FLASH_PLAIN_ROWS = 256          # query rows per block of the plain version
SWAP_GAIN_REL = 2.0 ** -18      # K3's limit per unit of swap_gain_limits' S


def swap_gain_matrix_ref(C, B):
    """Dense gain matrix: G[u,v] = M[u,u]+M[v,v]−M[u,v]−M[v,u]−2·C[u,v]·B[u,v],
    M = C @ Bᵀ; diagonal zeroed.  Mirrors objective.dense_gain_matrix."""
    import torch
    C = C.to(torch.float32)
    B = B.to(torch.float32)
    M = C @ B.T
    d = torch.diagonal(M)
    G = d[:, None] + d[None, :] - M - M.T - 2.0 * C * B
    n = C.shape[0]
    return G * (1.0 - torch.eye(n, dtype=torch.float32, device=C.device))


def swap_gain_limits(C, B):
    """The per-element limit K3 is held to on real data: |G − G_exact|
    ≤ 2⁻¹⁸·S(u,v), returned as a float64 (n, n) tensor on C's device,
    with A = |C|·|B|ᵀ and

        S(u,v) = A_uu + A_vv + A_uv + A_vu + 2·|C_uv·B_uv|,

    the sum of the magnitudes of every term of G[u,v].  A float32 sum of
    those terms is within a few 2⁻²⁴·S of the exact G in any order; 3xTF32
    adds the dropped small·small products and the split's rounding, about
    2⁻²² of each product; 1xTF32 (both cross terms dropped) is off by
    hundreds of units of 2⁻²⁴·S.  The limit, 64 units, sits between the
    two kinds (``tests/test_torch_gain.py`` measures both sides, and
    planted faults).  C and B may be tensors or arrays.
    """
    import torch
    C = torch.as_tensor(C).to(torch.float64)
    B = torch.as_tensor(B).to(device=C.device, dtype=torch.float64)
    A = C.abs() @ B.abs().T
    a = A.diagonal()
    S = a[:, None] + a[None, :] + A + A.T + 2.0 * (C * B).abs()
    return SWAP_GAIN_REL * S


def hier_distance_ref(pu, pv, strides: tuple, dists: tuple):
    """Online hierarchical distance oracle, torch version."""
    import torch
    out = torch.zeros(torch.broadcast_shapes(pu.shape, pv.shape),
                      dtype=torch.float32, device=pu.device)
    k = len(dists)
    out = torch.where(pu != pv, np.float32(dists[k - 1]).item(), out)
    for lvl in range(k - 1, 0, -1):
        same = (pu // strides[lvl]) == (pv // strides[lvl])
        out = torch.where(same & (pu != pv), np.float32(dists[lvl - 1]).item(),
                          out)
    return out


def qap_objective_edges_ref(pu, pv, w, strides: tuple, dists: tuple):
    import torch
    return torch.sum(w.to(torch.float32)
                     * hier_distance_ref(pu, pv, strides, dists))


def flash_bf16_limits(want, wide, one_tile: bool = False):
    """The limits K4's bfloat16 output is held to against the plain
    version ``want`` with its ``spread`` ``wide``: (per-element limit,
    limit on the mean |difference|).

    The two sides differ by p's rounding to bfloat16 (relative u = 2⁻⁸ on
    each side, at K4's running max there and at the row max here, so
    independently) and by the outputs' own rounding (at most one spacing,
    2⁻⁷·|want|, between them).  The first is a sum of independent terms
    with standard deviation at most u·√(2/3)·wide; the per-element limit
    allows 2⁻⁵·wide, about ten of those.  The mean limit is
    2⁻⁹·mean(wide), twice the mean difference between K4's tiling and
    this version in float arithmetic on the CPU at the chip smoke's
    shapes (2⁻¹⁰·mean(wide) at T 8192, window 4096).

    ``one_tile``: every query row's keys lie in one 64-row kv tile of K4
    (T ≤ 64), so K4's running max is the row max and both sides round the
    same p; they differ only where the float32 scores' last bits flip a
    rounding, and the mean limit is 2⁻¹³·mean(wide).  p left unrounded,
    or rounded another way, differs by 2⁻¹⁰·mean(wide) there."""
    want = want.float().abs()
    elem = 2.0 ** -7 * want + 2.0 ** -5 * wide + 1e-6
    mean = 2.0 ** (-13 if one_tile else -9) * float(wide.mean())
    return elem, mean


def flash_attention_plain(q, k, v, *, window: int = 0,
                          spread: bool = False):
    """K4's function in plain PyTorch: causal (optionally sliding-window)
    GQA attention, q (B, T, H, hd), k and v (B, T, KV, hd), returning
    (B, T, H, hd) in q's type.

    A dense masked softmax over each block of FLASH_PLAIN_ROWS query rows
    (so memory stays bounded): q·kᵀ·hd^-½ in float32, masked scores −1e30,
    p = exp(s − row max) in float32, p cast to v's type before p·v with
    the products summed in float32, acc / max(l, 1e-30) cast to q's type.
    GQA groups q heads over their KV head by a reshape; k and v are never
    expanded.

    With ``spread``, also returns the float32 (B, T, H, hd) spread
    √(Σ p²v²) / l: the size of the error that rounding every p to v's
    type by a relative u adds to an output, in units of u (the sum of
    independent rounding errors, each ≤ u·p·|v|)."""
    import torch
    b, t, h, hd = q.shape
    kvh = k.shape[2]
    if k.shape[1] != t or v.shape != k.shape or h % kvh:
        raise ValueError(f"flash attention needs q (B,T,H,hd), k and v "
                         f"(B,T,KV,hd) with KV | H; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    g = h // kvh
    f32 = torch.float32
    # (B, KV, G, T, hd) and (B, KV, T, hd)
    qg = q.reshape(b, t, kvh, g, hd).permute(0, 2, 3, 1, 4).to(f32)
    kg = k.permute(0, 2, 1, 3).to(f32)
    vg = v.permute(0, 2, 1, 3).to(f32)
    out = torch.empty((b, kvh, g, t, hd), dtype=q.dtype, device=q.device)
    wide = torch.empty((b, kvh, g, t, hd), dtype=f32, device=q.device) \
        if spread else None
    pos = torch.arange(t, device=q.device)
    for q0 in range(0, t, FLASH_PLAIN_ROWS):
        q1 = min(q0 + FLASH_PLAIN_ROWS, t)
        # keys at or after q1 are masked for every row of the block
        s = torch.einsum("bkgqd,bksd->bkgqs", qg[:, :, :, q0:q1],
                         kg[:, :, :q1]) * hd ** -0.5
        diff = pos[q0:q1, None] - pos[None, :q1]
        mask = diff >= 0
        if window > 0:
            mask &= diff < window
        s = torch.where(mask, s, NEG_INF)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        l = torch.clamp(p.sum(dim=-1), min=1e-30)[..., None]
        acc = torch.einsum("bkgqs,bksd->bkgqd", p.to(v.dtype).to(f32),
                           vg[:, :, :q1])
        out[:, :, :, q0:q1] = (acc / l).to(q.dtype)
        if spread:
            wide[:, :, :, q0:q1] = torch.sqrt(torch.einsum(
                "bkgqs,bksd->bkgqd", p * p, vg[:, :, :q1] ** 2)) / l
    out = out.permute(0, 3, 1, 2, 4).reshape(b, t, h, hd)
    if not spread:
        return out
    return out, wide.permute(0, 3, 1, 2, 4).reshape(b, t, h, hd)
