"""K4's plain version (what the port's flash attention runs on CPU
tensors) against the JAX package's flash attention, on the CPU.

  * Every case of ``tests/test_flash_kernel.py:CASES`` against the Pallas
    ``flash_attention_kernel`` in interpret mode, at float32 within 2e-5
    (the JAX package's own drop-in tolerance; the same float32 terms
    summed over other tiles) and at bfloat16 within 0.05 (p is rounded
    to bfloat16 before p·v, on other tiles on each side, and the outputs
    are bfloat16, whose spacing is up to 0.016 at these magnitudes).
  * The JAX model's blocked ``flash_attention`` at the granite smoke
    config, float32, within 2e-5.
  * Windows that mask whole leading kv tiles of a q tile, which K4
    skips, against the dense oracle of ``tests/test_flash_kernel.py``.
  * The bfloat16 limits K4 is held to on the card
    (``flash_bf16_limits``): K4's algorithm written in torch ops
    (``tiled_flash``: online softmax, p rounded at the running max) stays
    within them, and the faults they are meant to catch do not, at two
    tilings: 64-row tiles with exp and the sm90 kernel's 128-row q and
    kv tiles with exp2 and log2 e folded into the scale.
  * The float32 route's tolerance contract (``csrc/flash_attention.cu``):
    a numpy emulation of its arithmetic (``flash_3xtf32``: the 3xTF32
    split of q, k, p and v, a truncating tensor-core accumulator, its
    128-row q tiles of two 64-row warpgroups and 32-key kv tiles, the σ
    permutation of every 8-key group of p and vᵀ, l summed per lane)
    stays within ``chip_smoke.FLASH_F32_TOL`` of the plain version and of
    the Pallas kernel on ``chip_smoke.FLASH_SMALL``; planted faults (one
    TF32 pass, p permuted without vᵀ) exceed it.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_flash_kernel import CASES, ref_attn
from test_torch_gain import _split as _gain_split
from test_torch_multilevel import _chip_smoke

from repro.configs import get_smoke_config as jax_smoke_config
from repro.kernels.flash_attention import flash_attention_kernel as pallas
from repro.models.attention import flash_attention as jax_flash
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import FLASH_KERNEL, flash_attention_kernel
from repro_torch.kernels.flash_attention import (FLASH_SM90_TILES,
                                                FLASH_TILE, LOG2E)
from repro_torch.kernels.ref import flash_attention_plain, flash_bf16_limits
from repro_torch.models import attention as tattn
from repro_torch.models.attention import (blocked_flash_attention,
                                         flash_attention)

TOL = {"float32": 2e-5, "bfloat16": 0.05}


def _qkv(b, t, h, kv, hd, seed, dtype="float32"):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((b, t, h, hd), (b, t, kv, hd), (b, t, kv, hd))]
    jx = [jnp.asarray(a).astype(jnp.dtype(dtype)) for a in arrays]
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    tx = [torch.from_numpy(a).to(tdt) for a in arrays]
    return jx, tx


def _err(got, want):
    return float(np.max(np.abs(got.to(torch.float32).numpy()
                               - np.asarray(want, np.float32))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,h,kv,hd,win,qb,kb", CASES)
def test_plain_matches_pallas_kernel(b, t, h, kv, hd, win, qb, kb, dtype):
    (qj, kj, vj), (qt, kt, vt) = _qkv(b, t, h, kv, hd, t + h, dtype)
    want = pallas(qj, kj, vj, window=win, q_block=qb, kv_block=kb,
                  interpret=True)
    before = FLASH_KERNEL.launches
    got = flash_attention_kernel(qt, kt, vt, window=win)
    assert FLASH_KERNEL.launches == before       # CPU: the plain version
    assert got.dtype == qt.dtype and got.shape == qt.shape
    assert _err(got, want) < TOL[dtype]


def test_plain_matches_model_flash_attention():
    jcfg = jax_smoke_config("granite-3-8b")
    tcfg = get_smoke_config("granite-3-8b")
    hd = jcfg.head_dim_
    for t in (128, 96):                          # 96: ragged against 64
        (qj, kj, vj), (qt, kt, vt) = _qkv(2, t, jcfg.n_heads,
                                          jcfg.n_kv_heads, hd, t)
        want = jax_flash(qj, kj, vj, jcfg)
        assert _err(flash_attention(qt, kt, vt, tcfg), want) < 2e-5
        assert _err(flash_attention_plain(qt, kt, vt), want) < 2e-5


@pytest.mark.parametrize("t,win", [(256, 48), (200, 16), (320, 100)])
def test_window_skipping_whole_leading_tiles(t, win):
    # the last q tile's first row sees keys from q0 − win + 1 on: K4
    # skips every kv tile before that one for the whole q tile
    tq, tk = FLASH_TILE
    q0 = (t - 1) // tq * tq
    assert (q0 - win + 1) // tk >= 2
    (qj, kj, vj), (qt, kt, vt) = _qkv(1, t, 4, 2, 32, win)
    want = ref_attn(qj, kj, vj, win)
    assert _err(flash_attention_plain(qt, kt, vt, window=win), want) < 2e-5
    # a window at least T long is full causal attention
    full = flash_attention_plain(qt, kt, vt, window=t)
    assert _err(full, ref_attn(qj, kj, vj, 0)) < 2e-5


def test_q_offset_raises_on_cpu():
    """K4 attends positions 0..T−1 of q over the same positions of k and
    v, and its wrapper raises on a prefill continuation's shapes (S ≠ T);
    ``flash_attention(q_offset=...)`` never reaches it and attends
    through the blocked core instead."""
    cfg = get_smoke_config("granite-3-8b")
    (_, _, _), (q, k, v) = _qkv(1, 96, 4, 2, 32, 0)
    q = q[:, 64:]
    with pytest.raises(ValueError):
        flash_attention_kernel(q, k, v)
    before = FLASH_KERNEL.launches
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tattn, "flash_attention_kernel", _refuse)
        got = flash_attention(q, k, v, cfg, q_offset=64)
    assert FLASH_KERNEL.launches == before
    assert torch.equal(got, blocked_flash_attention(q, k, v, cfg,
                                                    q_offset=64))


def _refuse(*args, **kwargs):
    raise AssertionError("a continuation reached K4")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 64, 40], ids=["full", "w64", "w40"])
@pytest.mark.parametrize("q_offset,t", [(32, 64), (64, 64), (64, 32),
                                        (32, 96)])
def test_q_offset_matches_the_reference(q_offset, t, window, dtype):
    """A prefill continuation — q at positions q_offset..q_offset+T−1
    over keys 0..S−1, S = q_offset + T — through the port's
    ``flash_attention`` against the reference's blocked core, with and
    without a window (40: a span of window + q block that the kv block
    does not divide, so the blocks are halved).

    Where the span is no longer than the keys, the continuation's rows
    equal the same rows of the whole prefill.  Where it is longer (window
    64, q_offset 32, T 64: span 128 over 96 keys), the reference's
    ``dynamic_slice`` clamps the last kv block back onto keys 32..95
    while its mask labels them 64..127, so keys 64..95 are never
    attended as themselves: the reference's fault (ROADMAP queue 3),
    which the port copies, as it must to equal the reference."""
    jcfg = dataclasses.replace(jax_smoke_config("granite-3-8b"),
                               sliding_window=window)
    tcfg = dataclasses.replace(get_smoke_config("granite-3-8b"),
                               sliding_window=window)
    s_len = q_offset + t
    (qj, kj, vj), (qt, kt, vt) = _qkv(2, s_len, jcfg.n_heads,
                                      jcfg.n_kv_heads, jcfg.head_dim_,
                                      q_offset + t + window, dtype)
    want = jax_flash(qj[:, q_offset:], kj, vj, jcfg, q_offset=q_offset)
    got = flash_attention(qt[:, q_offset:].contiguous(), kt, vt, tcfg,
                          q_offset=q_offset)
    assert got.shape == (2, t, jcfg.n_heads, jcfg.head_dim_)
    assert got.dtype == qt.dtype
    assert _err(got, want) < TOL[dtype]
    span = tattn._blocks(t, s_len, tcfg)[4]
    if span <= s_len:
        whole = flash_attention_plain(qt, kt, vt, window=window)
        assert _err(got, whole[:, q_offset:].float().numpy()) < TOL[dtype]


@pytest.mark.parametrize("shapes", [
    ((1, 64, 4, 32), (1, 32, 2, 32)),            # S != T
    ((1, 64, 3, 32), (1, 64, 2, 32)),            # KV does not divide H
    ((1, 64, 4, 32), (1, 64, 2, 16)),            # head dims differ
])
def test_wrapper_rejects_bad_shapes(shapes):
    q, k = (torch.zeros(s) for s in shapes)
    with pytest.raises(ValueError):
        flash_attention_kernel(q, k, k.clone())


def test_wrapper_rejects_mixed_types_and_negative_window():
    q = torch.zeros((1, 64, 4, 32))
    k = torch.zeros((1, 64, 2, 32))
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        flash_attention_kernel(q, k.to(torch.bfloat16), k)
    with pytest.raises(ValueError, match="window"):
        flash_attention_kernel(q, k, k, window=-1)


# ------------------------------------------------ the bfloat16 limits
def tiled_flash(q, k, v, window=0, fault=None, tiles=(64, 64),
                exp2=False):
    """K4's algorithm in torch ops: ``tiles`` = (q rows, kv rows) tiles,
    each q tile over the kv tiles up to the diagonal, online softmax in
    float32, p rounded to v's type at the running max; with ``exp2``,
    exp2 of scores scaled by hd^-½·log2 e, as the sm90 kernel computes.
    It visits every kv tile up to the diagonal, which the kernels' tile
    skipping gives exactly (the argument in their sources).  ``fault``
    plants one of the errors the limits must catch."""
    tq, tk = tiles
    scale = q.shape[3] ** -0.5 * (LOG2E if exp2 else 1.0)
    exp = torch.exp2 if exp2 else torch.exp
    b, t, h, hd = q.shape
    kvh = k.shape[2]
    g, f32 = h // kvh, torch.float32
    qg = q.reshape(b, t, kvh, g, hd).permute(0, 2, 3, 1, 4).to(f32)
    kg = k.permute(0, 2, 1, 3).to(f32)
    vg = v.permute(0, 2, 1, 3).to(f32)
    out = torch.empty((b, kvh, g, t, hd), dtype=q.dtype)
    pos = torch.arange(t)
    for q0 in range(0, t, tq):
        q1 = min(q0 + tq, t)
        m = torch.full((b, kvh, g, q1 - q0), -1e30)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, kvh, g, q1 - q0, hd))
        for k0 in range(0, q1, tk):
            k1 = min(k0 + tk, t)
            s = torch.einsum("bkgqd,bksd->bkgqs", qg[:, :, :, q0:q1],
                             kg[:, :, k0:k1]) * scale
            diff = pos[q0:q1, None] - pos[None, k0:k1]
            mask = diff >= (-1 if fault == "future_key" else 0)
            if window:
                mask &= (diff <= window if fault == "window_off_by_one"
                         else diff < window)
            if fault == "half_diagonal_tile" and k0 == q0:
                mask &= pos[q0:q1, None] < q0 + tq // 2
            s = torch.where(mask, s, -1e30)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = exp(s - m_new[..., None])
            corr = exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            if fault != "unrounded_p":
                p = p.to(v.dtype).to(f32)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bksd->bkgqd", p, vg[:, :, k0:k1])
            m = m_new
        out[:, :, :, q0:q1] = (acc / torch.clamp(l, min=1e-30)[..., None]
                               ).to(q.dtype)
    return out.permute(0, 3, 1, 2, 4).reshape(b, t, h, hd)


def _bf16_qkv(b, t, h, kv, hd, seed):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn((b, t, n, hd), generator=gen).to(torch.bfloat16)
            for n in (h, kv, kv)]


def _within_limits(got, q, k, v, window):
    want, wide = flash_attention_plain(q, k, v, window=window, spread=True)
    elem, mean = flash_bf16_limits(want, wide, one_tile=q.shape[1] <= 64)
    diff = (got.float() - want.float()).abs()
    return float((diff / elem).max()), float(diff.mean()) / mean


def test_spread_is_the_rounding_error_scale():
    b, t, h, kv, hd, win = 2, 70, 4, 2, 32, 20
    (_, _, _), (q, k, v) = _qkv(b, t, h, kv, hd, 5)
    o, wide = flash_attention_plain(q, k, v, window=win, spread=True)
    assert torch.equal(o, flash_attention_plain(q, k, v, window=win))
    # dense: normalised p over every key, √(Σ p² v²) by definition
    qe = q.reshape(b, t, kv, h // kv, hd)
    s = torch.einsum("btkgd,bskd->bkgts", qe, k) * hd ** -0.5
    i = torch.arange(t)
    mask = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < win)
    p = torch.softmax(torch.where(mask, s, -torch.inf), dim=-1)
    want = torch.sqrt(torch.einsum("bkgts,bskd->btkgd", p * p, v * v))
    assert torch.allclose(wide, want.reshape(b, t, h, hd), rtol=1e-5,
                          atol=1e-7)


# the tilings tiled_flash runs: (tiles, exp2).  "sm90" is the bf16
# route's; "f32" a second one, 64 × 64 tiles with exp (the order of the
# first float32 kernel, which ran on the CUDA cores), so the limits are
# shown to hold at two tilings
K4_ORDERS = {"f32": ((64, 64), False),
             "sm90": (FLASH_SM90_TILES, True)}
ADMIT = [
    (1, 1024, 4, 1, 128, 0),        # serve-like: many kv tiles per row
    (1, 700, 4, 2, 64, 256),        # a window, ragged T
    (2, 64, 8, 2, 96, 16),          # one kv tile: the tight mean limit
]


def _case(values, order):
    name = "-".join(map(str, values))
    return pytest.param(*values, order,
                        id=name if order == "f32" else f"{order}-{name}")


@pytest.mark.parametrize("b,t,h,kv,hd,win,order",
                         [_case(c, o) for o in K4_ORDERS for c in ADMIT])
def test_bf16_limits_admit_k4_rounding_order(b, t, h, kv, hd, win, order):
    tiles, exp2 = K4_ORDERS[order]
    q, k, v = _bf16_qkv(b, t, h, kv, hd, t + win)
    got = tiled_flash(q, k, v, win, tiles=tiles, exp2=exp2)
    worst, mean_share = _within_limits(got, q, k, v, win)
    assert worst <= 0.6 and mean_share <= 0.6, (worst, mean_share)


# each fault at each tiling: a future key, a window off by one, the
# second half of a q tile's rows losing the diagonal tile (the second
# consumer warpgroup's, at the sm90 tiling), and p left unrounded where
# one kv tile holds every key (T = 64)
FAULTS = [("future_key", 700, 0), ("window_off_by_one", 700, 256),
          ("half_diagonal_tile", 700, 0), ("unrounded_p", 64, 0)]


@pytest.mark.parametrize("fault,t,win,order",
                         [_case(c, o) for o in K4_ORDERS for c in FAULTS])
def test_bf16_limits_catch_faults(fault, t, win, order):
    tiles, exp2 = K4_ORDERS[order]
    q, k, v = _bf16_qkv(1, t, 4, 2, 64, 7)
    got = tiled_flash(q, k, v, win, fault, tiles=tiles, exp2=exp2)
    worst, mean_share = _within_limits(got, q, k, v, win)
    assert worst > 1.0 or mean_share > 1.0, (worst, mean_share)


def test_sm90_order_equals_dense_at_float32():
    """At float32 (no rounding of p) the sm90 tiling with exp2 is the
    dense attention of the JAX package's oracle, across a window that
    empties whole leading 128-row tiles and a ragged T."""
    t, win = 600, 100
    (qj, kj, vj), (qt, kt, vt) = _qkv(1, t, 4, 2, 64, 3)
    got = tiled_flash(qt, kt, vt, win, tiles=FLASH_SM90_TILES, exp2=True)
    assert _err(got, ref_attn(qj, kj, vj, win)) < 2e-5
    got = tiled_flash(qt, kt, vt, 0, tiles=FLASH_SM90_TILES, exp2=True)
    assert _err(got, ref_attn(qj, kj, vj, 0)) < 2e-5


# ------------------------------------ the float32 route's 3xTF32 contract
SMOKE = _chip_smoke()
# the key of an 8-key group that slot c of vᵀ holds, and that A column c
# of P·V takes (csrc/flash_attention.cu: sigma)
SIGMA = np.array([0, 2, 4, 6, 1, 3, 5, 7])
WG_ROWS = FLASH_TILE[0] // 2           # q rows of a consumer warpgroup


def _split(x):
    """K3's split (``test_torch_gain._split``) as float64: big, small."""
    return tuple(t.astype(np.float64) for t in _gain_split(x))


_RZ = np.uint64(0xFFFFFFFFE0000000)    # float64 bits kept by float32


def _rz32(x):
    """``test_torch_gain._rz32`` (the tensor cores' accumulator after a
    wgmma: the float64 sum rounded toward zero to float32) by clearing
    the low 29 mantissa bits, a few times faster on the long cases."""
    return (x.view(np.uint64) & _RZ).view(np.float64)


def flash_3xtf32(q, k, v, window=0, fault=None):
    """o as K4's float32 route computes it on the card, from numpy q (B,
    T, H, hd), k, v (B, T, KV, hd) float32.  Per (b, KV head) all G heads'
    rows at once; a row's warpgroup (64 rows) visits the 32-key tiles that
    hold a key visible to one of its rows, in order.  Per tile: Qb·Kb,
    Qb·Ks and Qs·Kb each in a fresh accumulator over hd, every wgmma
    (one k8 step) adding its exact products and rounding toward zero,
    then S = (Qb·Kb + Qb·Ks) + Qs·Kb in float32; s = S·(hd^-½·log2 e) in
    float32, masked to −1e30; the online softmax in float32 with exp2; p
    and v in σ order within each 8-key group; P·V in a fresh accumulator,
    per k8 step of keys Pb·Vb, Pb·Vs, Ps·Vb, folded as O = fma(O, corr,
    P·V) (the kernel's chunks of o's columns round each element the same
    way); l per lane
    (each lane's 8 keys of a tile added in order), summed over the quad
    at the end; o = O / max(l, 1e-30).  ``fault``: "1xtf32" (big·big
    only), "v_unpermuted" (p in σ order, vᵀ not) or "carried" (O carried
    in one accumulator across the whole key range, the tensor cores'
    drift left in)."""
    b_, t, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    bn = FLASH_TILE[1]
    scale = np.float32(hd ** -0.5 * LOG2E)
    neg = np.float32(-1e30)
    out = np.empty_like(q)
    rows = np.tile(np.arange(t), g)     # the position of each stacked row
    wq0 = rows // WG_ROWS * WG_ROWS
    first = (np.maximum(0, wq0 - window + 1) // bn * bn if window
             else np.zeros_like(wq0))
    end = np.minimum(wq0 + WG_ROWS, t)
    slots = np.arange(bn)
    order = slots // 8 * 8 + SIGMA[slots % 8]

    def products(a_big, a_small, b_big, b_small):
        if fault == "1xtf32":
            return [(a_big, b_big)]
        return [(a_big, b_big), (a_big, b_small), (a_small, b_big)]

    for bi in range(b_):
        for j in range(kvh):
            qq = q[bi, :, j * g:(j + 1) * g].transpose(1, 0, 2).reshape(
                g * t, hd)
            qb, qs = _split(qq)
            tp = -(-t // bn) * bn
            kk_ = np.zeros((tp, hd), np.float32)
            vv = np.zeros((tp, hd), np.float32)
            kk_[:t], vv[:t] = k[bi, :, j], v[bi, :, j]
            kb, ks = _split(kk_)
            m = np.full(g * t, neg, np.float32)
            lanes = np.zeros((g * t, 4), np.float32)
            acc = np.zeros((g * t, hd), np.float32)
            for k0 in range(0, t, bn):
                act = np.flatnonzero((k0 >= first) & (k0 < end))
                if not len(act):
                    continue
                parts = []
                for a, w in products(qb[act], qs[act], kb[k0:k0 + bn],
                                     ks[k0:k0 + bn]):
                    S = np.zeros((len(act), bn))
                    for c in range(0, hd, 8):
                        S = _rz32(a[:, c:c + 8] @ w[:, c:c + 8].T + S)
                    parts.append(S.astype(np.float32))
                s = parts[0] if fault == "1xtf32" else (
                    (parts[0] + parts[1]) + parts[2])
                s = s * scale
                r = rows[act][:, None]
                col = k0 + slots[None, :]
                vis = col <= r
                if window:
                    vis &= r - col < window
                s = np.where(vis, s, neg)
                mn = np.maximum(m[act], s.max(axis=1))
                corr = np.exp2(m[act] - mn)
                p = np.exp2(s - mn[:, None])
                # lane t4 holds keys 8·grp + 2·t4, + 1 of each group
                pl = p.reshape(len(act), bn // 8, 4, 2)
                rs = np.zeros((len(act), 4), np.float32)
                for grp in range(bn // 8):
                    rs = (rs + pl[:, grp, :, 0]) + pl[:, grp, :, 1]
                lanes[act] = lanes[act] * corr[:, None] + rs
                pb, ps = _split(p[:, order])
                vt = vv[k0:k0 + bn]
                vb, vs = _split(vt if fault == "v_unpermuted" else vt[order])
                if fault == "carried":
                    O = (acc[act] * corr[:, None]).astype(np.float64)
                    for c in range(0, bn, 8):
                        for a, w in products(pb[:, c:c + 8], ps[:, c:c + 8],
                                             vb[c:c + 8], vs[c:c + 8]):
                            O = _rz32(a @ w + O)
                    acc[act] = O.astype(np.float32)
                else:
                    F = np.zeros((len(act), hd))
                    for c in range(0, bn, 8):
                        for a, w in products(pb[:, c:c + 8], ps[:, c:c + 8],
                                             vb[c:c + 8], vs[c:c + 8]):
                            F = _rz32(a @ w + F)
                    acc[act] = (acc[act].astype(np.float64) * corr[:, None]
                                + F).astype(np.float32)
                m[act] = mn
            l = (lanes[:, 0] + lanes[:, 1]) + (lanes[:, 2] + lanes[:, 3])
            o = acc / np.maximum(l, np.float32(1e-30))[:, None]
            out[bi, :, j * g:(j + 1) * g] = o.reshape(g, t, hd).transpose(
                1, 0, 2)
    return out


def _f32_case(shape, seed):
    b, t, h, kv, hd, win = shape
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, t, h, hd), (b, t, kv, hd), (b, t, kv, hd))]


def _block(t):
    """A Pallas block that divides T, at most 512 rows."""
    return next(d for d in range(min(t, 512), 0, -1) if t % d == 0)


@pytest.mark.parametrize("name", sorted(SMOKE.FLASH_SMALL))
def test_3xtf32_emulation_within_the_float32_tolerance(name):
    """The card's float32 arithmetic against the plain version and the
    Pallas kernel (interpret mode) on each small case of the card's
    phase flash, within FLASH_F32_TOL."""
    shape = SMOKE.FLASH_SMALL[name]
    t, win = shape[1], shape[5]
    q, k, v = _f32_case(shape, 11)
    got = flash_3xtf32(q, k, v, win)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    plain = flash_attention_plain(tq, tk, tv, window=win).numpy()
    want = pallas(*(jnp.asarray(x) for x in (q, k, v)), window=win,
                  q_block=_block(t), kv_block=_block(t), interpret=True)
    tol = SMOKE.FLASH_F32_TOL
    assert float(np.max(np.abs(got - plain))) <= tol
    assert float(np.max(np.abs(got - np.asarray(want)))) <= tol


@pytest.mark.parametrize("fault", ["1xtf32", "v_unpermuted"])
def test_3xtf32_tolerance_rejects_planted_faults(fault):
    shape = SMOKE.FLASH_SMALL["ragged"]
    q, k, v = _f32_case(shape, 11)
    got = flash_3xtf32(q, k, v, shape[5], fault)
    plain = flash_attention_plain(*(torch.from_numpy(x) for x in (q, k, v)),
                                  window=shape[5]).numpy()
    assert float(np.max(np.abs(got - plain))) > SMOKE.FLASH_F32_TOL


def test_3xtf32_fresh_accumulators_beat_the_carried_one():
    """Why the kernel folds each chunk's fresh accumulator into O: the
    tensor cores round a carried accumulator toward zero at every wgmma,
    and over 2048 keys that drift is three times the fresh design's
    error against the plain version."""
    shape = (1, 2048, 2, 1, 128, 0)
    q, k, v = _f32_case(shape, 11)
    plain = flash_attention_plain(*(torch.from_numpy(x) for x in (q, k, v))
                                  ).numpy()
    fresh = float(np.max(np.abs(flash_3xtf32(q, k, v) - plain)))
    carried = float(np.max(np.abs(flash_3xtf32(q, k, v, fault="carried")
                                  - plain)))
    assert fresh <= 2.5e-6 and carried >= 2 * fresh, (fresh, carried)


# ------------------------------ the build phase's check of wgmma operands
def _sass(*insns):
    """SASS lines as ``cuobjdump -sass`` prints them, from (address,
    text) pairs."""
    return [f"        /*{at:04x}*/                   {text} ;"
            f"                  /* 0x0000000000000000 */"
            for at, text in insns]


# a tile loop (0x1710 … the branch back at 0x4400) whose S product reads
# q's small parts from R84..R87, set before the loop: the shape of K4's
# float32 kernel at hd 32 (instructions from its listing)
_LOOP_HEAD = [
    (0x16d0, "LOP3.LUT R87, R87, 0xffffe000, RZ, 0xc0, !PT"),
    (0x1710, "SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [R98+URZ+0xc008], R99"),
    (0x1af0, "WARPGROUP.ARRIVE"),
    (0x1b60, "HGMMA.64x64x8.F32.TF32 R24, gdesc[UR16], RZ, !UPT"),
    (0x1c30, "HGMMA.64x32x8.F32.TF32 R56, R84, gdesc[UR12], RZ, !UPT"),
    (0x1f80, "WARPGROUP.DEPBAR.LE gsb0, 0x0"),
    (0x1fd0, "@P0 ISETP.GE.AND P6, PT, R85, R100, PT")]
_LOOP_TAIL = [(0x4400, "@!P0 BRA 0x1710")]


@pytest.mark.parametrize("body,hit", [
    # overwritten after the wait: the next trip reads the new value
    ([(0x1fc0, "@P0 IMAD.IADD R85, R107, 0x1, R104")], [85]),
    ([(0x3620, "LOP3.LUT R84, R33, 0xffffe000, RZ, 0xc0, !PT")], [84]),
    ([(0x3000, "IMAD.WIDE.U32 R86, R2, 0x4, R6")], [86, 87]),
    ([(0x3000, "LDS.128 R80, [R2]")], []),
    ([(0x3000, "STS.128 [R2], R84")], []),
    ([(0x3000, "SHFL.BFLY PT, R87, R22, 0x1, 0x1f")], [87]),
    ([], []),
], ids=["imad", "lop3", "wide", "neighbour", "store", "shfl", "kept"])
def test_clobbered_wgmma_operands_finds_loop_carried_writes(body, hit):
    """``chip_smoke.clobbered_wgmma_operands`` flags a write, inside the
    loop, to a register A operand that the loop carries unchanged, and
    nothing that only reads it or writes other registers."""
    lines = _sass(*_LOOP_HEAD, *body, *_LOOP_TAIL)
    found = SMOKE.clobbered_wgmma_operands(lines)
    assert sorted(r for f in found for r in f[4]) == hit
    assert all(f[:2] == ("0x1c30", "R84") for f in found)


def test_clobbered_wgmma_operands_ignores_operands_set_in_the_loop():
    """P·V's A operands (p's parts) are made in each trip before their
    wgmma: writing them later in the trip is not a fault."""
    lines = _sass(*_LOOP_HEAD[:4],
                  (0x1c00, "LOP3.LUT R84, R33, 0xffffe000, RZ, 0xc0, !PT"),
                  *_LOOP_HEAD[4:],
                  (0x3620, "LOP3.LUT R85, R33, 0xffffe000, RZ, 0xc0, !PT"),
                  *_LOOP_TAIL)
    assert SMOKE.clobbered_wgmma_operands(lines) == []
    # and outside any loop nothing is carried
    assert SMOKE.clobbered_wgmma_operands(_sass(
        *_LOOP_HEAD, (0x3620, "LOP3.LUT R85, R3, 0x1, RZ, 0xc0, !PT"))) == []
