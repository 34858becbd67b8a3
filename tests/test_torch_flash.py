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
    tilings: 64-row tiles with exp (the float32 route's order) and the
    sm90 kernel's 128-row q and kv tiles with exp2 and log2 e folded
    into the scale.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_flash_kernel import CASES, ref_attn

from repro.configs import get_smoke_config as jax_smoke_config
from repro.kernels.flash_attention import flash_attention_kernel as pallas
from repro.models.attention import flash_attention as jax_flash
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import FLASH_KERNEL, flash_attention_kernel
from repro_torch.kernels.flash_attention import (FLASH_SM90_TILES,
                                                FLASH_TILE, LOG2E)
from repro_torch.kernels.ref import flash_attention_plain, flash_bf16_limits
from repro_torch.models.attention import flash_attention

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
    q0 = (t - 1) // FLASH_TILE * FLASH_TILE
    assert (q0 - win + 1) // FLASH_TILE >= 2
    (qj, kj, vj), (qt, kt, vt) = _qkv(1, t, 4, 2, 32, win)
    want = ref_attn(qj, kj, vj, win)
    assert _err(flash_attention_plain(qt, kt, vt, window=win), want) < 2e-5
    # a window at least T long is full causal attention
    full = flash_attention_plain(qt, kt, vt, window=t)
    assert _err(full, ref_attn(qj, kj, vj, 0)) < 2e-5


def test_q_offset_raises_on_cpu():
    cfg = get_smoke_config("granite-3-8b")
    _, (q, k, v) = _qkv(1, 64, 4, 2, 32, 0)
    with pytest.raises(NotImplementedError, match="q_offset"):
        flash_attention(q, k, v, cfg, q_offset=1)


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
def tiled_flash(q, k, v, window=0, fault=None, tiles=(FLASH_TILE,
                                                       FLASH_TILE),
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


# the tilings tiled_flash runs: (tiles, exp2), by route
K4_ORDERS = {"f32": ((FLASH_TILE, FLASH_TILE), False),
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
