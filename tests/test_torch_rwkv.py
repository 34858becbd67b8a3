"""The port's RWKV-6 time mix and channel mix (``repro_torch.models.rwkv``)
against the JAX package's on the CPU.

Weights come from the JAX package's initialisers (carried across bit for
bit; ``w0`` and ``u`` stay float32 in a bfloat16 layer), inputs from a
numpy seed, each token scaled to RMS 1 as the layer's ``rms_norm`` hands
it over.  Tolerances are ``test_torch_lm.py``'s: float32 within atol
1e-4, bfloat16 one layer within atol 0.05.  T = 48 against a 32-step
chunk takes the chunk-halving fallback (32 → 16), as
``tests/test_recurrence.py`` does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rwkv as jr
from repro_torch import convert
from repro_torch.models import rwkv as tr
from test_torch_lm import ATOL, DTYPES, _cfgs, _close, _pair
from test_torch_mamba import _inputs

ARCH = "rwkv6-3b"


def _cfg(dtype, time_chunk=32):
    jcfg, tcfg = _cfgs(ARCH, dtype)
    return (dataclasses.replace(jcfg, time_chunk=time_chunk),
            dataclasses.replace(tcfg, time_chunk=time_chunk))


def _tensors(p):
    return {k: convert._lm_tensor(np.asarray(a), "cpu") for k, a in p.items()}


def _state(seed, b, jcfg):
    """A carried (shift, wkv) state: (B, D) in the layer's type and
    (B, H, K, V) float32."""
    rng = np.random.default_rng(seed)
    hd = jcfg.rwkv_head_size
    h = jcfg.d_model // hd
    xj, xt = _pair(rng.standard_normal((b, jcfg.d_model)), jcfg)
    s = rng.standard_normal((b, h, hd, hd)).astype(np.float32)
    return (xj, jnp.asarray(s)), (xt, torch.from_numpy(s))


def test_constants_and_float32_leaves():
    assert (tr.LOG_W_MIN, tr.LOG_W_MAX) == (jr.LOG_W_MIN, jr.LOG_W_MAX)
    jcfg, _ = _cfg("bfloat16")
    pt = _tensors(jr.init_rwkv_time_mix(jax.random.PRNGKey(0), jcfg))
    assert pt["w0"].dtype == pt["u"].dtype == torch.float32
    assert pt["wr"].dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t", [48, 64, 5])
@pytest.mark.parametrize("carried", [False, True],
                         ids=["zero-state", "carried-state"])
def test_rwkv_time_mix_matches(t, carried, dtype):
    jcfg, tcfg = _cfg(dtype)
    p = jr.init_rwkv_time_mix(jax.random.PRNGKey(1), jcfg)
    pt = _tensors(p)
    xj, xt = _inputs(t, (2, t, jcfg.d_model), jcfg)
    (sxj, swj), (sxt, swt) = _state(t + 1, 2, jcfg) if carried else \
        ((None, None), (None, None))
    want, (wx, ws) = jr.rwkv_time_mix(p, xj, jcfg, shift_state=sxj,
                                      wkv_state=swj)
    got, (gx, gs) = tr.rwkv_time_mix(pt, xt, tcfg, shift_state=sxt,
                                     wkv_state=swt)
    assert got.dtype == xt.dtype and gs.dtype == torch.float32
    _close(got, want, ATOL[dtype])
    _close(gx, wx, 0.0)
    _close(gs, ws, ATOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_rwkv_time_mix_matches(dtype):
    jcfg, tcfg = _cfg(dtype)
    p = jr.init_rwkv_time_mix(jax.random.PRNGKey(2), jcfg)
    pt = _tensors(p)
    (sxj, swj), (sxt, swt) = _state(3, 2, jcfg)
    cj = {"x": sxj, "s": swj}
    ct = {"x": sxt.clone(), "s": swt.clone()}
    bufs = (ct["x"], ct["s"])
    for step in range(3):
        xj, xt = _inputs(20 + step, (2, 1, jcfg.d_model), jcfg)
        want, cj = jr.decode_rwkv_time_mix(p, xj, cj, jcfg)
        got, ct = tr.decode_rwkv_time_mix(pt, xt, ct, tcfg)
        _close(got, want, ATOL[dtype])
        _close(ct["x"], cj["x"], 0.0)
        _close(ct["s"], cj["s"], ATOL[dtype])
    assert ct["x"] is bufs[0] and ct["s"] is bufs[1]      # in place


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("carried", [False, True],
                         ids=["zero-state", "carried-state"])
def test_rwkv_channel_mix_matches(carried, dtype):
    jcfg, tcfg = _cfg(dtype)
    p = jr.init_rwkv_channel_mix(jax.random.PRNGKey(3), jcfg)
    pt = _tensors(p)
    xj, xt = _inputs(9, (2, 48, jcfg.d_model), jcfg)
    (sxj, _), (sxt, _) = _state(4, 2, jcfg) if carried else \
        ((None, None), (None, None))
    want, wl = jr.rwkv_channel_mix(p, xj, shift_state=sxj)
    got, gl = tr.rwkv_channel_mix(pt, xt, shift_state=sxt)
    _close(got, want, ATOL[dtype])
    _close(gl, wl, 0.0)
    # one decode step, the cache written in place
    cache = {"x": sxt.clone() if carried else torch.zeros_like(xt[:, 0])}
    buf = cache["x"]
    cj = {"x": sxj if carried else jnp.zeros_like(xj[:, 0])}
    want, cj = jr.decode_rwkv_channel_mix(p, xj[:, :1], cj)
    got, cache = tr.decode_rwkv_channel_mix(pt, xt[:, :1], cache)
    _close(got, want, ATOL[dtype])
    assert cache["x"] is buf
    _close(cache["x"], cj["x"], 0.0)


def test_chunked_equals_sequential_decode():
    """The time mix over T = 48 tokens against 48 decode steps from a
    zero cache, the reference's own check (``tests/test_recurrence.py``,
    which allows 2e-2) on the port, float32."""
    jcfg, tcfg = _cfg("float32")
    pt = _tensors(jr.init_rwkv_time_mix(jax.random.PRNGKey(7), jcfg))
    _, x = _inputs(5, (2, 48, tcfg.d_model), jcfg)
    out, (_, s_f) = tr.rwkv_time_mix(pt, x, tcfg)
    hd = tcfg.rwkv_head_size
    cache = {"x": torch.zeros((2, tcfg.d_model)),
             "s": torch.zeros((2, tcfg.d_model // hd, hd, hd))}
    seq = torch.cat([tr.decode_rwkv_time_mix(pt, x[:, i:i + 1], cache,
                                             tcfg)[0] for i in range(48)], 1)
    _close(out, seq, 1e-3)
    _close(s_f, cache["s"], 1e-3)
