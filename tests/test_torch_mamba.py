"""The port's Mamba block (``repro_torch.models.mamba``) against the JAX
package's on the CPU.

Weights come from the JAX package's ``init_mamba`` (carried across bit
for bit; ``a_log`` and ``d_skip`` stay float32 in a bfloat16 layer),
inputs from a numpy seed, each token scaled to RMS 1 as the layer's
``rms_norm`` hands it over.  Tolerances are ``test_torch_lm.py``'s:
float32 within atol 1e-4 (the port's Hillis–Steele scan adds the same
float32 terms as ``lax.associative_scan`` in another order), bfloat16
one layer within atol 0.05.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba as jm
from repro_torch import convert
from repro_torch.models import mamba as tm
from test_torch_lm import ATOL, DTYPES, _cfgs, _close, _pair

ARCH = "jamba-v0.1-52b"


def _mamba(dtype, time_chunk=None, seed=0):
    jcfg, tcfg = _cfgs(ARCH, dtype)
    if time_chunk is not None:
        jcfg = dataclasses.replace(jcfg, time_chunk=time_chunk)
        tcfg = dataclasses.replace(tcfg, time_chunk=time_chunk)
    p = jm.init_mamba(jax.random.PRNGKey(seed), jcfg)
    pt = {k: convert._lm_tensor(np.asarray(a), "cpu") for k, a in p.items()}
    return jcfg, tcfg, p, pt


def _inputs(seed, shape, jcfg):
    """(JAX array, torch tensor) of seeded N(0, 1) rows scaled to RMS 1,
    in the config's type."""
    x = np.random.default_rng(seed).standard_normal(shape)
    return _pair(x / np.sqrt(np.mean(x * x, axis=-1, keepdims=True)), jcfg)


def test_float32_leaves_stay_float32():
    _, _, _, pt = _mamba("bfloat16")
    assert pt["a_log"].dtype == pt["d_skip"].dtype == torch.float32
    assert pt["w_in"].dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t,chunk", [(32, None), (48, 32), (40, 32),
                                     (3, None)],
                         ids=["t32", "t48-chunk32", "t40-chunk32", "t3"])
def test_mamba_block_matches(t, chunk, dtype):
    """T = 48 and 40 against a 32-step chunk take the chunk-halving
    fallback (32 → 16, 32 → 8); T = 3 is shorter than the conv."""
    jcfg, tcfg, p, pt = _mamba(dtype, chunk)
    if chunk:
        assert t % chunk and t % tm._chunk_len(tcfg, t) == 0
    xj, xt = _inputs(t, (2, t, jcfg.d_model), jcfg)
    want = jm.mamba_block(p, xj, jcfg)
    got = tm.mamba_block(pt, xt, tcfg)
    assert got.shape == want.shape and got.dtype == xt.dtype
    _close(got, want, ATOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_causal_conv_with_carried_state(dtype):
    jcfg, tcfg, p, pt = _mamba(dtype)
    rng = np.random.default_rng(4)
    di, dc = jcfg.d_inner, jcfg.mamba_d_conv
    xj, xt = _pair(rng.standard_normal((2, 5, di)), jcfg)
    sj, st = _pair(rng.standard_normal((2, dc - 1, di)), jcfg)
    for state in ((None, None), (sj, st)):
        want, want_s = jm._causal_conv(xj, p["conv_w"], p["conv_b"],
                                       state=state[0])
        got, got_s = tm._causal_conv(xt, pt["conv_w"], pt["conv_b"],
                                     state=state[1])
        assert got.dtype == xt.dtype
        _close(got, want, ATOL[dtype])
        _close(got_s, want_s, 0.0)               # a slice: exact


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_mamba_block_matches(dtype):
    """Three decode steps from a random carried state (conv and SSM),
    the cache written in place."""
    jcfg, tcfg, p, pt = _mamba(dtype)
    rng = np.random.default_rng(7)
    b, di, ds, dc = 2, jcfg.d_inner, jcfg.mamba_d_state, jcfg.mamba_d_conv
    cj = {"conv": jnp.asarray(rng.standard_normal((b, dc - 1, di)),
                              jnp.float32).astype(jcfg.jnp_dtype),
          "ssm": jnp.asarray(rng.standard_normal((b, di, ds)), jnp.float32)}
    ct = {k: convert._lm_tensor(np.asarray(a), "cpu") for k, a in cj.items()}
    conv_buf, ssm_buf = ct["conv"], ct["ssm"]
    for step in range(3):
        xj, xt = _inputs(10 + step, (b, 1, jcfg.d_model), jcfg)
        want, cj = jm.decode_mamba_block(p, xj, cj, jcfg)
        got, ct = tm.decode_mamba_block(pt, xt, ct, tcfg)
        _close(got, want, ATOL[dtype])
        # the conv state holds x @ w_in, the SSM state float32 sums of
        # terms made in the layer's type
        _close(ct["conv"], cj["conv"], ATOL[dtype])
        _close(ct["ssm"], cj["ssm"], ATOL[dtype])
    assert ct["conv"] is conv_buf and ct["ssm"] is ssm_buf   # in place


def test_prefix_scan_is_the_sequential_recurrence():
    """The Hillis–Steele scan against h_t = a_t·h_{t−1} + b_t, step by
    step, float64, over chunk lengths that are and are not powers of
    two."""
    rng = np.random.default_rng(2)
    for c in (1, 7, 16, 64):
        a = torch.from_numpy(rng.random((2, c, 3, 4)))
        b = torch.from_numpy(rng.standard_normal((2, c, 3, 4)))
        aa, bb = tm._prefix_scan(a, b)
        h = torch.zeros((2, 3, 4), dtype=torch.float64)
        prod = torch.ones((2, 3, 4), dtype=torch.float64)
        for i in range(c):
            h = a[:, i] * h + b[:, i]
            prod = prod * a[:, i]
            assert torch.allclose(bb[:, i], h, atol=1e-12)
            assert torch.allclose(aa[:, i], prod, atol=1e-12)


def test_chunked_equals_sequential_decode():
    """The block over T = 32 tokens against 32 decode steps from a zero
    cache, the reference's own check (``tests/test_recurrence.py``) on
    the port, float32."""
    jcfg, tcfg, p, pt = _mamba("float32")
    _, x = _inputs(1, (2, 32, tcfg.d_model), jcfg)
    full = tm.mamba_block(pt, x, tcfg)
    cache = tm.init_mamba_cache(2, tcfg, torch.float32, "cpu")
    seq = torch.cat([tm.decode_mamba_block(pt, x[:, i:i + 1], cache,
                                           tcfg)[0] for i in range(32)], 1)
    _close(full, seq, ATOL["float32"])
    _, state = tm._mamba_prefill(pt, x, tcfg)
    _close(state["ssm"], cache["ssm"], ATOL["float32"])
    _close(state["conv"], cache["conv"], ATOL["float32"])
