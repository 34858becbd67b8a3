"""The Mamba block split into d_inner slices, as the port's sharded step
runs it with d_inner over "model" (``models.transformer._mamba_sharded``),
against the JAX package's block on the CPU; and the index map of the
gather that hands each model rank its block of a dim stored over
("data", "model") (``models.sharding.block_plan``).

Each slice j of |model| = 2 or 4 runs ``mamba_split_in`` on its columns
of both halves of ``w_in``, of ``conv_w`` and ``conv_b`` and its rows of
``w_x``; the slices' partial projections are summed as the all-reduce
between the two regions sums them, then each slice runs
``mamba_split_out`` on its columns of ``w_dt``, its ``b_dt``, ``a_log``
and ``d_skip`` and its rows of ``w_out``, and the partial outputs are
summed as the layer's settle sums them.  The outputs, the final SSM and
conv states (the slices' side by side) and three decode steps from a
carried state are held to ``repro.models.mamba`` in float32 within 1e-5
(max |port − JAX|), on inputs from a numpy seed.

The index map is checked without a process group for every (|data|,
|model|) in {1, 2, 4, 16}², for one part and for the x and z halves of
``w_in``: the rows each model rank assembles, simulated on numpy row ids
through the all-gather over "data" and the all-to-all over "model", are
its logical model block(s), no rank receives more than N/|model| rows,
and the backward's plan takes a gradient partial over "data" home to
the stored blocks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba as jm
from repro_torch import convert
from repro_torch.models import mamba as tm
from repro_torch.models.sharding import block_plan
from test_torch_lm import _cfgs, _close, _pair

ARCH = "jamba-v0.1-52b"
TOL = 1e-5
SIZES = (1, 2, 4, 16)


def _mamba(seed=0):
    jcfg, tcfg = _cfgs(ARCH, "float32")
    p = jm.init_mamba(jax.random.PRNGKey(seed), jcfg)
    # the init's zero conv_b and constant b_dt would hide a slice mixed up
    rng = np.random.default_rng(seed + 100)
    for k in ("conv_b", "b_dt", "d_skip"):
        p[k] = p[k] + jnp.asarray(0.1 * rng.standard_normal(p[k].shape),
                                  p[k].dtype)
    pt = {k: convert._lm_tensor(np.asarray(a), "cpu") for k, a in p.items()}
    return jcfg, tcfg, p, pt


def _inputs(seed, shape):
    x = np.random.default_rng(seed).standard_normal(shape)
    x = x / np.sqrt(np.mean(x * x, axis=-1, keepdims=True))
    a = np.asarray(x, np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _slices(pt, di, model):
    """Each slice's weights: its d_inner columns / rows."""
    w = di // model
    out = []
    for j in range(model):
        c = slice(j * w, (j + 1) * w)
        out.append({
            "w_in": torch.cat([pt["w_in"][:, c],
                               pt["w_in"][:, di + j * w:di + (j + 1) * w]],
                              dim=1),
            "conv_w": pt["conv_w"][:, c], "conv_b": pt["conv_b"][c],
            "w_x": pt["w_x"][c], "w_dt": pt["w_dt"][:, c],
            "b_dt": pt["b_dt"][c], "a_log": pt["a_log"][c],
            "d_skip": pt["d_skip"][c], "w_out": pt["w_out"][c]})
    return out


def _split(parts, x, cfg, conv=None, ssm=None):
    """The block over the slices: (output, conv state, SSM state)."""
    model = len(parts)
    w = parts[0]["conv_b"].shape[0]

    def cut(t, d, j):
        return None if t is None else t.narrow(d, j * w, w)
    ins = [tm.mamba_split_in(p, x, cfg, cut(conv, 2, j))
           for j, p in enumerate(parts)]
    proj = sum(i[2] for i in ins)                  # the all-reduce
    outs = [tm.mamba_split_out(p, xc, z, proj, cfg, cut(ssm, 1, j))
            for j, (p, (xc, z, _, _)) in enumerate(zip(parts, ins))]
    out = sum(o[0] for o in outs)                  # the layer's settle
    assert len(ins) == model
    return (out, torch.cat([i[3] for i in ins], dim=2),
            torch.cat([o[1] for o in outs], dim=1))


def _jax_prefill(p, x, cfg):
    """The JAX block's output and the states its prefill leaves."""
    xz = x @ p["w_in"]
    x_p, _ = jnp.split(xz, 2, axis=-1)
    xc, conv = jm._causal_conv(x_p, p["conv_w"], p["conv_b"])
    h0 = jnp.zeros((x.shape[0], cfg.d_inner, cfg.mamba_d_state),
                   jnp.float32)
    _, h_f = jm._chunked_ssm(p, jax.nn.silu(xc), cfg, h0)
    return jm.mamba_block(p, x, cfg), conv, h_f


@pytest.mark.parametrize("model", (2, 4))
@pytest.mark.parametrize("t", (32, 3), ids=["t32", "t3"])
def test_split_block_matches_reference(model, t):
    """T = 32 runs two chunks of the smoke config's 16; T = 3 is shorter
    than the conv."""
    jcfg, tcfg, p, pt = _mamba()
    xj, xt = _inputs(1, (2, t, jcfg.d_model))
    want, conv_w, ssm_w = _jax_prefill(p, xj, jcfg)
    got, conv_g, ssm_g = _split(_slices(pt, tcfg.d_inner, model), xt, tcfg)
    _close(got, want, TOL)
    _close(conv_g, conv_w, TOL)
    _close(ssm_g, ssm_w, TOL)


@pytest.mark.parametrize("model", (2, 4))
def test_split_decode_matches_reference(model):
    """Three one-token steps from a random carried state, each slice
    stepping its own columns of the conv and SSM states."""
    jcfg, tcfg, p, pt = _mamba(seed=1)
    rng = np.random.default_rng(7)
    b, di, ds, dc = 2, jcfg.d_inner, jcfg.mamba_d_state, jcfg.mamba_d_conv
    cj = {"conv": jnp.asarray(rng.standard_normal((b, dc - 1, di)),
                              jnp.float32),
          "ssm": jnp.asarray(rng.standard_normal((b, di, ds)), jnp.float32)}
    conv, ssm = (torch.from_numpy(np.array(cj[k])) for k in cj)
    parts = _slices(pt, di, model)
    for step in range(3):
        xj, xt = _inputs(10 + step, (b, 1, jcfg.d_model))
        want, cj = jm.decode_mamba_block(p, xj, cj, jcfg)
        got, conv, ssm = _split(parts, xt, tcfg, conv, ssm)
        _close(got, want, TOL)
        _close(conv, cj["conv"], TOL)
        _close(ssm, cj["ssm"], TOL)


# --------------------------------------------------------- the index map
def _apply(buf, runs):
    return np.concatenate([buf[a:b] for a, b in runs]) if runs else buf[:0]


def _exchange(bufs, send_counts, model):
    """An all-to-all of each model rank's rows: rank m's buffer cut by its
    ``send_counts[m]``; rank j receives the j-th piece of each in turn."""
    pieces = []
    for m in range(model):
        cuts = np.cumsum((0,) + tuple(send_counts[m]))
        pieces.append([bufs[m][cuts[k]:cuts[k + 1]] for k in range(model)])
    return [np.concatenate([pieces[m][j] for m in range(model)])
            for j in range(model)]


def _stored(n, data, model):
    s = n // (data * model)
    return {(i, j): np.arange((i * model + j) * s, (i * model + j + 1) * s)
            for i in range(data) for j in range(model)}


def _want(n, model, parts, j):
    """Model rank j's logical rows: part p's block j of each part."""
    span, blk = n // parts, n // (parts * model)
    return np.concatenate([np.arange(p * span + j * blk,
                                     p * span + (j + 1) * blk)
                           for p in range(parts)])


@pytest.mark.parametrize("parts", (1, 2), ids=["whole", "w_in-halves"])
@pytest.mark.parametrize("data", SIZES)
@pytest.mark.parametrize("model", SIZES)
def test_block_plan_assembles_model_blocks(model, data, parts):
    n = data * model * parts * 3
    s = n // (data * model)
    plans = [block_plan(n, data, model, j, parts) for j in range(model)]
    stored = _stored(n, data, model)
    # forward: the all-gather over data (alike on every data rank), the
    # send order, the exchange over model, the assembly
    gathered = [np.concatenate([stored[i, j] for i in range(data)])
                for j in range(model)]
    recv = _exchange([_apply(g, pl.send) for g, pl in zip(gathered, plans)],
                     [pl.send_counts for pl in plans], model)
    for j, pl in enumerate(plans):
        assert sum(pl.recv_counts) == len(recv[j]) == n // model
        assert np.array_equal(_apply(recv[j], pl.assemble),
                              _want(n, model, parts, j))
    # backward: data rank i's gradient of a row is (row + 1)·(i + 1), a
    # partial sum; the reversed exchange and the reduce-scatter over data
    # take Σ_i (row + 1)·(i + 1) to the row's stored block
    home = {key: 0.0 for key in stored}
    for i in range(data):
        back = _exchange([_apply((_want(n, model, parts, j) + 1.0) * (i + 1),
                                 pl.back_send)
                          for j, pl in enumerate(plans)],
                         [pl.recv_counts for pl in plans], model)
        for j, pl in enumerate(plans):
            g = _apply(back[j], pl.back_place)
            for i2 in range(data):
                home[i2, j] = home[i2, j] + g[i2 * s:(i2 + 1) * s]
    for key, rows in stored.items():
        assert np.array_equal(home[key], (rows + 1.0) * data * (data + 1) / 2)


def test_block_plan_refuses_a_ragged_dim():
    with pytest.raises(ValueError):
        block_plan(10, 2, 2, 0)
