"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX
package's on the CPU.

Weights come from the JAX package's ``init_moe`` (carried across bit for
bit), inputs from a numpy seed.  Tolerances are ``test_torch_lm.py``'s:
float32 within atol 1e-4, bfloat16 one layer within atol 0.05.  The
route (each assignment's virtual expert, token, position in its expert
and whether it was kept) must be equal, not close: at float32 the
router's probabilities differ in their last bits at most, and no token
of these inputs has two experts that close.

The smoke configs are drop-free (``capacity_factor`` = E); the cases at
the production factor 1.25 reach the drop path, and assert that drops
happened.  The inputs carry one offset shared by every token (as real
activations share a common component), which skews the router's load
across experts; without it these random routers spread tokens evenly
enough that no expert overflows 1.25 times its mean.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jm
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import moe as tm
from test_torch_lm import ATOL, _cfgs, _close, _pair

# (arch, capacity factor or None for the smoke config's, T)
CASES = [("jamba-v0.1-52b", None, 48), ("mixtral-8x7b", None, 40),
         ("jamba-v0.1-52b", 1.25, 64), ("mixtral-8x7b", 1.25, 96)]


def _moe(arch, dtype, factor, seed=0):
    jcfg, tcfg = _cfgs(arch, dtype)
    if factor is not None:
        jcfg = dataclasses.replace(jcfg, capacity_factor=factor)
        tcfg = dataclasses.replace(tcfg, capacity_factor=factor)
    p = jm.init_moe(jax.random.PRNGKey(seed), jcfg,
                    split=jcfg.moe_ep_split)
    pt = {k: convert._lm_tensor(np.asarray(a), "cpu") for k, a in p.items()}
    return jcfg, tcfg, p, pt


def _inputs(seed, b, t, jcfg):
    """(JAX array, torch tensor) of (b, t, d) tokens: N(0, 1) plus one
    N(0, 1) offset per feature shared by every token, each token scaled
    to RMS 1, as the layer's ``rms_norm`` (scale 1) hands it to the
    FFN."""
    rng = np.random.default_rng(seed)
    d = jcfg.d_model
    x = rng.standard_normal((b, t, d)) + rng.standard_normal(d)
    return _pair(x / np.sqrt(np.mean(x * x, axis=-1, keepdims=True)), jcfg)


def _jax_route(p, xj, jcfg, cap):
    e, k = jcfg.moe_experts, jcfg.moe_top_k
    split = p["w1"].shape[0] // e
    return jax.vmap(lambda xr: jm._route_row(xr, p["router"], e, k, cap,
                                             split))(xj)


def _assert_same_route(got, want):
    se, st, sw, pos, keep = got[:5]
    wse, wst, wsw, wpos, wkeep = (np.asarray(a) for a in want[:5])
    assert np.array_equal(se.numpy(), wse)
    assert np.array_equal(st.numpy(), wst)
    assert np.array_equal(pos.numpy(), wpos)
    assert np.array_equal(keep.numpy(), wkeep)
    np.testing.assert_allclose(sw.numpy(), wsw, atol=1e-6)


def test_capacity_is_the_references():
    for arch, factor, t in CASES + [("jamba-v0.1-52b", 1.25, 1),
                                    ("jamba-v0.1-52b", 1.25, 2048)]:
        jcfg, tcfg, _, _ = _moe(arch, "float32", factor)
        e, k = jcfg.moe_experts, jcfg.moe_top_k
        cap = int(jcfg.capacity_factor * k * t / e + 0.999)
        cap = min(max(8, -(-cap // 8) * 8), t * k)
        assert tm.capacity(tcfg, t) == cap
    # the card's jamba cell: T 2048, 16 experts, factor 1.25
    assert tm.capacity(get_config("jamba-v0.1-52b"), 2048) == 320


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,factor,t", CASES)
def test_moe_ffn_matches(arch, factor, t, dtype):
    jcfg, tcfg, p, pt = _moe(arch, dtype, factor)
    xj, xt = _inputs(t, 2, t, jcfg)
    want, want_aux = jm.moe_ffn(p, xj, jcfg)
    got, aux = tm.moe_ffn(pt, xt, tcfg)
    assert got.shape == want.shape and got.dtype == xt.dtype
    _close(got, want, ATOL[dtype])
    assert aux.dtype == torch.float32
    _close(aux, want_aux, 1e-5)


@pytest.mark.parametrize("arch,factor,t", CASES)
def test_route_and_drops_equal_the_references(arch, factor, t):
    jcfg, tcfg, p, pt = _moe(arch, "float32", factor)
    xj, xt = _inputs(t, 2, t, jcfg)
    cap = tm.capacity(tcfg, t)
    e, k = tcfg.moe_experts, tcfg.moe_top_k
    split = pt["w1"].shape[0] // e
    got = tm._route(xt, pt["router"], e, k, cap, split)
    want = _jax_route(p, xj, jcfg, cap)
    _assert_same_route(got, want)
    _close(got[6], want[5], 1e-6)                     # aux per row
    dropped = int((~got[4]).sum())
    if factor is None:
        assert dropped == 0                           # drop-free smoke
    else:
        assert dropped > 0, "no assignment past capacity"


def test_dropped_tokens_get_nothing_from_their_expert():
    """At capacity 1.25 a dropped assignment adds 0: the port's output
    equals a combine over the kept assignments alone, computed here
    token by token from the expert FFNs."""
    jcfg, tcfg, p, pt = _moe("jamba-v0.1-52b", "float32", 1.25)
    t = 64
    _, x = _inputs(3, 1, t, jcfg)
    out, _ = tm.moe_ffn(pt, x, tcfg)
    cap = tm.capacity(tcfg, t)
    e, k = tcfg.moe_experts, tcfg.moe_top_k
    split = pt["w1"].shape[0] // e
    se, st, sw, _, keep, _, _ = tm._route(x, pt["router"], e, k, cap, split)
    want = torch.zeros_like(x[0])
    for a in range(se.shape[1]):
        if not keep[0, a]:
            continue
        ex, tok = int(se[0, a]), int(st[0, a])
        row = x[0, tok]
        h = torch.nn.functional.silu(row @ pt["w1"][ex]) * (row
                                                            @ pt["w3"][ex])
        want[tok] += sw[0, a] * (h @ pt["w2"][ex])
    assert int((~keep).sum()) > 0
    _close(out[0], want, 1e-4)


def test_top_k_tie_takes_the_lower_expert():
    """Experts 1 and 3 with the same router column tie exactly; where
    the pair ranks second and third, ``jax.lax.top_k`` keeps expert 1,
    and so must the port (``torch.topk`` promises no order on a tie)."""
    jcfg, tcfg, p, pt = _moe("mixtral-8x7b", "float32", None)
    rng = np.random.default_rng(11)
    d = jcfg.d_model
    a, b = rng.standard_normal((2, d)).astype(np.float32) * d ** -0.5
    router = np.stack([3 * a, b, -3 * b, b], axis=1).astype(np.float32)
    p = dict(p, router=jnp.asarray(router))
    pt = dict(pt, router=torch.from_numpy(router))
    t = 64
    xj, xt = _pair(rng.standard_normal((2, t, d)), jcfg)
    probs = torch.softmax(xt @ pt["router"], dim=-1)
    assert torch.equal(probs[..., 1], probs[..., 3])
    # tokens whose top expert is 0 and whose runner-up is the tied pair
    second = (probs[..., 0] > probs[..., 1]) & (probs[..., 1]
                                                > probs[..., 2])
    assert int(second.sum()) > 4
    cap = tm.capacity(tcfg, t)
    e, k = tcfg.moe_experts, tcfg.moe_top_k
    split = pt["w1"].shape[0] // e
    got = tm._route(xt, pt["router"], e, k, cap, split)
    want = _jax_route(p, xj, jcfg, cap)
    _assert_same_route(got, want)
    chosen = got[0] // split                      # real expert per slot
    assert int((chosen == 3).sum()) < int((chosen == 1).sum())
    out, _ = tm.moe_ffn(pt, xt, tcfg)
    want_out, _ = jm.moe_ffn(p, xj, jcfg)
    _close(out, want_out, ATOL["float32"])


def test_decode_shape_keeps_every_assignment():
    """At T = 1 the capacity is k and nothing drops, as in the
    reference's decode step."""
    jcfg, tcfg, p, pt = _moe("jamba-v0.1-52b", "float32", 1.25)
    assert tm.capacity(tcfg, 1) == tcfg.moe_top_k
    xj, xt = _inputs(8, 3, 1, jcfg)
    got, _ = tm.moe_ffn(pt, xt, tcfg)
    want, _ = jm.moe_ffn(p, xj, jcfg)
    _close(got, want, ATOL["float32"])


def test_ep_split_is_the_references():
    for arch in ("jamba-v0.1-52b", "mixtral-8x7b"):
        jcfg, tcfg = _cfgs(arch, "float32")
        for n in (1, 2, 4, 8, 16, 32, 3):
            assert tm.ep_split(tcfg, n) == jm.ep_split(jcfg, n)
