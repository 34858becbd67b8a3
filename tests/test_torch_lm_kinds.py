"""The port's LM serving path for the MoE, Mamba and RWKV layer kinds
and the modality frontends, whole model, against the JAX package on the
CPU: jamba at 16 layers (2 periods, so that period index 1 is carried
across), mixtral, rwkv6-3b, and musicgen-medium and llava-next-34b with
their frontends, each at its smoke width.  ``forward`` with the frontend
in front of the tokens and the MoE layers' aux losses summed, the
serving prefill with every cache compared through ``convert.lm_caches``,
decode steps and a greedy serve loop.

Tolerances are ``tests/test_torch_lm.py``'s: float32 within 1e-4 for all
five (logits, caches; the MoE routes follow), ``MODEL_BF16`` for the two
dense frontend configs at bfloat16.  The MoE, Mamba and RWKV configs at
bfloat16 are held to the reference's own bfloat16 error instead
(``test_kind_bf16_is_as_close_to_float32_as_the_reference``): the
reference's own bfloat16 logits lie farther than ``MODEL_BF16`` from its
float32 logits (jamba at 16 layers: mean 0.05–0.08, max up to 3.8, where
a MoE route flips on a near tie), so no port that rounds anywhere
differently could be held to it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as jt
from repro_torch import convert
from repro_torch.models import transformer as tt
from repro_torch.train.steps import serve_step
from test_torch_lm import (ATOL, MODEL_BF16, _cfgs, _close,
                           _close_model, _jdecode, _jprefill, _jserve_step,
                           _np, _pair, _prompts)

_jforward = jax.jit(jt.forward, static_argnames=("cfg",))

# ------------------------------------------ every layer kind, whole model
# the smoke configs of the layer kinds beyond (attn, mlp), and the two
# with a modality frontend; jamba at 2 periods, so that period index 1 is
# carried across.  float32 for all five (the strict gate: logits, caches
# and MoE routes against the reference within 1e-4); bfloat16 against
# MODEL_BF16 for the two dense frontend configs, and for the MoE, Mamba
# and RWKV configs against the reference's own bfloat16 error
# (test_kind_bf16_is_as_close_to_float32_as_the_reference)
KINDS = {"jamba-v0.1-52b": {"n_layers": 16}, "mixtral-8x7b": {},
         "rwkv6-3b": {}, "musicgen-medium": {}, "llava-next-34b": {}}
KIND_MODELS = ([(a, "float32") for a in KINDS]
               + [(a, "bfloat16") for a in ("musicgen-medium",
                                            "llava-next-34b")])
# mean |Δ| and relative Frobenius norm of the port's bfloat16 logits
# against the reference's float32 ones, at most this multiple of the
# reference's own bfloat16 logits' (8 prompts × 48 tokens)
KIND_BF16_RATIO = 1.5


def _kind_cfgs(arch, dtype):
    jcfg, tcfg = _cfgs(arch, dtype)
    return (dataclasses.replace(jcfg, **KINDS[arch]),
            dataclasses.replace(tcfg, **KINDS[arch]))


@pytest.fixture(scope="module", params=KIND_MODELS,
                ids=lambda p: f"{p[0]}-{p[1]}")
def kind_model(request):
    arch, dtype = request.param
    jcfg, tcfg = _kind_cfgs(arch, dtype)
    params = jt.init_params(jax.random.PRNGKey(0), jcfg)
    port = convert.lm_params(jax.tree.map(np.asarray, params), tcfg, "cpu")
    return dtype, jcfg, tcfg, params, port


def _frontend(cfg, b, seed):
    """(JAX array, torch tensor) of (b, F, D) frontend embeddings, or
    (None, None) for a config without a frontend."""
    if not cfg.frontend_tokens:
        return None, None
    a = np.random.default_rng(seed).standard_normal(
        (b, cfg.frontend_tokens, cfg.d_model)) * 0.02
    return _pair(a, cfg)


def test_kind_model_carries_every_layer(kind_model):
    dtype, jcfg, tcfg, params, port = kind_model
    assert [layer.kind for layer in port.layers] == [
        jcfg.layer_kind(i) for i in range(jcfg.n_layers)]
    for i, layer in enumerate(port.layers):
        period, pos = divmod(i, jcfg.period)
        src = params["periods"][pos]
        for part in ("mixer", "ffn"):
            for name, a in src[part].items():
                got = getattr(layer, part)[name]
                assert got.dtype == convert._lm_tensor(
                    np.asarray(a[period]), "cpu").dtype
                assert np.array_equal(_np(got), _np(a[period]))


def test_kind_forward_matches(kind_model):
    """``forward`` with the frontend in front of the tokens (where the
    config has one) and the MoE layers' aux losses summed."""
    dtype, jcfg, tcfg, params, port = kind_model
    toks = _prompts(2, 48, jcfg.vocab_size, seed=3)
    fj, ft = _frontend(jcfg, 2, 4)
    want, want_aux = _jforward(params, jnp.asarray(toks), cfg=jcfg,
                               frontend=fj)
    got, aux = tt.forward(port, torch.from_numpy(toks), tcfg, frontend=ft)
    assert got.shape == want.shape
    _close_model(got[..., :jcfg.vocab_size], want[..., :jcfg.vocab_size],
                 dtype)
    assert aux.dtype == torch.float32
    if tcfg.moe_experts:
        assert float(aux) > 0
    _close(aux, want_aux, ATOL[dtype])


# one prefill shape for the prefill, decode and greedy tests (the JAX
# steps compile once per config and shape)
B, T, GEN = 3, 40, 4


def _kind_prefill(kind_model, seed, b=B, t=T, max_len=T + GEN):
    dtype, jcfg, tcfg, params, port = kind_model
    toks = _prompts(b, t, jcfg.vocab_size, seed)
    lj, cj = _jprefill(params, jnp.asarray(toks), cfg=jcfg, max_len=max_len)
    lt, ct = tt.prefill_with_cache(port, torch.from_numpy(toks), tcfg,
                                   max_len)
    return (lj, cj), (lt, ct)


def _close_caches(got, want_tree, jcfg, tcfg, dtype):
    want = convert.lm_caches(jax.tree.map(np.asarray, want_tree), tcfg,
                             "cpu")
    assert len(got) == len(want) == tcfg.n_layers
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for kind in g:
            assert sorted(g[kind]) == sorted(w[kind])
            for name, a in g[kind].items():
                assert a.shape == w[kind][name].shape
                assert a.dtype == w[kind][name].dtype
                _close_model(a, w[kind][name], dtype)


def test_kind_prefill_with_cache_matches(kind_model):
    """The serving prefill and every cache it fills, compared through
    ``convert.lm_caches``."""
    dtype, jcfg, tcfg, params, port = kind_model
    (lj, cj), (lt, ct) = _kind_prefill(kind_model, seed=1)
    v = jcfg.vocab_size
    _close_model(lt[..., :v], lj[..., :v], dtype)
    _close_caches(ct, cj, jcfg, tcfg, dtype)


def test_short_prompt_pads_the_mamba_conv_state():
    """A prompt of T = 2 tokens, fewer than the d_conv − 1 = 3 inputs the
    Mamba conv carries: the prefill's conv state holds a zero row in
    front, as the reference's (jamba's smoke config, one period,
    float32)."""
    jcfg, tcfg = _cfgs("jamba-v0.1-52b", "float32")
    params = jt.init_params(jax.random.PRNGKey(1), jcfg)
    port = convert.lm_params(jax.tree.map(np.asarray, params), tcfg, "cpu")
    model = ("float32", jcfg, tcfg, params, port)
    (lj, cj), (lt, ct) = _kind_prefill(model, seed=3, b=2, t=2, max_len=8)
    _close_model(lt[..., :jcfg.vocab_size], lj[..., :jcfg.vocab_size],
                 "float32")
    _close_caches(ct, cj, jcfg, tcfg, "float32")
    conv = [c["mamba"]["conv"] for c in ct if "mamba" in c]
    assert conv and all(not torch.any(c[:, 0]) for c in conv)


def test_kind_decode_step_matches(kind_model):
    dtype, jcfg, tcfg, params, port = kind_model
    t = T
    (lj, cj), (lt, ct) = _kind_prefill(kind_model, seed=5)
    tok = np.asarray(jnp.argmax(lj[:, -1:], axis=-1)).astype(np.int32)
    for i in range(2):
        dj, cj = _jdecode(params, jnp.asarray(tok), cj, jnp.int32(t + i),
                          cfg=jcfg)
        dt_, ct = tt.decode_step(port, torch.from_numpy(tok), ct, t + i,
                                 tcfg)
        v = jcfg.vocab_size
        _close_model(dt_[..., :v], dj[..., :v], dtype)
        _close_caches(ct, cj, jcfg, tcfg, dtype)
        tok = np.asarray(jnp.argmax(dj[:, -1:], axis=-1)).astype(np.int32)


def test_kind_greedy_serve_loop_matches(kind_model):
    """4 greedy tokens through each package's ``serve_step``, each side
    feeding its own tokens back; equal wherever the JAX logits' top-2
    margin exceeds twice the logits' tolerance, as
    ``test_greedy_serve_loop_matches``."""
    dtype, jcfg, tcfg, params, port = kind_model
    b, t, gen = B, T, GEN
    (lj, cj), (lt, ct) = _kind_prefill(kind_model, seed=9)
    tj = jnp.argmax(lj[:, -1:], axis=-1).astype(jnp.int32)
    tt_ = torch.argmax(lt[:, -1:], dim=-1).to(torch.int32)
    live = np.ones(b, bool)
    compared = 0
    for i in range(gen):
        if i:
            step = jnp.int32(t + i - 1)
            logits_j, _ = _jdecode(params, tj, cj, step, cfg=jcfg)
            tj, cj = _jserve_step(params, tj, cj, step, cfg=jcfg)
            tt_, ct = serve_step(port, tt_, ct, t + i - 1, tcfg)
            last = np.asarray(logits_j[:, -1], np.float64)
        else:
            last = np.asarray(lj[:, -1], np.float64)
        top2 = np.sort(last[:, :jcfg.vocab_size], axis=-1)[:, -2:]
        margin = top2[:, 1] - top2[:, 0]
        same = np.asarray(tj)[:, 0] == tt_.numpy()[:, 0]
        sure = live & (margin > (1e-3 if dtype == "float32"
                                 else 2 * MODEL_BF16[0]))
        assert np.all(same[sure]), (i, margin, np.asarray(tj), tt_)
        compared += int(np.sum(sure))
        live &= same
    assert compared >= (b * gen - 1 if dtype == "float32" else 1), compared


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "mixtral-8x7b",
                                  "rwkv6-3b"])
def test_kind_bf16_is_as_close_to_float32_as_the_reference(arch):
    """At bfloat16 the MoE, Mamba and RWKV configs are not held to
    MODEL_BF16: the reference's own bfloat16 logits lie farther than
    that from its float32 logits on the same weights (jamba at 16 layers:
    mean 0.05–0.08, max up to 3.8, where a token's MoE route flips on a
    near tie; rwkv: max 0.2–1.3), so no port that rounds anywhere
    differently could be.  Instead the port's bfloat16 logits (forward
    and the serving prefill) must lie as close to the reference's float32
    logits as the reference's own bfloat16 logits do: mean |Δ| and
    relative Frobenius norm within ``KIND_BF16_RATIO`` of the
    reference's, over 8 prompts of 48 tokens."""
    jcfg, tcfg = _kind_cfgs(arch, "bfloat16")
    params = jt.init_params(jax.random.PRNGKey(0), jcfg)
    port = convert.lm_params(jax.tree.map(np.asarray, params), tcfg, "cpu")
    j32 = dataclasses.replace(jcfg, dtype="float32")
    p32 = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    toks = _prompts(8, 48, jcfg.vocab_size, seed=17)
    v = jcfg.vocab_size
    exact = _np(_jforward(p32, jnp.asarray(toks), cfg=j32)[0])[..., :v]
    ref = _np(_jforward(params, jnp.asarray(toks), cfg=jcfg)[0])[..., :v]
    ports = {"forward": tt.forward(port, torch.from_numpy(toks), tcfg)[0],
             "prefill": tt.prefill_with_cache(port, torch.from_numpy(toks),
                                              tcfg, 56)[0]}

    def stats(got):
        d = got - exact
        return (float(np.abs(d).mean()),
                float(np.linalg.norm(d) / np.linalg.norm(exact)))

    ref_mean, ref_fro = stats(ref)
    for name, got in ports.items():
        mean, fro = stats(_np(got)[..., :v])
        print(f"{arch} {name}: mean {mean:.4f} rel_fro {fro:.4f} "
              f"(reference's own: {ref_mean:.4f}, {ref_fro:.4f})")
        assert mean <= KIND_BF16_RATIO * ref_mean, (name, mean, ref_mean)
        assert fro <= KIND_BF16_RATIO * ref_fro, (name, fro, ref_fro)
