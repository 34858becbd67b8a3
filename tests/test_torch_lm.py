"""The port's LM serving path against the JAX package on the CPU.

The JAX ``init_params`` weights at a smoke config are carried across with
``convert.lm_params``; token prompts come from a numpy seed, one of them
ragged (T = 96 against the smoke config's 64-wide blocks).  The port's
attention is K4's plain version here (CPU tensors).

Tolerances:
  * float32 (``dtype="float32"``): layer outputs and logits within atol
    1e-4 — the two sides add the same float32 terms in other orders;
    generated tokens are equal wherever the JAX logits' top-2 margin
    exceeds 1e-3.
  * bfloat16 (the configs' own type): one layer on the same inputs within
    atol 0.05; what the whole model computes (logits, and the caches of
    layers past the first) within max 0.1 and mean 0.02 (``MODEL_BF16``).
    Both sides round every matmul output and activation to bfloat16, at
    places that differ by a rounding here and there; besides, the JAX
    prefill's blocked ``flash_attention`` rounds its q·kᵀ scores (and
    each block's p·v) to bfloat16 (``attention.py:63``, bfloat16 einsums)
    while K4, like the Pallas kernel, keeps them in float32.  The logits
    (and cached k values) reach |5|, where bfloat16's spacing is 0.031,
    so 0.05 is under two spacings: the JAX package's own two attention
    cores (blocked and Pallas) give logits that differ by 0.070 (mean
    0.0100) on these weights at T = 96, and the port differs from the
    Pallas core by 0.066 (mean 0.0087)
    (``test_bf16_tolerance_covers_the_references_own_spread``).

The MoE, Mamba and RWKV configs and the two frontend configs, whole
model, are ``tests/test_torch_lm_kinds.py``; their layers are
``tests/test_torch_{moe,mamba,rwkv}.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import attention as ja
from repro.models import layers as jl
from repro.models import transformer as jt
from repro.train.steps import serve_step as jax_serve_step
from repro_torch import convert
from repro_torch.configs import ARCHS, get_smoke_config
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.serve import serve
from repro_torch.models import attention as ta
from repro_torch.models import layers as tl
from repro_torch.models import transformer as tt
from repro_torch.train.steps import serve_step

ARCH = "granite-3-8b"
ATOL = {"float32": 1e-4, "bfloat16": 0.05}
MODEL_BF16 = (0.1, 0.02)               # max, mean |port − JAX|
DTYPES = ["float32", "bfloat16"]


def _cfgs(arch, dtype):
    return (dataclasses.replace(jax_smoke_config(arch), dtype=dtype),
            dataclasses.replace(get_smoke_config(arch), dtype=dtype))


def _np(x):
    """A JAX or torch array as a float64 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy().astype(np.float64)
    return np.asarray(jnp.asarray(x, jnp.float32), dtype=np.float64)


def _pair(a, jcfg):
    """One numpy array as (JAX array, torch tensor) of the config's type."""
    a = np.asarray(a, np.float32)
    tdt = torch.bfloat16 if jcfg.dtype == "bfloat16" else torch.float32
    return (jnp.asarray(a).astype(jcfg.jnp_dtype),
            torch.from_numpy(a).to(tdt))


# the JAX steps, jitted once per config (eager scans would recompile at
# every call)
_jprefill = jax.jit(jt.prefill_with_cache, static_argnames=("cfg",
                                                            "max_len"))
_jdecode = jax.jit(jt.decode_step, static_argnames=("cfg",))
_jserve_step = jax.jit(jax_serve_step, static_argnames=("cfg",))


def _close(got, want, atol):
    err = float(np.max(np.abs(_np(got) - _np(want))))
    assert err <= atol, err


def _close_model(got, want, dtype):
    diff = np.abs(_np(got) - _np(want))
    if dtype == "float32":
        assert float(diff.max()) <= ATOL[dtype], float(diff.max())
    else:
        top, mean = MODEL_BF16
        assert float(diff.max()) <= top and float(diff.mean()) <= mean, \
            (float(diff.max()), float(diff.mean()))


@pytest.fixture(scope="module", params=DTYPES)
def model(request):
    dtype = request.param
    jcfg, tcfg = _cfgs(ARCH, dtype)
    params = jt.init_params(jax.random.PRNGKey(0), jcfg)
    port = convert.lm_params(jax.tree.map(np.asarray, params), tcfg, "cpu")
    return dtype, jcfg, tcfg, params, port


def _prompts(b, t, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, t),
                                                dtype=np.int32)


# ----------------------------------------------------------- layers
@pytest.mark.parametrize("dtype", DTYPES)
def test_rms_norm_matches(dtype):
    jcfg, _ = _cfgs(ARCH, dtype)
    rng = np.random.default_rng(1)
    xj, xt = _pair(rng.standard_normal((2, 5, 128)) * 3.0, jcfg)
    sj, st = _pair(rng.random(128) + 0.5, jcfg)
    _close(tl.rms_norm(xt, st), jl.rms_norm(xj, sj), ATOL[dtype] / 10)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ["granite-3-8b", "starcoder2-7b"],
                         ids=["swiglu", "gelu"])
def test_mlp_matches(arch, dtype):
    jcfg, tcfg = _cfgs(arch, dtype)
    assert tcfg.mlp_type == ("swiglu" if arch.startswith("granite")
                             else "gelu")
    p = jl.init_mlp(jax.random.PRNGKey(2), jcfg.d_model, jcfg.d_ff,
                    jcfg.mlp_type, jcfg.jnp_dtype)
    pt = {k: convert._lm_tensor(np.asarray(a), "cpu") for k, a in p.items()}
    xj, xt = _pair(np.random.default_rng(3).standard_normal(
        (2, 7, jcfg.d_model)), jcfg)
    _close(tl.mlp(pt, xt, tcfg.mlp_type), jl.mlp(p, xj, jcfg.mlp_type),
           ATOL[dtype])


@pytest.mark.parametrize("theta", [1e4, 1e5])
def test_apply_rope_matches(theta):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, 4, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(9) + 100, (2, 9)).astype(np.int32)
    got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    want = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    _close(got, want, 1e-5)
    _close(tl.rope_freqs(32, theta), jl.rope_freqs(32, theta), 1e-7)


# -------------------------------------------------------- attention
@pytest.mark.parametrize("t", [64, 96])
def test_attention_block_matches(model, t):
    dtype, jcfg, tcfg, params, port = model
    pj = jax.tree.map(lambda a: a[0], params["periods"][0]["mixer"])
    pt = port.layers[0].mixer
    xj, xt = _pair(np.random.default_rng(t).standard_normal(
        (2, t, jcfg.d_model)), jcfg)
    pos = np.broadcast_to(np.arange(t), (2, t)).astype(np.int32)
    got = ta.attention_block(pt, xt, torch.from_numpy(pos), tcfg)
    want = ja.attention_block(pj, xj, jnp.asarray(pos), jcfg)
    _close(got, want, ATOL[dtype])


# ----------------------------------------------------------- model
def test_lm_params_carries_every_layer(model):
    dtype, jcfg, tcfg, params, port = model
    assert len(port.layers) == jcfg.n_layers
    for i, layer in enumerate(port.layers):
        period, pos = divmod(i, jcfg.period)
        src = params["periods"][pos]
        for name, a in src["mixer"].items():
            assert np.array_equal(_np(layer.mixer[name]), _np(a[period]))
        for name, a in src["ffn"].items():
            assert np.array_equal(_np(layer.ffn[name]), _np(a[period]))
    assert port.embeddings["embed"].dtype == tcfg.torch_dtype


@pytest.mark.parametrize("t", [64, 96])
def test_forward_matches(model, t):
    dtype, jcfg, tcfg, params, port = model
    toks = _prompts(2, t, jcfg.vocab_size, seed=t)
    want, _ = jt.forward(params, jnp.asarray(toks), jcfg)
    got, aux = port(torch.from_numpy(toks))
    assert got.shape == want.shape and float(aux) == 0.0
    _close_model(got[..., :jcfg.vocab_size], want[..., :jcfg.vocab_size],
                  dtype)
    last, _ = tt.forward(port, torch.from_numpy(toks), tcfg,
                         logits_last_only=True)
    assert last.shape == (2, 1, got.shape[-1])
    _close_model(last, got[:, -1:], dtype)   # other matmul blocking


def _prefill_both(model, b, t, max_len, seed=0):
    dtype, jcfg, tcfg, params, port = model
    toks = _prompts(b, t, jcfg.vocab_size, seed)
    lj, cj = _jprefill(params, jnp.asarray(toks), cfg=jcfg, max_len=max_len)
    lt, ct = tt.prefill_with_cache(port, torch.from_numpy(toks), tcfg,
                                   max_len)
    return (lj, cj), (lt, ct)


@pytest.mark.parametrize("t", [64, 96])
def test_prefill_with_cache_matches(model, t):
    dtype, jcfg, tcfg, params, port = model
    (lj, cj), (lt, ct) = _prefill_both(model, 2, t, t + 8)
    v = jcfg.vocab_size
    _close_model(lt[..., :v], lj[..., :v], dtype)
    # the padded vocab tail holds the type's lowest value on both sides
    assert np.array_equal(_np(lt[..., v:]), _np(lj[..., v:]))
    for i, c in enumerate(ct):
        period, pos = divmod(i, jcfg.period)
        for name in ("k", "v"):
            got, want = c["attn"][name], cj[pos]["attn"][name][period]
            assert got.shape == want.shape
            _close_model(got, want, dtype)
            assert not torch.any(got[:, t:])      # unwritten slots stay 0


def test_decode_step_matches(model):
    dtype, jcfg, tcfg, params, port = model
    t = 96
    (lj, cj), (lt, ct) = _prefill_both(model, 2, t, t + 4, seed=5)
    tok = np.asarray(jnp.argmax(lj[:, -1:], axis=-1)).astype(np.int32)
    dj, cj2 = _jdecode(params, jnp.asarray(tok), cj, jnp.int32(t), cfg=jcfg)
    dt_, ct2 = tt.decode_step(port, torch.from_numpy(tok), ct, t, tcfg)
    v = jcfg.vocab_size
    _close_model(dt_[..., :v], dj[..., :v], dtype)
    for i, c in enumerate(ct2):
        period, pos = divmod(i, jcfg.period)
        for name in ("k", "v"):
            _close_model(c["attn"][name], cj2[pos]["attn"][name][period],
                         dtype)


def test_greedy_serve_loop_matches(model):
    """16 greedy tokens through each package's ``serve_step``: each side
    feeds its own tokens back, and the tokens must be equal wherever the
    JAX logits' top-2 margin exceeds twice the logits' tolerance (1e-3 at
    float32, 0.2 at bfloat16); past a closer call the rows may rightly
    part, and are not compared from there on."""
    dtype, jcfg, tcfg, params, port = model
    b, t, gen = 3, 96, 16
    (lj, cj), (lt, ct) = _prefill_both(model, b, t, t + gen, seed=9)
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
    # at float32 close calls are rare; at bfloat16 random logits over 512
    # words often have two within 0.2, and a row that parts stays apart
    assert compared >= (b * gen - 2 if dtype == "float32" else b), compared


@pytest.mark.parametrize("t", [48, 96])         # 96: longer than the window
def test_sliding_window_prefill_and_decode_match(t):
    """starcoder2's smoke config (window 64, GELU, RoPE θ 1e5), float32:
    the prefill through K4's window mask, the ring-buffer cache it fills
    (only the last 64 positions when T > 64) and three decode steps that
    wrap around it, against the JAX package.  At T = 96 this pins the
    reference's eviction order, which is faulty: the prefill puts
    positions T − 64 .. T − 1 in slots 0 .. 63, but decode step T writes
    slot T % 64 = 32, evicting position 64 and keeping position 32, which
    has left the window (ROADMAP queue 3); the port reproduces it."""
    jcfg, tcfg = _cfgs("starcoder2-7b", "float32")
    assert tcfg.sliding_window == 64 and tcfg.mlp_type == "gelu"
    params = jt.init_params(jax.random.PRNGKey(7), jcfg)
    port = convert.lm_params(jax.tree.map(np.asarray, params), tcfg, "cpu")
    toks = _prompts(2, t, jcfg.vocab_size, seed=t + 1)
    lj, cj = _jprefill(params, jnp.asarray(toks), cfg=jcfg, max_len=t + 8)
    lt, ct = tt.prefill_with_cache(port, torch.from_numpy(toks), tcfg,
                                   t + 8)
    v = jcfg.vocab_size
    _close_model(lt[..., :v], lj[..., :v], "float32")
    assert ct[0]["attn"]["k"].shape[1] == min(t + 8, 64)
    tj = jnp.argmax(lj[:, -1:], axis=-1).astype(jnp.int32)
    tok = torch.from_numpy(np.array(tj))
    for i in range(3):
        dj, cj = _jdecode(params, tj, cj, jnp.int32(t + i), cfg=jcfg)
        dt_, ct = tt.decode_step(port, tok, ct, t + i, tcfg)
        _close_model(dt_[..., :v], dj[..., :v], "float32")
        for layer, c in enumerate(ct):
            for name in ("k", "v"):
                _close(c["attn"][name], cj[0]["attn"][name][layer],
                       ATOL["float32"])
        tj = jnp.argmax(dj[:, -1:], axis=-1).astype(jnp.int32)
        tok = torch.from_numpy(np.array(tj))


# ------------------------------------------------------ entry points
def test_serve_on_cpu_runs_the_path():
    out = serve(ARCH, batch=2, prompt_len=40, gen=4, smoke=True, seed=3,
                device="cpu")
    cfg = get_smoke_config(ARCH)
    assert out["tokens"].shape == (2, 4)
    assert out["tokens"].dtype == torch.int32
    assert int(out["tokens"].min()) >= 0
    assert int(out["tokens"].max()) < cfg.vocab_size
    assert out["decode_syncs"] is None            # counted on CUDA only
    assert out["prefill_s"] > 0 and out["decode_tok_per_s"] > 0
    again = serve(ARCH, batch=2, prompt_len=40, gen=4, smoke=True, seed=3,
                  device="cpu")
    assert torch.equal(out["tokens"], again["tokens"])   # seeded


def test_serve_cli_on_cpu(capsys):
    serve_main(["--arch", ARCH, "--smoke", "--batch", "2", "--prompt-len",
                "16", "--gen", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "prefill" in out and "tok/s" in out and "sample:" in out


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve(ARCH, batch=1, prompt_len=8, gen=2, smoke=True)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "mixtral-8x7b",
                                  "rwkv6-3b"])
def test_training_refuses_unported_layer_kinds(arch):
    """The MoE, Mamba and RWKV kinds train (the name is kept from when
    ``init_train_state`` and ``train_step`` refused them): one
    ``train_step`` of each smoke config on the CPU gives a finite loss
    and moves every trainable matrix, and serving still builds its
    caches."""
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.steps import init_train_state, train_step
    cfg = get_smoke_config(arch)
    state = init_train_state(0, cfg, device="cpu")
    start = {n: p.detach().clone()
             for n, p in state["params"].named_parameters()}
    toks = torch.from_numpy(_prompts(2, 33, cfg.vocab_size, seed=1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    _, metrics = train_step(state, batch, cfg, OptConfig(warmup_steps=1))
    assert torch.isfinite(metrics["loss"]) and float(metrics["loss"]) > 0
    assert torch.isfinite(metrics["grad_norm"])
    mats = [n for n, p in start.items() if p.dim() >= 2]
    assert any(".ffn." in n or ".mixer." in n for n in mats)
    for n, p in state["params"].named_parameters():
        if p.dim() >= 2:
            assert not torch.equal(p.detach(), start[n]), n
    assert int(state["step"]) == 1
    tt.init_caches(1, cfg, 8, device="cpu")          # serving builds


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_every_shipped_arch_on_cpu(arch):
    """``serve`` runs every shipped config at its smoke width through the
    same code, tokens inside the vocabulary and seeded."""
    out = serve(arch, batch=2, prompt_len=24, gen=3, smoke=True, seed=1,
                device="cpu")
    cfg = get_smoke_config(arch)
    tok = out["tokens"]
    assert tok.shape == (2, 3) and tok.dtype == torch.int32
    assert 0 <= int(tok.min()) and int(tok.max()) < cfg.vocab_size
    again = serve(arch, batch=2, prompt_len=24, gen=3, smoke=True, seed=1,
                  device="cpu")
    assert torch.equal(tok, again["tokens"])


# --------------------------------------------- where the tolerances stand
def test_bf16_tolerance_covers_the_references_own_spread(monkeypatch):
    """The JAX package's two attention cores (the blocked
    ``flash_attention`` and the Pallas kernel, interpret mode) give bf16
    logits that differ by as much as the port differs from either: the
    bf16 tolerance is the reference's own spread, not slack for the
    port."""
    jcfg, tcfg = _cfgs(ARCH, "bfloat16")
    params = jt.init_params(jax.random.PRNGKey(0), jcfg)
    port = convert.lm_params(jax.tree.map(np.asarray, params), tcfg, "cpu")
    toks = _prompts(2, 96, jcfg.vocab_size, seed=96)
    v = jcfg.vocab_size
    blocked, _ = jt.prefill_with_cache(params, jnp.asarray(toks), jcfg, 104)
    from repro.kernels.flash_attention import flash_attention_kernel
    monkeypatch.setattr(ja, "flash_attention", lambda q, k, v_, cfg, **_:
                        flash_attention_kernel(q, k, v_, window=0,
                                               q_block=64, kv_block=64,
                                               interpret=True))
    pallas, _ = jt.prefill_with_cache(params, jnp.asarray(toks), jcfg, 104)
    ours, _ = tt.prefill_with_cache(port, torch.from_numpy(toks), tcfg, 104)
    spread = np.abs(_np(blocked)[..., :v] - _np(pallas)[..., :v])
    ours_vs_pallas = np.abs(_np(ours)[..., :v] - _np(pallas)[..., :v])
    print(f"bf16 logits: blocked vs Pallas max {spread.max():.4f} mean "
          f"{spread.mean():.4f}; port vs Pallas max {ours_vs_pallas.max():.4f}"
          f" mean {ours_vs_pallas.mean():.4f}")
    assert float(spread.max()) > ATOL["bfloat16"]     # two spacings at |5|
    for diff in (spread, ours_vs_pallas):
        assert float(diff.max()) <= MODEL_BF16[0]
        assert float(diff.mean()) <= MODEL_BF16[1]


def test_depth_amplifies_last_bit_score_changes(monkeypatch):
    """Why ``chip_smoke.py`` holds K4's 40-layer bf16 prefill to its plain
    version by relative Frobenius error 0.1 and max 1.0, not by a float32
    bound: on the CPU, a 40-layer model (d_model 512, hd 64, G 4) whose
    attention scores change in their last float32 bit — as K4's sums in
    another order do — gives bf16 logits that move by far more than one
    bf16 spacing, and still stay well inside that tolerance."""
    from repro_torch.kernels import ref
    from repro_torch.models import attention as tatt
    cfg = dataclasses.replace(get_smoke_config(ARCH), n_layers=40,
                              d_model=512, n_heads=8, n_kv_heads=2,
                              head_dim=64, d_ff=1600, vocab_size=4000)
    params = tt.init_params(0, cfg, device="cpu")
    toks = torch.from_numpy(_prompts(2, 256, cfg.vocab_size, seed=40))
    plain = ref.flash_attention_plain
    with torch.inference_mode():
        base, _ = tt.prefill_with_cache(params, toks, cfg, 256)
        gen = torch.Generator().manual_seed(0)
        einsum = torch.einsum

        def last_bit(eq, *xs):
            out = einsum(eq, *xs)
            if eq.startswith("bkgqd,bksd"):           # the scores
                out = out * (1 + 2.0 ** -24 * torch.randint(
                    -1, 2, out.shape, generator=gen).to(out.dtype))
            return out

        def perturbed(q, k, v, window=0):
            monkeypatch.setattr(torch, "einsum", last_bit)
            try:
                return plain(q, k, v, window=window)
            finally:
                monkeypatch.setattr(torch, "einsum", einsum)

        monkeypatch.setattr(tatt, "flash_attention_kernel", perturbed)
        moved, _ = tt.prefill_with_cache(params, toks, cfg, 256)
    a = base[..., :cfg.vocab_size].float()
    d = moved[..., :cfg.vocab_size].float() - a
    rel = float(torch.linalg.vector_norm(d) / torch.linalg.vector_norm(a))
    top = float(d.abs().max())
    print(f"40 layers, last-bit score changes: rel_fro {rel:.4f}, "
          f"max {top:.4f}")
    assert top > 2 * 2.0 ** -5          # more than two spacings at |4|
    assert rel <= 0.1 and top <= 1.0


def test_depth_amplifies_p_rounding_order():
    """Why the same tolerance holds K4 against the plain version, which
    rounds p to bfloat16 at each row's max where K4 rounds it at its
    running max over 64-row kv tiles: on the CPU, the 40-layer model of
    ``test_depth_amplifies_last_bit_score_changes`` with K4's order
    (``tiled_flash``) in place of the plain version moves the logits by
    about as much as last-bit score changes do, inside rel_fro 0.1 and
    max 1.0."""
    from test_torch_flash import tiled_flash
    cfg = dataclasses.replace(get_smoke_config(ARCH), n_layers=40,
                              d_model=512, n_heads=8, n_kv_heads=2,
                              head_dim=64, d_ff=1600, vocab_size=4000)
    params = tt.init_params(0, cfg, device="cpu")
    toks = torch.from_numpy(_prompts(2, 256, cfg.vocab_size, seed=40))
    with torch.inference_mode():
        base, _ = tt.prefill_with_cache(params, toks, cfg, 256)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(ta, "flash_attention_kernel",
                       lambda q, k, v, window=0: tiled_flash(q, k, v,
                                                             window))
            moved, _ = tt.prefill_with_cache(params, toks, cfg, 256)
    a = base[..., :cfg.vocab_size].float()
    d = moved[..., :cfg.vocab_size].float() - a
    rel = float(torch.linalg.vector_norm(d) / torch.linalg.vector_norm(a))
    top = float(d.abs().max())
    print(f"40 layers, K4's rounding order: rel_fro {rel:.4f}, "
          f"max {top:.4f}")
    assert top > 2 * 2.0 ** -5
    assert rel <= 0.1 and top <= 1.0
