"""The port's training path against the JAX package on the CPU.

Loss, optimizer, compression, the blocked training attention, the
training forward's remat policies, ``train_step``, the data pipeline and
``launch.train`` (checkpoints: ``tests/test_torch_checkpoint.py``).  The
JAX ``init_train_state`` of a smoke config (granite-3-2b's, and
starcoder2-7b's with its 64-key sliding window), in float32 and
bfloat16, is carried across with ``convert.train_state``; batches are
seeded numpy tokens.

Tolerances:
  * float32: losses and grad norms within 1e-5 relative; parameters,
    ``m`` and ``v`` within 1e-5 relative Frobenius error per tensor
    (‖port − JAX‖ / ‖JAX‖), not per element: the two sides sum the same
    float32 terms in other orders, and AdamW's first step moves every
    element by ±lr whatever its gradient's size, so an element whose
    gradient is rounding noise may move the other way on the other side.
    The steps run ``OptConfig()`` (``build_train_step``'s default: lr 3e-4 after
    100 warm-up steps, so 3e-6 and 6e-6 at steps 1 and 2); at lr 1e-3 the
    flipped elements alone put the parameters 1e-5 apart after one step
    and the second step's ``v`` 2.8e-5 apart.
  * bfloat16 (``BF16``): derived, as ``tests/test_torch_lm.py`` derives
    its own, from the reference's own spread: the JAX train step with
    32-wide attention blocks against itself with the smoke config's 64
    (the same function; bfloat16 roundings of q·kᵀ and p·v at other
    places) differs by up to 9e-5 in the loss, 4.2e-4 in the grad norm,
    1.2e-5 in the parameters and 1.7 % in ``m`` and ``v`` over two
    steps; the limits are about twice the larger of that spread and the
    port's error, and the port's error stays within 2.5× the spread on
    each config, key by key
    (``test_bf16_tolerance_covers_the_references_own_spread``).
  * float32 with a bfloat16 gradient sync: ``m`` and ``v`` within
    ``SYNC`` (below), the rest as float32.
  * attention: float32 outputs and gradients within 2e-5 absolute
    (inputs of unit scale), the JAX package's own drop-in tolerance.
"""

import dataclasses
import functools
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.data.pipeline import Prefetcher as JaxPrefetcher
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.models import attention as ja
from repro.models import transformer as jt
from repro.train import compression as jcomp
from repro.train import loss as jloss
from repro.train import optimizer as jopt
from repro.train import steps as jsteps
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.kernels import flash_attention_kernel
from repro_torch.kernels.ref import flash_attention_plain
from repro_torch.launch import train as tlaunch
from repro_torch.models import attention as ta
from repro_torch.models import transformer as tt
from repro_torch.train import (IGNORE, OptConfig, adamw_update,
                               cross_entropy, init_opt_state, lm_loss,
                               schedule)
from repro_torch.train import compression as tcomp
from repro_torch.train import steps as tsteps

F32 = 1e-5
BF16 = {"loss": 2e-4, "grad_norm": 1e-3, "params": 3e-5, "m": 0.04,
        "v": 0.04}
# with a bfloat16 gradient sync, each microbatch's float32 gradients are
# rounded to bfloat16 before the float32 sum: an element whose two sides
# differ in the last float32 bits may land on neighbouring bfloat16
# values, a relative u = 2⁻⁸ apart, so a tensor of n elements of which k
# do so differs by about u·√(k/n); one such element of a 128-wide norm
# scale moves it by about u/√128 = 3.5e-4
SYNC = 2.0 ** -8 / 8
ATTN = 2e-5
ARCHS = ["granite-3-2b", "starcoder2-7b"]
DTYPES = ["float32", "bfloat16"]
T = 128
BATCH = 4


def _cfgs(arch, dtype, **kw):
    return (dataclasses.replace(jax_smoke_config(arch), dtype=dtype, **kw),
            dataclasses.replace(get_smoke_config(arch), dtype=dtype, **kw))


def _t(a):
    """A JAX array (any type) as a float64 torch tensor."""
    return torch.from_numpy(np.asarray(jnp.asarray(a, jnp.float32),
                                       dtype=np.float64))


def _rel(got, want):
    """Relative Frobenius error ‖got − want‖ / ‖want‖."""
    g = got.detach().double() if isinstance(got, torch.Tensor) else _t(got)
    w = want.detach().double() if isinstance(want, torch.Tensor) else \
        _t(want)
    return float(torch.linalg.vector_norm(g - w)
                 / torch.linalg.vector_norm(w))


def _batch(vocab, b, t, seed):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, t + 1),
                                                dtype=np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


# ------------------------------------------------------------------ loss
@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_entropy_matches(dtype):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 17, 40)) * 4).astype(np.float32)
    labels = rng.integers(0, 40, (3, 17)).astype(np.int32)
    labels[rng.random((3, 17)) < 0.3] = IGNORE
    jl = jnp.asarray(logits).astype(jnp.dtype(dtype))
    tl = torch.from_numpy(logits).to(getattr(torch, dtype))
    want, wcount = jloss.cross_entropy(jl, jnp.asarray(labels))
    got, count = cross_entropy(tl, torch.from_numpy(labels))
    assert int(count) == int(wcount) == int((labels != IGNORE).sum())
    assert got.dtype == torch.float32
    assert abs(float(got) - float(want)) <= F32 * abs(float(want))


def test_cross_entropy_masking():
    """The reference's case (``tests/test_train_substrate.py``)."""
    loss, count = cross_entropy(torch.zeros((1, 4, 8)),
                                torch.tensor([[1, 2, IGNORE, IGNORE]]))
    assert int(count) == 2
    assert math.isclose(float(loss), math.log(8.0), abs_tol=1e-5)
    # nothing valid: the count is clamped to 1 on the device
    loss, count = cross_entropy(torch.zeros((1, 2, 8)),
                                torch.full((1, 2), IGNORE))
    assert int(count) == 1 and float(loss) == 0.0


def test_lm_loss_matches():
    """``lm_loss`` through each package's forward (the port's training
    forward) on the same weights, float32."""
    jcfg, tcfg = _cfgs("granite-3-2b", "float32")
    params = jt.init_params(jax.random.PRNGKey(3), jcfg)
    port = convert.lm_params(jax.tree.map(np.asarray, params), tcfg, "cpu")
    batch = _batch(jcfg.vocab_size, 2, T, seed=3)
    batch["labels"][0, :5] = IGNORE
    want, wm = jloss.lm_loss(params, {k: jnp.asarray(v)
                                      for k, v in batch.items()},
                             jcfg, jt.forward)
    got, m = lm_loss(port, _torch_batch(batch), tcfg,
                     functools.partial(tt.forward, train=True))
    assert abs(float(got) - float(want)) <= F32 * float(want)
    assert int(m["tokens"]) == int(wm["tokens"]) == 2 * T - 5
    assert float(m["aux"]) == 0.0


# ------------------------------------------------------------- optimizer
def test_schedule_matches():
    for opt in (OptConfig(lr=1.0, warmup_steps=10, total_steps=110,
                          min_lr_frac=0.1),
                OptConfig(), OptConfig(warmup_steps=0, total_steps=3)):
        jo = jopt.OptConfig(**dataclasses.asdict(opt))
        for s in (0, 1, 5, 10, 60, 99, 100, 101, 110, 5000, 10_000, 20_000):
            got = schedule(opt, torch.tensor(s, dtype=torch.int32))
            assert got.dtype == torch.float32
            assert float(got) == float(jopt.schedule(jo, jnp.int32(s))), s


def test_schedule_shape():
    """The reference's case: warm-up to lr, cosine down to min_lr_frac."""
    opt = OptConfig(lr=1.0, warmup_steps=10, total_steps=110,
                    min_lr_frac=0.1)
    lrs = [float(schedule(opt, torch.tensor(s))) for s in (0, 5, 10, 60,
                                                            110)]
    assert lrs[0] == 0.0
    assert math.isclose(lrs[1], 0.5, rel_tol=1e-6)
    assert math.isclose(lrs[2], 1.0, rel_tol=1e-6)
    assert lrs[2] > lrs[3] > lrs[4]
    assert math.isclose(lrs[4], 0.1, abs_tol=1e-3)


def test_adamw_matches_reference():
    """One AdamW step against a hand-rolled numpy reference (the JAX
    package's case)."""
    opt = OptConfig(lr=1e-2, warmup_steps=0, total_steps=100,
                    weight_decay=0.1, clip_norm=1e9)
    w = np.array([[1.0, -2.0], [0.5, 3.0]], np.float32)
    g = np.array([[0.1, 0.2], [-0.3, 0.4]], np.float32)
    p = {"w": torch.from_numpy(w.copy())}
    st = init_opt_state(p)
    new_p, st2, _ = adamw_update(p, {"w": torch.from_numpy(g)}, st, opt)
    lr = float(schedule(opt, torch.tensor(1)))
    mh = 0.1 * g / (1 - 0.9)
    vh = 0.05 * g ** 2 / (1 - 0.95)
    ref = w - lr * (mh / (np.sqrt(vh) + opt.eps) + 0.1 * w)
    assert np.allclose(new_p["w"].numpy(), ref, atol=1e-6)
    assert new_p["w"] is p["w"]                    # updated in place
    assert int(st2["step"]) == 1 and st2["step"].dtype == torch.int32


def test_grad_clipping():
    opt = OptConfig(lr=1e-2, warmup_steps=0, clip_norm=0.1)
    p = {"w": torch.ones(4)}
    st = init_opt_state(p)
    _, st, metrics = adamw_update(p, {"w": torch.full((4,), 100.0)}, st,
                                  opt)
    assert float(metrics["grad_norm"]) == 200.0
    # m = 0.1 · clipped g, clipped g = 100 · 0.1 / 200
    assert torch.allclose(st["m"]["w"], torch.full((4,), 0.005))


@pytest.mark.parametrize("clip", [1e9, 1.0])
@pytest.mark.parametrize("dtype", DTYPES)
def test_adamw_matches_jax(dtype, clip):
    """Three AdamW steps on random parameters and gradients (norm ≈ 136:
    clipped at clip_norm 1), parameters in ``dtype``, moments float32."""
    opt = OptConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                    clip_norm=clip)
    jo = jopt.OptConfig(**dataclasses.asdict(opt))
    rng = np.random.default_rng(1)
    shapes = {"w": (64, 32), "b": (32,), "e": (7, 5, 3)}
    p = {k: rng.standard_normal(s).astype(np.float32)
         for k, s in shapes.items()}
    jp = {k: jnp.asarray(v).astype(jnp.dtype(dtype)) for k, v in p.items()}
    # copies: the port updates in place, and a float32 JAX array on the
    # CPU may share the numpy buffer it was made from
    tp = {k: torch.tensor(v).to(getattr(torch, dtype))
          for k, v in p.items()}
    jst, tst = jopt.init_opt_state(jp), init_opt_state(tp)
    for _ in range(3):
        g = {k: (rng.standard_normal(s) * 3).astype(np.float32)
             for k, s in shapes.items()}
        jp, jst, jm = jopt.adamw_update(
            jp, {k: jnp.asarray(v).astype(jnp.dtype(dtype))
                 for k, v in g.items()}, jst, jo)
        tp, tst, tm = adamw_update(
            tp, {k: torch.from_numpy(v).to(getattr(torch, dtype))
                 for k, v in g.items()}, tst, opt)
        for key in ("grad_norm", "lr"):
            assert abs(float(tm[key]) - float(jm[key])) <= \
                F32 * abs(float(jm[key]))
        for k in shapes:
            assert tp[k].dtype == getattr(torch, dtype)
            assert _rel(tst["m"][k], jst["m"][k]) <= F32
            assert _rel(tst["v"][k], jst["v"][k]) <= F32
            assert _rel(tp[k], jp[k]) <= (F32 if dtype == "float32"
                                          else BF16["params"])
    assert int(tst["step"]) == int(jst["step"]) == 3


# ----------------------------------------------------------- compression
def test_int8_error_feedback_quantization():
    """The reference's case, on the port."""
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(256)
                         .astype(np.float32))
    q, scale, err2 = tcomp.quantize(g, torch.zeros_like(g))
    assert q.dtype == torch.int8
    deq = tcomp.dequantize(q, scale)
    assert float((deq - g).abs().max()) <= float(scale) * 0.51
    assert torch.allclose(g - deq, err2, atol=1e-7)
    total_err = err2
    for _ in range(10):
        q, scale, total_err = tcomp.quantize(g, total_err)
    assert float(total_err.abs().max()) < 0.1


@pytest.mark.parametrize("dtype", DTYPES)
def test_quantize_with_error_feedback_matches_jax(dtype):
    """Four rounds of quantize → dequantize with the error carried: the
    int8 payloads equal, scales and errors within float32 rounding."""
    rng = np.random.default_rng(2)
    jerr = jnp.zeros((33, 17), jnp.float32)
    terr = tcomp.init_error_state({"g": torch.zeros((33, 17))})["g"]
    assert terr.dtype == torch.float32 and not torch.any(terr)
    for _ in range(4):
        g = (rng.standard_normal((33, 17)) * 0.01).astype(np.float32)
        jq, js, jerr = jcomp.quantize(jnp.asarray(g).astype(
            jnp.dtype(dtype)), jerr)
        tq, ts, terr = tcomp.quantize(torch.from_numpy(g).to(
            getattr(torch, dtype)), terr)
        assert np.array_equal(tq.numpy(), np.asarray(jq))
        assert float(ts) == float(js)
        assert float((terr - _t(jerr)).abs().max()) <= 1e-9
        assert torch.equal(tcomp.dequantize(tq, ts),
                           torch.from_numpy(np.array(
                               jcomp.dequantize(jq, js))))


def test_cross_pod_mean_is_not_ported():
    """``cross_pod_mean`` is ported (``tests/test_torch_shard_gloo.py``
    holds it to the reference over a pod mesh dim); a mesh without a
    ``pod`` dim is refused."""
    from repro_torch.models.sharding import MeshShape
    with pytest.raises(ValueError, match="pod"):
        tcomp.cross_pod_mean({"g": torch.zeros(3)}, {"g": torch.zeros(3)},
                             MeshShape((1, 1), ("data", "model")))


# ------------------------------------------------------ blocked attention
ATTN_CASES = {
    # (arch, T, overrides): q blocks × kv blocks of the blocked core
    "causal-2x2": ("granite-3-2b", 128, {}),
    "causal-4x4": ("granite-3-2b", 256, {}),
    "causal-ragged": ("granite-3-2b", 96, {}),           # qb 32, kb 32
    "window-4x2": ("starcoder2-7b", 256, {}),            # span 128
    "window-2x2": ("starcoder2-7b", 128, {}),
    # span (100 + 64) > T: kv slices run past the keys and the reference
    # clamps the slice but not its positions; the twin does the same
    "window-clamped": ("starcoder2-7b", 128, {"sliding_window": 100}),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_blocked_attention_matches_jax_forward_and_grads(case):
    arch, t, kw = ATTN_CASES[case]
    jcfg, tcfg = _cfgs(arch, "float32", **kw)
    h, kv, hd = tcfg.n_heads_eff, tcfg.n_kv_heads, tcfg.head_dim_
    rng = np.random.default_rng(t)
    q, k, v, cot = (rng.standard_normal(s).astype(np.float32) for s in
                    ((2, t, h, hd), (2, t, kv, hd), (2, t, kv, hd),
                     (2, t, h, hd)))

    def jfn(q_, k_, v_):
        return jnp.sum(ja.flash_attention(q_, k_, v_, jcfg) * cot)

    want = ja.flash_attention(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), jcfg)
    wgrads = jax.grad(jfn, argnums=(0, 1, 2))(jnp.asarray(q),
                                               jnp.asarray(k),
                                               jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got = ta.blocked_flash_attention(tq, tk, tv, tcfg)
    grads = torch.autograd.grad((got * torch.from_numpy(cot)).sum(),
                                (tq, tk, tv))
    got = got.detach()
    assert float((got.double() - _t(want)).abs().max()) <= ATTN
    for g, w in zip(grads, wgrads):
        assert float((g.double() - _t(w)).abs().max()) <= ATTN
    if case != "window-clamped":
        # the same function as K4's plain version
        plain = flash_attention_plain(tq.detach(), tk.detach(), tv.detach(),
                                      window=tcfg.sliding_window)
        assert float((got - plain).abs().max()) <= ATTN


def test_blocked_attention_bf16_matches_jax():
    """bfloat16 in, bfloat16 out: both cores round q·kᵀ and p·v to
    bfloat16 blockwise at the same places; within two output spacings."""
    jcfg, tcfg = _cfgs("starcoder2-7b", "bfloat16")
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, 256, 4, 32), (2, 256, 2, 32), (2, 256, 2, 32)))
    want = ja.flash_attention(*(jnp.asarray(a).astype(jnp.bfloat16)
                                for a in (q, k, v)), jcfg)
    got = ta.blocked_flash_attention(*(torch.from_numpy(a).to(
        torch.bfloat16) for a in (q, k, v)), tcfg)
    assert got.dtype == torch.bfloat16
    assert float((got.double() - _t(want)).abs().max()) <= 2 * 2 ** -7


def test_attention_block_routes():
    """``attention_block`` attends through K4 by default and through the
    blocked twin with ``train=True``; both give the same function."""
    _, tcfg = _cfgs("granite-3-2b", "float32")
    port = tt.init_params(0, tcfg, device="cpu")
    x = torch.randn((2, 96, tcfg.d_model), generator=torch.Generator()
                    .manual_seed(0))
    pos = torch.arange(96).expand(2, 96)
    p = port.layers[0].mixer
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ta, "flash_attention_kernel",
                   lambda *a, **kw: calls.append(1)
                   or flash_attention_kernel(*a, **kw))
        k4 = ta.attention_block(p, x, pos, tcfg)
        twin = ta.attention_block(p, x, pos, tcfg, train=True)
    assert calls == [1]
    assert float((k4 - twin).abs().max()) <= 1e-5


def test_k4_raises_under_autograd():
    """K4 has no backward: with grad mode on and q, k or v requiring grad
    it raises, on the CPU as on the card (so a training route that
    reached it fails here too); under no_grad or inference_mode it runs,
    and serving's frozen parameters never require grad."""
    q = torch.randn(1, 64, 4, 32)
    k = torch.randn(1, 64, 2, 32)
    for args in ((q.clone().requires_grad_(), k, k.clone()),
                 (q, k.clone().requires_grad_(), k),
                 (q, k, k.clone().requires_grad_())):
        with pytest.raises(RuntimeError, match="no backward"):
            flash_attention_kernel(*args)
        with torch.no_grad():
            flash_attention_kernel(*args)
        with torch.inference_mode():
            flash_attention_kernel(*args)
    flash_attention_kernel(q, k, k)              # nothing requires grad
    state = tsteps.init_train_state(0, get_smoke_config("granite-3-2b"),
                                    device="cpu")
    toks = torch.zeros((1, 64), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no backward"):
        tt.forward(state["params"], toks, state["params"].cfg)
    assert tsteps.prefill_step(state["params"], {"tokens": toks},
                               state["params"].cfg).shape[1] == 1


@pytest.fixture
def one_thread():
    """One intra-op thread: PyTorch's CPU reductions and the embedding's
    gradient sum in an order that depends on how many threads split them
    (two calls of the same loss differ in the last bits with several),
    so a bit-for-bit comparison of two runs needs one."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


# --------------------------------------------------------------- remat
@pytest.mark.parametrize("dtype", DTYPES)
def test_remat_policies_give_equal_gradients(dtype, one_thread):
    """``remat`` "none", "full" and "dots" recompute the same ops on the
    same inputs: bit-equal loss and gradients on the CPU."""
    _, tcfg = _cfgs("starcoder2-7b", dtype)
    state = tsteps.init_train_state(1, tcfg, device="cpu")
    params = state["params"]
    batch = _torch_batch(_batch(tcfg.vocab_size, 2, T, seed=4))
    out = {}
    for remat in ("none", "full", "dots"):
        cfg = dataclasses.replace(tcfg, remat=remat)
        fwd = functools.partial(tt.forward, train=True)
        loss, _ = lm_loss(params, batch, cfg, fwd)
        out[remat] = (loss.detach(), torch.autograd.grad(
            loss, list(params.parameters())))
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], out["none"][0])
        for g, w in zip(out[remat][1], out["none"][1]):
            assert torch.equal(g, w)
    with pytest.raises(ValueError, match="remat"):
        tt.forward(params, batch["tokens"],
                   dataclasses.replace(tcfg, remat="some"), train=True)


def test_dots_policy_keeps_the_projections():
    """The "dots" policy keeps what the projections' matmuls return
    (``mm``, or an einsum's ``bmm`` of one batch) and recomputes the
    attention's batched products and everything else."""
    from torch.utils.checkpoint import CheckpointPolicy
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    save, again = CheckpointPolicy.MUST_SAVE, CheckpointPolicy.PREFER_RECOMPUTE
    assert tt._dots_policy(None, mm, torch.zeros(3, 4)) is save
    assert tt._dots_policy(None, bmm, torch.zeros(1, 3, 4)) is save
    assert tt._dots_policy(None, bmm, torch.zeros(8, 3, 4)) is again
    assert tt._dots_policy(None, torch.ops.aten.exp.default,
                           torch.zeros(3)) is again


# ------------------------------------------------------------ train step
CONFIGS = [(a, d) for a in ARCHS for d in DTYPES]
# (config, microbatches, bfloat16 gradient sync); a bfloat16 sync of
# bfloat16 gradients is the identity, so it runs at float32 only
STEP_CASES = [(c, mb, sync) for c in CONFIGS
              for mb, sync in ((1, False), (2, False), (2, True))
              if not (sync and c[1] == "bfloat16")]


def _id(case):
    (arch, dtype), mb, sync = case
    return f"{arch}-{dtype}-mb{mb}" + ("-bf16-sync" if sync else "")


@pytest.fixture(scope="module")
def reference(request):
    """One config's JAX initial state (as numpy), its batches, and the
    JAX train step's two-step results per (microbatches, grad sync
    type), computed once each."""
    arch, dtype = request.param
    jcfg, tcfg = _cfgs(arch, dtype)
    state0 = jax.tree.map(np.asarray, jsteps.init_train_state(
        jax.random.PRNGKey(0), jcfg))
    batches = [_batch(jcfg.vocab_size, BATCH, T, seed=s) for s in (0, 1)]
    runs = {}

    def run(mb, sync):
        if (mb, sync) not in runs:
            fn = jax.jit(functools.partial(
                jsteps.train_step, cfg=jcfg, opt=jopt.OptConfig(),
                microbatches=mb,
                grad_sync_dtype=jnp.bfloat16 if sync else None))
            st, metrics = jax.tree.map(jnp.asarray, state0), []
            for b in batches:
                st, m = fn(st, {k: jnp.asarray(v) for k, v in b.items()})
                metrics.append(jax.tree.map(float, m))
            runs[mb, sync] = (jax.tree.map(np.asarray, st), metrics)
        return runs[mb, sync]

    return dtype, jcfg, tcfg, state0, batches, run


def _errors(state, metrics, want_tree, want_metrics, tcfg):
    """The largest relative error, per kind, of a port run (final state,
    per-step metrics) against a JAX one: ``loss`` and ``grad_norm`` over
    the steps, ``params``, ``m`` and ``v`` per tensor (Frobenius)."""
    want = convert.train_state(want_tree, tcfg, "cpu")
    assert int(state["step"]) == int(want["step"])
    assert state["step"].dtype == torch.int32
    got = dict(state["params"].named_parameters())
    assert set(got) == set(state["m"]) == set(state["v"])
    err = {k: max(abs(float(m[k]) / wm[k] - 1)
                  for m, wm in zip(metrics, want_metrics))
           for k in ("loss", "grad_norm")}
    err["params"] = max(_rel(got[n], w)
                        for n, w in want["params"].named_parameters())
    for part in ("m", "v"):
        err[part] = max(_rel(state[part][n], w)
                        for n, w in want[part].items())
    assert all(p.dtype == tcfg.torch_dtype for p in got.values())
    assert all(t.dtype == torch.float32 for part in ("m", "v")
               for t in state[part].values())
    return err


def _port_steps(state0, batches, tcfg, mb, sync=False):
    """Two ``train_step`` calls from the carried JAX state."""
    state, metrics = convert.train_state(state0, tcfg, "cpu"), []
    for b in batches:
        state, m = tsteps.train_step(
            state, _torch_batch(b), tcfg, OptConfig(), microbatches=mb,
            grad_sync_dtype=torch.bfloat16 if sync else None)
        metrics.append(m)
    return state, metrics


@pytest.mark.parametrize("reference,mb,sync", STEP_CASES,
                         indirect=["reference"],
                         ids=[_id(c) for c in STEP_CASES])
def test_train_step_matches_jax(reference, mb, sync):
    """Two consecutive ``train_step`` calls on the same batches against
    the JAX package's: loss, ce, grad_norm, lr, tokens, every parameter,
    ``m``, ``v`` and ``step``."""
    dtype, jcfg, tcfg, state0, batches, run = reference
    want_state, want_metrics = run(mb, sync)
    state, metrics = _port_steps(state0, batches, tcfg, mb, sync)
    for m, wm in zip(metrics, want_metrics):
        assert set(m) == set(wm) == {"ce", "aux", "tokens", "loss",
                                     "grad_norm", "lr"}
        assert all(isinstance(x, torch.Tensor) for x in m.values())
        assert int(m["tokens"]) == int(wm["tokens"]) == BATCH // mb * T
        assert float(m["aux"]) == 0.0
        assert float(m["lr"]) == wm["lr"]
        assert abs(float(m["ce"]) / wm["ce"] - 1) <= \
            (F32 if dtype == "float32" else BF16["loss"])
    err = _errors(state, metrics, want_state, want_metrics, tcfg)
    limits = dict.fromkeys(err, F32) if dtype == "float32" else BF16
    if sync:
        limits = dict(limits, m=SYNC, v=SYNC)
    print(f"{jcfg.name} {dtype} mb {mb} sync {sync}: {err}")
    for key, e in err.items():
        assert e <= limits[key], (key, e)


@pytest.mark.parametrize("reference", [c for c in CONFIGS
                                       if c[1] == "bfloat16"],
                         indirect=True, ids=lambda c: c[0])
def test_bf16_tolerance_covers_the_references_own_spread(reference):
    """The JAX train step with 32-wide attention blocks against itself
    with 64-wide ones (the smoke configs'): the reference's own spread
    lies inside the bfloat16 limits, and the port's error (two steps at
    microbatches 2) is no more than 2.5× that spread, key by key — the
    limits stand for the reference's spread, not for slack the port
    needs."""
    dtype, jcfg, tcfg, state0, batches, run = reference
    want_state, want_metrics = run(2, False)
    fn = jax.jit(functools.partial(
        jsteps.train_step, cfg=dataclasses.replace(jcfg, q_block=32,
                                                   kv_block=32),
        opt=jopt.OptConfig(), microbatches=2))
    st, other_metrics = jax.tree.map(jnp.asarray, state0), []
    for b in batches:
        st, m = fn(st, {k: jnp.asarray(v) for k, v in b.items()})
        other_metrics.append(m)
    other = convert.train_state(jax.tree.map(np.asarray, st), tcfg, "cpu")
    spread = _errors(other, other_metrics, want_state, want_metrics, tcfg)
    port = _errors(*_port_steps(state0, batches, tcfg, 2), want_state,
                   want_metrics, tcfg)
    print(f"{jcfg.name} bf16: reference spread {spread}, port {port}")
    for key, limit in BF16.items():
        assert spread[key] <= limit, (key, spread[key])
        assert port[key] <= 2.5 * spread[key], (key, port[key])


@pytest.mark.parametrize("reference", CONFIGS, indirect=True,
                         ids=lambda c: f"{c[0]}-{c[1]}")
def test_convert_train_state_carries_every_leaf(reference):
    dtype, jcfg, tcfg, state0, _, _ = reference
    state = convert.train_state(state0, tcfg, "cpu")
    params = state["params"]
    assert all(p.requires_grad for p in params.parameters())
    for i, layer in enumerate(params.layers):
        period, pos = divmod(i, jcfg.period)
        src = state0["params"]["periods"][pos]
        for name, a in src["mixer"].items():
            assert torch.equal(layer.mixer[name].detach().double(),
                               _t(a[period]))
    for part in ("m", "v"):
        assert set(state[part]) == {n for n, _ in params.named_parameters()}
        assert all(t.dtype == torch.float32 and not torch.any(t)
                   for t in state[part].values())
    assert int(state["step"]) == 0


def test_train_step_rejects_a_batch_that_does_not_split():
    state = tsteps.init_train_state(0, get_smoke_config("granite-3-2b"),
                                    device="cpu")
    batch = _torch_batch(_batch(512, 3, 16, seed=0))
    with pytest.raises(ValueError, match="microbatches"):
        tsteps.train_step(state, batch, state["params"].cfg, OptConfig(),
                          microbatches=2)


def test_prefill_step_matches_jax():
    jcfg, tcfg = _cfgs("granite-3-2b", "float32")
    params = jt.init_params(jax.random.PRNGKey(2), jcfg)
    port = convert.lm_params(jax.tree.map(np.asarray, params), tcfg, "cpu")
    toks = _batch(jcfg.vocab_size, 2, 96, seed=6)["tokens"]
    want = jsteps.prefill_step(params, {"tokens": jnp.asarray(toks)}, jcfg)
    fn, pspec, bspec = tsteps.build_prefill_step(tcfg, None)
    assert pspec is None and bspec is None
    got = fn(port, {"tokens": torch.from_numpy(toks)})
    assert got.shape == want.shape == (2, 1, jcfg.padded_vocab)
    v = jcfg.vocab_size
    assert float((got[..., :v].double() - _t(want)[..., :v]).abs().max()) \
        <= 1e-4


def test_default_microbatches_matches_one_data_shard():
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    for arch in ARCHS + ["granite-3-8b"]:
        jcfg, tcfg = jax_smoke_config(arch), get_smoke_config(arch)
        for gb in (1, 2, 3, 4, 6, 8, 16, 24, 64):
            assert tsteps.default_microbatches(tcfg, None, gb) == \
                jsteps.default_microbatches(jcfg, mesh, gb), (arch, gb)
    cfg = dataclasses.replace(get_smoke_config("granite-3-2b"),
                              train_microbatches=0)
    assert tsteps.default_microbatches(cfg, None, 4) == 4
    step, sspec, bspec = tsteps.build_train_step(cfg, None, global_batch=4)
    assert sspec is None and bspec is None
    assert step.keywords["microbatches"] == 4
    assert step.keywords["opt"] == OptConfig()


# -------------------------------------------------------------- pipeline
@pytest.mark.parametrize("frontend", [0, 4])
def test_synthetic_batches_equal_the_references(frontend):
    kw = dict(frontend_tokens=frontend, d_model=16 if frontend else 0)
    ours = SyntheticLM(49155, 33, 8, seed=11, **kw)
    ref = JaxSyntheticLM(49155, 33, 8, seed=11, **kw)
    for step in (0, 1, 7, 123456):
        for host in ((0, None), (0, 4), (4, 4), (2, 3)):
            a, b = ours.batch_at(step, *host), ref.batch_at(step, *host)
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype
                assert np.array_equal(a[k], b[k]), (step, host, k)


def test_synthetic_data_deterministic_and_host_sliced():
    """The reference's case, on the port."""
    src = SyntheticLM(1000, 16, 8, seed=3)
    a = src.batch_at(5)
    assert np.array_equal(a["tokens"], src.batch_at(5)["tokens"])
    assert not np.array_equal(a["tokens"], src.batch_at(6)["tokens"])
    half = src.batch_at(5, host_start=4, host_size=4)
    assert np.array_equal(half["tokens"], a["tokens"][4:8])
    assert np.array_equal(a["labels"][:, :-1], a["tokens"][:, 1:])


@pytest.mark.parametrize("start", [0, 5])
def test_prefetcher_orders_batches(start):
    src = SyntheticLM(1000, 8, 4, seed=1)
    ref = JaxPrefetcher(JaxSyntheticLM(1000, 8, 4, seed=1),
                        start_step=start)
    pre = Prefetcher(src, start_step=start)
    try:
        for i in range(4):
            got, want = pre.next(), ref.next()
            assert np.array_equal(got["tokens"],
                                  src.batch_at(start + i)["tokens"])
            assert np.array_equal(got["tokens"], want["tokens"])
    finally:
        pre.close()
        ref.close()
    assert not pre._thread.is_alive()


# ------------------------------------------------------------ launch.train
# the JAX package's log line (``launch/train.py:84``: f"step {step:5d}
# loss={...:.4f} gnorm={...:.3f} lr={...:.2e} {dt*1e3:.0f}ms");
# ``repro.launch.train`` itself does not run under the installed jax (its
# mesh's axes are Explicit there, and ``with_sharding_constraint``
# refuses them)
_LINE = re.compile(r"^step +\d+ loss=\d+\.\d{4} gnorm=\d+\.\d{3} "
                   r"lr=\d\.\d{2}e[-+]\d{2} \d+ms$")


@pytest.mark.parametrize("arch", ["granite-3-2b", "rwkv6-3b",
                                  "jamba-v0.1-52b"])
def test_train_cli_prints_the_references_lines_and_resumes(tmp_path,
                                                           capsys, arch,
                                                           one_thread):
    """``python -m repro_torch.launch.train --arch <arch> --smoke --steps
    4 --batch 4 --seq 64 --ckpt-dir … --ckpt-every 2 --device cpu``, then
    the same with ``--steps 6``, which resumes: a dense config and two
    with the new layer kinds (their checkpoints in the JAX package's
    layout)."""
    args = ["--arch", arch, "--smoke", "--steps", "4",
            "--batch", "4", "--seq", "64", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2", "--device", "cpu"]
    tlaunch.main(args)
    first = capsys.readouterr().out.splitlines()
    assert len(first) == 5 and all(_LINE.match(x) for x in first[:4]), first
    assert re.match(r"^done: final loss \d+\.\d{4}$", first[4])
    assert [x.split()[1] for x in first[:4]] == ["0", "1", "2", "3"]
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000002", "step_00000004"]
    # a second run resumes from the latest checkpoint
    tlaunch.main(args[:4] + ["6"] + args[5:])
    second = capsys.readouterr().out.splitlines()
    assert second[0] == "restored checkpoint at step 4"
    assert [x.split()[1] for x in second[1:3]] == ["4", "5"]
    assert all(_LINE.match(x) for x in second[1:3])


def test_train_resumed_equals_uninterrupted(tmp_path, one_thread):
    """4 steps straight against 2 steps, a checkpoint, and 2 more from it
    in a fresh process state: equal bit for bit on the CPU."""
    kw = dict(smoke=True, ckpt_every=2, device="cpu")
    full = tlaunch.train("granite-3-2b", 4, 4, 64,
                         ckpt_dir=str(tmp_path / "a"), **kw)
    resumed_dir = tmp_path / "b"
    resumed_dir.mkdir()
    (tmp_path / "a" / "step_00000002").rename(resumed_dir /
                                              "step_00000002")
    part = tlaunch.train("granite-3-2b", 4, 4, 64,
                         ckpt_dir=str(resumed_dir), **kw)
    assert [r["step"] for r in part["log"]] == [2, 3]
    assert [r["loss"] for r in part["log"]] == \
        [r["loss"] for r in full["log"][2:]]
    assert part["final_loss"] == full["final_loss"]
    a, b = full["state"], part["state"]
    for (n, x), (_, y) in zip(a["params"].named_parameters(),
                              b["params"].named_parameters()):
        assert torch.equal(x, y), n
    for part_name in ("m", "v"):
        for n in a[part_name]:
            assert torch.equal(a[part_name][n], b[part_name][n])
    assert int(b["step"]) == 4
    rec = full["log"][0]
    assert rec["seconds"] > 0 and rec["step_syncs"] is None
    assert rec["log_reads"] == 1 and math.isfinite(rec["grad_norm"])


def test_train_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.train("granite-3-2b", 1, 2, 16, smoke=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsteps.init_train_state(0, get_smoke_config("granite-3-2b"))
