"""Shared by the tests of training through the MoE, Mamba and RWKV layer
kinds and the modality frontends against the JAX package on the CPU:
``tests/test_torch_train_kinds.py`` (MoE), ``test_torch_train_jamba.py``
(hybrid), ``test_torch_train_rwkv.py`` (RWKV) and
``test_torch_train_frontends.py`` (the frontends), one file per layer kind
so that the workers of a parallel run share them; each holds its kind's
cases of the ``check_*`` functions below.

``train_step`` of the smoke configs of jamba-v0.1-52b (16 layers, 2
periods, capacity factor 1.25), mixtral-8x7b, rwkv6-3b, llava-next-34b
and musicgen-medium (with their frontends' embeddings in the batch):
two calls from one initial state against ``jax.jit`` of the JAX
package's ``train_step`` (``tests/test_torch_train.py``'s comparison),
float32 at microbatches 1 and 2 and bfloat16 at 2 on the three new
kinds; jamba's rows end in a run of one repeated token, which skews its
routers so that its MoE drops assignments (``chip_smoke.LM_PARITY``'s
prompts do the same).  The initial state is the port's
``init_train_state`` written in the JAX package's layout
(``convert.reference_tree``), so that no JAX initialiser compiles.

The truth is the JAX package's own train step in float64
(``_jax_float64``: JAX's 64-bit mode with its modules' float32 widened;
the traced step is checked to hold no other floating type), from the
same state and batches.  Tolerances, each from the reference alone:
  * float64: the port's two steps in float64
    (``testing.float64_evaluation``, which raises on any op that makes a
    floating tensor of another type) against the truth, every metric,
    parameter, m and v within ``F64`` = 1e-10 relative (measured ≤
    8.5e-14): any fault of the port's arithmetic shows at its own size,
    whatever its precision.
  * float32: per key — each metric, and each parameter, m and v by its
    relative Frobenius error — the port's error against the truth
    within 1e-5 or, where larger, ``REF_RATIO`` × the JAX package's own
    float32 error on that key against the truth (the larger of its runs
    at microbatches 1 and 2).  The 1e-5 alone cannot hold: the JAX
    package's own float32 steps lie up to 1.06e-5 (jamba ``conv_b``)
    and 5e-5 (rwkv ``u``'s m) from the truth — the factored WKV chunk's
    gradient is ill-conditioned, and AdamW's first steps on a
    zero-initialised tensor turn the rounding noise of a gradient
    element near 0 into a move of up to ±lr.
    ``check_a_planted_gradient_fault_exceeds_the_limits`` shows a 1 %
    gradient fault in one leaf beyond both limits.
  * bfloat16: each of loss, grad norm, parameters, m and v (the largest
    per-tensor error: a bfloat16 parameter moves only where its update
    passes half its ulp, so a tensor's error counts a handful of
    elements and one tensor's ratio is noise) within ``REF_RATIO`` ×
    the reference's own spread: the same JAX train step with the time
    chunk and attention blocks halved, compiled with
    ``xla_allow_excess_precision`` off (so that every bfloat16 op
    rounds, as eager PyTorch's do; XLA's default keeps fused bfloat16
    chains in float32).
"""

import contextlib
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.models import attention as ja
from repro.models import layers as jl
from repro.models import mamba as jmb
from repro.models import moe as jm
from repro.models import rwkv as jr
from repro.models import transformer as jt
from repro.train import loss as jloss
from repro.train import optimizer as jopt
from repro.train import steps as jsteps
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.convert import reference_tree
from repro_torch.models import mamba as tmb
from repro_torch.models import moe as tm
from repro_torch.models import rwkv as tr
from repro_torch.models import transformer as tt
from repro_torch.testing import (float64_evaluation, moe_routes,
                                 widen_train_state)
from repro_torch.train import OptConfig, lm_loss
from repro_torch.train import steps as tsteps
from test_torch_moe import _inputs, _jax_route, _moe
from test_torch_train import _batch, _cfgs, _rel, _t, _torch_batch

F32 = 1e-5
F64 = 1e-10
REF_RATIO = 2.5
T = 96
BATCH = 4
RUN = 32
# the smoke configs, jamba's at the production capacity factor
ARCHS = {"jamba-v0.1-52b": {"capacity_factor": 1.25}, "mixtral-8x7b": {},
         "rwkv6-3b": {}, "llava-next-34b": {}, "musicgen-medium": {}}
KINDS = ["jamba-v0.1-52b", "mixtral-8x7b", "rwkv6-3b"]
STEP_CASES = ([((a, "float32"), mb) for a in ARCHS for mb in (1, 2)]
              + [((a, "bfloat16"), 2) for a in KINDS])


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side of these tests runs on one intra-op thread: its
    smoke-width ops gain nothing from more, and a suite's parallel
    workers all spinning every core's OpenMP threads over thousands of
    small ops slow each other many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


# ------------------------------------------------------------ helpers
def _numpy(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy().copy()


def _jax_tree(state):
    """A port train state as a tree of numpy arrays in the JAX package's
    layout (``convert.reference_tree``: leaves stacked over periods)."""
    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, list):
            return [walk(v) for v in x]
        if isinstance(x, torch.Tensor):
            return _numpy(x)
        return np.stack([_numpy(p) for p in x.parts])
    return walk(reference_tree(state))


def _batches(jcfg, seed=0):
    out = []
    for s in (seed, seed + 1):
        b = _batch(jcfg.vocab_size, BATCH, T, seed=s)
        if jcfg.moe_experts and jcfg.capacity_factor < jcfg.moe_experts:
            b["tokens"][:, -RUN:] = b["tokens"][:, :1]
            b["labels"][:, -RUN - 1:-1] = b["tokens"][:, :1]
        if jcfg.frontend_tokens:
            b["frontend"] = (np.random.default_rng(10 + s).standard_normal(
                (BATCH, jcfg.frontend_tokens, jcfg.d_model)) * 0.02
            ).astype(np.float32)
        out.append(b)
    return out


def _port_steps(state0, batches, tcfg, mb, float64=False, hook=None):
    """Two ``train_step`` calls from ``state0`` (a JAX-layout tree), in
    float64 with ``float64`` (``testing.float64_evaluation``); ``hook``
    (name, parameter) may register gradient hooks first.  Returns the
    state, the metrics and the MoE plans made (forward and
    recomputation, in call order)."""
    state = convert.train_state(state0, tcfg, "cpu")
    if float64:
        state = widen_train_state(state)
    if hook is not None:
        for name, p in state["params"].named_parameters():
            hook(name, p)
    metrics = []
    tbs = [_torch_batch(_widen(b) if float64 else b) for b in batches]
    with (float64_evaluation() if float64 else contextlib.nullcontext()), \
            moe_routes() as plans:
        for b in tbs:
            state, m = tsteps.train_step(state, b, tcfg, OptConfig(),
                                         microbatches=mb)
            metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics, [tuple(a.detach() for a in p[:5]) for p in plans]


def _tensors(state):
    """{(part, name): tensor} of a port train state."""
    out = {("params", n): p.detach()
           for n, p in state["params"].named_parameters()}
    for part in ("m", "v"):
        out.update({(part, n): t for n, t in state[part].items()})
    return out


def _metric_rel(got, want, keys=("loss", "ce", "aux", "grad_norm", "lr")):
    return {k: max(abs(g[k] / w[k] - 1) if w[k] else abs(g[k])
                   for g, w in zip(got, want)) for k in keys}


def _errors(got, want, keys=("loss", "ce", "aux", "grad_norm", "lr")):
    """{key: relative error} of a run (state, metrics) against another:
    the metrics (the larger of the two steps'), and each parameter, m
    and v by its relative Frobenius error."""
    out = {("metric", k): e
           for k, e in _metric_rel(got[1], want[1], keys).items()}
    w = _tensors(want[0])
    out.update({k: _rel(x, w[k]) for k, x in _tensors(got[0]).items()})
    return out


def _by_part(errors):
    """The largest error of each part (a metric, params, m, v)."""
    out = {}
    for (part, name), e in errors.items():
        key = name if part == "metric" else part
        out[key] = max(out.get(key, 0.0), e)
    return out


# ------------------------------------- the JAX package's float64 steps
class _Float64Numpy:
    """``jax.numpy`` with ``float32`` standing for ``float64``."""
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


_JAX_MODULES = (ja, jl, jmb, jm, jr, jt, jloss, jopt, jsteps)


@contextlib.contextmanager
def _jax_float64():
    """Inside the block the JAX package's model and training modules
    trace in float64: JAX's 64-bit mode, and in each module a ``jnp``
    whose ``float32`` is ``float64``, so that every cast to float32 and
    every float32 buffer is float64.  The caller holds the traced step
    to that (``_float_types``): a float32 value reached another way
    would stay float32."""
    wide = _Float64Numpy()
    with jax.enable_x64(True):
        for mod in _JAX_MODULES:
            mod.jnp = wide
        try:
            yield
        finally:
            for mod in _JAX_MODULES:
                mod.jnp = jnp


def _float_types(closed) -> set:
    """The floating types of every value of a closed jaxpr, those of the
    jaxprs in its equations' parameters (jit, scan, remat) included."""
    from jax.extend import core as jcore
    found = set()

    def note(v):
        dt = getattr(getattr(v, "aval", None), "dtype", None)
        if dt is not None and jnp.issubdtype(dt, jnp.floating):
            found.add(np.dtype(dt).name)

    def visit(x):
        if isinstance(x, jcore.ClosedJaxpr):
            visit(x.jaxpr)
        elif isinstance(x, jcore.Jaxpr):
            for v in (*x.constvars, *x.invars, *x.outvars):
                note(v)
            for eqn in x.eqns:
                for v in (*eqn.invars, *eqn.outvars):
                    note(v)
                for param in eqn.params.values():
                    visit(param)
        elif isinstance(x, (tuple, list)):
            for y in x:
                visit(y)

    visit(closed)
    return found


def _widen(tree):
    """A tree of numpy arrays with every floating leaf in float64."""
    return jax.tree.map(lambda a: a.astype(np.float64)
                        if np.issubdtype(a.dtype, np.floating) else a, tree)


# ---------------------------------------------------------- reference
@pytest.fixture(scope="module")
def reference(request):
    return _reference(*request.param)


@functools.cache
def _reference(arch, dtype):
    """One config's initial state (the port's, in the JAX package's
    layout), its batches, and two-step runs, each computed once in this
    process: the JAX train step's (``jax_run``: as compiled by default,
    its bfloat16 ``"spread"`` variant, or in ``"float64"``) and the
    port's (``port_run``)."""
    jcfg, tcfg = _cfgs(arch, dtype, **ARCHS[arch])
    state0 = _jax_tree(tsteps.init_train_state(0, tcfg, device="cpu"))
    batches = _batches(jcfg)
    cache = {}

    def jax_run(mb, variant=None):
        """([state after each step], [metrics of each step]) of the JAX
        package's step; ``variant`` ``"spread"``: the time chunk and
        attention blocks halved, compiled with ``xla_allow_excess_precision``
        off (so that every bfloat16 op rounds, as eager PyTorch's do);
        ``"float64"``: the same step in float64 from the widened state
        (``_jax_float64``), checked to trace no other floating type."""
        if ("jax", mb, variant) not in cache:
            cfg, options, ctx = jcfg, None, contextlib.nullcontext()
            st0, bs = state0, batches
            if variant == "spread":
                cfg = dataclasses.replace(
                    jcfg, time_chunk=jcfg.time_chunk // 2,
                    q_block=jcfg.q_block // 2, kv_block=jcfg.kv_block // 2)
                options = {"xla_allow_excess_precision": False}
            elif variant == "float64":
                ctx = _jax_float64()
                st0, bs = _widen(state0), [_widen(b) for b in batches]
            with ctx:
                fn = jax.jit(functools.partial(
                    jsteps.train_step, cfg=cfg, opt=jopt.OptConfig(),
                    microbatches=mb))
                st = jax.tree.map(jnp.asarray, st0)
                jb = [{k: jnp.asarray(v) for k, v in b.items()}
                      for b in bs]
                traced = fn.trace(st, jb[0])
                if variant == "float64":
                    assert _float_types(traced.jaxpr) == {"float64"}
                step = traced.lower().compile(compiler_options=options)
                states, metrics = [], []
                for b in jb:
                    st, m = step(st, b)
                    states.append(jax.tree.map(np.asarray, st))
                    metrics.append(jax.tree.map(float, m))
            cache["jax", mb, variant] = (states, metrics)
        return cache["jax", mb, variant]

    def port_run(mb, float64=False):
        if ("port", mb, float64) not in cache:
            cache["port", mb, float64] = _port_steps(state0, batches, tcfg,
                                                     mb, float64=float64)
        return cache["port", mb, float64]

    def jax_state(mb, variant=None):
        """The JAX run's final state as a port train state, its metrics."""
        states, metrics = jax_run(mb, variant)
        return convert.train_state(states[-1], tcfg, "cpu"), metrics

    return types.SimpleNamespace(arch=arch, dtype=dtype, jcfg=jcfg,
                                 tcfg=tcfg, state0=state0, batches=batches,
                                 jax_run=jax_run, jax_state=jax_state,
                                 port_run=port_run)


def _case_id(case):
    (arch, dtype), mb = case
    return f"{arch}-{dtype}-mb{mb}"


def _float32_check(r, port, mb):
    """A float32 port run at ``mb`` microbatches ((state, metrics))
    against the JAX package's float64 steps at ``mb``, the truth: per key
    (a metric, or one parameter, m or v) its error and its limit, the
    larger of ``F32`` and ``REF_RATIO`` × the JAX package's own float32
    error on that key against its float64 steps (the larger of its runs
    at microbatches 1 and 2: two samples of its rounding), and that own
    error.  Nothing here comes from the port but the run under test."""
    err = _errors(port, r.jax_state(mb, "float64"))
    own = {}
    for split in (1, 2):
        one = _errors(r.jax_state(split), r.jax_state(split, "float64"))
        own = {k: max(own.get(k, 0.0), e) for k, e in one.items()}
    return {k: (e, max(F32, REF_RATIO * own[k]), own[k])
            for k, e in err.items()}


def check_train_step_matches_jax(reference, mb):
    """Two ``train_step`` calls against the JAX package's: the metrics,
    every parameter, m and v, within the module docstring's limits."""
    r = reference
    states, want_metrics = r.jax_run(mb)
    state, metrics, _ = r.port_run(mb)
    want = convert.train_state(states[-1], r.tcfg, "cpu")
    assert int(state["step"]) == int(want["step"]) == 2
    for m, wm in zip(metrics, want_metrics):
        assert set(m) == set(wm) == {"ce", "aux", "tokens", "loss",
                                     "grad_norm", "lr"}
        assert m["tokens"] == wm["tokens"] == BATCH // mb * T
        assert m["lr"] == wm["lr"]
        assert (m["aux"] > 0) == bool(r.tcfg.moe_experts)
    assert [p.dtype for p in state["params"].parameters()] == \
        [p.dtype for p in want["params"].parameters()]
    if r.dtype == "float32":
        check = _float32_check(r, (state, metrics), mb)
        port = _by_part({k: e for k, (e, _, _) in check.items()})
        own = _by_part({k: o for k, (_, _, o) in check.items()})
        print(f"{r.arch} float32 mb {mb}: against float64, port {port}, "
              f"reference {own}")
        beyond = {k: v for k, v in check.items() if v[0] > v[1]}
        assert not beyond, beyond
        return
    keys = ("loss", "grad_norm")
    err = _by_part(_errors((state, metrics), (want, want_metrics), keys))
    spread = _by_part(_errors(r.jax_state(mb, "spread"),
                              (want, want_metrics), keys))
    print(f"{r.arch} bfloat16 mb {mb}: port {err}, reference spread "
          f"{spread}")
    for key, s in spread.items():
        assert err[key] <= REF_RATIO * s, (key, err[key], s)


def check_float64_steps_match_the_references_float64_steps(reference):
    """The port's two steps at microbatches 2 in float64
    (``testing.float64_evaluation``) against the JAX package's in
    float64 (``_jax_float64``): every metric, parameter, m and v within
    ``F64``.  Without float32's rounding this holds any fault of the
    port's arithmetic (a gradient, a route, a drop, AdamW) to its own
    size, whatever its precision."""
    r = reference
    port = r.port_run(2, float64=True)
    assert all(p.dtype == torch.float64
               for p in port[0]["params"].parameters())
    err = _errors(port[:2], r.jax_state(2, "float64"))
    print(f"{r.arch} float64 mb 2: port against the JAX package "
          f"{_by_part(err)}")
    beyond = {k: e for k, e in err.items() if e > F64}
    assert not beyond, beyond


PLANTED = {"jamba-v0.1-52b": "mixer.d_skip", "rwkv6-3b": "mixer.u",
           "mixtral-8x7b": "ffn.router"}


def check_a_planted_gradient_fault_exceeds_the_limits(reference, leaf):
    """A fault that does not depend on precision — one leaf's gradient
    1 % too large in every layer (a Mamba ``d_skip``, an RWKV ``u``, a
    MoE router) — puts that leaf's m and v beyond their float32 limits
    (``_float32_check``) and every planted leaf's m beyond ``F64`` in
    float64: the limits come from the reference alone."""
    r = reference

    def plant(name, p):
        if name.endswith(leaf):
            p.register_hook(lambda g: g * 1.01)

    planted = {n for n, _ in convert.train_state(
        r.state0, r.tcfg, "cpu")["params"].named_parameters()
        if n.endswith(leaf)}
    assert planted
    run = _port_steps(r.state0, r.batches, r.tcfg, 1, hook=plant)
    check = _float32_check(r, run[:2], 1)
    beyond = {k for k, (e, limit, _) in check.items() if e > limit}
    assert {(part, n) for n in planted for part in ("m", "v")} <= beyond
    wide = _port_steps(r.state0, r.batches, r.tcfg, 1, float64=True,
                       hook=plant)
    err = _errors(wide[:2], r.jax_state(1, "float64"))
    assert all(err["m", n] > F64 for n in planted)


# ------------------------------------------------------ routes, drops
def _jax_routes(params, tokens, jcfg):
    """The reference's forward, each MoE layer's dispatch plan (se, st,
    sw, pos, keep) per MoE period position, stacked over periods: its
    mixer through ``_layer_apply`` with no FFN, its router on
    ``rms_norm(·, norm2)`` of that, then the whole layer."""
    h = jl.embed_tokens(params["embeddings"], tokens)
    b, t = tokens.shape
    positions = jnp.broadcast_to(jnp.arange(t), (b, t))
    cap = tm.capacity(jcfg, t)
    kinds = jcfg.period_kinds()

    def body(h, pp):
        plans = []
        for pos, kind in enumerate(kinds):
            if kind[1] == "moe":
                mid, _ = jt._layer_apply(pp[pos], h, positions, jcfg,
                                         (kind[0], None))
                x = jl.rms_norm(mid, pp[pos]["norm2"])
                plans.append(_jax_route(pp[pos]["ffn"], x, jcfg, cap)[:5])
            h, _ = jt._layer_apply(pp[pos], h, positions, jcfg, kind)
        return h, plans

    return jax.lax.scan(body, h, params["periods"])[1]


def check_routes_and_drops_equal_the_references(reference):
    """jamba at capacity factor 1.25: each step's routes (expert, token,
    slot, kept; weights within 1e-5) equal the reference's forward's from
    the same state, assignments drop, and under remat "full" the
    recomputation routes every token as the forward did."""
    r = reference
    assert r.tcfg.remat == "full"
    states, _ = r.jax_run(1)
    _, _, plans = _port_steps(r.state0, r.batches, r.tcfg, 1)
    moe_layers = [i for i in range(r.tcfg.n_layers)
                  if r.tcfg.layer_kind(i)[1] == "moe"]
    moe_pos = [p for p, k in enumerate(r.jcfg.period_kinds())
               if k[1] == "moe"]
    n = len(moe_layers)
    assert len(plans) == 2 * 2 * n             # 2 steps × (fwd + recompute)
    routes = jax.jit(_jax_routes, static_argnums=2)
    dropped = 0
    for step, params in enumerate([r.state0["params"],
                                   states[0]["params"]]):
        want = routes(jax.tree.map(jnp.asarray, params),
                      jnp.asarray(r.batches[step]["tokens"]), r.jcfg)
        fwd = plans[2 * n * step:2 * n * step + n]
        again = plans[2 * n * step + n:2 * n * (step + 1)][::-1]
        for j, layer in enumerate(moe_layers):
            period, pos = divmod(layer, r.jcfg.period)
            w = [np.asarray(a[period]) for a in want[moe_pos.index(pos)]]
            for i in (0, 1, 3, 4):              # expert, token, slot, kept
                assert np.array_equal(fwd[j][i].numpy(), w[i])
            np.testing.assert_allclose(fwd[j][2].numpy(), w[2], atol=F32)
            for a, b in zip(fwd[j], again[j]):
                assert torch.equal(a, b)
            dropped += int((~fwd[j][4]).sum())
    assert dropped > 0


def check_moe_gradients_match_jax_and_skip_drops(arch, factor):
    """``moe_ffn`` under autograd against ``jax.vjp`` of the reference's
    (float32, inputs that make factor 1.25 drop): the gradients to the
    tokens (through the dispatch's scatter, whose dropped assignments all
    land in the cut-off slot), the router (through the normalised top-k
    weights and the aux loss's mean of the probabilities) and the
    experts within 1e-5 of the largest; and the dispatch gives a dropped
    assignment's row no gradient, as the reference's ``mode="drop"``."""
    jcfg, tcfg, p, pt = _moe(arch, "float32", factor)
    t = 96
    xj, xt = _inputs(7, 2, t, jcfg)
    rng = np.random.default_rng(8)
    cot = rng.standard_normal((2, t, jcfg.d_model)).astype(np.float32)
    c_aux = 0.37

    def jf(p_, x_):
        out, aux = jm.moe_ffn(p_, x_, jcfg)
        return jnp.sum(out * cot) + c_aux * aux

    wgrads = jax.grad(jf, argnums=(0, 1))(p, xj)
    leaves = {k: v.clone().requires_grad_() for k, v in pt.items()}
    x = xt.clone().requires_grad_()
    out, aux = tm.moe_ffn(leaves, x, tcfg)
    grads = torch.autograd.grad(
        (out * torch.from_numpy(cot)).sum() + c_aux * aux,
        list(leaves.values()) + [x])
    for (k, g) in zip(list(leaves) + ["x"], grads):
        w = _t(wgrads[1] if k == "x" else wgrads[0][k])
        assert float((g.double() - w).abs().max()) <= \
            F32 * float(w.abs().max()), k
    # the dispatch alone: a token's row gets the cotangents of its kept
    # slots; an assignment past capacity gets none
    cap = tm.capacity(tcfg, t)
    e, k = tcfg.moe_experts, tcfg.moe_top_k
    ev = pt["w1"].shape[0]
    se, st, _, pos, keep, _, _ = tm._route(xt, pt["router"], e, k, cap,
                                           ev // e)
    pos_c = torch.where(keep, pos, cap)
    x = xt.clone().requires_grad_()
    buf = tm._dispatch(x, se, st, pos_c, ev, cap)
    c_buf = torch.randn(buf.shape, generator=torch.Generator()
                        .manual_seed(9))
    (g_x,) = torch.autograd.grad((buf * c_buf).sum(), x)
    want = torch.zeros_like(xt)
    for b in range(2):
        for a in range(se.shape[1]):
            if keep[b, a]:
                want[b, st[b, a]] += c_buf[b, se[b, a], pos[b, a]]
    assert torch.allclose(g_x, want, atol=1e-5)
    if factor is not None:
        assert int((~keep).sum()) > 0
        only_dropped = [(b, int(st[b, a])) for b in range(2)
                        for a in range(se.shape[1])
                        if not bool(keep[b][st[b] == st[b, a]].any())]
        for b, tok in only_dropped:
            assert not torch.any(g_x[b, tok])


# -------------------------------------------------------------- remat
def check_remat_policies_give_equal_gradients_over_the_new_kinds(arch,
                                                                 dtype):
    """remat "none", "full" and "dots" give bit-equal loss and gradients
    through the MoE (routes recomputed), Mamba and RWKV layers (one
    intra-op thread, ``_one_torch_thread``: PyTorch's CPU reductions add
    in a thread-dependent order)."""
    _, tcfg = _cfgs(arch, dtype, **ARCHS[arch])
    state = tsteps.init_train_state(1, tcfg, device="cpu")
    params = state["params"]
    batch = _torch_batch(_batches(tcfg, seed=4)[0])
    out = {}
    for remat in ("none", "full", "dots"):
        cfg = dataclasses.replace(tcfg, remat=remat)
        loss, _ = lm_loss(params, batch, cfg,
                          functools.partial(tt.forward, train=True))
        out[remat] = (loss.detach(), torch.autograd.grad(
            loss, list(params.parameters())))
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], out["none"][0])
        for g, w in zip(out[remat][1], out["none"][1]):
            assert torch.equal(g, w)


class _Ops(TorchDispatchMode):
    """Record each (op, args) the dispatcher sees."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        self.calls.append((func, args))
        return func(*args, **(kwargs or {}))


def _matmuls(fn):
    with _Ops() as rec:
        fn()
    mm = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default)
    return [(f, a) for f, a in rec.calls if f in mm]


def check_dots_policy_on_the_new_kinds():
    """The "dots" policy keeps the Mamba projections' matmuls (``xc @
    w_x``, ``dt_r @ w_dt``: no batch axes, as
    ``dots_with_no_batch_dims_saveable`` keeps them) and recomputes the
    MoE experts' einsums (batched over E_v), the Mamba readout's and the
    WKV chunk's (batched over B·T and B·H)."""
    from torch.utils.checkpoint import CheckpointPolicy
    save = CheckpointPolicy.MUST_SAVE

    def decisions(fn):
        calls = _matmuls(fn)
        assert calls
        return [tt._dots_policy(None, f, *a) is save for f, a in calls]

    _, cfg = _cfgs("jamba-v0.1-52b", "float32")
    gen = torch.Generator().manual_seed(0)
    mam = tmb.init_mamba(gen, cfg)
    x = torch.randn((2, 32, cfg.d_model), generator=gen)
    # x @ w_in and xc @ w_x
    assert decisions(lambda: tmb.mamba_split_in(mam, x, cfg)) == [True, True]
    xc = torch.randn((2, 32, cfg.d_inner), generator=gen,
                     requires_grad=True)
    proj = (xc @ mam["w_x"]).detach().requires_grad_()
    assert decisions(lambda: tmb._ssm_params(mam, xc, proj, cfg)) == [True]
    h0 = torch.zeros((2, cfg.d_inner, cfg.mamba_d_state))
    scan = decisions(lambda: tmb._chunked_ssm(mam, xc, proj, cfg, h0))
    chunks = 32 // tmb._chunk_len(cfg, 32)
    assert scan.count(True) == scan.count(False) == chunks   # dt, readout
    jcfg, tcfg, _, pt = _moe("mixtral-8x7b", "float32", None)
    buf = torch.randn((2, pt["w1"].shape[0], 8, tcfg.d_model),
                      generator=gen)
    assert decisions(lambda: tm._experts(pt, buf)) == [False] * 3
    _, rcfg = _cfgs("rwkv6-3b", "float32")
    hd = rcfg.rwkv_head_size
    h = rcfg.d_model // hd
    r, k, v = (torch.randn((2, 16, h, hd), generator=gen) for _ in range(3))
    lw = -torch.rand((2, 16, h, hd), generator=gen)
    u = torch.randn((h, hd), generator=gen)
    s0 = torch.zeros((2, h, hd, hd))
    assert not any(decisions(lambda: tr._wkv_chunk(r, k, v, lw, u, s0)))


# ------------------------------------------------------------ convert
def check_convert_train_state_carries_every_new_leaf(arch):
    """A train state in the JAX package's layout has its tree, shapes and
    types (``jax.eval_shape`` of its ``init_train_state``), and
    ``convert.train_state`` carries every leaf back bit for bit, the
    parameters trainable."""
    jcfg, tcfg = _cfgs(arch, "bfloat16", **ARCHS[arch])
    state = tsteps.init_train_state(0, tcfg, device="cpu")
    with torch.no_grad():
        for t in list(state["m"].values()) + list(state["v"].values()):
            t.normal_()
    state["step"].fill_(5)
    tree = _jax_tree(state)
    shapes = jax.eval_shape(functools.partial(jsteps.init_train_state,
                                              cfg=jcfg),
                            jax.random.PRNGKey(0))
    got = jax.tree_util.tree_flatten_with_path(tree)
    want = jax.tree_util.tree_flatten_with_path(shapes)
    assert [p for p, _ in got[0]] == [p for p, _ in want[0]]
    for (_, a), (_, s) in zip(got[0], want[0]):
        assert a.shape == s.shape and a.dtype == s.dtype
    back = convert.train_state(tree, tcfg, "cpu")
    assert int(back["step"]) == 5
    assert all(p.requires_grad for p in back["params"].parameters())
    for key, x in _tensors(state).items():
        y = _tensors(back)[key]
        assert x.dtype == y.dtype
        assert torch.equal(x.view(torch.int16) if x.dtype == torch.bfloat16
                           else x, y.view(torch.int16)
                           if y.dtype == torch.bfloat16 else y), key


# --------------------------------------------------------------- rwkv
def check_clip_gradient_at_the_bounds_is_the_references():
    """``jnp.clip``'s gradient is 0.5 at a bound, 1 inside, 0 outside;
    ``_clip_log_w`` gives the same (``torch.clamp`` would give 1)."""
    x = np.array([jr.LOG_W_MIN, jr.LOG_W_MAX, -6.0, -1.0, 0.0, -5.0 + 1e-6],
                 np.float32)
    want = jax.grad(lambda a: jnp.sum(jnp.clip(a, jr.LOG_W_MIN,
                                               jr.LOG_W_MAX)))(x)
    xt = torch.from_numpy(x).requires_grad_()
    (got,) = torch.autograd.grad(tr._clip_log_w(xt).sum(), xt)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(tr._clip_log_w(xt.detach()),
                       torch.clamp(xt.detach(), tr.LOG_W_MIN, tr.LOG_W_MAX))


def check_wkv_gradients_finite_at_full_head_size(dtype):
    """rwkv6-3b's time mix at its full width (d 2560, head size 64, chunk
    32, where the factored chunk's exponents may reach e^{|LOG_W_MIN|·c/2}
    = e^80 and a masked score be inf in the forward) with its initial
    weights, so that the decays are drawn as the init draws them: every
    gradient is finite.  (With every decay of a chunk at the floor
    LOG_W_MIN the backward overflows, the reference's too.)"""
    cfg = dataclasses.replace(get_config("rwkv6-3b"), dtype=dtype)
    assert (cfg.rwkv_head_size, cfg.time_chunk) == (64, 32)
    gen = torch.Generator().manual_seed(0)
    p = {k: v.requires_grad_()
         for k, v in tr.init_rwkv_time_mix(gen, cfg).items()}
    x = torch.randn((1, 64, cfg.d_model), generator=gen)
    x = (x * torch.rsqrt((x * x).mean(-1, keepdim=True))).to(
        cfg.torch_dtype).requires_grad_()
    out, _ = tr.rwkv_time_mix(p, x, cfg)
    assert torch.isfinite(out).all()
    grads = torch.autograd.grad(out.float().square().sum(),
                                list(p.values()) + [x])
    for g in grads:
        assert torch.isfinite(g).all()
