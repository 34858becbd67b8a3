"""The division-free distance oracle of K1 and K2, emulated on the CPU.

The kernels (``csrc/distance.cuh``) divide by nothing: every divisor of
a closed distance form (a tree stride, a torus axis' stride) gets a
fixed-point reciprocal on the host, ``p // s == (p·mul) >> shift`` for
0 <= p < 2^31 (``repro_torch.kernels.qap_objective.reciprocal``), and
the oracles compare per-level keys of the two PEs.  This file emulates
that integer arithmetic in numpy, with the ``FormParams`` the port's own
host helper builds (``form_params``), and holds it

  * against numpy's ``//`` and ``%``: exhaustively for every
    0 <= p < n_pe on every preset topology (``repro_torch.topology
    .presets`` and the hierarchy presets), the main path's machines and
    the card tests' shapes; for the card tests' 16-level tree, whose
    n_pe = 2,134,623,456 lies near 2^31, over the lowest and highest
    2^20 PEs and 2^20 drawn between (its divisors are also checked at
    the top of the whole range, below 2^31, where the error term of a
    reciprocal is largest);
  * against the JAX package's oracles ``_hier_distance`` and
    ``_torus_distance`` (``repro.kernels.qap_objective``): K2's keyed
    d(π_a, t) − d(π_b, t) and K1's d(p, q), exactly;
  * as whole kernels against the JAX package: K2 (keys hoisted, rows
    read four slots at a time and padded to K % 4 == 0 as the wrapper
    pads, each side summed over its slots in order, then the two sides
    added) against ``repro.kernels.pair_gain.pair_gains``, and K1 (per-
    thread sums over a grid-stride, a fixed block tree, the last block's
    fixed-order sum of the partials) against the JAX objective: equal on
    integer data (every float32 partial sum is an integer below 2^24),
    within rtol 1e-6 of Σ|w|·(|d_a| + |d_b|) (K2) and of Σ|w·d| (K1) on
    real data.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as rc
import repro.kernels.pair_gain as rpg
import repro.kernels.qap_objective as rqo
from repro.core.local_search import communication_pairs
from repro_torch.core import Hierarchy
from repro_torch.core.hierarchy import supermuc_like, tpu_v5e_fleet
from repro_torch.kernels.qap_objective import (MAX_LEVELS, form_params,
                                               reciprocal)
from repro_torch.topology import TorusTopology, presets
from test_torch_card import ORACLE_CASES, TORUS, TREE, oracle_pes


# ------------------------------------------------------------ emulation
class Oracle:
    """``csrc/distance.cuh`` in numpy, on the port's ``FormParams``."""

    def __init__(self, kind, params):
        self.kind = kind
        _, f = form_params(kind, params, torch.zeros((1, 1)))
        self.nlev = f.nlev
        self.ip = [int(x) for x in f.ip]
        self.rc = [(int(r.mul), int(r.shift)) for r in f.rc]
        self.fp = np.array(f.fp[:], np.float32)
        self.top = self.fp[self.nlev - 1] if self.nlev else np.float32(0)

    def div(self, p, i):
        """div_by(p, f.rc[i])."""
        mul, shift = self.rc[i]
        return ((np.asarray(p).astype(np.uint64) * np.uint64(mul))
                >> np.uint64(shift)).astype(np.int64)

    def keys(self, p):
        """keys_of: a tree's ancestors by level, a torus' coordinates."""
        if self.kind == "tree":
            return {lvl: self.div(p, lvl) for lvl in range(1, self.nlev)}
        out, q = {}, np.asarray(p, np.int64)
        for a in range(self.nlev):
            nxt = self.div(p, a + 1)
            out[a] = q - nxt * self.ip[a]
            q = nxt
        return out

    def _ring(self, a, x, y):
        e = np.abs(x - y)
        return self.fp[a] * np.minimum(e, self.ip[a] - e).astype(np.float32)

    def delta_keyed(self, pa, ka, pb, kb, t):
        """K2's d(pa, t) − d(pb, t), float32."""
        t = np.asarray(t, np.int64)
        if self.kind == "tree":
            da = np.full(t.shape, self.top, np.float32)
            db = np.full(t.shape, self.top, np.float32)
            for lvl in range(self.nlev - 1, 0, -1):      # top down
                kt = self.div(t, lvl)
                da = np.where(kt == ka[lvl], self.fp[lvl - 1], da)
                db = np.where(kt == kb[lvl], self.fp[lvl - 1], db)
            da = np.where(t == pa, np.float32(0), da)
            db = np.where(t == pb, np.float32(0), db)
            return (da - db).astype(np.float32)
        da = np.zeros(t.shape, np.float32)
        db = np.zeros(t.shape, np.float32)
        kt = self.keys(t)
        for a in range(self.nlev):
            da = da + self._ring(a, kt[a], ka[a])
            db = db + self._ring(a, kt[a], kb[a])
        return (da - db).astype(np.float32)

    def distance(self, p, q):
        """K1's d(p, q), float32."""
        p, q = np.asarray(p, np.int64), np.asarray(q, np.int64)
        kp, kq = self.keys(p), self.keys(q)
        if self.kind == "tree":
            d = np.full(p.shape, self.top, np.float32)
            for lvl in range(self.nlev - 1, 0, -1):      # top down
                d = np.where(kp[lvl] == kq[lvl], self.fp[lvl - 1], d)
            return np.where(p == q, np.float32(0), d)
        out = np.zeros(p.shape, np.float32)
        for a in range(self.nlev):
            out = out + self._ring(a, kp[a], kq[a])
        return out


def emulated_pair_gains(orc, nbr, wgt, perm, us, vs):
    """K2: the wrapper's padding to K % 4 == 0 (the row's own id, weight
    0), the pair's keys once, each side over its slots in order."""
    n, k = nbr.shape
    pad = -k % 4
    nbr = np.concatenate([nbr, np.repeat(np.arange(n)[:, None], pad, 1)], 1)
    wgt = np.concatenate([wgt, np.zeros((n, pad), np.float32)], 1)
    pu, pv = perm[us], perm[vs]
    ku, kv = orc.keys(pu), orc.keys(pv)

    def side(rows, other, pa, ka, pb, kb):
        s = np.zeros(len(rows), np.float32)
        for slot in range(nbr.shape[1]):
            node = nbr[rows, slot]
            w = np.where(node == other, np.float32(0), wgt[rows, slot])
            d = orc.delta_keyed(pa, ka, pb, kb, perm[node])
            s = (s + (w * d).astype(np.float32)).astype(np.float32)
        return s

    return (side(us, vs, pu, ku, pv, kv)
            + side(vs, us, pv, kv, pu, ku)).astype(np.float32)


def _block_tree(sm):
    """block_sum over each row of (blocks, 256) float32."""
    s = sm.shape[1] // 2
    while s:
        sm = np.concatenate([(sm[:, :s] + sm[:, s:2 * s]).astype(np.float32),
                             sm[:, s:]], axis=1)
        s //= 2
    return sm[:, 0]


def emulated_objective(orc, pu, pv, w, block=256, max_blocks=1024):
    """K1: nb = min(⌈E/256⌉, 1024) blocks; thread (b, t) sums edges
    b·256 + t + j·nb·256 in order, each block reduces in a fixed tree,
    the last block sums the partials b = t, t + 256, … and reduces them
    in the same tree."""
    e = len(w)
    nb = max(1, min(-(-e // block), max_blocks))
    stride = nb * block
    terms = (w * orc.distance(pu, pv)).astype(np.float32)
    terms = np.concatenate([terms, np.zeros(-e % stride, np.float32)])
    acc = np.zeros(stride, np.float32)
    for j in range(len(terms) // stride):
        acc = (acc + terms[j * stride:(j + 1) * stride]).astype(np.float32)
    partials = _block_tree(acc.reshape(nb, block))
    last = np.zeros(block, np.float32)
    for lo in range(0, nb, block):
        chunk = np.zeros(block, np.float32)
        chunk[:min(block, nb - lo)] = partials[lo:lo + block]
        last = (last + chunk).astype(np.float32)
    return np.float32(_block_tree(last[None, :])[0])


# --------------------------------------------------------------- shapes
def _tree_of(h):
    return "tree", h.oracle.kernel_params()


def _torus_of(t):
    return "torus", (t.dims, t.weights)


# every divisor must divide exactly for every PE of these machines
MACHINES = {
    "v5e-torus": _torus_of(presets.tpu_v5e_torus()),
    "v5e-torus-2pods": _torus_of(presets.tpu_v5e_torus(pods=2)),
    "v5p-torus": _torus_of(presets.tpu_v5p_torus()),
    "v5p-torus-2pods": _torus_of(presets.tpu_v5p_torus(pods=2)),
    "v5e-fleet-1pod": _tree_of(tpu_v5e_fleet(1)),
    "v5e-fleet-2pods": _tree_of(tpu_v5e_fleet(2)),
    "supermuc": _tree_of(supermuc_like()),
    "main-tree-4:16:64": _tree_of(Hierarchy.from_strings("4:16:64",
                                                         "1:10:100")),
    "main-torus-16^3": _torus_of(TorusTopology((16, 16, 16))),
    "forms-torus-16x16x4": _torus_of(TorusTopology((16, 16, 4))),
    "card-tree": ("tree", TREE),
    "card-torus": ("torus", TORUS),
    "card-tree-odd": ORACLE_CASES["tree-odd"],
    "card-torus-odd": ORACLE_CASES["torus-odd"],
    # strides that do not nest (6 is no multiple of 4): the reference's
    # top-down overwrite, not an ancestor hierarchy; the kernels follow it
    "tree-unnested": ("tree", ((1, 4, 6, 24), (1.0, 5.0, 20.0))),
}


def _n_pe(kind, params):
    return (int(params[0][-1]) if kind == "tree"
            else int(np.prod(params[0], dtype=np.int64)))


def _divisors(kind, params):
    """{rc index: divisor} — what ``form_params`` gives a reciprocal."""
    if kind == "tree":
        return {lvl: int(params[0][lvl]) for lvl in range(1, len(params[1]))}
    return {a: int(np.prod(params[0][:a], dtype=np.int64))
            for a in range(1, len(params[0]) + 1)}


def _check_divisions(kind, params, p):
    orc = Oracle(kind, params)
    for i, s in _divisors(kind, params).items():
        assert np.array_equal(orc.div(p, i), p // s), (i, s)
    if kind == "torus":
        keys, stride = orc.keys(p), 1
        for a, d in enumerate(params[0]):
            assert np.array_equal(keys[a], (p // stride) % d), a
            stride *= int(d)


@pytest.mark.parametrize("name", sorted(MACHINES))
def test_reciprocals_divide_exactly_for_every_pe(name):
    kind, params = MACHINES[name]
    _check_divisions(kind, params, np.arange(_n_pe(kind, params),
                                             dtype=np.int64))


def test_reciprocals_near_the_top_of_the_range():
    kind, params = ORACLE_CASES["tree16-top"]
    n_pe = _n_pe(kind, params)
    assert len(params[1]) == MAX_LEVELS and 2 ** 30 < n_pe < 2 ** 31
    span = 1 << 20
    rng = np.random.default_rng(0)
    p = np.concatenate([np.arange(span), np.arange(n_pe - span, n_pe),
                        rng.integers(span, n_pe - span, span)])
    _check_divisions(kind, params, p.astype(np.int64))
    # the top of the reciprocals' whole range, for these divisors and
    # for divisors of every magnitude
    top = np.arange(2 ** 31 - span, 2 ** 31, dtype=np.int64)
    for s in sorted(set(_divisors(kind, params).values())
                    | {1, 2, 3, 7, 641, 2 ** 16 + 1, 2 ** 30 + 1,
                       2 ** 31 - 1}):
        mul, shift = reciprocal(s)
        assert mul < 2 ** 32
        got = (top.astype(np.uint64) * np.uint64(mul)) >> np.uint64(shift)
        assert np.array_equal(got.astype(np.int64), top // s), s


def test_reciprocal_rejects_divisors_out_of_range():
    for s in (0, -3, 2 ** 31):
        with pytest.raises(ValueError, match="outside"):
            reciprocal(s)


def test_form_params_is_built_once_per_form():
    a = form_params("tree", TREE, torch.zeros((1, 1)))
    assert form_params("tree", TREE, torch.zeros((1, 1))) is a
    assert form_params("torus", TORUS, torch.zeros((1, 1))) is not a
    with pytest.raises(ValueError, match="at most 16"):
        form_params("tree", (tuple(range(1, 19)), (1.0,) * 17),
                    torch.zeros((1, 1)))


# --------------------------------------------------------------- oracles
def _jax_distance(kind, params, p, q):
    pj, qj = jnp.asarray(p, jnp.int32), jnp.asarray(q, jnp.int32)
    fn = rqo._hier_distance if kind == "tree" else rqo._torus_distance
    return np.asarray(fn(pj, qj, *params))


def _pe_pairs(kind, params):
    """Every pair of PEs for n_pe <= 1024; else every pair of 512 PEs
    that meet at every level (``oracle_pes``)."""
    n_pe = _n_pe(kind, params)
    pes = (np.arange(n_pe) if n_pe <= 1024
           else oracle_pes(kind, params, 512, seed=1).astype(np.int64))
    p, q = np.meshgrid(pes, pes, indexing="ij")
    return p.reshape(-1), q.reshape(-1)


ORACLE_SHAPES = {**{k: MACHINES[k] for k in (
    "v5e-torus", "v5p-torus", "v5e-fleet-2pods", "supermuc",
    "main-tree-4:16:64", "card-tree", "card-torus", "card-tree-odd",
    "card-torus-odd", "tree-unnested")},
    "card-tree16-top": ORACLE_CASES["tree16-top"]}


@pytest.mark.parametrize("name", sorted(ORACLE_SHAPES))
def test_emulated_oracles_equal_the_jax_package(name):
    kind, params = ORACLE_SHAPES[name]
    orc = Oracle(kind, params)
    p, t = _pe_pairs(kind, params)
    want = _jax_distance(kind, params, p, t)
    assert np.array_equal(orc.distance(p, t), want)             # K1
    # K2: pa fixed against every t, pb another PE
    pb = np.roll(p, 7)
    want_b = _jax_distance(kind, params, pb, t)
    got = orc.delta_keyed(p, orc.keys(p), pb, orc.keys(pb), t)
    assert np.array_equal(got, (want - want_b).astype(np.float32))


# ---------------------------------------------------------------- kernels
GAIN_CASES = ["card-tree16-top", "card-tree-odd", "card-torus-odd",
              "main-tree-4:16:64"]


def _graph(real):
    """grid3d(8, 8, 8): n = 512, max degree 6, so ELL rows of K = 6 that
    the wrapper pads to 8; real weights on request."""
    g = rc.grid3d(8, 8, 8)
    if real:
        u, v, _ = g.edge_list()
        w = np.random.default_rng(4).random(len(u)) * 4.0 + 0.5
        g = rc.graph.from_edges(g.n, u, v, w)
    return g


def _pes(name, n):
    kind, params = ORACLE_SHAPES[name]
    if name.startswith("card-tree16") or name.endswith("-odd"):
        return oracle_pes(kind, params, n, seed=2).astype(np.int64)
    return np.random.default_rng(2).permutation(n)


@pytest.mark.parametrize("real", [False, True], ids=["integer", "real"])
@pytest.mark.parametrize("name", GAIN_CASES)
def test_emulated_pair_gains_equal_the_jax_package(name, real):
    kind, params = ORACLE_SHAPES[name]
    g = _graph(real)
    pairs = np.concatenate([communication_pairs(g, 3),
                            np.array([[5, 5], [0, 0]])])
    dg = rc.DeviceGraph.from_comm(g, pad_deg_to=1)
    assert dg.max_deg == 6
    perm = _pes(name, g.n)
    us, vs = pairs[:, 0], pairs[:, 1]
    nbr, wgt = np.asarray(dg.nbr), np.asarray(dg.wgt)
    want = np.asarray(rpg.pair_gains(
        kind, params, dg.nbr, dg.wgt, jnp.asarray(perm, jnp.int32),
        jnp.asarray(us, jnp.int32), jnp.asarray(vs, jnp.int32),
        jnp.zeros((1, 1))))
    got = emulated_pair_gains(Oracle(kind, params), nbr, wgt, perm, us, vs)
    assert np.all(got[-2:] == 0.0)                      # padding pairs
    if not real:
        assert np.array_equal(got, want)
        return
    # Σ over both sides of |w|·(|d(π_a, t)| + |d(π_b, t)|)
    mag = np.zeros(len(pairs))
    for a, b in ((us, vs), (vs, us)):
        t = perm[nbr[a]]
        for pe in (perm[a], perm[b]):
            d = _jax_distance(kind, params,
                              np.repeat(pe[:, None], t.shape[1], 1), t)
            mag += np.sum(np.abs(wgt[a]) * d, axis=1)
    assert np.all(np.abs(got - want) <= 1e-6 * mag)


@pytest.mark.parametrize("e", [1000, 70000, 300000])
@pytest.mark.parametrize("name", ["card-tree16-top", "card-torus-odd"])
def test_emulated_objective_equals_the_jax_package(name, e):
    """E = 70,000: 274 blocks and the last block's sum; 300,000: the
    grid capped at 1024 blocks, each thread over several edges."""
    kind, params = ORACLE_SHAPES[name]
    rng = np.random.default_rng(e)
    pes = _pes(name, 512)
    u, v = rng.integers(0, 512, e), rng.integers(0, 512, e)
    pu, pv = pes[u], pes[v]
    d = _jax_distance(kind, params, pu, pv)
    orc = Oracle(kind, params)
    w_int = rng.integers(1, 3, e).astype(np.float32)
    exact = float(np.sum(w_int.astype(np.float64) * d))
    assert exact < 2 ** 24              # so every partial sum is exact
    assert float(emulated_objective(orc, pu, pv, w_int)) == exact
    w = (rng.random(e) * 3.0).astype(np.float32)
    want = float(rqo.qap_objective_edges(
        jnp.asarray(pu, jnp.int32), jnp.asarray(pv, jnp.int32),
        jnp.asarray(w), *params, interpret=True)) if kind == "tree" else \
        float(rqo.qap_objective_edges_torus(
            jnp.asarray(pu, jnp.int32), jnp.asarray(pv, jnp.int32),
            jnp.asarray(w), *params, interpret=True))
    got = float(emulated_objective(orc, pu, pv, w))
    assert abs(got - want) <= 1e-6 * float(np.sum(np.abs(w) * d))
