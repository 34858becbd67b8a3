"""Plain versions of the port's two kernels against the JAX package.

K1 (the edge-list QAP objective) is held against the three Pallas
entries ``qap_objective_edges``, ``qap_objective_edges_torus`` and
``qap_objective_edges_matrix`` (interpret mode); K2 (the sparse pair
gains) against ``pair_gains_pallas`` (interpret mode) and the fused
``pair_gains``.  Forms: tree, torus, float32 matrix, int8 and int16
packed matrices.

Tolerances: with integer weights and distances every float32 sum is
exact in any order, so results must be *equal*.  With real weights the
two packages add the same float32 terms in different orders, so they
agree to rtol 1e-6 of Σ|w·d| (a few float32 ulps of the magnitude).

The :class:`DeviceGraph` and ``device_pairs`` that ``repro_torch.convert``
carries across from the JAX package must equal the port's own, element
by element.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as rc
import repro.kernels.pair_gain as rpg
import repro.kernels.qap_objective as rqo
import repro.topology as rt
import repro_torch.core as tc
from repro.core.graph import from_edges
from repro.kernels.config import quantize_table
from repro_torch import convert
from repro_torch.kernels import (OBJECTIVE_KERNEL, PAIR_GAIN_KERNEL,
                                 pair_gains, pair_gains_plain,
                                 qap_objective_edges, qap_objective_plain)
from repro_torch.kernels.pair_gain import edge_objective

N = 64
TREE = ((1, 4, 16, 64), (1.0, 10.0, 100.0))
TORUS = ((4, 4, 4), (1.0, 2.0, 3.0))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run tiny tensors: one intra-op thread, so
    parallel test workers do not oversubscribe the CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _tables():
    torus = rt.TorusTopology((4, 4, 4), (1.0, 2.0, 3.0))
    d_int = torus.distance_matrix()                        # max 9: int8
    d_i16 = d_int * 37.0                                   # max 333: int16
    rng = np.random.default_rng(7)
    r = rng.random((N, N)) * 5.0
    d_real = np.triu(r, 1) + np.triu(r, 1).T               # not packable
    return {"f32": d_int, "f32real": d_real, "int8": d_int, "int16": d_i16}


TABLES = _tables()
INT_FORMS = ["tree", "torus", "f32", "int8", "int16"]
REAL_FORMS = ["tree", "torus", "f32real", "int8", "int16"]


def _dense(name):
    """The full float64 distance matrix of a form (test oracle)."""
    if name == "tree":
        return rc.Hierarchy((4, 4, 4), TREE[1]).distance_matrix()
    if name == "torus":
        return rt.TorusTopology(*TORUS).distance_matrix()
    return TABLES[name]


def _form(name):
    """(kind, params, jax table, torch table) for one distance form."""
    if name == "tree":
        return "tree", TREE, jnp.zeros((1, 1)), torch.zeros((1, 1))
    if name == "torus":
        return "torus", TORUS, jnp.zeros((1, 1)), torch.zeros((1, 1))
    D = TABLES[name]
    if name.startswith("f32"):
        return ("matrix", (), jnp.asarray(D, jnp.float32),
                torch.from_numpy(D.astype(np.float32)))
    packed, _ = quantize_table(D, name)
    return "matrix", (), jnp.asarray(packed), torch.from_numpy(packed)


def _edges(e, real, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, N, e)
    v = (u + rng.integers(1, N, e)) % N
    w = rng.random(e) * 3.0 if real else rng.integers(1, 10, e) * 1.0
    perm = rng.permutation(N)
    return u, v, w.astype(np.float32), perm


def _ref_objective(name, u, v, w, perm):
    kind, params, Dj, _ = _form(name)
    pu = jnp.asarray(perm[u], jnp.int32)
    pv = jnp.asarray(perm[v], jnp.int32)
    wj = jnp.asarray(w)
    if kind == "tree":
        return float(rqo.qap_objective_edges(pu, pv, wj, *params,
                                             interpret=True))
    if kind == "torus":
        return float(rqo.qap_objective_edges_torus(pu, pv, wj, *params,
                                                   interpret=True))
    return float(rqo.qap_objective_edges_matrix(pu, pv, wj, Dj,
                                                interpret=True))


def _port_objective(name, u, v, w, perm):
    kind, params, _, Dt = _form(name)
    t = lambda a: torch.from_numpy(np.asarray(a, np.int32))  # noqa: E731
    return qap_objective_plain(kind, params, t(u), t(v),
                               torch.from_numpy(w), t(perm), Dt)


def _magnitude(name, u, v, w, perm):
    """Σ_e |w_e · d_e| — the scale the real-weight tolerance is relative
    to."""
    return float(np.sum(np.abs(w) * np.abs(_dense(name)[perm[u], perm[v]])))


# ------------------------------------------------------------------- K1
@pytest.mark.parametrize("name", INT_FORMS)
@pytest.mark.parametrize("e", [128, 1000])          # 1000: ragged tail
def test_objective_plain_equals_pallas_integer(name, e):
    u, v, w, perm = _edges(e, real=False)
    got = _port_objective(name, u, v, w, perm)
    assert got.dtype == torch.float32 and got.shape == ()
    assert float(got) == _ref_objective(name, u, v, w, perm)


@pytest.mark.parametrize("name", REAL_FORMS)
def test_objective_plain_matches_pallas_real(name):
    u, v, w, perm = _edges(1000, real=True, seed=3)
    ref = _ref_objective(name, u, v, w, perm)
    got = float(_port_objective(name, u, v, w, perm))
    assert abs(got - ref) <= 1e-6 * _magnitude(name, u, v, w, perm)


@pytest.mark.parametrize("name", ["tree", "torus", "int8"])
def test_objective_padding_edges_are_inert(name):
    kind, params, _, Dt = _form(name)
    u, v, w, perm = _edges(300, real=False, seed=5)
    t = lambda a: torch.from_numpy(np.asarray(a, np.int32))  # noqa: E731
    base = qap_objective_plain(kind, params, t(u), t(v), torch.from_numpy(w),
                               t(perm), Dt)
    pad = 212
    padded = qap_objective_plain(
        kind, params, t(np.pad(u, (0, pad))), t(np.pad(v, (0, pad))),
        torch.from_numpy(np.pad(w, (0, pad))), t(perm), Dt)
    assert float(padded) == float(base)


def test_wrappers_run_the_plain_version_on_cpu_tensors():
    kind, params, _, Dt = _form("tree")
    u, v, w, perm = _edges(256, real=False)
    t = lambda a: torch.from_numpy(np.asarray(a, np.int32))  # noqa: E731
    before = OBJECTIVE_KERNEL.launches
    got = qap_objective_edges(kind, params, t(u), t(v), torch.from_numpy(w),
                              t(perm), Dt)
    assert float(got) == float(_port_objective("tree", u, v, w, perm))
    assert OBJECTIVE_KERNEL.launches == before     # no launch on the CPU


@pytest.mark.parametrize("acc", ["float32", "float64"])
def test_edge_objective_chunked_equals_flat(acc):
    """The tiled CPU form (config chunk < E) adds the same terms."""
    from repro_torch.kernels.config import KernelConfig
    kind, params, _, Dt = _form("torus")
    u, v, w, perm = _edges(1000, real=False, seed=9)
    t = lambda a: torch.from_numpy(np.asarray(a, np.int32))  # noqa: E731
    args = (kind, params, t(u), t(v), torch.from_numpy(w), t(perm), Dt)
    flat = edge_objective(*args)
    cfg = KernelConfig(block_rows=1, lanes=128, acc_dtype=acc)
    tiled = edge_objective(*args, config=cfg)
    assert float(tiled) == float(flat)
    assert tiled.dtype == torch.float32


# ------------------------------------------------------------------- K2
def _graph(real):
    g = rc.random_geometric(N, 0.25, seed=11)
    if real:
        rng = np.random.default_rng(4)
        w = rng.random(g.num_edges) * 4.0 + 0.5
        u, v, _ = g.edge_list()
        g = from_edges(N, u, v, w)
    return g


def _pairs_with_padding(g):
    from repro.core.local_search import communication_pairs
    pairs = communication_pairs(g, 3)
    return np.concatenate([pairs, np.array([[5, 5], [0, 0], [17, 17]])])


def _gains_both(name, real):
    kind, params, Dj, Dt = _form(name)
    g = _graph(real)
    pairs = _pairs_with_padding(g)
    perm = np.random.default_rng(2).permutation(N)
    dg_r = rc.DeviceGraph.from_comm(g)
    us_r, vs_r = rc.device_pairs(pairs)
    pj = jnp.asarray(perm, jnp.int32)
    ref_pallas = np.asarray(rpg.pair_gains_pallas(
        kind, params, dg_r.nbr, dg_r.wgt, pj, us_r, vs_r, Dj,
        interpret=True))
    ref_fused = np.asarray(rpg.pair_gains(
        kind, params, dg_r.nbr, dg_r.wgt, pj, us_r, vs_r, Dj))
    gt = tc.graph.from_edges(N, *g.edge_list())
    dg_t = tc.DeviceGraph.from_comm(gt, device="cpu")
    us_t, vs_t = tc.device_pairs(pairs, device="cpu")
    pt = torch.from_numpy(perm.astype(np.int32))
    got = pair_gains_plain(kind, params, dg_t.nbr, dg_t.wgt, pt, us_t, vs_t,
                           Dt).numpy()
    # Σ over both sides of |w|·(|d(π_a, t)| + |d(π_b, t)|) per pair: the
    # scale the real-weight tolerance is relative to
    C = np.abs(g.to_dense())
    B = np.abs(_dense(name)[np.ix_(perm, perm)])
    own = np.sum(C * B, axis=1)
    cross = C @ B.T
    us, vs = pairs[:, 0], pairs[:, 1]
    mag = own[us] + cross[us, vs] + own[vs] + cross[vs, us]
    return got, ref_pallas, ref_fused, len(pairs), mag


@pytest.mark.parametrize("name", INT_FORMS)
def test_pair_gains_plain_equals_pallas_integer(name):
    got, ref_pallas, ref_fused, p, _ = _gains_both(name, real=False)
    assert got.dtype == np.float32
    assert np.array_equal(got, ref_pallas)
    assert np.array_equal(got, ref_fused)
    # padding pairs (u, u) — the explicit ones and the (0, 0) tail
    assert np.all(got[p - 3:] == 0.0)


@pytest.mark.parametrize("name", REAL_FORMS)
def test_pair_gains_plain_matches_pallas_real(name):
    got, ref_pallas, ref_fused, p, mag = _gains_both(name, real=True)
    live = got[:p]
    assert np.all(np.abs(live - ref_pallas[:p]) <= 1e-6 * mag)
    assert np.all(np.abs(live - ref_fused[:p]) <= 1e-6 * mag)
    assert np.all(got[p - 3:] == 0.0)


def test_pair_gains_tiled_equals_fused():
    from repro_torch.kernels.config import KernelConfig
    kind, params, _, Dt = _form("tree")
    g = tc.random_geometric(N, 0.25, seed=11)
    from repro_torch.core.local_search import communication_pairs
    pairs = communication_pairs(g, 3)
    dg = tc.DeviceGraph.from_comm(g, device="cpu")
    us, vs = tc.device_pairs(pairs, device="cpu")
    perm = torch.from_numpy(np.random.default_rng(1).permutation(N)
                            .astype(np.int32))
    fused = pair_gains_plain(kind, params, dg.nbr, dg.wgt, perm, us, vs, Dt)
    cfg = KernelConfig(block_rows=1, lanes=128)        # tile = 16 pairs
    tiled = pair_gains_plain(kind, params, dg.nbr, dg.wgt, perm, us, vs, Dt,
                             config=cfg)
    assert torch.equal(fused, tiled)
    before = PAIR_GAIN_KERNEL.launches
    wrapped = pair_gains(kind, params, dg.nbr, dg.wgt, perm, us, vs, Dt)
    assert torch.equal(wrapped, fused)
    assert PAIR_GAIN_KERNEL.launches == before     # no launch on the CPU


# ------------------------------------------------------ carried-across state
def test_convert_device_graph_and_pairs_equal_the_ports_own():
    g_r = rc.random_geometric(N, 0.3, seed=1)
    g_t = convert.graph(g_r.xadj, g_r.adjncy, g_r.adjwgt, g_r.vwgt)
    dg_r = rc.DeviceGraph.from_comm(g_r)
    k, e = dg_r.max_deg + 8, dg_r.eu.shape[0] + 256
    dg_r = dg_r.pad_to(k, e)
    carried = convert.device_graph(
        *(np.asarray(a) for a in (dg_r.nbr, dg_r.wgt, dg_r.eu, dg_r.ev,
                                  dg_r.ew)),
        n=dg_r.n, num_edges=dg_r.num_edges, device="cpu")
    own = tc.DeviceGraph.from_comm(g_t, device="cpu").pad_to(k, e)
    for key in ("nbr", "wgt", "eu", "ev", "ew"):
        a, b = getattr(carried, key), getattr(own, key)
        assert a.dtype == b.dtype and torch.equal(a, b), key
    assert (carried.n, carried.num_edges) == (own.n, own.num_edges)
    from repro.core.local_search import communication_pairs
    pairs = communication_pairs(g_r, 2)
    us_r, vs_r = rc.device_pairs(pairs, pad_to=256)
    us_c, vs_c = convert.pairs(np.asarray(us_r), np.asarray(vs_r), "cpu")
    us_t, vs_t = tc.device_pairs(pairs, pad_to=256, device="cpu")
    assert torch.equal(us_c, us_t) and torch.equal(vs_c, vs_t)
    assert us_t.dtype == torch.int32
    perm = np.random.default_rng(0).permutation(N)
    assert torch.equal(convert.perm(perm, "cpu"),
                       torch.from_numpy(perm.astype(np.int32)))
