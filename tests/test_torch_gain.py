"""The port's dense gain matrix (K3's plain version, ``kernels.ops``,
``Mapper.gain_matrix``) against the JAX package.

The JAX side runs its Pallas kernel in interpret mode, as its own tests
do.  Inputs are made with numpy from a seed and handed to both packages.

Tolerances: on integer C and D every product and partial sum is an
integer below 2²⁴, so both packages' float32 G must be *identical*.  On
real data the two add the same float32 products in different orders;
each of G's four dot products (d_u, d_v, M[u,v], M[v,u]) is within
n·2⁻²⁴·max(|C|·|B|ᵀ) of the exact sum in each, so the stated bound on
|ΔG| is n·2⁻²²·max(|C|·|B|ᵀ).

K3's arithmetic on the card (3xTF32 on the tensor cores) cannot run
here; ``_gain_3xtf32`` emulates it in numpy — the same big/small split,
the same three products into one float32 sum, the same S taken from the
upper triangle — and the contract tests hold the emulation to K3's
tolerance contract: bit-equal to the JAX package on integer instances,
within n·2⁻²²·max(|C|·|B|ᵀ) and the per-element limit 2⁻¹⁸·S(u,v)
(``kernels.ref.swap_gain_limits``) on real data, and planted faults
beyond the per-element limit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as rc
import repro.topology as rt
import repro_torch.core as tc
import repro_torch.kernels as tk
import repro_torch.topology as tt
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro_torch import convert
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.swap_gain import (swap_gain_matrix,
                                           swap_gain_matrix_plain)

N = 64
TOPOLOGIES = ["tree", "torus", "fattree", "dragonfly", "matrix"]
CASES = [(8, 8), (16, 8), (40, 16), (64, 32), (100, 32), (128, 128),
         (192, 64), (256, 128)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _instance(n, seed, integer, density=0.3):
    """The JAX package's kernel instance (``tests/test_kernels.py``):
    random symmetric C of the given density and D with zero diagonals,
    real-valued or integer-valued."""
    rng = np.random.default_rng(seed)
    if integer:
        vals_c = rng.integers(1, 10, (n, n)).astype(np.float64)
        vals_d = rng.integers(1, 100, (n, n)).astype(np.float64)
    else:
        vals_c, vals_d = rng.random((n, n)), rng.random((n, n))
    C = np.triu(vals_c * (rng.random((n, n)) < density), 1)
    D = np.triu(vals_d, 1)
    return C + C.T, D + D.T, rng.permutation(n)


def _bound(C, D, perm):
    """n·2⁻²²·max(|C|·|B|ᵀ), B = D[perm][:, perm], in float64."""
    B = np.asarray(D, np.float64)[np.ix_(perm, perm)]
    return len(C) * 2.0 ** -22 * np.max(np.abs(C) @ np.abs(B).T)


def _port(C, D, perm, tile):
    return tops.gain_matrix(C, D, perm, tile=tile, device="cpu").numpy()


def _ref(C, D, perm, tile):
    return np.asarray(rops.gain_matrix(C, D, perm, tile=tile,
                                       interpret=True))


@pytest.mark.parametrize("integer", [True, False], ids=["int", "real"])
@pytest.mark.parametrize("n,tile", CASES)
def test_gain_matrix_equals_reference_kernel(n, tile, integer):
    C, D, perm = _instance(n, n, integer)
    got, want = _port(C, D, perm, tile), _ref(C, D, perm, tile)
    assert got.dtype == np.float32 and got.shape == (n, n)
    if integer:
        assert np.array_equal(got, want)
        assert np.array_equal(got, rc.dense_gain_matrix(C, D, perm))
    else:
        assert np.max(np.abs(got - want)) <= _bound(C, D, perm)
    assert np.all(np.diag(got) == 0.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gain_matrix_input_dtypes(dtype):
    """Both packages cast to float32 inside; the inputs are rounded to
    the working type once, by torch, and both get the rounded values."""
    C, D, perm = _instance(64, 0, integer=False)
    tdt = getattr(torch, dtype)
    Ct = torch.from_numpy(C.astype(np.float32)).to(tdt)
    Dt = torch.from_numpy(D.astype(np.float32)).to(tdt)
    got = tops.gain_matrix(Ct, Dt, perm, tile=32, device="cpu").numpy()
    Cr, Dr = Ct.float().numpy(), Dt.float().numpy()
    want = np.asarray(rops.gain_matrix(
        jnp.asarray(Cr, getattr(jnp, dtype)),
        jnp.asarray(Dr, getattr(jnp, dtype)), perm, tile=32,
        interpret=True))
    assert got.dtype == np.float32
    assert np.max(np.abs(got - want)) <= _bound(Cr, Dr, perm)


@pytest.mark.parametrize("integer", [True, False], ids=["int", "real"])
def test_ref_oracle_equals_reference_oracle(integer):
    C, D, perm = _instance(100, 5, integer)
    got = tops.gain_matrix_ref(C, D, perm, device="cpu").numpy()
    want = np.asarray(rops.gain_matrix_ref(C, D, perm))
    plain = swap_gain_matrix_plain(torch.from_numpy(C), tops.
                                   permuted_distances(torch.from_numpy(D),
                                                      perm)).numpy()
    if integer:
        assert np.array_equal(got, want) and np.array_equal(plain, want)
    else:
        bound = _bound(C, D, perm)
        assert np.max(np.abs(got - want)) <= bound
        assert np.max(np.abs(plain - want)) <= bound


def test_hier_distance_and_objective_ref_equal_reference():
    h_ref = rc.Hierarchy((4, 4, 4), (1.0, 10.0, 100.0))
    h_port = tc.Hierarchy((4, 4, 4), (1.0, 10.0, 100.0))
    rng = np.random.default_rng(3)
    pu, pv = rng.integers(0, 64, 500), rng.integers(0, 64, 500)
    strides = tuple(int(s) for s in h_ref.strides)
    got = tref.hier_distance_ref(torch.from_numpy(pu), torch.from_numpy(pv),
                                 strides, h_ref.distances).numpy()
    want = np.asarray(rref.hier_distance_ref(jnp.asarray(pu),
                                             jnp.asarray(pv), strides,
                                             h_ref.distances))
    assert np.array_equal(got, want)
    g_ref = rc.random_geometric(64, 0.25, seed=3)
    g_port = convert.graph(g_ref.xadj, g_ref.adjncy, g_ref.adjwgt,
                           g_ref.vwgt)
    perm = rng.permutation(64)
    j = rc.qap_objective(g_ref, h_ref, perm)
    assert tops.objective(g_port, h_port, perm, device="cpu") == j
    assert tops.objective_ref(g_port, h_port, perm, device="cpu") == j
    assert rops.objective(g_ref, h_ref, perm, interpret=True) == j


def test_comm_matrix_equals_to_dense():
    g = tc.random_geometric(N, 0.25, seed=9)
    rng = np.random.default_rng(2)
    u, v, _ = g.edge_list()
    g = tc.from_edges(N, u, v, rng.random(len(u)) * 4.0 + 0.5)
    C = tops.comm_matrix(g, device="cpu")
    assert C.dtype == torch.float32
    assert np.array_equal(C.numpy(), g.to_dense().astype(np.float32))


def test_swap_gain_matrix_wrapper_contract():
    assert "swap_gain_matrix" in tk.KERNELS
    assert "swap_gain_matrix" not in tk.__all__
    assert callable(tk.swap_gain_matrix)
    before = tk.KERNELS["swap_gain_matrix"].launches
    C = torch.zeros((5, 5), dtype=torch.float64)
    G = swap_gain_matrix(C, C, tile=8)          # CPU: the plain version
    assert G.dtype == torch.float32 and G.shape == (5, 5)
    assert tk.KERNELS["swap_gain_matrix"].launches == before
    with pytest.raises(ValueError, match="must be"):
        swap_gain_matrix(torch.zeros((4, 5)), torch.zeros((4, 5)))
    with pytest.raises(ValueError, match="must be"):
        swap_gain_matrix(torch.zeros((4, 4)), torch.zeros((5, 5)))


# ------------------------------------------------------------ Mapper
def _machine(mod, core, name, real=False):
    if name == "tree":
        return mod.TreeTopology(hierarchy=core.Hierarchy(
            (4, 4, 4), (1.0, 10.0, 100.0)))
    if name == "torus":
        return mod.TorusTopology((4, 4, 4), (1.0, 2.0, 1.0))
    if name == "fattree":
        return mod.FatTreeTopology((4, 4, 4), (1.0, 2.0, 5.0))
    if name == "dragonfly":
        return mod.DragonflyTopology(4, 4, 4)
    if real:
        r = np.random.default_rng(11).random((N, N)) * 5.0
        return mod.MatrixTopology(matrix=np.triu(r, 1) + np.triu(r, 1).T)
    torus = mod.TorusTopology((4, 4, 4))
    return mod.MatrixTopology(matrix=torus.distance_matrix() * 3.0)


def _graphs(real=False):
    g = rc.random_geometric(N, 0.25, seed=3)
    if real:
        u, v, _ = g.edge_list()
        w = np.random.default_rng(4).random(len(u)) * 4.0 + 0.5
        g = rc.from_edges(N, u, v, w)
    return g, convert.graph(g.xadj, g.adjncy, g.adjwgt, g.vwgt)


@pytest.mark.parametrize("backend", ["pallas", "numpy"])
@pytest.mark.parametrize("name", TOPOLOGIES + ["matrix-real"])
def test_mapper_gain_matrix_equals_reference(name, backend):
    real = name == "matrix-real"
    topo = name.split("-")[0]
    spec = rc.MappingSpec(backend=backend)
    ref = rc.Mapper(_machine(rt, rc, topo, real), spec)
    port = tc.Mapper(_machine(tt, tc, topo, real),
                     convert.spec(spec.to_dict()), device="cpu")
    g_ref, g_port = _graphs(real)
    perm = np.random.default_rng(7).permutation(N)
    want = ref.gain_matrix(g_ref, perm)
    got = port.gain_matrix(g_port, perm)
    assert got.dtype == want.dtype and got.shape == (N, N)
    bound = _bound(g_ref.to_dense(), ref.topology.matrix(), perm)
    if real and backend == "pallas":
        assert np.max(np.abs(got - want)) <= bound
    else:
        assert np.array_equal(got, want)
    if real:                    # G is symmetric up to the summation order
        assert np.max(np.abs(got - got.T)) <= bound
    else:
        assert np.array_equal(got, got.T)
    # the dense form against the sparse swap gain, sign included
    u, v = 3, 41
    sparse = tc.swap_gain(g_port, port.topology, perm, u, v)
    assert np.isclose(got[u, v], sparse, rtol=1e-5, atol=1e-4)
    # the kernel is bound once per plan, as the reference counts it
    port.gain_matrix(g_port, perm)
    ref.gain_matrix(g_ref, perm)
    assert (port.cache_info()["kernel_compiles"]
            == ref.cache_info()["kernel_compiles"])


# ------------------------------------------------------------ K3 contract
def _rna_tf32(x):
    """cvt.rna.tf32.f32: the TF32 value nearest to float32 x, ties away
    from zero, low 13 bits clear (add half a TF32 ulp to the magnitude,
    then truncate)."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _split(x):
    """K3's split of every operand value: big = rna(x), small =
    rna(x − big), the subtraction in float32."""
    x = np.asarray(x, np.float32)
    big = _rna_tf32(x)
    return big, _rna_tf32(x - big)


def _rz32(x):
    """float64 → the float32 value next to it toward zero (as float64)."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f.astype(np.float64)


STEP = 32       # k-columns a step of K3's K-loop (csrc/swap_gain.cu: kSlab)
PAIR = 2 * STEP  # k-columns between its float32 promotions


def _gain_3xtf32(C, B, fault=None):
    """G as K3 computes it on the card: S = C·Bᵀ + B·Cᵀ as one K-loop over
    the stacked operands [C | B]·[B | C]ᵀ (each half padded to whole
    steps), each product big·big + big·small + small·big; the tensor
    cores' accumulator is modelled as truncating (each k8 wgmma adds its
    exact products to it and rounds toward zero), restarted every pair of
    steps and added into a float32 total; S taken from its upper triangle for
    both halves, d = rowsum(C∘B) in float32, G = ((d_u + d_v) − S) −
    2·(C·B), diagonal 0.  ``fault`` plants one error: "1xtf32" (big·big
    only), "no_corr" (the k == j term 2·C·B dropped), "m_twice" (S = M +
    M instead of M + Mᵀ)."""
    C = np.asarray(C, np.float32)
    B = np.asarray(B, np.float32)
    n = len(C)
    width = -(-n // STEP) * STEP

    def halves(p, q):
        out = np.zeros((n, 2 * width), np.float32)
        out[:, :n], out[:, width:width + n] = p, q
        return out

    X = halves(C, C if fault == "m_twice" else B)
    Y = halves(B, B if fault == "m_twice" else C)
    (xb, xs), (yb, ys) = _split(X), _split(Y)
    xb, xs, yb, ys = (t.astype(np.float64) for t in (xb, xs, yb, ys))
    terms = [(xb, yb)] if fault == "1xtf32" else \
        [(xb, yb), (xb, ys), (xs, yb)]
    S = np.zeros((n, n), np.float32)
    for k0 in range(0, 2 * width, PAIR):
        acc = np.zeros((n, n))
        for k in range(k0, k0 + PAIR, 8):
            for a, b in terms:
                acc = _rz32(a[:, k:k + 8] @ b[:, k:k + 8].T + acc)
        S = S + acc.astype(np.float32)
    S = np.triu(S) + np.triu(S, 1).T
    d = np.sum(C * B, axis=1, dtype=np.float32)
    G = (d[:, None] + d[None, :]) - S
    if fault != "no_corr":
        G = G - np.float32(2.0) * (C * B)
    np.fill_diagonal(G, 0.0)
    return G.astype(np.float32)


def _permuted(D, perm):
    return np.asarray(D, np.float64)[np.ix_(perm, perm)]


def _integer_edge(n, seed):
    """C of integers in [2¹¹, 2¹⁴) — more significant bits than TF32
    holds, so only the split keeps them — on a random cycle (two
    neighbours a process), tree distances {1, 10, 100}, and a
    permutation; every |C|·|B|ᵀ sum stays below 2²⁴."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    C = np.zeros((n, n))
    C[order, np.roll(order, 1)] = rng.integers(2 ** 11, 2 ** 14, n)
    C = C + C.T
    h = tc.Hierarchy((4, 4, n // 16), (1.0, 10.0, 100.0))
    return C, h.distance_matrix(), rng.permutation(n)


def _exact(C, D, perm):
    """The float64 G of the float32-rounded inputs."""
    f = lambda x: np.asarray(x, np.float32).astype(np.float64)  # noqa: E731
    return rc.dense_gain_matrix(f(C), f(D), perm)


INTEGER_EDGE = [(64, 64), (256, 128)]


@pytest.mark.parametrize("n,tile", CASES)
def test_3xtf32_equals_reference_on_integers(n, tile):
    C, D, perm = _instance(n, n, integer=True)
    got = _gain_3xtf32(C, _permuted(D, perm))
    assert np.array_equal(got, _ref(C, D, perm, tile))
    assert np.array_equal(got, rc.dense_gain_matrix(C, D, perm))


@pytest.mark.parametrize("n,tile", INTEGER_EDGE)
def test_3xtf32_exact_on_integer_edge(n, tile):
    C, D, perm = _integer_edge(n, n)
    B = _permuted(D, perm)
    scale = tref.swap_gain_limits(C, B).numpy() / tref.SWAP_GAIN_REL
    assert np.max(scale) < 2.0 ** 24                # the contract holds
    got = _gain_3xtf32(C, B)
    want = _ref(C, D, perm, tile)
    assert np.array_equal(got, want)
    assert np.array_equal(got, rc.dense_gain_matrix(C, D, perm))
    assert np.array_equal(got, got.T)
    # C's low bits matter here: 1xTF32 is not exact
    assert not np.array_equal(_gain_3xtf32(C, B, "1xtf32"), want)


@pytest.mark.parametrize("n,tile", CASES)
def test_3xtf32_within_limits_on_real_data(n, tile):
    C, D, perm = _instance(n, n, integer=False)
    B = _permuted(D, perm)
    got = _gain_3xtf32(C, B).astype(np.float64)
    limit = tref.swap_gain_limits(C, B).numpy()
    assert np.all(np.abs(got - _exact(C, D, perm)) <= limit)
    assert np.max(np.abs(got - _ref(C, D, perm, tile))) <= \
        _bound(C, D, perm)
    # G[u,v] and G[v,u] come from one S entry: bit-symmetric on real data
    assert np.array_equal(got, got.T)


@pytest.mark.parametrize("fault", ["1xtf32", "no_corr", "m_twice"])
@pytest.mark.parametrize("n", [64, 100, 257])
def test_planted_faults_exceed_the_limit(n, fault):
    C, D, perm = _instance(n, n, integer=False)
    B = _permuted(D, perm)
    limit = tref.swap_gain_limits(C, B).numpy()
    err = np.abs(_gain_3xtf32(C, B, fault).astype(np.float64)
                 - _exact(C, D, perm))
    assert np.max(err / limit) > 1.0
