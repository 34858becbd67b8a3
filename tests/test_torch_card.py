"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``gpu``: every test here asks the ``cuda`` fixture for the card
and skips without one (the decision is made inside the fixture, so every
xdist worker collects the same tests).  On the card, run them with

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_card.py

(``--noconftest``: the repository's conftest imports jax, which the
card's machine need not have; this file imports only the port.)

Tolerances: integer weights and distances must match exactly (every
float32 sum of them is exact in any order).  With real weights the
kernel and the plain version add the same float32 terms in different
orders: K1 agrees to rtol 1e-6 of Σ|w·d|, K2 to rtol 1e-6 of each pair's
Σ|w|·(|d_a| + |d_b|), and K3 (the dense gain matrix, four float32 dot
products of length n per entry, on 3xTF32 tensor cores) to
n·2⁻²²·max(|C|·|B|ᵀ) of the plain version and to 2⁻¹⁸·S(u,v) of the
float64 G at every entry (``kernels.ref.swap_gain_limits``); on integer
data, and on C of integers up to 2²² with B in TF32 and every sum below
2²⁴, K3 is exact.  K4 (flash
attention) is held to 2e-5 at float32 (its float32 route,
``csrc/flash_attention.cu``), and at bfloat16 (its sm90 route,
``csrc/flash_attention_sm90.cu``) to a limit per element and a limit on
the mean |difference| from ``kernels.ref.flash_bf16_limits``
(``_assert_flash_close``).
"""

import numpy as np
import pytest
import torch

import repro_torch.core as tc
from repro_torch.core.local_search import communication_pairs
from repro_torch.engine import RefinementEngine
from repro_torch.kernels import (FLASH_F32_KERNEL, FLASH_KERNEL,
                                 OBJECTIVE_KERNEL,
                                 PAIR_GAIN_KERNEL, SWAP_GAIN_KERNEL,
                                 flash_attention_kernel, pair_gains,
                                 pair_gains_plain, qap_objective_edges,
                                 qap_objective_plain)
from repro_torch.kernels.ops import permuted_distances
from repro_torch.kernels.ref import (SWAP_GAIN_REL, flash_attention_plain,
                                     flash_bf16_limits, swap_gain_limits)
from repro_torch.kernels.swap_gain import (swap_gain_matrix,
                                           swap_gain_matrix_plain)
from repro_torch.kernels.config import quantize_table
from repro_torch.topology import MatrixTopology, TorusTopology

pytestmark = pytest.mark.gpu

N = 512
TREE = ((1, 8, 64, 512), (1.0, 10.0, 100.0))
TORUS = ((8, 8, 8), (1.0, 2.0, 3.0))
FORMS = ["tree", "torus", "f32", "f32real", "int8", "int16"]

# The division-free oracle's cases (K1, K2; tests/test_torch_oracle.py
# emulates the same arithmetic on the CPU): a tree of the most levels the
# kernels take (16), strides 3·7·2·… (none a power of two above 2) and
# n_pe = 2,134,623,456, within 0.6 % of 2^31, the top of the range its
# reciprocals are exact for; a tree of odd strides; a torus of odd axes.
TREE16_FACTORS = (3, 7, 2, 7, 3, 7, 2, 7, 3, 7, 2, 7, 3, 7, 2, 2)
TREE16 = (tuple(int(np.prod(TREE16_FACTORS[:i], dtype=np.int64))
                for i in range(17)),
          tuple(float(2 * lvl + 1) for lvl in range(16)))
ORACLE_CASES = {"tree16-top": ("tree", TREE16),
                "tree-odd": ("tree", ((1, 3, 15, 105, 945),
                                      (1.0, 10.0, 100.0, 1000.0))),
                "torus-odd": ("torus", ((7, 9, 11), (1.0, 2.0, 3.0)))}


def oracle_pes(kind, params, n, seed):
    """n PE ids for an oracle case: near the top of the range at every
    scale (so pairs meet at every tree level), the largest PE, and
    uniform ones."""
    n_pe = (params[0][-1] if kind == "tree"
            else int(np.prod(params[0], dtype=np.int64)))
    rng = np.random.default_rng(seed)
    scale = 10 ** rng.integers(0, 10, n)
    pes = n_pe - 1 - rng.integers(0, np.minimum(scale, n_pe))
    pes[::3] = rng.integers(0, n_pe, len(pes[::3]))
    pes[0] = n_pe - 1
    return pes.astype(np.int32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card: python -m pytest "
                    "--noconftest -m gpu tests/test_torch_card.py)")
    return torch.device("cuda")


def _form(name, device):
    if name == "tree":
        return "tree", TREE, torch.zeros((1, 1), device=device), False
    if name == "torus":
        return "torus", TORUS, torch.zeros((1, 1), device=device), False
    d_int = TorusTopology(*TORUS).distance_matrix()
    if name == "f32":
        return ("matrix", (), torch.from_numpy(d_int.astype(np.float32))
                .to(device), False)
    if name == "f32real":
        r = np.random.default_rng(7).random((N, N)) * 5.0
        r = np.triu(r, 1) + np.triu(r, 1).T
        return ("matrix", (), torch.from_numpy(r.astype(np.float32))
                .to(device), True)
    table = d_int if name == "int8" else d_int * 37.0
    packed, _ = quantize_table(table, name)
    return "matrix", (), torch.from_numpy(packed).to(device), False


def _max_distance(kind, D):
    if kind == "tree":
        return max(TREE[1])
    if kind == "torus":
        return sum(w * (d // 2) for d, w in zip(*TORUS))
    return float(D.abs().max())


def _close(got, want, scale, real):
    if real:
        assert torch.all(torch.abs(got - want) <= 1e-6 * scale)
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("name", FORMS)
@pytest.mark.parametrize("e", [11520, 1000])           # 1000: ragged
def test_objective_kernel_equals_plain(cuda, name, e):
    kind, params, D, real_d = _form(name, cuda)
    rng = np.random.default_rng(e)
    u = rng.integers(0, N, e)
    v = (u + rng.integers(1, N, e)) % N
    real = real_d or name == "tree"          # real weights on one form
    w = (rng.random(e) * 3.0 if real else rng.integers(1, 10, e) * 1.0)
    t = lambda a, dt=torch.int32: torch.from_numpy(  # noqa: E731
        np.asarray(a)).to(cuda, dt)
    args = (kind, params, t(u), t(v), t(w, torch.float32),
            t(rng.permutation(N)), D)
    before = OBJECTIVE_KERNEL.launches
    got = qap_objective_edges(*args)
    assert OBJECTIVE_KERNEL.launches == before + 1
    want = qap_objective_plain(*args)
    torch.cuda.synchronize()
    assert got.shape == () and got.dtype == torch.float32
    scale = float(torch.sum(torch.abs(args[4]))) * _max_distance(kind, D)
    _close(got, want, scale, real)
    again = qap_objective_edges(*args)
    assert torch.equal(got, again)              # deterministic


def _graph(real):
    g = tc.random_geometric(N, 0.08, seed=11)
    if real:
        rng = np.random.default_rng(4)
        u, v, _ = g.edge_list()
        g = tc.graph.from_edges(N, u, v, rng.random(len(u)) * 4.0 + 0.5)
    return g


@pytest.mark.parametrize("name", FORMS)
def test_pair_gain_kernel_equals_plain(cuda, name):
    kind, params, D, real_d = _form(name, cuda)
    real = real_d or name == "tree"
    g = _graph(real)
    pairs = np.concatenate([communication_pairs(g, 3),
                            np.array([[5, 5], [0, 0]])])
    dg = tc.DeviceGraph.from_comm(g, device=cuda)
    us, vs = tc.device_pairs(pairs, device=cuda)
    perm = torch.from_numpy(np.random.default_rng(2).permutation(N)
                            .astype(np.int32)).to(cuda)
    before = PAIR_GAIN_KERNEL.launches
    got = pair_gains(kind, params, dg.nbr, dg.wgt, perm, us, vs, D)
    assert PAIR_GAIN_KERNEL.launches == before + 1
    want = pair_gains_plain(kind, params, dg.nbr, dg.wgt, perm, us, vs, D)
    torch.cuda.synchronize()
    bound = _max_distance(kind, D)
    rowsum = dg.wgt.abs().sum(dim=1)
    scale = (rowsum[us.long()] + rowsum[vs.long()]) * 2.0 * bound
    _close(got, want, scale, real)
    assert torch.all(got[len(pairs) - 2:] == 0.0)   # padding pairs


def _oracle_bound(kind, params):
    """The largest distance of a closed form."""
    if kind == "tree":
        return max(params[1])
    return sum(w * (d // 2) for d, w in zip(*params))


@pytest.mark.parametrize("real", [False, True], ids=["integer", "real"])
@pytest.mark.parametrize("case", sorted(ORACLE_CASES))
def test_pair_gain_kernel_division_free_forms(cuda, case, real):
    """K2 on the oracle cases, over ELL rows of K = 6 (grid3d's degree,
    not a multiple of 4: the wrapper pads them to 8)."""
    kind, params = ORACLE_CASES[case]
    g = tc.grid3d(8, 8, 8)
    if real:
        u, v, _ = g.edge_list()
        w = np.random.default_rng(4).random(len(u)) * 4.0 + 0.5
        g = tc.graph.from_edges(N, u, v, w)
    dg = tc.DeviceGraph.from_comm(g, device=cuda, pad_deg_to=1)
    assert dg.max_deg == 6
    pairs = np.concatenate([communication_pairs(g, 3),
                            np.array([[5, 5], [0, 0]])])
    us, vs = tc.device_pairs(pairs, device=cuda)
    perm = torch.from_numpy(oracle_pes(kind, params, N, seed=2)).to(cuda)
    D = torch.zeros((1, 1), device=cuda)
    args = (kind, params, dg.nbr, dg.wgt, perm, us, vs, D)
    before = PAIR_GAIN_KERNEL.launches
    got = pair_gains(*args)
    assert PAIR_GAIN_KERNEL.launches == before + 1
    want = pair_gains_plain(*args)
    torch.cuda.synchronize()
    rowsum = dg.wgt.abs().sum(dim=1)
    scale = ((rowsum[us.long()] + rowsum[vs.long()]) * 2.0
             * _oracle_bound(kind, params))
    _close(got, want, scale, real)
    assert torch.all(got[len(pairs) - 2:] == 0.0)   # padding pairs


@pytest.mark.parametrize("e", [70000, 300000])
@pytest.mark.parametrize("case", sorted(ORACLE_CASES))
def test_objective_kernel_division_free_forms(cuda, case, e):
    """K1 on the oracle cases at E = 70,000 (274 blocks, then the last
    block's sum of their partials) and 300,000 (the grid capped at 1024
    blocks, each thread over several edges): integer weights exactly
    where every partial sum is an integer below 2^24 (the contract's
    condition; the odd tree's distances reach 1000, so its sums pass it
    and are held as real data), real weights to rtol 1e-6 of Σ|w·d|,
    one launch a call, two calls bit-equal."""
    kind, params = ORACLE_CASES[case]
    rng = np.random.default_rng(e)
    t = lambda a, dt=torch.int32: torch.from_numpy(  # noqa: E731
        np.asarray(a)).to(cuda, dt)
    pes = t(oracle_pes(kind, params, N, seed=e))
    eu, ev = t(rng.integers(0, N, e)), t(rng.integers(0, N, e))
    D = torch.zeros((1, 1), device=cuda)
    for w, real in ((rng.integers(1, 3, e) * 1.0, False),
                    (rng.random(e) * 3.0, True)):
        args = (kind, params, eu, ev, t(w, torch.float32), pes, D)
        before = OBJECTIVE_KERNEL.launches
        got = qap_objective_edges(*args)
        again = qap_objective_edges(*args)
        assert OBJECTIVE_KERNEL.launches == before + 2
        want = qap_objective_plain(*args)
        scale = float(qap_objective_plain(kind, params, eu, ev,
                                          args[4].abs(), pes, D))
        _close(got, want, scale, real or scale >= 2 ** 24)
        assert torch.equal(got, again)              # deterministic


@pytest.mark.parametrize("machine", ["tree", "matrix-int8"])
def test_engine_on_card_equals_cpu(cuda, machine):
    torus = TorusTopology((8, 8, 8))
    topo = (tc.Hierarchy((8, 8, 8), (1.0, 10.0, 100.0)) if machine == "tree"
            else MatrixTopology(matrix=torus.distance_matrix()))
    from repro_torch.topology.base import as_topology
    topo = as_topology(topo)
    from repro_torch.kernels.config import derive_kernel_config
    kind = topo.kernel_params()[0]
    cfg = derive_kernel_config(kind, backend="cuda",
                               table=topo.matrix() if kind == "matrix"
                               else None)
    g = tc.grid3d(8, 8, 8)
    pairs = communication_pairs(g, 4)
    perm0 = np.random.default_rng(0).permutation(N)
    runs = {}
    for dev in ("cpu", "cuda"):
        eng = RefinementEngine(topo, max_sweeps=16, kernel_config=cfg,
                               device=dev)
        perm = perm0.copy()
        k1, k2 = OBJECTIVE_KERNEL.launches, PAIR_GAIN_KERNEL.launches
        stats = eng.refine(g, perm, pairs, tabu_tenure=2, telemetry=True)
        runs[dev] = (perm, stats, OBJECTIVE_KERNEL.launches - k1,
                     PAIR_GAIN_KERNEL.launches - k2, eng.last_syncs)
    (pc, sc, k1c, k2c, _), (pg, sg, k1g, k2g, syncs) = runs["cpu"], \
        runs["cuda"]
    assert k1c == 0 and k2c == 0
    assert k1g > 0 and k2g == sg.telemetry.passes
    assert np.array_equal(pc, pg)
    assert sc.objective_trace == sg.objective_trace
    assert sc.swaps == sg.swaps
    assert np.array_equal(sc.telemetry.match_rounds, sg.telemetry.match_rounds)
    assert syncs["reads"] == sg.telemetry.passes + int(
        sg.telemetry.match_rounds.sum())


def test_kernel_wrappers_reject_mixed_devices(cuda):
    kind, params, D, _ = _form("tree", cuda)
    eu = torch.zeros(8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="is on cpu"):
        qap_objective_edges(kind, params, eu, eu, torch.zeros(8, device=cuda),
                            torch.zeros(8, dtype=torch.int32), D)
    with pytest.raises(ValueError, match="must be torch.int32"):
        qap_objective_edges(kind, params, eu.long(), eu, torch.zeros(
            8, device=cuda), eu, D)


def _swap_gain_instance(n, kind):
    """C and B = D[perm][:, perm] for K3 as numpy float32: "int" — C of
    integers 1–9 at density 0.3, D of integers 1–99 (the JAX package's
    instance); "real" — the same with uniform reals; "edge" — C of
    integers in [2¹¹, 2¹⁴) on a random cycle and tree distances {1, 10,
    100} (PEs in fours and sixteens), every |C|·|B|ᵀ sum below 2²⁴."""
    rng = np.random.default_rng(n)
    if kind == "edge":
        order = rng.permutation(n)
        C = np.zeros((n, n))
        C[order, np.roll(order, 1)] = rng.integers(2 ** 11, 2 ** 14, n)
        pe = np.arange(n)
        D = np.where(pe[:, None] // 16 == pe[None, :] // 16, 10.0, 100.0)
        D[pe[:, None] // 4 == pe[None, :] // 4] = 1.0
        np.fill_diagonal(D, 0.0)
        C = C + C.T
    else:
        if kind == "int":
            vc, vd = rng.integers(1, 10, (n, n)), rng.integers(1, 100, (n, n))
        else:
            vc, vd = rng.random((n, n)), rng.random((n, n))
        C = np.triu(vc * (rng.random((n, n)) < 0.3), 1)
        D = np.triu(vd, 1)
        C, D = C + C.T, D + D.T
    perm = rng.permutation(n)
    B = D[np.ix_(perm, perm)]
    return C.astype(np.float32), B.astype(np.float32)


# ragged against the 128-row tiles and against n % 4 (TMA's row stride)
@pytest.mark.parametrize("kind", ["int", "real", "edge"])
@pytest.mark.parametrize("n", [8, 64, 127, 128, 129, 257, 1000])
def test_swap_gain_kernel_equals_plain(cuda, n, kind):
    C, B = _swap_gain_instance(n, kind)
    Ct, Bt = torch.from_numpy(C).to(cuda), torch.from_numpy(B).to(cuda)
    before = SWAP_GAIN_KERNEL.launches
    got = swap_gain_matrix(Ct, Bt)
    assert SWAP_GAIN_KERNEL.launches == before + 1
    want = swap_gain_matrix_plain(Ct, Bt)
    torch.cuda.synchronize()
    assert got.shape == (n, n) and got.dtype == torch.float32
    exact = tc.dense_gain_matrix(C.astype(np.float64), B.astype(np.float64),
                                 np.arange(n))
    g64 = got.cpu().numpy().astype(np.float64)
    if kind == "real":
        tol = n * 2.0 ** -22 * float(torch.max(Ct.abs() @ Bt.abs().T))
        assert float(torch.max(torch.abs(got - want))) <= tol
        limit = swap_gain_limits(C, B).numpy()
        assert np.all(np.abs(g64 - exact) <= limit), \
            float(np.max(np.abs(g64 - exact) / limit))
    else:
        if kind == "edge":      # the contract's condition for exactness
            assert float(swap_gain_limits(C, B).max()) / SWAP_GAIN_REL \
                < 2.0 ** 24
        assert torch.equal(got, want)
        assert np.array_equal(g64, exact)
    assert torch.equal(got, got.T)      # one S entry for G[u,v], G[v,u]
    assert torch.all(torch.diagonal(got) == 0.0)
    assert torch.equal(got, swap_gain_matrix(Ct, Bt))
    # bf16 inputs are cast to float32 first, as the JAX package does
    half = swap_gain_matrix(Ct.to(torch.bfloat16), Bt.to(torch.bfloat16))
    assert half.dtype == torch.float32


def test_swap_gain_rejects_a_misaligned_base(cuda):
    flat = torch.zeros(64 * 64 + 1, device=cuda)
    C = flat[1:].view(64, 64)           # contiguous, 4 bytes off
    assert C.is_contiguous() and C.data_ptr() % 16 == 4
    ok = torch.zeros((64, 64), device=cuda)
    before = SWAP_GAIN_KERNEL.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        swap_gain_matrix(C, ok)
    with pytest.raises(ValueError, match="16-byte aligned"):
        swap_gain_matrix(ok, C)
    assert SWAP_GAIN_KERNEL.launches == before


def test_mapper_gain_matrix_on_card_equals_cpu(cuda):
    h = tc.Hierarchy((8, 8, 8), (1.0, 10.0, 100.0))
    g = tc.grid3d(8, 8, 8)
    perm = np.random.default_rng(1).permutation(N)
    spec = tc.MappingSpec(backend="pallas")
    before = SWAP_GAIN_KERNEL.launches
    got = tc.Mapper(h, spec).gain_matrix(g, perm)
    assert SWAP_GAIN_KERNEL.launches == before + 1
    want = tc.Mapper(h, spec, device="cpu").gain_matrix(g, perm)
    assert np.array_equal(got, want)
    assert np.array_equal(got.astype(np.float64), tc.dense_gain_matrix(
        g.to_dense(), h.distance_matrix(), perm))


def test_mapper_gain_matrix_calls_return_arrays_they_own(cuda):
    h = tc.Hierarchy((8, 8, 8), (1.0, 10.0, 100.0))
    g = tc.grid3d(8, 8, 8)
    rng = np.random.default_rng(2)
    p1, p2 = rng.permutation(N), rng.permutation(N)
    mapper = tc.Mapper(h, tc.MappingSpec(backend="pallas"))
    first = mapper.gain_matrix(g, p1)
    kept = first.copy()
    second = mapper.gain_matrix(g, p2)
    assert not np.shares_memory(first, second)
    assert np.array_equal(first, kept)  # the second call left it alone
    cpu = tc.Mapper(h, tc.MappingSpec(backend="pallas"), device="cpu")
    assert np.array_equal(first, cpu.gain_matrix(g, p1))
    assert np.array_equal(second, cpu.gain_matrix(g, p2))
    assert first.dtype == np.float32 and first.flags.writeable
    first[:] = -1.0                     # the caller's to write
    assert np.array_equal(second, cpu.gain_matrix(g, p2))


def _pinned_bytes():
    """Bytes of page-locked blocks PyTorch's caching host allocator owns
    (in use and cached)."""
    return torch.cuda.host_memory_stats()["allocated_bytes.current"]


def test_mapper_gain_matrix_pins_no_more_than_the_caller_holds(cuda):
    """Calls at two sizes (n = 512: 1 MiB; n = 1000: 4 MiB for 3.8 MiB),
    some results held and the rest dropped: right after every call the
    process pins no more than the power-of-two blocks of the arrays the
    caller still holds."""
    import gc

    from repro_torch.core.plan import empty_host_cache
    sizes = [(tc.Mapper(tc.Hierarchy(s, (1.0, 10.0, 100.0)),
                        tc.MappingSpec(backend="pallas")), tc.grid3d(*s))
             for s in ((8, 8, 8), (10, 10, 10))]
    rng = np.random.default_rng(3)
    gc.collect()
    empty_host_cache()
    base = _pinned_bytes()

    def block(a):
        return 1 << (a.nbytes - 1).bit_length()

    held = []
    for step in range(9):
        mapper, g = sizes[step % 2]
        G = mapper.gain_matrix(g, rng.permutation(g.n))
        live = held + [G]
        if step % 3 == 0:
            held.append(G)
        assert _pinned_bytes() - base <= sum(map(block, live)), step
        del G, live
    held.clear()
    mapper, g = sizes[1]
    G = mapper.gain_matrix(g, rng.permutation(g.n))
    assert _pinned_bytes() - base <= block(G)


def test_gain_call_leaves_other_pinned_blocks_cached(cuda):
    """A page-locked block that other code cached in PyTorch's caching
    host allocator is still cached after gain calls at two sizes, with
    results held and dropped; the port's own blocks (``core/pinned.py``)
    stay within the arrays the caller holds, plus at most one free block
    of each size served."""
    import gc

    from repro_torch.core import pinned
    from repro_torch.core.plan import empty_host_cache
    sizes = [(tc.Mapper(tc.Hierarchy(s, (1.0, 10.0, 100.0)),
                        tc.MappingSpec(backend="pallas")), tc.grid3d(*s))
             for s in ((8, 8, 8), (10, 10, 10))]
    rng = np.random.default_rng(5)
    gc.collect()
    empty_host_cache()
    other = torch.empty(1 << 20, dtype=torch.uint8, pin_memory=True)
    del other                           # cached by PyTorch, not in use
    ours = pinned.stats()
    theirs = torch.cuda.host_memory_stats()
    assert theirs["allocated_bytes.current"] >= 1 << 20
    held, served = [], set()
    for step in range(9):
        mapper, g = sizes[step % 2]
        G = mapper.gain_matrix(g, rng.permutation(g.n))
        served.add(G.nbytes)
        live = held + [G]
        if step % 3 == 0:
            held.append(G)
        now = torch.cuda.host_memory_stats()
        for key in ("allocated_bytes.current", "num_host_free",
                    "num_host_alloc"):
            assert now[key] == theirs[key], (step, key)
        st = pinned.stats()
        in_use = st["in_use_bytes"] - ours["in_use_bytes"]
        assert in_use == sum(a.nbytes for a in live), step
        assert st["free_blocks"] <= len(served) + ours["free_blocks"]
        assert (st["pinned_bytes"] - ours["pinned_bytes"]
                <= sum(a.nbytes for a in live) + sum(served)), step
        del G, live
    allocs = pinned.stats()["host_allocs"]
    held.clear()
    mapper, g = sizes[0]
    G = mapper.gain_matrix(g, rng.permutation(g.n))  # reuses a free block
    assert pinned.stats()["host_allocs"] == allocs
    assert torch.cuda.host_memory_stats()["num_host_free"] == \
        theirs["num_host_free"]


def test_swap_gain_wrapper_rejects_mixed_devices(cuda):
    C = torch.zeros((8, 8), device=cuda)
    with pytest.raises(ValueError, match="is on cpu"):
        swap_gain_matrix(C, torch.zeros((8, 8)))
    with pytest.raises(ValueError, match="contiguous"):
        swap_gain_matrix(C.T, C)


# ------------------------------------------------------------------ K4
# (H, KV, hd): G = H / KV of 1, 3, 4 and 9 over the kernels' four head dims
FLASH_HEADS = [(4, 4, 64), (6, 2, 96), (8, 2, 128), (9, 1, 32)]
# K4's route for each dtype, and the other one
FLASH_ROUTES = {torch.bfloat16: (FLASH_KERNEL, FLASH_F32_KERNEL),
                torch.float32: (FLASH_F32_KERNEL, FLASH_KERNEL)}


def _flash_launches():
    return FLASH_KERNEL.launches, FLASH_F32_KERNEL.launches


def _assert_flash_close(got, q, k, v, window):
    """float32: max |Δ| ≤ 2e-5 (the same float32 terms in other orders).
    bfloat16: every |Δ| within its element's limit, 2⁻⁷·|plain| +
    2⁻⁵·spread, and the mean |Δ| within the mean limit (the limits and
    their derivation: ``flash_bf16_limits``)."""
    want, wide = flash_attention_plain(q, k, v, window=window, spread=True)
    diff = (got.float() - want.float()).abs()
    if q.dtype == torch.float32:
        assert float(diff.max()) <= 2e-5, float(diff.max())
        return
    elem, mean = flash_bf16_limits(want, wide, one_tile=q.shape[1] <= 64)
    assert bool((diff <= elem).all()), float((diff / elem).max())
    assert float(diff.mean()) <= mean, (float(diff.mean()), mean)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("window", [0, 48, 4096])
@pytest.mark.parametrize("h,kv,hd", FLASH_HEADS)
def test_flash_kernel_equals_plain(cuda, h, kv, hd, window, dtype):
    # T ragged against the 64-row tiles; longer than the 4096 window
    b, t = (1, 4500) if window == 4096 else (2, 333)
    gen = torch.Generator(device=cuda).manual_seed(h * 1000 + window)
    q, k, v = (torch.randn((b, t, n, hd), generator=gen, device=cuda)
               .to(dtype) for n in (h, kv, kv))
    route, other = FLASH_ROUTES[dtype]
    before, before_other = route.launches, other.launches
    got = flash_attention_kernel(q, k, v, window=window)
    assert route.launches == before + 1
    assert other.launches == before_other
    assert got.shape == q.shape and got.dtype == dtype
    assert bool(torch.isfinite(got).all())
    _assert_flash_close(got, q, k, v, window)
    assert torch.equal(got, flash_attention_kernel(q, k, v, window=window))


@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("h,kv,hd", FLASH_HEADS)
def test_flash_kernel_rounds_p_as_plain_in_one_tile(cuda, h, kv, hd, window):
    """T = 64: one kv tile per query row, so K4's running max is the row
    max and K4 rounds the same p to bfloat16 as the plain version; the
    mean limit is then 2⁻¹³·mean(spread); p left unrounded differs by
    2⁻¹⁰·mean(spread) there (tests/test_torch_flash.py)."""
    gen = torch.Generator(device=cuda).manual_seed(h * 100 + window)
    q, k, v = (torch.randn((3, 64, n, hd), generator=gen, device=cuda)
               .to(torch.bfloat16) for n in (h, kv, kv))
    _assert_flash_close(flash_attention_kernel(q, k, v, window=window),
                        q, k, v, window)


@pytest.mark.parametrize("t,window", [(1, 0), (127, 0), (128, 0),
                                      (129, 0), (4500, 4096)])
@pytest.mark.parametrize("h,kv,hd", FLASH_HEADS)
def test_flash_sm90_ragged_against_its_tiles(cuda, h, kv, hd, t, window):
    """bfloat16 at T ragged against the sm90 kernel's 128-row q and kv
    tiles (and T = 1), through that kernel alone."""
    gen = torch.Generator(device=cuda).manual_seed(h * 10 + t)
    q, k, v = (torch.randn((1, t, n, hd), generator=gen, device=cuda)
               .to(torch.bfloat16) for n in (h, kv, kv))
    before = _flash_launches()
    got = flash_attention_kernel(q, k, v, window=window)
    assert _flash_launches() == (before[0] + 1, before[1])
    assert bool(torch.isfinite(got).all())
    _assert_flash_close(got, q, k, v, window)
    assert torch.equal(got, flash_attention_kernel(q, k, v, window=window))


def test_flash_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.zeros((1, 64, 4, 48), device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_kernel(q, q[:, :, :2], q[:, :, :2].clone())
    q = torch.zeros((1, 64, 4, 64), device=cuda)
    k = torch.zeros((1, 64, 2, 64), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_kernel(q.transpose(1, 2).contiguous()
                               .transpose(1, 2), k, k)
    with pytest.raises(ValueError, match="is on cpu"):
        flash_attention_kernel(q, k.cpu(), k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_on_card_equals_cpu(cuda, dtype):
    """The smoke granite prefill through K4 on the card against the plain
    version on the CPU, same weights.  float32 within 1e-4 (TF32 is off);
    bfloat16 within max 0.1 and mean 0.02, the tolerance the CPU tests
    hold the port to against the JAX package (tests/test_torch_lm.py)."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import make_prompts
    from repro_torch.models.transformer import (init_params,
                                                prefill_with_cache)
    cfg = dataclasses.replace(get_smoke_config("granite-3-8b"), dtype=dtype)
    params = init_params(0, cfg, device="cpu")
    toks = make_prompts(cfg, 2, 96, 0, "cpu")
    want, caches_cpu = prefill_with_cache(params, toks, cfg, 100)
    route, other = FLASH_ROUTES[cfg.torch_dtype]
    before, before_other = route.launches, other.launches
    got, caches = prefill_with_cache(params.to(cuda), toks.to(cuda), cfg,
                                     100)
    assert route.launches == before + cfg.n_layers
    assert other.launches == before_other
    diff = (got.cpu().float() - want.float())[..., :cfg.vocab_size].abs()
    if dtype == "float32":
        assert float(diff.max()) <= 1e-4
    else:
        assert float(diff.max()) <= 0.1 and float(diff.mean()) <= 0.02
    assert len(caches) == len(caches_cpu) == cfg.n_layers


def test_serve_on_card_makes_no_decode_sync(cuda):
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import serve
    before = _flash_launches()
    out = serve("granite-3-8b", batch=2, prompt_len=100, gen=8, smoke=True)
    cfg = get_smoke_config("granite-3-8b")               # bfloat16
    # one prefill, through the sm90 route
    assert _flash_launches() == (before[0] + cfg.n_layers, before[1])
    assert out["decode_syncs"] == 0
    assert out["tokens"].shape == (2, 8) and out["tokens"].is_cuda


# ------------------------------------------------------------- lane axis
def _lane_graphs(real):
    """Four graphs on N vertices with different E and ELL widths: K = 6
    (grid3d, the wrapper pads it to 8), and random geometric graphs of
    other degrees."""
    out = [tc.grid3d(8, 8, 8), tc.random_geometric(N, 0.05, seed=1),
           tc.random_geometric(N, 0.08, seed=2),
           tc.random_geometric(N, 0.03, seed=3)]
    if real:
        rng = np.random.default_rng(9)
        out = [tc.graph.from_edges(N, *g.edge_list()[:2],
                                   rng.random(g.num_edges) * 4.0 + 0.5)
               for g in out]
    return out


@pytest.mark.parametrize("real", [False, True], ids=["integer", "real"])
@pytest.mark.parametrize("b", [1, 3, 4])
@pytest.mark.parametrize("name", ["tree", "torus", "f32real", "int8"])
def test_lane_axis_kernels_equal_single_launches(cuda, name, b, real):
    """K1 and K2 with B lanes of different E, K and P, padded to the
    batch's maxima (inert padding), in one launch each: every lane
    bit-equal to a single launch on that lane's own, unpadded arrays."""
    kind, params, D, _ = _form(name, cuda)
    graphs = _lane_graphs(real)[:b]
    dgs = [tc.DeviceGraph.from_comm(g, device=cuda, pad_deg_to=1)
           for g in graphs]
    pairs = [communication_pairs(g, 3) for g in graphs]
    k = max(dg.max_deg for dg in dgs)
    e = max(dg.eu.shape[0] for dg in dgs)
    p = -(-max(len(x) for x in pairs) // 128) * 128
    padded = [dg.pad_to(k, e) for dg in dgs]
    dev_pairs = [tc.device_pairs(x, device=cuda) for x in pairs]
    lane_pairs = [tc.device_pairs(x, pad_to=p, device=cuda) for x in pairs]
    rng = np.random.default_rng(b)
    perms = [torch.from_numpy(rng.permutation(N).astype(np.int32)).to(cuda)
             for _ in graphs]
    stack = lambda xs: torch.stack(xs)  # noqa: E731
    k1, k2 = OBJECTIVE_KERNEL.launches, PAIR_GAIN_KERNEL.launches
    gains = pair_gains(kind, params, stack([d.nbr for d in padded]),
                       stack([d.wgt for d in padded]), stack(perms),
                       stack([u for u, _ in lane_pairs]),
                       stack([v for _, v in lane_pairs]), D)
    objs = qap_objective_edges(kind, params, stack([d.eu for d in padded]),
                               stack([d.ev for d in padded]),
                               stack([d.ew for d in padded]), stack(perms),
                               D)
    assert PAIR_GAIN_KERNEL.launches == k2 + 1
    assert OBJECTIVE_KERNEL.launches == k1 + 1
    assert gains.shape == (b, p) and objs.shape == (b,)
    for i, (dg, (us, vs), perm) in enumerate(zip(dgs, dev_pairs, perms)):
        one = pair_gains(kind, params, dg.nbr, dg.wgt, perm, us, vs, D)
        assert torch.equal(gains[i, :len(one)], one)
        assert torch.all(gains[i, len(one):] == 0.0)
        assert torch.equal(objs[i], qap_objective_edges(
            kind, params, dg.eu, dg.ev, dg.ew, perm, D))


@pytest.mark.parametrize("multilevel", [True, False])
def test_multilevel_and_map_many_on_card_equal_cpu(cuda, multilevel):
    """A multilevel map and a map_many (structurally different graphs) at
    n = 256 on the card equal the CPU port's, exactly (integer data)."""
    from repro_torch.core import MultilevelSpec
    machine = tc.Hierarchy((4, 8, 8), (1.0, 10.0, 100.0))
    spec = tc.MappingSpec(engine="device", backend="pallas",
                          neighborhood_dist=4,
                          multilevel=MultilevelSpec(levels=3,
                                                    coarsen_min=16)
                          if multilevel else None)
    rng = np.random.default_rng(5)
    stencil = tc.grid3d(8, 8, 4)
    u, v, _ = stencil.edge_list()
    graphs = [tc.graph.from_edges(256, u, v, rng.integers(1, 101, len(u))
                                  * 1.0) for _ in range(2)]
    graphs.append(tc.random_geometric(256, 0.09, seed=4))
    runs = {}
    for dev in ("cpu", "cuda"):
        mapper = tc.Mapper(machine, spec, device=dev)
        single = mapper.map(graphs[0])
        many = mapper.map_many(graphs)
        runs[dev] = (single, many)
    (s_cpu, m_cpu), (s_gpu, m_gpu) = runs["cpu"], runs["cuda"]
    for a, b in [(s_cpu, s_gpu)] + list(zip(m_cpu, m_gpu)):
        assert np.array_equal(a.perm, b.perm)
        assert a.final_objective == b.final_objective
        assert a.search_stats.objective_trace == b.search_stats.objective_trace
    assert np.array_equal(m_gpu[0].perm, s_gpu.perm)


def test_multilevel_map_makes_no_uncounted_sync(cuda):
    """Every host sync of a multilevel card map's contractions and
    per-level refinements is a counted read: PyTorch's sync debug mode
    (on inside each counted scope) observes no other."""
    from repro_torch.core import MultilevelSpec
    machine = tc.Hierarchy((4, 8, 8), (1.0, 10.0, 100.0))
    spec = tc.MappingSpec(engine="device", backend="pallas",
                          neighborhood_dist=4,
                          multilevel=MultilevelSpec(levels=3,
                                                    coarsen_min=16))
    g = tc.grid3d(8, 8, 4)
    mapper = tc.Mapper(machine, spec, device="cuda")
    plan = mapper.lower_for(g)
    res = plan.execute(g)
    assert sorted(res.perm.tolist()) == list(range(256))
    pyramid = plan._pyramid(g, spec.seed)
    assert len(pyramid) == len(plan.engines) == 3
    for level in pyramid[1:]:
        assert level.syncs["reads"] > 0
        assert level.syncs["observed"] == level.syncs["reads"]
    for eng in plan.engines:
        assert eng.last_syncs["reads"] > 0
        assert eng.last_syncs["observed"] == eng.last_syncs["reads"]
