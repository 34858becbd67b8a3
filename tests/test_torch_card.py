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

import contextlib

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


@pytest.fixture(scope="module", autouse=True)
def _cpu_references():
    """What the CPU references of this file need: full float32 products
    (the card's TF32 flags stated, not left to defaults) and the CPU's
    vector math run once first (``warm_cpu_math``: a process's first
    multi-threaded ``torch.cos`` may come back ~1.5e-4 off, which put
    the smoke prefill's CPU logits 6.2e-4 from the card's)."""
    from repro_torch.testing import warm_cpu_math
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    warm_cpu_math()
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


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
    # T ragged against both routes' tiles; longer than the 4096 window
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


@pytest.mark.parametrize("t,window", [(31, 0), (32, 0), (33, 0), (63, 0),
                                      (65, 0), (127, 0), (128, 0), (129, 0),
                                      (200, 33)])
@pytest.mark.parametrize("h,kv,hd", FLASH_HEADS)
def test_flash_f32_ragged_against_its_tiles(cuda, h, kv, hd, t, window):
    """float32 at T on both sides of the float32 route's 32-key kv tiles,
    64-row warpgroups and 128-row q tiles, through that kernel alone."""
    gen = torch.Generator(device=cuda).manual_seed(h * 10 + t)
    q, k, v = (torch.randn((2, t, n, hd), generator=gen, device=cuda)
               for n in (h, kv, kv))
    before = _flash_launches()
    got = flash_attention_kernel(q, k, v, window=window)
    assert _flash_launches() == (before[0], before[1] + 1)
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


def test_flash_f32_repeats_at_the_smoke_prefill_shape(cuda):
    """K4's float32 route at the shape the granite smoke prefill gives it
    (q (2, 96, 4, 32), k and v (2, 96, 2, 32): 3 kv tiles through the
    2-stage ring, so the ring's refill runs), 256 launches in one
    process on fresh randn inputs, each within 2e-5 of the plain
    version (tools/flash_f32_repeat.py does the same across fresh
    processes)."""
    gen = torch.Generator(device=cuda).manual_seed(96)
    before = FLASH_F32_KERNEL.launches
    worst = []
    for _ in range(256):
        q, k, v = (torch.randn((2, 96, n, 32), generator=gen, device=cuda)
                   for n in (4, 2, 2))
        got = flash_attention_kernel(q, k, v)
        worst.append((got - flash_attention_plain(q, k, v)).abs().amax())
    assert FLASH_F32_KERNEL.launches == before + 256
    worst = torch.stack(worst)
    assert float(worst.max()) <= 2e-5, \
        (int((worst > 2e-5).sum()), float(worst.max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_on_card_equals_cpu(cuda, dtype):
    """The smoke granite prefill through K4 on the card against the plain
    version on the CPU, same weights.  float32 within 1e-4 (TF32 is off,
    and the CPU's vector math was run once first: ``_cpu_references``);
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


# ------------------------------------------ the MoE, Mamba and RWKV kinds
# smoke configs at float32; jamba at 2 periods and the production
# capacity factor, its prompts ending in a run of one token so that the
# MoE drops tokens (chip_smoke.LM_PARITY's cases at smoke width)
KIND_CASES = {"jamba": ("jamba-v0.1-52b",
                        {"n_layers": 16, "capacity_factor": 1.25}),
              "mixtral": ("mixtral-8x7b", {}), "rwkv": ("rwkv6-3b", {})}


@pytest.mark.parametrize("case", sorted(KIND_CASES))
def test_layer_kinds_on_card_equal_cpu(cuda, case):
    """One prefill and 2 decode steps of each new layer kind at float32
    on the card against the CPU from the same weights, both fed the
    CPU's tokens: logits and every cache within 1e-4 (TF32 off), every
    MoE plan (expert, token, slot, kept) equal, and 0 host syncs inside
    each decode step (its token uploaded before the counted scope)."""
    import copy
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import make_prompts
    from repro_torch.models.transformer import (decode_step, init_params,
                                                prefill_with_cache)
    from repro_torch.runtime.boundary import host_boundary
    from repro_torch.testing import moe_routes
    arch, over = KIND_CASES[case]
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                              **over)
    cpu = init_params(0, cfg, device="cpu")
    card = copy.deepcopy(cpu).to(cuda)
    toks = make_prompts(cfg, 2, 96, 0, "cpu")
    toks[:, -32:] = toks[:, :1]
    t = toks.shape[1]

    def close(got, want):
        assert float((got.cpu().float() - want.float()).abs().max()) <= 1e-4

    def close_caches(got, want):
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for kind in g:
                for name in g[kind]:
                    close(g[kind][name], w[kind][name])

    with torch.inference_mode(), moe_routes() as plans_cpu:
        want, want_c = prefill_with_cache(cpu, toks, cfg, t + 2)
    with torch.inference_mode(), moe_routes() as plans_card:
        got, got_c = prefill_with_cache(card, toks.to(cuda), cfg, t + 2)
    close(got, want)
    close_caches(got_c, want_c)
    for i in range(2):
        tok = torch.argmax(want[:, -1:], dim=-1).to(torch.int32)
        tok_card = tok.to(cuda)
        with torch.inference_mode():
            with moe_routes() as plans:
                want, want_c = decode_step(cpu, tok, want_c, t + i, cfg)
            plans_cpu += plans
            with host_boundary("test.decode", cuda) as hb, \
                    moe_routes() as plans:
                got, got_c = decode_step(card, tok_card, got_c, t + i, cfg)
            plans_card += plans
        assert hb.syncs == 0
        close(got, want)
        close_caches(got_c, want_c)
    assert len(plans_card) == len(plans_cpu)
    for g, w in zip(plans_card, plans_cpu):
        for i in (0, 1, 3, 4):                   # expert, token, slot, kept
            assert torch.equal(g[i].cpu(), w[i])
    if cfg.moe_experts and cfg.capacity_factor < cfg.moe_experts:
        assert sum(int((~w[4]).sum()) for w in plans_cpu) > 0


def test_serve_layer_kinds_on_card_make_no_decode_sync(cuda):
    """``serve`` of the jamba and rwkv smoke configs (bf16) on the card:
    K4 launched once per attention layer of the prefill, 0 host syncs in
    the decode loop."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import serve
    for arch in ("jamba-v0.1-52b", "rwkv6-3b"):
        cfg = get_smoke_config(arch)
        n_attn = sum(cfg.layer_kind(i)[0] == "attn"
                     for i in range(cfg.n_layers))
        before = _flash_launches()
        out = serve(arch, batch=2, prompt_len=100, gen=6, smoke=True)
        assert _flash_launches() == (before[0] + n_attn, before[1])
        assert out["decode_syncs"] == 0
        assert out["tokens"].shape == (2, 6) and out["tokens"].is_cuda


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


# ------------------------------------------------- shared graph, portfolio
@pytest.mark.parametrize("real", [False, True], ids=["integer", "real"])
@pytest.mark.parametrize("graph", [0, 1], ids=["stencil", "geometric"])
@pytest.mark.parametrize("name", ["tree", "torus", "f32real", "int8"])
def test_shared_graph_kernels_equal_stacked_and_singles(cuda, name, graph,
                                                        real):
    """K1 and K2 over one graph shared by 4 lanes (the portfolio's
    restart lanes), one launch each: every lane bit-equal to the same
    graph stacked once a lane and to a single launch on that lane's
    permutation, on real weights too."""
    kind, params, D, _ = _form(name, cuda)
    g = _lane_graphs(real)[graph]
    dg = tc.DeviceGraph.from_comm(g, device=cuda)
    us, vs = tc.device_pairs(communication_pairs(g, 3), device=cuda)
    b = 4
    rng = np.random.default_rng(11)
    perms = torch.from_numpy(np.stack([rng.permutation(N) for _ in range(b)])
                             .astype(np.int32)).to(cuda)

    def lanes(x):
        return x[None].expand(b, *x.shape).contiguous()

    k1, k2 = OBJECTIVE_KERNEL.launches, PAIR_GAIN_KERNEL.launches
    gains = pair_gains(kind, params, dg.nbr, dg.wgt, perms, us, vs, D)
    objs = qap_objective_edges(kind, params, dg.eu, dg.ev, dg.ew, perms, D)
    assert PAIR_GAIN_KERNEL.launches == k2 + 1
    assert OBJECTIVE_KERNEL.launches == k1 + 1
    assert gains.shape == (b, us.shape[0]) and objs.shape == (b,)
    assert torch.equal(gains, pair_gains(kind, params, lanes(dg.nbr),
                                         lanes(dg.wgt), perms, lanes(us),
                                         lanes(vs), D))
    assert torch.equal(objs, qap_objective_edges(
        kind, params, lanes(dg.eu), lanes(dg.ev), lanes(dg.ew), perms, D))
    for i in range(b):
        assert torch.equal(gains[i], pair_gains(kind, params, dg.nbr,
                                                dg.wgt, perms[i], us, vs, D))
        assert torch.equal(objs[i], qap_objective_edges(
            kind, params, dg.eu, dg.ev, dg.ew, perms[i], D))


def _portfolio_spec(multilevel):
    from repro_torch.core import MultilevelSpec
    from repro_torch.core.spec import PortfolioSpec
    return tc.MappingSpec(
        construction="random", neighborhood_dist=2,
        preconfiguration="fast", engine="device", backend="pallas", seed=1,
        multilevel=MultilevelSpec(levels=2, coarsen_min=8)
        if multilevel else None,
        portfolio=PortfolioSpec(lanes=4, rounds=4, tabu_tenure=4,
                                kick_strength=0.2, stagnation=2))


@pytest.mark.parametrize("multilevel", [False, True])
def test_portfolio_map_on_card_equals_cpu(cuda, multilevel):
    """A portfolio map at n = 64 on the card equals the CPU port's
    exactly (integer data; the kick draws come from numpy on the host,
    so both draw the same), and every sync of the card's round loop,
    lane refinements and upload is a counted read."""
    machine = tc.Hierarchy((4, 4, 4), (1.0, 10.0, 100.0))
    g = tc.random_geometric(64, 0.25, seed=3)
    runs = {}
    for dev in ("cpu", "cuda"):
        plan = tc.Mapper(machine, _portfolio_spec(multilevel),
                         device=dev).lower_for(g)
        k1, k2 = OBJECTIVE_KERNEL.launches, PAIR_GAIN_KERNEL.launches
        res = plan.execute(g)
        runs[dev] = (res, plan, OBJECTIVE_KERNEL.launches - k1,
                     PAIR_GAIN_KERNEL.launches - k2)
    (a, _, k1c, k2c), (b, plan, k1g, k2g) = runs["cpu"], runs["cuda"]
    assert k1c == k2c == 0 and k1g > 0 and k2g > 0
    assert np.array_equal(a.perm, b.perm)
    assert a.initial_objective == b.initial_objective
    assert a.final_objective == b.final_objective
    assert a.search_stats.objective_trace == b.search_stats.objective_trace
    assert a.search_stats.swaps == b.search_stats.swaps
    assert a.search_stats.evaluated == b.search_stats.evaluated
    runner = plan.portfolio
    assert len(runner.last_rounds) > 0
    assert runner.last_syncs["upload"] == 0
    assert runner.last_syncs["reads"] > 0
    assert runner.last_syncs["observed"] == runner.last_syncs["reads"]
    for eng in plan.engines:
        assert eng.last_syncs["observed"] == eng.last_syncs["reads"]


def test_remap_monitor_on_card_equals_cpu(cuda):
    """The closed loop at n = 64 (torus 8×8, ``grid3d(4, 4, 4)``, integer
    weights) on the card equals the same loop on the CPU tick for tick:
    quiet windows, a ×8 shift of a seeded quarter of the vertices, and a
    REBALANCE through the gate.  ``backend="pallas"``: the drift score
    and the replay price with K1, every warm remap runs K1 and K2, and
    every sync of a warm remap is a counted read."""
    import dataclasses

    from repro_torch.monitor import MonitorConfig, RemapMonitor
    from repro_torch.runtime.fault_tolerance import Action
    from repro_torch.topology import make_topology
    g = tc.grid3d(4, 4, 4)
    u, v, w = g.edge_list()
    hot = np.zeros(g.n, bool)
    hot[np.random.default_rng(0).permutation(g.n)[:16]] = True
    shifted = tc.from_edges(g.n, u, v, np.where(hot[u] | hot[v], w * 8, w))
    windows = [g, g, shifted, shifted, shifted, shifted]
    spec = tc.MappingSpec(construction="hierarchytopdown",
                          neighborhood="communication", neighborhood_dist=10,
                          engine="device", backend="pallas", seed=0)
    runs = {}
    for dev in ("cpu", "cuda"):
        plan = tc.Mapper(make_topology("torus", dims=[8, 8]), spec,
                         device=dev).lower_for(g, schedule="pow2")
        mon = RemapMonitor(plan, g, config=MonitorConfig(
            drift_patience=2, min_weight=0.01), seed=0)
        rows, launches = [], []
        for t, win in enumerate(windows):
            if t == 5:
                mon.handle_action(Action.REBALANCE, [1], pes_per_host=16)
            k1, k2 = OBJECTIVE_KERNEL.launches, PAIR_GAIN_KERNEL.launches
            mon.observe_graph(win)
            r = mon.tick()
            launches.append((OBJECTIVE_KERNEL.launches - k1,
                             PAIR_GAIN_KERNEL.launches - k2))
            row = dataclasses.asdict(r)
            del row["remap_seconds"]
            rows.append(row)
            if r.triggered and dev == "cuda":
                syncs = plan.engines[0].last_syncs
                assert syncs["observed"] == syncs["reads"]
        runs[dev] = (rows, mon.incumbent.copy(), mon.remaps, launches)
    (rc_, ic, nc, lc), (rg, ig, ng, lg) = runs["cpu"], runs["cuda"]
    assert rg == rc_
    assert np.array_equal(ig, ic)
    assert ng == nc >= 1
    assert all(k == (0, 0) for k in lc)
    for row, (k1, k2) in zip(rg, lg):
        assert k1 > 0                       # the drift score is K1's
        assert (k2 > 0) == (row["triggered"] and row["skipped"] is None)


def test_service_batch_on_card_equals_singles(cuda):
    """Three same-bucket stencils (seeded integer weights) in one tick of
    ``MappingService`` on the card take the batch branch — 3 requests
    padded to ``max_batch`` = 4 lanes in the ``pow2`` bucket, K2 launched
    with 4 lanes — and each result equals the same Mapper's single
    ``map`` (tight bucket) on the card and the CPU port's, exactly."""
    from repro_torch.launch.serve import MappingService
    from repro_torch.testing import pair_gain_lanes
    machine = tc.Hierarchy((4, 4, 4), (1.0, 10.0, 100.0))
    spec = tc.MappingSpec(construction="random",
                          neighborhood="communication", neighborhood_dist=2,
                          preconfiguration="fast", engine="device",
                          backend="pallas", seed=0)
    rng = np.random.default_rng(9)
    u, v, _ = tc.grid3d(4, 4, 4).edge_list()
    graphs = [tc.from_edges(64, u, v, rng.integers(1, 10, len(u)) * 1.0)
              for _ in range(3)]
    mapper = tc.Mapper(machine, spec, device=cuda)
    with pair_gain_lanes() as lanes, \
            MappingService(mapper, max_batch=4, max_wait_s=1.0) as svc:
        tickets = [svc.submit(g) for g in graphs]
        got = dict(svc.results.get(timeout=300) for _ in tickets)
        stats = svc.stats()
    assert (stats["batches"], stats["batched_requests"],
            stats["errors"]) == (1, 3, 0)
    assert lanes and set(lanes) == {4}
    cpu = tc.Mapper(machine, spec, device="cpu")
    for t, g in zip(tickets, graphs):
        one, ref = mapper.map(g), cpu.map(g)
        for want in (one, ref):
            assert np.array_equal(got[t].perm, want.perm)
            assert got[t].final_objective == want.final_objective
            assert got[t].initial_objective == want.initial_objective


def test_two_services_count_their_own_syncs(cuda):
    """Two device-engine ``MappingService`` s serving at once, each from
    its own worker thread: every sweep loop's observed syncs equal its
    counted reads (each thread's syncs are charged to its own scope), the
    two services' loops overlap in time, and the sync debug mode is back
    at 0 afterwards."""
    import threading
    import time

    from repro_torch.engine.sweep import RefinementEngine
    from repro_torch.launch.serve import MappingService
    machine = tc.Hierarchy((4, 8, 8), (1.0, 10.0, 100.0))
    spec = tc.MappingSpec(construction="random",
                          neighborhood="communication", neighborhood_dist=2,
                          preconfiguration="fast", engine="device",
                          backend="pallas", seed=0)
    rng = np.random.default_rng(5)
    u, v, _ = tc.grid3d(8, 8, 4).edge_list()
    loops, lock = [], threading.Lock()
    orig = RefinementEngine._sweep

    def sweep(eng, *a, **kw):
        t0 = time.perf_counter()
        out = orig(eng, *a, **kw)
        with lock:
            loops.append((threading.get_ident(), t0,
                          time.perf_counter(), dict(eng.last_syncs)))
        return out

    RefinementEngine._sweep = sweep
    try:
        services = [MappingService(tc.Mapper(machine, spec, device=cuda),
                                   max_batch=2, max_wait_s=0.01)
                    for _ in range(2)]
        try:
            tickets = [[svc.submit(tc.from_edges(
                256, u, v, rng.integers(1, 10, len(u)) * 1.0))
                for _ in range(6)] for svc in services]
            for svc, ts in zip(services, tickets):
                got = dict(svc.results.get(timeout=300) for _ in ts)
                assert sorted(got) == sorted(ts)
                assert not any(isinstance(r, Exception)
                               for r in got.values())
        finally:
            for svc in services:
                svc.close()
    finally:
        RefinementEngine._sweep = orig
    assert torch.cuda.get_sync_debug_mode() == 0
    names = {ident for ident, *_ in loops}
    assert len(names) == 2                  # both workers swept
    for _, _, _, syncs in loops:
        assert syncs["reads"] > 0
        assert syncs["observed"] == syncs["reads"]
    spans = {n: [(a, b) for m, a, b, _ in loops if m == n] for n in names}
    one, two = spans.values()
    assert any(a0 < b1 and a1 < b0 for a0, b0 in one for a1, b1 in two)


# ---------------------------------------------------------------- training
# the CPU tests' float32 measure (tests/test_torch_train.py) and K4's
# float32 tolerance
TRAIN_TOL = 1e-5
TRAIN_ATTN_TOL = 2e-5


def _train_state_on(state, device):
    import copy
    return {"params": copy.deepcopy(state["params"]).to(device),
            "m": {k: t.to(device, copy=True) for k, t in state["m"].items()},
            "v": {k: t.to(device, copy=True) for k, t in state["v"].items()},
            "step": state["step"].to(device, copy=True)}


def _rel_fro(got, want):
    got, want = got.detach().cpu().double(), want.detach().cpu().double()
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want))


def test_train_step_on_card_equals_cpu(cuda):
    """The smoke granite config at float32: two ``train_step`` calls (4 ×
    128 tokens, 2 microbatches) on the card and on the CPU from one
    initial state: losses and grad norms within 1e-5 relative, every
    parameter, m and v within 1e-5 relative Frobenius error per tensor
    (``chip_smoke.py``'s train:parity measure); K4 launched 0 times and
    no host sync inside a step."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.runtime.boundary import host_boundary
    from repro_torch.train import OptConfig
    from repro_torch.train.steps import init_train_state, train_step
    cfg = dataclasses.replace(get_smoke_config("granite-3-2b"),
                              dtype="float32")
    cpu = init_train_state(0, cfg, device="cpu")
    card = _train_state_on(cpu, cuda)
    src = SyntheticLM(cfg.vocab_size, 128, 4, seed=0)
    before = _flash_launches()
    for i in range(2):
        batch = {k: torch.from_numpy(v) for k, v in src.batch_at(i).items()}
        on_card = {k: v.to(cuda) for k, v in batch.items()}
        _, want = train_step(cpu, batch, cfg, OptConfig(), microbatches=2)
        with host_boundary("train.step", cuda, all_threads=True) as hb:
            _, got = train_step(card, on_card, cfg, OptConfig(),
                                microbatches=2)
        assert hb.syncs == 0
        for key in ("loss", "grad_norm"):
            assert abs(float(got[key]) / float(want[key]) - 1) <= TRAIN_TOL
    assert _flash_launches() == before
    assert int(card["step"]) == 2
    cpu_params = dict(cpu["params"].named_parameters())
    for name, p in card["params"].named_parameters():
        assert _rel_fro(p, cpu_params[name]) <= TRAIN_TOL, name
    for part in ("m", "v"):
        for name, t in card[part].items():
            assert _rel_fro(t, cpu[part][name]) <= TRAIN_TOL, (part, name)


@pytest.mark.parametrize("arch,b,t", [("granite-3-2b", 2, 256),
                                      ("granite-3-2b", 2, 96),
                                      ("starcoder2-7b", 2, 256),
                                      ("granite-3-2b-full", 1, 1024)])
def test_blocked_train_attention_equals_k4_f32(cuda, arch, b, t):
    """The blocked training attention's forward against K4's float32
    route within K4's 2e-5, at the smoke configs' blocks (64) and at
    granite-3-2b's full heads and blocks (32/8 × 64, q 512, kv 1024)."""
    import dataclasses

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models.attention import blocked_flash_attention
    cfg = (get_config("granite-3-2b") if arch.endswith("-full")
           else get_smoke_config(arch))
    cfg = dataclasses.replace(cfg, dtype="float32")
    gen = torch.Generator(device=cuda).manual_seed(t)
    q, k, v = (torch.randn((b, t, n, cfg.head_dim_), generator=gen,
                           device=cuda)
               for n in (cfg.n_heads_eff, cfg.n_kv_heads, cfg.n_kv_heads))
    before = _flash_launches()
    with torch.no_grad():
        got = blocked_flash_attention(q, k, v, cfg)
    assert _flash_launches() == before
    want = flash_attention_kernel(q, k, v, window=cfg.sliding_window)
    assert float((got - want).abs().max()) <= TRAIN_ATTN_TOL


def test_train_k4_raises_under_autograd(cuda):
    """K4 on the card raises under grad mode when q, k or v requires
    grad (its output would carry no gradient to wq, wk, wv), launches
    nothing, and runs under no_grad."""
    q = torch.randn((1, 128, 4, 64), device=cuda)
    k = torch.randn((1, 128, 2, 64), device=cuda)
    for dtype in (torch.float32, torch.bfloat16):
        qq, kk = q.to(dtype).requires_grad_(), k.to(dtype)
        before = _flash_launches()
        with pytest.raises(RuntimeError, match="no backward"):
            flash_attention_kernel(qq, kk, kk)
        assert _flash_launches() == before
        with torch.no_grad():
            flash_attention_kernel(qq, kk, kk)
        assert sum(_flash_launches()) == sum(before) + 1


def test_train_step_scope_counts_a_sync_in_backward(cuda):
    """The backward runs on the autograd engine's device thread.  A sync
    there — in Python (a custom backward, as a checkpointed layer's
    recomputed forward runs) or in a C++ backward op (the boolean-mask
    index's ``index_put_``) — is charged to the caller's all-thread
    ``train.step`` scope, so "0 syncs inside each step" covers the
    backward; a thread-local scope misses the Python one."""
    from repro_torch.runtime.boundary import host_boundary

    class Sync(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.clone()

        @staticmethod
        def backward(ctx, g):
            g.sum().item()
            return g

    x = torch.ones(4, device=cuda, requires_grad=True)
    with host_boundary("train.step", cuda, all_threads=True) as hb:
        torch.autograd.grad(Sync.apply(x).sum(), x)
    assert hb.syncs >= 1
    with host_boundary("train.step", cuda) as local:
        torch.autograd.grad(Sync.apply(x).sum(), x)
    assert local.syncs == 0
    mask = torch.tensor([True, False, True, False], device=cuda)
    y = x[mask]                                  # its forward syncs here
    with host_boundary("train.step", cuda, all_threads=True) as hb:
        torch.autograd.grad(y.sum(), x)
    assert hb.syncs >= 1
    with host_boundary("train.step", cuda, all_threads=True) as hb:
        torch.autograd.grad((x.clone() * 2).sum(), x)
    assert hb.syncs == 0


def test_runtime_audit_on_card(cuda):
    """``viem lint --runtime-audit --device cuda`` on the tree machine:
    every construction through ``execute``, ``execute_batch`` and the
    portfolio's lanes under the op recorder and PyTorch's sync debug
    mode; every sync a counted read (tests/test_torch_staticcheck.py
    runs the five machines on the CPU)."""
    from repro_torch.staticcheck.runtime_audit import run_audit
    report = run_audit(topologies=["tree"], device="cuda")
    assert report["device"] == "cuda"
    assert report["ok"], [e for e in report["entries"]
                          if e["status"] != "ok"]
    assert all(e["status"] == "ok" for e in report["entries"])


# ------------------------------------ training through the new layer kinds
def _kind_cfg(arch, dtype, **over):
    import dataclasses

    from repro_torch.configs import get_smoke_config
    return dataclasses.replace(get_smoke_config(arch), dtype=dtype, **over)


def _kind_batch(cfg, b, t, seed, run=0):
    """SyntheticLM tokens, the last ``run`` of each row its first token
    (a padding run: it skews jamba's routers so that its MoE drops)."""
    from repro_torch.data.pipeline import SyntheticLM
    batch = SyntheticLM(cfg.vocab_size, t, b, seed=seed).batch_at(0)
    if run:
        batch["tokens"][:, -run:] = batch["tokens"][:, :1]
        batch["labels"][:, -run - 1:-1] = batch["tokens"][:, :1]
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("shape", [(2, 32, 40, 64), (4, 16, 4, 32)])
def test_wkv_cumulative_on_card_equals_cpu(cuda, shape):
    """The WKV chunk's Λ (``models/rwkv.py:_cumulative``) on a chunk's
    slice of log-decays: CUDA's ``torch.cumsum`` adds in float32, one
    term after another, so the card and the CPU's running sum agree bit
    for bit (rwkv6-3b's chunk and head size, and the smoke config's)."""
    from repro_torch.models.rwkv import _cumulative
    b, c, h, k = shape
    gen = torch.Generator().manual_seed(0)
    full = -torch.exp(torch.randn((b, 4 * c, h, k), generator=gen) * 0.7)
    lw = full.clamp(-5.0, -1e-4)[:, c:2 * c]
    assert torch.equal(_cumulative(lw.to(cuda)).cpu(), _cumulative(lw))


def test_train_remat_keeps_the_routes_on_card(cuda):
    """jamba's smoke config in bf16 at capacity factor 1.25, on the
    card: under remat "full" the backward's recomputation routes every
    token as the forward did (a near tie resolved otherwise the second
    time would give a gradient of another function), the MoE drops
    assignments, and the gradients equal remat "none"'s — bit for bit
    where two remat "none" runs agree bit for bit, else, over every
    tensor, within 2.5× the largest difference between those two runs
    (the dispatch's gather backward adds on the card with atomics)."""
    import dataclasses
    import functools

    from repro_torch.models.transformer import forward
    from repro_torch.testing import moe_routes
    from repro_torch.train import lm_loss
    from repro_torch.train.steps import init_train_state
    cfg = _kind_cfg("jamba-v0.1-52b", "bfloat16", capacity_factor=1.25)
    params = init_train_state(0, cfg, device=cuda)["params"]
    batch = {k: v.to(cuda) for k, v in
             _kind_batch(cfg, 4, 256, 0, run=64).items()}
    fwd = functools.partial(forward, train=True)
    n_moe = sum(cfg.layer_kind(i)[1] == "moe" for i in range(cfg.n_layers))

    def grads(remat):
        with moe_routes() as plans:
            loss, _ = lm_loss(params, batch,
                              dataclasses.replace(cfg, remat=remat), fwd)
            g = torch.autograd.grad(loss, list(params.parameters()))
        return g, [tuple(a.detach() for a in p[:5]) for p in plans]

    full, plans = grads("full")
    none, none_plans = grads("none")
    again, _ = grads("none")
    assert len(plans) == 2 * n_moe and len(none_plans) == n_moe
    forward_plans, recomputed = plans[:n_moe], plans[n_moe:][::-1]
    dropped = 0
    for a, b, c in zip(forward_plans, recomputed, none_plans):
        for i in (0, 1, 3, 4):                  # expert, token, slot, kept
            assert torch.equal(a[i], b[i]) and torch.equal(a[i], c[i])
        assert torch.equal(a[2], b[2])
        dropped += int((~a[4]).sum())
    assert dropped > 0
    spread = max(_rel_fro(n2, n) for n, n2 in zip(none, again))
    if spread == 0.0:
        assert all(torch.equal(f, n) for f, n in zip(full, none))
    else:
        assert max(_rel_fro(f, n) for f, n in zip(full, none)) <= \
            2.5 * spread


@pytest.mark.parametrize("case", ["jamba", "mixtral", "rwkv"])
def test_train_step_kinds_on_card_equal_cpu(cuda, case):
    """Two float32 ``train_step`` calls (2 × 128 tokens, 2 microbatches)
    of each new family's smoke config on the card and on the CPU from one
    initial state (jamba at capacity factor 1.25 with a padding run, so
    that it drops): every MoE route equal, 0 host syncs inside a step, no
    kernel launched, and per key (the loss, the grad norm, and each
    parameter, m and v by its relative Frobenius error) the card's error
    against the same steps in float64 on the CPU (the truth,
    ``testing.float64_evaluation``, at one microbatch) within 1e-5 — or,
    where larger, within 2.5× the CPU's own float32 spread on that key
    (the largest of its runs' errors at microbatches 2 and 1 and their
    distance from each other; the factored WKV chunk's gradients and
    AdamW's first steps on zero-initialised tensors are ill-conditioned
    in float32), as ``chip_smoke.py``'s train:kinds-parity."""
    from repro_torch.runtime.boundary import host_boundary
    from repro_torch.testing import (float64_evaluation, moe_routes,
                                     widen_train_state)
    from repro_torch.train import OptConfig
    from repro_torch.train.steps import init_train_state, train_step
    arch, over, run = {"jamba": ("jamba-v0.1-52b",
                                 {"capacity_factor": 1.25}, 32),
                       "mixtral": ("mixtral-8x7b", {}, 0),
                       "rwkv": ("rwkv6-3b", {}, 0)}[case]
    cfg = _kind_cfg(arch, "float32", **over)
    cpu = init_train_state(0, cfg, device="cpu")
    card = _train_state_on(cpu, cuda)
    cpu1 = _train_state_on(card, "cpu")
    truth = widen_train_state(cpu)
    batches = [_kind_batch(cfg, 2, 128, s, run) for s in (0, 1)]
    before = _flash_launches()
    logs = {"cpu": [], "card": [], "truth": [], "cpu1": []}
    plans = {}
    for side, state, dev, mb in (("cpu", cpu, "cpu", 2),
                                 ("card", card, cuda, 2),
                                 ("truth", truth, "cpu", 1),
                                 ("cpu1", cpu1, "cpu", 1)):
        with (float64_evaluation() if side == "truth"
              else contextlib.nullcontext()), moe_routes() as rec:
            for b in batches:
                b = {k: v.to(dev) for k, v in b.items()}
                with host_boundary("train.step", dev,
                                   all_threads=True) as hb:
                    _, m = train_step(state, b, cfg, OptConfig(),
                                      microbatches=mb)
                if side == "card":
                    assert hb.syncs == 0
                logs[side].append({k: float(m[k])
                                   for k in ("loss", "grad_norm")})
        plans[side] = [tuple(a.detach().cpu() for a in p[:5]) for p in rec]
    assert _flash_launches() == before
    assert len(plans["card"]) == len(plans["cpu"])
    for g, w in zip(plans["card"], plans["cpu"]):
        for i in (0, 1, 3, 4):
            assert torch.equal(g[i], w[i])
    if case == "jamba":
        assert sum(int((~w[4]).sum()) for w in plans["cpu"]) > 0

    def leaves(st):
        out = {("params", n): p for n, p in st["params"].named_parameters()}
        for part in ("m", "v"):
            out.update({(part, n): t for n, t in st[part].items()})
        return out

    def errors(st, side, want=truth, want_side="truth"):
        out = {key: max(abs(g[key] / w[key] - 1)
                        for g, w in zip(logs[side], logs[want_side]))
               for key in ("loss", "grad_norm")}
        w = leaves(want)
        out.update({k: _rel_fro(x, w[k]) for k, x in leaves(st).items()})
        return out

    err = errors(card, "card")
    own = {}
    for sample in (errors(cpu, "cpu"), errors(cpu1, "cpu1"),
                   errors(cpu, "cpu", cpu1, "cpu1")):
        own = {k: max(own.get(k, 0.0), e) for k, e in sample.items()}
    beyond = {k: (e, own[k]) for k, e in err.items()
              if e > max(TRAIN_TOL, 2.5 * own[k])}
    assert not beyond, beyond


@pytest.mark.parametrize("arch", ["granite-3-8b", "starcoder2-7b"])
def test_sharded_k4_prefill_on_a_one_rank_mesh_is_bit_equal(cuda, arch):
    """The prefill through the sharded K4 route (``build_prefill_step``
    with a (1, 1) mesh over a world-1 NCCL group: each rank's heads, their
    KV expanded) equals the unsharded K4 prefill bit for bit (bf16, smoke
    width: 4 heads over 2 KV heads; starcoder2's window too), K4 launched
    once a layer on each."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.train import make_local_mesh
    from repro_torch.models.transformer import init_params
    from repro_torch.train import steps as tsteps
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="bfloat16")
    started = not dist.is_initialized()
    mesh = make_local_mesh("cuda")
    try:
        toks = torch.randint(0, cfg.vocab_size, (2, 256),
                             generator=torch.Generator().manual_seed(3))
        batch = {"tokens": toks.to(cuda)}
        f0, _, _ = tsteps.build_prefill_step(cfg, None)
        f1, _, _ = tsteps.build_prefill_step(cfg, mesh, global_batch=2)
        before = FLASH_KERNEL.launches
        want = f0(init_params(0, cfg, device=cuda), batch)
        mid = FLASH_KERNEL.launches
        got = f1(init_params(0, cfg, device=cuda), batch)
        after = FLASH_KERNEL.launches
    finally:
        if started:
            dist.destroy_process_group()
    assert mid - before == after - mid == cfg.n_layers
    assert got.dtype == want.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
