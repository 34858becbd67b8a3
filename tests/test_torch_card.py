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
Σ|w|·(|d_a| + |d_b|).
"""

import numpy as np
import pytest
import torch

import repro_torch.core as tc
from repro_torch.core.local_search import communication_pairs
from repro_torch.engine import RefinementEngine
from repro_torch.kernels import (OBJECTIVE_KERNEL, PAIR_GAIN_KERNEL,
                                 pair_gains, pair_gains_plain,
                                 qap_objective_edges, qap_objective_plain)
from repro_torch.kernels.config import quantize_table
from repro_torch.topology import MatrixTopology, TorusTopology

pytestmark = pytest.mark.gpu

N = 512
TREE = ((1, 8, 64, 512), (1.0, 10.0, 100.0))
TORUS = ((8, 8, 8), (1.0, 2.0, 3.0))
FORMS = ["tree", "torus", "f32", "f32real", "int8", "int16"]


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
