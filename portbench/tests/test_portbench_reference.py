"""The plain reference against cases worked by hand."""

import numpy as np
import pytest

from portbench import reference
from portbench.reference.machines import torus, tree

TREE = {"kind": "tree", "factors": [2, 2, 2], "distances": [1.0, 10.0, 100.0]}


@pytest.mark.parametrize("p,q,want", [
    (0, 0, 0.0), (0, 1, 1.0), (1, 0, 1.0),      # one processor
    (0, 2, 10.0), (1, 3, 10.0), (2, 3, 1.0),    # one node
    (0, 4, 100.0), (3, 4, 100.0), (5, 7, 10.0), (6, 7, 1.0),
])
def test_tree_distance_by_hand(p, q, want):
    dist, n = reference.distance_fn(TREE)
    assert n == 8
    assert float(dist(np.array(p), np.array(q))) == want


def test_tree_distance_of_the_paper_machine():
    # S = 4:16:64: PEs 0-3 share a processor, 0-63 a node
    f, d = [4, 16, 64], [1.0, 10.0, 100.0]
    p = np.array([0, 0, 0, 0, 63, 64, 4095])
    q = np.array([3, 4, 63, 64, 64, 127, 0])
    assert tree.distance(p, q, f, d).tolist() == [
        1.0, 10.0, 10.0, 100.0, 100.0, 10.0, 100.0]


@pytest.mark.parametrize("dims,p,q,want", [
    ((4,), 0, 3, 1.0), ((4,), 0, 2, 2.0), ((4,), 1, 1, 0.0),
    ((4, 4), 0, 5, 2.0),          # (0,0) to (1,1)
    ((4, 4), 0, 15, 2.0),         # (0,0) to (3,3): one hop back on each
    ((4, 4), 2, 8, 4.0),          # (2,0) to (0,2)
    ((16, 16, 16), 0, 8 + 8 * 16 + 8 * 256, 24.0),   # the farthest PE
])
def test_torus_distance_by_hand(dims, p, q, want):
    assert float(torus.distance(np.array(p), np.array(q), dims)) == want


def test_objective_by_hand():
    # a path 0-1-2-3 with weights 1, 2, 3 on the tree above
    u, v, w = np.array([0, 1, 2]), np.array([1, 2, 3]), np.array([1., 2., 3.])
    dist, _ = reference.distance_fn(TREE)
    assert reference.objective(u, v, w, np.arange(4), dist) == \
        1 * 1 + 2 * 10 + 3 * 1
    # 0 and 2 exchanged: D(2,1) = 10, D(1,0) = 1, D(0,3) = 10
    perm = np.array([2, 1, 0, 3])
    assert reference.objective(u, v, w, perm, dist) == 1 * 10 + 2 * 1 + 3 * 10


def test_bf16_objective_departs_where_float32_would_not():
    rng = np.random.default_rng(0)
    u = rng.integers(0, 4096, 11520)
    v = (u + 1 + rng.integers(0, 4095, 11520)) % 4096
    w = rng.integers(1, 101, 11520).astype(np.float64)
    dist, _ = reference.distance_fn(
        {"kind": "tree", "factors": [4, 16, 64],
         "distances": [1.0, 10.0, 100.0]})
    perm = rng.permutation(4096)
    j = reference.objective(u, v, w, perm, dist)
    j32 = float(np.sum((w * dist(perm[u], perm[v])).astype(np.float32),
                       dtype=np.float32))
    j16 = reference.objective_bf16(u, v, w, perm, dist)
    assert abs(j32 - j) / j < 1e-6
    assert abs(j16 - j) / j > 1e-4


@pytest.mark.parametrize("perm,ok", [
    ([2, 0, 1], True), ([0, 0, 1], False), ([0, 1], False),
    ([0, 1, 3], False), ([-1, 0, 1], False), ([0.0, 1.0, 2.0], False),
])
def test_bijection(perm, ok):
    assert reference.is_bijection(np.array(perm), 3) is ok


def test_ema_windows_by_hand():
    base = np.array([1.0, 2.0, 0.005])          # the last below min_weight
    wins = [np.array([3.0, 2.0, 0.0]), np.array([1.0, 0.0, 0.0])]
    lives = list(reference.ema_windows(base, wins, alpha=0.5,
                                       min_weight=0.01))
    assert lives[0].tolist() == [2.0, 2.0, 0.0]
    assert lives[1].tolist() == [1.5, 1.0, 0.0]
    # an edge that decays below min_weight is dropped, then comes back
    decay = list(reference.ema_windows(np.array([0.04]),
                                       [np.zeros(1)] * 3 + [np.ones(1)],
                                       alpha=0.5, min_weight=0.01))
    assert [x[0] for x in decay] == [0.02, 0.01, 0.0, 0.5]


def test_edge_l1_by_hand():
    assert reference.edge_l1(np.array([1.0, 3.0]),
                             np.array([2.0, 1.0])) == 0.75


def test_a_new_machine_kind_is_found_by_name(tmp_path, monkeypatch):
    from portbench.reference import distances
    (tmp_path / "ring.py").write_text(
        "import numpy as np\n\n\n"
        "def make(machine):\n"
        "    n = int(machine['n'])\n"
        "    def D(p, q):\n"
        "        d = np.abs(np.asarray(p) - np.asarray(q)) % n\n"
        "        return np.minimum(d, n - d).astype(np.float64)\n"
        "    return D, n\n")
    monkeypatch.setattr(distances, "MACHINE_DIRS",
                        [tmp_path, *distances.MACHINE_DIRS])
    dist, n = reference.distance_fn({"kind": "ring", "n": 8})
    assert n == 8
    assert dist(np.array([0, 1]), np.array([7, 5])).tolist() == [1.0, 4.0]
    with pytest.raises(ValueError):
        reference.distance_fn({"kind": "dragonfly"})
