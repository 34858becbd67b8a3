"""The port's partitioner against the JAX package's, on the CPU.

``core.partition._exact_rebalance`` sums every vertex's move gain in one
pass over the edge list, where the reference loops over the candidates
and sums each one's adjacency with ``ndarray.sum``.  It must move the
same vertices in the same order: on unit and integer weights (where
every order of summation is exact), on real weights, and on weights in
tenths whose gains tie but for the rounding of the order they are summed
in (numpy sums an adjacency of 8 or more in 8 partial sums).  Then
``partition`` and the tree construction ``hierarchy_top_down``, which
call it at every bisection, must give the reference's labels and
permutation exactly.
"""

import numpy as np
import pytest

import repro.core as rc
import repro_torch.core as tc
from repro.core import partition as jpart
from repro.core.construction import hierarchy_top_down as jax_top_down
from repro.topology.base import as_topology as jax_topology
from repro_torch.core import partition as tpart
from repro_torch.core.construction import hierarchy_top_down
from repro_torch.topology.base import as_topology

N = 96
KINDS = ("grid", "integer", "real", "tenths")


def _graph(mod, kind: str, seed: int):
    """A graph of N vertices: a 6×4×4 stencil of unit weights, or 700
    seeded random edges (parallel ones merged, so some vertices have
    degree above 8) with integer weights in [1, 100), reals in [0, 1)
    or tenths in {0.1, 0.2, 0.3}."""
    if kind == "grid":
        return mod.grid3d(6, 4, 4)
    rng = np.random.default_rng(seed)
    u, v = rng.integers(0, N, 700), rng.integers(0, N, 700)
    keep = u != v
    u, v = u[keep], v[keep]
    w = {"integer": lambda: rng.integers(1, 100, len(u)).astype(float),
         "real": lambda: rng.random(len(u)),
         "tenths": lambda: rng.integers(1, 4, len(u)) * 0.1}[kind]()
    return mod.from_edges(N, u, v, w)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", KINDS)
def test_exact_rebalance_moves_the_references_vertices(kind, seed):
    tg, jg = _graph(tc, kind, seed), _graph(rc, kind, seed)
    rng = np.random.default_rng(100 + seed)
    for _ in range(6):
        side = rng.random(N) < rng.uniform(0.3, 0.7)
        target = int(np.sum(~side)) + int(rng.integers(-12, 13))
        got = tpart._exact_rebalance(tg, side, float(target))
        want = jpart._exact_rebalance(jg, side, float(target))
        assert np.array_equal(got, want), (kind, seed, target)
        assert int(np.sum(~got)) == target


@pytest.mark.parametrize("kind", KINDS)
def test_partition_equals_the_references(kind):
    tg, jg = _graph(tc, kind, 3), _graph(rc, kind, 3)
    for k in (2, 3, 4):
        got = tpart.partition(tg, k, seed=k)
        want = jpart.partition(jg, k, seed=k)
        assert np.array_equal(got, want), (kind, k)


def test_tree_construction_equals_the_references():
    """The construction the main map runs, on a 2-level tree of 96 PEs:
    every bisection rebalanced on the way."""
    tg, jg = tc.grid3d(6, 4, 4), rc.grid3d(6, 4, 4)
    got = hierarchy_top_down(tg, as_topology(
        tc.Hierarchy.from_strings("4:24", "1:10")), seed=5)
    want = jax_top_down(jg, jax_topology(
        rc.Hierarchy.from_strings("4:24", "1:10")), seed=5)
    assert np.array_equal(got, want)
