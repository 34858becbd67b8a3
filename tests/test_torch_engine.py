"""The port's eager sweep engine against the JAX package's jitted one.

``repro_torch.engine.RefinementEngine.refine`` (on the CPU: the plain
versions of both kernels) is held against
``repro.engine.RefinementEngine.refine`` (Pallas pair gains in interpret
mode) on all five topologies, over tabu tenure 0/3 × don't-look bits
off/on × telemetry off/on.  Weights and distances are integers, so the
permutation, objective trace, sweep and swap counts and every telemetry
counter must be *equal*.

Each case starts a few random swaps away from a converged mapping, so
within the 8-sweep budget the engines take matching moves, reach the
local optimum, and — with tabu on — take downhill escapes and fire
aspirations.
"""

import functools

import numpy as np
import pytest
import torch

import repro.core as rc
import repro.topology as rt
import repro_torch.core as tc
import repro_torch.topology as tt
from repro.core.local_search import communication_pairs
from repro.engine import RefinementEngine as RefEngine
from repro.kernels.config import KernelConfig as RefConfig
from repro_torch.engine import RefinementEngine as PortEngine
from repro_torch.kernels.config import KernelConfig as PortConfig

N = 64
SWEEPS = 8
TOPOLOGIES = ["tree", "torus", "fattree", "dragonfly", "matrix"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run tiny tensors: one intra-op thread, so
    parallel test workers do not oversubscribe the CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _machines(mod, core):
    torus = mod.TorusTopology((4, 4, 4), (1.0, 2.0, 1.0))
    return {
        "tree": mod.TreeTopology(hierarchy=core.Hierarchy(
            (4, 4, 4), (1.0, 10.0, 100.0))),
        "torus": torus,
        "fattree": mod.FatTreeTopology((4, 4, 4), (1.0, 2.0, 5.0)),
        "dragonfly": mod.DragonflyTopology(4, 4, 4),
        "matrix": mod.MatrixTopology(matrix=torus.distance_matrix() * 3.0),
    }


@functools.lru_cache(maxsize=None)
def _setup(name):
    """(graph, pairs, start perm, JAX engine, port engine) per topology;
    cached so each engine is built (and the JAX one compiled) once."""
    ref_topo = _machines(rt, rc)[name]
    port_topo = _machines(tt, tc)[name]
    g = rc.random_geometric(N, 0.25, seed=3)
    g_port = tc.CommGraph(g.xadj.copy(), g.adjncy.copy(), g.adjwgt.copy(),
                          g.vwgt.copy())
    pairs = communication_pairs(g, 3)
    perm = np.random.default_rng(0).permutation(N)
    PortEngine(port_topo, max_sweeps=64, device="cpu").refine(
        g_port, perm, pairs)                        # converge
    rng = np.random.default_rng(1)
    for _ in range(3):                              # then perturb
        a, b = rng.choice(N, 2, replace=False)
        perm[a], perm[b] = perm[b], perm[a]
    # one tile covers the whole pair list: the interpreted Pallas grid is
    # one step per side instead of one per 8 pairs (same results)
    ref = RefEngine(ref_topo, max_sweeps=SWEEPS, use_pallas=True,
                    interpret=True,
                    kernel_config=RefConfig(block_rows=1024, lanes=128))
    port = PortEngine(port_topo, max_sweeps=SWEEPS, device="cpu",
                      kernel_config=PortConfig(block_rows=1024, lanes=128))
    return g, g_port, pairs, perm, ref, port


@pytest.mark.parametrize("telemetry", [False, True])
@pytest.mark.parametrize("dlb", [False, True])
@pytest.mark.parametrize("tenure", [0, 3])
@pytest.mark.parametrize("name", TOPOLOGIES)
def test_refine_equals_reference(name, tenure, dlb, telemetry):
    g, g_port, pairs, perm0, ref, port = _setup(name)
    p_ref, p_port = perm0.copy(), perm0.copy()
    s_ref = ref.refine(g, p_ref, pairs, tabu_tenure=tenure, dlb=dlb,
                       telemetry=telemetry)
    s_port = port.refine(g_port, p_port, pairs, tabu_tenure=tenure, dlb=dlb,
                         telemetry=telemetry)
    assert np.array_equal(p_port, p_ref)
    assert s_port.objective_trace == s_ref.objective_trace
    assert s_port.swaps == s_ref.swaps
    assert s_port.evaluated == s_ref.evaluated
    assert s_port.initial_objective == s_ref.initial_objective
    assert s_port.final_objective == s_ref.final_objective
    if not telemetry:
        assert s_port.telemetry is None and s_ref.telemetry is None
        return
    a, b = s_port.telemetry, s_ref.telemetry
    assert a.summary() == b.summary()
    for key in ("exchanges", "tabu_masked", "aspirations", "match_rounds",
                "objective_trace"):
        assert np.array_equal(getattr(a, key), getattr(b, key)), key
    # the host syncs are counted: one per sweep pass plus one per
    # matching round
    syncs = port.last_syncs
    assert syncs["reads"] == a.passes + int(a.match_rounds.sum())


def test_cases_exercise_tabu_escapes_and_dont_look_bits():
    """The start states really reach the tabu and don't-look paths (so
    the parity above covers them, not just the monotone sweep)."""
    g, g_port, pairs, perm0, _, port = _setup("torus")
    plain = port.refine(g_port, perm0.copy(), pairs, telemetry=True)
    tabu = port.refine(g_port, perm0.copy(), pairs, tabu_tenure=3,
                       telemetry=True)
    dlb = port.refine(g_port, perm0.copy(), pairs, tabu_tenure=3, dlb=True,
                      telemetry=True)
    assert plain.telemetry.passes < SWEEPS          # converged early
    assert tabu.telemetry.downhill_escapes > 0
    assert tabu.telemetry.tabu_masked_total > 0
    assert tabu.telemetry.aspiration_fires > 0
    assert dlb.objective_trace != tabu.objective_trace


def test_empty_pairs_and_zero_budget():
    g, g_port, pairs, perm0, _, _ = _setup("torus")
    topo = _machines(tt, tc)["torus"]
    eng = PortEngine(topo, max_sweeps=0, device="cpu")
    perm = perm0.copy()
    stats = eng.refine(g_port, perm, pairs, telemetry=True)
    assert np.array_equal(perm, perm0) and stats.swaps == 0
    assert len(stats.objective_trace) == 1
    stats = eng.refine(g_port, perm, np.zeros((0, 2), np.int64))
    assert stats.objective_trace == [stats.initial_objective]
