"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card, the CUDA
toolkit (nvcc) and PyTorch.  It imports nothing of JAX and nothing of the
JAX package ``repro``; it drives ``src/repro_torch`` in phases and prints
one JSON line after each, failing loudly on the first fault:

1. device   — a CUDA card must be present; prints its name and power
              limit (``nvidia-smi``).
2. build    — compiles every kernel of the mapping path from
              ``src/repro_torch/csrc`` (one ``nvcc`` per source, all at
              once) and prints the ``-Xptxas -v`` register / shared-memory
              report.
3. kernels  — holds K1 (objective) and K2 (pair gains) against their plain
              PyTorch versions on the card at the main path's shapes
              (E = 11,520 edges on 4096 PEs; P = 1,824,720 pairs, K = 8):
              integer inputs exactly, real-weight inputs to rtol 1e-6 of
              Σ|w·d|; times each with CUDA events over 100 launches after
              warm-up beside its plain version and its bound.
4. main     — ``Mapper(4:16:64 / 1:10:100, MappingSpec(engine="device",
              backend="pallas"), device="cuda").map(grid3d(16, 16, 16))``
              with the launch counts set to 0 just before and read just
              after; checks the result (bijection, jf equals the host
              float64 objective, jf <= j0) and that the card's refinement
              equals the plain versions' on the CPU from the same start.
5. forms    — the same path on a torus and on a fat-tree distance matrix
              packed to int8, at n = 1024.

The line before the last is ``{"kernels": [...]}`` (one entry per kernel:
route, source, the TPU kernel it replaces, launches on the main path,
max |kernel − plain|, ms, plain_ms, bound_ms, bound_by, library_ms); the
last is ``{"ok": true, "device": {...}}``.  Without a card, or outside a
checkout, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and float32
# outside the tensor cores (the kernels' arithmetic is scalar fp32/int32)
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
ITERS = 100

# the main path's size: Schulz & Träff's S = 4:16:k, D = 1:10:100 with
# k = 64 (n = 4096 PEs), a 16^3 stencil, the communication neighborhood
# at distance 10; the other forms at n = 1024
SIZE = {"hierarchy": "4:16:64", "distances": "1:10:100", "side": 16,
        "fattree": (4, 16, 64), "forms_fattree": (4, 16, 16),
        "edges": 11520, "pairs": 1824720, "ell": 8}
DEVICE = "cuda"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


# ------------------------------------------------------------ phase 1
def preflight() -> None:
    """Fail before printing anything without a card or outside a
    checkout."""
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA card")
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        fail(f"cannot import repro_torch from {ROOT / 'src'}: {exc}")


def phase_device():
    import torch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        f"nvidia-smi failed: {smi.stderr.strip()}"
    print(card, flush=True)
    emit({"phase": "device", "card": card,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return card


# ------------------------------------------------------------ phase 2
def phase_build():
    from repro_torch.kernels.cuda import build, library_path
    t0 = time.perf_counter()
    reports = build(["qap_objective", "pair_gain"])
    secs = time.perf_counter() - t0
    for name, text in reports.items():
        for line in text.splitlines():
            if any(k in line for k in ("registers", "smem", "spill",
                                       "Compiling entry")):
                print(f"ptxas[{name}] {line.strip()}", flush=True)
    emit({"phase": "build", "seconds": secs,
          "libraries": [str(library_path(n).relative_to(ROOT))
                        for n in reports]})


# ------------------------------------------------------------ timing
def cuda_ms(fn, iters: int = ITERS, warmup: int = 5) -> float:
    """Mean milliseconds per call over ``iters`` back-to-back calls,
    timed with CUDA events after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(bytes_moved: int, flops: float) -> tuple:
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FP32 * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations")


# ------------------------------------------------------------ phase 3
def machines():
    """The five distance forms at the main path's PE count."""
    import numpy as np

    from repro_torch.core import Hierarchy
    from repro_torch.topology import (FatTreeTopology, MatrixTopology,
                                      TorusTopology, TreeTopology)
    side = SIZE["side"]
    tree = TreeTopology(hierarchy=Hierarchy.from_strings(
        SIZE["hierarchy"], SIZE["distances"]))
    torus = TorusTopology((side, side, side))
    fattree = FatTreeTopology(SIZE["fattree"], (1.0, 1.0, 1.0))
    rng = np.random.default_rng(7)
    n = side ** 3
    real = rng.random((n, n), dtype=np.float32) * 5.0
    real = np.triu(real, 1) + np.triu(real, 1).T
    tree_wide = TreeTopology(hierarchy=Hierarchy.from_strings(
        SIZE["hierarchy"], "1:10:1000"))
    return {
        "tree": (tree, None),
        "torus": (torus, None),
        "matrix-f32": (MatrixTopology(matrix=real), None),
        "matrix-int8": (MatrixTopology(matrix=fattree.distance_matrix()),
                        "int8"),
        "matrix-int16": (MatrixTopology(matrix=tree_wide.distance_matrix()),
                         "int16"),
    }


def form_of(topo, packing, device):
    import numpy as np
    import torch

    from repro_torch.kernels.config import quantize_table
    kp = topo.kernel_params()
    if kp[0] != "matrix":
        return kp[0], kp[1:], torch.zeros((1, 1), device=device)
    if packing is None:
        table = np.asarray(topo.matrix(), dtype=np.float32)
    else:
        table = np.ascontiguousarray(quantize_table(topo.matrix(),
                                                    packing)[0])
    return "matrix", (), torch.from_numpy(table).to(device)


def phase_kernels(forms):
    import numpy as np
    import torch

    from repro_torch.core import DeviceGraph, device_pairs, grid3d
    from repro_torch.core.local_search import communication_pairs
    from repro_torch.kernels import (pair_gains, pair_gains_plain,
                                     qap_objective_edges,
                                     qap_objective_plain)
    from repro_torch.kernels.pad import pad_edge_arrays
    dev = torch.device(DEVICE)
    side = SIZE["side"]
    g = grid3d(side, side, side)
    n = g.n
    rng = np.random.default_rng(0)
    perm = torch.from_numpy(rng.permutation(n).astype(np.int32)).to(dev)
    u, v, w = g.edge_list()
    eu, ev, ew = pad_edge_arrays(u, v, w, device=dev)
    e = int(eu.shape[0])
    check(e == SIZE["edges"], f"main-path edge count {e}")
    w_real = torch.from_numpy(rng.random(e).astype(np.float32) * 3.0).to(dev)
    k1 = {"max_abs_err": 0.0}
    for name, (topo, packing) in forms.items():
        kind, params, D = form_of(topo, packing, dev)
        # grid weights (integers) and real weights; the f32 table holds
        # real distances, so its integer-weight case is real input too
        for weights, real in ((ew, name == "matrix-f32"), (w_real, True)):
            args = (kind, params, eu, ev, weights, perm, D)
            got = qap_objective_edges(*args)
            want = qap_objective_plain(*args)
            err = float(torch.abs(got - want))
            scale = float(qap_objective_plain(kind, params, eu, ev,
                                              weights.abs(), perm,
                                              D.abs() if kind == "matrix"
                                              else D))
            if real:
                check(err <= 1e-6 * scale,
                      f"K1 {name} real weights: |{float(got)} - "
                      f"{float(want)}| > 1e-6 * {scale}")
            else:
                check(err == 0.0, f"K1 {name}: {float(got)} != "
                                  f"{float(want)}")
            k1["max_abs_err"] = max(k1["max_abs_err"], err)
            emit({"phase": "kernels", "kernel": "qap_objective",
                  "form": name, "real_weights": real, "E": e,
                  "value": float(got), "plain": float(want),
                  "abs_err": err})
    kind, params, D = form_of(*forms["tree"], dev)
    args = (kind, params, eu, ev, ew, perm, D)
    k1["ms"] = cuda_ms(lambda: qap_objective_edges(*args))
    k1["plain_ms"] = cuda_ms(lambda: qap_objective_plain(*args))
    # per edge: eu, ev, ew once, the two perm entries it gathers (perm is
    # read once overall), and ~(k + 2) integer/float ops of the oracle
    k1["bound_ms"], k1["bound_by"] = bound(
        nbytes(eu, ev, ew, perm, D) + 4, e * 2.0)

    t0 = time.perf_counter()
    pairs = communication_pairs(g, 10)
    pairs_seconds = time.perf_counter() - t0
    check(len(pairs) == SIZE["pairs"],
          f"main-path pair count {len(pairs)}")
    dg = DeviceGraph.from_comm(g, device=dev)
    us, vs = device_pairs(pairs, device=dev)
    p, kdeg = int(us.shape[0]), dg.max_deg
    check(kdeg == SIZE["ell"], f"main-path ELL width {kdeg}")
    k2 = {"max_abs_err": 0.0}
    for name in ("tree", "torus", "matrix-int8"):
        kind, params, D = form_of(*forms[name], dev)
        args = (kind, params, dg.nbr, dg.wgt, perm, us, vs, D)
        got = pair_gains(*args)
        want = pair_gains_plain(*args)
        err = float(torch.max(torch.abs(got - want)))
        check(err == 0.0, f"K2 {name}: max |kernel - plain| = {err}")
        check(bool(torch.all(got[len(pairs):] == 0.0)),
              f"K2 {name}: padding pairs have nonzero gain")
        k2["max_abs_err"] = max(k2["max_abs_err"], err)
        emit({"phase": "kernels", "kernel": "pair_gains", "form": name,
              "P": p, "K": kdeg, "abs_err": err,
              "positive": int(torch.sum(got > 0)),
              "host_pairs_seconds": pairs_seconds})
    kind, params, D = form_of(*forms["tree"], dev)
    args = (kind, params, dg.nbr, dg.wgt, perm, us, vs, D)
    k2["ms"] = cuda_ms(lambda: pair_gains(*args))
    k2["plain_ms"] = cuda_ms(lambda: pair_gains_plain(*args))
    # bytes: us, vs, nbr, wgt, perm, D once, the gains written once;
    # operations: per pair and side K slots of (2 oracles, sub, mul, add)
    k2["bound_ms"], k2["bound_by"] = bound(
        nbytes(us, vs, dg.nbr, dg.wgt, perm, D) + p * 4,
        p * 2.0 * kdeg * 3.0)
    for rec in (k1, k2):
        rec["library_ms"] = None        # no single PyTorch call computes it
    emit({"phase": "kernels", "qap_objective": k1, "pair_gains": k2})
    return k1, k2


# ------------------------------------------------------------ phase 4/5
def run_map(topo, g, label, compare_cpu):
    """One ``Mapper.map`` on the card with the launch counts reset just
    before and read just after; optionally the same refinement on the
    CPU (plain versions) from the captured start."""
    import numpy as np
    import torch

    from repro_torch.core import Mapper, MappingSpec, qap_objective
    from repro_torch.engine import RefinementEngine
    from repro_torch.kernels import KERNELS
    mapper = Mapper(topo, MappingSpec(engine="device", backend="pallas"),
                    device=DEVICE)
    plan = mapper.lower_for(g)
    eng = plan.engines[0]
    captured = {}
    orig = eng.refine

    def recording_refine(g_, perm, pairs, **kw):
        captured.update(perm0=perm.copy(), pairs=np.array(pairs), kw=kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(g_, perm, pairs, **kw)
        torch.cuda.synchronize()
        captured["refine_seconds"] = time.perf_counter() - t0
        return out

    eng.refine = recording_refine           # records the inputs only
    torch.cuda.reset_peak_memory_stats()
    for k in KERNELS.values():
        k.launches = 0
    t0 = time.perf_counter()
    res = mapper.map(g)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in KERNELS.items()}
    peak = torch.cuda.max_memory_allocated()
    eng.refine = orig
    perm = res.perm
    n = g.n
    check(sorted(perm.tolist()) == list(range(n)),
          f"{label}: result is not a bijection")
    jf_host = qap_objective(g, topo, perm)
    check(res.final_objective == jf_host,
          f"{label}: jf {res.final_objective} != host {jf_host}")
    check(res.final_objective <= res.initial_objective,
          f"{label}: jf {res.final_objective} > j0 {res.initial_objective}")
    for name, count in launches.items():
        check(count > 0, f"{label}: kernel {name} was never launched on "
                         f"the main path")
    stats = res.search_stats
    syncs = dict(eng.last_syncs)
    out = {"phase": label, "n": n, "pairs": len(captured["pairs"]),
           "j0": res.initial_objective, "jf": res.final_objective,
           "sweeps": syncs["sweeps"], "swaps": stats.swaps,
           "construction_seconds": res.construction_seconds,
           "search_seconds": res.search_seconds,
           "refine_seconds": captured["refine_seconds"],
           "map_seconds": wall, "launches": launches,
           "host_reads": syncs["reads"],
           "syncs_observed": syncs["observed"],
           "passes": syncs["passes"],
           "max_memory_allocated": peak}
    out["reads_per_pass"] = out["host_reads"] / max(out["passes"], 1)
    if compare_cpu:
        ref = RefinementEngine(topo, max_sweeps=eng.max_sweeps,
                               kernel_config=eng.kernel_config,
                               device="cpu")
        p_cpu = captured["perm0"].copy()
        t1 = time.perf_counter()
        s_cpu = ref.refine(g, p_cpu, captured["pairs"], **captured["kw"])
        out["cpu_refine_seconds"] = time.perf_counter() - t1
        check(np.array_equal(p_cpu, perm),
              f"{label}: card and CPU permutations differ")
        check(s_cpu.objective_trace == stats.objective_trace,
              f"{label}: card and CPU objective traces differ")
        check(s_cpu.swaps == stats.swaps and
              ref.last_syncs["sweeps"] == syncs["sweeps"],
              f"{label}: card and CPU sweep/swap counts differ")
        out["equals_cpu"] = True
    emit(out)
    return out


def main() -> int:
    preflight()
    import torch
    card = phase_device()
    phase_build()
    forms = machines()
    k1, k2 = phase_kernels(forms)
    from repro_torch.core import Hierarchy, grid3d
    from repro_torch.topology import (FatTreeTopology, MatrixTopology,
                                      TorusTopology)
    from repro_torch.topology.base import as_topology
    side = SIZE["side"]
    main_run = run_map(as_topology(Hierarchy.from_strings(
        SIZE["hierarchy"], SIZE["distances"])), grid3d(side, side, side),
        "main", compare_cpu=True)
    quarter = grid3d(side, side, side // 4)
    run_map(TorusTopology((side, side, side // 4)), quarter, "forms:torus",
            compare_cpu=False)
    run_map(MatrixTopology(matrix=FatTreeTopology(
        SIZE["forms_fattree"], (1.0, 1.0, 1.0)).distance_matrix()), quarter,
        "forms:fattree-matrix-int8", compare_cpu=False)
    kernels = []
    for rec, name, source, replaces in (
            (k1, "qap_objective", "src/repro_torch/csrc/qap_objective.cu",
             "src/repro/kernels/qap_objective.py:144"),
            (k2, "pair_gains", "src/repro_torch/csrc/pair_gain.cu",
             "src/repro/kernels/pair_gain.py:245")):
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": main_run["launches"][name],
                        "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                        "plain_ms": rec["plain_ms"],
                        "bound_ms": rec["bound_ms"],
                        "bound_by": rec["bound_by"],
                        "library_ms": rec["library_ms"]})
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
