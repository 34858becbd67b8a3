"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card, the CUDA
toolkit (nvcc) and PyTorch.  It imports nothing of JAX and nothing of the
JAX package ``repro``; it drives ``src/repro_torch`` in phases and prints
one JSON line after each, failing loudly on the first fault:

1. device   — a CUDA card must be present; prints its name and power
              limit (``nvidia-smi``).
2. build    — compiles every kernel of the port from
              ``src/repro_torch/csrc`` (one ``nvcc`` per source, all at
              once; also ``host_alloc.cu``, the page-locked blocks of the
              gain call) and prints the ``-Xptxas -v`` register / shared-
              memory / spill report, K1's, K2's and K3's in the build line.
3. kernels  — holds K1 (objective) and K2 (pair gains) against their plain
              PyTorch versions on the card at the main path's shapes
              (E = 11,520 edges on 4096 PEs; P = 1,824,720 pairs, K = 8):
              integer inputs exactly, real-weight inputs to rtol 1e-6 of
              Σ|w·d|.  Times K2 in the tree, torus and int8-matrix forms
              and K1 in the tree form: the device time per launch (a spin
              kernel holds the stream while 100 calls are enqueued, so
              CUDA events bracket the kernels alone), the wrapper's host
              time per call (100 calls, no synchronize), the back-to-back
              figure of earlier runs, the CUDA kernels per call and their
              durations (torch.profiler), beside the plain version and
              the bound.  Then K2 (tree form) and K1 with LANES = 4 lanes
              in one launch, each lane its own structure at the main
              shape (the main graph, then three seeded relabellings of
              it: their own ELL rows, edges and pairs) with seeded
              permutations and real weights: each lane bit-equal to a
              single launch on its arrays; the device time per launch
              beside the 4 lanes' single launches and the bound at 4×
              the bytes.
4. main     — ``Mapper(4:16:64 / 1:10:100, MappingSpec(engine="device",
              backend="pallas"), device="cuda").map(grid3d(16, 16, 16))``
              with the launch counts set to 0 just before and read just
              after; checks the result (bijection, jf equals the host
              float64 objective, jf <= j0) and that the card's refinement
              equals the plain versions' on the CPU from the same start.
5. forms    — the same path on a torus and on a fat-tree distance matrix
              packed to int8, at n = 1024, each equal to the CPU
              refinement from the same start.
6. multilevel — the main call with ``multilevel=MultilevelSpec(),
              preconfiguration="eco"`` (4 levels, coarsen_min 64: n =
              4096 → 512): every level's refinement equals the plain
              versions' on the CPU from its captured start and the JAX
              package's levels (ML_REFERENCE_LEVELS: no level moves),
              every sync of each level's refinement and contraction is a
              counted read; a bijection, jf equal to the host float64
              objective.
              Prints the construction, pyramid and per-level refinement
              seconds, K1/K2 launches per level, the coarse tables'
              packing and jf beside the main map's.
7. batch    — ``map_many`` of 4 graphs at n = 4096 on the main machine
              under the same spec (3 stencils with seeded integer weights
              in [1, 100], one random geometric graph of about the
              stencil's mean degree), then a flat ``map_many`` of 4 at n
              = 1024 on the torus form: each result equal to its single
              card map, and the multilevel batch's levels up to n = 1024
              (which do swap) equal to the CPU refinement from the same
              starts; wall time per graph against the singles, K1/K2
              launches against the singles' sum, counted reads per
              sweep, each call's syncs all counted.
8. warm     — ``MappingPlan.execute_warm`` on the main map's result
              after a seeded drift (5 % of the vertices gain an edge to a
              seeded partner), the pairs touching them active: equal to
              the CPU warm refinement from the same incumbent, the
              incumbent unchanged, P unchanged, the inactive region
              frozen.
9. gain     — ``Mapper(..., backend="pallas").gain_matrix(g, perm)`` on
              the main map's graph, machine and final permutation, with
              the launch counts set to 0 just before and read just
              after: G must equal the plain version on the card, the
              host float64 ``dense_gain_matrix`` and K2's sparse gains at
              the main map's candidate pairs exactly, be bit-symmetric
              with a zero diagonal; the integer-edge cell (the same graph
              with seeded integer weights in [2¹¹, 2¹⁴), beyond the
              exactness contract's condition) must equal the host
              float64 G exactly; a ragged real-valued n = 1000
              instance stays within n·2⁻²²·max(|C|·|B|ᵀ) of the plain
              version and within 2⁻¹⁸·S(u,v) of the float64 G at every
              entry (``kernels.ref.swap_gain_limits``), bit-symmetric.
              Times K3 (3xTF32 ``wgmma``) beside its plain version,
              cuBLAS's ``torch.mm(C, B.T)`` (the one 2n³ product, TF32
              off) and its bound (2n³ at the TF32 tensor-core peak), and
              splits the call's wall time, with the readback of G
              through page-locked memory (what the call does) beside the
              pageable ``.cpu()``, and the warm call (least, median and
              largest of 5) with each result dropped and with the
              previous one held, with the page-locked blocks each call
              made, freed and reused, PyTorch's and the port's own.
10. flash   — holds K4 (flash attention) against its plain version on
              the card at the serve shape (B 4, T 2048, H 32, KV 8, hd
              128, bf16) and at starcoder2-7b's windowed shape (B 1, T
              8192, H 36, KV 4, hd 128, window 4096, bf16), and on small
              cases at float32 and bf16 (T ragged against both routes'
              tiles, T = 1, G = 1, MQA, one kv tile); every case must take
              its dtype's route (bf16: ``csrc/flash_attention_sm90.cu``,
              float32: ``csrc/flash_attention.cu``) and no other.  Times
              K4, its plain version and ``scaled_dot_product_attention``
              (the yardstick; the port never calls it) beside the bound,
              at both shapes in bf16 and at the serve shape in float32.
11. serve   — ``serve("granite-3-8b", batch=4, prompt_len=2048, gen=32)``
              at the full published config (40 layers, random weights)
              with the launch counts set to 0 just before and read just
              after: K4's bf16 route must launch once per layer of the
              prefill, its float32 route never, and the decode loop must
              make no host sync.  Then the same weights
              and prompts again: the prefill through K4 against the same
              prefill with K4's plain version, both on the card; the
              device time of a prefill and of 4 decode steps by kernel
              (torch.profiler) beside their wall time; and the same path
              at float32 and full width, 2 layers, K4 against the plain
              version, with the counts set to 0 just before and read just
              after: the float32 route once per layer, the bf16 route
              never.

The line before the last is ``{"kernels": [...]}`` (one entry per kernel,
K4 one per route: route, source, the TPU kernel it replaces, launches on
its path — the main map for K1 and K2, the gain call for K3, the serve
call for K4's bf16 route and the float32 prefill check for its float32
route —
max |kernel − plain|, ms, plain_ms, bound_ms, bound_by, library_ms; K1's
and K2's ms is the device time per launch, and they add
``batch_launches``, their launches in the multilevel batch's
``map_many``, and ``batch_ms``, the device time of one launch of 4
lanes); the last is ``{"ok": true,
"device": {...}}``.  Without a card, or outside a checkout, it exits
non-zero and prints no result.  ``--stop-after build|kernels`` runs the
phases up to that one and stops, with neither line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32
# outside the tensor cores (K1 and K2's arithmetic is scalar fp32/int32),
# TF32 on the tensor cores (the least time for K3's 2n³; its 3xTF32 split
# issues three times that) and bf16 on the tensor cores (the least time
# for K4's bf16 attention)
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
PEAK_TF32 = 495e12
PEAK_BF16 = 989e12
ITERS = 100

# the main path's size: Schulz & Träff's S = 4:16:k, D = 1:10:100 with
# k = 64 (n = 4096 PEs), a 16^3 stencil, the communication neighborhood
# at distance 10; the other forms at n = 1024
SIZE = {"hierarchy": "4:16:64", "distances": "1:10:100", "side": 16,
        "fattree": (4, 16, 64), "forms_fattree": (4, 16, 16),
        "edges": 11520, "pairs": 1824720, "ell": 8}
DEVICE = "cuda"
# lanes of the lane-axis kernel checks and of the batch cells
LANES = 4
# the batch cells: LANES - 1 stencils with seeded integer weights in
# [1, 100] and one random geometric graph whose radius puts its mean
# degree near the stencil's (16^3: 5.625; 16·16·4: 5.25); the flat
# batch runs on the torus form at n = 1024
BATCH = {"weights": (1, 100), "seed": 31, "radius": 0.0215,
         "flat_radius": 0.0425}
# the warm cell's drift: a seeded share of the vertices turn hot, each
# gaining one edge of this weight to a seeded partner, and the pairs
# touching them are active; its sweep budget (the CPU comparison takes
# ~1.5 s a sweep at n = 4096)
WARM = {"share": 0.05, "factor": 8.0, "seed": 17, "max_sweeps": 16}
# the multilevel cell's levels as the JAX package's V-cycle gives them on
# the CPU, coarsest first: (start objective, refined objective, swaps).
# The projected start is already a local optimum of every level, so the
# card's per-level comparison with the CPU compares unmoved permutations;
# these hold the card to the reference's word that nothing should move.
# tests/test_torch_multilevel.py::test_eco_main_cell_levels_equal_reference
# holds the reference and the port's CPU V-cycle to the same values.
ML_REFERENCE_LEVELS = ((277680.0, 277680.0, 0), (298160.0, 298160.0, 0),
                       (300208.0, 300208.0, 0), (302256.0, 302256.0, 0))
# the multilevel batch's levels up to this n are also refined again on
# the CPU from the card's captured starts (the finer ones take minutes
# there); their lanes do move, so that comparison is not of unmoved
# permutations
BATCH_CPU_MAX_N = 1024


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
    reports = build(["qap_objective", "pair_gain", "swap_gain",
                     "flash_attention", "flash_attention_sm90",
                     "host_alloc"])
    secs = time.perf_counter() - t0
    for name, text in reports.items():
        for line in text.splitlines():
            if any(k in line for k in ("registers", "smem", "spill",
                                       "Compiling entry")):
                print(f"ptxas[{name}] {line.strip()}", flush=True)
    emit({"phase": "build", "seconds": secs,
          "libraries": [str(library_path(n).relative_to(ROOT))
                        for n in reports],
          "qap_objective": ptxas_usage(reports["qap_objective"]),
          "pair_gain": ptxas_usage(reports["pair_gain"]),
          "swap_gain": dict(ptxas_usage(reports["swap_gain"]),
                            gain_tile_dynamic_smem=swap_gain_smem())})


def ptxas_usage(report: str) -> dict:
    """{entry name: {registers, spill_stores, spill_loads, static_smem}}
    from an ``-Xptxas -v`` report ({} for a library that was already
    built); the names are the report's own (mangled)."""
    import re
    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name].update(spill_stores=int(m.group(1)),
                             spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            out[name]["static_smem"] = int(m.group(1)) if m else 0
    return out


def swap_gain_smem() -> int:
    """Bytes of dynamic shared memory one K3 tile block asks for."""
    import ctypes

    from repro_torch.kernels.swap_gain import SWAP_GAIN_KERNEL
    fn = SWAP_GAIN_KERNEL.library().viem_swap_gain_smem
    fn.restype = ctypes.c_int
    return int(fn())


# ------------------------------------------------------------ timing
def cuda_ms(fn, iters: int = ITERS, warmup: int = 5) -> float:
    """Mean milliseconds per call over ``iters`` back-to-back calls,
    timed with CUDA events after ``warmup`` calls.  Where the host takes
    longer to enqueue a call than the card takes to run it, this is the
    host's rate (``device_ms`` is the kernel's)."""
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


def host_ms(fn, iters: int = ITERS, warmup: int = 5) -> float:
    """Mean host milliseconds per call of ``iters`` calls made without a
    synchronize (the wrapper's own cost: checks, arguments, launch)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    return secs / iters * 1e3


def device_ms(fn, iters: int = ITERS) -> dict:
    """Mean device milliseconds per call: a spin kernel
    (``torch.cuda._sleep``) holds the stream for twice the host's time
    to enqueue ``iters`` calls, so the CUDA events around the calls
    bracket the kernels run back to back, not the host's enqueue rate.
    Also the host time per call (``host_ms``)."""
    import torch
    host = host_ms(fn, iters)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    hold_s = 2.0 * host * iters / 1e3 + 1e-3
    torch.cuda._sleep(int(hold_s * 2.0e9))  # >= hold_s at clocks <= 2 GHz
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    enqueue_s = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    check(enqueue_s < hold_s, f"device_ms: enqueue took {enqueue_s} s, "
          f"longer than the {hold_s} s hold")
    return {"device_ms": start.elapsed_time(end) / iters, "host_ms": host}


def profile_calls(fn, iters: int = 20) -> dict:
    """torch.profiler over ``iters`` calls of ``fn``: the CUDA kernels
    it recorded per call, and by name each kernel's launches and mean
    device milliseconds.  {"error": ...} if the profiler records no
    device time here."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = [(e.key, e.self_device_time_total / 1e3, e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0]
    except (RuntimeError, AttributeError) as exc:
        return {"error": f"{type(exc).__name__}: {exc}"}
    if not rows:
        return {"error": "the profiler recorded no device time"}
    return {"calls": iters,
            "kernels_per_call": sum(c for _, _, c in rows) / iters,
            "by_name": {n[:80]: {"launches": c, "ms_each": ms / c}
                        for n, ms, c in rows}}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(bytes_moved: int, flops: float, peak: float = PEAK_FP32) -> tuple:
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    t_ops = flops / peak * 1e3
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


def table_entries(dg, perm, us, vs, D) -> int:
    """Bytes of the distance-table entries K2 reads for these pairs, each
    counted once: rows π_u and π_v against the columns π_k of both
    neighbor rows."""
    import torch
    perm_l = perm.long()
    n_pe = D.shape[0]
    seen = []
    for a, b in ((us, vs), (vs, us)):
        cols = perm_l[dg.nbr[a.long()].long()]            # (P, K)
        for r in (a, b):
            seen.append((perm_l[r.long()][:, None] * n_pe + cols)
                        .reshape(-1))
    return int(torch.unique(torch.cat(seen)).numel()) * D.element_size()


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
    call = lambda: qap_objective_edges(*args)  # noqa: E731
    # the kernel's device time apart from the wrapper's host time, and
    # the back-to-back figure of earlier runs (which is the slower of
    # the two rates)
    k1.update(device_ms(call))
    k1["ms"] = k1["device_ms"]
    k1["ms_back_to_back"] = cuda_ms(call)
    k1["profile"] = profile_calls(call)
    k1["plain_ms"] = cuda_ms(lambda: qap_objective_plain(*args))
    # per edge: eu, ev, ew once, the two perm entries it gathers (perm is
    # read once overall), and ~(k + 2) integer/float ops of the oracle
    k1["bound_ms"], k1["bound_by"] = bound(
        nbytes(eu, ev, ew, perm, D) + 4, e * 2.0)
    k1["share_of_bound"] = k1["bound_ms"] / k1["ms"]

    t0 = time.perf_counter()
    pairs = communication_pairs(g, 10)
    pairs_seconds = time.perf_counter() - t0
    check(len(pairs) == SIZE["pairs"],
          f"main-path pair count {len(pairs)}")
    dg = DeviceGraph.from_comm(g, device=dev)
    us, vs = device_pairs(pairs, device=dev)
    p, kdeg = int(us.shape[0]), dg.max_deg
    check(kdeg == SIZE["ell"], f"main-path ELL width {kdeg}")
    k2 = {"max_abs_err": 0.0, "forms": {}}
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
        call = lambda: pair_gains(*args)  # noqa: E731
        rec = dict(device_ms(call), ms_back_to_back=cuda_ms(call),
                   plain_ms=cuda_ms(lambda: pair_gains_plain(*args),
                                    iters=10, warmup=2),
                   profile=profile_calls(call), abs_err=err)
        # bytes: us, vs, nbr, wgt, perm once, the gains written once, and
        # for a table the entries this run's pairs read, each once;
        # operations: per pair and side K slots of (sub, mul, add)
        table = table_entries(dg, perm, us, vs, D) if kind == "matrix" \
            else 0
        rec["bound_ms"], rec["bound_by"] = bound(
            nbytes(us, vs, dg.nbr, dg.wgt, perm) + table + p * 4,
            p * 2.0 * kdeg * 3.0)
        rec["share_of_bound"] = rec["bound_ms"] / rec["device_ms"]
        rec["table_bytes_read"] = table
        k2["forms"][name] = rec
        emit({"phase": "kernels", "kernel": "pair_gains", "form": name,
              "P": p, "K": kdeg, "positive": int(torch.sum(got > 0)),
              "host_pairs_seconds": pairs_seconds, **rec})
    # the main path's form: the tree
    main = k2["forms"]["tree"]
    k2.update(ms=main["device_ms"], plain_ms=main["plain_ms"],
              bound_ms=main["bound_ms"], bound_by=main["bound_by"])
    for rec in (k1, k2):
        rec["library_ms"] = None        # no single PyTorch call computes it
    lane_axis(forms, k1, k2, g, dg, us, vs, eu, ev)
    emit({"phase": "kernels", "qap_objective": k1, "pair_gains": k2})
    return k1, k2


def lane_axis(forms, k1, k2, g, dg, us, vs, eu, ev):
    """K2 in the tree form and K1 at the main shape with LANES lanes in
    one launch each (the batched sweep's calls).  Every lane has its own
    structure: lane 0 is the main graph and each other lane the main
    graph with its vertices relabelled by a seeded permutation (its own
    ELL rows, edge list and candidate pairs, the main shape's K, E and
    P), with seeded permutations and real weights a lane.  Each lane
    bit-equal to a single launch on that lane's arrays; the device time
    per launch beside the sum of the lanes' single launches (the
    relabelled lanes lose the stencil's locality, so they are timed
    each) and the bound at LANES times the bytes.  Adds ``batch_ms`` (and the rest under ``lanes``) to
    ``k1`` and ``k2``."""
    import numpy as np
    import torch

    from repro_torch.core import DeviceGraph, from_edges
    from repro_torch.kernels import pair_gains, qap_objective_edges
    from repro_torch.kernels.pad import pad_edge_arrays
    dev = torch.device(DEVICE)
    b, n = LANES, g.n
    rng = np.random.default_rng(23)
    kind, params, D = form_of(*forms["tree"], dev)
    u, v, w = g.edge_list()
    lanes = [(dg, us, vs, eu, ev)]
    for _ in range(b - 1):
        relabel = rng.permutation(n)
        gl = from_edges(n, relabel[u], relabel[v], w)
        dgl = DeviceGraph.from_comm(gl, device=dev)
        ul, vl, _ = gl.edge_list()
        eul, evl, _ = pad_edge_arrays(ul, vl, np.ones(len(ul)), device=dev)
        r = torch.from_numpy(relabel.astype(np.int32)).to(dev)
        lanes.append((dgl, r[us.long()], r[vs.long()], eul, evl))
    check(len({(x.max_deg, int(e.shape[0]), int(a.shape[0]))
               for x, a, _, e, _ in lanes}) == 1,
          "lane axis: the relabelled lanes left the main shape")
    perms = torch.from_numpy(np.stack([rng.permutation(n) for _ in range(b)])
                             .astype(np.int32)).to(dev)
    factor = torch.from_numpy(rng.random((b,) + tuple(dg.wgt.shape))
                              .astype(np.float32) * 3.0 + 0.5).to(dev)
    wgt = (torch.stack([x.wgt for x, *_ in lanes]) * factor).contiguous()
    nbr = torch.stack([x.nbr for x, *_ in lanes]).contiguous()
    us_b = torch.stack([x for _, x, *_ in lanes]).contiguous()
    vs_b = torch.stack([x for _, _, x, *_ in lanes]).contiguous()
    e = int(eu.shape[0])
    ew_b = torch.from_numpy(rng.random((b, e)).astype(np.float32) * 3.0
                            ).to(dev)
    ew_b[:, g.num_edges:] = 0.0                     # padding stays inert
    eu_b = torch.stack([x for *_, x, _ in lanes]).contiguous()
    ev_b = torch.stack([x for *_, x in lanes]).contiguous()
    p = int(us.shape[0])
    cases = {
        "pair_gains": (
            lambda: pair_gains(kind, params, nbr, wgt, perms, us_b, vs_b, D),
            lambda i: pair_gains(kind, params, nbr[i], wgt[i], perms[i],
                                 us_b[i], vs_b[i], D),
            # a lane's bytes as the single launch counts them
            (nbytes(us, vs, dg.nbr, dg.wgt, perms[0]) + p * 4,
             p * 2.0 * dg.max_deg * 3.0), k2),
        "qap_objective": (
            lambda: qap_objective_edges(kind, params, eu_b, ev_b, ew_b,
                                        perms, D),
            lambda i: qap_objective_edges(kind, params, eu_b[i], ev_b[i],
                                          ew_b[i], perms[i], D),
            (nbytes(eu, ev, ew_b[0], perms[0], D) + 4, e * 2.0), k1)}
    for name, (batch, single, (lane_bytes, lane_ops), rec) in cases.items():
        got = batch()
        for i in range(b):
            check(torch.equal(got[i], single(i)),
                  f"{name}: lane {i} of {b} differs from its single launch")
        ones = [device_ms(lambda i=i: single(i))["device_ms"]
                for i in range(b)]
        rec["lanes"] = dict(device_ms(batch), lanes=b,
                            single_device_ms=ones[0],
                            lane_single_device_ms=ones,
                            singles_device_ms=sum(ones),
                            bit_equal_to_singles=True,
                            own_structure_a_lane=True)
        rec["lanes"]["bound_ms"], rec["lanes"]["bound_by"] = bound(
            b * lane_bytes, b * lane_ops)
        rec["batch_ms"] = rec["lanes"]["device_ms"]
        emit({"phase": "kernels", "kernel": name, "lanes": rec["lanes"]})


# ------------------------------------------------------------ phase 4/5
# the kernels each driven path must launch
MAP_KERNELS = ("qap_objective", "pair_gains")
GAIN_KERNELS = ("swap_gain_matrix",)
SERVE_KERNELS = ("flash_attention",)            # K4, bf16 route
F32_KERNELS = ("flash_attention_f32",)          # K4, float32 route


def reset_launches() -> None:
    from repro_torch.kernels import KERNELS
    for k in KERNELS.values():
        k.launches = 0


def read_launches() -> dict:
    from repro_torch.kernels import KERNELS
    return {name: k.launches for name, k in KERNELS.items()}


def check_launched(launches: dict, expected, label: str) -> None:
    for name in expected:
        check(launches[name] > 0, f"{label}: kernel {name} was never "
                                  f"launched on this path")


def run_map(topo, g, label, compare_cpu):
    """One ``Mapper.map`` on the card with the launch counts reset just
    before and read just after; optionally the same refinement on the
    CPU (plain versions) from the captured start.  Returns the phase
    record, the final permutation and the candidate pairs."""
    import numpy as np
    import torch

    from repro_torch.core import Mapper, MappingSpec, qap_objective
    from repro_torch.engine import RefinementEngine
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
    reset_launches()
    t0 = time.perf_counter()
    res = mapper.map(g)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
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
    check_launched(launches, MAP_KERNELS, label)
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
    return out, perm, captured["pairs"]


# ------------------------------------------------------ phases 6-8
def instrument(engines):
    """Wrap each engine's ``refine_batch`` (which a single ``refine``
    also goes through) to record every call: its inputs (copies of the
    starts), its results, its seconds (ending in a synchronize), the
    K1/K2 launches it made and the engine's sync counts after it.
    Returns (the list the calls are appended to, a function that
    restores the engines)."""
    import numpy as np
    import torch
    calls, restore = [], []

    def wrap(eng):
        orig = eng.refine_batch

        def recording(graphs, perms, pairs_list, **kw):
            rec = {"engine": eng, "graphs": list(graphs),
                   "perms0": [np.array(p) for p in perms],
                   "pairs": [np.array(x) for x in pairs_list], "kw": kw}
            before = read_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(graphs, perms, pairs_list, **kw)
            torch.cuda.synchronize()
            rec["seconds"] = time.perf_counter() - t0
            after = read_launches()
            rec["launches"] = {k: after[k] - before[k] for k in MAP_KERNELS}
            rec["syncs"] = dict(eng.last_syncs)
            rec["stats"] = out
            rec["perms_out"] = [np.array(p) for p in perms]  # in place
            calls.append(rec)
            return out
        eng.refine_batch = recording
        restore.append((eng, orig))

    for eng in engines:
        wrap(eng)

    def undo():
        for eng, orig in restore:
            eng.refine_batch = orig
    return calls, undo


def cpu_equal(rec, label):
    """Refine the captured starts again on the CPU (the plain versions)
    with the same machine, budget, kernel configuration and arguments,
    and hold the card's permutations, traces and swap counts to it.
    Returns the CPU seconds."""
    import numpy as np

    from repro_torch.engine import RefinementEngine
    eng = rec["engine"]
    ref = RefinementEngine(eng.topology, max_sweeps=eng.max_sweeps,
                           kernel_config=eng.kernel_config, device="cpu")
    perms = [p.copy() for p in rec["perms0"]]
    t0 = time.perf_counter()
    stats = ref.refine_batch(rec["graphs"], perms, rec["pairs"], **rec["kw"])
    secs = time.perf_counter() - t0
    for i, (p_cpu, s_cpu, s_gpu) in enumerate(zip(perms, stats,
                                                  rec["stats"])):
        check(s_cpu.objective_trace == s_gpu.objective_trace and
              s_cpu.swaps == s_gpu.swaps,
              f"{label}: lane {i}: card and CPU traces/swaps differ")
        check(np.array_equal(p_cpu, rec["perms_out"][i]),
              f"{label}: lane {i}: card and CPU permutations differ")
    return secs


def check_counted(syncs, label):
    """A counted scope's host syncs (an engine call's or a
    contraction's): every one PyTorch's sync debug mode saw was a
    counted read."""
    check(syncs["observed"] == syncs["reads"],
          f"{label}: {syncs['observed']} syncs observed against "
          f"{syncs['reads']} counted reads")


def ml_spec():
    from repro_torch.core import MappingSpec, MultilevelSpec
    return MappingSpec(engine="device", backend="pallas",
                       multilevel=MultilevelSpec(), preconfiguration="eco")


def phase_multilevel(topo, g, flat_jf):
    """``Mapper(..., multilevel=MultilevelSpec(), preconfiguration="eco")
    .map(g)`` at the main cell's n: every level's refinement equals the
    plain versions' on the CPU from the same start, the result is a
    bijection and jf the host float64 objective; the construction,
    pyramid and per-level refinement seconds, the launches and syncs
    per level, the coarse tables' packing and jf beside the flat map's."""
    import torch

    from repro_torch.core import Mapper, qap_objective
    mapper = Mapper(topo, ml_spec(), device=DEVICE)
    plan = mapper.lower_for(g)
    calls, undo = instrument(plan.engines)
    pyramid_s = {}
    orig_pyramid = plan._pyramid

    def timed_pyramid(g_, seed):
        t0 = time.perf_counter()
        out = orig_pyramid(g_, seed)
        pyramid_s["seconds"] = time.perf_counter() - t0
        return out
    plan._pyramid = timed_pyramid
    reset_launches()
    t0 = time.perf_counter()
    res = mapper.map(g)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    undo()
    plan._pyramid = orig_pyramid
    perm = res.perm
    check(sorted(perm.tolist()) == list(range(g.n)),
          "multilevel: result is not a bijection")
    jf_host = qap_objective(g, topo, perm)
    check(res.final_objective == jf_host,
          f"multilevel: jf {res.final_objective} != host {jf_host}")
    check_launched(launches, MAP_KERNELS, "multilevel")
    pyramid = orig_pyramid(g, plan.spec.seed)          # the cached one
    check(len(calls) == len(pyramid) == len(plan.engines),
          f"multilevel: {len(calls)} refinements for {len(pyramid)} "
          f"levels")
    levels = []
    check([(st.initial_objective, st.final_objective, st.swaps)
           for st in (rec["stats"][0] for rec in calls)]
          == list(ML_REFERENCE_LEVELS),
          "multilevel: the levels' objectives and swaps are not the "
          "reference's")
    # the V-cycle refines the coarsest level first
    for rec, lvl in zip(calls, range(len(pyramid) - 1, -1, -1)):
        stats = rec["stats"][0]
        check_counted(rec["syncs"], f"multilevel level {lvl}")
        if lvl:
            check_counted(pyramid[lvl].syncs,
                          f"multilevel contraction to level {lvl}")
        levels.append({"level": lvl, "n": pyramid[lvl].graph.n,
                       "pairs": len(rec["pairs"][0]),
                       "refine_seconds": rec["seconds"],
                       "launches": rec["launches"],
                       "reads": rec["syncs"]["reads"],
                       "syncs_observed": rec["syncs"]["observed"],
                       "passes": rec["syncs"]["passes"],
                       "swaps": stats.swaps,
                       "j0": stats.initial_objective,
                       "jf": stats.final_objective,
                       "contraction_syncs": pyramid[lvl].syncs,
                       "packing": plan.kernel_configs[lvl].dist_dtype
                       or "float32",
                       "cpu_refine_seconds": cpu_equal(
                           rec, f"multilevel level {lvl}"),
                       "equals_cpu": True, "equals_reference": True})
    out = {"phase": "multilevel", "n": g.n,
           "levels_built": len(pyramid),
           "resolved": list(plan.spec.resolved_multilevel()),
           "j0": res.initial_objective, "jf": res.final_objective,
           "flat_jf": flat_jf, "jf_over_flat": res.final_objective / flat_jf,
           "construction_seconds": res.construction_seconds,
           "pyramid_seconds": pyramid_s.get("seconds"),
           "search_seconds": res.search_seconds, "map_seconds": wall,
           "launches": launches, "levels": levels,
           "packing": [cfg.dist_dtype or "float32"
                       for cfg in plan.kernel_configs]}
    emit(out)
    return out


def batch_graphs(side_xy, side_z, radius, seed):
    """LANES - 1 stencils with their own seeded integer weights and one
    random geometric graph of the same n (mean degree near the
    stencil's)."""
    import numpy as np

    from repro_torch.core import from_edges, grid3d, random_geometric
    lo, hi = BATCH["weights"]
    stencil = grid3d(side_xy, side_xy, side_z)
    u, v, _ = stencil.edge_list()
    rng = np.random.default_rng(seed)
    graphs = [from_edges(stencil.n, u, v,
                         rng.integers(lo, hi + 1, len(u)) * 1.0)
              for _ in range(LANES - 1)]
    graphs.append(random_geometric(stencil.n, radius, seed=seed))
    return graphs


def run_batch(topo, spec, graphs, label, cpu_max_n=0):
    """``map_many`` of the graphs on the card, then each graph's single
    card map: each batch result must equal its single map exactly.
    Launch counts reset just before each and read just after; every
    engine call's syncs must all be counted reads.  Each engine call of
    the batch at n <= ``cpu_max_n`` is refined again on the CPU from its
    captured starts and must equal it, and those calls must have swapped
    something."""
    import numpy as np
    import torch

    from repro_torch.core import Mapper, qap_objective
    mapper = Mapper(topo, spec, device=DEVICE)
    bucket = mapper.bucket_of(graphs[0])
    for g in graphs[1:]:
        bucket = bucket.union(mapper.bucket_of(g))
    plan = mapper.lower(bucket)
    calls, undo = instrument(plan.engines)
    reset_launches()
    t0 = time.perf_counter()
    many = mapper.map_many(graphs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    undo()
    check_launched(launches, MAP_KERNELS, label)
    reads = sum(c["syncs"]["reads"] for c in calls)
    passes = sum(c["syncs"]["passes"] for c in calls)
    for c in calls:
        check(len(c["graphs"]) == len(graphs),
              f"{label}: a level refined {len(c['graphs'])} of "
              f"{len(graphs)} graphs in one call")
        check_counted(c["syncs"], label)
    compared = [c for c in calls if c["graphs"][0].n <= cpu_max_n]
    cpu_s = [cpu_equal(c, f"{label} n = {c['graphs'][0].n}")
             for c in compared]
    cpu_swaps = [[st.swaps for st in c["stats"]] for c in compared]
    if cpu_max_n:
        check(compared and sum(map(sum, cpu_swaps)) > 0,
              f"{label}: the levels held to the CPU swapped nothing")
    singles, single_launches, single_s = [], {k: 0 for k in MAP_KERNELS}, []
    for i, g in enumerate(graphs):
        reset_launches()
        t1 = time.perf_counter()
        one = mapper.map(g)
        torch.cuda.synchronize()
        single_s.append(time.perf_counter() - t1)
        got = read_launches()
        for k in MAP_KERNELS:
            single_launches[k] += got[k]
        b = many[i]
        check(np.array_equal(b.perm, one.perm) and
              b.final_objective == one.final_objective and
              b.initial_objective == one.initial_objective and
              b.search_stats.objective_trace ==
              one.search_stats.objective_trace,
              f"{label}: map_many result {i} differs from its single map")
        check(b.final_objective == qap_objective(g, topo, b.perm),
              f"{label}: result {i}: jf is not the host objective")
        singles.append(one)
    out = {"phase": label, "n": graphs[0].n, "graphs": len(graphs),
           "edges": [g.num_edges for g in graphs],
           "mean_degree": [2.0 * g.num_edges / g.n for g in graphs],
           "bucket": plan.bucket.tag(),
           "levels": len(plan.engines),
           "jf": [r.final_objective for r in many],
           "batch_seconds": wall, "batch_seconds_per_graph":
           wall / len(graphs), "single_seconds": single_s,
           "single_seconds_mean": sum(single_s) / len(single_s),
           "batch_launches": {k: launches[k] for k in MAP_KERNELS},
           "single_launches_sum": single_launches,
           "engine_calls": len(calls),
           "refine_seconds": [c["seconds"] for c in calls],
           "reads": reads, "passes": passes,
           "reads_per_pass": reads / max(passes, 1),
           "reads_by_call": [c["syncs"]["reads"] for c in calls],
           "syncs_observed_by_call": [c["syncs"]["observed"] for c in calls],
           "swaps_by_call": [[st.swaps for st in c["stats"]] for c in calls],
           "cpu_compared_n": [c["graphs"][0].n for c in compared],
           "cpu_compared_swaps": cpu_swaps, "cpu_refine_seconds": cpu_s,
           "equals_singles": True}
    emit(out)
    return out


def phase_batch(topo):
    """The multilevel batch at the main cell's n on the main machine,
    then the flat batch at n = 1024 on the torus form."""
    from repro_torch.core import MappingSpec
    from repro_torch.topology import TorusTopology
    side = SIZE["side"]
    ml = run_batch(topo, ml_spec(), batch_graphs(
        side, side, BATCH["radius"], BATCH["seed"]), "batch:multilevel",
        cpu_max_n=BATCH_CPU_MAX_N)
    flat = run_batch(TorusTopology((side, side, side // 4)),
                     MappingSpec(engine="device", backend="pallas"),
                     batch_graphs(side, side // 4, BATCH["flat_radius"],
                                  BATCH["seed"] + 1), "batch:flat-torus")
    return ml, flat


def phase_warm(topo, g, perm, pairs):
    """``execute_warm`` on the main map's result after a drift at a
    seeded WARM["share"] of the vertices (WARM's note), with the pairs
    touching those vertices active: equal to the CPU warm refinement from
    the same incumbent, the incumbent unchanged, P unchanged, the
    inactive region frozen."""
    import numpy as np
    import torch

    from repro_torch.core import Mapper, MappingSpec, from_edges
    spec = MappingSpec(engine="device", backend="pallas",
                       max_sweeps=WARM["max_sweeps"])
    rng = np.random.default_rng(WARM["seed"])
    hot_ids = rng.choice(g.n, int(WARM["share"] * g.n), replace=False)
    hot = np.zeros(g.n, bool)
    hot[hot_ids] = True
    partner = (hot_ids + rng.integers(1, g.n, len(hot_ids))) % g.n
    u, v, w = g.edge_list()
    live = from_edges(g.n, np.concatenate([u, hot_ids]),
                      np.concatenate([v, partner]),
                      np.concatenate([w, np.full(len(hot_ids),
                                                 WARM["factor"])]))
    active = hot[pairs[:, 0]] | hot[pairs[:, 1]]
    incumbent = perm.copy()
    mapper = Mapper(topo, spec, device=DEVICE)
    plan = mapper.lower_for(live)
    calls, undo = instrument(plan.engines)
    reset_launches()
    t0 = time.perf_counter()
    res = plan.execute_warm(live, incumbent, pairs=pairs, active=active)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    undo()
    check_launched(launches, MAP_KERNELS, "warm")
    check(np.array_equal(incumbent, perm), "warm: the incumbent changed")
    check(len(calls) == 1 and len(calls[0]["pairs"][0]) == len(pairs),
          "warm: the refined pair set is not the fixed one (P changed)")
    check_counted(calls[0]["syncs"], "warm")
    movable = np.zeros(g.n, bool)
    movable[pairs[active].ravel()] = True
    check(np.array_equal(res.perm[~movable], perm[~movable]),
          "warm: a vertex outside every active pair moved")
    check(res.final_objective <= res.initial_objective,
          "warm: jf above j0")
    cpu = Mapper(topo, spec, device="cpu").lower_for(live)
    t1 = time.perf_counter()
    ref = cpu.execute_warm(live, perm, pairs=pairs, active=active)
    cpu_s = time.perf_counter() - t1
    check(np.array_equal(ref.perm, res.perm) and
          ref.final_objective == res.final_objective and
          ref.initial_objective == res.initial_objective and
          ref.search_stats.objective_trace ==
          res.search_stats.objective_trace,
          "warm: card and CPU warm refinements differ")
    out = {"phase": "warm", "n": g.n, "pairs": len(pairs),
           "active_pairs": int(active.sum()), "hot_vertices": int(hot.sum()),
           "movable_vertices": int(movable.sum()),
           "moved_vertices": int(np.sum(res.perm != perm)),
           "j0": res.initial_objective, "jf": res.final_objective,
           "sweeps": calls[0]["syncs"]["sweeps"],
           "reads": calls[0]["syncs"]["reads"],
           "syncs_observed": calls[0]["syncs"]["observed"],
           "refine_seconds": calls[0]["seconds"], "warm_seconds": wall,
           "cpu_warm_seconds": cpu_s, "launches": launches,
           "equals_cpu": True, "incumbent_unchanged": True,
           "inactive_frozen": True}
    emit(out)
    return out


# ------------------------------------------------------------ phase 9
def _host_s(fn):
    """(result, seconds) of ``fn()`` ending in a device synchronize."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def ragged_instance(n: int, seed: int, density: float = 0.3):
    """A random symmetric C of the given density and a random symmetric
    D with a zero diagonal, and a permutation — the JAX package's kernel
    test instance (``tests/test_kernels.py``)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    C = np.triu(rng.random((n, n)) * (rng.random((n, n)) < density), 1)
    C = C + C.T
    D = np.triu(rng.random((n, n)), 1)
    D = D + D.T
    return C, D, rng.permutation(n)


def warm_calls(call, reps: int = 5, hold: bool = False) -> dict:
    """Host seconds of ``reps`` calls: their least, median and largest,
    and each one, with what each call did to page-locked memory and the
    gen-2 garbage collections during it.  Page-locked memory: the blocks
    PyTorch's caching host allocator made and freed, and the port's own
    pool (``core/pinned.py``): blocks allocated, freed and reused, and
    its bytes pinned after the call.  Each result is dropped before the
    next call starts, unless ``hold``, when the caller keeps the previous
    result while the next call runs."""
    import gc
    import statistics

    import torch

    from repro_torch.core import pinned

    def counts():
        h, p = torch.cuda.host_memory_stats(), pinned.stats()
        return (h.get("num_host_alloc", 0), h.get("num_host_free", 0),
                gc.get_stats()[2]["collections"], p["host_allocs"],
                p["host_frees"], p["reuses"])
    secs, events, pinned_after, kept = [], [], [], None
    for _ in range(reps):
        before = counts()
        out, s = _host_s(call)
        secs.append(s)
        events.append([b - a for a, b in zip(before, counts())])
        kept = out if hold else None
        del out
        pinned_after.append(pinned.stats()["pinned_bytes"])
    del kept
    return {"min": min(secs), "median": statistics.median(secs),
            "max": max(secs), "calls": secs,
            "torch_allocs_frees_gc2_own_allocs_frees_reuses": events,
            "own_pinned_bytes_after": pinned_after}


def phase_gain(topo, g, perm, pairs, forms):
    """``Mapper.gain_matrix`` on the main map's graph, machine and final
    permutation through K3, held against the plain version, the host
    float64 formula and K2; then the integer-edge cell, the ragged
    real-valued case, the times and the call's split."""
    import numpy as np
    import torch

    from repro_torch.core import (DeviceGraph, Mapper, MappingSpec,
                                  dense_gain_matrix, device_pairs,
                                  from_edges)
    from repro_torch.kernels import pair_gains
    from repro_torch.core.plan import read_back
    from repro_torch.kernels.ops import comm_matrix, permuted_distances
    from repro_torch.kernels.ref import SWAP_GAIN_REL, swap_gain_limits
    from repro_torch.kernels.swap_gain import (swap_gain_matrix,
                                               swap_gain_matrix_plain)
    dev = torch.device(DEVICE)
    n = g.n
    mapper = Mapper(topo, MappingSpec(engine="device", backend="pallas"),
                    device=DEVICE)
    reset_launches()
    G, cold_s = _host_s(lambda: mapper.gain_matrix(g, perm))
    launches = read_launches()
    check_launched(launches, GAIN_KERNELS, "gain")
    check(launches["swap_gain_matrix"] == 1,
          f"gain: K3 launched {launches['swap_gain_matrix']} times, "
          f"expected once")
    check(G.shape == (n, n) and G.dtype == np.float32,
          f"gain: G is {G.shape} {G.dtype}")
    check(bool(np.all(np.isfinite(G))), "gain: G has non-finite entries")
    check(np.array_equal(G, G.T), "gain: G is not symmetric")
    check(bool(np.all(np.diag(G) == 0.0)), "gain: G has a nonzero diagonal")

    # the call's parts, each timed alone with the same functions
    D = torch.from_numpy(np.asarray(topo.matrix(), dtype=np.float32)).to(dev)
    C, scatter_s = _host_s(lambda: comm_matrix(g, dev))
    B, gather_s = _host_s(lambda: permuted_distances(D, perm))
    Gd = swap_gain_matrix(C, B)
    # the call's page-locked readback, and the pageable ``.cpu()`` it
    # replaced as the yardstick; each twice, results dropped between
    readback = {"page_locked": warm_calls(lambda: read_back(Gd), reps=2),
                "pageable": warm_calls(lambda: Gd.cpu().numpy(), reps=2)}
    plain = swap_gain_matrix_plain(C, B).cpu().numpy()
    check(np.array_equal(G, plain), "gain: K3 != plain version on the card "
          f"(max {float(np.max(np.abs(G - plain)))})")
    C_host = g.to_dense()
    check(np.array_equal(C.cpu().numpy(), C_host.astype(np.float32)),
          "gain: the device C differs from to_dense()")
    G_host = dense_gain_matrix(C_host, topo.matrix(), perm)
    check(np.array_equal(G.astype(np.float64), G_host),
          "gain: K3 != host float64 dense_gain_matrix (max "
          f"{float(np.max(np.abs(G - G_host)))})")
    # the dense form against the paper's sparse form (K2) at the main
    # map's candidate pairs; positive = the objective drops, in both
    kind, params, Dk = form_of(*forms["tree"], dev)
    dg = DeviceGraph.from_comm(g, device=dev)
    us, vs = device_pairs(pairs, device=dev)
    p_dev = torch.from_numpy(np.asarray(perm, dtype=np.int32)).to(dev)
    sparse = pair_gains(kind, params, dg.nbr, dg.wgt, p_dev, us, vs, Dk)
    sparse = sparse[:len(pairs)].cpu().numpy()
    dense = G[pairs[:, 0], pairs[:, 1]]
    check(np.array_equal(dense, sparse),
          "gain: G at the candidate pairs != K2 pair_gains (max "
          f"{float(np.max(np.abs(dense - sparse)))})")
    del G_host

    # the integer-edge cell: the same graph, machine and permutation with
    # seeded integer weights in [2¹¹, 2¹⁴) (more significant bits than
    # TF32 keeps, so only the 3xTF32 split holds them).  It lies beyond
    # the contract's condition (S(u,v) reaches past 2²⁴ here, counted in
    # ``entries_scale_at_least_2^24``), so its exactness is this data's,
    # not the contract's: the card tests' "edge" instances hold the
    # contract itself.
    u, v, _ = g.edge_list()
    w_int = np.random.default_rng(0).integers(2 ** 11, 2 ** 14, len(u))
    g_int = from_edges(n, u, v, w_int.astype(np.float64))
    reset_launches()
    Ge = mapper.gain_matrix(g_int, perm)
    edge_launches = read_launches()["swap_gain_matrix"]
    check(edge_launches == 1, f"gain: integer-edge K3 launched "
          f"{edge_launches} times, expected once")
    Ce = comm_matrix(g_int, dev)
    scale = swap_gain_limits(Ce, B) / SWAP_GAIN_REL
    edge = {"n": n, "launches": edge_launches,
            "max_scale_over_2^24": float(scale.max()) / 2.0 ** 24,
            "entries_scale_at_least_2^24": int((scale >= 2.0 ** 24).sum())}
    del scale
    Ge_host = dense_gain_matrix(g_int.to_dense(), topo.matrix(), perm)
    check(np.array_equal(Ge.astype(np.float64), Ge_host),
          "gain: integer-edge K3 != host float64 dense_gain_matrix (max "
          f"{float(np.max(np.abs(Ge - Ge_host)))}, at "
          f"{int(np.sum(Ge != Ge_host))} entries)")
    check(np.array_equal(Ge, swap_gain_matrix_plain(Ce, B).cpu().numpy()),
          "gain: integer-edge K3 != plain version on the card")
    check(np.array_equal(Ge, Ge.T), "gain: integer-edge G not symmetric")
    edge["equals_host_float64"] = True
    del Ge, Ge_host, Ce

    # ragged, real-valued: within the float32 dot-product bound of the
    # plain version and the per-element limit of the float64 G
    nr = 1000
    Cr, Dr, pr = ragged_instance(nr, nr)
    Crt = torch.from_numpy(Cr.astype(np.float32)).to(dev)
    Brt = permuted_distances(torch.from_numpy(Dr.astype(np.float32))
                             .to(dev), pr)
    got, want = swap_gain_matrix(Crt, Brt), swap_gain_matrix_plain(Crt, Brt)
    real_err = float(torch.max(torch.abs(got - want)))
    real_tol = nr * 2.0 ** -22 * float(torch.max(Crt.abs() @ Brt.abs().T))
    check(real_err <= real_tol, f"gain: ragged real n = {nr}: max |K3 - "
          f"plain| = {real_err} > {real_tol}")
    exact = torch.from_numpy(dense_gain_matrix(
        Cr.astype(np.float32).astype(np.float64),
        Dr.astype(np.float32).astype(np.float64), pr)).to(dev)
    limit = swap_gain_limits(Crt, Brt)
    share = float(((got.double() - exact).abs() / limit).max())
    plain_share = float(((want.double() - exact).abs() / limit).max())
    check(share <= 1.0, f"gain: ragged real n = {nr}: |K3 - float64| "
          f"beyond 2^-18 S(u,v) by {share}x")
    check(torch.equal(got, got.T), f"gain: ragged real n = {nr}: G is not "
          f"bit-symmetric")
    check(torch.equal(got, swap_gain_matrix(Crt, Brt)),
          f"gain: ragged real n = {nr}: two launches differ")

    ms = cuda_ms(lambda: swap_gain_matrix(C, B), iters=20, warmup=2)
    plain_ms = cuda_ms(lambda: swap_gain_matrix_plain(C, B), iters=20,
                       warmup=2)
    library_ms = cuda_ms(lambda: torch.mm(C, B.T), iters=20, warmup=2)
    ms_again = cuda_ms(lambda: swap_gain_matrix(C, B), iters=20, warmup=2)
    # bytes: C and B read once, G written once; operations: one n×n×n
    # product (2n³) on the tensor cores at their TF32 peak.  Beside it,
    # two design figures: the three TF32 products of the 3xTF32 split
    # (3·2n³) on the tensor cores, and 2n³ on the fp32 CUDA cores
    useful = 2.0 * n ** 3
    moved = nbytes(C, B) + n * n * 4
    bound_ms, bound_by = bound(moved, useful, PEAK_TF32)
    bound_3xtf32_ms, _ = bound(moved, 3.0 * useful, PEAK_TF32)
    bound_fp32_ms, _ = bound(moved, useful)
    rec = {"max_abs_err": max(float(np.max(np.abs(G - plain))), real_err),
           "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, "bound_by": bound_by}
    del Gd, plain

    # the warm call, 5 times with each result dropped before the next
    # call, and 5 times with the caller holding the previous result
    del G
    call = lambda: mapper.gain_matrix(g, perm)  # noqa: E731
    emit({"phase": "gain", "n": n, "launches": launches,
          "call_seconds_cold": cold_s,
          "warm_call_seconds": warm_calls(call),
          "warm_call_seconds_holding_previous": warm_calls(call, hold=True),
          "split_seconds": {"scatter_C": scatter_s, "gather_B": gather_s,
                            "kernel": ms / 1e3, "readback": readback},
          "equals_plain": True, "equals_host_float64": True,
          "bit_symmetric": True,
          "equals_pair_gains_at_pairs": len(pairs),
          "positive_pairs": int(np.sum(dense > 0)),
          "integer_edge": edge,
          "ragged_real": {"n": nr, "max_abs_err": real_err,
                          "tol": real_tol,
                          "max_share_of_element_limit": share,
                          "plain_max_share_of_element_limit": plain_share},
          "library_call": "torch.mm(C, B.T), TF32 off: the one 2n³ product",
          "tf32": torch.backends.cuda.matmul.allow_tf32,
          "tflops_of_2n3": useful / (ms * 1e-3) / 1e12,
          "share_of_bound": bound_ms / ms, "ms_again": ms_again,
          "bound_3xtf32_ms": bound_3xtf32_ms,
          "share_of_3xtf32_bound": bound_3xtf32_ms / ms,
          "bound_fp32_cuda_cores_ms": bound_fp32_ms,
          "kernel": rec})
    return rec, launches

# ------------------------------------------------------------ phase 10
# K4 at the serve phase's prefill shape (granite-3-8b, B 4 x T 2048), bf16
# and float32 (the float32 check's shape), and at starcoder2-7b's
# sliding-window attention (T 8192, window 4096), bf16; small cases at
# float32 and bf16: T ragged against the 64-row float32 tiles and the
# 128-row bf16 tiles, T = 1, G = 1 with a window, MQA, and T = 64 (one kv
# tile per query row, so both sides round the same p).
# (b, t, h, kv, hd, window)
FLASH_SHAPES = {"serve": ((4, 2048, 32, 8, 128, 0), "bfloat16"),
                "window": ((1, 8192, 36, 4, 128, 4096), "bfloat16"),
                "serve-f32": ((4, 2048, 32, 8, 128, 0), "float32")}
FLASH_SMALL = {"ragged": (2, 333, 8, 2, 64, 0),
               "g1-window": (1, 200, 4, 4, 32, 48),
               "mqa": (2, 130, 8, 1, 128, 0),
               "one-tile": (4, 64, 32, 8, 128, 0),
               "one-tile-window": (2, 64, 8, 2, 96, 16),
               "t1": (2, 1, 8, 2, 128, 0),
               "t127": (2, 127, 8, 2, 128, 0),
               "t128": (2, 128, 8, 2, 128, 0),
               "t129": (2, 129, 6, 2, 96, 0),
               "t4500-window": (1, 4500, 8, 2, 128, 4096)}
FLASH_F32_TOL = 2e-5    # the same float32 terms summed in other orders


def visible_pairs(t: int, window: int) -> int:
    """(query, key) pairs per head that the causal (window) mask keeps."""
    if window <= 0 or window >= t:
        return t * (t + 1) // 2
    return window * (window + 1) // 2 + (t - window) * window


def flash_case(shape, dtype, seed):
    """K4 against its plain version on seeded inputs.  float32: max |Δ| ≤
    FLASH_F32_TOL.  bfloat16: every |Δ| within its element's limit and
    the mean |Δ| within the mean limit of ``flash_bf16_limits``."""
    import torch

    from repro_torch.kernels import flash_attention_kernel
    from repro_torch.kernels.ref import (flash_attention_plain,
                                         flash_bf16_limits)
    from repro_torch.kernels import FLASH_F32_KERNEL, FLASH_KERNEL
    b, t, h, kv, hd, window = shape
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    q, k, v = (torch.randn((b, t, n, hd), generator=gen, device=DEVICE)
               .to(dtype) for n in (h, kv, kv))
    route, other = ((FLASH_KERNEL, FLASH_F32_KERNEL)
                    if dtype == torch.bfloat16
                    else (FLASH_F32_KERNEL, FLASH_KERNEL))
    before, before_other = route.launches, other.launches
    got = flash_attention_kernel(q, k, v, window=window)
    check(route.launches == before + 1 and other.launches == before_other,
          f"K4 {shape} {dtype}: did not take the {route.name} route alone")
    want, wide = flash_attention_plain(q, k, v, window=window, spread=True)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"K4 {shape}: non-finite output")
    diff = (got.float() - want.float()).abs()
    rec = {"max_abs_err": float(diff.max()),
           "mean_abs_err": float(diff.mean()),
           "mean_abs_plain": float(want.float().abs().mean())}
    if dtype == torch.float32:
        rec["tol"] = FLASH_F32_TOL
        check(rec["max_abs_err"] <= FLASH_F32_TOL,
              f"K4 {shape} float32: max |kernel - plain| = "
              f"{rec['max_abs_err']} > {FLASH_F32_TOL}")
    else:
        elem, mean_limit = flash_bf16_limits(want, wide, one_tile=t <= 64)
        rec.update(max_share_of_limit=float((diff / elem).max()),
                   mean_limit=mean_limit, mean_spread=float(wide.mean()))
        check(rec["max_share_of_limit"] <= 1.0,
              f"K4 {shape} bf16: |kernel - plain| beyond its element's "
              f"limit by {rec['max_share_of_limit']}x")
        check(rec["mean_abs_err"] <= mean_limit,
              f"K4 {shape} bf16: mean |kernel - plain| = "
              f"{rec['mean_abs_err']} > {mean_limit}")
    del wide, diff
    again = flash_attention_kernel(q, k, v, window=window)
    check(torch.equal(got, again), f"K4 {shape}: not deterministic")
    return (q, k, v), want, rec


def sdpa_fn(q, k, v, window):
    """One PyTorch call computing the same function, on (B, H, T, hd)
    copies: the yardstick, timed only here."""
    import torch
    F = torch.nn.functional
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    if not window:
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)
    i = torch.arange(q.shape[1], device=q.device)
    diff = i[:, None] - i[None, :]
    mask = (diff >= 0) & (diff < window)
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True)


def phase_flash():
    """K4 against its plain version at the path's shapes and at small
    cases; times of K4, the plain version and SDPA beside the bound.
    Returns the records of the timed shapes and the largest |kernel -
    plain| over every case of each dtype."""
    import torch

    from repro_torch.kernels import flash_attention_kernel
    from repro_torch.kernels.ref import flash_attention_plain
    worst = {"bfloat16": 0.0, "float32": 0.0}
    for name, shape in FLASH_SMALL.items():
        for dtype in (torch.float32, torch.bfloat16):
            _, _, rec = flash_case(shape, dtype, 1)
            key = str(dtype).removeprefix("torch.")
            worst[key] = max(worst[key], rec["max_abs_err"])
            emit({"phase": "flash", "case": name, "shape": shape,
                  "dtype": key, **rec})
    records = {}
    for name, (shape, dname) in FLASH_SHAPES.items():
        b, t, h, kv, hd, window = shape
        dtype = getattr(torch, dname)
        (q, k, v), want, rec = flash_case(shape, dtype, 2)
        worst[dname] = max(worst[dname], rec["max_abs_err"])
        heavy = name != "serve"
        ms = cuda_ms(lambda: flash_attention_kernel(q, k, v, window=window),
                     iters=5 if heavy else 10, warmup=1)
        plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v,
                                                         window=window),
                           iters=2 if heavy else 5, warmup=1)
        lib = sdpa_fn(q, k, v, window)
        lib_err = float((lib().transpose(1, 2).float() - want.float())
                        .abs().max())
        library_ms = cuda_ms(lib, iters=5 if heavy else 10, warmup=1)
        # operations: 4·hd flop per visible (query, key) pair per head, at
        # the bf16 tensor-core peak for bf16 and the CUDA cores' float32
        # peak for float32 (full float32, which TF32 would not give);
        # bytes: q, k, v read once, o written once
        flops = 4.0 * hd * visible_pairs(t, window) * b * h
        bound_ms, bound_by = bound(
            nbytes(q, k, v) + nbytes(q), flops,
            PEAK_BF16 if dtype == torch.bfloat16 else PEAK_FP32)
        rec.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=bound_by,
                   gflop=flops / 1e9,
                   tflops_achieved=flops / (ms * 1e-3) / 1e12,
                   sdpa_max_abs_err=lib_err)
        records[name] = rec
        emit({"phase": "flash", "case": name, "shape": shape,
              "dtype": dname, **rec})
        del q, k, v, want, lib
        torch.cuda.empty_cache()
    emit({"phase": "flash", "library_call": "torch.nn.functional."
          "scaled_dot_product_attention(is_causal / window mask, "
          "enable_gqa=True) on (B, H, T, hd) copies",
          "max_abs_err_all_cases": worst})
    return records, worst


# ------------------------------------------------------------ phase 11
# the serving path at granite-3-8b's full published config
SERVE = {"arch": "granite-3-8b", "batch": 4, "prompt_len": 2048, "gen": 32,
         "seed": 0}
# K4 prefill vs the same prefill with the plain version, both on the card,
# bf16, 40 layers: the two round p to bfloat16 at different maxima (K4 at
# its running max, the plain version at the row max) and their float32
# scores differ in the last bits, and depth amplifies both: on the CPU a
# 40-layer model (d_model 512) moves by relative Frobenius 0.033 under
# last-bit score changes and 0.044 under K4's rounding order, max 0.23 and
# 0.36 (tests/test_torch_lm.py::test_depth_amplifies_*)
SERVE_TOL = {"rel_fro": 0.1, "max_abs": 1.0}
# the same path at float32, full width, 2 layers: the CPU tests' logits
# tolerance against the JAX package
SERVE_F32 = {"n_layers": 2, "max_abs": 1e-4}


def logits_diff(got, want, vocab):
    import torch
    a = got[..., :vocab].float()
    b = want[..., :vocab].float()
    d = a - b
    return {"max_abs": float(d.abs().max()),
            "mean_abs": float(d.abs().mean()),
            "rel_fro": float(torch.linalg.vector_norm(d)
                             / torch.linalg.vector_norm(b)),
            "last_argmax_agree": float((a[:, -1].argmax(-1)
                                        == b[:, -1].argmax(-1))
                                       .float().mean())}


def prefill_pair(cfg, seed, batch, prompt_len, max_len):
    """The prefill of ``cfg``'s seeded weights on the seeded prompts
    through K4, and again with K4's plain version in its place.  Returns
    (logits, plain logits, K4 prefill seconds, plain seconds, params,
    prompts)."""
    import torch

    import repro_torch.models.attention as attention
    from repro_torch.kernels.ref import flash_attention_plain
    from repro_torch.launch.serve import make_prompts
    from repro_torch.models.transformer import (init_params,
                                                prefill_with_cache)
    params = init_params(seed, cfg, device=DEVICE)
    prompts = make_prompts(cfg, batch, prompt_len, seed, DEVICE)
    run = lambda: prefill_with_cache(params, prompts, cfg,  # noqa: E731
                                     max_len)[0]
    with torch.inference_mode():
        logits, k4_s = _host_s(run)
        kernel = attention.flash_attention_kernel
        attention.flash_attention_kernel = flash_attention_plain
        try:
            plain, plain_s = _host_s(run)
        finally:
            attention.flash_attention_kernel = kernel
    return logits, plain, k4_s, plain_s, params, prompts


def device_split(fn):
    """Profile one call of ``fn`` (ending in a synchronize) with
    torch.profiler: the kernels' device time by name (kernel events
    only, so a kernel is not counted again under the operator that
    launched it), grouped into K4, matmuls and the rest, the host-clock
    wall time of the profiled call, and the device's idle share of it.
    {"error": ...} if the profiler gives no device time on this
    machine."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows = [(e.key, e.self_device_time_total / 1e3, e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0]
    except (RuntimeError, AttributeError) as exc:
        return {"error": f"{type(exc).__name__}: {exc}"}
    busy = sum(ms for _, ms, _ in rows)
    if busy <= 0:
        return {"error": "the profiler recorded no device time"}
    # K4: flash_fwd_sm90 (bf16 route) and flash_fwd (float32 route)
    groups = {"K4 flash_fwd": 0.0, "matmul": 0.0, "other": 0.0}
    for name, ms, _ in rows:
        low = name.lower()
        if "flash_fwd" in low:
            groups["K4 flash_fwd"] += ms
        elif any(w in low for w in ("gemm", "gemv", "nvjet", "xmma",
                                    "cutlass", "sm90_")):
            groups["matmul"] += ms
        else:
            groups["other"] += ms
    top = sorted(rows, key=lambda r: -r[1])[:8]
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": max(0.0, 1.0 - busy / wall_ms),
            "kernel_launches": sum(c for _, _, c in rows),
            "groups_ms": groups,
            "top_kernels": [{"name": n[:120], "ms": ms, "count": c}
                            for n, ms, c in top]}


def phase_serve(k4_serve_ms):
    """The serve call at the full config with the launch counts reset
    just before and read just after; then the prefill's K4 against the
    plain version on the card, its split, and the float32 check."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    arch, batch = SERVE["arch"], SERVE["batch"]
    prompt_len, gen, seed = SERVE["prompt_len"], SERVE["gen"], SERVE["seed"]
    cfg = get_config(arch)
    max_len = prompt_len + gen
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    out = serve(arch, batch=batch, prompt_len=prompt_len, gen=gen,
                seed=seed, device=DEVICE)
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    check_launched(launches, SERVE_KERNELS, "serve")
    check(launches["flash_attention"] == cfg.n_layers,
          f"serve: K4 (bf16) launched {launches['flash_attention']} times, "
          f"expected {cfg.n_layers} (one per layer of the prefill)")
    check(launches["flash_attention_f32"] == 0,
          f"serve: K4's float32 route launched "
          f"{launches['flash_attention_f32']} times in a bf16 serve")
    check(out["decode_syncs"] == 0,
          f"serve: {out['decode_syncs']} host syncs in the decode loop")
    tokens = out["tokens"].cpu()
    check(tuple(tokens.shape) == (batch, gen) and
          tokens.dtype == torch.int32, f"serve: tokens {tokens.shape} "
                                       f"{tokens.dtype}")
    check(0 <= int(tokens.min()) and int(tokens.max()) < cfg.vocab_size,
          "serve: a token outside the vocabulary")
    emit({"phase": "serve", "arch": arch, "batch": batch,
          "prompt_len": prompt_len, "gen": gen,
          "params": cfg.param_count(), "dtype": cfg.dtype,
          "prefill_s": out["prefill_s"], "decode_s": out["decode_s"],
          "decode_step_ms": out["decode_s"] / (gen - 1) * 1e3,
          "decode_tok_per_s": out["decode_tok_per_s"],
          "decode_syncs": out["decode_syncs"], "serve_call_s": wall,
          "max_memory_allocated": peak, "launches": launches,
          "sample": tokens[0, :8].tolist()})
    del out
    torch.cuda.empty_cache()

    # the same weights and prompts: K4 against the plain version
    logits, plain, k4_s, plain_s, params, prompts = prefill_pair(
        cfg, seed, batch, prompt_len, max_len)
    check(bool(torch.isfinite(logits[..., :cfg.vocab_size]).all()),
          "serve: non-finite prefill logits")
    diff = logits_diff(logits, plain, cfg.vocab_size)
    check(diff["rel_fro"] <= SERVE_TOL["rel_fro"] and
          diff["max_abs"] <= SERVE_TOL["max_abs"],
          f"serve: K4 prefill vs plain prefill {diff} beyond {SERVE_TOL}")
    # serve's first token is the argmax of this same prefill (same weights,
    # prompts and kernels; rows whose top two logits lie within a few
    # bfloat16 spacings are not held to it)
    last = logits[:, -1, :cfg.vocab_size].float()
    top2 = torch.topk(last, 2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1]) > 0.1
    first = last.argmax(-1).to(torch.int32).cpu()
    check(bool(torch.all((first == tokens[:, 0]) | ~sure.cpu())),
          "serve: first generated token != argmax of the rebuilt prefill")
    del logits, plain
    from repro_torch.models.transformer import prefill_with_cache
    from repro_torch.train.steps import serve_step
    with torch.inference_mode():
        prefill_prof = device_split(
            lambda: prefill_with_cache(params, prompts, cfg, max_len))
        _, caches = prefill_with_cache(params, prompts, cfg, max_len)
        tok = tokens[:, :1].to(DEVICE)

        def decode_steps(n=4):
            nonlocal tok
            for i in range(n):
                tok, _ = serve_step(params, tok, caches, prompt_len + i, cfg)

        decode_steps()                  # warm
        decode_prof = device_split(decode_steps)
    del params, prompts, caches
    torch.cuda.empty_cache()

    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                n_layers=SERVE_F32["n_layers"])
    reset_launches()
    l32, p32, _, _, _, _ = prefill_pair(cfg32, seed, batch, prompt_len,
                                        max_len)
    f32_launches = read_launches()
    check_launched(f32_launches, F32_KERNELS, "serve float32 check")
    check(f32_launches["flash_attention_f32"] == cfg32.n_layers and
          f32_launches["flash_attention"] == 0,
          f"serve float32 check: K4 launches {f32_launches}, expected "
          f"{cfg32.n_layers} of the float32 route and 0 of the bf16 one")
    diff32 = logits_diff(l32, p32, cfg.vocab_size)
    check(diff32["max_abs"] <= SERVE_F32["max_abs"],
          f"serve: float32 K4 prefill vs plain {diff32} beyond {SERVE_F32}")
    del l32, p32
    torch.cuda.empty_cache()
    emit({"phase": "serve", "check": "prefill K4 vs plain on the card",
          "bf16_full": diff, "tol": SERVE_TOL,
          "float32_full_width": dict(diff32, n_layers=cfg32.n_layers,
                                     tol=SERVE_F32["max_abs"],
                                     launches=f32_launches),
          "prefill_warm_s": k4_s, "prefill_plain_s": plain_s,
          "k4_share_of_warm_prefill": cfg.n_layers * k4_serve_ms / 1e3
          / k4_s,
          "prefill_profile": prefill_prof,
          "decode_profile_4_steps": decode_prof})
    return launches, f32_launches


def main(argv) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Smoke run of the port on "
                                 "one CUDA card (see the module notes).")
    ap.add_argument("--stop-after", choices=("build", "kernels"),
                    help="run the phases up to this one and stop, with "
                         "no kernels line and no result line")
    args = ap.parse_args(argv)
    preflight()
    import torch
    # full float32 products in the plain versions and the library call
    torch.backends.cuda.matmul.allow_tf32 = False
    card = phase_device()
    phase_build()
    if args.stop_after == "build":
        return 0
    forms = machines()
    k1, k2 = phase_kernels(forms)
    if args.stop_after == "kernels":
        return 0
    from repro_torch.core import Hierarchy, grid3d
    from repro_torch.topology import (FatTreeTopology, MatrixTopology,
                                      TorusTopology)
    from repro_torch.topology.base import as_topology
    side = SIZE["side"]
    main_topo = as_topology(Hierarchy.from_strings(SIZE["hierarchy"],
                                                   SIZE["distances"]))
    main_g = grid3d(side, side, side)
    main_run, main_perm, main_pairs = run_map(main_topo, main_g, "main",
                                              compare_cpu=True)
    quarter = grid3d(side, side, side // 4)
    run_map(TorusTopology((side, side, side // 4)), quarter, "forms:torus",
            compare_cpu=True)
    run_map(MatrixTopology(matrix=FatTreeTopology(
        SIZE["forms_fattree"], (1.0, 1.0, 1.0)).distance_matrix()), quarter,
        "forms:fattree-matrix-int8", compare_cpu=True)
    phase_multilevel(main_topo, main_g, main_run["jf"])
    batch_ml, _ = phase_batch(main_topo)
    phase_warm(main_topo, main_g, main_perm, main_pairs)
    k3, gain_launches = phase_gain(main_topo, main_g, main_perm, main_pairs,
                                   forms)
    k4, k4_worst = phase_flash()
    serve_launches, f32_launches = phase_serve(k4["serve"]["ms"])
    kernels = []
    for rec, launches, name, source, replaces in (
            (k1, main_run["launches"], "qap_objective",
             "src/repro_torch/csrc/qap_objective.cu",
             "src/repro/kernels/qap_objective.py:144"),
            (k2, main_run["launches"], "pair_gains",
             "src/repro_torch/csrc/pair_gain.cu",
             "src/repro/kernels/pair_gain.py:245"),
            (k3, gain_launches, "swap_gain_matrix",
             "src/repro_torch/csrc/swap_gain.cu",
             "src/repro/kernels/swap_gain.py:88"),
            (dict(k4["serve"], max_abs_err=k4_worst["bfloat16"]),
             serve_launches, "flash_attention",
             "src/repro_torch/csrc/flash_attention_sm90.cu",
             "src/repro/kernels/flash_attention.py:115"),
            (dict(k4["serve-f32"], max_abs_err=k4_worst["float32"]),
             f32_launches, "flash_attention_f32",
             "src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:115")):
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": launches[name],
                        "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                        "plain_ms": rec["plain_ms"],
                        "bound_ms": rec["bound_ms"],
                        "bound_by": rec["bound_by"],
                        "library_ms": rec["library_ms"]})
        if "batch_ms" in rec:
            # the lane axis: launches in the multilevel batch's map_many
            # and the device time of one launch of LANES lanes
            kernels[-1].update(
                batch_launches=batch_ml["batch_launches"][name],
                batch_ms=rec["batch_ms"])
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
